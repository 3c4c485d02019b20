"""LAION-CLAP audio embedder (HTSAT tower) in PyTorch.

Counterpart of ``audio_metrics_tpu/models/clap.py``:

    audio (B, n <= 10 s) @48 kHz
      -> repeat-pad to 10 s (laion "repeatpad"), log-mel (1024 fft / 480
         hop / 64 slaney mels, dB), folded BatchNorm, patch tokens
         [one kernel on the bf16 path for clips that tile 10 s:
         ops/frontend_fused.py; other lengths: the halo log-mel kernel,
         ops/mel.py, then plain products]
      -> HTSAT Swin encoder [ops/attention.py, ops/mlp.py, ops/merge.py
         kernels; each block's path as models/htsat.py selects it]
      -> latent (B, num_features)
      -> audio_projection: linear1 -> relu -> linear2 -> l2-normalize

Weights come from the framework-free numpy dict (HF Clap names) that
``init_params`` / ``init_projection_params`` / ``convert.convert_checkpoint``
produce, or from a checkpoint file that ``LaionCLAP(ckpt=)`` resolves
(``utils.get_url.resolve_checkpoint``: ``$AM_TPU_CKPT_DIR``, the cache) and
converts; ``convert.params_from_numpy`` folds them into the modules once at
load.

In f32 (the default, as in the JAX package) the mel chain (repeat-pad, f32
log-mel, BatchNorm, the frontend products) runs as PyTorch ops, the
counterparts of the JAX package's XLA code, in full f32 (TF32 off for
matmuls and cuDNN, ``utils.precision.full_f32``); the Swin blocks and
merges launch their f32 kernels on the card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..ops.frontend_fused import (
    BF16_TABLES,
    clap_tokens_fused,
    frontend_tables,
    fused_frontend_supported,
)
from ..ops.mel import device_table, log_mel_halo_plain, log_mel_spectrogram, mel_filter_bank
from ..utils.precision import full_f32
from .base import Embedder, _require_random_weights_optin, resolve_device
from .htsat import HTSAT_BASE, HTSATConfig, HTSATEncoder, frontend_tokens, init_params

__all__ = [
    "LaionCLAP",
    "ClapAudio",
    "clap_mel",
    "clap_mel_tiled",
    "repeat_pad",
    "init_projection_params",
    "LAION_CLAP_LAYERS",
    "LAION_CLAP_MUSIC_CHECKPOINT_URL",
    "LAION_CLAP_MUSIC_SPEECH_CHECKPOINT_URL",
]

LAION_CLAP_MUSIC_SPEECH_CHECKPOINT_URL = "https://huggingface.co/lukewys/laion_clap/resolve/main/music_speech_audioset_epoch_15_esc_89.98.pt"
LAION_CLAP_MUSIC_CHECKPOINT_URL = "https://huggingface.co/lukewys/laion_clap/resolve/main/music_audioset_epoch_15_esc_90.14.pt"
LAION_CLAP_LAYERS = ["audio_projection.0", "audio_projection.2"]

SAMPLE_RATE = 48000
MAX_SAMPLES = 10 * SAMPLE_RATE
_N_FFT = 1024
_HOP = 480
_N_MELS = 64
_FMIN, _FMAX = 50, 14000
PROJECTION_DIM = 512


def _clap_fb() -> np.ndarray:
    return mel_filter_bank(
        _N_FFT // 2 + 1, _N_MELS, float(_FMIN), float(_FMAX), SAMPLE_RATE,
        norm="slaney", mel_scale="slaney",
    ).astype(np.float32)


def clap_mel(audio, compute_dtype=None, center=True, out_affine=None, out_dtype=None,
             plain=False):
    """(B, n) @48k -> (B, n//480 + 1, 64) log-mel, laion non-fusion
    convention (audio_metrics_tpu/models/clap.py:78-101); ``center=False``
    takes uncentered frames, (n - 1024)//480 + 1 of them.  On a CUDA tensor
    in bf16 it runs the halo log-mel kernel, or with ``plain`` that
    kernel's plain version on any device."""
    if plain and compute_dtype == torch.bfloat16:
        return log_mel_halo_plain(
            audio, frame_length=_N_FFT, hop_length=_HOP, n_fft=_N_FFT, fb=_clap_fb(),
            center=center, log_mode="db", out_affine=out_affine, out_dtype=out_dtype)
    return log_mel_spectrogram(
        audio, sampling_rate=SAMPLE_RATE, frame_length=_N_FFT, hop_length=_HOP,
        n_mels=_N_MELS, fmin=_FMIN, fmax=_FMAX, n_fft=_N_FFT, center=center,
        mel_norm="slaney", mel_scale="slaney", log_mode="db", compute_dtype=compute_dtype,
        out_affine=out_affine, out_dtype=out_dtype,
    )


def _can_tile_mel(n: int) -> bool:
    """The repeat-pad clip tiles 10 s a whole number of times (no zero
    tail) in whole hops, so its mel frames repeat with the clip period
    (audio_metrics_tpu/models/clap.py:104-114)."""
    return n < MAX_SAMPLES and MAX_SAMPLES % n == 0 and n % _HOP == 0 and n >= _N_FFT


def repeat_pad(audio):
    """laion "repeatpad": whole copies of the clip, then zeros up to 10 s."""
    n = audio.shape[1]
    if n >= MAX_SAMPLES:
        return audio
    audio = audio.repeat(1, MAX_SAMPLES // n)
    return torch.nn.functional.pad(audio, (0, MAX_SAMPLES - audio.shape[1]))


@lru_cache(maxsize=None)
def _mid_rows(p: int, t_tail0: int) -> np.ndarray:
    """The head frame each mid frame p+2 .. t_tail0-1 of the tiled mel
    copies: one clip period (p frames) earlier, folded into the head."""
    return 2 + (np.arange(p + 2, t_tail0) - 2) % p


def clap_mel_tiled(audio, compute_dtype=None, out_affine=None, out_dtype=None, plain=False):
    """Log-mel of the repeat-padded clip computed from its p+2 head and 2
    tail frames only (audio_metrics_tpu/models/clap.py:116-157): every frame
    strictly inside the tiled signal equals the frame one clip period
    (p = n/hop frames) earlier, so mid frames are row copies.  ``plain`` as
    ``clap_mel``'s."""
    b, n = audio.shape
    p = n // _HOP
    half = _N_FFT // 2
    n_frames = MAX_SAMPLES // _HOP + 1
    t_tail0 = (MAX_SAMPLES - half) // _HOP + 1
    extra = _HOP + half
    head_sig = torch.cat([audio[:, 1 : half + 1].flip(1), audio, audio[:, :extra]], dim=1)
    tail_sig = torch.cat([audio[:, n - extra :], audio[:, -half - 1 : -1].flip(1)], dim=1)
    kw = dict(compute_dtype=compute_dtype, out_affine=out_affine, out_dtype=out_dtype,
              plain=plain)
    head = clap_mel(head_sig, center=False, **kw)
    tail = clap_mel(tail_sig, center=False, **kw)
    mid_idx = device_table(_mid_rows, (p, t_tail0), audio.device, torch.int64)
    mel = torch.cat([head, head[:, mid_idx], tail], dim=1)
    assert mel.shape[1] == n_frames
    return mel


def init_projection_params(cfg: HTSATConfig = HTSAT_BASE, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed + 1)
    d = cfg.num_features
    return {
        "audio_projection.linear1.weight": rng.normal(
            scale=0.02, size=(PROJECTION_DIM, d)
        ).astype(np.float32),
        "audio_projection.linear1.bias": np.zeros(PROJECTION_DIM, np.float32),
        "audio_projection.linear2.weight": rng.normal(
            scale=0.02, size=(PROJECTION_DIM, PROJECTION_DIM)
        ).astype(np.float32),
        "audio_projection.linear2.bias": np.zeros(PROJECTION_DIM, np.float32),
    }


def _buffers(module: nn.Module, arrays: dict, bf16_names=()) -> None:
    for name, arr in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        module.register_buffer(name, t.to(torch.bfloat16) if name in bf16_names else t)


class ClapFrontend(nn.Module):
    """Buffers of :func:`ops.frontend_fused.frontend_tables` plus the
    unfolded BatchNorm statistics of the f32 path."""

    def __init__(self, params: dict, cfg: HTSATConfig):
        super().__init__()
        _buffers(self, frontend_tables(params, cfg, _clap_fb(), SAMPLE_RATE), BF16_TABLES)
        _buffers(self, {
            k.rsplit(".", 1)[-1]: params[k] for k in (
                "audio_encoder.batch_norm.running_mean",
                "audio_encoder.batch_norm.running_var",
                "audio_encoder.batch_norm.weight",
                "audio_encoder.batch_norm.bias",
            )
        })


class ClapAudio(nn.Module):
    """HTSAT tower + projection, weights folded for the kernels at load.

    ``forward(audio)`` dispatches each kernel wrapper on the audio's device."""

    def __init__(self, params: dict, cfg: HTSATConfig, compute_dtype: torch.dtype):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        self.frontend = ClapFrontend(params, cfg)
        self.encoder = HTSATEncoder(params, cfg, compute_dtype)
        _buffers(self, {
            k.replace("audio_projection.", "").replace(".", "_"): params[k]
            for k in (
                "audio_projection.linear1.weight", "audio_projection.linear1.bias",
                "audio_projection.linear2.weight", "audio_projection.linear2.bias",
            )
        })

    def forward(self, audio) -> dict:
        """audio (B, n <= 10 s) f32 -> the three tap outputs, (B, 512) f32
        each, along the three branches of ``_clap_forward``
        (audio_metrics_tpu/models/clap.py:160-242): the fused frontend for
        bf16 clips that tile 10 s; else the tiled repeat-pad mel where the
        clip tiles; else the repeat-padded 10 s clip's centered mel.  In
        bf16 the BatchNorm folds into the mel epilogue (bf16 out); in f32
        it is applied to the f32 mel, and the whole forward runs in full
        f32 (the encoder's blocks and merges launch their f32 kernels)."""
        cfg, dt, fr = self.cfg, self.compute_dtype, self.frontend
        n = audio.shape[1]
        if n > MAX_SAMPLES:
            raise ValueError(f"{n}-sample clips: CLAP takes at most 10 s ({MAX_SAMPLES} samples)")
        if dt != torch.bfloat16:
            with full_f32():
                return self._projection_taps(self.encoder(self.f32_tokens(audio)))
        if fused_frontend_supported(n, SAMPLE_RATE, cfg):
            tokens = clap_tokens_fused(audio, fr, sr=SAMPLE_RATE, cfg=cfg)
        else:
            kw = dict(compute_dtype=dt, out_affine=(fr.bn_scale, fr.bn_offset),
                      out_dtype=torch.bfloat16)
            if _can_tile_mel(n):
                mel = clap_mel_tiled(audio, **kw)
            else:
                mel = clap_mel(repeat_pad(audio), center=True, **kw)
            tokens = frontend_tokens(mel, fr.patch_w, fr.patch_b, fr.ln_w, fr.ln_b, cfg, dt)
        return self._projection_taps(self.encoder(tokens))

    def f32_tokens(self, audio):
        """The f32 mel chain (audio_metrics_tpu/models/clap.py:219-241, the
        XLA path): the tiled repeat-pad log-mel where the clip tiles, else
        the repeat-padded clip's centered one, BatchNorm, the frontend
        products; PyTorch ops on any device, no kernel.  Callers hold
        ``full_f32()``."""
        fr = self.frontend
        if _can_tile_mel(audio.shape[1]):
            mel = clap_mel_tiled(audio)
        else:
            mel = clap_mel(repeat_pad(audio), center=True)
        mel = (mel - fr.running_mean) * torch.rsqrt(fr.running_var + 1e-5) * fr.weight + fr.bias
        return frontend_tokens(mel, fr.patch_w, fr.patch_b, fr.ln_w, fr.ln_b, self.cfg,
                               torch.float32)

    def _projection_taps(self, latent) -> dict:
        """Pooled latent -> the reference tap outputs (reference
        embedders/clap.py:7,32-43)."""
        l1 = latent @ self.linear1_weight.T + self.linear1_bias
        l2 = torch.relu(l1) @ self.linear2_weight.T + self.linear2_bias
        return {
            "embedding": l2 / torch.linalg.vector_norm(l2, dim=-1, keepdim=True),
            "audio_projection.0": l1,
            "audio_projection.2": l2,
        }


class LaionCLAP(Embedder):
    """HTSAT CLAP audio embedder; 512-d outputs at three tap points.

    ``params`` is the numpy dict with HF Clap names; else ``ckpt``, a
    checkpoint URL or path, is resolved (``utils.get_url.
    resolve_checkpoint``: the path, ``$AM_TPU_CKPT_DIR/<basename>``, the
    cache, a download) and converted (:func:`_load_params`).  Without
    either, or when the checkpoint cannot be found, weights are random and
    must be opted into (``allow_random_weights=True``): metric values from
    random weights are meaningless.  ``compute_dtype`` None is f32, the
    JAX package's default."""

    names = ("embedding", "audio_projection.0", "audio_projection.2")
    sr = SAMPLE_RATE

    def __init__(
        self,
        ckpt: str | None = None,
        layer: str | None = None,
        params: dict | None = None,
        cfg: HTSATConfig = HTSAT_BASE,
        seed: int = 0,
        compute_dtype: str | None = None,
        allow_random_weights: bool = False,
        device="cuda",
    ):
        from ..convert import params_from_numpy

        if params is None and ckpt is not None:
            params = _load_params(ckpt, cfg)
        self.layer = layer or "embedding"
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            _require_random_weights_optin("LaionCLAP", ckpt, allow_random_weights)
            params = init_params(cfg, seed=seed)
            params.update(init_projection_params(cfg, seed=seed))
        dtypes = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16,
                  torch.float32: torch.float32, torch.bfloat16: torch.bfloat16}
        if compute_dtype not in dtypes:
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        self.model = params_from_numpy(params, cfg, self.device, dtypes[compute_dtype])

    @torch.no_grad()
    def embed(self, audio):
        """(B, n <= 10 s) f32 on the embedder's device -> (B, 512) f32."""
        return self.model(audio)[self.layer]


CLAP = LaionCLAP


def _load_params(ckpt: str, cfg: HTSATConfig = HTSAT_BASE) -> dict | None:
    """Resolve a checkpoint URL or path and convert it to the numpy
    parameter dict (audio_metrics_tpu/models/clap.py:477-504); None when it
    cannot be found.  An ``.npz`` is already in the dict's layout (the JAX
    package's ``convert`` writes it) and is checked against the forward's
    key set; anything else is a torch state dict (``torch.load``,
    ``weights_only``), under ``state_dict`` or not, converted strictly."""
    from ..convert import convert_checkpoint, expected_param_keys
    from ..utils.get_url import resolve_checkpoint

    path = resolve_checkpoint(ckpt)
    if path is None:
        return None
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            params = {k: np.asarray(z[k]) for k in z.files}
        expected = expected_param_keys(cfg)
        missing = expected - set(params)
        if missing:
            raise ValueError(
                f"npz checkpoint {path} incomplete: {len(missing)} of {len(expected)} keys "
                f"missing, e.g. {sorted(missing)[:5]}"
            )
        return {k: v for k, v in params.items() if k in expected}
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return convert_checkpoint(state, cfg=cfg, strict=True)
