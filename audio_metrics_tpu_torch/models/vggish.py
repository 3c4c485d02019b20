"""VGGish embedder in PyTorch.

Counterpart of ``audio_metrics_tpu/models/vggish.py`` (torchvggish's VGG
with its final ReLU removed: 128-d pre-activation features averaged over
0.96 s patches).

    audio (B, n) @16 kHz
      -> magnitude STFT (25 ms / 10 ms Hann, n_fft 512, no centering),
         64 HTK mel bands 125-7500 Hz (mel-domain triangles, DC bin zeroed),
         log(mel + 0.01), non-overlapping 96-frame patches   [always f32]
      -> features: [Conv64, MP, Conv128, MP, Conv256 x2, MP, Conv512 x2, MP]
         (3x3 convs pad 1, ReLU; 2x2 max-pool stride 2)
      -> NCHW -> NHWC flatten -> Linear 12288-4096 ReLU, 4096-4096 ReLU,
         4096-128
      -> mean over the clip's patches

The JAX package runs all of it in XLA, outside any Pallas kernel, so the
convolutions and products here are library calls (``F.conv2d``,
``F.max_pool2d``, products) in full f32 (``utils.precision.full_f32``:
cuDNN and cuBLAS would otherwise take TF32).  In bf16 the JAX rounding
points are kept (vggish.py:120-157): bf16 operands, products accumulated in
f32, the f32 bias added, ReLU, one rounding to bf16; the last product
returns f32.  Here the products run in f32 on the bf16-rounded operands
(the weights are rounded once at load), which is that arithmetic up to the
order of the f32 sums; cuDNN's bf16 convolution would round its output to
bf16 before the bias (``tests/test_torch_vggish.py`` reads both against the
JAX forward).

Weights: the torchvggish-named numpy dict of the JAX ``init_params`` /
``convert_torch_state_dict``, or a checkpoint (``load_checkpoint``: the
torchvggish ``.pth`` or the JAX package's converted ``.npz``), resolved from
``VGGISH_CHECKPOINT_URL`` like every checkpoint of the port
(``utils.get_url.resolve_checkpoint``: ``$AM_TPU_CKPT_DIR``, the cache).
Without one, random weights must be opted into.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mel import log_mel_spectrogram
from ..utils.precision import full_f32
from .base import Embedder, _require_random_weights_optin, resolve_device

__all__ = ["VGGish", "vggish_log_mel_patches", "init_params", "convert_torch_state_dict",
           "load_checkpoint", "VGGISH_CHECKPOINT_URL"]

# torchvggish's release weights, the file torch.hub resolves for the
# reference's ``torch.hub.load("harritaylor/torchvggish")``
VGGISH_CHECKPOINT_URL = (
    "https://github.com/harritaylor/torchvggish/releases/download/v0.1/vggish-10086976.pth"
)

SAMPLE_RATE = 16000
_FRAME_LEN = 400  # 25 ms
_HOP = 160  # 10 ms
_N_FFT = 512
_N_MELS = 64
_PATCH_FRAMES = 96
_CONV_CHANNELS = [(1, 64), (64, 128), (128, 256), (256, 256), (256, 512), (512, 512)]
_TORCH_CONV_IDX = [0, 3, 6, 8, 11, 13]  # torchvggish ``features`` indices
_POOL_AFTER = {0, 1, 3, 5}  # a max-pool follows these convs
_FC_DIMS = [(512 * 4 * 6, 4096), (4096, 4096), (4096, 128)]
_TORCH_FC_IDX = [0, 2, 4]  # torchvggish ``embeddings`` indices


def vggish_log_mel_patches(audio: torch.Tensor, sr: int = SAMPLE_RATE) -> torch.Tensor:
    """audio (B, n) -> (B, n_patches, 96, 64) f32 log-mel examples, in full
    f32 (the JAX function passes no compute dtype)."""
    with full_f32():
        mel = log_mel_spectrogram(
            audio, sampling_rate=sr, frame_length=_FRAME_LEN, hop_length=_HOP, n_fft=_N_FFT,
            n_mels=_N_MELS, fmin=125.0, fmax=7500.0, center=False, power=1.0, mel_norm=None,
            mel_scale="htk", triangle_domain="mel", zero_dc=True, log_mode="natural",
            log_offset=0.01,
        )
    b, n_frames, n_mels = mel.shape
    n_patches = n_frames // _PATCH_FRAMES
    return mel[:, : n_patches * _PATCH_FRAMES].reshape(b, n_patches, _PATCH_FRAMES, n_mels)


def init_params(seed: int = 0) -> dict:
    """Seeded weights under torchvggish's names (He-normal, zero biases):
    the JAX package's ``init_params``, the same numbers for a seed."""
    rng = np.random.default_rng(seed)
    params = {}
    for (c_in, c_out), idx in zip(_CONV_CHANNELS, _TORCH_CONV_IDX):
        params[f"features.{idx}.weight"] = rng.normal(
            scale=np.sqrt(2.0 / (c_in * 9)), size=(c_out, c_in, 3, 3)).astype(np.float32)
        params[f"features.{idx}.bias"] = np.zeros(c_out, np.float32)
    for (d_in, d_out), idx in zip(_FC_DIMS, _TORCH_FC_IDX):
        params[f"embeddings.{idx}.weight"] = rng.normal(
            scale=np.sqrt(2.0 / d_in), size=(d_out, d_in)).astype(np.float32)
        params[f"embeddings.{idx}.bias"] = np.zeros(d_out, np.float32)
    return params


def _expected_keys() -> set:
    return {f"features.{i}.{p}" for i in _TORCH_CONV_IDX for p in ("weight", "bias")} | {
        f"embeddings.{i}.{p}" for i in _TORCH_FC_IDX for p in ("weight", "bias")}


def convert_torch_state_dict(state_dict) -> dict:
    """torchvggish state dict -> the numpy parameter dict (same names, f32)."""
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)
            for k, v in state_dict.items()}


def load_checkpoint(path: str) -> dict:
    """The parameter dict of a torchvggish ``.pth`` (``torch.load``,
    ``weights_only``) or of the torch-free ``.npz`` that the JAX package's
    ``convert`` writes; raises ``ValueError`` when a key is missing."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            params = {k: np.asarray(z[k]) for k in z.files}
        kind = "npz checkpoint"
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        params = convert_torch_state_dict(state)
        kind = "torchvggish checkpoint"
    expected = _expected_keys()
    missing = expected - set(params)
    if missing:
        raise ValueError(f"{kind} {path} incomplete: {len(missing)} of {len(expected)} keys "
                         f"missing, e.g. {sorted(missing)[:5]}")
    return {k: v for k, v in params.items() if k in expected}


class VGGish(nn.Module, Embedder):
    """128-d pre-activation VGGish embeddings averaged over 0.96 s patches.

    ``params``: the numpy dict with torchvggish names; else ``ckpt`` (a URL
    or path; default ``VGGISH_CHECKPOINT_URL``) is resolved and loaded.
    Without a checkpoint this raises unless ``allow_random_weights``
    (seeded weights, ``init_params``).  ``compute_dtype`` None is f32, the
    JAX package's default; "bfloat16" its bf16 rounding points.  The
    weights are buffers on ``device``, rounded to bf16 once at load in bf16
    (kept as f32 tensors).  The conv stack and FCs on patches are
    :meth:`patch_net`; ``forward(data)`` is the embedder protocol."""

    names = ("embedding",)
    sr = SAMPLE_RATE

    def __init__(self, params: dict | None = None, ckpt: str | None = None,
                 compute_dtype: str | None = None, allow_random_weights: bool = False,
                 device="cuda"):
        from ..utils.get_url import resolve_checkpoint

        super().__init__()
        if params is None:
            path = resolve_checkpoint(ckpt if ckpt is not None else VGGISH_CHECKPOINT_URL)
            if path is not None:
                params = load_checkpoint(path)
        if params is None:
            _require_random_weights_optin("VGGish", ckpt, allow_random_weights)
            params = init_params()
        dtypes = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16,
                  torch.float32: torch.float32, torch.bfloat16: torch.bfloat16}
        if compute_dtype not in dtypes:
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
        self.compute_dtype = dtypes[compute_dtype]
        self.device = resolve_device(device)
        for key in sorted(_expected_keys()):
            t = torch.from_numpy(np.ascontiguousarray(params[key], np.float32))
            if key.endswith(".weight") and self.compute_dtype == torch.bfloat16:
                t = t.to(torch.bfloat16).float()
            self.register_buffer(key.replace(".", "_"), t.to(self.device))

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX ``.astype(compute_dtype)`` of the input and after each
        ReLU: a bf16 rounding, kept in f32."""
        return x.to(torch.bfloat16).float() if self.compute_dtype == torch.bfloat16 else x

    def patch_net(self, patches: torch.Tensor) -> torch.Tensor:
        """patches (N, 96, 64) f32 -> (N, 128) f32 pre-activation
        embeddings (the JAX ``_forward``)."""
        with full_f32():
            x = self._round(patches[:, None].float())  # NCHW
            for i, idx in enumerate(_TORCH_CONV_IDX):
                w = getattr(self, f"features_{idx}_weight")
                b = getattr(self, f"features_{idx}_bias")
                x = self._round(torch.relu(F.conv2d(x, w, b, padding=1)))
                if i in _POOL_AFTER:
                    x = F.max_pool2d(x, 2, 2)
            # torchvggish permutes NCHW -> NHWC before it flattens
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            for i, idx in enumerate(_TORCH_FC_IDX):
                w = getattr(self, f"embeddings_{idx}_weight")
                x = x @ w.T + getattr(self, f"embeddings_{idx}_bias")
                if i < 2:
                    x = self._round(torch.relu(x))
        return x

    @torch.no_grad()
    def embed(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, n >= 0.975 s) f32 on the embedder's device -> (B, 128) f32."""
        patches = vggish_log_mel_patches(audio)
        b, t = patches.shape[:2]
        emb = self.patch_net(patches.reshape(b * t, _PATCH_FRAMES, _N_MELS))
        return emb.reshape(b, t, -1).mean(dim=1)

    # the reference protocol (audio_metrics_tpu/models/vggish.py:212-216),
    # also what calling the module runs: ``vggish({"audio": audio})``
    forward = Embedder.forward
