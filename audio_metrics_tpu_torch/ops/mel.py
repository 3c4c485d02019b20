"""Log-mel spectrogram as products, and the halo log-mel kernel's wrapper.

Counterpart of ``audio_metrics_tpu/ops/mel.py``: the filterbank and
windowed-DFT tables are the same numpy code (:48-145, :222-228); framing is
a hop-strided view, the DFT a product with the ``window * cos`` /
``window * sin`` basis, and the mel projection a second product
(:151-219, :574-668).  ``log_mel_halo`` has the contract of
``log_mel_pallas_halo`` (:374-571) and launches kernels/csrc/log_mel.cu;
``log_mel_spectrogram`` dispatches to it for bf16 compute on a CUDA
tensor, as :625-644 dispatches to the TPU kernel.  The CLAP 5 s path
does not come here on a card: it goes through the fused frontend kernel
(ops/frontend_fused.py).

Dispatch of ``log_mel_halo``: a CPU tensor runs ``log_mel_halo_plain``; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import KERNELS, require_cuda

__all__ = [
    "mel_filter_bank",
    "stft_power",
    "log_mel_spectrogram",
    "log_mel_halo",
    "log_mel_halo_plain",
]

KERNEL = KERNELS["log_mel"]
_LOG_MODES = {"db": 0, "natural": 1}


def _hertz_to_mel(freq, mel_scale: str):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = freq >= min_log_hz
    return np.where(
        above, min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep, mels
    )


def _mel_to_hertz(mels, mel_scale: str):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@lru_cache(maxsize=None)
def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
    norm: str | None = None,
    mel_scale: str = "htk",
    triangle_domain: str = "hz",
    zero_dc: bool = False,
) -> np.ndarray:
    """Triangular mel filterbank (num_frequency_bins, num_mel_filters).
    ``triangle_domain="hz"``: librosa construction (slopes in hertz);
    ``"mel"`` with ``zero_dc=True``: torchvggish's
    ``spectrogram_to_mel_matrix`` (slopes in mel units, DC row zeroed)."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)
    mel_min = _hertz_to_mel(min_frequency, mel_scale)
    mel_max = _hertz_to_mel(max_frequency, mel_scale)
    mel_points = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hertz(mel_points, mel_scale)
    if triangle_domain == "mel":
        with np.errstate(divide="ignore", invalid="ignore"):
            spec_mels = _hertz_to_mel(fft_freqs, mel_scale)
            lower = mel_points[:-2][np.newaxis, :]
            center = mel_points[1:-1][np.newaxis, :]
            upper = mel_points[2:][np.newaxis, :]
            up_slope = (spec_mels[:, np.newaxis] - lower) / (center - lower)
            down_slope = (upper - spec_mels[:, np.newaxis]) / (upper - center)
            weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    else:
        fdiff = np.diff(filter_freqs)
        slopes = filter_freqs[np.newaxis, :] - fft_freqs[:, np.newaxis]
        down = -slopes[:, :-2] / fdiff[:-1]
        up = slopes[:, 2:] / fdiff[1:]
        weights = np.maximum(0.0, np.minimum(down, up))
    if zero_dc:
        weights[0, :] = 0.0
    if norm == "slaney":
        enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
        weights *= enorm[np.newaxis, :]
    return weights


@lru_cache(maxsize=None)
def _dft_matrices(frame_length: int, n_fft: int, window: str):
    """(frame_length, n_bins) windowed cos/sin matrices for a real DFT."""
    if window == "hann":
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_length) / frame_length)
    elif window == "ones":
        win = np.ones(frame_length)
    else:
        raise ValueError(f"unknown window {window!r}")
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[None, :]
    t = np.arange(frame_length)[:, None]
    angle = 2.0 * np.pi * k * t / n_fft
    cos_m = (np.cos(angle) * win[:, None]).astype(np.float32)
    sin_m = (-np.sin(angle) * win[:, None]).astype(np.float32)
    return cos_m, sin_m


def _fb_support_bins(fb: np.ndarray) -> int:
    """Highest frequency bin with any mel-filter weight, rounded up to a
    multiple of 128 — bins above fmax contribute nothing and are dropped
    from the DFT basis."""
    nz = np.nonzero(np.any(fb != 0.0, axis=1))[0]
    hi = int(nz[-1]) + 1 if len(nz) else fb.shape[0]
    return min(fb.shape[0], -(-hi // 128) * 128)


def _reflect_pad(x: torch.Tensor, frame_length: int) -> torch.Tensor:
    """torch.stft's ``center``: reflect by frame_length // 2 at both ends
    (the edge sample itself is not repeated)."""
    pad = frame_length // 2
    return F.pad(x, (pad, pad), mode="reflect")


def stft_power(audio, frame_length: int, hop_length: int, n_fft: int | None = None,
               center: bool = True, compute_dtype=None):
    """Power spectrogram of Hann-windowed frames via a DFT product:
    (B, n) -> (B, frames, n_fft//2+1) f32.
    ``center`` reflect-pads by frame_length//2.  ``compute_dtype`` rounds
    the frame samples and the basis (bf16 on the bf16 forward); the product
    accumulates in f32 either way."""
    x = audio.float()
    if center:
        x = _reflect_pad(x, frame_length)
    n_fft = n_fft or frame_length
    cos_m, sin_m = _dft_matrices(frame_length, n_fft, "hann")
    n_bins = cos_m.shape[1]
    basis = torch.from_numpy(np.concatenate([cos_m, sin_m], axis=1)).to(x.device)
    dt = compute_dtype or torch.float32
    frames = x.unfold(1, frame_length, hop_length)  # (B, frames, frame_length) view
    acc = torch.matmul(frames.to(dt).float(), basis.to(dt).float())
    re, im = acc[..., :n_bins], acc[..., n_bins:]
    return re * re + im * im


def _log(mel, log_mode: str, log_offset: float):
    if log_mode == "db":  # the kernels' form of 10*log10(max(m, 1e-10))
        return 10.0 * (torch.log(torch.clamp(mel, min=1e-10)) * 0.43429448190325176)
    if log_mode == "natural":
        return torch.log(mel + log_offset)
    raise ValueError(f"unknown log_mode {log_mode!r}")


def log_mel_halo_plain(audio, *, frame_length: int, hop_length: int, n_fft: int, fb: np.ndarray,
                       center: bool = True, log_mode: str = "db", log_offset: float = 0.01,
                       out_affine=None, out_dtype=None):
    """The kernel's arithmetic in plain tensor ops: bf16 frames x bf16
    basis cut to the filterbank support (``_fb_support_bins``), f32
    accumulation, power, f32 mel product, log, affine, cast."""
    x = audio.float()
    if center:
        x = _reflect_pad(x, frame_length)
    n_keep = _fb_support_bins(fb)
    cos_m, sin_m = _dft_matrices(frame_length, n_fft, "hann")
    basis = np.concatenate([cos_m[:, :n_keep], sin_m[:, :n_keep]], axis=1)
    basis = torch.from_numpy(basis).to(x.device, torch.bfloat16).float()
    frames = x.unfold(1, frame_length, hop_length).to(torch.bfloat16).float()
    fb_t = torch.from_numpy(np.ascontiguousarray(fb[:n_keep], np.float32)).to(x.device)
    acc = torch.matmul(frames, basis)
    re, im = acc[..., :n_keep], acc[..., n_keep:]
    lm = _log(torch.matmul(re * re + im * im, fb_t), log_mode, log_offset)
    if out_affine is not None:
        sc, of = out_affine
        lm = lm * sc.float() + of.float()
    return lm.to(out_dtype or torch.float32)


@lru_cache(maxsize=16)
def _halo_tables(frame_length: int, n_fft: int, fb_bytes: bytes, n_mels: int, device: str):
    """Kernel tables on ``device``: the (K, 2*n_keep) bf16 basis with cos/sin
    columns interleaved and zero rows from frame_length up to K (a multiple
    of 32), and the (n_keep, n_mels) f32 filterbank rows, n_keep padded to a
    multiple of 32 with zero columns / rows."""
    fb = np.frombuffer(fb_bytes, np.float32).reshape(-1, n_mels)
    n_keep = _fb_support_bins(fb)
    n_keep_p = -(-n_keep // 32) * 32
    k_pad = -(-frame_length // 32) * 32
    cos_m, sin_m = _dft_matrices(frame_length, n_fft, "hann")
    basis = np.zeros((k_pad, 2 * n_keep_p), np.float32)
    basis[:frame_length, 0 : 2 * n_keep : 2] = cos_m[:, :n_keep]
    basis[:frame_length, 1 : 2 * n_keep : 2] = sin_m[:, :n_keep]
    fb_p = np.zeros((n_keep_p, n_mels), np.float32)
    fb_p[:n_keep] = fb[:n_keep]
    return (torch.from_numpy(basis).to(device, torch.bfloat16),
            torch.from_numpy(fb_p).to(device), k_pad, n_keep_p)


def _log_mel_halo_cuda(audio, *, frame_length, hop_length, n_fft, fb, center, log_mode,
                       log_offset, out_affine, out_dtype):
    out_dtype = out_dtype or torch.float32
    if audio.dtype != torch.float32 or audio.ndim != 2:
        raise NotImplementedError(f"log_mel kernel takes (B, n) float32 audio, got "
                                  f"{tuple(audio.shape)} {audio.dtype}")
    if log_mode not in _LOG_MODES or out_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"log_mel kernel: log_mode {log_mode!r}, out {out_dtype}")
    if hop_length % 8:
        raise NotImplementedError(f"log_mel kernel reads 16-byte rows: hop {hop_length} % 8 != 0")
    fb = np.ascontiguousarray(fb, np.float32)
    basis, fb_p, k_pad, n_keep = _halo_tables(frame_length, n_fft, fb.tobytes(), fb.shape[1],
                                              str(audio.device))
    # the JAX wrapper's prologue (mel.py:417-443): reflect pad, bf16, hop rows
    x = _reflect_pad(audio, frame_length) if center else audio
    b, n_mels = x.shape[0], fb.shape[1]
    n_frames = (x.shape[1] - frame_length) // hop_length + 1
    if n_frames < 1:
        raise ValueError(f"{x.shape[1]} samples hold no {frame_length}-sample frame")
    clip_stride = -(-((n_frames - 1) * hop_length + k_pad) // 8) * 8
    hops = torch.zeros((b, clip_stride), dtype=torch.bfloat16, device=x.device)
    m = min(clip_stride, x.shape[1])
    hops[:, :m] = x[:, :m]
    sc = of = None
    if out_affine is not None:
        sc, of = (t.to(x.device, torch.float32).contiguous() for t in out_affine)
        require_cuda(sc, of, dtype=torch.float32)
    power = torch.empty((b, n_frames, n_keep), dtype=torch.float32, device=x.device)
    out = torch.empty((b, n_frames, n_mels), dtype=out_dtype, device=x.device)
    KERNEL.launch("am_log_mel", hops, clip_stride, hop_length, k_pad, n_frames, basis, n_keep,
                  power, fb_p, sc, of, n_mels, _LOG_MODES[log_mode], float(log_offset),
                  int(out_dtype == torch.bfloat16), out, b)
    KERNEL.launches += 1
    return out


def log_mel_halo(audio, *, frame_length: int, hop_length: int, n_fft: int, fb: np.ndarray,
                 center: bool = True, log_mode: str = "db", log_offset: float = 0.01,
                 out_affine=None, out_dtype=None):
    """audio (B, n) f32 -> log-mel (B, n_frames, n_mels) of ``out_dtype``
    (default f32): bf16 DFT of Hann frames (``center`` reflect-pads by
    frame_length//2), power, the ``fb`` (n_fft//2+1, n_mels) mel product in
    f32, ``log_mode`` "db" (10*log10(max(m, 1e-10))) or "natural"
    (log(m + log_offset)), then ``lm * scale + offset`` for ``out_affine``."""
    fn = log_mel_halo_plain if audio.device.type == "cpu" else _log_mel_halo_cuda
    return fn(audio, frame_length=frame_length, hop_length=hop_length, n_fft=n_fft, fb=fb,
              center=center, log_mode=log_mode, log_offset=log_offset, out_affine=out_affine,
              out_dtype=out_dtype)


def log_mel_spectrogram(audio, sampling_rate: int, frame_length: int, hop_length: int,
                        n_mels: int, fmin: float, fmax: float, n_fft: int | None = None,
                        center: bool = True,
                        mel_norm: str | None = "slaney", mel_scale: str = "slaney",
                        triangle_domain: str = "hz", zero_dc: bool = False,
                        log_mode: str = "db", log_offset: float = 0.01, compute_dtype=None,
                        out_affine=None, out_dtype=None):
    """audio (B, n) -> log-mel (B, frames, n_mels): ``log_mode`` "db"
    (10*log10(max(mel, 1e-10)), the CLAP convention) or "natural"
    (log(mel + log_offset), VGGish).  ``out_affine`` (scale, offset) is a
    per-bin affine applied to the log-mel (the bf16 CLAP forward folds
    BatchNorm here); ``out_dtype`` the output dtype (default f32).  A CUDA
    tensor with bf16 compute goes to the halo log-mel kernel."""
    fb = mel_filter_bank(
        (n_fft or frame_length) // 2 + 1, n_mels, float(fmin), float(fmax),
        int(sampling_rate), norm=mel_norm, mel_scale=mel_scale,
        triangle_domain=triangle_domain, zero_dc=zero_dc,
    ).astype(np.float32)
    if audio.is_cuda and compute_dtype == torch.bfloat16:
        return log_mel_halo(
            audio, frame_length=frame_length, hop_length=hop_length,
            n_fft=n_fft or frame_length, fb=fb, center=center, log_mode=log_mode,
            log_offset=log_offset, out_affine=out_affine, out_dtype=out_dtype,
        )
    spec = stft_power(audio, frame_length, hop_length, n_fft=n_fft, center=center,
                      compute_dtype=compute_dtype)
    mel = torch.matmul(spec, torch.from_numpy(fb).to(spec.device))
    if log_mode == "db":
        lm = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    elif log_mode == "natural":
        lm = torch.log(mel + log_offset)
    else:
        raise ValueError(f"unknown log_mode {log_mode!r}")
    if out_affine is not None:
        sc, of = out_affine
        lm = lm * sc.float() + of.float()
    return lm.to(out_dtype or torch.float32)
