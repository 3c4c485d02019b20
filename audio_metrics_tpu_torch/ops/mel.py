"""Log-mel spectrogram as products (plain PyTorch).

Counterpart of the plain half of ``audio_metrics_tpu/ops/mel.py``
(:80-230, :574-668): the filterbank and windowed-DFT tables are the same
numpy code; framing is a hop-strided view, the DFT is a product with the
``window * cos`` / ``window * sin`` basis, and the mel projection a second
product.  The CLAP 5 s path does not come here on a card: it goes through
the fused frontend kernel (ops/frontend_fused.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["mel_filter_bank", "stft_power", "log_mel_spectrogram"]


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
) -> np.ndarray:
    """Triangular mel filterbank (num_frequency_bins, num_mel_filters),
    librosa construction (slopes in hertz)."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)
    mel_min = _hertz_to_mel(min_frequency, mel_scale)
    mel_max = _hertz_to_mel(max_frequency, mel_scale)
    mel_points = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hertz(mel_points, mel_scale)
    fdiff = np.diff(filter_freqs)
    slopes = filter_freqs[np.newaxis, :] - fft_freqs[:, np.newaxis]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    weights = np.maximum(0.0, np.minimum(down, up))
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


def stft_power(audio, frame_length: int, hop_length: int, n_fft: int | None = None,
               compute_dtype=None):
    """Power spectrogram of uncentered Hann-windowed frames via a DFT
    product: (B, n) -> (B, frames, n_fft//2+1) f32.  ``compute_dtype``
    rounds the frame samples and the basis (bf16 on the bf16 forward); the
    product accumulates in f32 either way."""
    x = audio.float()
    n_fft = n_fft or frame_length
    cos_m, sin_m = _dft_matrices(frame_length, n_fft, "hann")
    n_bins = cos_m.shape[1]
    basis = torch.from_numpy(np.concatenate([cos_m, sin_m], axis=1)).to(x.device)
    dt = compute_dtype or torch.float32
    frames = x.unfold(1, frame_length, hop_length)  # (B, frames, frame_length) view
    acc = torch.matmul(frames.to(dt).float(), basis.to(dt).float())
    re, im = acc[..., :n_bins], acc[..., n_bins:]
    return re * re + im * im


def log_mel_spectrogram(audio, sampling_rate: int, frame_length: int, hop_length: int,
                        n_mels: int, fmin: float, fmax: float, n_fft: int | None = None,
                        mel_norm: str | None = "slaney",
                        mel_scale: str = "slaney", compute_dtype=None, out_affine=None,
                        out_dtype=None):
    """audio (B, n) -> 10*log10(max(mel, 1e-10)) (B, frames, n_mels) over
    uncentered frames, the CLAP dB convention.  ``out_affine`` (scale,
    offset) is a per-bin affine applied to the log-mel (the bf16 forward
    folds BatchNorm here); ``out_dtype`` the output dtype (default f32)."""
    fb = mel_filter_bank(
        (n_fft or frame_length) // 2 + 1, n_mels, float(fmin), float(fmax),
        int(sampling_rate), norm=mel_norm, mel_scale=mel_scale,
    ).astype(np.float32)
    spec = stft_power(audio, frame_length, hop_length, n_fft=n_fft,
                      compute_dtype=compute_dtype)
    mel = torch.matmul(spec, torch.from_numpy(fb).to(spec.device))
    lm = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    if out_affine is not None:
        sc, of = out_affine
        lm = lm * sc.float() + of.float()
    return lm.to(out_dtype or torch.float32)
