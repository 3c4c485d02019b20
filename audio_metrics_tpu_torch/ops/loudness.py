"""ITU-R BS.1770-4 integrated loudness of a batch of signals.

Counterpart of ``audio_metrics_tpu/ops/loudness.py``: the K-weighting
(``ops.iir``), 400 ms blocks at a 100 ms step as stride-sized sub-block
means plus a length-4 sliding mean, the absolute gate at -70 LKFS and the
relative gate at the ungated mean - 10 LU, over the whole batch on its
device.  The gating runs in f32 and returns float64, as the JAX package's
(x64 on) does; ``method="scan"`` runs in float64 throughout (the oracle).
"""

from __future__ import annotations

import numpy as np
import torch

from .iir import (
    _k_weighting_parallel,
    _k_weighting_sections,
    biquad_cascade,
    cascade_impulse_response,
    k_weighting_coeffs,
    lfilter_blocked,
)

__all__ = ["integrated_loudness_batch", "k_weighted", "Meter", "CHANNEL_GAINS"]

# channel gains [L, R, C, Ls, Rs] (BS.1770 table)
CHANNEL_GAINS = np.array([1.0, 1.0, 1.0, 1.41, 1.41])

_ABS_THRESHOLD = -70.0  # LKFS absolute gate


def k_weighted(x: torch.Tensor, sr: int, method: str = "blocked") -> torch.Tensor:
    """The K-weighting cascade, (B, n) -> (B, n) (audio_metrics_tpu/ops/
    loudness.py:40-82): "blocked" (default), the low-transient cascade
    sections each through ``lfilter_blocked``; "blocked-parallel", the
    partial-fraction sections on the same input; "fir", an FFT convolution
    with the cascade's 4096-tap impulse response; "scan", the biquads in
    float64 (``biquad_cascade``)."""
    if method == "scan":
        b, a = k_weighting_coeffs(float(sr))
        return biquad_cascade(x, b, a)
    xf = x.float()
    if method == "blocked":
        y = xf
        for b, a in _k_weighting_sections(float(sr)):
            y = lfilter_blocked(b, a, y)
        return y
    if method == "blocked-parallel":
        k0, sections = _k_weighting_parallel(float(sr))
        y = xf * np.float32(k0).item()
        for b, a in sections:
            y = y + lfilter_blocked(b, a, xf)
        return y
    if method != "fir":
        raise ValueError(f"unknown K-weighting method {method!r}")
    ir = torch.from_numpy(cascade_impulse_response(float(sr)).astype(np.float32)).to(x.device)
    n = xf.shape[-1]
    nfft = 1 << (n + len(ir) - 1).bit_length()
    out = torch.fft.irfft(torch.fft.rfft(xf, nfft) * torch.fft.rfft(ir, nfft)[None], nfft)
    return out[:, :n].float()


def _gated_loudness(z: torch.Tensor) -> torch.Tensor:
    """BS.1770 two-stage gating over per-block mean-square powers ``z``
    (B, C, n_blocks), in ``z``'s dtype (audio_metrics_tpu/ops/loudness.py:
    85-120).  The JAX floor ``max(., 1e-300)`` rounds to 0 in f32, so a
    silent block reads -inf there, and so here."""
    n_ch = z.shape[1]
    gains = torch.as_tensor(CHANNEL_GAINS[:n_ch], dtype=z.dtype, device=z.device)
    weighted = torch.einsum("c,bcn->bn", gains, z)
    floor = torch.tensor(1e-300, dtype=z.dtype, device=z.device)
    l_blocks = -0.691 + 10.0 * torch.log10(torch.maximum(weighted, floor))

    # absolute gate
    j_abs = l_blocks >= _ABS_THRESHOLD
    count_abs = j_abs.sum(dim=-1)
    z_abs = torch.where(j_abs[:, None, :], z, 0.0).sum(dim=-1) / torch.clamp(
        count_abs[:, None], min=1)
    gamma_r = -0.691 + 10.0 * torch.log10(
        torch.maximum(torch.einsum("c,bc->b", gains, z_abs), floor)) - 10.0

    # relative + absolute gate
    j_rel = (l_blocks > gamma_r[:, None]) & (l_blocks > _ABS_THRESHOLD)
    count_rel = j_rel.sum(dim=-1)
    z_rel = torch.where(j_rel[:, None, :], z, 0.0).sum(dim=-1) / torch.clamp(
        count_rel[:, None], min=1)
    lufs = -0.691 + 10.0 * torch.log10(
        torch.maximum(torch.einsum("c,bc->b", gains, z_rel), floor))
    return torch.where((count_abs == 0) | (count_rel == 0), -torch.inf, lufs)


def integrated_loudness_batch(audio, sr: int, method: str = "blocked") -> torch.Tensor:
    """Integrated gated loudness per item: (B, n) mono or (B, n, C)
    multichannel -> (B,) LUFS, float64 on the audio's device
    (audio_metrics_tpu/ops/loudness.py:123-171).  ``method``: see
    :func:`k_weighted`; the gating is f32 but for "scan" (float64)."""
    dtype = torch.float64 if method == "scan" else torch.float32
    x = torch.as_tensor(audio).to(dtype)
    if x.ndim == 1:
        x = x[None, :, None]
    elif x.ndim == 2:
        x = x[:, :, None]
    b_sz, n, n_ch = x.shape

    block = int(0.4 * sr)
    stride = int(0.4 * 0.25 * sr)  # 75% overlap -> 100 ms step
    n_sub = n // stride
    if n_sub < 4:
        raise ValueError(
            f"audio too short for loudness gating: {n} samples < {block} "
            f"({sr} Hz, 400 ms blocks)"
        )

    # K-weight each channel (batched over B*C signals)
    flat = x.movedim(2, 1).reshape(b_sz * n_ch, n)
    filtered = k_weighted(flat, sr, method=method)
    sq = filtered * filtered

    n_blocks = (n - block) // stride + 1
    if block == 4 * stride:
        # stride-sized sub-block means + a length-4 sliding mean
        sub = sq[:, : n_sub * stride].reshape(b_sz * n_ch, n_sub, stride).mean(-1)
        z = (sub[:, 0:-3] + sub[:, 1:-2] + sub[:, 2:-1] + sub[:, 3:]) / 4.0
        z = z[:, :n_blocks]
    else:
        # block not a multiple of the stride: differences of a cumulative sum
        cs = torch.cat([torch.zeros((b_sz * n_ch, 1), dtype=sq.dtype, device=sq.device),
                        torch.cumsum(sq, dim=1)], dim=1)
        starts = torch.arange(n_blocks, device=sq.device) * stride
        z = (cs[:, starts + block] - cs[:, starts]) / block

    return _gated_loudness(z.reshape(b_sz, n_ch, -1)).double()


class Meter:
    """BS.1770 meter with the reference's pyloudnorm-based ``Meter``
    interface (audio_metrics_tpu/ops/loudness.py:174-191): the three
    ``integrated_loudness`` variants are one batched computation on
    ``device``."""

    def __init__(self, rate: int, device="cuda"):
        from ..models.base import resolve_device

        self.rate = int(rate)
        self.block_size = 0.400
        self.G = CHANNEL_GAINS
        self.device = resolve_device(device)

    def integrated_loudness(self, data) -> float:
        x = torch.as_tensor(np.asarray(data, np.float64), device=self.device)
        return float(integrated_loudness_batch(x[None], self.rate)[0])

    # the reference's two optimised variants
    integrated_loudness_fast = integrated_loudness
    integrated_loudness_numba = integrated_loudness
