"""Rational resampling as one strided convolution per batch.

Counterpart of ``audio_metrics_tpu/ops/resample.py``: the same numpy
filter design (a Kaiser-windowed sinc, ``scipy.signal.resample_poly``'s
for the "hq" quality), the same centering and output length
``ceil(n * up / down)``.  The JAX package zero-stuffs the input by ``up``
(``lhs_dilation``) and convolves with all taps; here the filter is split
into its ``up`` polyphase components, so each output sample takes only the
~``len(h) / up`` taps that meet input samples: for 44.1 -> 48 kHz (up 160,
down 147, 3201 taps) 21 products instead of 3201.  Output phase ``r`` of
every group of ``up`` outputs reads input samples from offset ``i0_r``, so
the phases are the ``up`` output channels of one ``conv1d`` of stride
``down``, each phase's taps placed at its offset in a kernel of ``max(i0_r)
- i0_0 + ceil(len(h) / up)`` taps.  It runs in full f32
(``utils.precision.full_f32``): cuDNN would otherwise take TF32.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import full_f32

__all__ = ["resample", "resample_batch", "design_resample_filter", "polyphase_kernel",
           "RESAMPLE_QUALITIES"]


def _kaiser_sinc_filter(numtaps: int, cutoff: float, beta: float) -> np.ndarray:
    """Lowpass FIR via Kaiser-windowed sinc (== scipy firwin, scale=True);
    ``cutoff`` relative to the Nyquist frequency."""
    alpha = 0.5 * (numtaps - 1)
    m = np.arange(numtaps) - alpha
    h = cutoff * np.sinc(cutoff * m)
    h *= np.kaiser(numtaps, beta)
    h /= h.sum()
    return h


# quality -> (Kaiser beta, half-length multiplier): "hq" is scipy's
# resample_poly design, "vhq" a narrower transition band and a stopband
# below the f32 noise floor (the JAX package's table)
RESAMPLE_QUALITIES = {"hq": (5.0, 10), "vhq": (14.0, 24)}


@lru_cache(maxsize=None)
def design_resample_filter(up: int, down: int, beta: float = 5.0, half_len_mult: int = 10):
    """``(h, up, down, n_pre_remove)``: the f32 anti-aliasing filter (gain
    ``up``, pre-padded so that the output is centered) for the reduced
    ratio up/down, and the leading outputs of the full ``upfirdn`` to
    drop."""
    g = gcd(up, down)
    up, down = up // g, down // g
    max_rate = max(up, down)
    half_len = half_len_mult * max_rate
    h = _kaiser_sinc_filter(2 * half_len + 1, 1.0 / max_rate, beta) * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    return h.astype(np.float32), up, down, n_pre_remove


@lru_cache(maxsize=None)
def polyphase_kernel(up: int, down: int, beta: float = 5.0, half_len_mult: int = 10):
    """``(w, left, up, down)``: the (up, 1, K) f32 conv1d kernel of the
    polyphase form and the left zero pad of the input.

    Output ``m = r + j*up`` of ``upfirdn(h, x, up, down)[n_pre_remove:]`` is
    ``sum_q h[p_r + q*up] * x[i0_r + j*down - q]`` with ``t = (r +
    n_pre_remove) * down``, ``p_r = t % up``, ``i0_r = t // up``.  A stride
    ``down`` conv1d over the input padded by ``left`` on the left computes
    ``sum_k w[r, k] * x[j*down + k - left]``, so phase ``r``'s tap ``q``
    sits at ``k = i0_r - q + left``, with ``left`` chosen so that the
    smallest ``k`` is 0 (``left`` >= 9: the filter's half length is at
    least 10 * up taps)."""
    h, up, down, n_pre_remove = design_resample_filter(up, down, beta, half_len_mult)
    n_taps = -(-len(h) // up)
    t = (np.arange(up) + n_pre_remove) * down
    phase, i0 = t % up, t // up
    left = n_taps - 1 - int(i0.min())
    w = np.zeros((up, int(i0.max()) + left + 1), np.float32)
    for r in range(up):
        taps = h[phase[r] :: up]
        w[r, i0[r] + left - np.arange(len(taps))] = taps
    return w[:, None, :], left, up, down


def resample_batch(audio, sr_orig: int, sr_new: int, quality: str = "hq") -> torch.Tensor:
    """(B, n) f32 -> (B, ceil(n * up / down)) f32 on ``audio``'s device
    (a numpy array is taken to the CPU), and (B, n, C) -> (B, ceil(n * up /
    down), C) channel by channel; ``quality`` a key of
    ``RESAMPLE_QUALITIES``.  Each row is ``scipy.signal.resample_poly(row,
    up, down)`` for "hq", to f32 rounding."""
    x = torch.as_tensor(audio).float()
    if sr_orig == sr_new:
        return x
    if x.ndim == 3:
        y = resample_batch(x.movedim(2, 1).reshape(-1, x.shape[1]), sr_orig, sr_new, quality)
        return y.reshape(x.shape[0], x.shape[2], -1).movedim(1, 2)
    w, left, up, down = polyphase_kernel(int(sr_new), int(sr_orig), *RESAMPLE_QUALITIES[quality])
    b, n = x.shape
    n_out = -(-n * up // down)
    n_j = -(-n_out // up)
    right = max(0, (n_j - 1) * down + w.shape[2] - left - n)
    xp = F.pad(x, (left, right))
    with full_f32():
        y = F.conv1d(xp[:, None, :], torch.from_numpy(w).to(x.device), stride=down)
    return y[:, :, :n_j].transpose(1, 2).reshape(b, n_j * up)[:, :n_out]


def resample(item, sr_orig: int, sr_new: int, quality: str = "hq") -> np.ndarray:
    """One item, (n_samples,) or (n_samples, n_channels), like soxr
    (reference embed.py:69-83): numpy in, numpy f32 out."""
    x = np.asarray(item, np.float32)
    if x.ndim not in (1, 2):
        raise ValueError(f"expected 1-D or 2-D audio, got shape {x.shape}")
    rows = torch.from_numpy(np.ascontiguousarray(x.T if x.ndim == 2 else x[None]))
    y = resample_batch(rows, sr_orig, sr_new, quality).numpy()
    return y.T if x.ndim == 2 else y[0]
