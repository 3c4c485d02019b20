"""Brick-wall lookahead peak limiter over a batch of signals.

Counterpart of ``audio_metrics_tpu/ops/limiter.py`` (the reference's
``numpy_audio_limiter.limit``: attack 0.99, release 0.99, delay 527,
threshold 0.5): an envelope follower ``e[t] = max(|x[t]|, r e[t-1])``, a
target gain ``threshold / e`` where the envelope exceeds the threshold, a
one-pole smoothed gain, applied to the signal delayed by ``delay - 1``
samples.

- "blocked" (default): the envelope is a max-plus linear recurrence, so per
  chunk of (at most) 1024 samples it is a weighted ``cummax`` and the carry
  across chunks a short max-convolution; the smoother is
  ``ops.iir.lfilter_blocked`` plus the ``a^(t+1)`` term of its g[-1] = 1
  start.  f32 powers as in the JAX code: a float64 power would change which
  near-threshold samples limit.
- "scan": the recurrence sample by sample in f32 on the host (the oracle).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .iir import lfilter_blocked

__all__ = ["limit_batch", "limit"]


def _delayed(x: torch.Tensor, delay: int) -> torch.Tensor:
    """``x`` read through the limiter's ring buffer of ``delay`` slots: at
    step i the read slot holds x[i - (delay - 1)], zeros before the start."""
    lag = delay - 1
    return F.pad(x, (lag, 0))[:, : x.shape[1]] if lag else x


def _limit_scan(x: torch.Tensor, attack_coeff: float, release_coeff: float,
                threshold: float, delay: int) -> torch.Tensor:
    """The limiter's recurrence one sample at a time, f32 on the host
    (audio_metrics_tpu/ops/limiter.py:38-69): the oracle of
    :func:`_limit_blocked`.  (B, n) -> (B, n) f32 on ``x``'s device."""
    xs = np.asarray(x.detach().cpu(), np.float32)
    ds = np.asarray(_delayed(x, delay).detach().cpu(), np.float32)
    r, a = np.float32(release_coeff), np.float32(attack_coeff)
    one_minus_a, thr = np.float32(1.0 - attack_coeff), np.float32(threshold)
    envelope = np.zeros(xs.shape[0], np.float32)
    gain = np.ones(xs.shape[0], np.float32)
    y = np.empty_like(xs)
    with np.errstate(divide="ignore"):
        for i in range(xs.shape[1]):
            envelope = np.maximum(np.abs(xs[:, i]), envelope * r)
            target = np.where(envelope > thr, thr / envelope, np.float32(1.0))
            gain = gain * a + target * one_minus_a
            y[:, i] = ds[:, i] * gain
    return torch.from_numpy(y).to(x.device)


def _limit_blocked(x: torch.Tensor, attack_coeff: float, release_coeff: float,
                   threshold: float, delay: int, block: int = 1024) -> torch.Tensor:
    """The limiter as parallel operations (audio_metrics_tpu/ops/limiter.py:
    72-125), (B, n) f32 -> (B, n) f32 on ``x``'s device."""
    b_sz, n = x.shape
    # the within-chunk weights r^-j must stay finite in f32: cap the chunk
    # so that r^-(block-1) < ~1e30 (r = 0.99 allows the full 1024)
    max_block = int(30.0 * np.log(10.0) / max(-np.log(release_coeff), 1e-9))
    while block > 16 and block > max_block:
        block //= 2
    r = torch.tensor(release_coeff, dtype=torch.float32, device=x.device)
    delayed = _delayed(x, delay)

    nb = -(-n // block)
    axr = F.pad(x.abs(), (0, nb * block - n)).reshape(b_sz, nb, block)
    j = torch.arange(block, dtype=torch.float32, device=x.device)
    # within-chunk zero-history envelope: r^t * cummax(|x_j| r^-j)
    e0 = torch.cummax(axr * (r ** -j), dim=2).values * (r ** j)
    # cross-chunk carry E_{i-1} = max_k r^(k*block) u_{i-1-k}: the weights
    # fall below 1e-12 within a few chunks, so a short max-convolution
    u = e0[:, :, -1]
    n_carry = min(nb, int(np.ceil(-12 / np.log10(release_coeff ** block))) + 1)
    carry = torch.zeros((b_sz, nb), dtype=torch.float32, device=x.device)
    for k in range(n_carry):
        shifted = F.pad(u, (k + 1, 0))[:, :nb]
        carry = torch.maximum(carry, shifted * float(np.float32(release_coeff ** (k * block))))
    e = torch.maximum(e0, carry[:, :, None] * (r ** (j + 1.0)))
    e = e.reshape(b_sz, nb * block)[:, :n]

    tg = torch.where(e > threshold, threshold / torch.clamp(e, min=1e-30), 1.0)
    # one-pole smoothing with g[-1] = 1: zero-state lfilter + a^(t+1)
    a = torch.tensor(attack_coeff, dtype=torch.float32, device=x.device)
    g = lfilter_blocked((1.0 - attack_coeff,), (1.0, -attack_coeff), tg) + a ** (
        torch.arange(n, dtype=torch.float32, device=x.device) + 1.0)
    return delayed * g


def limit_batch(signal, attack_coeff: float = 0.99, release_coeff: float = 0.99,
                delay: int = 527, threshold: float = 0.5, method: str = "blocked"):
    """Limit a batch of signals: (B, n) or (n,) -> the same shape, f32 on
    the signal's device (a numpy array on the CPU)."""
    x = torch.as_tensor(signal).float()
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    fn = _limit_blocked if method == "blocked" else _limit_scan
    y = fn(x, float(attack_coeff), float(release_coeff), float(threshold), int(delay))
    return y[0] if squeeze else y


def limit(signal, attack_coeff=0.99, release_coeff=0.99, delay=527, threshold=0.5):
    """``numpy_audio_limiter.limit``'s signature: (channels, n) float32 in,
    numpy float32 out."""
    return limit_batch(signal, attack_coeff, release_coeff, delay, threshold).cpu().numpy()
