"""IIR filtering of batches of signals: the BS.1770 K-weighting and the
limiter's one-pole smoother.

Counterpart of ``audio_metrics_tpu/ops/iir.py``.  The host table builders
(numpy float64, cached) are copies; ``lfilter_blocked`` runs the recurrence
as batched products on the tensor's device, in full f32
(``utils.precision.full_f32``: TF32 products would move a loudness by
~0.01 dB); ``biquad_cascade``, the float64 oracle, filters on the host with
``scipy.signal.lfilter``, as the JAX suite holds its scan to
(tests/test_dsp.py:59).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import full_f32
from .mel import device_table

__all__ = [
    "biquad_cascade",
    "k_weighting_coeffs",
    "cascade_impulse_response",
    "lfilter_blocked",
]


def biquad_cascade(x: torch.Tensor, b, a) -> torch.Tensor:
    """A cascade of biquads (rows of ``b``, ``a``, each normalised by its
    ``a[0]``) along the last axis of ``x`` ((B, n) or (n,)), zero initial
    state, in float64 on the host; float64 on ``x``'s device."""
    from scipy import signal

    y = np.asarray(x.detach().cpu(), np.float64)
    b, a = np.asarray(b, np.float64), np.asarray(a, np.float64)
    for bs, as_ in zip(b / a[:, :1], a / a[:, :1]):
        y = signal.lfilter(bs, as_, y, axis=-1)
    return torch.from_numpy(np.ascontiguousarray(y)).to(x.device)


# ----------------------------------------------------------------------
# blocked IIR: the recurrence as products (no scan, no FFT)
# ----------------------------------------------------------------------
@lru_cache(maxsize=None)
def _blocked_tables(b: tuple, a: tuple, block: int):
    """Host tables turning ``lfilter(b, a, x)`` into products
    (audio_metrics_tpu/ops/iir.py:79-145): ``(M, A, Pk, b)``.

    Within a chunk of ``block`` samples the zero-state response of the
    poles is a lower-triangular (L, L) product M; the chunk's output adds
    the initial-condition response A @ s, s = (y[-1], ..., y[-p]) at the
    chunk boundary, with s_i = sum_k P^k u_{i-1-k} over the zero-state
    boundary values u; P^k decays (a stable filter), so the sum stops at
    |P^k| < 1e-9 and rounding errors do not compound."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b, a = b / a[0], a / a[0]
    p = len(a) - 1
    L = block
    poles = np.roots(a)
    if p and np.max(np.abs(poles)) >= 1.0 - 1e-9:
        raise ValueError(
            f"lfilter_blocked requires a strictly stable filter "
            f"(max pole radius {np.max(np.abs(poles)):.6f})"
        )

    # pure-pole impulse response h (L taps): h[0]=1; h[t] = -sum a_j h[t-j]
    h = np.zeros(L)
    h[0] = 1.0
    for t in range(1, L):
        for j in range(1, p + 1):
            if t - j >= 0:
                h[t] -= a[j] * h[t - j]
    M = np.zeros((L, L), np.float32)
    for t in range(L):
        M[t, : t + 1] = h[t::-1]

    # initial-condition basis: r_j = response to y[-j]=1 (f=0)
    A = np.zeros((L, p))
    for j in range(1, p + 1):
        y = np.zeros(L + p)  # y[-p..-1] prepended
        y[p - j] = 1.0
        for t in range(L):
            acc = 0.0
            for k in range(1, p + 1):
                acc -= a[k] * y[p + t - k]
            y[p + t] = acc
        A[:, j - 1] = y[p:]

    # boundary propagation: s_{i+1,m} = y_i[L-m]; P[m-1, j-1] = r_j[L-m]
    P = np.zeros((p, p))
    for m in range(1, p + 1):
        P[m - 1] = A[L - m]
    Pk = []
    Q = np.eye(p)
    for _ in range(4096):
        if np.max(np.abs(Q)) < 1e-9:
            break
        Pk.append(Q.astype(np.float32))
        Q = P @ Q
    return (
        M,
        A.astype(np.float32),
        np.stack(Pk) if Pk else np.zeros((0, p, p), np.float32),
        b.astype(np.float32),
    )


@lru_cache(maxsize=None)
def _product_tables(key: tuple):
    """``(M^T, A^T, W)`` of ``_blocked_tables(*key)``, the operands of
    ``lfilter_blocked``'s products: W stacks the P^k transposed, (K p, p),
    so that the boundary sum is one product."""
    M, A, Pk, _ = _blocked_tables(*key)
    return M.T, A.T, Pk.transpose(0, 2, 1).reshape(-1, Pk.shape[1])


def _table(key: tuple, i: int):
    return _product_tables(key)[i]


def lfilter_blocked(b, a, x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """``scipy.signal.lfilter(b, a, x, axis=-1)`` (zero initial state) for
    a small-order filter, batched over rows: (B, n) -> (B, n) f32 on
    ``x``'s device, every sequential step a product
    (audio_metrics_tpu/ops/iir.py:148-197).  ~1e-4 relative signal error in
    f32, not compounding; ``biquad_cascade`` is the oracle."""
    x = x.float()
    bsz, n = x.shape
    key = (tuple(np.ravel(b)), tuple(np.ravel(a)), block)
    bn = _blocked_tables(*key)[3]
    m_t, a_t, w = (device_table(_table, (key, i), x.device) for i in range(3))
    p = a_t.shape[0]
    L = block
    nb = -(-n // L)

    # FIR part: f[t] = sum_j b_j x[t-j] (zero history before t=0)
    f = None
    for j, bj in enumerate(bn):
        xj = x if j == 0 else F.pad(x, (j, 0))[:, :n]
        term = xj * float(bj)
        f = term if f is None else f + term
    fr = F.pad(f, (0, nb * L - n)).reshape(bsz, nb, L)
    with full_f32():
        y0 = fr @ m_t  # zero-state chunk responses
        if p == 0:
            return y0.reshape(bsz, nb * L)[:, :n]
        # boundary states s_i = sum_k P^k u_{i-1-k}: the K shifted copies of
        # u side by side, times the stacked P^k, in one product
        u = y0[:, :, L - p :].flip(2)  # (B, nb, p): (y[L-1], ..., y[L-p])
        k_max = w.shape[0] // p
        shifted = torch.cat([F.pad(u, (0, 0, k + 1, 0))[:, :nb] for k in range(k_max)], dim=2)
        s = shifted @ w
        y = y0 + s @ a_t
    return y.reshape(bsz, nb * L)[:, :n]


@lru_cache(maxsize=None)
def _k_weighting_sections(rate: float):
    """K-weighting as low-transient cascade sections
    (audio_metrics_tpu/ops/iir.py:200-222): the shelf biquad, and the
    BS.1770 high-pass (Q = 0.5, an exactly repeated real pole) as two
    first-order sections with |h[t]| = p^t <= 1."""
    b, a = k_weighting_coeffs(rate)
    shelf_b = tuple(b[0] / a[0, 0])
    shelf_a = tuple(a[0] / a[0, 0])
    hb = b[1] / a[1, 0]
    ha = a[1] / a[1, 0]
    p = -ha[1] / 2.0
    if abs(ha[2] - p * p) >= 1e-12:
        raise ValueError("the BS.1770 high-pass pole is not repeated")
    return (
        (shelf_b, shelf_a),
        (tuple(hb), (1.0, -p)),
        ((1.0,), (1.0, -p)),
    )


@lru_cache(maxsize=None)
def _k_weighting_parallel(rate: float):
    """K-weighting in parallel (partial-fraction) form, ``(k0, ((b, a),
    ...))``: y = k0 x + the sections' outputs on the same input
    (audio_metrics_tpu/ops/iir.py:225-282)."""
    from scipy import signal

    b, a = k_weighting_coeffs(rate)
    b_c = np.convolve(b[0] / a[0, 0], b[1] / a[1, 0])
    a_c = np.convolve(a[0] / a[0, 0], a[1] / a[1, 0])
    r, p, k = signal.residuez(b_c, a_c)
    if len(k) != 1:
        raise ValueError("expected an equal-order K-weighting transfer function")
    sections = []
    used = [False] * len(p)
    for i in range(len(p)):
        if used[i]:
            continue
        if abs(p[i].imag) > 1e-9:
            # complex pair -> one real second-order section
            for j in range(i + 1, len(p)):
                if not used[j] and abs(p[j] - np.conj(p[i])) < 1e-6:
                    q, rr = p[i], r[i]
                    sections.append(
                        (
                            (2 * rr.real, -2 * (rr * np.conj(q)).real),
                            (1.0, -2 * q.real, abs(q) ** 2),
                        )
                    )
                    used[i] = used[j] = True
                    break
            else:  # pragma: no cover
                raise ValueError("unpaired complex pole")
        elif (
            i + 1 < len(p)
            and abs(p[i + 1] - p[i]) < 1e-5
            and abs(p[i + 1].imag) < 1e-9
        ):
            # repeated real pole: residuez orders ascending powers
            pp = p[i].real
            sections.append(((r[i].real,), (1.0, -pp)))
            sections.append(((r[i + 1].real,), (1.0, -2 * pp, pp * pp)))
            used[i] = used[i + 1] = True
        else:
            sections.append(((r[i].real,), (1.0, -p[i].real)))
            used[i] = True
    # drop numerically-zero sections (the double-pole residue vanishes for
    # the BS.1770 high-pass numerator)
    sections = tuple(
        (tuple(bb), tuple(aa))
        for bb, aa in sections
        if max(abs(x) for x in bb) > 1e-12
    )
    return float(k[0].real), sections


def _high_shelf(g_db: float, q: float, fc: float, rate: float):
    """RBJ cookbook high-shelf biquad (ITU-R BS.1770 pre-filter)."""
    a_lin = 10.0 ** (g_db / 40.0)
    w0 = 2.0 * np.pi * fc / rate
    alpha = np.sin(w0) / (2.0 * q)
    cos_w0 = np.cos(w0)
    sqrt_a = np.sqrt(a_lin)
    b0 = a_lin * ((a_lin + 1) + (a_lin - 1) * cos_w0 + 2 * sqrt_a * alpha)
    b1 = -2 * a_lin * ((a_lin - 1) + (a_lin + 1) * cos_w0)
    b2 = a_lin * ((a_lin + 1) + (a_lin - 1) * cos_w0 - 2 * sqrt_a * alpha)
    a0 = (a_lin + 1) - (a_lin - 1) * cos_w0 + 2 * sqrt_a * alpha
    a1 = 2 * ((a_lin - 1) - (a_lin + 1) * cos_w0)
    a2 = (a_lin + 1) - (a_lin - 1) * cos_w0 - 2 * sqrt_a * alpha
    return np.array([b0, b1, b2]), np.array([a0, a1, a2])


def _high_pass(q: float, fc: float, rate: float):
    """RBJ cookbook high-pass biquad (BS.1770 RLB weighting)."""
    w0 = 2.0 * np.pi * fc / rate
    alpha = np.sin(w0) / (2.0 * q)
    cos_w0 = np.cos(w0)
    b0 = (1 + cos_w0) / 2
    b1 = -(1 + cos_w0)
    b2 = (1 + cos_w0) / 2
    a0 = 1 + alpha
    a1 = -2 * cos_w0
    a2 = 1 - alpha
    return np.array([b0, b1, b2]), np.array([a0, a1, a2])


def k_weighting_coeffs(rate: float):
    """BS.1770 K-weighting: 4 dB shelf at 1500 Hz (Q=1/sqrt 2) + 38 Hz
    high-pass (Q=0.5), for any sample rate, as pyloudnorm computes it."""
    b1, a1 = _high_shelf(4.0, 1.0 / np.sqrt(2.0), 1500.0, rate)
    b2, a2 = _high_pass(0.5, 38.0, rate)
    return np.stack([b1, b2]), np.stack([a1, a2])


@lru_cache(maxsize=None)
def cascade_impulse_response(rate: float, n_taps: int = 4096) -> np.ndarray:
    """Truncated impulse response of the K-weighting cascade (host, float64,
    cached): its slowest pole decays below ~1e-4 within a few thousand
    samples at 48 kHz."""
    b, a = k_weighting_coeffs(rate)
    x = np.zeros(n_taps)
    x[0] = 1.0
    for s in range(b.shape[0]):
        b0, b1, b2 = b[s] / a[s, 0]
        a1, a2 = a[s, 1] / a[s, 0], a[s, 2] / a[s, 0]
        y = np.empty_like(x)
        z1 = z2 = 0.0
        for i in range(n_taps):
            y[i] = b0 * x[i] + z1
            z1 = b1 * x[i] - a1 * y[i] + z2
            z2 = b2 * x[i] - a2 * y[i]
        x = y
    return x
