"""Frechet Audio Distance.

Counterpart of ``audio_metrics_tpu/metrics/fad.py``:

- the host float64 path (:38-70, :261-301), the oracle:
  ``FAD = |mu_x - mu_y|^2 + Tr Sx + Tr Sy - 2 Tr sqrt(Sx Sy)`` with
  ``Tr sqrt(Sx Sy) = Tr sqrt(L^T Sy L)`` for ``Sx = L L^T``;
- the ``nsdev`` device tail (:73-130, :180-260): ``M = L^T C L`` and a
  coupled Newton-Schulz ``Tr sqrt(M)`` in f32 on the device against the
  reference Cholesky factor, cached on the device per reference.  Its
  products run in full f32: TF32 is switched off for the duration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import AudioMetricsData
from ..utils.precision import full_f32

__all__ = ["frechet_distance", "trace_sqrtm_product", "fad_device_tail"]

NS_ITERS = 30


def _sym_sqrtm(a: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(a)
    return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.T


def trace_sqrtm_product(sigma_x, sigma_y, chol_x=None) -> float:
    """``Tr sqrt(sigma_x @ sigma_y)`` for symmetric PSD inputs, f64."""
    l = chol_x
    if l is None:
        try:
            l = np.linalg.cholesky(sigma_x)
        except np.linalg.LinAlgError:
            l = None
    if l is None:
        sx_half = _sym_sqrtm(sigma_x)
        m = sx_half @ sigma_y @ sx_half
    else:
        m = l.T @ sigma_y @ l
    return float(np.sqrt(np.clip(np.linalg.eigvalsh(m), 0.0, None)).sum())


def _frechet_distance(mu_x, sigma_x, mu_y, sigma_y, chol_x=None) -> float:
    mu_x, mu_y = np.asarray(mu_x, np.float64), np.asarray(mu_y, np.float64)
    sigma_x, sigma_y = np.asarray(sigma_x, np.float64), np.asarray(sigma_y, np.float64)
    a = float(np.sum(np.square(mu_x - mu_y)))
    b = float(np.trace(sigma_x) + np.trace(sigma_y))
    return a + b - 2.0 * trace_sqrtm_product(sigma_x, sigma_y, chol_x=chol_x)


def frechet_distance(x: AudioMetricsData, y: AudioMetricsData) -> float:
    """Host f64 FAD; the similarity transform runs on ``y``'s (the
    reference's) side when its covariance has a Cholesky factor, which is
    cached across evaluates."""
    mx, sx, _ = x.stats()
    my, sy, _ = y.stats()
    chol_y = y.chol_cov()
    if chol_y is not None:
        return _frechet_distance(my, sy, mx, sx, chol_x=chol_y)
    return _frechet_distance(mx, sx, my, sy)


def _ns_trace_sqrt_sym(m: torch.Tensor, n_iter: int = NS_ITERS) -> torch.Tensor:
    """``Tr sqrt(M)`` for symmetric PSD ``M`` by coupled Newton-Schulz on
    ``A = M / ||M||_F``: ``Y <- Y (3I - ZY)/2, Z <- (3I - ZY)/2 Z`` so that
    ``Y -> sqrt(A)``; products only."""
    eye = torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
    norm = torch.sqrt(torch.sum(m * m)) + 1e-30
    y, z = m / norm, eye
    with full_f32():
        for _ in range(n_iter):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
    return torch.sqrt(norm) * torch.trace(y)


def _ref_chol_device(ref: AudioMetricsData, l: np.ndarray, device) -> torch.Tensor:
    """f32 device copy of the reference Cholesky factor, cached by factor
    identity (uploaded once per reference)."""
    hit = ref.cache.get("chol_dev")
    if hit is not None and hit[0] is l and hit[1].device == device:
        return hit[1]
    l_dev = torch.as_tensor(l, dtype=torch.float32, device=device)
    ref.cache["chol_dev"] = (l, l_dev)
    return l_dev


def fad_device_tail(cand: AudioMetricsData, ref: AudioMetricsData) -> float | None:
    """FAD with the candidate's moments still on the device.

    Applies when ``cand`` holds exactly one pending device moment triple
    with n > d (full-rank covariance) and ``ref`` has a Cholesky factor;
    returns None otherwise (the caller takes :func:`frechet_distance`).
    ``cand``'s pending triple stays in place."""
    if len(cand._pending) != 1:
        return None
    n, s1, m2 = cand._pending[0]
    d = m2.shape[0]
    if n <= d:
        return None
    l = ref.chol_cov()
    if l is None or l.shape[0] != d:
        return None
    l_dev = _ref_chol_device(ref, l, m2.device)
    with full_f32():
        c = m2 * (1.0 / (n - 1))
        m = l_dev.T @ (c @ l_dev)
        m = 0.5 * (m + m.T)
        tr_x = torch.diagonal(c).double().sum()
    trsqrt = _ns_trace_sqrt_sym(m)
    mu_ref, cov_ref, _ = ref.stats()
    mu_x = s1.double().cpu().numpy() / n
    a = float(np.sum(np.square(mu_x - mu_ref)))
    b = float(tr_x) + float(np.trace(cov_ref))
    return a + b - 2.0 * float(trsqrt)
