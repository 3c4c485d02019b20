"""Frechet Audio Distance.

Counterpart of ``audio_metrics_tpu/metrics/fad.py``:

- the host float64 path (:38-70, :261-301), the oracle:
  ``FAD = |mu_x - mu_y|^2 + Tr Sx + Tr Sy - 2 Tr sqrt(Sx Sy)`` with
  ``Tr sqrt(Sx Sy) = Tr sqrt(L^T Sy L)`` for ``Sx = L L^T``;
- the device tail (:122-256): ``M = L^T C L`` in f32 on the device
  against the reference Cholesky factor, cached on the device per
  reference, then ``Tr sqrt(M)`` as ``AM_TPU_FAD_TAIL`` says, read at each
  call as the JAX package reads it (:144-145): ``nsdev`` (the default) a
  coupled Newton-Schulz iteration in f32 on the device; ``eigdev`` f32
  ``eigvalsh`` on the device, the square roots summed in float64 on the
  host; ``packed`` (and any value the JAX package does not name, which
  takes its ``packed`` branch) M pulled, float64 ``eigvalsh`` on the host;
  ``host`` no device tail: the caller takes the float64
  :func:`frechet_distance`.  Its products run in full f32: TF32 is
  switched off for the duration;
- ``fad_inf_parts`` (:304-418), FAD-inf: FAD at several subset sizes of
  the candidate, extrapolated linearly in 1/size to an infinite set, in
  float64 on the device (the JAX package: f32, whose Newton-Schulz
  diverges on the smallest subsets of real-sized sets; see its docstring).

The Newton-Schulz iteration count of the device tail and of FAD-inf is
``AM_TPU_FAD_NS_ITERS`` (default 30), read at each call as in the JAX
package (its ``_ns_iters``, :148-149).  ``frechet_distance(...,
method="newton_schulz")`` (:100-120) runs the jittered Cholesky, ``L^T Sy
L`` and the iteration at a fixed 30 iterations in float64 on ``device``,
as the JAX package runs them under its x64 mode (where n is little above d,
an f32 Cholesky of the candidate's covariance fails).
"""

from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch

from ..data import AudioMetricsData
from ..models.base import resolve_device
from ..utils.precision import full_f32

__all__ = ["FadInfUnavailable", "fad_device_tail", "fad_inf_parts", "frechet_distance",
           "trace_sqrtm_product", "trace_sqrtm_product_ns"]


NS_METHOD_ITERS = 30  # frechet_distance(method="newton_schulz"), as the JAX fad.py:100


def _ns_iters() -> int:
    return int(os.environ.get("AM_TPU_FAD_NS_ITERS", "30"))


def _fad_tail_mode() -> str:
    return os.environ.get("AM_TPU_FAD_TAIL", "nsdev")


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


def frechet_distance(x: AudioMetricsData, y: AudioMetricsData, method: str = "eigh",
                     device="cuda") -> float:
    """FAD between the Gaussian fits of ``x`` and ``y``
    (audio_metrics_tpu/metrics/fad.py:261-301).  ``method="eigh"``: host
    float64; the similarity transform runs on ``y``'s (the reference's)
    side when its covariance has a Cholesky factor, which is cached across
    evaluates.  ``method="newton_schulz"``: ``Tr sqrt(Sx Sy)`` in float64
    on ``device`` (default ``"cuda"``) by :func:`trace_sqrtm_product_ns`,
    the rest in float64 on the host.  Another method raises ``ValueError``."""
    mx, sx, _ = x.stats()
    my, sy, _ = y.stats()
    if method == "newton_schulz":
        mx, sx = np.asarray(mx, np.float64), np.asarray(sx, np.float64)
        my, sy = np.asarray(my, np.float64), np.asarray(sy, np.float64)
        a = float(np.sum(np.square(mx - my)))
        b = float(np.trace(sx) + np.trace(sy))
        return a + b - 2.0 * trace_sqrtm_product_ns(sx, sy, device)
    if method != "eigh":
        raise ValueError(f"Unknown FAD method {method!r}")
    chol_y = y.chol_cov()
    if chol_y is not None:
        return _frechet_distance(my, sy, mx, sx, chol_x=chol_y)
    return _frechet_distance(mx, sx, my, sy)


def trace_sqrtm_product_ns(sigma_x, sigma_y, device="cuda") -> float:
    """``Tr sqrt(Sx Sy)`` by products only (audio_metrics_tpu/metrics/
    fad.py:100-120), in float64 on ``device``, as the JAX package runs it
    under its x64 mode (and as :func:`fad_inf_parts` runs its sweep): ``Sx
    + eps I = L L^T`` with ``eps = 1e-10 Tr Sx / d + 1e-30``, then the
    coupled Newton-Schulz ``Tr sqrt`` of the symmetrised ``L^T Sy L`` at
    ``NS_METHOD_ITERS`` iterations.  nan where the jittered ``Sx`` has no
    float64 Cholesky factor (the JAX ``cholesky`` returns nan there)."""
    dev = resolve_device(device)
    sx = torch.as_tensor(np.asarray(sigma_x), dtype=torch.float64, device=dev)
    sy = torch.as_tensor(np.asarray(sigma_y), dtype=torch.float64, device=dev)
    d = sx.shape[0]
    eye = torch.eye(d, dtype=torch.float64, device=dev)
    eps = 1e-10 * torch.trace(sx) / d + 1e-30
    chol, info = torch.linalg.cholesky_ex(sx + eps * eye)
    m = chol.T @ sy @ chol
    trsqrt = _ns_trace_sqrt_sym(0.5 * (m + m.T), NS_METHOD_ITERS)
    return math.nan if int(info) else float(trsqrt)


def _ns_trace_sqrt_sym(m: torch.Tensor, n_iter: int | None = None) -> torch.Tensor:
    """``Tr sqrt(M)`` for symmetric PSD ``M`` by coupled Newton-Schulz on
    ``A = M / ||M||_F``: ``Y <- Y (3I - ZY)/2, Z <- (3I - ZY)/2 Z`` so that
    ``Y -> sqrt(A)``; products only.  ``n_iter`` defaults to
    ``AM_TPU_FAD_NS_ITERS``."""
    n_iter = _ns_iters() if n_iter is None else n_iter
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


def fad_device_tail(cand: AudioMetricsData, ref: AudioMetricsData,
                    mode: str | None = None) -> float | None:
    """FAD with the candidate's moments still on the device, its ``Tr
    sqrt(M)`` as ``mode`` says (default ``AM_TPU_FAD_TAIL``, read at each
    call, else ``nsdev``; the module docstring lists the modes).

    Applies when ``cand`` holds exactly one pending device moment triple
    with n > d (full-rank covariance) and ``ref`` has a Cholesky factor,
    and ``mode`` is not ``host``; returns None otherwise (the caller takes
    :func:`frechet_distance`).  ``cand``'s pending triple stays in place."""
    mode = _fad_tail_mode() if mode is None else mode
    if mode == "host" or len(cand._pending) != 1:
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
    if mode == "nsdev":
        trsqrt = float(_ns_trace_sqrt_sym(m))
    else:
        if mode == "eigdev":
            vals = torch.linalg.eigvalsh(m).double().cpu().numpy()
        else:  # "packed", and any value the JAX package does not name (fad.py:165-170)
            vals = np.linalg.eigvalsh(m.double().cpu().numpy())
        trsqrt = float(np.sqrt(np.clip(vals, 0.0, None)).sum())
    mu_ref, cov_ref, _ = ref.stats()
    mu_x = s1.double().cpu().numpy() / n
    a = float(np.sum(np.square(mu_x - mu_ref)))
    b = float(tr_x) + float(np.trace(cov_ref))
    return a + b - 2.0 * trsqrt


# ----------------------------------------------------------------------
# FAD-inf (audio_metrics_tpu/metrics/fad.py:304-418)
# ----------------------------------------------------------------------
class FadInfUnavailable(ValueError):
    """``fad_inf_parts`` cannot fit the extrapolation; the message names why."""


def fad_inf_parts(cand: AudioMetricsData, ref: AudioMetricsData, n_points: int = 8,
                  min_frac: float = 0.25, seed: int = 1234):
    """The FAD-inf subset sweep: ``(device_arrays, host_reduce)`` as the
    JAX package's ``fad_inf_parts`` returns them, ``host_reduce(arrays
    pulled to the host) -> {"fad_inf": intercept, "fad_inf_slope": c}``.

    Subset sizes are the distinct values of ``round(linspace(max(d + 2,
    min_frac * n), n, n_points))``, the last the whole set; each smaller
    subset is the head of ``default_rng(seed).permutation(n)``, drawn in
    the JAX package's call order, as a 0/1 row mask.  On the candidate's
    device, in float64: the subset means ``mask @ emb``, then one subset
    at a time (no (S, n, d) tensor) its centered covariance ``((X - mu_s)
    m_s)^T ((X - mu_s) m_s) / (n_s - 1)``, its trace, and ``Tr sqrt(L^T
    C_s L)`` by Newton-Schulz (``AM_TPU_FAD_NS_ITERS``) against the
    reference's Cholesky factor.  The reduce fits FAD(s) = fad_inf + c / s
    by float64 least squares on the host.

    The JAX package runs the sweep in f32 (``precision=HIGHEST``).  On
    HTSAT-base embeddings (d = 512, n = 2304; ``chip_smoke.py`` phase 16)
    the smallest subset's ``L^T C L`` has eigenvalues 2.9e-13..0.0117, and
    ``Z -> M^(-1/2)`` outgrows f32: its trace square root read 0.41994 on
    an H100 and 0.41427 on the host's CPU at 30 iterations, nan on both at
    60, against 0.41996 in float64, so the fitted FAD-inf read 5.642 on the
    card and -23.357 on the CPU.  In float64 the iteration holds (0.41996
    at 30 and 60 iterations on both; ROADMAP Queue 3).

    Raises ``FadInfUnavailable`` where the JAX package returns None (no
    stored candidate embeddings, n <= d + 1, no reference Cholesky factor)
    and where the sizes leave fewer than two distinct points, which the
    JAX package fits anyway (``np.polyfit`` on one point).  Warns when n <
    4 (d + 2): the smallest subsets then sit at the d + 2 floor, barely
    above the rank of their covariance (ROADMAP Queue 3)."""
    emb = cand.embeddings
    if emb is None:
        raise FadInfUnavailable("the candidate has no stored embeddings")
    n, d = int(emb.shape[0]), int(emb.shape[1])
    if n <= d + 1:
        raise FadInfUnavailable(f"{n} candidate embeddings for d = {d}: every subset "
                                "covariance would be rank-deficient (needs n > d + 1)")
    l = ref.chol_cov()
    if l is None or l.shape[0] != d:
        raise FadInfUnavailable("the reference covariance has no Cholesky factor")
    sizes = np.unique(np.round(np.linspace(max(d + 2, min_frac * n), n, n_points))
                      .astype(np.int64))
    if len(sizes) < 2:
        raise FadInfUnavailable(f"the subset sizes {sizes.tolist()} give fewer than two "
                                "distinct points to fit")
    if n < 4 * (d + 2):
        warnings.warn(f"fad_inf: {n} candidate embeddings < 4 (d + 2) = {4 * (d + 2)}; the "
                      f"smallest subsets sit at the d + 2 = {d + 2} floor, where their "
                      "covariances are barely full rank")
    rng = np.random.default_rng(seed)
    mask = np.zeros((len(sizes), n), np.float32)
    for i, s in enumerate(sizes):
        idx = np.arange(n) if s == n else rng.permutation(n)[:s]
        mask[i, idx] = 1.0

    dev = emb.device
    emb = emb.double()
    l_dev = torch.from_numpy(np.asarray(l, np.float64)).to(dev)
    mask_dev = torch.from_numpy(mask).to(dev, torch.float64)
    counts = torch.from_numpy(sizes.astype(np.float64)).to(dev)
    n_iter = _ns_iters()
    mu = (mask_dev @ emb) / counts[:, None]
    tr, trsqrt = [], []
    for i in range(len(sizes)):
        xc = (emb - mu[i][None, :]) * mask_dev[i][:, None]
        cov = (xc.T @ xc) / (counts[i] - 1.0)
        tr.append(torch.trace(cov))
        m = l_dev.T @ (cov @ l_dev)
        trsqrt.append(_ns_trace_sqrt_sym(0.5 * (m + m.T), n_iter))
    arrays = (mu, torch.stack(tr), torch.stack(trsqrt))
    mu_ref, cov_ref, _ = ref.stats()
    mu_ref = np.asarray(mu_ref, np.float64)
    tr_ref = float(np.trace(np.asarray(cov_ref, np.float64)))

    def reduce_fn(host_arrays):
        mu_s, tr_s, trsqrt_s = (np.asarray(a, np.float64) for a in host_arrays)
        fads = np.sum((mu_s - mu_ref[None, :]) ** 2, axis=1) + tr_s + tr_ref - 2.0 * trsqrt_s
        slope, intercept = np.polyfit(1.0 / sizes.astype(np.float64), fads, 1)
        return {"fad_inf": float(intercept), "fad_inf_slope": float(slope)}

    return arrays, reduce_fn
