"""Kernel Distance (KID / MMD^2).

Counterpart of ``audio_metrics_tpu/metrics/kd.py``: subset indices are
drawn on the host with the reference's exact ``default_rng(1234)`` call
order (:459-475); the per-subset Gram sums run on the device (:116-250,
:313-430) as batched products over chunks of subsets, row sums in f32 and
the finals in f64.  The reference-only term sum(K_YY) - tr(K_YY) is cached
per reference embeddings, subset indices and kernel parameters.
"""

from __future__ import annotations

import logging
from functools import lru_cache

import numpy as np
import torch

from ..data import AudioMetricsData
from .fad import _full_f32

__all__ = [
    "kernel_distance",
    "mmd2",
    "polynomial_kernel",
    "rbf_kernel",
    "KEY_METRIC_KID_MEAN",
    "KEY_METRIC_KID_STD",
]

KEY_METRIC_KID_MEAN = "kernel_distance_mean"
KEY_METRIC_KID_STD = "kernel_distance_std"
KID_SUBSETS = 100
KID_SUBSET_SIZE = 1000
KID_DEGREE = 3
KID_GAMMA = None
KID_COEF0 = 1
KID_SIGMA = 10.0

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# numpy reference formulas (kd.py:63-110)
# ----------------------------------------------------------------------
def polynomial_kernel(X, Y, degree=3, gamma=None, coef0=1):
    """(gamma <X,Y> + coef0)^degree."""
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    return (np.matmul(X, Y.T) * gamma + coef0) ** degree


def rbf_kernel(X, Y, sigma=1.0):
    """exp(-|x-y|^2 / 2 sigma^2)."""
    sq_x = np.sum(np.square(X), axis=1)[:, None]
    sq_y = np.sum(np.square(Y), axis=1)[None, :]
    squared_dist = np.maximum(sq_x + sq_y - 2.0 * np.matmul(X, Y.T), 0.0)
    return np.exp(-squared_dist / (2 * sigma**2))


def mmd2(K_XX, K_XY, K_YY, unit_diagonal=False, mmd_est="unbiased"):
    """MMD^2 estimators from Gram matrices."""
    assert mmd_est in ("biased", "unbiased", "u-statistic")
    m = K_XX.shape[0]
    assert K_XX.shape == (m, m)
    assert K_XY.shape == (m, m)
    assert K_YY.shape == (m, m)
    if unit_diagonal:
        diag_x = diag_y = 1.0
        sum_diag_x = sum_diag_y = m
    else:
        diag_x = np.diagonal(K_XX)
        diag_y = np.diagonal(K_YY)
        sum_diag_x = diag_x.sum()
        sum_diag_y = diag_y.sum()
    kt_xx_sum = (K_XX.sum(axis=1) - diag_x).sum()
    kt_yy_sum = (K_YY.sum(axis=1) - diag_y).sum()
    k_xy_sum = K_XY.sum()
    if mmd_est == "biased":
        return (
            (kt_xx_sum + sum_diag_x) / (m * m)
            + (kt_yy_sum + sum_diag_y) / (m * m)
            - 2 * k_xy_sum / (m * m)
        )
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    if mmd_est == "unbiased":
        value -= 2 * k_xy_sum / (m * m)
    else:
        value -= 2 * (k_xy_sum - np.trace(K_XY)) / (m * (m - 1))
    return value


# ----------------------------------------------------------------------
# device path
# ----------------------------------------------------------------------
def _gram(a, b, kparams):
    """Batched Gram (S, m, m) f32 of row sets a, b (S, m, d)."""
    kernel_type, degree, gamma, coef0, sigma = kparams
    dots = torch.bmm(a, b.transpose(1, 2))
    if kernel_type == "polynomial":
        return (dots * gamma + coef0) ** degree
    sq_a = (a * a).sum(dim=2)
    sq_b = (b * b).sum(dim=2)
    sq = torch.clamp(sq_a[:, :, None] + sq_b[:, None, :] - 2.0 * dots, min=0.0)
    return torch.exp(-sq / (2.0 * sigma**2))


def _off_diag_sum(k):
    """sum(K) - tr(K) per subset, f32 row sums, f64 finals."""
    return k.sum(dim=2).double().sum(dim=1) - torch.diagonal(k, dim1=1, dim2=2).double().sum(dim=1)


def _chunks(s: int, m: int):
    chunk = max(1, min(s, (128 << 20) // (2 * m * m * 4)))
    return [slice(i, min(i + chunk, s)) for i in range(0, s, chunk)]


def _cand_sums(f1, f2, i1, i2, kparams):
    kt_xx, k_xy = [], []
    with _full_f32():
        for sl in _chunks(i1.shape[0], i1.shape[1]):
            a, b = f1[i1[sl]], f2[i2[sl]]
            kt_xx.append(_off_diag_sum(_gram(a, a, kparams)))
            k_xy.append(_gram(a, b, kparams).sum(dim=2).double().sum(dim=1))
    return torch.cat(kt_xx), torch.cat(k_xy)


def _ref_sums(ref: AudioMetricsData, f2, i2, idx_2, kparams):
    """Cached (subsets,) f64 device tensor of sum(K_YY) - tr(K_YY); keyed on
    the reference embeddings' identity, the subset indices' identity (they
    are lru-cached and read-only) and the kernel parameters."""
    key = ("kd_ref", id(idx_2), kparams)
    hit = ref.cache.get(key)
    if hit is not None and hit[0] is f2:
        return hit[1]
    out = []
    with _full_f32():
        for sl in _chunks(i2.shape[0], i2.shape[1]):
            b = f2[i2[sl]]
            out.append(_off_diag_sum(_gram(b, b, kparams)))
    kt_yy = torch.cat(out)
    ref.cache[key] = (f2, kt_yy)
    return kt_yy


@lru_cache(maxsize=8)
def _subset_indices(n1: int, n2: int, subsets: int, size: int, seed: int):
    """Deterministic subset indices, cached across evaluate() calls.

    Same rng call order as the reference loop (kd.py:178-186) —
    bit-identical indices."""
    rng = np.random.default_rng(seed)
    idx_1 = np.empty((subsets, size), dtype=np.int64)
    idx_2 = np.empty((subsets, size), dtype=np.int64)
    for i in range(subsets):
        idx_1[i] = rng.choice(n1, size, replace=False)
        idx_2[i] = rng.choice(n2, size, replace=False)
    idx_1.setflags(write=False)
    idx_2.setflags(write=False)
    return idx_1, idx_2


def kernel_distance(x: AudioMetricsData, y: AudioMetricsData, **kwargs) -> dict:
    """KID estimate of candidate ``x`` against reference ``y`` over random
    subsets (reference kd.py:127-194)."""
    kernel_type = kwargs.get("kernel_type", "polynomial")
    if kernel_type not in ("polynomial", "rbf"):
        raise NotImplementedError(f'Unknown kernel_type "{kernel_type}"')
    f1, f2 = x.embeddings.float(), y.embeddings.float()
    if f1.ndim != 2 or f2.ndim != 2 or f1.shape[1] != f2.shape[1]:
        raise ValueError(f"embedding shapes {tuple(f1.shape)} / {tuple(f2.shape)}")
    n1, n2 = len(f1), len(f2)
    if not (n1 and n2):
        raise ValueError("Cannot compute KID on empty features tensor")
    size = kwargs.get("kid_subset_size", KID_SUBSET_SIZE)
    if size >= min(n1, n2):
        new = max(1, min(n1, n2) // 2)
        if kwargs.get("verbose", False):
            logger.warning("Reducing KID subset size from %d to %d", size, new)
        size = new
    idx_1, idx_2 = _subset_indices(
        n1, n2, kwargs.get("kid_subsets", KID_SUBSETS), size, kwargs.get("rng_seed", 1234)
    )
    gamma = kwargs.get("kid_gamma", KID_GAMMA)
    kparams = (
        kernel_type,
        float(kwargs.get("kid_degree", KID_DEGREE)),
        float(1.0 / f1.shape[1] if gamma is None else gamma),
        float(kwargs.get("kid_coef0", KID_COEF0)),
        float(kwargs.get("kid_sigma", KID_SIGMA)),
    )
    i1 = torch.tensor(idx_1, device=f1.device)  # copies: the cached arrays are read-only
    i2 = torch.tensor(idx_2, device=f2.device)
    kt_yy = _ref_sums(y, f2, i2, idx_2, kparams)
    kt_xx, k_xy = _cand_sums(f1, f2, i1, i2, kparams)
    m = size
    mmds = (
        (kt_xx.cpu().numpy() + kt_yy.cpu().numpy()) / (m * (m - 1))
        - 2.0 * k_xy.cpu().numpy() / (m * m)
    )
    return {KEY_METRIC_KID_MEAN: float(np.mean(mmds)), KEY_METRIC_KID_STD: float(np.std(mmds))}
