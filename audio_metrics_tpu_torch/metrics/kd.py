"""Kernel Distance (KID / MMD^2).

Counterpart of ``audio_metrics_tpu/metrics/kd.py``: subset indices are
drawn on the host with the reference's exact ``default_rng(1234)`` call
order (:459-475); the per-subset Gram sums run on the device (:116-250,
:313-430) as batched products over chunks of subsets, row sums in f32 and
the finals in f64.  The reference-only term sum(K_YY) - tr(K_YY) is cached
per reference embeddings, subset indices, kernel parameters and mesh
(``kernel_distance``, on ``AudioMetricsData``; ``kid_features_to_metric``,
on raw features, takes the same path without the cache).
Over a mesh (:257-324, :394-410; one shard by default) the chunks are dealt out in contiguous
runs, one a shard, each shard working on its own device's copy of both
feature sets, and the per-subset sums come back in subset order.
"""

from __future__ import annotations

import logging
import threading
from functools import lru_cache

import numpy as np
import torch

from ..data import AudioMetricsData, as_rows, pull
from ..parallel.mesh import make_mesh
from ..utils.precision import full_f32

__all__ = [
    "kernel_distance",
    "kid_features_to_metric",
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


CHUNK_BYTES = 128 << 20  # the two (S, m, m) f32 Gram batches of one chunk of subsets


def _chunks(s: int, m: int):
    chunk = max(1, min(s, CHUNK_BYTES // (2 * m * m * 4)))
    return [slice(i, min(i + chunk, s)) for i in range(0, s, chunk)]


def shard_chunks(s: int, m: int, shards: int) -> list:
    """The chunks of ``_chunks(s, m)`` in contiguous runs, one a shard
    (fewer runs than shards when there are fewer chunks; a shard without one
    gets None): every product then has the shape and the operands it has on
    one device, so each subset's sums come out bitwise as there.  The JAX
    package pads its subsets to a multiple of its mesh with duplicates
    instead (kd.py:394-402)."""
    chunks = _chunks(s, m)
    runs = np.array_split(np.arange(len(chunks)), min(shards, len(chunks)))
    out = [chunks[r[0] : r[-1] + 1] for r in runs]
    return out + [None] * (shards - len(out))


def _cand_sums(f1, f2, i1, i2, kparams, chunks):
    kt_xx, k_xy = [], []
    with full_f32():
        for sl in chunks:
            a, b = f1[i1[sl]], f2[i2[sl]]
            kt_xx.append(_off_diag_sum(_gram(a, a, kparams)))
            k_xy.append(_gram(a, b, kparams).sum(dim=2).double().sum(dim=1))
    return torch.cat(kt_xx), torch.cat(k_xy)


def _ref_rows(f2, i2, kparams, chunks):
    out = []
    with full_f32():
        for sl in chunks:
            b = f2[i2[sl]]
            out.append(_off_diag_sum(_gram(b, b, kparams)))
    return torch.cat(out)


def _ref_sums(cache: dict | None, f2, subset_key, kparams, mesh, shard_run):
    """(subsets,) f64 tensor of sum(K_YY) - tr(K_YY), on the mesh's first
    device, cached in ``cache`` (the reference's ``AudioMetricsData.cache``;
    None: computed, not cached); keyed on the reference embeddings' identity, the
    arguments that determine the subset indices ``(n1, n2, subsets, size,
    seed)``, the kernel parameters and the mesh's devices (kd.py:319).
    (Keying on the index array's ``id()`` is unsound: once the lru cache
    evicts and frees an array, another candidate size's indices can be
    allocated at the same address.)  ``shard_run(fn)`` computes it, a run
    of chunks a shard."""
    key = ("kd_ref", subset_key, kparams, tuple(mesh.devices))
    hit = None if cache is None else cache.get(key)
    if hit is not None and hit[0] is f2:
        return hit[1]
    kt_yy = torch.cat(shard_run(lambda f1, f2, i1, i2, chunks: _ref_rows(f2, i2, kparams,
                                                                         chunks)))
    if cache is not None:
        cache[key] = (f2, kt_yy)
    return kt_yy


def _on_shards(mesh, tensors, s: int, m: int):
    """``run(fn)``: ``fn(*tensors, chunks)`` on every shard with a run of
    ``shard_chunks(s, m, mesh.size)``, over the shard device's copies of
    ``tensors`` (``Mesh.copies``: one a device, made here, once), the
    results moved to the mesh's first device in shard order."""
    copies = mesh.copies(*tensors)
    runs = shard_chunks(s, m, mesh.size)

    def run(fn):
        out = mesh.map(lambda shard, chunks: fn(*copies[shard.device], chunks), runs)
        return [r.to(mesh.home) if isinstance(r, torch.Tensor) else
                tuple(t.to(mesh.home) for t in r) for r in out if r is not None]

    return run


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


_DEVICE_INDICES: dict = {}
_DEVICE_INDICES_LOCK = threading.Lock()


def _device_indices(subset_key: tuple, device: torch.device):
    """The subset index arrays ``_subset_indices(*subset_key)`` on
    ``device``, uploaded once and kept across evaluates (kd.py:430-456;
    keyed on the arguments that determine the arrays, not on their
    ``id()``), so that a warm evaluate uploads no index.  The JAX
    package's uint16 transfer saves bytes on its relay and is not kept."""
    key = (subset_key, device)
    with _DEVICE_INDICES_LOCK:
        hit = _DEVICE_INDICES.get(key)
        if hit is None:
            if len(_DEVICE_INDICES) >= 8:
                _DEVICE_INDICES.clear()
            # copies: the cached host arrays are read-only
            hit = _DEVICE_INDICES[key] = tuple(torch.tensor(idx, device=device)
                                               for idx in _subset_indices(*subset_key))
        return hit


def _kid_parts(f1: torch.Tensor, f2: torch.Tensor, mesh, cache, kwargs):
    """The KID sweep of candidate rows ``f1`` against reference rows ``f2``
    (reference kd.py:127-194): ``((kt_xx, kt_yy, k_xy) f64 device tensors
    of one value a subset, host_reduce)``, ``host_reduce`` taking them
    pulled to the host.  ``cache``: the reference's cache of its Gram sums
    (None: none)."""
    kernel_type = kwargs.get("kernel_type", "polynomial")
    if kernel_type not in ("polynomial", "rbf"):
        raise NotImplementedError(f'Unknown kernel_type "{kernel_type}"')
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
    subset_key = (n1, n2, kwargs.get("kid_subsets", KID_SUBSETS), size,
                  kwargs.get("rng_seed", 1234))
    gamma = kwargs.get("kid_gamma", KID_GAMMA)
    kparams = (
        kernel_type,
        float(kwargs.get("kid_degree", KID_DEGREE)),
        float(1.0 / f1.shape[1] if gamma is None else gamma),
        float(kwargs.get("kid_coef0", KID_COEF0)),
        float(kwargs.get("kid_sigma", KID_SIGMA)),
    )
    i1 = _device_indices(subset_key, f1.device)[0]
    i2 = _device_indices(subset_key, f2.device)[1]
    if mesh is None:
        mesh = make_mesh(devices=[f1.device])
    run = _on_shards(mesh, (f1, f2, i1, i2), *i1.shape)
    kt_yy = _ref_sums(cache, f2, subset_key, kparams, mesh, run)
    parts = run(lambda f1, f2, i1, i2, chunks: _cand_sums(f1, f2, i1, i2, kparams, chunks))
    kt_xx, k_xy = (torch.cat(t) for t in zip(*parts))
    m = size

    def host_reduce(host_arrays) -> dict:
        kt_xx, kt_yy, k_xy = host_arrays
        mmds = (kt_xx + kt_yy) / (m * (m - 1)) - 2.0 * k_xy / (m * m)
        return {KEY_METRIC_KID_MEAN: float(np.mean(mmds)), KEY_METRIC_KID_STD: float(np.std(mmds))}

    return (kt_xx, kt_yy, k_xy), host_reduce


def _finish(arrays, host_reduce, lazy):
    """The ``lazy`` protocol of the JAX package's KD (kd.py:547-556):
    ``"parts"`` gives ``(device tensors, host_reduce)``, ``True`` a
    zero-argument finalize that waits for the card and returns the dict,
    anything else the dict."""
    if lazy == "parts":
        return arrays, host_reduce

    def finalize() -> dict:
        return host_reduce(pull(arrays))

    return finalize if lazy else finalize()


def kernel_distance(x: AudioMetricsData, y: AudioMetricsData, mesh=None, lazy=False, **kwargs):
    """KID estimate of candidate ``x`` against reference ``y`` over random
    subsets (reference kd.py:127-194), the subsets' chunks spread over the
    shards of ``mesh`` (``shard_chunks``; None: the embeddings' device
    alone); the reference's Gram sums cached on ``y``.  ``lazy`` as the
    JAX package's (kd.py:50-57): ``True`` returns a callable that waits
    for the card and returns the dict, ``"parts"`` returns ``(device
    tensors, host_reduce)``, ``host_reduce`` taking the tensors pulled to
    the host (``data.pull``); the other keyword arguments are
    :func:`kid_features_to_metric`'s."""
    arrays, host_reduce = _kid_parts(x.embeddings.float(), y.embeddings.float(), mesh, y.cache,
                                     kwargs)
    return _finish(arrays, host_reduce, lazy)


def kid_features_to_metric(features_1, features_2, **kwargs):
    """KID of ``features_1`` (candidate) against ``features_2``
    (reference) on raw features (audio_metrics_tpu/metrics/kd.py:477-556),
    through ``kernel_distance``'s path without its cache.  Features are
    (n, d) tensors (kept on their device) or numpy arrays / array-likes
    (moved to ``device``, default ``"cuda"``).  The JAX keyword arguments:
    ``kernel_type`` ("polynomial" or "rbf"), ``kid_subsets``,
    ``kid_subset_size`` (shrunk to min(n1, n2) // 2 where it does not fit,
    with a warning under ``verbose``), ``rng_seed``, ``kid_degree``,
    ``kid_gamma``, ``kid_coef0``, ``kid_sigma``, ``mesh`` (the shards that
    share the subsets), and ``lazy``, as :func:`kernel_distance` takes it."""
    device = kwargs.get("device", "cuda")
    f1 = as_rows(features_1, device)
    f2 = as_rows(features_2, device)
    arrays, host_reduce = _kid_parts(f1, f2, kwargs.get("mesh"), None, kwargs)
    return _finish(arrays, host_reduce, kwargs.get("lazy"))
