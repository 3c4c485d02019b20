"""PRDC distance reductions: k-NN radii and the pairwise statistics.

Counterpart of ``audio_metrics_tpu/ops/distance.py``: the kernels
``_knn_call`` (:116-145) and ``_stats_calls`` (:210-283) are
kernels/csrc/distance.cu; the plain versions follow the blocked XLA path of
``audio_metrics_tpu/metrics/prdc.py`` (:59-167): row blocks of 2048, one
f32 product per block (TF32 off), ``topk`` for the radii.  Nothing N x N
is materialised, so the plain versions run at real eval-set sizes.

Squared distances are ``max((|a|^2 + |b|^2) - 2 a.b, 0)`` with f32 squared
norms, radii the ``sqrt`` of the k-th smallest (self included, k =
nearest_k + 1), and the comparisons ``d < r`` are taken after the ``sqrt``,
strictly, as the TPU kernels take them.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from ..kernels import KERNELS, require_cuda
from ..utils.precision import full_f32

__all__ = [
    "check_depth",
    "column_splits",
    "knn_radii",
    "knn_radii_plain",
    "pairwise_stats",
    "pairwise_stats_plain",
    "prdc_device",
]

KNN = KERNELS["knn_radii"]
STATS = KERNELS["prdc_stats"]
BLOCK = 2048  # plain versions' row block (metrics/prdc.py:25)
K_MAX = 128   # widest k-smallest list of the kernel (the TPU scratch's width)
KNN_TILE = 128  # the kNN and statistics kernels' row and column tile


def _sq_dists(a, sq_a, b, sq_b):
    """(m, d), (m,), (n, d), (n,) -> (m, n) squared distances, f32."""
    return torch.clamp((sq_a[:, None] + sq_b[None, :]) - 2.0 * (a @ b.T), min=0.0)


def knn_radii_plain(x: torch.Tensor, nearest_k: int) -> torch.Tensor:
    """Distance of each row of ``x`` (n, d) f32 to its nearest_k-th
    neighbour, self included: the (nearest_k + 1)-th smallest distance,
    (n,) f32 (metrics/prdc.py:69-87)."""
    x = x.float()
    k = min(nearest_k + 1, x.shape[0])
    sq = (x * x).sum(dim=1)
    out = []
    with full_f32():
        for i in range(0, x.shape[0], BLOCK):
            d2 = _sq_dists(x[i : i + BLOCK], sq[i : i + BLOCK], x, sq)
            kth = torch.topk(d2, k, dim=1, largest=False).values[:, k - 1]
            out.append(torch.sqrt(torch.clamp(kth, min=0.0)))
    return torch.cat(out)


def pairwise_stats_plain(ref, cand, ref_radii, cand_radii):
    """The four PRDC reductions over the ref x cand distances
    (metrics/prdc.py:129-157): per candidate ``any(d < ref_r)`` (bool) and
    its count (int32), per reference ``any(d < cand_r)`` (bool) and ``min d``
    (f32)."""
    ref, cand = ref.float(), cand.float()
    rr, cr = ref_radii.float(), cand_radii.float()
    sq_r, sq_c = (ref * ref).sum(dim=1), (cand * cand).sum(dim=1)
    cand_count = torch.zeros(cand.shape[0], dtype=torch.int32, device=cand.device)
    ref_any, ref_min = [], []
    with full_f32():
        for i in range(0, ref.shape[0], BLOCK):
            d = torch.sqrt(_sq_dists(ref[i : i + BLOCK], sq_r[i : i + BLOCK], cand, sq_c))
            cand_count += (d < rr[i : i + BLOCK, None]).sum(dim=0, dtype=torch.int32)
            ref_any.append((d < cr[None, :]).any(dim=1))
            ref_min.append(d.min(dim=1).values)
    return cand_count > 0, cand_count, torch.cat(ref_any), torch.cat(ref_min)


def column_splits(n_rows: int, n_cols: int, sms: int) -> tuple[int, int]:
    """``(splits, split_cols)``: how the kNN and the statistics kernels
    divide ``n_cols`` columns among blocks over ``n_rows`` rows.  Each split
    is a run of whole 128-column tiles; there are about four blocks
    (128-row tile, split) per SM, at most one split per column tile, and no
    empty split."""
    row_tiles, col_tiles = -(-n_rows // KNN_TILE), -(-n_cols // KNN_TILE)
    splits = max(1, min(col_tiles, -(-4 * sms // row_tiles)))
    split_cols = -(-col_tiles // splits) * KNN_TILE
    return -(-n_cols // split_cols), split_cols


def check_depth(name: str, d: int) -> None:
    """Raise ``NotImplementedError`` unless the distance kernels take rows of
    ``d`` floats: they read them in 16-byte chunks."""
    if d % 4:
        raise NotImplementedError(f"{name} kernel reads rows in 16-byte chunks, got d={d}")


def _knn_radii_cuda(x, nearest_k):
    require_cuda(x, dtype=torch.float32)
    n, d = x.shape
    k = min(nearest_k + 1, n)
    if k > K_MAX:
        raise NotImplementedError(f"knn_radii kernel keeps at most {K_MAX} neighbours, got k={k}")
    check_depth("knn_radii", d)
    splits, split_cols = column_splits(n, n, torch.cuda.get_device_properties(x.device)
                                       .multi_processor_count)
    lists = torch.empty((n, splits, k), dtype=torch.float32, device=x.device)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    # the plain version's squared norms: the kernel rounds the distance
    # formula as it does
    KNN.launch("am_knn_radii", x, (x * x).sum(dim=1), n, d, k, splits, split_cols, lists, out)
    KNN.launches += 1
    return out


def _pairwise_stats_cuda(ref, cand, ref_radii, cand_radii):
    require_cuda(ref, cand, ref_radii, cand_radii, dtype=torch.float32)
    (n_ref, d), n_cand = ref.shape, cand.shape[0]
    if cand.shape[1] != d or ref_radii.shape != (n_ref,) or cand_radii.shape != (n_cand,):
        raise ValueError(f"pairwise_stats shapes {tuple(ref.shape)} {tuple(cand.shape)} "
                         f"{tuple(ref_radii.shape)} {tuple(cand_radii.shape)}")
    check_depth("pairwise_stats", d)
    dev = ref.device
    splits, split_cols = column_splits(n_ref, n_cand,
                                       torch.cuda.get_device_properties(dev).multi_processor_count)
    cand_any = torch.zeros(n_cand, dtype=torch.int32, device=dev)
    cand_count = torch.zeros(n_cand, dtype=torch.int32, device=dev)
    ref_any = torch.zeros(n_ref, dtype=torch.int32, device=dev)
    ref_min = torch.full((n_ref,), float("inf"), dtype=torch.float32, device=dev)
    # the plain version's squared norms: the kernel rounds the distance
    # formula as it does
    STATS.launch("am_prdc_stats", ref, (ref * ref).sum(dim=1), ref_radii, n_ref, cand,
                 (cand * cand).sum(dim=1), cand_radii, n_cand, d, splits, split_cols, cand_any,
                 cand_count, ref_any, ref_min)
    STATS.launches += 1
    return cand_any > 0, cand_count, ref_any > 0, ref_min


def knn_radii(x: torch.Tensor, nearest_k: int) -> torch.Tensor:
    """k-NN radii (n,) f32 of the rows of ``x`` (n, d) f32, self included
    (``knn_radii_pallas``, distance.py:148-156)."""
    fn = knn_radii_plain if x.device.type == "cpu" else _knn_radii_cuda
    return fn(x, nearest_k)


def pairwise_stats(ref, cand, ref_radii, cand_radii):
    """``(cand_any, cand_count, ref_any, ref_min)``: bool (M), int32 (M),
    bool (N), f32 (N) (``pairwise_stats_pallas``, distance.py:341-364)."""
    fn = pairwise_stats_plain if ref.device.type == "cpu" else _pairwise_stats_cuda
    return fn(ref, cand, ref_radii, cand_radii)


def prdc_device(ref, cand, nearest_k: int, ref_radii=None, cand_radii=None):
    """``(ref_radii, cand_radii, cand_any, cand_count, ref_any, ref_min)``
    as device tensors, with no host sync (``prdc_all_pallas_device``,
    distance.py:295-327).  Radii that are given (cached across evaluate()
    calls) are not recomputed."""
    rr = knn_radii(ref, nearest_k) if ref_radii is None else ref_radii
    cr = knn_radii(cand, nearest_k) if cand_radii is None else cand_radii
    return (rr, cr) + pairwise_stats(ref, cand, rr, cr)

