"""The plain reference of the metrics: moments, FAD, KD and PRDC.

Written from the published definitions (the ``audio_metrics`` library's
FAD, its KID over 100 subsets of 1000 rows drawn by ``default_rng(1234)``,
and Naeem et al.'s PRDC), in PyTorch on any device, in the dtype of the
embeddings given: the benchmark runs them in float64 (the reference) and
in f32 with TF32 on (the control).  Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

KID_SUBSETS = 100
KID_SUBSET_SIZE = 1000
KID_SEED = 1234
PRDC_K = 10


def moments(e: torch.Tensor):
    """Mean and covariance (n - 1 in the denominator) of the rows."""
    mu = e.mean(dim=0)
    c = e - mu
    return mu, c.T @ c / (e.shape[0] - 1)


def _sym_sqrt(a: torch.Tensor) -> torch.Tensor:
    vals, vecs = torch.linalg.eigh(a)
    return (vecs * vals.clamp(min=0).sqrt()) @ vecs.T


def frechet_distance(mu_x, cov_x, mu_y, cov_y) -> float:
    """|mu_x - mu_y|^2 + tr(cov_x) + tr(cov_y) - 2 tr((cov_x^1/2 cov_y
    cov_x^1/2)^1/2)."""
    root = _sym_sqrt(cov_x)
    inner = torch.linalg.eigvalsh(root @ cov_y @ root).clamp(min=0).sqrt().sum()
    diff = mu_x - mu_y
    return float(diff @ diff + torch.trace(cov_x) + torch.trace(cov_y) - 2 * inner)


def kid_subsets(n_x: int, n_y: int, subsets: int = KID_SUBSETS, size: int = KID_SUBSET_SIZE):
    """The subsets' row indices, (subsets, m) each, in the library's draw
    order (one ``choice`` without replacement of each set per subset); m
    is ``size``, or half the smaller set where ``size`` does not fit."""
    if size >= min(n_x, n_y):
        size = max(1, min(n_x, n_y) // 2)
    rng = np.random.default_rng(KID_SEED)
    ix, iy = np.empty((subsets, size), np.int64), np.empty((subsets, size), np.int64)
    for s in range(subsets):
        ix[s] = rng.choice(n_x, size, replace=False)
        iy[s] = rng.choice(n_y, size, replace=False)
    return ix, iy


def kernel_distance(x: torch.Tensor, y: torch.Tensor, chunk: int = 10) -> tuple[float, float]:
    """KID of candidate rows ``x`` against reference rows ``y``: the
    unbiased MMD^2 under the cubic polynomial kernel (<a, b>/d + 1)^3 over
    each subset pair; the mean and the standard deviation (ddof 0) over
    the subsets."""
    ix, iy = kid_subsets(len(x), len(y))
    ix, iy = torch.from_numpy(ix).to(x.device), torch.from_numpy(iy).to(x.device)
    m, d = ix.shape[1], x.shape[1]
    mmds = []
    for s in range(0, len(ix), chunk):
        a, b = x[ix[s : s + chunk]], y[iy[s : s + chunk]]

        def gram(p, q):
            return (torch.bmm(p, q.transpose(1, 2)) / d + 1) ** 3

        kxx, kyy, kxy = gram(a, a), gram(b, b), gram(a, b)
        off = lambda k: k.sum(dim=(1, 2)) - torch.diagonal(k, dim1=1, dim2=2).sum(dim=1)
        mmds.append((off(kxx) + off(kyy)) / (m * (m - 1)) - 2 * kxy.sum(dim=(1, 2)) / (m * m))
    mmds = torch.cat(mmds).double().cpu().numpy()
    return float(mmds.mean()), float(mmds.std())


def _distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T
    return sq.clamp(min=0).sqrt()


def knn_radii(e: torch.Tensor, k: int, block: int = 2048) -> torch.Tensor:
    """Each row's distance to its k-th nearest other row (the row itself
    is the 0th)."""
    return torch.cat([torch.kthvalue(_distances(e[i : i + block], e), k + 1, dim=1).values
                      for i in range(0, len(e), block)])


def prdc(ref: torch.Tensor, cand: torch.Tensor, k: int = PRDC_K, block: int = 2048) -> dict:
    """Precision, recall, density and coverage of the candidate rows
    against the reference rows (Naeem et al. 2020), k = min(k, sizes)."""
    k = max(1, min(k, len(ref), len(cand)))
    r_ref, r_cand = knn_radii(ref, k, block), knn_radii(cand, k, block)
    cand_any = torch.zeros(len(cand), dtype=torch.bool, device=ref.device)
    cand_count = torch.zeros(len(cand), dtype=torch.float64, device=ref.device)
    ref_any, ref_cover = [], []
    for i in range(0, len(ref), block):
        d = _distances(ref[i : i + block], cand)  # (rows of ref, cand)
        inside = d < r_ref[i : i + block, None]
        cand_any |= inside.any(dim=0)
        cand_count += inside.sum(dim=0, dtype=torch.float64)
        ref_any.append((d < r_cand[None, :]).any(dim=1))
        ref_cover.append(d.min(dim=1).values < r_ref[i : i + block])
    return dict(
        precision=float(cand_any.double().mean()),
        recall=float(torch.cat(ref_any).double().mean()),
        density=float(cand_count.mean()) / k,
        coverage=float(torch.cat(ref_cover).double().mean()),
    )
