"""Precision / Recall / Density / Coverage.

Counterpart of ``audio_metrics_tpu/metrics/prdc.py::prdc`` (:350-447): the
k-NN radii of both sets (cached per k on each ``AudioMetricsData``) and the
four pairwise reductions run on the device (ops/distance.py); the means are
taken on the host in float64, exactly as ``host_reduce`` (:427-434) takes
them.

The work is spread over a mesh of shards (:101-126, :171-238, :255-269,
:309-315, :362-376; one shard by default): each shard takes a block of
rows (``row_blocks``) and works on its device's copy of the sets: the
radii of its block of each set against the whole set (#4's query-row
range), then the four reductions of its block of reference rows against
the whole candidate set (#5 unchanged).
The partials combine on the mesh's first device: the candidates' counts
are summed (int32, exact: the JAX package's ``psum``, :204) and their
flags OR-ed; the reference rows' flags, minimum distances and the radii
are concatenated.  Every value is then the one-device value, bitwise; a
mesh of one shard computes the whole set's radii and reductions in one
call each.

On raw features (the JAX package's functional API, :240-347):
``nearest_neighbour_distances`` (#4) and ``pairwise_distance_stats`` (#5)
take tensors, kept on their device, or numpy arrays and array-likes,
moved to ``device`` (default ``"cuda"``), and return device tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import AudioMetricsData, as_rows, pull
from ..ops.distance import KNN_TILE, knn_radii, pairwise_stats
from ..parallel.mesh import make_mesh

__all__ = ["nearest_neighbour_distances", "pairwise_distance_stats", "prdc", "row_blocks",
           "sharded_knn_radii", "sharded_pairwise_stats"]


def row_blocks(n: int, shards: int) -> list[tuple[int, int]]:
    """Contiguous blocks of whole 128-row tiles (the kernels' row tile; a
    block's radii then start 16-byte aligned), one a shard; a shard past
    the rows gets an empty block."""
    per = -(-n // (KNN_TILE * shards)) * KNN_TILE
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(shards)]


def sharded_knn_radii(x: torch.Tensor, nearest_k: int, mesh) -> torch.Tensor:
    """k-NN radii of the rows of ``x``, a block of rows a shard, gathered
    on the mesh's first device."""
    copies = mesh.copies(x)
    blocks = row_blocks(x.shape[0], mesh.size)
    out = mesh.map(lambda shard, b: knn_radii(copies[shard.device][0], nearest_k, b[0],
                                              b[1] - b[0]),
                   [b if b[1] > b[0] else None for b in blocks])
    return torch.cat([r.to(mesh.home) for r in out if r is not None])


def sharded_pairwise_stats(ref, cand, ref_radii, cand_radii, mesh):
    """``pairwise_stats`` a block of reference rows a shard against the
    whole candidate set, combined on the mesh's first device."""
    copies = mesh.copies(ref, cand, ref_radii, cand_radii)
    blocks = row_blocks(ref.shape[0], mesh.size)

    def run(shard, b):
        r, c, rr, cr = copies[shard.device]
        return pairwise_stats(r[b[0] : b[1]], c, rr[b[0] : b[1]], cr)

    out = [tuple(t.to(mesh.home) for t in p) for p in
           mesh.map(run, [b if b[1] > b[0] else None for b in blocks]) if p is not None]
    cand_any = torch.stack([p[0] for p in out]).any(dim=0)
    cand_count = torch.stack([p[1] for p in out]).sum(dim=0, dtype=torch.int32)
    return (cand_any, cand_count, torch.cat([p[2] for p in out]),
            torch.cat([p[3] for p in out]))


def nearest_neighbour_distances(input_features, nearest_k: int, mesh=None,
                                device="cuda") -> torch.Tensor:
    """Distance of each row to its ``nearest_k``-th nearest neighbour,
    itself included as the JAX package counts (its prdc.py:240-280): (n,)
    f32 on the features' device, through #4 (``ops.distance.knn_radii``;
    over ``mesh``, a block of rows a shard, ``sharded_knn_radii``)."""
    x = as_rows(input_features, device).contiguous()
    if mesh is None:
        return knn_radii(x, nearest_k)
    return sharded_knn_radii(x, nearest_k, mesh)


def pairwise_distance_stats(reference, candidate, ref_radii, cand_radii, nearest_k: int,
                            mesh=None, device="cuda"):
    """The four reductions of the reference x candidate distances, without
    the matrix (the JAX package's prdc.py:283-347), through #5
    (``ops.distance.pairwise_stats``; over ``mesh``, a block of reference
    rows a shard): ``(cand_in_ref_any, cand_in_ref_count, ref_in_cand_any,
    ref_min_dist)``, bool (M), int32 (M), bool (N), f32 (N) on the
    reference's device.  ``nearest_k`` is not read (the radii carry it), as
    in the JAX package."""
    ref = as_rows(reference, device).contiguous()
    dev = ref.device
    cand, rr, cr = (as_rows(t, dev).to(dev).contiguous()
                    for t in (candidate, ref_radii, cand_radii))
    if mesh is None:
        return pairwise_stats(ref, cand, rr, cr)
    return sharded_pairwise_stats(ref, cand, rr, cr, mesh)


def prdc(reference: AudioMetricsData, candidate: AudioMetricsData, nearest_k: int,
         mesh=None, lazy=False):
    """``precision``, ``recall``, ``density``, ``coverage`` of the candidate
    manifold against the reference one (reference prdc.py:18-50).  Both
    objects must hold their embeddings; their radii for ``nearest_k`` are
    computed when missing and cached on them.  ``mesh``: the shards that
    share the work (see the module's docstring; None: the embeddings'
    device alone).  ``lazy`` (audio_metrics_tpu/metrics/prdc.py:350-447):
    ``True`` returns a callable that waits for the card and returns the
    dict, ``"parts"`` returns ``(device tensors, host_reduce)``,
    ``host_reduce`` taking the tensors pulled to the host (``data.pull``:
    one wait for the five)."""
    if not (reference.has_embeddings and candidate.has_embeddings):
        raise ValueError("PRDC needs the stored embeddings of both sets")
    key = f"radii_{nearest_k}"
    ref_e, cand_e = reference.embeddings.float(), candidate.embeddings.float()
    if mesh is None:
        mesh = make_mesh(devices=[ref_e.device])
    rr, cr = (amd.radii.get(key) if amd.radii.get(key) is not None else
              sharded_knn_radii(e, nearest_k, mesh)
              for amd, e in ((reference, ref_e), (candidate, cand_e)))
    ca, cc, ra, rm = sharded_pairwise_stats(ref_e, cand_e, rr, cr, mesh)
    reference.radii[key], candidate.radii[key] = rr, cr
    arrays = (ca, cc, ra, rm, rr)

    def host_reduce(host_arrays) -> dict:
        ca, cc, ra, rm, rr = host_arrays
        return dict(
            precision=float(np.mean(ca.astype(np.float64))),
            recall=float(np.mean(ra.astype(np.float64))),
            density=float(np.mean(cc.astype(np.float64))) / float(nearest_k),
            coverage=float(np.mean((rm < rr).astype(np.float64))),
        )

    if lazy == "parts":
        return arrays, host_reduce

    def finalize() -> dict:
        return host_reduce(pull(arrays))

    return finalize if lazy else finalize()
