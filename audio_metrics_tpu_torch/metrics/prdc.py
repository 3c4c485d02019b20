"""Precision / Recall / Density / Coverage.

Counterpart of ``audio_metrics_tpu/metrics/prdc.py::prdc`` (:350-447) on
one device: the k-NN radii of both sets (cached per k on each
``AudioMetricsData``) and the four pairwise reductions run on the device
(ops/distance.py); the means are taken on the host in float64, exactly as
``host_reduce`` (:427-434) takes them.
"""

from __future__ import annotations

import numpy as np

from ..data import AudioMetricsData
from ..ops.distance import prdc_device

__all__ = ["prdc"]


def prdc(reference: AudioMetricsData, candidate: AudioMetricsData, nearest_k: int) -> dict:
    """``precision``, ``recall``, ``density``, ``coverage`` of the candidate
    manifold against the reference one (reference prdc.py:18-50).  Both
    objects must hold their embeddings; their radii for ``nearest_k`` are
    computed when missing and cached on them."""
    if not (reference.has_embeddings and candidate.has_embeddings):
        raise ValueError("PRDC needs the stored embeddings of both sets")
    key = f"radii_{nearest_k}"
    rr, cr, ca, cc, ra, rm = prdc_device(
        reference.embeddings.float(), candidate.embeddings.float(), nearest_k,
        ref_radii=reference.radii.get(key), cand_radii=candidate.radii.get(key),
    )
    reference.radii[key], candidate.radii[key] = rr, cr
    ca, cc, ra, rm, rr = (t.cpu().numpy() for t in (ca, cc, ra, rm, rr))
    return dict(
        precision=float(np.mean(ca.astype(np.float64))),
        recall=float(np.mean(ra.astype(np.float64))),
        density=float(np.mean(cc.astype(np.float64))) / float(nearest_k),
        coverage=float(np.mean((rm < rr).astype(np.float64))),
    )
