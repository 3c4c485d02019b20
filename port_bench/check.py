"""The comparison that decides ``correct``.

The program's side is what the timed path produced: the embeddings that
the embedder returned for the reference set (``add_reference``) and for a
sample of the window's candidate sets (drawn from the seed), and the
metrics that each sampled ``evaluate`` returned.  The reference side is
the plain reference (``port_bench/reference``) on the same weights and the
same audio: the forward in f32 with TF32 off, the moments and metrics in
float64 on its own embeddings.  The control is the reference in the
nearest precision below the configuration's f32: the forward and the
metrics in f32 with TF32 on.

Numbers compared, each against its limit in ``port_bench/workloads/
<cell>.json`` (PERF.md gives the readings that each limit was set from):

- ``emb_err``: the largest distance from a row of one side's embeddings
  of a set to the nearest row of the other side's (the rows are of unit
  length), over the reference set and the sampled candidate sets: it
  needs no row order, so it holds however the program orders or shards
  its batches;
- ``fad_err``: FAD, the largest relative gap over the sampled evaluates;
- ``kd_err``: KD's mean, the largest relative gap;
- ``prdc_err``: precision, recall, density and coverage, the largest
  absolute gap.
"""

from __future__ import annotations

import contextlib
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .reference import metrics as ref_metrics

NUMBERS = ("emb_err", "fad_err", "kd_err", "prdc_err")
PRDC_KEYS = ("precision", "recall", "density", "coverage")


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def embed_rows(models, audio: torch.Tensor) -> torch.Tensor:
    """``audio``'s embeddings on the first model's device, the rows split
    in contiguous blocks over the models (one a device, a thread each)."""
    home = models[0].device
    if len(models) == 1:
        return models[0].embed(audio)
    cuts = np.linspace(0, len(audio), len(models) + 1).astype(int)

    def one(i):
        dev = models[i].device
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            return models[i].embed(audio[cuts[i] : cuts[i + 1]].to(dev)).to(home)

    with ThreadPoolExecutor(len(models)) as pool:
        return torch.cat(list(pool.map(one, range(len(models)))))


def set_metrics(ref_emb, cand_emb: dict, dtype, nearest: int, device) -> dict:
    """Each candidate set's FAD, KD and PRDC against the reference rows, in
    ``dtype`` on ``device``."""
    r = ref_emb.to(device, dtype)
    mean, cov = ref_metrics.moments(r)
    results = {}
    for k, e in cand_emb.items():
        c = e.to(device, dtype)
        kd_mean, kd_std = ref_metrics.kernel_distance(c, r)
        results[k] = dict(fad=ref_metrics.frechet_distance(*ref_metrics.moments(c), mean, cov),
                          kernel_distance_mean=kd_mean, kernel_distance_std=kd_std,
                          **ref_metrics.prdc(r, c, nearest))
    return results


def reference_side(cell, params, traffic, picks, devices, control: bool = False) -> dict:
    """The plain reference's side (``control``: the control's) of the
    sampled evaluates ``picks``, on ``devices``."""
    from .harness import family

    set_tf32(control)
    try:
        models = [family(cell.config).build_reference(cell.config, params, d) for d in devices]
        ref_emb = embed_rows(models, traffic.reference)
        cand_emb = {k: embed_rows(models, traffic.candidate(k)) for k in picks}
        del models
        results = set_metrics(ref_emb, cand_emb, torch.float32 if control else torch.float64,
                              nearest(cell), devices[0])
        return dict(ref_emb=ref_emb.cpu(), cand_emb={k: v.cpu() for k, v in cand_emb.items()},
                    results=results)
    finally:
        set_tf32(False)


def nearest(cell) -> int:
    """PRDC's k in ``cell``."""
    mix = cell.traffic
    return max(1, min(ref_metrics.PRDC_K, mix["reference_clips"], mix["candidate_clips"]))


def set_distance(a, b, device) -> float:
    """The largest distance from a row of ``a`` to the nearest row of
    ``b`` or from a row of ``b`` to the nearest of ``a``, in float64 on
    ``device``; inf where a side has no rows."""
    if a is None or b is None or len(a) == 0 or len(b) == 0:
        return math.inf
    d = torch.cdist(a.to(device, torch.float64), b.to(device, torch.float64),
                    compute_mode="donot_use_mm_for_euclid_dist")  # exact near 0
    return float(torch.maximum(d.min(dim=1).values.max(), d.min(dim=0).values.max()))


def numbers(side: dict, ref: dict, device) -> dict:
    """The compared numbers of ``side`` (the program's or the control's)
    against the reference's side."""
    emb = [set_distance(side["ref_emb"], ref["ref_emb"], device)] + [
        set_distance(side["cand_emb"].get(k), ref["cand_emb"][k], device)
        for k in ref["cand_emb"]]
    fad, kd, prdc = [], [], []
    for k, want in ref["results"].items():
        got = side["results"][k]
        fad.append(abs(got["fad"] - want["fad"]) / abs(want["fad"]))
        kd.append(abs(got["kernel_distance_mean"] - want["kernel_distance_mean"])
                  / abs(want["kernel_distance_mean"]))
        prdc += [abs(got[m] - want[m]) for m in PRDC_KEYS]
    # a NaN anywhere reads inf (max() would pass over it)
    worst = lambda xs: max(xs) if all(math.isfinite(x) for x in xs) else math.inf
    return dict(emb_err=worst(emb), fad_err=worst(fad), kd_err=worst(kd),
                prdc_err=worst(prdc))


def judge(cell, params, traffic, prog: dict, picks, devices) -> dict:
    """``{number: {"value", "limit"}}`` of the program's side against the
    reference's; a number without a limit, or a missing sample, fails."""
    if not picks:
        return {name: {"value": math.inf, "limit": cell.limits.get(name)} for name in NUMBERS}
    ref = reference_side(cell, params, traffic, picks, devices)
    got = numbers(prog, ref, devices[0])
    return {name: {"value": got[name], "limit": cell.limits.get(name)} for name in NUMBERS}


def passed(checks: dict) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
