"""Helpers for checking the port, shared by ``chip_smoke.py``, the profile
(``profile_evaluate``) and the tests; no metric or model path calls them.

- ``seeded_clips``: the reference and candidate clips of the smoke's and
  the profile's evaluates, made on the device from a seed;
- ``card_line``: the card's name and power limit from ``nvidia-smi``;
- ``stats_mismatches``: the near-tie rule for two results of the PRDC
  reductions.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

__all__ = ["card_line", "seeded_clips", "stats_mismatches"]


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def seeded_clips(n_clips: int, n_samples: int, sr: int, seed: int, device="cuda"):
    """``(reference, candidate)``, each (n_clips, n_samples) f32 on
    ``device``: reference noise; candidate half noise of the same kind, half
    quieter noise + a 440 Hz tone, so that neither set covers the other and
    every PRDC metric lies inside [0, 1]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(n_samples, device=device) / sr
    reference = 0.2 * torch.randn((n_clips, n_samples), generator=gen, device=device)
    candidate = 0.1 * torch.randn((n_clips, n_samples), generator=gen, device=device) \
        + 0.1 * torch.sin(2 * np.pi * 440.0 * t)
    candidate[::2] = 0.2 * torch.randn((n_clips - n_clips // 2, n_samples), generator=gen,
                                       device=device)
    return reference, candidate


def stats_mismatches(ref, cand, got, want, got_radii, want_radii=None, rel: float = 1e-5):
    """Compare two results ``(cand_any, cand_count, ref_any, ref_min)`` of
    the PRDC reductions on the same embeddings, and the coverage flags
    ``ref_min < ref_radius`` they imply, under the near-tie rule: a
    differing element is explained when a float64 recomputation shows
    pairs in its row or column with |d - r| <= rel * r for the radii of
    either result, at least as many as its count differs by.
    ``got_radii`` / ``want_radii`` are the ``(ref_radii, cand_radii)`` each
    result was computed with (``want_radii`` defaults to ``got_radii``).
    Returns ``(n_differing, n_unexplained)``."""
    want_radii = got_radii if want_radii is None else want_radii
    ref, cand = ref.double(), cand.double()
    rrs = [got_radii[0].double(), want_radii[0].double()]
    crs = [got_radii[1].double(), want_radii[1].double()]

    def ties(d, radii, idx=None):
        near = torch.zeros_like(d, dtype=torch.bool)
        for r in radii:
            r = r if idx is None else r[idx]
            near |= (d - r).abs() <= rel * r.abs()
        return int(near.sum())

    cols = ((got[0] != want[0]) | (got[1] != want[1])).nonzero().flatten().tolist()
    rows = (got[2] != want[2]).nonzero().flatten().tolist()
    cov = ((got[3] < rrs[0].to(got[3].dtype)) != (want[3] < rrs[1].to(want[3].dtype)))
    cov_rows = cov.nonzero().flatten().tolist()
    n = len(cols) + len(rows) + len(cov_rows)
    if n > 1000:  # far more than ties can explain: a fault, not rounding
        return n, n
    bad = 0
    for j in cols:
        n_ties = ties((ref - cand[j]).norm(dim=1), rrs)
        bad += n_ties < max(1, abs(int(got[1][j]) - int(want[1][j])))
    for i in rows:
        bad += ties((cand - ref[i]).norm(dim=1), crs) < 1
    for i in cov_rows:
        bad += ties((cand - ref[i]).norm(dim=1).min(), rrs, i) < 1
    return n, bad
