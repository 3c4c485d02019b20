"""Helpers for checking the port, shared by ``chip_smoke.py``, the profile
(``profile_evaluate``) and the tests; no metric or model path calls them.

- ``seeded_clips``: the reference and candidate clips of the smoke's and
  the profile's evaluates, made on the device from a seed;
- ``card_line``: the card's name and power limit from ``nvidia-smi``;
- ``stats_mismatches``: the near-tie rule for two results of the PRDC
  reductions;
- ``near_duplicate_rows``: embeddings whose k-NN radii are the small
  distances of near-duplicates, where the squared-distance formula cancels;
- ``laion_state_dict``: a parameter dict written back under a LAION CLAP
  checkpoint's names, as ``convert.convert_checkpoint`` reads them;
- ``tf32x3_matmul``: the f32 product of the 3xTF32 kernels, emulated on
  any device (or one TF32 product, ``terms=1``).
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

__all__ = ["card_line", "laion_state_dict", "near_duplicate_rows", "seeded_clips",
           "stats_mismatches", "tf32x3_matmul"]


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


def near_duplicate_rows(n: int, d: int, seed: int, group: int = 8, noise: float = 1e-2,
                        device="cuda"):
    """(n, d) f32 unit rows in groups of ``group`` near-duplicates (a random
    unit row plus ``noise`` N(0, I), normalised): for k <= group, each
    row's k-NN radius is a near-duplicate's distance (~0.3 at noise 1e-2,
    d = 512), where |a|^2 + |b|^2 - 2 a.b cancels from ~2 to ~0.1, so a dot
    product of TF32 accuracy moves it out of rtol 1e-4."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((-(-n // group), d), generator=gen, device=device)
    x = (base / base.norm(dim=1, keepdim=True)).repeat_interleave(group, dim=0)[:n]
    x = x + noise * torch.randn((n, d), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


# HF Clap name fragment -> LAION's (the converter's renames, inverted; the
# attention's output projection before the MLP's, which shares its suffix)
_TO_LAION = [
    ("audio_encoder.", "audio_branch."),
    ("batch_norm.", "bn0."),
    ("attention.output.dense.", "attn.proj."),
    ("attention.self.relative_position_bias_table", "attn.relative_position_bias_table"),
    ("intermediate.dense.", "mlp.fc1."),
    ("output.dense.", "mlp.fc2."),
    ("layernorm_before.", "norm1."),
    ("layernorm_after.", "norm2."),
    ("audio_projection.linear1.", "audio_projection.0."),
    ("audio_projection.linear2.", "audio_projection.2."),
]


def laion_state_dict(params: dict, prefix: str = "module.") -> dict:
    """``params`` (HF Clap names, numpy) as a LAION CLAP checkpoint holds
    them: LAION names under ``prefix``, each block's query, key and value
    fused into one ``attn.qkv`` (3C, C) weight and (3C,) bias, torch f32
    tensors."""
    out = {}
    for key, arr in params.items():
        if ".attention.self.key." in key or ".attention.self.value." in key:
            continue
        if ".attention.self.query." in key:
            parts = [params[key.replace(".query.", f".{n}.")] for n in ("query", "key", "value")]
            arr = np.concatenate(parts, axis=0)
            key = key.replace(".attention.self.query.", ".attn.qkv.")
        for hf, laion in _TO_LAION:
            key = key.replace(hf, laion)
        out[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3,
                  k_step: int | None = None) -> torch.Tensor:
    """``a @ b`` (f32) as the 3xTF32 kernels compute it
    (kernels/csrc/gemm_tf32x3_sm90.cuh, window_attn.cuh): both operands
    split into TF32 hi and lo parts (``ops.tf32``), the products A_lo @ B_hi
    + A_hi @ B_lo + A_hi @ B_hi summed small terms first, each in f32.
    ``terms=1`` keeps A_hi @ B_hi alone, one TF32 product.  ``k_step``: the
    depth that the kernels sum into a fresh accumulator (32): the product
    of each slice of that depth in turn, the slices' sums added in f32 in
    depth order.  Callers hold full f32 products (TF32 off) on a card."""
    from .ops.tf32 import tf32_round

    if k_step is not None and a.shape[-1] > k_step:
        out = None
        for k in range(0, a.shape[-1], k_step):
            part = tf32x3_matmul(a[..., k : k + k_step], b[..., k : k + k_step, :], terms)
            out = part if out is None else out + part
        return out
    a_hi, b_hi = tf32_round(a.float()), tf32_round(b.float())
    hi = torch.matmul(a_hi, b_hi)
    if terms == 1:
        return hi
    a_lo, b_lo = tf32_round(a.float() - a_hi), tf32_round(b.float() - b_hi)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + hi
