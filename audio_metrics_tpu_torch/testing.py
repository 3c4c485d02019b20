"""Helpers for checking the port, shared by ``chip_smoke.py``, the profile
(``profile_evaluate``) and the tests; no metric or model path calls them.

- ``seeded_clips``: the reference and candidate clips of the smoke's and
  the profile's evaluates, made on the device from a seed;
- ``seeded_pairs``: context+stem pairs for APA, made likewise;
- ``seeded_songs``: songs of varied length for the host-fed path, a list
  of numpy arrays on the host, mono or context+stem;
- ``card_line``: the card's name and power limit from ``nvidia-smi``;
- ``stats_mismatches``: the near-tie rule for two results of the PRDC
  reductions; ``prdc_mismatches`` applies it to two computations' reference
  and candidate embeddings (the port's and the JAX package's);
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

__all__ = ["card_line", "laion_state_dict", "near_duplicate_rows", "prdc_mismatches",
           "seeded_clips", "seeded_pairs", "seeded_songs", "stats_mismatches", "tf32x3_matmul"]


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


def seeded_pairs(n_pairs: int, n_samples: int, sr: int, seed: int, misaligned: int = 0,
                 device="cuda") -> torch.Tensor:
    """(n_pairs, n_samples, 2) f32 context+stem pairs on ``device``: in the
    context a tone of random pitch (110-880 Hz) under a random envelope
    (1-8 Hz), over noise at std 0.02; in the stem its octave under the same
    envelope, at half the amplitude, over its own noise.  In the last
    ``misaligned`` pairs the stem follows the next pair's pitch and
    envelope instead, so that a set with some is less adherent."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((n_pairs, 1), generator=gen, device=device)

    t = torch.arange(n_samples, device=device) / sr
    f, rate, phase = uniform(110.0, 880.0), uniform(1.0, 8.0), uniform(0.0, 2 * np.pi)
    env = 0.5 * (1 + torch.sin(2 * np.pi * rate * t + phase))
    ctx = env * torch.sin(2 * np.pi * f * t)
    if misaligned:
        k = n_pairs - misaligned
        f, env = f.clone(), env.clone()
        f[k:], env[k:] = torch.roll(f[k:], 1, 0), torch.roll(env[k:], 1, 0)
    stem = 0.5 * env * torch.sin(2 * np.pi * 2 * f * t)
    noise = 0.02 * torch.randn((n_pairs, n_samples, 2), generator=gen, device=device)
    return torch.stack([ctx, stem], dim=2) + noise


def seeded_songs(n_windows: int, win_len: int, sr: int, seed: int, pairs: bool = False,
                 candidate: bool = False, max_windows: int = 7, device="cpu") -> list:
    """A list of f32 numpy songs that hold ``n_windows`` whole windows of
    ``win_len`` samples in all: each song k + f windows long, k drawn from
    1..``max_windows`` (the last song's cut to the total) and f from [0.1,
    0.9), so that every song ends in a partial window, which the pipeline
    drops.  Made on ``device`` from ``seed`` (one generator a song), then
    copied to the host.  Mono songs (n,): noise at std 0.2, and with
    ``candidate`` every other song half as loud over a 440 Hz tone at 0.1,
    so that neither set covers the other.  ``pairs``: (n, 2) context+stem
    songs, each ``seeded_pairs`` of one pair (a tone and its octave under
    one envelope, over noise)."""
    rng = np.random.default_rng(seed)
    songs, total = [], 0
    while total < n_windows:
        k = min(int(rng.integers(1, max_windows + 1)), n_windows - total)
        n = int((k + rng.uniform(0.1, 0.9)) * win_len)
        song_seed = int(rng.integers(2**31))
        if pairs:
            x = seeded_pairs(1, n, sr, song_seed, device=device)[0]
        else:
            gen = torch.Generator(device=device).manual_seed(song_seed)
            x = 0.2 * torch.randn(n, generator=gen, device=device)
            if candidate and len(songs) % 2:
                t = torch.arange(n, device=device) / sr
                x = 0.5 * x + 0.1 * torch.sin(2 * np.pi * 440.0 * t)
        songs.append(x.float().cpu().numpy())
        total += k
    return songs


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


def prdc_mismatches(ref_a, cand_a, ref_b, cand_b, rel: float = 1e-5):
    """``stats_mismatches`` of the PRDC reductions of two computations of
    the same sets, ``(ref_a, cand_a)`` and ``(ref_b, cand_b)`` (f32 tensors
    or arrays, rows that agree to rounding), each with its own k-NN radii
    at ``AudioMetrics``' k = min(10, n_ref, n_cand), all through the plain
    versions.  Returns ``(n_differing, n_unexplained)``."""
    from .ops.distance import knn_radii_plain, pairwise_stats_plain

    sets = [tuple(torch.as_tensor(np.asarray(x, np.float32)) for x in pair)
            for pair in ((ref_a, cand_a), (ref_b, cand_b))]
    k = max(1, min(10, len(ref_a), len(cand_a)))
    radii = [(knn_radii_plain(r, k), knn_radii_plain(c, k)) for r, c in sets]
    stats = [pairwise_stats_plain(r, c, *rad) for (r, c), rad in zip(sets, radii)]
    return stats_mismatches(*sets[0], stats[0], stats[1], radii[0], radii[1], rel=rel)


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


# gemm_tf32x3_sm90.cuh's gemm_rs, which runs the f32 MLP's fc1 (EPI_GELU)
# and fc2 (EPI_RESID): 128-row tiles, K steps of 32, and the depth up to
# which the consumer warpgroups share the epilogue's rows (RS_SHARE_K)
RS_BM, RS_BK = 128, 32
RS_SHARE_K = {"fc1": 256, "fc2": 512}


def mlp_f32_schedule(c: int, m: int, sms: int) -> dict:
    """What each of the f32 MLP's products does at width ``c`` on ``m``
    rows on a card of ``sms`` SMs: its column tile ``bn`` (``launch_bn``'s
    choice), its 128 x bn ``tiles``, the most tiles a block takes (a grid
    of min(tiles, sms) blocks, tile t to block t % grid), the rows of its
    last row tile, its depth ``k`` in ``ksteps`` K steps, and whether the
    consumers store a share of the epilogue's rows (``shared``: K <=
    RS_SHARE_K; else the epilogue warps store every row)."""
    out = {}
    for name, n, k in (("fc1", 4 * c, c), ("fc2", c, 4 * c)):
        bn = 128 if n % 128 == 0 else 64 if n % 64 == 0 else 96
        tiles = -(-m // RS_BM) * (n // bn)
        out[name] = dict(bn=bn, tiles=tiles, per_block=-(-tiles // sms),
                         last_rows=m - (-(-m // RS_BM) - 1) * RS_BM, k=k, ksteps=k // RS_BK,
                         shared=k <= RS_SHARE_K[name])
    return out


def mlp_f32_edge_rows(c: int, sms: int) -> dict:
    """Row counts of the f32 MLP (#9 f32) at width ``c`` on a card of
    ``sms`` SMs that reach the edges of its products' schedule
    (``mlp_f32_schedule``; each consumer warpgroup holds 64 rows of a
    128-row tile): one row tile whose rows all lie in consumer 0's half;
    one that reaches into consumer 1's; three, the last holding 20 rows,
    fewer than the epilogue warps' share of a warpgroup's 64; one tile a
    block for both products; and fc2's tiles over two SMs' worth, so that
    some blocks hold 3 tiles (an odd count above 1) and the others 2.
    Every last row tile is partial.  The depths are C's: at C = 96 and
    128 both products are shallow enough for the consumers to share the
    epilogue, at 256 fc1 only, at 512 and 1024 neither; fc1 at C = 96 has
    an odd number of K steps (3)."""
    n1, n2 = (mlp_f32_schedule(c, RS_BM, sms)[k]["tiles"] for k in ("fc1", "fc2"))
    return {"M < 64, one tile": 40, "M < 128, one tile": 100,
            "3 row tiles, the last of 20 rows": 2 * RS_BM + 20,
            "one tile a block": RS_BM * ((sms - 1) // n1) - 5,
            "2 or 3 tiles a block": RS_BM * -(-(5 * sms // 2) // n2) - 9}


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
