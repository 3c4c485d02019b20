"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one status line each:
  1. the card (torch and ``nvidia-smi`` name / power limit);
  2. build of the CUDA kernels from the repository's sources (nvcc, one
     process per source, all started together);
  3. each kernel against its plain PyTorch version on the card, at the
     main-path shapes, with errors, tolerances and times: bf16 Swin blocks
     (every stage shifted and unshifted), patch merges and the 5 s
     frontend (B=4) with weights under which every part of a block moves
     its output; the f32 k-NN radii and PRDC statistics at (2048, 2048) x
     512 (bench.py's size) and (10000, 12345) x 512 (ragged against any
     tile), the booleans and counts under the near-tie rule; the log-mel at
     the CLAP 10 s geometry (BatchNorm affine, bf16 out) and the VGGish
     convention; and the FAD device tail against the host float64 path;
  4. the main path end to end: ``AudioMetrics(metrics=["fad", "kd",
     "prdc"])`` with LaionCLAP HTSAT-base in bf16 (random weights from a
     seed) over 2048 reference and 2048 candidate 5 s clips at 48 kHz
     already on the card (bench.py's eval set), with the kernels' launch
     counts, FAD of a set against itself, PRDC through the kernels against
     PRDC through the plain versions on the same stored embeddings, and the
     same evaluate through the plain versions;
  5. the 10 s path: ``win_dur=10.0`` (windows that do not tile 10 s take
     the halo log-mel kernel), 128 + 128 clips, launch counts, FAD of a set
     against itself, embeddings against the plain path, clips/s.
Then one JSON line with each kernel's numbers, the card line, and last the
ok line.  Any failure exits non-zero and prints no ok line.  Imports no JAX.
"""

from __future__ import annotations

import json
import sys
import time
import traceback

import numpy as np
import torch

N_CLIPS = 2048   # bench.py's eval set
N_CLIPS_10S = 128
CLIP_S = 5
SR = 48000
BATCH = 64       # e2e batch size
CHECK_B = 4      # kernel-vs-plain batch
# the card's peaks (NVIDIA data sheet, H100 SXM, dense, at 700 W): bytes/s
# and operations/s by type, for each kernel's bound
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12}
# bf16 kernel vs bf16 plain on the same inputs: same rounding points, other
# f32 summation order, so they differ by the odd bf16 rounding flip and what
# it propagates.  Bounds: (mean abs error / mean abs signal, max abs error),
# where the signal is what the kernel adds: out - x for the residual Swin
# block, the output itself for the others.  Set at 2-5x the readings of a
# correct kernel (PERF.md): the Swin block's relative error grows with the
# stage's width, so its bound is per stage.  A planted fault (wrong roll,
# dropped mask, swapped merge quadrants) reads 10x or more above them.
TOL = {"swin_block": ((2e-4, 5e-4, 1.5e-3, 3.5e-3), 0.0625),
       "patch_merge": (1e-5, 0.03125),
       "clap_frontend": (4e-3, 0.0625)}
# log-mel kernel vs plain (same bf16 rounding of frames and basis, other
# f32 summation order): (mean abs error / mean |out|, max abs error) per
# convention, about 5x a correct kernel's readings (PERF.md); the bf16
# output's max at one bf16 ulp of values in [32, 64).
LOG_MEL_TOL = {"clap": (1e-5, 0.25), "vggish": (1e-6, 3e-5)}
# PRDC kernels (f32): radii rtol / atol, the JAX suite's kernel-vs-XLA
# bound (tests/test_pallas_distance.py:20); ref_min rtol / atol
# (test_pallas_distance.py:38); booleans and counts equal up to near-ties
# (pairs with |d - r| <= NEAR_TIE * r in a float64 recomputation).
RADII_TOL = (1e-4, 1e-5)
REF_MIN_TOL = (1e-5, 1e-6)
NEAR_TIE = 1e-5
# End to end, kernels vs plain versions (same weights, same clips): each
# bound about 10x the reading of a correct run (PERF.md).  KD's std is a
# spread of ~1e-6 over subsets and moves most.
E2E_TOL = {"1-cos": 1e-5, "max_abs": 3e-3, "fad": 1e-3, "kernel_distance_mean": 1e-3,
           "kernel_distance_std": 3e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: dict, n_bytes: float) -> tuple[float, str]:
    """Least time (ms) the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate of their type (the
    times of the types add)."""
    t_ops = sum(n / PEAK[t] for t, n in ops.items())
    t_bytes = n_bytes / PEAK["bytes"]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def swin_bound(cfg, b):
    """The 18 Swin blocks of one forward: qkv, proj, fc1 and fc2 products
    (24 T C^2) and the window attention (4 T win^2 C), bf16; bytes: each
    block's input and output rows and its weights, bf16."""
    ops = n_bytes = 0
    res = cfg.grid_size
    for stage, depth in enumerate(cfg.depths):
        c, t = cfg.embed_dim * 2**stage, b * res * res
        ops += depth * (24 * t * c * c + 4 * t * min(cfg.window_size, res) ** 2 * c)
        n_bytes += depth * (2 * t * c * 2 + 12 * c * c * 2)
        res //= 2
    return bound({"bf16": ops}, n_bytes)


def merge_bound(cfg, b):
    """The three patch merges of one forward: (T/4, 4C) x (4C, 2C), bf16."""
    ops = n_bytes = 0
    res = cfg.grid_size
    for stage in range(len(cfg.depths) - 1):
        c, t_out = cfg.embed_dim * 2**stage, b * (res // 2) ** 2
        ops += 2 * t_out * 4 * c * 2 * c
        n_bytes += b * res * res * c * 2 + t_out * 2 * c * 2 + 8 * c * c * 2
        res //= 2
    return bound({"bf16": ops}, n_bytes)


def frontend_bound(cfg, b, n):
    """The fused frontend on (b, n) clips: the DFT of the p+2 head and the
    tail frames, the bicubic interp and the patch embed in bf16; the mel
    product of those frames in f32; bytes: the f32 clips in, the bf16
    tokens out."""
    from audio_metrics_tpu_torch.ops.frontend_fused import FRAME, HOP, _plan

    pln = _plan(n, SR, FRAME, HOP, cfg.num_mel_bins, cfg.spec_size, cfg.patch_size)
    frames = pln["head_frames"] + pln["n_frames"] - pln["t_tail0"]
    n_keep, n_mels, ps = 384, cfg.num_mel_bins, cfg.patch_size
    rg = pln["ratio"] * pln["gw"]
    bf16 = b * (2 * frames * FRAME * 2 * n_keep + 2 * ps * rg * pln["n_frames"] * n_mels
                + 2 * rg * ps * n_mels * pln["fb"] * cfg.embed_dim)
    f32 = b * 2 * frames * n_keep * n_mels
    tokens = b * (cfg.grid_size ** 2) * cfg.embed_dim
    return bound({"bf16": bf16, "f32": f32}, b * n * 4 + tokens * 2)


def prdc_values(stats, ref_radii, k):
    """PRDC from the four reductions, float64 on the host, as the port's
    ``metrics.prdc`` reduces them."""
    ca, cc, ra, rm = (t.cpu().numpy() for t in stats)
    rr = ref_radii.cpu().numpy()
    return dict(precision=float(np.mean(ca.astype(np.float64))),
                recall=float(np.mean(ra.astype(np.float64))),
                density=float(np.mean(cc.astype(np.float64))) / k,
                coverage=float(np.mean((rm < rr).astype(np.float64))))


def check_params(cfg):
    """HTSAT-base weights for the kernel checks.  Every matrix at std
    1/sqrt(fan_in), biases and relative-position tables at std 0.5, LN and
    BN affines away from 1/0: each half of a block then moves its output by
    O(1).  (``init_params``' 0.02 std leaves the attention branch at
    ~0.007 beside a residual of ~1, where a wrong roll or a dropped mask
    hides under the output's bf16 rounding.)"""
    from audio_metrics_tpu_torch.models.htsat import init_params

    rng = np.random.default_rng(0)
    params = init_params(cfg, seed=0)
    for k, v in params.items():
        if k.endswith(".bias") or "bias_table" in k:
            params[k] = rng.normal(scale=0.5, size=v.shape).astype(np.float32)
        elif v.ndim == 2:  # (out, in) linear weights
            params[k] = rng.normal(scale=v.shape[1] ** -0.5, size=v.shape).astype(np.float32)
        elif k.endswith(".weight") and "norm" in k:
            params[k] = (1.0 + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
    params["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 3.0, 64).astype(np.float32)
    return params


def compare(name, got, want, signal, results):
    """Error of the kernel's output against the plain version's, absolute
    and relative to the mean size of ``signal``."""
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (got.float() - want.float()).abs()
    mx, rel = err.max().item(), err.mean().item() / signal.float().abs().mean().item()
    r = results.setdefault(name, {"max_abs_err": 0.0, "rel_mean_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], mx)
    r["rel_mean_err"] = max(r["rel_mean_err"], rel)
    return mx, rel


def phase_kernels(cfg, params, results):
    from audio_metrics_tpu_torch.models.clap import ClapFrontend
    from audio_metrics_tpu_torch.models.htsat import PatchMerge, SwinBlock
    from audio_metrics_tpu_torch.ops.attention import swin_block, swin_block_plain
    from audio_metrics_tpu_torch.ops.frontend_fused import (
        clap_tokens_fused,
        clap_tokens_fused_plain,
    )
    from audio_metrics_tpu_torch.ops.merge import patch_merge, patch_merge_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    times = {k: {"ms": {}, "plain_ms": {}} for k in TOL}

    def check(name, shape_key, kfn, pfn, counts, x=None, stage=None):
        got, want = kfn(), pfn()
        mx, rel = compare(name, got, want, want if x is None else want.float() - x.float(),
                          results)
        rel_tol, max_tol = TOL[name]
        if stage is not None:
            rel_tol = rel_tol[stage]
        ok = mx <= max_tol and rel <= rel_tol
        log(f"  {name} {shape_key}: max_abs_err {mx:.4g} (tol {max_tol}) mean_abs_err / "
            f"mean |{'out' if x is None else 'out - x'}| {rel:.4g} (tol {rel_tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {shape_key} disagrees with its plain version")
        for b in (CHECK_B, BATCH):
            ms, pms = cuda_ms(kfn if b == CHECK_B else counts[0]), cuda_ms(
                pfn if b == CHECK_B else counts[1], iters=3)
            times[name]["ms"].setdefault(b, 0.0)
            times[name]["plain_ms"].setdefault(b, 0.0)
            times[name]["ms"][b] += ms * counts[2]
            times[name]["plain_ms"][b] += pms * counts[2]
            log(f"    B={b}: kernel {ms:.4f} ms, plain {pms:.4f} ms")

    res = cfg.grid_size
    for stage, depth in enumerate(cfg.depths):
        c = cfg.embed_dim * 2**stage
        for shift in ((0, cfg.window_size // 2) if res > cfg.window_size else (0,)):
            block = SwinBlock(params, f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}",
                              cfg, res, shift, cfg.num_heads[stage], torch.bfloat16).to(dev)
            xs = {b: torch.randn((b, res * res, c), generator=gen, device=dev).to(torch.bfloat16)
                  for b in (CHECK_B, BATCH)}
            # blocks of this (stage, shift) in one forward
            n_blocks = depth // 2 if res > cfg.window_size else depth
            check("swin_block", f"stage {stage} R={res} C={c} shift={shift}",
                  lambda: block(xs[CHECK_B], swin_block),
                  lambda: block(xs[CHECK_B], swin_block_plain),
                  (lambda: block(xs[BATCH], swin_block),
                   lambda: block(xs[BATCH], swin_block_plain), n_blocks),
                  x=xs[CHECK_B], stage=stage)
        if stage < len(cfg.depths) - 1:
            merge = PatchMerge(params, f"audio_encoder.layers.{stage}.downsample", cfg, res,
                               torch.bfloat16).to(dev)
            xs = {b: torch.randn((b, res * res, c), generator=gen, device=dev).to(torch.bfloat16)
                  for b in (CHECK_B, BATCH)}
            check("patch_merge", f"merge {stage} R={res} C={c}",
                  lambda: merge(xs[CHECK_B], patch_merge),
                  lambda: merge(xs[CHECK_B], patch_merge_plain),
                  (lambda: merge(xs[BATCH], patch_merge),
                   lambda: merge(xs[BATCH], patch_merge_plain), 1))
            res //= 2
    fr = ClapFrontend(params, cfg).to(dev)
    audio = {b: 0.2 * torch.randn((b, CLIP_S * SR), generator=gen, device=dev)
             for b in (CHECK_B, BATCH)}
    check("clap_frontend", f"B x {CLIP_S * SR} samples",
          lambda: clap_tokens_fused(audio[CHECK_B], fr, sr=SR, cfg=cfg),
          lambda: clap_tokens_fused_plain(audio[CHECK_B], fr, sr=SR, cfg=cfg),
          (lambda: clap_tokens_fused(audio[BATCH], fr, sr=SR, cfg=cfg),
           lambda: clap_tokens_fused_plain(audio[BATCH], fr, sr=SR, cfg=cfg), 1))
    bounds = {"swin_block": swin_bound(cfg, BATCH), "patch_merge": merge_bound(cfg, BATCH),
              "clap_frontend": frontend_bound(cfg, BATCH, CLIP_S * SR)}
    for name, t in times.items():
        for b in (CHECK_B, BATCH):
            log(f"  {name} per forward at B={b}: kernel {t['ms'][b]:.4f} ms, "
                f"plain {t['plain_ms'][b]:.4f} ms")
        results[name].update(ms=t["ms"][BATCH], plain_ms=t["plain_ms"][BATCH],
                             bound_ms=bounds[name][0], bound_by=bounds[name][1])
        log(f"  {name} bound at B={BATCH}: {bounds[name][0]:.4f} ms ({bounds[name][1]})")


def phase_prdc_kernels(results):
    """k-NN radii and PRDC statistics, kernel vs plain (f32, TF32 off)."""
    from audio_metrics_tpu_torch.ops.distance import (
        knn_radii,
        knn_radii_plain,
        pairwise_stats,
        pairwise_stats_plain,
    )
    from audio_metrics_tpu_torch.testing import stats_mismatches

    gen = torch.Generator(device="cuda").manual_seed(4)
    k, d = 10, 512

    def sets(n, m):  # candidate 0.05 + 1.02 N(0, I): every metric inside (0, 1)
        ref = torch.randn((n, d), generator=gen, device="cuda")
        return ref, 0.05 + 1.02 * torch.randn((m, d), generator=gen, device="cuda")

    knn = results.setdefault("knn_radii", {"max_abs_err": 0.0})
    st = results.setdefault("prdc_stats", {"max_abs_err": 0.0})
    for n, m in ((2048, 2048), (10000, 12345)):
        ref, cand = sets(n, m)
        rr_p, cr_p = knn_radii_plain(ref, k), knn_radii_plain(cand, k)
        for got, want in ((knn_radii(ref, k), rr_p), (knn_radii(cand, k), cr_p)):
            torch.cuda.synchronize()
            err = (got - want).abs()
            out = int((err > RADII_TOL[1] + RADII_TOL[0] * want.abs()).sum())
            knn["max_abs_err"] = max(knn["max_abs_err"], err.max().item())
            log(f"  knn_radii ({len(want)}, {d}) k={k + 1}: max abs err {err.max().item():.4g}, "
                f"max rel err {(err / want).max().item():.4g}, outside rtol {RADII_TOL[0]} "
                f"atol {RADII_TOL[1]}: {out} {'ok' if not out else 'FAIL'}")
            if out:
                raise AssertionError("knn_radii kernel disagrees with its plain version")
        got = pairwise_stats(ref, cand, rr_p, cr_p)
        torch.cuda.synchronize()
        want = pairwise_stats_plain(ref, cand, rr_p, cr_p)
        n_diff, n_bad = stats_mismatches(ref, cand, got, want, (rr_p, cr_p), rel=NEAR_TIE)
        mn_err = (got[3] - want[3]).abs()
        mn_out = int((mn_err > REF_MIN_TOL[1] + REF_MIN_TOL[0] * want[3].abs()).sum())
        st["max_abs_err"] = max(st["max_abs_err"], mn_err.max().item())
        log(f"  prdc_stats ({n}, {m}) x {d}: {n_diff} differing elements, "
            f"{n_diff - n_bad} near-ties (|d - r| <= {NEAR_TIE} r in float64), {n_bad} not; "
            f"ref_min max abs err {mn_err.max().item():.4g}, outside rtol {REF_MIN_TOL[0]} "
            f"atol {REF_MIN_TOL[1]}: {mn_out} {'ok' if not (n_bad or mn_out) else 'FAIL'}")
        log(f"    kernel PRDC {prdc_values(got, rr_p, k)}")
        if n_bad or mn_out:
            raise AssertionError("prdc_stats kernel disagrees with its plain version")
    x = ref[:2048]
    r = knn_radii(x, k)
    same = prdc_values(pairwise_stats(x, x, r, r), r, k)
    log(f"  the same 2048 rows against themselves: {same}")
    if not same["precision"] == same["recall"] == same["coverage"] == 1.0:
        raise AssertionError("PRDC of a set against itself is not 1")

    for n in (2048, 20480):
        ref, cand = sets(n, n)
        rr, cr = knn_radii_plain(ref, k), knn_radii_plain(cand, k)
        it = 10 if n == 2048 else 3
        t = {"knn_radii": (cuda_ms(lambda: knn_radii(ref, k), it),
                           cuda_ms(lambda: knn_radii_plain(ref, k), it)),
             "prdc_stats": (cuda_ms(lambda: pairwise_stats(ref, cand, rr, cr), it),
                            cuda_ms(lambda: pairwise_stats_plain(ref, cand, rr, cr), it))}
        b = {"knn_radii": bound({"f32": 2 * n * n * d}, n * d * 4 + n * 4 * 2),
             "prdc_stats": bound({"f32": 2 * n * n * d}, 2 * n * d * 4 + 2 * n * 4 + 2 * n * 5)}
        for name, (ms, pms) in t.items():
            log(f"  {name} at ({n}, {n}) x {d}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                f"bound {b[name][0]:.4f} ms ({b[name][1]})")
            if n == 2048:  # bench.py's size, the main path's
                results[name].update(ms=ms, plain_ms=pms, bound_ms=b[name][0],
                                     bound_by=b[name][1])


def phase_log_mel(cfg, params, results):
    """The halo log-mel kernel vs its plain version: CLAP 10 s (centered,
    dB, BatchNorm affine, bf16 out) and VGGish (400-sample frames, n_fft
    512, uncentered, natural log, f32 out)."""
    from audio_metrics_tpu_torch.models.clap import ClapFrontend, _clap_fb
    from audio_metrics_tpu_torch.ops.mel import log_mel_halo, log_mel_halo_plain, mel_filter_bank

    fr = ClapFrontend(params, cfg).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    vgg_fb = mel_filter_bank(257, 64, 125.0, 7500.0, 16000, norm=None, mel_scale="htk",
                             triangle_domain="mel", zero_dc=True).astype(np.float32)
    convs = {
        "clap": (10 * SR, dict(frame_length=1024, hop_length=480, n_fft=1024, fb=_clap_fb(),
                               center=True, log_mode="db", out_affine=(fr.bn_scale, fr.bn_offset),
                               out_dtype=torch.bfloat16)),
        "vggish": (10 * 16000, dict(frame_length=400, hop_length=160, n_fft=512, fb=vgg_fb,
                                    center=False, log_mode="natural")),
    }
    for conv, (n, kw) in convs.items():
        audio = {b: 0.2 * torch.randn((b, n), generator=gen, device="cuda")
                 for b in (CHECK_B, BATCH)}
        got = log_mel_halo(audio[CHECK_B], **kw)
        want = log_mel_halo_plain(audio[CHECK_B], **kw)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"log_mel {conv}: {got.shape} {got.dtype} vs {want.shape} "
                                 f"{want.dtype}")
        mx, rel = compare("log_mel", got, want, want, results)
        rel_tol, max_tol = LOG_MEL_TOL[conv]
        ok = mx <= max_tol and rel <= rel_tol
        log(f"  log_mel {conv} {tuple(got.shape)} {got.dtype}: max_abs_err {mx:.4g} (tol "
            f"{max_tol}) mean_abs_err / mean |out| {rel:.4g} (tol {rel_tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"log_mel {conv} disagrees with its plain version")
        ms = cuda_ms(lambda: log_mel_halo(audio[BATCH], **kw))
        pms = cuda_ms(lambda: log_mel_halo_plain(audio[BATCH], **kw), iters=3)
        frames, n_keep = got.shape[1], 384 if conv == "clap" else 256
        b = bound({"bf16": 2 * BATCH * frames * kw["frame_length"] * 2 * n_keep,
                   "f32": 2 * BATCH * frames * n_keep * 64},
                  BATCH * n * 4 + BATCH * frames * 64 * got.element_size())
        log(f"    B={BATCH}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
        if conv == "clap":
            results["log_mel"].update(ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1])


def phase_fad_tail():
    """nsdev device tail vs the host f64 path on full-rank moments
    (d=512, n=1024): rel 1e-5, the bound of tests/test_fad_device_tail.py."""
    from audio_metrics_tpu_torch.data import AudioMetricsData, batch_moments
    from audio_metrics_tpu_torch.metrics.fad import fad_device_tail, frechet_distance

    gen = torch.Generator(device="cuda").manual_seed(2)
    mix = torch.randn((512, 512), generator=gen, device="cuda") / 24
    ref_e = torch.randn((1024, 512), generator=gen, device="cuda") @ mix
    cand_e = torch.randn((1024, 512), generator=gen, device="cuda") @ mix + 0.05
    ref = AudioMetricsData()
    ref.add_moments_device(1024, *batch_moments(ref_e)[1:])
    cand = AudioMetricsData()
    cand.add_moments_device(1024, *batch_moments(cand_e)[1:])
    dev = fad_device_tail(cand, ref)
    if dev is None:
        raise AssertionError("FAD device tail did not apply to full-rank moments")
    host = frechet_distance(cand, ref)
    rel = abs(dev - host) / abs(host)
    log(f"  fad nsdev device tail {dev:.8g} vs host f64 {host:.8g}: rel {rel:.3g} (tol 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError("FAD device tail disagrees with the host path")


def set_counts_to_zero():
    from audio_metrics_tpu_torch.kernels import KERNELS

    for k in KERNELS.values():
        k.launches = 0


def read_counts() -> dict:
    from audio_metrics_tpu_torch.kernels import KERNELS

    torch.cuda.synchronize()
    return {k.name: k.launches for k in KERNELS.values()}


def check_counts(what: str, launches: dict, want: dict) -> None:
    log(f"  launches {what}: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"a kernel of the path was not launched as expected ({what})")


def compare_embeddings(e_k, e_p):
    cos = (e_k * e_p).sum(dim=1).min().item()
    emax = (e_k - e_p).abs().max().item()
    log(f"  embeddings kernel vs plain: 1 - min cosine {1 - cos:.3g} (tol {E2E_TOL['1-cos']}), "
        f"max abs {emax:.4g} (tol {E2E_TOL['max_abs']})")
    if not (1 - cos <= E2E_TOL["1-cos"] and emax <= E2E_TOL["max_abs"]):
        raise AssertionError("kernel-path embeddings disagree with the plain path")


def clips(n_clips, seconds, seed):
    """Seeded clips made on the card (``testing.seeded_clips``)."""
    from audio_metrics_tpu_torch.testing import seeded_clips

    reference, candidate = seeded_clips(n_clips, seconds * SR, SR, seed)
    log(f"  {n_clips} + {n_clips} clips of {seconds} s on the card "
        f"({2 * reference.numel() * 4 / 2**30:.3f} GiB f32), batch {BATCH}")
    return reference, candidate


def phase_e2e(card: str):
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.ops.attention import swin_block_plain
    from audio_metrics_tpu_torch.ops.distance import (
        knn_radii,
        knn_radii_plain,
        pairwise_stats,
        pairwise_stats_plain,
    )
    from audio_metrics_tpu_torch.ops.frontend_fused import clap_tokens_fused_plain
    from audio_metrics_tpu_torch.ops.merge import patch_merge_plain
    from audio_metrics_tpu_torch.testing import stats_mismatches

    metrics = ["fad", "kd", "prdc"]
    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     device="cuda")
    am = AudioMetrics(metrics=metrics, embedder=clap, win_dur=float(CLIP_S),
                      input_sr=SR, batch_size=BATCH, device="cuda")
    reference, candidate = clips(N_CLIPS, CLIP_S, seed=3)

    set_counts_to_zero()
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = read_counts()
    forwards = 2 * -(-N_CLIPS // BATCH)
    log(f"  result {result}")
    check_counts(f"add_reference + first evaluate, {forwards} forward batches", launches,
                 {"swin_block": 18 * forwards, "patch_merge": 3 * forwards,
                  "clap_frontend": forwards, "knn_radii": 2, "prdc_stats": 1, "log_mel": 0})
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")

    set_counts_to_zero()
    t0 = time.perf_counter()
    again = am.evaluate(candidate)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check_counts("second evaluate (reference radii cached)", read_counts(),
                 {"swin_block": 9 * forwards, "patch_merge": 3 * forwards // 2,
                  "clap_frontend": forwards // 2, "knn_radii": 1, "prdc_stats": 1, "log_mel": 0})
    log(f"  evaluate of {N_CLIPS} clips: {N_CLIPS / warm:.2f} clips/s warm ({warm:.4f} s), "
        f"{N_CLIPS / cold:.2f} clips/s first ({cold:.4f} s) [{card}; real_weights: false]")
    if again != result:
        log(f"  note: repeat evaluate {again}")

    # PRDC through the kernels vs through the plain versions, on the same
    # stored embeddings (the candidate's embedded once more)
    k = max(1, min(10, N_CLIPS))
    ref_e = am.stem_reference.embeddings
    cand_e = am._run_pipeline(candidate).embeddings
    rr_k, cr_k = am.stem_reference.radii[f"radii_{k}"], knn_radii(cand_e, k)
    rr_p, cr_p = knn_radii_plain(ref_e, k), knn_radii_plain(cand_e, k)
    for name, got, want in (("reference", rr_k, rr_p), ("candidate", cr_k, cr_p)):
        err = (got - want).abs()
        out = int((err > RADII_TOL[1] + RADII_TOL[0] * want.abs()).sum())
        log(f"  {name} radii kernel vs plain: max abs err {err.max().item():.4g}, outside "
            f"rtol {RADII_TOL[0]} atol {RADII_TOL[1]}: {out}")
        if out:
            raise AssertionError("main-path radii disagree with the plain version")
    st_k = pairwise_stats(ref_e, cand_e, rr_k, cr_k)
    st_p = pairwise_stats_plain(ref_e, cand_e, rr_p, cr_p)
    n_diff, n_bad = stats_mismatches(ref_e, cand_e, st_k, st_p, (rr_k, cr_k), (rr_p, cr_p),
                                     rel=NEAR_TIE)
    v_k, v_p = prdc_values(st_k, rr_k, k), prdc_values(st_p, rr_p, k)
    log(f"  PRDC on the stored embeddings: kernels {v_k}, plain {v_p}; {n_diff} differing "
        f"elements, {n_diff - n_bad} near-ties, {n_bad} not {'ok' if not n_bad else 'FAIL'}")
    if n_bad:
        raise AssertionError("main-path PRDC through the kernels disagrees with the plain one")

    self_fad = am.evaluate(reference)["fad"]
    log(f"  FAD of the reference against itself: {self_fad:.3g} (tol |fad| <= 1e-4)")
    if not abs(self_fad) <= 1e-4:
        raise AssertionError("FAD(reference, reference) is not ~0")

    model = clap.model

    class PlainPath:  # the same weights through the kernels' plain versions
        sr, device = clap.sr, clap.device

        @staticmethod
        @torch.no_grad()
        def embed(audio):
            tokens = clap_tokens_fused_plain(audio, model.frontend, sr=SR, cfg=model.cfg)
            latent = model.encoder(tokens, swin_block_plain, patch_merge_plain)
            return model._projection_taps(latent)[clap.layer]

    amp = AudioMetrics(metrics=metrics, embedder=PlainPath(), win_dur=float(CLIP_S),
                       input_sr=SR, batch_size=BATCH, device="cuda")
    amp.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = amp.evaluate(candidate)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    log(f"  plain path: {plain} ({N_CLIPS / plain_s:.2f} clips/s)")
    compare_embeddings(am.stem_reference.embeddings, amp.stem_reference.embeddings)
    for key, v in result.items():
        rel = abs(v - plain[key]) / max(abs(plain[key]), 1e-12)
        if key not in E2E_TOL:  # PRDC over embeddings that differ by ~1e-4: printed only
            log(f"  {key}: kernel path {v:.6g} plain path {plain[key]:.6g} rel {rel:.3g}")
            continue
        log(f"  {key}: kernel {v:.6g} plain {plain[key]:.6g} rel {rel:.3g} "
            f"(tol {E2E_TOL[key]})")
        if not rel <= E2E_TOL[key]:
            raise AssertionError(f"{key} through the kernels disagrees with the plain path")
    return launches


def phase_10s(card: str):
    """``win_dur=10.0``: the windows do not tile 10 s, so the forward takes
    the repeat-pad, the halo log-mel kernel and plain frontend products."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.models.clap import LaionCLAP, _clap_fb, repeat_pad
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE, frontend_tokens
    from audio_metrics_tpu_torch.ops.attention import swin_block_plain
    from audio_metrics_tpu_torch.ops.mel import log_mel_halo_plain
    from audio_metrics_tpu_torch.ops.merge import patch_merge_plain

    metrics = ["fad", "kd", "prdc"]
    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     device="cuda")
    am = AudioMetrics(metrics=metrics, embedder=clap, win_dur=10.0, input_sr=SR,
                      batch_size=BATCH, device="cuda")
    reference, candidate = clips(N_CLIPS_10S, 10, seed=6)

    set_counts_to_zero()
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = read_counts()
    forwards = 2 * -(-N_CLIPS_10S // BATCH)
    log(f"  result {result}")
    check_counts(f"add_reference + first evaluate, {forwards} forward batches", launches,
                 {"swin_block": 18 * forwards, "patch_merge": 3 * forwards, "clap_frontend": 0,
                  "knn_radii": 2, "prdc_stats": 1, "log_mel": forwards})
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")
    t0 = time.perf_counter()
    am.evaluate(candidate)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"  evaluate of {N_CLIPS_10S} 10 s clips: {N_CLIPS_10S / warm:.2f} clips/s warm "
        f"({warm:.4f} s), {N_CLIPS_10S / cold:.2f} clips/s first ({cold:.4f} s) "
        f"[{card}; real_weights: false]")
    self_fad = am.evaluate(reference)["fad"]
    log(f"  FAD of the reference against itself: {self_fad:.3g} (tol |fad| <= 1e-4)")
    if not abs(self_fad) <= 1e-4:
        raise AssertionError("FAD(reference, reference) is not ~0")

    model, fr = clap.model, clap.model.frontend

    class PlainPath:  # repeat-pad, plain halo log-mel, plain Swin and merge
        sr, device = clap.sr, clap.device

        @staticmethod
        @torch.no_grad()
        def embed(audio):
            mel = log_mel_halo_plain(
                repeat_pad(audio), frame_length=1024, hop_length=480, n_fft=1024,
                fb=_clap_fb(), center=True, log_mode="db",
                out_affine=(fr.bn_scale, fr.bn_offset), out_dtype=torch.bfloat16)
            tokens = frontend_tokens(mel, fr.patch_w, fr.patch_b, fr.ln_w, fr.ln_b,
                                     model.cfg, torch.bfloat16)
            latent = model.encoder(tokens, swin_block_plain, patch_merge_plain)
            return model._projection_taps(latent)[clap.layer]

    amp = AudioMetrics(metrics=metrics, embedder=PlainPath(), win_dur=10.0, input_sr=SR,
                       batch_size=BATCH, device="cuda")
    amp.add_reference(reference)
    plain = amp.evaluate(candidate)
    log(f"  plain path: {plain}")
    compare_embeddings(am.stem_reference.embeddings, amp.stem_reference.embeddings)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from audio_metrics_tpu_torch import kernels
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.testing import card_line

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 references
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"phase 1 card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    kernels.build()
    log(f"phase 2 build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds} s)")

    log("phase 3 kernels vs plain")
    cfg = HTSAT_BASE
    params = check_params(cfg)
    results: dict = {}
    phase_kernels(cfg, params, results)
    phase_prdc_kernels(results)
    phase_log_mel(cfg, params, results)
    phase_fad_tail()

    log("phase 4 main path end to end (fad + kd + prdc, HTSAT-base bf16, 5 s windows)")
    launches = phase_e2e(card)
    log("phase 5 the 10 s path (fad + kd + prdc, HTSAT-base bf16, 10 s windows)")
    launches_10s = phase_10s(card)

    # launches: each kernel's count on the path that runs it (log_mel: the
    # 10 s path; the others: the main path)
    line = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": (launches_10s if k.name == "log_mel" else launches)[k.name],
         **{key: results[k.name][key] for key in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None}
        for k in kernels.KERNELS.values()
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
