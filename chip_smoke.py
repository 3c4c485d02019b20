"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one status line each:
  1. the card (torch and ``nvidia-smi`` name / power limit);
  2. build of the CUDA kernels from the repository's sources (nvcc);
  3. each kernel against its plain PyTorch version on the card, bf16, at
     the main-path shapes (B=4: every Swin stage shifted and unshifted,
     every patch merge, the 5 s frontend) with weights under which every
     part of a block moves its output, with errors, tolerances and times,
     and the FAD device tail against the host float64 path;
  4. the slice end to end: ``AudioMetrics(metrics=["fad", "kd"])`` with
     LaionCLAP HTSAT-base in bf16 (random weights from a seed) over 256
     reference and 256 candidate 5 s clips at 48 kHz already on the card,
     with the kernels' launch counts, FAD of a set against itself, and the
     same evaluate through the plain versions.
Then one JSON line with each kernel's numbers, and last the ok line.  Any
failure exits non-zero and prints no ok line.  Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

N_CLIPS = 256
CLIP_S = 5
SR = 48000
BATCH = 64       # e2e batch size
CHECK_B = 4      # kernel-vs-plain batch
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
# End to end, kernels vs plain versions (same weights, same clips): each
# bound about 10x the reading of a correct run (PERF.md).  KD's std is a
# spread of ~1e-6 over subsets and moves most.
E2E_TOL = {"1-cos": 1e-5, "max_abs": 3e-3, "fad": 1e-3, "kernel_distance_mean": 1e-3,
           "kernel_distance_std": 3e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    for name, t in times.items():
        for b in (CHECK_B, BATCH):
            log(f"  {name} per forward at B={b}: kernel {t['ms'][b]:.4f} ms, "
                f"plain {t['plain_ms'][b]:.4f} ms")
        results[name]["ms"] = t["ms"][BATCH]
        results[name]["plain_ms"] = t["plain_ms"][BATCH]


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


def phase_e2e(card: str):
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.kernels import KERNELS
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE
    from audio_metrics_tpu_torch.ops.attention import swin_block_plain
    from audio_metrics_tpu_torch.ops.frontend_fused import clap_tokens_fused_plain
    from audio_metrics_tpu_torch.ops.merge import patch_merge_plain

    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype="bfloat16", allow_random_weights=True,
                     device="cuda")
    am = AudioMetrics(metrics=["fad", "kd"], embedder=clap, win_dur=float(CLIP_S),
                      input_sr=SR, batch_size=BATCH, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = CLIP_S * SR
    t = torch.arange(n, device="cuda") / SR
    reference = 0.2 * torch.randn((N_CLIPS, n), generator=gen, device="cuda")
    candidate = 0.1 * torch.randn((N_CLIPS, n), generator=gen, device="cuda") \
        + 0.1 * torch.sin(2 * np.pi * 440.0 * t)
    log(f"  {N_CLIPS} + {N_CLIPS} clips of {CLIP_S} s on the card "
        f"({2 * reference.numel() * 4 / 2**30:.3f} GiB f32), batch {BATCH}")

    for k in KERNELS.values():
        k.launches = 0
    am.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = am.evaluate(candidate)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS.values()}
    forwards = 2 * -(-N_CLIPS // BATCH)
    want = {"swin_block": 18 * forwards, "patch_merge": 3 * forwards, "clap_frontend": forwards}
    log(f"  result {result}")
    log(f"  launches {launches} (expected {want} for {forwards} forward batches)")
    if launches != want:
        raise AssertionError("a kernel of the path was not launched as expected")
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError("non-finite metric")

    t0 = time.perf_counter()
    again = am.evaluate(candidate)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"  evaluate of {N_CLIPS} clips: {N_CLIPS / warm:.2f} clips/s warm ({warm:.4f} s), "
        f"{N_CLIPS / cold:.2f} clips/s first ({cold:.4f} s) [{card}; real_weights: false]")
    if again != result:
        log(f"  note: repeat evaluate {again}")

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

    amp = AudioMetrics(metrics=["fad", "kd"], embedder=PlainPath(), win_dur=float(CLIP_S),
                       input_sr=SR, batch_size=BATCH, device="cuda")
    amp.add_reference(reference)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = amp.evaluate(candidate)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    e_k, e_p = am.stem_reference.embeddings, amp.stem_reference.embeddings
    cos = (e_k * e_p).sum(dim=1).min().item()
    emax = (e_k - e_p).abs().max().item()
    log(f"  plain path: {plain} ({N_CLIPS / plain_s:.2f} clips/s); embeddings kernel vs "
        f"plain: 1 - min cosine {1 - cos:.3g} (tol {E2E_TOL['1-cos']}), max abs {emax:.4g} "
        f"(tol {E2E_TOL['max_abs']})")
    if not (1 - cos <= E2E_TOL["1-cos"] and emax <= E2E_TOL["max_abs"]):
        raise AssertionError("kernel-path embeddings disagree with the plain path")
    for key, v in result.items():
        rel = abs(v - plain[key]) / max(abs(plain[key]), 1e-12)
        log(f"  {key}: kernel {v:.6g} plain {plain[key]:.6g} rel {rel:.3g} "
            f"(tol {E2E_TOL[key]})")
        if not rel <= E2E_TOL[key]:
            raise AssertionError(f"{key} through the kernels disagrees with the plain path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from audio_metrics_tpu_torch import kernels
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 references
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"phase 1 card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    kernels.build()
    log(f"phase 2 build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds} s)")

    log("phase 3 kernels vs plain (bf16)")
    cfg = HTSAT_BASE
    results: dict = {}
    phase_kernels(cfg, check_params(cfg), results)
    phase_fad_tail()

    log("phase 4 slice end to end (fad + kd, HTSAT-base bf16)")
    launches = phase_e2e(card)

    line = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], "max_abs_err": results[k.name]["max_abs_err"],
         "ms": results[k.name]["ms"], "plain_ms": results[k.name]["plain_ms"]}
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
