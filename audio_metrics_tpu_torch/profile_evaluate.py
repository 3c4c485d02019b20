"""Where the time of one evaluate goes, on a card.

    python -m audio_metrics_tpu_torch.profile_evaluate [--win-dur 5] [--clips 2048]
    AM_TPU_V4_STAGES= python -m audio_metrics_tpu_torch.profile_evaluate --clips 512
    python -m audio_metrics_tpu_torch.profile_evaluate --dtype float32 --clips 256

The model's configuration variables (``AM_TPU_V4_STAGES``,
``AM_TPU_ATTN_V1``, ``AM_TPU_MEL_V1``) apply as in any run; the profile
prints them and each Swin stage's block paths.

Builds ``AudioMetrics(metrics=["fad", "kd", "prdc"])`` with LaionCLAP
HTSAT-base in bf16, or in f32 (the default embedder's dtype) with
``--dtype float32`` (random weights from a seed), adds a reference of
``--clips`` clips made on the card by ``testing.seeded_clips`` with the seed
of ``chip_smoke.py``'s main path, warms up with one evaluate, then
traces one evaluate of as many candidate clips with ``torch.profiler`` and
prints: the card (``nvidia-smi`` name and power limit), the evaluate's wall
time, the device kernel time and count, the device idle share (1 - kernel
time / wall: one stream, kernels do not overlap), the kernels by device
time, and the PRDC share of the evaluate (the k-NN and statistics kernels'
device time, and the host-clock time of ``metrics.prdc.prdc`` on the
evaluate's sets, each over the evaluate's wall time).  Needs a card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def _short(name: str) -> str:
    """A kernel's name without its template arguments and namespace."""
    for key in ("gemm_sm90_kernel<", "gemm_tf32x3_kernel<", "knn_split_kernel", "knn_merge_kernel",
                "merge_stats_kernel", "stats_split_kernel", "mel_log_kernel", "ln_rows_kernel",
                "ln1_window_kernel", "hop_rows_kernel", "halo_rows_kernel", "log_mel_sm90_kernel",
                "window_attn_kernel", "frame_rows_kernel", "merged_attn_bf16",
                "merged_attn_f32", "merged_dense_bf16", "merged_dense_f32"):
        if key in name:
            i = name.find(key)
            return name[i : name.find(">", i) + 1] if key.endswith("<") else key
    return name[:80]


def launch_ms(fn, iters: int = 20) -> dict:
    """Device time (ms) per call of each kernel that ``fn`` launches, by
    name (torch.profiler over ``iters`` calls after one warm call); empty
    if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0:
            name = _short(ev.name)
            per[name] = per.get(name, 0.0) + ev.device_time_total / 1e3 / iters
    return per


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--win-dur", type=float, default=5.0)
    ap.add_argument("--clips", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_evaluate: CUDA is not available", file=sys.stderr)
        return 1
    from . import AudioMetrics
    from .metrics.prdc import prdc
    from .models.clap import LaionCLAP
    from .models.htsat import HTSAT_BASE
    from .parallel.pipeline import ItemCategory
    from .testing import card_line, seeded_clips

    sr = 48000
    reference, candidate = seeded_clips(args.clips, int(args.win_dur * sr), sr, seed=3)
    clap = LaionCLAP(cfg=HTSAT_BASE, compute_dtype=args.dtype, allow_random_weights=True,
                     device="cuda")
    am = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=clap, win_dur=args.win_dur,
                      input_sr=sr, batch_size=args.batch, device="cuda")
    am.add_reference(reference)
    am.evaluate(candidate)  # warm-up: caches, allocator, cuBLAS handles
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = am.evaluate(candidate)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0:
            k = kernels.setdefault(_short(ev.name), [0.0, 0])
            k[0] += ev.device_time_total / 1e3
            k[1] += 1
    device_ms = sum(v[0] for v in kernels.values())
    print(f"card: {card_line()}; torch {torch.__version__}")
    switches = {k: os.environ.get(k) for k in ("AM_TPU_V4_STAGES", "AM_TPU_ATTN_V1",
                                                "AM_TPU_MEL_V1")}
    paths = [[b.attention for b in stage] for stage in clap.model.encoder.blocks]
    print(f"configuration {switches}; block paths per stage {paths}")
    print(f"evaluate of {args.clips} clips of {args.win_dur} s, batch {args.batch}, "
          f"{args.dtype}, traced: "
          f"wall {wall_ms:.1f} ms, device kernel time {device_ms:.1f} ms over "
          f"{sum(v[1] for v in kernels.values())} kernels, device idle share "
          f"{1 - device_ms / wall_ms:.3f}")
    print(f"result {result}")
    for name, (ms, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"  {ms:9.2f} ms {100 * ms / device_ms:5.1f}% {cnt:6d}  {name}")
    prdc_dev = sum(kernels.get(k, [0.0])[0]
                   for k in ("knn_split_kernel", "knn_merge_kernel", "stats_split_kernel"))
    cand = am._run_pipeline(candidate, None)[ItemCategory.stem]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prdc(am.stem_reference, cand, max(1, min(10, len(am.stem_reference), len(cand))))
    torch.cuda.synchronize()
    prdc_ms = (time.perf_counter() - t0) * 1e3
    print(f"PRDC share of the evaluate: kernels {prdc_dev:.3f} ms ({prdc_dev / wall_ms:.4f} of "
          f"the wall); metrics.prdc.prdc with the reference radii cached {prdc_ms:.3f} ms host "
          f"clock ({prdc_ms / wall_ms:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
