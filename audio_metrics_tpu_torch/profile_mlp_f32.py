"""The f32 fused MLP (#9 f32, launches 5-7 of the f32 Swin block) alone on a
card, launch by launch, at the main path's shapes.

    python -m audio_metrics_tpu_torch.profile_mlp_f32 [--batch 64] \
        [--variant plain_store]

Calls ``am_swin_mlp_f32`` (kernels/csrc/swin_block.cu: LN2, fc1 + b1 +
exact-erf GELU, fc2 + b2 + residual, both products 3xTF32 on
gemm_tf32x3_sm90.cuh) on random rows of every stage of HTSAT-base and
HTSAT-tiny at ``--batch`` clips of 5 s, with weights at std 1/sqrt(fan_in),
and prints for each stage and each library: the time of each of its three
launches (torch.profiler, per call, over ``--iters`` calls after a warm
call), each product's achieved TFLOP/s (8 M C^2 f32 operations a product)
against 165 TFLOP/s (three TF32 products at 495), and the call's time
(CUDA events).  Then the sums over one forward: every stage's blocks (the
whole f32 block, #1 f32, runs these launches in each of its blocks) and the
stages whose rows the split path gives the MLP kernel (#9 f32,
``SwinBlock.fused_mlp``).

The libraries, timed in turns in one process (this, variants, variants,
this): this checkout's (``kernels.build()``); with ``--variant NAME`` a
copy of this checkout's kernel sources with the replacements of
``VARIANTS[NAME]`` (``plain_store``: the f32 MLP's epilogues store the
accumulator as it is, no GELU, no residual read; it splits a product's
time into its mainloop's and its epilogue's), built under
``kernels/build/variants/`` (git-ignored) and never committed.  Needs a
card and ``nvcc``; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

PEAK_F32_ACCURATE = 495e12 / 3  # three TF32 products at the H100's dense TF32 rate, 700 W
HERE = Path(__file__).resolve().parent
CSRC = "audio_metrics_tpu_torch/kernels/csrc"

# name: [(file under csrc, text, replacement)], each replaced wherever it
# occurs; a text that these sources do not hold is an error
VARIANTS = {
    "plain_store": [
        ("gemm_tf32x3_sm90.cuh",
         "    const float t = a + bias;\n"
         "    return 0.5f * t * (1.f + erff(t * 0.7071067811865476f));\n",
         "    return a;\n"),
        ("gemm_tf32x3_sm90.cuh", "  return a + bias + res;  // EPI_PROJ, EPI_RESID",
         "  if (EPI == EPI_RESID) return a;\n  return a + bias + res;  // EPI_PROJ, EPI_RESID"),
        ("gemm_tf32x3_sm90.cuh",
         "if (EPI == EPI_RESID) res = *reinterpret_cast<const float4*>(p.res + o);", ""),
    ],
}


def variant_library(name: str, flags: list[str]) -> ctypes.CDLL:
    """This checkout's kernel sources with ``VARIANTS[name]`` applied, built
    under ``kernels/build/variants/name``."""
    root = HERE / "kernels" / "build" / "variants" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(HERE / "kernels" / "csrc", root / CSRC)
    for file, text, repl in VARIANTS[name]:
        path = root / CSRC / file
        src = path.read_text()
        if text not in src:
            raise RuntimeError(f"variant {name}: {file} does not hold {text!r}")
        path.write_text(src.replace(text, repl))
    from .sass_diff import _tool, other_objects

    so = root / "lib.so"
    run = subprocess.run([_tool("nvcc"), *flags, "-shared", "-o", str(so),
                          *other_objects(root, flags, str(root))],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"linking {so} failed:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(so))


def mlp_call(lib: ctypes.CDLL, x, ln_w, ln_b, w1_s, b1, w2_s, b2, eps: float = 1e-5):
    """``am_swin_mlp_f32`` of ``lib`` on (M, C) f32 rows ``x`` (the
    wrapper's scratch and output, allocated here)."""
    from .kernels import _arg

    m, c = x.shape
    hbuf = torch.empty((m, c), device=x.device)
    h1 = torch.empty((m, 4 * c), device=x.device)
    out = torch.empty_like(x)
    rc = lib.am_swin_mlp_f32(*map(_arg, (x, ln_w, ln_b, w1_s, b1, w2_s, b2, m, c, float(eps),
                                         hbuf, h1, out)),
                             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"am_swin_mlp_f32 failed with cudaError {rc}")
    return out


def part_of(name: str) -> str:
    """The MLP's launch that a kernel name is: LN2, fc1 (EPI_GELU = 2) or
    fc2 (EPI_RESID = 3, gemm.cuh's enum Epi)."""
    if "ln_rows" in name:
        return "LN2"
    m = re.search(r"gemm_tf32x3_kernel<\s*\d+,\s*(?:\([^)]*\))?\s*(\d+)", name)
    return {"2": "fc1 + GELU", "3": "fc2 + residual"}.get(m.group(1) if m else "", name)


def event_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_inputs(gen, m: int, c: int) -> tuple:
    """Random rows and MLP weights of one stage: x (m, C), LN affine, w1
    (C, 4C) and w2 (4C, C) at std 1/sqrt(fan_in) as their (2, N, K) split
    stacks, biases at std 0.5."""
    from .ops.mlp import mlp_operands

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    w1, w2 = randn(c, 4 * c, std=c**-0.5), randn(4 * c, c, std=(4 * c) ** -0.5)
    ops = mlp_operands(w1, w2)
    return (randn(m, c), 1.0 + randn(c, std=0.1), randn(c, std=0.5), ops["w1_t"],
            randn(4 * c, std=0.5), ops["w2_t"], randn(c, std=0.5))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_mlp_f32: CUDA is not available", file=sys.stderr)
        return 1
    from . import kernels
    from .models.htsat import HTSAT_BASE, HTSAT_TINY
    from .profile_evaluate import launch_ms
    from .testing import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"this": kernels.build()}
    for name in args.variant:
        libs[name] = variant_library(name, kernels._NVCC_FLAGS)
    order = list(libs) + list(libs)[::-1]  # this, variants, variants, this
    print(f"card: {card_line()}; torch {torch.__version__}; batch {args.batch}; "
          f"libraries {list(libs)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for cfg_name, cfg in (("HTSAT-base", HTSAT_BASE), ("HTSAT-tiny", HTSAT_TINY)):
        totals = {k: {"all": {}, "split": {}} for k in libs}
        res = cfg.grid_size
        for stage, depth in enumerate(cfg.depths):
            c, m = cfg.embed_dim * 2**stage, args.batch * res * res
            fused = res * res >= 1024 or m >= 16384  # SwinBlock.fused_mlp
            inputs = stage_inputs(gen, m, c)
            flops = 8 * m * c * c  # each product, f32 operations
            readings = {k: [] for k in libs}
            for k in order:
                per = launch_ms(lambda: mlp_call(libs[k], *inputs), args.iters)
                readings[k].append((per, event_ms(lambda: mlp_call(libs[k], *inputs),
                                                  args.iters)))
            print(f"{cfg_name} stage {stage} R={res} C={c} M={m}: x{depth} a forward"
                  f"{'' if fused else ' (the split path takes the XLA MLP here)'}")
            for k, runs in readings.items():
                for per, ms in runs:
                    names = list(per)
                    gemms = [n for n in names if "gemm" in n]
                    rates = ", ".join(
                        f"{part_of(n)} {per[n]:.4f} ms "
                        f"({flops / (per[n] * 1e-3) / 1e12:.1f} TFLOP/s, "
                        f"{flops / (per[n] * 1e-3) / PEAK_F32_ACCURATE:.3f} of 165)"
                        if n in gemms else f"{part_of(n)} {per[n]:.4f} ms" for n in names)
                    print(f"  {k}: call {ms:.4f} ms (CUDA events); launches: {rates}")
                per = {n: sum(r[0][n] for r in runs) / len(runs) for n in runs[0][0]}
                ms = sum(r[1] for r in runs) / len(runs)
                for part in ("all", "split") if fused else ("all",):
                    t = totals[k][part]
                    t["call"] = t.get("call", 0.0) + depth * ms
                    for n in per:
                        t[part_of(n)] = t.get(part_of(n), 0.0) + depth * per[n]
            res //= 2
        for k, t in totals.items():
            for part, what in (("all", f"{sum(cfg.depths)} blocks (#1 f32's launches 5-7)"),
                               ("split", "the split path's MLP kernel blocks (#9 f32)")):
                print(f"{cfg_name} per forward, {k}, {what}: "
                      + ", ".join(f"{n} {v:.4f} ms" for n, v in t[part].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
