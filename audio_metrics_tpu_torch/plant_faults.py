"""Plant one fault at a time in a copy of the checkout and run the smoke there.

    python -m audio_metrics_tpu_torch.plant_faults [NAME ...]

Each fault is one textual replacement in one source file (``FAULTS``); a
replacement that does not match exactly once is an error, so a fault can
never be silently absent.  For each named fault (by default all but
``CPU_FAULTS``, which the CPU tests plant and catch) the
checkout is copied, without its kernel build, ``.git`` and caches,
into ``kernels/build/faults/<NAME>`` (git-ignored), the fault is planted
there, and ``python3 chip_smoke.py`` runs in the copy under a time limit
(a fault in a barrier ring could hang a kernel; the wgmma core's waits trap
after 2^34 clocks).  A fault is caught when the smoke exits non-zero.
Printed per fault: exit code, the smoke's lines that report a failure
(``FAIL``, ``DIFFERS``, an exception), and the last line; then one JSON
line ``{"faults": {NAME: {"rc": .., "caught": ..}}}``.  Needs a card: the
smoke exits non-zero without one, which would count every fault caught, so
this exits non-zero first.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CSRC = "audio_metrics_tpu_torch/kernels/csrc"

# name: (file, text, replacement, what it breaks)
FAULTS = {
    "L1": (f"{CSRC}/log_mel.cu", "const int s = r * hop + i0 + e - half;",
           "const int s = r * hop_pad + i0 + e - half;",
           "the halo log-mel's padded hop rows (a hop not a multiple of 8) step hop_pad "
           "samples a row, not hop"),
    "L2": (f"{CSRC}/log_mel.cu", "if (nt == 0) {", "if (nt >= 0) {",
           "the halo log-mel's mel accumulator is reset at every N tile"),
    "L3": (f"{CSRC}/log_mel.cu",
           "            v[e] = log_of(v[e], p.log_mode, p.log_offset);\n"
           "            if (p.sc != nullptr) v[e] = v[e] * p.sc[m] + p.of[m];\n",
           "            if (p.sc != nullptr) v[e] = v[e] * p.sc[m] + p.of[m];\n"
           "            v[e] = log_of(v[e], p.log_mode, p.log_offset);\n",
           "the halo log-mel applies the affine before the log"),
    "L4": (f"{CSRC}/log_mel.cu", "const int s = r * hop + j + e - half;",
           "const int s = r * (hop + 1) + j + e - half;",
           "the v1 log-mel's framing pass steps hop + 1 samples a frame"),
    "S1": (f"{CSRC}/distance.cu", "atomicAdd(cand_count + c, count);", "cand_count[c] = count;",
           "the PRDC statistics store each tile's count instead of adding it"),
    "S2": (f"{CSRC}/distance.cu", "c < c_end && r < n_ref", "c <= c_end && r < n_ref",
           "the PRDC statistics' column mask takes the column at the split's end"),
    "A1": (f"{CSRC}/window_attn.cuh",
           "const float* tab = bm + ((long long)(g % nbm) * heads + h) * N * N;",
           "const float* tab = bm + ((long long)0 * heads + h) * N * N;",
           "the f32 window attention reads window 0's table everywhere: the shift mask "
           "is dropped"),
    "G1": ("audio_metrics_tpu_torch/ops/merge.py",
           "origin.append(((q >> 1) * c + c0, 0, q & 1, 0))",
           "origin.append(((q & 1) * c + c0, 0, q >> 1, 0))",
           "the merges' A map swaps quadrants x10 and x01 (both dtypes read it)"),
    "Q1": (f"{CSRC}/gemm_tf32x3_sm90.cuh", "return a * rs - rs * mu * p.csum[n] + bias;",
           "return a * rs + bias;",
           "the f32 qkv epilogue drops the LN1 fold's rs * mu * csum term"),
    "T1": (f"{CSRC}/gemm_tf32x3_sm90.cuh",
           "      wgmma_bn<BN>(tmp, smem_desc(a_lo + kk * 32), smem_desc(b_hi + kk * 32), kk > 0);\n"
           "      wgmma_bn<BN>(tmp, smem_desc(a_hi + kk * 32), smem_desc(b_lo + kk * 32), 1);\n",
           "      wgmma_bn<BN>(tmp, smem_desc(a_hi + kk * 32), smem_desc(b_lo + kk * 32), kk > 0);\n",
           "the 3xTF32 core drops the A_lo . B_hi product"),
    "X1": (f"{CSRC}/gemm_tf32x3_sm90.cuh",
           "        sm90::mbar_wait(epi_full, j & 1);  // the consumers staged tile j\n", "",
           "the f32 MLP's epilogue warps drop the ordered handoff from the consumer "
           "warpgroups: they read the staging tile before it holds the tile"),
    "X2": (f"{CSRC}/gemm_tf32x3_sm90.cuh",
           "    rs_stage_acc<BN>(acc, c, staging);",
           "    if (wg != 0 || j + 1 < count || count % 2 == 0 || count == 1)\n"
           "      rs_stage_acc<BN>(acc, c, staging);",
           "the f32 MLP's consumer 0 skips staging a block's last tile where the block holds an "
           "odd number of tiles above 1"),
    "W1": (f"{CSRC}/window_attn.cuh",
           "mma_tf32x3(t[n], ph, pl, vh, vl);",
           "mma_tf32(t[n], ph, vl);\n        mma_tf32(t[n], ph, vh);",
           "the f32 window attention's P.V drops the A_lo . B_hi product"),
    "N1": (f"{CSRC}/swin_block.cu",
           "const float4 b = *reinterpret_cast<const float4*>(ln_b + k);",
           "const float4 b = make_float4(0.f, 0.f, 0.f, 0.f);",
           "the f32 LN1 window pass of the v1 and v2 halves drops the LN1 bias"),
    "R1": (f"{CSRC}/gemm_sm90.cuh",
           "load8(static_cast<const T*>(p.res) + o, x);",
           "load8(static_cast<const bf16*>(p.res) + o, x);",
           "the f32 int8 MLP's fc2 epilogue reads its f32 residual as bf16"),
    "P1": (f"{CSRC}/gemm_sm90.cuh",
           "else store8(static_cast<bf16*>(p.out) + o, v);",
           "else store8(static_cast<bf16*>(p.out) + (long long)r * p.ldo + n, v);",
           "the bf16 proj epilogue of the v3 half writes window-order row r, not its "
           "un-partitioned, un-rolled row"),
    "F1": (f"{CSRC}/gemm_sm90.cuh",
           "else load8(static_cast<const bf16*>(p.res) + o, x);",
           "else for (int i = 0; i < 8; ++i) x[i] = 0.f;",
           "the bf16 fc2 epilogue of the fused MLP drops the residual"),
    "N2": (f"{CSRC}/swin_block.cu", "sm90::load8(ln_b + k, b);",
           "for (int t = 0; t < 8; ++t) b[t] = 0.f;",
           "the bf16 LN1 window pass of the v1 and v2 halves drops the LN1 bias"),
    "I1": (f"{CSRC}/gemm_sm90.cuh", "__fmul_rn(a[i], __fmul_rn(rs, s[i]))",
           "__fmul_rn(a[i], s[i])",
           "the int8 MLP's fc1 epilogue drops the row scale sx (both dtypes)"),
    "Z1": (f"{CSRC}/merged_attn.cuh",
           "    const float2 b0 = *reinterpret_cast<const float2*>(t0 + 8 * j + 2 * tq);\n"
           "    const float2 b1 = *reinterpret_cast<const float2*>(t0 + 8 * N + 8 * j + 2 * tq);\n",
           "    const bool own = j / 8 == row / 64;  // the query's own 64-key tile\n"
           "    const float2 b0 = own ? *reinterpret_cast<const float2*>(t0 + 8 * j + 2 * tq)\n"
           "                          : make_float2(0.f, 0.f);\n"
           "    const float2 b1 = own ? *reinterpret_cast<const float2*>(t0 + 8 * N + 8 * j + "
           "2 * tq)\n"
           "                          : make_float2(0.f, 0.f);\n",
           "the merged attention (both dtypes) drops the table's entries of the keys outside the "
           "query's own 64-key tile: it reads the table as if it were block-diagonal"),
    "Z2": (f"{CSRC}/merged_attn.cuh",
           "*reinterpret_cast<const uint4*>(src + (long long)(QT * qt + i) * 3 * C + j)",
           "*reinterpret_cast<const uint4*>(src + (long long)(QT * ((qt + 1) % (N / QT)) + i) * "
           "3 * C + j)",
           "the bf16 merged attention loads the next 64-query tile's rows of q"),
    "V1": ("audio_metrics_tpu_torch/models/vggish.py",
           "x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)", "x = x.reshape(x.shape[0], -1)",
           "VGGish flattens its last feature map NCHW, not NHWC as torchvggish"),
    "H1": ("audio_metrics_tpu_torch/parallel/pipeline.py",
           "hop_len = win_len if hop_dur is None else window_length(in_sr, hop_dur)",
           "hop_len = win_len", "the pipeline ignores hop_dur"),
    "P2": ("audio_metrics_tpu_torch/audio_metrics.py",
           '        snapshot["stem_projection"] = copy.deepcopy(self.stem_projection)\n', "",
           "precompile leaves the projection refitted on its synthetic audio"),
    "D1": ("audio_metrics_tpu_torch/parallel/pipeline.py", "out[p] = np.roll(p, -s)",
           "out = rng.permutation(n)",
           "the misaligned pairing is a plain permutation, not the derangement"),
    "U1": ("audio_metrics_tpu_torch/ops/loudness.py",
           "torch.maximum(torch.einsum(\"c,bc->b\", gains, z_abs), floor)) - 10.0",
           "torch.maximum(torch.einsum(\"c,bc->b\", gains, z_abs), floor))",
           "the BS.1770 relative gate drops its -10 LU"),
    "K1": ("audio_metrics_tpu_torch/ops/limiter.py", "lag = delay - 1", "lag = delay",
           "the limiter's delay is one sample too long"),
    "A2": ("audio_metrics_tpu_torch/metrics/apa.py",
           "    if abs(numerator) > denominator:\n        denominator = abs(numerator)\n", "",
           "APA's denominator is d(x, x') alone, not max(d(x, x'), |numerator|)"),
    "F2": ("audio_metrics_tpu_torch/metrics/fad.py",
           "np.polyfit(1.0 / sizes.astype(np.float64), fads, 1)",
           "np.polyfit(sizes.astype(np.float64), fads, 1)",
           "FAD-inf fits FAD against the subset size, not its inverse"),
    "S3": ("audio_metrics_tpu_torch/parallel/shuffle.py",
           "protected = min(min_age, len(held) - 1)", "protected = min(min_age - 1, len(held) - 1)",
           "the window shuffle protects one insertion fewer than min_age"),
    "W2": ("audio_metrics_tpu_torch/utils/wavio.py",
           'struct.pack("<I", len(riff)) + riff)', 'struct.pack("<I", 4 + len(riff)) + riff)',
           "the WAV writer's RIFF size is 4 bytes too large, as the JAX copy's"),
    "S4": ("audio_metrics_tpu_torch/parallel/pipeline.py",
           "        lo, hi = blocks[i]\n        w = windows[lo:hi]",
           "        lo, hi = blocks[i][0] + (i == 1), blocks[i][1] + (i == 1)\n"
           "        w = windows[lo:hi]",
           "the second shard's block of windows starts one window late"),
    "S5": ("audio_metrics_tpu_torch/metrics/prdc.py",
           "torch.stack([p[1] for p in out]).sum(dim=0, dtype=torch.int32)",
           "torch.stack([p[1] for p in out]).amax(dim=0)",
           "PRDC's candidate counts are the largest of the shards', not their sum"),
    "S6": ("audio_metrics_tpu_torch/metrics/kd.py",
           "tuple(t.to(mesh.home) for t in r) for r in out if r is not None]",
           "tuple(t.to(mesh.home) for t in r) for r in out[:1] + out if r is not None]",
           "KD keeps the first shard's subsets twice"),
    "C1": ("audio_metrics_tpu_torch/models/clap.py",
           "out[i] = audio[i, start : start + max_len]",
           "out[i] = audio[i, start + 1 : start + 1 + max_len]",
           "LaionCLAP.forward's rand_trunc crop starts one sample after its drawn offset"),
    "M1": ("audio_metrics_tpu_torch/data.py",
           "        self._flush()\n        return self._mean\n", "        return self._mean\n",
           "AudioMetricsData.mean is read without merging the pending device moments"),
    "M2": ("audio_metrics_tpu_torch/data.py",
           "        if self.n is None:\n            self.store_embeddings = other.store_embeddings\n",
           "", "an empty AudioMetricsData keeps its own flag in +=, not the one of the set added"),
    "F3": ("audio_metrics_tpu_torch/metrics/fad.py",
           "_ns_trace_sqrt_sym(0.5 * (m + m.T), NS_METHOD_ITERS)",
           "_ns_trace_sqrt_sym(0.5 * (m + m.T))",
           "FAD's newton_schulz method iterates AM_TPU_FAD_NS_ITERS times, not a fixed 30"),
}
# faults in Python code that the CPU tests run: tests/test_torch_faults.py
# plants each in a module loaded beside the real one and runs the first
# check of it there; the smoke's phases 12-13 (15 for the APA path, 16 for
# FAD-inf, 17 for the mesh, 18 for the public surface) would catch most of them too, after every kernel
# phase, so they run here only when named
CPU_FAULTS = ("V1", "H1", "P2", "D1", "U1", "K1", "A2", "F2", "S3", "W2", "S4", "S5", "S6",
              "C1", "M1", "M2", "F3")
SKIP = ("build", ".git", "__pycache__", ".pytest_cache")


def plant(name: str, dest: Path) -> None:
    """A copy of the checkout at ``dest`` with fault ``name`` planted."""
    path, text, repl, _ = FAULTS[name]
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(ROOT, dest, ignore=shutil.ignore_patterns(*SKIP))
    src = (dest / path).read_text()
    if src.count(text) != 1:
        raise RuntimeError(f"fault {name}: {text!r} occurs {src.count(text)} times in {path}")
    (dest / path).write_text(src.replace(text, repl))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=[n for n in FAULTS if n not in CPU_FAULTS])
    ap.add_argument("--timeout", type=int, default=420)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plant_faults: CUDA is not available", file=sys.stderr)
        return 1
    results = {}
    for name in args.names:
        dest = ROOT / "audio_metrics_tpu_torch/kernels/build/faults" / name
        plant(name, dest)
        print(f"fault {name}: {FAULTS[name][3]}", flush=True)
        try:
            run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=dest, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 timeout=args.timeout)
            rc, out = run.returncode, run.stdout
        except subprocess.TimeoutExpired as e:
            rc = "timeout"
            out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        lines = out.splitlines()
        for line in lines:
            if "FAIL" in line or "DIFFERS" in line or "Error" in line:
                print(f"  {line.strip()[:400]}")
        print(f"  exit {rc}; last line: {lines[-1][:400] if lines else ''}", flush=True)
        results[name] = {"rc": rc, "caught": rc != 0}
        shutil.rmtree(dest)
    print(json.dumps({"faults": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
