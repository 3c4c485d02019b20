"""The f32 window attention alone on a card, at the main path's shapes.

    python -m audio_metrics_tpu_torch.profile_window_attn [--batch 64]

Launches ``window_attn_kernel<float>`` (kernels/csrc/window_attn.cuh, the
third launch of the f32 Swin block and of its f32 attention halves) through
the library's ``am_window_attn_f32`` entry on random qkv rows of each
HTSAT-base stage at ``--batch`` clips of 5 s, unshifted (one bias table) and
shifted (a bias/mask table per window of an image), and prints for each: the
kernel's time per launch (CUDA events over ``--iters`` launches, after a
warm-up), its bytes (qkv in and context out, the table once) and their rate
against the card's 3.35 TB/s, its bound (those bytes, or its operations as
three TF32 products at 495 TFLOP/s), and as a yardstick that the port never
calls, ``torch.nn.functional.scaled_dot_product_attention`` in f32 on the
same q, k, v with the table as its additive mask (scale 1: q is
pre-scaled), with the largest difference between the two outputs.  Then
the sums over one forward's 18 blocks.  Needs a card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

PEAK_BYTES, PEAK_TF32 = 3.35e12, 495e12  # H100 SXM data sheet, dense, 700 W


def _ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_window_attn: CUDA is not available", file=sys.stderr)
        return 1
    from . import kernels
    from .models.htsat import HTSAT_BASE as cfg
    from .testing import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = kernels.build()
    fn = lib.am_window_attn_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d = cfg.window_size**2, 32
    print(f"card: {card_line()}; torch {torch.__version__}; batch {args.batch}")
    total = {"ms": 0.0, "sdpa_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0}
    res = cfg.grid_size
    for stage, depth in enumerate(cfg.depths):
        c, heads = cfg.embed_dim * 2**stage, cfg.num_heads[stage]
        per_image = (res // cfg.window_size) ** 2
        windows = args.batch * per_image
        shifted = depth // 2 if res > cfg.window_size else 0
        qkv = torch.randn((windows * n, 3 * c), generator=gen, device="cuda") * d**-0.5
        ctx = torch.empty((windows * n, c), device="cuda")
        q, k, v = qkv.view(windows, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        for nbm, blocks in ((1, depth - shifted), (per_image, shifted)):
            if blocks == 0:
                continue
            bm = torch.randn((nbm, heads, n, n), generator=gen, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                rc = fn(qkv.data_ptr(), bm.data_ptr(), nbm, windows, heads, c, ctx.data_ptr(),
                        stream)
                if rc:
                    raise RuntimeError(f"am_window_attn_f32 failed with cudaError {rc}")

            mask = bm.repeat(args.batch, 1, 1, 1) if nbm > 1 else bm

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=1.0)

            ms, sdpa_ms = _ms(launch, args.iters), _ms(sdpa, args.iters)
            diff = (ctx.view(windows, n, heads, d).transpose(1, 2) - sdpa()).abs().max().item()
            n_bytes = (windows * n * 4 * c + nbm * heads * n * n) * 4
            ops = 4 * windows * heads * n * n * d
            bound_ms = max(n_bytes / PEAK_BYTES, 3 * ops / PEAK_TF32) * 1e3
            print(f"  stage {stage} R={res} C={c} heads {heads} windows {windows} tables {nbm}: "
                  f"kernel {ms:.4f} ms, {n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s "
                  f"({n_bytes / (ms * 1e-3) / PEAK_BYTES:.3f} of peak); bound {bound_ms:.4f} ms "
                  f"({'bytes' if n_bytes / PEAK_BYTES >= 3 * ops / PEAK_TF32 else 'operations'}); "
                  f"sdpa {sdpa_ms:.4f} ms, max |kernel - sdpa| {diff:.3g}; x{blocks} a forward")
            total["ms"] += blocks * ms
            total["sdpa_ms"] += blocks * sdpa_ms
            total["bound_ms"] += blocks * bound_ms
            total["bytes"] += blocks * n_bytes
        res //= 2
    print(f"per forward (18 blocks): kernel {total['ms']:.4f} ms, bound {total['bound_ms']:.4f} ms, "
          f"{total['bytes'] / (total['ms'] * 1e-3) / 1e12:.3f} TB/s; "
          f"sdpa {total['sdpa_ms']:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
