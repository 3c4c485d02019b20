"""Swin patch merge with the LayerNorm folded in: wrapper and plain version.

Counterpart of ``audio_metrics_tpu/ops/merge.py::patch_merge_pallas``
(:113-150).  ``wg`` (4, C, OC) holds the LN-folded weight blocks in
[x00, x10, x01, x11] order (x_yx: y = row offset, x = column offset),
``svec`` = g @ W and ``tvec`` = b @ W (models/htsat._merge_weights).

Dispatch: a CPU tensor runs :func:`patch_merge_plain`; a CUDA tensor
launches the hand-written kernel for its dtype (kernels/csrc/patch_merge.cu:
``am_patch_merge`` for bf16 on the wgmma core, ``am_patch_merge_f32`` for
f32 on the 3xTF32 wgmma core, with its own launch count,
``KERNELS["patch_merge_f32"]``), which reads the weight K-major, ``wg_t =
merge_weight_t(wg)`` made once at load (``models.htsat.PatchMerge``; in f32
split into its TF32 hi and lo parts), or raises.  Both read A, the
quadrant concat, through one 4-D tensor map (:func:`merge_a_map`).
"""

from __future__ import annotations

import functools

import torch

from ..kernels import KERNELS, check_sm90_gemm, check_tf32x3_gemm, require_cuda
from .tf32 import tf32_split

__all__ = [
    "check_merge_f32",
    "check_merge_gemm",
    "merge_a_map",
    "merge_stats",
    "merge_weight_t",
    "patch_merge",
    "patch_merge_plain",
]

KERNEL = KERNELS["patch_merge"]
KERNEL_F32 = KERNELS["patch_merge_f32"]
BM, BK = 128, 64  # the wgmma core's row tile and K step (kernels/csrc/gemm_sm90.cuh)
BK_F32 = 32  # the 3xTF32 core's K step, 128 bytes of f32 (kernels/csrc/gemm_tf32x3_sm90.cuh)
MERGE_STEPS_MAX = 64  # K steps the kernel's table holds (kernels/csrc/patch_merge.cu)


def merge_stats(x, *, h: int, w: int, eps: float):
    """Mean and 1/sigma (f32, (B*(H/2)*(W/2),)) of each output row's 4C
    concat [x00, x10, x01, x11]: the centered two-pass LN statistics of
    the JAX kernel (its merge.py:69-80), which the card's
    ``merge_stats_kernel`` computes once per row."""
    qf = _quadrants(x, h, w).float()
    mu = qf.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt((qf - mu).square().mean(dim=-1, keepdim=True) + eps)
    return mu.reshape(-1), rs.reshape(-1)


def _quadrants(x, h, w):
    """(B, H*W, C) -> (B, H/2, W/2, 4C), the quadrant concat."""
    b, _, c = x.shape
    x4 = x.reshape(b, h, w, c)
    return torch.cat((x4[:, 0::2, 0::2], x4[:, 1::2, 0::2], x4[:, 0::2, 1::2],
                      x4[:, 1::2, 1::2]), dim=-1)


def _mm(a, b):
    """Product of ``a`` and ``b`` as rounded (bf16 or f32), accumulated in
    f32."""
    return torch.matmul(a.float(), b.float())


def patch_merge_plain(x, wg, svec, tvec, *, h: int, w: int, eps: float, wg_t=None):
    """x (B, H*W, C) -> (B, (H/2)*(W/2), OC): centered two-pass f32
    statistics of the virtual 4C concat row, the reduction on the raw
    quadrants with f32 accumulation, LN applied afterwards.  ``wg_t`` is
    the kernel's and is not read here."""
    b, _, c = x.shape
    mu, rs = merge_stats(x, h=h, w=w, eps=eps)
    raw = _mm(_quadrants(x, h, w).reshape(-1, 4 * c), wg.reshape(4 * c, -1))
    out = raw * rs[:, None] + (tvec - mu[:, None] * rs[:, None] * svec)
    return out.reshape(b, (h // 2) * (w // 2), -1).to(x.dtype)


def merge_weight_t(wg: torch.Tensor) -> torch.Tensor:
    """``wg`` (4, C, OC) as the kernel reads it, made once at load: (OC,
    4C), K-major (the layout of both operands of the wgmma cores); in f32
    that matrix's TF32 hi over lo parts, (2, OC, 4C) (``ops.tf32.
    tf32_split``), what the 3xTF32 core reads."""
    w = wg.reshape(-1, wg.shape[-1]).t()
    return tf32_split(w) if wg.dtype == torch.float32 else w.contiguous()


def check_merge_gemm(r: int, c: int) -> None:
    """Raise ``NotImplementedError`` unless the kernel takes a merge of an
    R x R image of C channels: a 128-row tile of its product must hold whole
    rows of the (R/2)^2 output grid (R/2 divides 128), each K step of 64
    must lie in one quadrant (C % 64 == 0), the kernel's table holds at most
    MERGE_STEPS_MAX K steps (C <= 1024), and the wgmma core must take
    N = 2C, K = 4C and the map's strides (``kernels.check_sm90_gemm``)."""
    if r < 2 or r % 2 or BM % (r // 2):
        raise NotImplementedError(f"patch_merge: R/2 must divide {BM}, got R={r}")
    if c % BK or 4 * c // BK > MERGE_STEPS_MAX:
        raise NotImplementedError(f"patch_merge: C must be a multiple of {BK} and at most "
                                  f"{MERGE_STEPS_MAX * BK // 4}, got C={c}")
    check_sm90_gemm("patch_merge", 2 * c, 4 * c, *merge_a_map(1, r, c)["strides"])


@functools.lru_cache(maxsize=None)
def merge_a_map(b: int, r: int, c: int, bk: int = BK) -> dict:
    """The 4-D TMA map through which the kernel reads A, the quadrant concat
    (B*(R/2)^2, 4C), from the unmerged tokens x (B, R*R, C), and where each
    load of it lies: dims and box innermost first, strides (of dims 1-3) in
    elements, ``origin`` the box coordinates of each K step of ``bk`` (64
    bf16 or 32 f32: 128 bytes either way) in row tile 0 (tile t adds t boxes
    to the outermost).  The kernel reads these numbers and computes none of
    them.  Cached: read it, do not change it.  As rows of 2C (a horizontal
    pixel pair), quadrant (dy, dx) of output row (b, i2, j2) is row (b*R/2 +
    i2, dy, j2) at columns dx*C .. dx*C + C - 1; K step s reads quadrant q =
    bk*s // C of [x00, x10, x01, x11], (dy, dx) = (q & 1, q >> 1)."""
    h2 = r // 2
    origin = []
    for step in range(4 * c // bk):
        q, c0 = divmod(step * bk, c)
        origin.append(((q >> 1) * c + c0, 0, q & 1, 0))
    return dict(dims=(2 * c, h2, 2, b * h2), strides=(2 * c, r * c, 2 * r * c),
                box=(bk, h2, 1, BM // h2), origin=tuple(origin))


@functools.lru_cache(maxsize=None)
def _map_args(b: int, r: int, c: int, bk: int = BK) -> tuple:
    """``am_patch_merge``'s (``bk`` 64) or ``am_patch_merge_f32``'s (32) map
    arguments: dims, strides, box, then the origin table as a host int32
    tensor (made once per shape: a merge's kernels take ~0.05 ms, and
    rebuilding the table cost up to a third of that on the host)."""
    amap = merge_a_map(b, r, c, bk)
    return (*amap["dims"], *amap["strides"], *amap["box"],
            torch.tensor(amap["origin"], dtype=torch.int32))


def check_merge_f32(r: int, c: int) -> None:
    """Raise ``NotImplementedError`` unless the f32 kernel takes a merge of
    an R x R image of C channels: a 128-row tile holds whole rows of the
    (R/2)^2 output grid (R/2 divides 128), each K step of 32 lies in one
    quadrant (C % 32 == 0), the kernel's table holds at most
    MERGE_STEPS_MAX K steps (C <= 512), and the 3xTF32 core takes N = 2C,
    K = 4C and the map's strides (``kernels.check_tf32x3_gemm``)."""
    if r < 2 or r % 2 or BM % (r // 2):
        raise NotImplementedError(f"patch_merge f32: R/2 must divide {BM}, got R={r}")
    if c % BK_F32 or 4 * c // BK_F32 > MERGE_STEPS_MAX:
        raise NotImplementedError(f"patch_merge f32: C must be a multiple of {BK_F32} and at "
                                  f"most {MERGE_STEPS_MAX * BK_F32 // 4}, got C={c}")
    check_tf32x3_gemm("patch_merge f32", 2 * c, 4 * c,
                      *merge_a_map(1, r, c, BK_F32)["strides"])


def _merge_operands(x, wg_t, h, w):
    b, n, c = x.shape
    if wg_t is None:
        raise ValueError("patch_merge on the card reads merge_weight_t(wg), made once at "
                         "weight load: pass it as wg_t=")
    oc = wg_t.shape[-2]
    want = (oc, 4 * c) if x.dtype != torch.float32 else (2, oc, 4 * c)
    if n != h * w or h != w or oc != 2 * c or wg_t.shape != want:
        raise NotImplementedError(f"patch_merge kernel shape x={tuple(x.shape)} "
                                  f"wg_t={tuple(wg_t.shape)}")
    return b, c, oc


def _patch_merge_f32_cuda(x, wg, svec, tvec, *, h, w, eps, wg_t):
    b, c, oc = _merge_operands(x, wg_t, h, w)
    require_cuda(x, wg_t, svec, tvec, dtype=torch.float32)
    check_merge_f32(h, c)
    m = b * (h // 2) ** 2
    stats = torch.empty((2, m), dtype=torch.float32, device=x.device)
    out = torch.empty((b, (h // 2) * (w // 2), oc), dtype=x.dtype, device=x.device)
    KERNEL_F32.launch("am_patch_merge_f32", x, wg_t, svec, tvec, b, h, c, float(eps), stats,
                      out, *_map_args(b, h, c, BK_F32))
    KERNEL_F32.count()
    return out


def _patch_merge_cuda(x, wg, svec, tvec, *, h, w, eps, wg_t):
    b, c, oc = _merge_operands(x, wg_t, h, w)
    require_cuda(x, wg_t)
    require_cuda(svec, tvec, dtype=torch.float32)
    check_merge_gemm(h, c)
    m = b * (h // 2) ** 2
    stats = torch.empty((2, m), dtype=torch.float32, device=x.device)
    out = torch.empty((b, (h // 2) * (w // 2), oc), dtype=x.dtype, device=x.device)
    KERNEL.launch("am_patch_merge", x, wg_t, svec, tvec, b, h, c, float(eps), stats, out,
                  *_map_args(b, h, c))
    KERNEL.count()
    return out


def patch_merge(x, wg, svec, tvec, *, h: int, w: int, eps: float, wg_t=None):
    """2x2 patch merge + folded LN, (B, H*W, C) -> (B, H*W/4, OC)."""
    if x.device.type == "cpu":
        fn = patch_merge_plain
    else:
        fn = _patch_merge_f32_cuda if x.dtype == torch.float32 else _patch_merge_cuda
    return fn(x, wg, svec, tvec, h=h, w=w, eps=eps, wg_t=wg_t)
