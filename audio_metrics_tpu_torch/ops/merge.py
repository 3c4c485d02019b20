"""Swin patch merge with the LayerNorm folded in: wrapper and plain version.

Counterpart of ``audio_metrics_tpu/ops/merge.py::patch_merge_pallas``
(:113-150).  ``wg`` (4, C, OC) holds the LN-folded weight blocks in
[x00, x10, x01, x11] order (x_yx: y = row offset, x = column offset),
``svec`` = g @ W and ``tvec`` = b @ W (models/htsat._merge_weights).

Dispatch: a CPU tensor runs :func:`patch_merge_plain`; a CUDA tensor
launches the hand-written kernel (kernels/csrc/patch_merge.cu) or raises.
"""

from __future__ import annotations

import torch

from ..kernels import KERNELS, require_cuda

__all__ = ["patch_merge", "patch_merge_plain"]

KERNEL = KERNELS["patch_merge"]


def patch_merge_plain(x, wg, svec, tvec, *, h: int, w: int, eps: float):
    """x (B, H*W, C) -> (B, (H/2)*(W/2), OC): centered two-pass f32
    statistics of the virtual 4C concat row, the reduction on the raw
    quadrants with f32 accumulation, LN applied afterwards."""
    b, n, c = x.shape
    x4 = x.reshape(b, h, w, c)
    quads = (x4[:, 0::2, 0::2], x4[:, 1::2, 0::2], x4[:, 0::2, 1::2], x4[:, 1::2, 1::2])
    qf = torch.cat([q.float() for q in quads], dim=-1)  # (b, h/2, w/2, 4c)
    mu = qf.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt((qf - mu).square().mean(dim=-1, keepdim=True) + eps)
    raw = torch.matmul(qf, wg.float().reshape(4 * c, -1))
    out = raw * rs + (tvec - mu * rs * svec)
    return out.reshape(b, (h // 2) * (w // 2), -1).to(x.dtype)


def _patch_merge_cuda(x, wg, svec, tvec, *, h, w, eps):
    b, n, c = x.shape
    require_cuda(x, wg)
    require_cuda(svec, tvec, dtype=torch.float32)
    oc = wg.shape[-1]
    if n != h * w or h != w or h % 2 or c % 32 or oc % 64 or wg.shape != (4, c, oc):
        raise NotImplementedError(f"patch_merge kernel shape x={tuple(x.shape)} wg={tuple(wg.shape)}")
    out = torch.empty((b, (h // 2) * (w // 2), oc), dtype=x.dtype, device=x.device)
    KERNEL.launch("am_patch_merge", x, wg, svec, tvec, b, h, c, float(eps), out)
    KERNEL.launches += 1
    return out


def patch_merge(x, wg, svec, tvec, *, h: int, w: int, eps: float):
    """2x2 patch merge + folded LN, (B, H*W, C) -> (B, H*W/4, OC)."""
    fn = patch_merge_plain if x.device.type == "cpu" else _patch_merge_cuda
    return fn(x, wg, svec, tvec, h=h, w=w, eps=eps)
