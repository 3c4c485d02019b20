"""Whole Swin block: the kernel wrapper and its plain PyTorch version.

Counterpart of ``audio_metrics_tpu/ops/attention.py::swin_block_pallas_v4``
(:1137-1193, kernel ``_swin_block_kernel_v4`` :951).  Weight layout as
there, after ``models.htsat._v3_kernel_weights``: ``wqkv`` (C, 3C) with the
LN1 affine and 1/sqrt(d) folded in, ``bq3`` (3C,), ``wp`` (C, C), ``bp``
(C,) absorbing the value bias, ``bm`` (nW or 1, heads, n, n) bias+mask,
``w1`` (C, 4C), ``w2`` (4C, C) input-major; vectors f32.

Dispatch: a CPU tensor runs :func:`swin_block_plain`; a CUDA tensor
launches the hand-written kernel (kernels/csrc/swin_block.cu) or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import KERNELS, require_cuda

__all__ = ["swin_block", "swin_block_plain"]

KERNEL = KERNELS["swin_block"]


def _mm(a, b):
    """Product of ``a`` and ``b`` as rounded (bf16 or f32), accumulated in
    f32 — what the kernel's tensor-core products compute."""
    return torch.matmul(a.float(), b.float())


def swin_block_plain(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2, *,
                     heads: int, window: int, shift: int, eps: float = 1e-5):
    """x (B, R, R, C) -> same dtype.  Rounds where the kernel rounds: qkv,
    probabilities, context, the LN2 output and the GELU output go to the
    activation dtype; the residual and every statistic stay f32.  Unlike
    the JAX XLA block (htsat.py:264-266) scores are not rounded."""
    b, h, w, c = x.shape
    dt = x.dtype
    n = window * window
    hb, wb = h // window, w // window
    g = b * hb * wb
    d = c // heads

    x4 = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2)) if shift else x
    xw = x4.reshape(b, hb, window, wb, window, c).permute(0, 1, 3, 2, 4, 5).reshape(g * n, c)
    xwf = xw.float()
    mu = xwf.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt((xwf - mu).square().mean(dim=-1, keepdim=True) + eps)
    csum = wqkv.float().sum(dim=0)
    y = (_mm(xw, wqkv) * rs - (rs * mu) * csum + bq3).to(dt)
    q, k, v = (
        y[:, i * c : (i + 1) * c].reshape(g, n, heads, d).transpose(1, 2) for i in range(3)
    )
    s = _mm(q, k.transpose(-1, -2))  # (g, heads, n, n) f32
    s = (s.reshape(b, -1, heads, n, n) + bm[None]).reshape(g, heads, n, n)
    p = torch.softmax(s, dim=-1).to(dt)
    ctx = _mm(p, v).to(dt).transpose(1, 2).reshape(g * n, c)
    ow = _mm(ctx, wp) + bp
    o4 = ow.reshape(b, hb, wb, window, window, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    if shift:
        o4 = torch.roll(o4, shifts=(shift, shift), dims=(1, 2))
    res = o4 + x.float()

    mu2 = res.mean(dim=-1, keepdim=True)
    var2 = (res - mu2).square().mean(dim=-1, keepdim=True)
    hn = ((res - mu2) * torch.rsqrt(var2 + eps) * ln2_w + ln2_b).to(dt)
    h1 = F.gelu(_mm(hn, w1) + b1, approximate="none").to(dt)
    return (res + _mm(h1, w2) + b2).to(dt)


def _swin_block_cuda(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2, *,
                     heads, window, shift, eps):
    b, r, r2, c = x.shape
    require_cuda(x, wqkv, wp, w1, w2)
    require_cuda(bq3, bp, bm, ln2_w, ln2_b, b1, b2, dtype=torch.float32)
    if r != r2 or r % window or window * window != 64 or c != 32 * heads or c % 64:
        raise NotImplementedError(
            f"swin_block kernel takes 8x8 windows of 32-wide heads, got R={r} "
            f"window={window} C={c} heads={heads}"
        )
    if bm.shape[1:] != (heads, 64, 64) or bm.shape[0] not in (1, (r // window) ** 2):
        raise ValueError(f"bias/mask table shape {tuple(bm.shape)}")
    m = b * r * r
    qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=x.device)
    ctx = torch.empty((m, c), dtype=x.dtype, device=x.device)
    res = torch.empty((m, c), dtype=torch.float32, device=x.device)
    hbuf = torch.empty((m, c), dtype=x.dtype, device=x.device)
    h1 = torch.empty((m, 4 * c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    KERNEL.launch(
        "am_swin_block", x, wqkv, bq3, wp, bp, bm, bm.shape[0], ln2_w, ln2_b, w1, b1,
        w2, b2, b, r, c, heads, window, shift, float(eps), qkv, ctx, res, hbuf, h1, out,
    )
    KERNEL.launches += 1
    return out


def swin_block(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2, *,
               heads: int, window: int, shift: int, eps: float = 1e-5):
    """Whole Swin block, (B, R, R, C) -> (B, R, R, C)."""
    fn = swin_block_plain if x.device.type == "cpu" else _swin_block_cuda
    return fn(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2,
              heads=heads, window=window, shift=shift, eps=eps)
