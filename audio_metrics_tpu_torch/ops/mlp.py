"""The Swin block's MLP half: the kernel wrapper, its plain version and the
XLA form.

Counterpart of ``audio_metrics_tpu/ops/mlp.py``: ``mlp_block`` has the
contract of ``mlp_block_pallas`` (:278-305, kernel ``_mlp_kernel`` :119)
with exact-erf GELU (the JAX kernel's ``gelu="exact"``; the port does not
carry the polynomial GELU, ROADMAP.md), and launches
kernels/csrc/swin_halves.cu::am_swin_mlp; ``mlp_xla`` is the XLA MLP of
``models/htsat.py::_swin_block`` (:622-631), the JAX package's own
non-kernel path, which runs on both devices and is not the plain version of
any kernel.  Weights: ``w1`` (C, 4C), ``w2`` (4C, C) input-major in the
activation dtype; LN affine and biases f32.

Dispatch of ``mlp_block``: a CPU tensor runs ``mlp_block_plain``; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import KERNELS, require_cuda

__all__ = ["layer_norm", "mlp_block", "mlp_block_plain", "mlp_xla"]

KERNEL = KERNELS["swin_mlp"]


def layer_norm(x, w, b, eps):
    """LayerNorm with f32 statistics regardless of activation dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5):
    """x (..., C) -> same dtype.  Rounds where the kernel rounds: the LN
    output and the GELU output go to the activation dtype; products
    accumulate in f32; the residual is the input as given."""
    dt = x.dtype
    h1 = F.gelu(torch.matmul(layer_norm(x, ln_w, ln_b, eps).float(), w1.float()) + b1,
                approximate="none").to(dt)
    return (torch.matmul(h1.float(), w2.float()) + b2 + x.float()).to(dt)


def _mlp_block_cuda(x, ln_w, ln_b, w1, b1, w2, b2, *, eps):
    c = x.shape[-1]
    require_cuda(x, w1, w2)
    require_cuda(ln_w, ln_b, b1, b2, dtype=torch.float32)
    if c % 64 or w1.shape != (c, 4 * c) or w2.shape != (4 * c, c):
        raise NotImplementedError(
            f"swin_mlp kernel takes C % 64 == 0 and a 4C hidden width, got x "
            f"{tuple(x.shape)} w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}"
        )
    m = x.numel() // c
    hbuf = torch.empty((m, c), dtype=x.dtype, device=x.device)
    h1 = torch.empty((m, 4 * c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    KERNEL.launch("am_swin_mlp", x, ln_w, ln_b, w1, b1, w2, b2, m, c, float(eps), hbuf, h1, out)
    KERNEL.launches += 1
    return out


def mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5):
    """x + fc2(GELU(fc1(LN(x)))) over the last axis."""
    fn = mlp_block_plain if x.device.type == "cpu" else _mlp_block_cuda
    return fn(x, ln_w, ln_b, w1, b1, w2, b2, eps=eps)


def mlp_xla(x, ln_w, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5):
    """The XLA MLP half, x + fc2(GELU(fc1(LN(x)))): every step rounds to the
    activation dtype as ``_linear`` and ``jax.nn.gelu`` do there (the
    products accumulate in f32), and the residual sum is taken in the
    activation dtype."""
    dt = x.dtype
    y = (torch.matmul(layer_norm(x, ln_w, ln_b, eps).float(), w1.float()) + b1).to(dt)
    y = F.gelu(y, approximate="none")
    y = (torch.matmul(y.float(), w2.float()) + b2).to(dt)
    return x + y
