"""The Swin block's MLP half: the kernel wrappers, their plain versions and
the XLA form.

Counterpart of ``audio_metrics_tpu/ops/mlp.py``: ``mlp_block`` has the
contract of ``mlp_block_pallas`` (:278-305, kernel ``_mlp_kernel`` :119)
with exact-erf GELU (the JAX kernel's ``gelu="exact"``; the port does not
carry the polynomial GELU, ROADMAP.md), and launches
kernels/csrc/swin_block.cu::am_swin_mlp (the whole block's launches 5-7 on
the wgmma core); ``mlp_xla`` is the XLA MLP of
``models/htsat.py::_swin_block`` (:622-631), the JAX package's own
non-kernel path, which runs on both devices and is not the plain version of
any kernel.  Weights: ``w1`` (C, 4C), ``w2`` (4C, C) input-major in the
activation dtype; LN affine and biases f32.

``mlp_block_int8`` has the contract of ``mlp_block_pallas_int8`` (:249-275,
kernel ``_mlp_kernel_int8`` :166), the W8A8 MLP: ``w1`` and ``w2`` given in
f32 and quantised per output column by :func:`quantize_columns` (the JAX
wrapper's XLA prep, :216-223), the activations per row inside the kernel
(kernels/csrc/mlp_int8.cu::am_swin_mlp_int8, both products int8 ``wgmma``
on kernels/csrc/gemm_sm90.cuh's TMA ring).  The kernel reads the weights'
codes transposed to (N, K) and their scales, :func:`mlp_int8_operands`: a
caller makes them once when the weights load and passes them as
``operands=``; without them a call on the card makes them itself, every
call.  A public op that no model path calls, in the JAX package as here.
Exact-erf GELU (the JAX kernel's A&S 7.1.26 erf is within 1.5e-7 of it).

Dispatch of ``mlp_block`` and ``mlp_block_int8``: a CPU tensor runs the
``*_plain`` version; a CUDA tensor launches the kernel for its dtype or
raises.  Both take the activation dtype, as their JAX kernels do: bf16
launches ``am_swin_mlp`` / ``am_swin_mlp_int8``, f32 ``am_swin_mlp_f32``
(the f32 block's launches 5-7, its products as three TF32 products on the
tensor cores) / ``am_swin_mlp_int8_f32``; each dtype has its own launch
count.  ``am_swin_mlp`` and ``am_swin_mlp_f32`` read ``w1`` and ``w2`` as
:func:`mlp_operands` gives them, made at load: transposed (bf16) or as
their transposes' (2, N, K) TF32 split stacks (f32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import KERNELS, check_s8_gemm, require_cuda
from .tf32 import k_major, k_major_operand

__all__ = [
    "layer_norm",
    "mlp_block",
    "mlp_operands",
    "mlp_block_plain",
    "mlp_block_int8",
    "mlp_block_int8_plain",
    "mlp_int8_operands",
    "mlp_xla",
    "quantize_columns",
]

KERNEL = KERNELS["swin_mlp"]
KERNEL_F32 = KERNELS["swin_mlp_f32"]
KERNEL_INT8 = KERNELS["swin_mlp_int8"]
KERNEL_INT8_F32 = KERNELS["swin_mlp_int8_f32"]
# f32 constants of the int8 kernel, as jnp.float32 gives them
_INV127 = float(np.float32(1.0 / 127.0))
_AMAX_FLOOR = float(np.float32(1e-12))
_SQRT1_2 = float(np.float32(0.7071067811865476))


def layer_norm(x, w, b, eps):
    """LayerNorm with f32 statistics regardless of activation dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _mm(a, b):
    """Product of ``a`` and ``b`` as rounded, accumulated in f32: what the
    kernels' products compute (the tests replace it by the f32 kernel's
    3xTF32 product, ``testing.tf32x3_matmul``)."""
    return torch.matmul(a.float(), b.float())


def mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5):
    """x (..., C) -> same dtype.  Rounds where the kernel rounds: the LN
    output and the GELU output go to the activation dtype; products
    accumulate in f32; the residual is the input as given."""
    dt = x.dtype
    h1 = F.gelu(_mm(layer_norm(x, ln_w, ln_b, eps), w1) + b1, approximate="none").to(dt)
    return (_mm(h1, w2) + b2 + x.float()).to(dt)


_MADE_BY = "mlp_operands(w1, w2)"


def mlp_operands(w1, w2) -> dict:
    """What the MLP kernel reads besides the plain version's operands, made
    once when the weights load (``models.htsat.SwinBlock``): ``w1`` (C, 4C)
    and ``w2`` (4C, C) in the K-major form of their dtype
    (``ops.tf32.k_major``): bf16 transposed to (N, K), f32 that matrix
    split into its TF32 hi and lo parts, a (2, N, K) stack."""
    return dict(w1_t=k_major(w1), w2_t=k_major(w2))


def _mlp_shape(name, x, w1_shape, w2_shape):
    c = x.shape[-1]
    if c % 64 or w1_shape != (c, 4 * c) or w2_shape != (4 * c, c):
        raise NotImplementedError(
            f"{name} kernel takes C % 64 == 0 and a 4C hidden width, got x "
            f"{tuple(x.shape)} w1 {tuple(w1_shape)} w2 {tuple(w2_shape)}"
        )
    return x.numel() // c, c


def _mlp_matrices(kernel, operands, c, dtype):
    """``w1_t`` (4C, C) and ``w2_t`` (C, 4C) of :func:`mlp_operands`, checked
    by :func:`ops.tf32.k_major_operand`."""
    return (k_major_operand(kernel, operands, "w1_t", 4 * c, c, _MADE_BY, dtype),
            k_major_operand(kernel, operands, "w2_t", c, 4 * c, _MADE_BY, dtype))


def _mlp_block_f32_cuda(x, ln_w, ln_b, w1, b1, w2, b2, *, eps, operands):
    m, c = _mlp_shape("swin_mlp_f32", x, w1.shape, w2.shape)
    w1_t, w2_t = _mlp_matrices("swin_mlp_f32", operands, c, torch.float32)
    require_cuda(x, ln_w, ln_b, w1_t, b1, w2_t, b2, dtype=torch.float32)
    hbuf = torch.empty((m, c), dtype=torch.float32, device=x.device)
    h1 = torch.empty((m, 4 * c), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    KERNEL_F32.launch("am_swin_mlp_f32", x, ln_w, ln_b, w1_t, b1, w2_t, b2, m, c, float(eps),
                      hbuf, h1, out)
    KERNEL_F32.launches += 1
    return out


def _mlp_block_cuda(x, ln_w, ln_b, w1, b1, w2, b2, *, eps, operands):
    m, c = _mlp_shape("swin_mlp", x, w1.shape, w2.shape)
    w1_t, w2_t = _mlp_matrices("swin_mlp", operands, c, x.dtype)
    require_cuda(x, w1_t, w2_t)
    require_cuda(ln_w, ln_b, b1, b2, dtype=torch.float32)
    hbuf = torch.empty((m, c), dtype=x.dtype, device=x.device)
    h1 = torch.empty((m, 4 * c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    KERNEL.launch("am_swin_mlp", x, ln_w, ln_b, w1_t, b1, w2_t, b2, m, c, float(eps), hbuf, h1,
                  out)
    KERNEL.launches += 1
    return out


def mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5, operands=None):
    """x + fc2(GELU(fc1(LN(x)))) over the last axis.  ``operands``: the
    kernel's :func:`mlp_operands` of these weights (or a whole block's
    ``swin_block_operands``, which hold the same ``w1_t``, ``w2_t``), made
    at load; a CUDA tensor needs them, a CPU tensor ignores them."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps=eps)
    if x.dtype == torch.float32:
        return _mlp_block_f32_cuda(x, ln_w, ln_b, w1, b1, w2, b2, eps=eps, operands=operands)
    return _mlp_block_cuda(x, ln_w, ln_b, w1, b1, w2, b2, eps=eps, operands=operands)


# ----------------------------------------------------------------------
# #12 W8A8 int8 MLP
# ----------------------------------------------------------------------
def _codes(v, dim: int):
    """Symmetric int8 codes of f32 ``v`` along ``dim`` and their scales:
    s = max(max |v|, 1e-12) * f32(1/127), q = round(v / s), half to even."""
    s = torch.clamp(v.abs().amax(dim=dim, keepdim=True), min=_AMAX_FLOOR) * _INV127
    return torch.round(v / s), s


def quantize_columns(w):
    """(K, N) weight -> int8 codes (K, N) and f32 scales (1, N), one scale
    per output column (audio_metrics_tpu/ops/mlp.py:216-223)."""
    q, s = _codes(w.float(), 0)
    return q.to(torch.int8), s


def _int_product(q, w_q):
    """Codes @ codes in float64, which is exact here (|sum| <= 127^2 * K <
    2^53; f32 is not above 2^24, and the card's matmul has no int32 form),
    then to f32 as the kernel converts its int32 sums."""
    return torch.matmul(q.double(), w_q.double()).float()


def mlp_block_int8_plain(x, ln_w, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5):
    """x (..., C) f32 or bf16 -> same dtype: LN in f32, per-row int8 codes
    of the LN output and of the GELU output, per-column codes of the
    weights, integer products, each dequantised with (row scale * column
    scale), bias, exact-erf GELU, the f32 residual, one rounding to the
    activation dtype at the end."""
    q1, s1 = quantize_columns(w1)
    q2, s2 = quantize_columns(w2)
    xf = x.float()
    qx, sx = _codes(layer_norm(xf, ln_w, ln_b, eps), -1)
    y = _int_product(qx, q1) * (sx * s1) + b1
    y = y * 0.5 * (1 + torch.erf(y * _SQRT1_2))
    qy, sy = _codes(y, -1)
    return (_int_product(qy, q2) * (sy * s2) + b2 + xf).to(x.dtype)


def mlp_int8_operands(w1, w2) -> dict:
    """What the int8 MLP kernel reads of ``w1`` (C, 4C) and ``w2`` (4C, C),
    f32, made once when the weights load: their :func:`quantize_columns`
    codes transposed to (N, K) int8, ``q1t`` (4C, C) and ``q2t`` (C, 4C),
    as the int8 wgmma core reads both operands K-major, and their column
    scales ``s1`` (1, 4C) and ``s2`` (1, C) f32."""
    q1, s1 = quantize_columns(w1)
    q2, s2 = quantize_columns(w2)
    return dict(q1t=q1.t().contiguous(), s1=s1, q2t=q2.t().contiguous(), s2=s2)


def _int8_matrices(kernel, operands, x):
    """The four tensors of :func:`mlp_int8_operands` for ``x``'s width C,
    each checked for its dtype, shape ((4C, C), (1, 4C), (C, 4C), (1, C))
    and device; ``ValueError`` names the first that differs."""
    c = x.shape[-1]
    want = {"q1t": (torch.int8, (4 * c, c)), "s1": (torch.float32, (1, 4 * c)),
            "q2t": (torch.int8, (c, 4 * c)), "s2": (torch.float32, (1, c))}
    for name, (dtype, shape) in want.items():
        t = operands[name]
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"{kernel} reads {name} of mlp_int8_operands(w1, w2) as {dtype} {shape} on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return [operands[name] for name in want]


def check_int8_gemms(kernel: str, c: int) -> None:
    """Raise ``NotImplementedError`` unless the int8 wgmma core takes the
    MLP's two products at width ``c`` (``kernels.check_s8_gemm``): fc1, N =
    4C over K = C, and fc2, N = C over K = 4C."""
    check_s8_gemm(f"{kernel} fc1", 4 * c, c, c)
    check_s8_gemm(f"{kernel} fc2", c, 4 * c, 4 * c)


def _mlp_block_int8_cuda(x, ln_w, ln_b, w1, b1, w2, b2, *, eps, operands):
    f32 = x.dtype == torch.float32
    kernel = KERNEL_INT8_F32 if f32 else KERNEL_INT8
    require_cuda(x, dtype=torch.float32 if f32 else torch.bfloat16)
    m, c = _mlp_shape(kernel.name, x, w1.shape, w2.shape)
    check_int8_gemms(kernel.name, c)
    q1t, s1, q2t, s2 = _int8_matrices(
        kernel.name, mlp_int8_operands(w1, w2) if operands is None else operands, x)
    require_cuda(ln_w, ln_b, w1, b1, w2, b2, s1, s2, dtype=torch.float32)
    require_cuda(q1t, q2t, dtype=torch.int8)
    dev = x.device
    qx = torch.empty((m, c), dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=torch.float32, device=dev)
    hid = torch.empty((m, 4 * c), dtype=torch.float32, device=dev)
    amax = torch.empty(m, dtype=torch.int32, device=dev)
    qy = torch.empty((m, 4 * c), dtype=torch.int8, device=dev)
    out = torch.empty_like(x)
    kernel.launch("am_swin_mlp_int8_f32" if f32 else "am_swin_mlp_int8", x, ln_w, ln_b, q1t, s1,
                  b1, q2t, s2, b2, m, c, float(eps), qx, sx, hid, amax, qy, out)
    kernel.launches += 1
    return out


def mlp_block_int8(x, ln_w, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5, operands=None):
    """x + fc2(GELU(fc1(LN(x)))) over the last axis with W8A8 int8
    products; ``x`` bf16 or f32, ``w1`` (C, 4C) and ``w2`` (4C, C) f32.
    ``operands``: :func:`mlp_int8_operands` of these weights, made at load;
    checked on either device (``ValueError`` for another shape, dtype or
    device), read by the kernel on the card, where a call without them
    makes them.  A CPU tensor runs the plain version, which quantises the
    weights itself."""
    if x.device.type == "cpu":
        if operands is not None:
            _int8_matrices("swin_mlp_int8", operands, x)
        return mlp_block_int8_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps=eps)
    return _mlp_block_int8_cuda(x, ln_w, ln_b, w1, b1, w2, b2, eps=eps, operands=operands)


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
