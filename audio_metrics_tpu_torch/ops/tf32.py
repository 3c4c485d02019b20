"""TF32 rounding and the hi/lo split of the 3xTF32 products.

The f32 whole block and the f32 patch merge run their products on the
tensor cores as three TF32 products (kernels/csrc/gemm_tf32x3_sm90.cuh):
each f32 operand x is split into x_hi = rna(x) and x_lo = rna(x - x_hi),
where rna rounds to TF32 (10 mantissa bits) to nearest with ties away from
zero, the rounding of the card's ``cvt.rna.tf32.f32``.  x_hi + x_lo holds x
to ~2^-22 relative, and A @ B ~= A_lo @ B_hi + A_hi @ B_lo + A_hi @ B_hi.
The kernels split A themselves; a weight is split here, once at load
(``ops.attention.swin_block_operands``, ``half_operands``, ``v1_operands``,
``ops.mlp.mlp_operands``, ``ops.merge.merge_weight_t``), and an f32
kernel's wrapper takes it through :func:`k_major_operand`.  :func:`k_major`
gives a weight in the form the products of its dtype read.
"""

from __future__ import annotations

import torch

from ..kernels import check_sm90_gemm, check_tf32x3_gemm

__all__ = ["k_major", "k_major_operand", "tf32_round", "tf32_split"]

_LOW = 0x1000  # half a TF32 ulp: bit 12 of the f32 bits
_KEEP = -0x2000  # 0xFFFFE000 as an int32: clears the 13 low mantissa bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32, to nearest with ties away from zero: on
    the bits, (bits + 0x1000) & 0xFFFFE000 (the sign bit is untouched, so
    negatives round away from zero too; a carry moves into the exponent)."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes f32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    return ((bits + _LOW) & _KEEP).view(torch.float32)


def tf32_split(w: torch.Tensor) -> torch.Tensor:
    """f32 ``w`` (N, K) -> (2, N, K): its TF32 hi part over its lo part,
    hi = rna(w), lo = rna(w - hi), as the 3xTF32 kernels read a weight."""
    hi = tf32_round(w)
    return torch.stack([hi, tf32_round(w - hi)])


def k_major(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) weight as the wgmma cores read it, made once at load: bf16
    transposed to (N, K), K-major (``kernels/csrc/gemm_sm90.cuh``); f32 that
    (N, K) matrix's (2, N, K) :func:`tf32_split` stack (the 3xTF32 core)."""
    return tf32_split(w.t()) if w.dtype == torch.float32 else w.t().contiguous()


def k_major_operand(kernel: str, operands: dict | None, name: str, n: int, k: int,
                    made_by: str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``operands[name]``, the :func:`k_major` form of an (n, k) matrix that
    the ``dtype`` kernel ``kernel`` reads, made at load by ``made_by``: for
    f32 its (2, n, k) :func:`tf32_split` stack, for bf16 the (n, k) matrix.
    Raise ``ValueError`` when the operands are missing or the matrix has
    another shape, and ``NotImplementedError`` for any other dtype or unless
    the dtype's core takes an (n, k) product (``kernels.check_tf32x3_gemm``
    / ``check_sm90_gemm``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{kernel}: the CUDA kernels take bf16 or f32, got {dtype}")
    if operands is None:
        raise ValueError(f"{kernel} on the card reads {made_by}, made once at weight load: "
                         "pass them as operands=")
    t = operands[name]
    f32 = dtype == torch.float32
    want = (2, n, k) if f32 else (n, k)
    if tuple(t.shape) != want:
        form = "tf32_split's stack" if f32 else "the transposed matrix"
        raise ValueError(f"{kernel} reads {name} as {form} {want}, got {tuple(t.shape)}")
    (check_tf32x3_gemm if f32 else check_sm90_gemm)(kernel, n, k, k)
    return t
