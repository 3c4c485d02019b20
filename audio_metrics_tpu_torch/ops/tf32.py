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
kernel's wrapper takes it through :func:`split_operand`.
"""

from __future__ import annotations

import torch

from ..kernels import check_tf32x3_gemm

__all__ = ["split_operand", "tf32_round", "tf32_split"]

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


def split_operand(kernel: str, operands: dict | None, name: str, n: int, k: int,
                  made_by: str) -> torch.Tensor:
    """``operands[name]``, the (2, n, k) :func:`tf32_split` stack of an (n, k)
    matrix that the f32 kernel ``kernel`` reads, made at load by
    ``made_by``.  Raise ``ValueError`` when the operands are missing or the
    stack has another shape, and ``NotImplementedError`` unless the 3xTF32
    core takes an (n, k) product (``kernels.check_tf32x3_gemm``)."""
    if operands is None:
        raise ValueError(f"{kernel} on the card reads {made_by}, made once at weight load: "
                         "pass them as operands=")
    t = operands[name]
    if t.shape != (2, n, k):
        raise ValueError(f"{kernel} reads {name} as tf32_split's (2, {n}, {k}) stack, got "
                         f"{tuple(t.shape)}")
    check_tf32x3_gemm(kernel, n, k, k)
    return t
