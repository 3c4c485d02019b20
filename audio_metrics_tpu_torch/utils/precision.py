"""Numeric modes shared by the metric and distance layers."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32"]


@contextlib.contextmanager
def full_f32():
    """f32 products without TF32 (cuBLAS and cuDNN), restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
