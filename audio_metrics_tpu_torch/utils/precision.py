"""Numeric modes shared by the metric and distance layers."""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["full_f32"]

# TF32 is a process-wide switch of PyTorch's, not a per-thread one; the
# shards of a mesh run on one host thread each, so the regions of all
# threads are counted and the caller's setting comes back when the last ends
_lock = threading.Lock()
_depth = 0
_saved: tuple[bool, bool] | None = None


@contextlib.contextmanager
def full_f32():
    """f32 products without TF32 (cuBLAS and cuDNN), restored on exit: the
    setting saved when the first of the open regions (of any thread) began
    comes back when the last one ends."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _saved
