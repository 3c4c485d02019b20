"""Numpy parameter dict -> the port's modules.

The dict is the framework-free one that ``init_params``,
``init_projection_params`` and the JAX package's ``convert_checkpoint``
produce (HF Clap names, f32 arrays), so both packages compute with the same
weights.  Every fold the kernels need happens here, once: each Swin block
takes the layout of the path it runs (``models.htsat.SwinBlock``: the v4/v3
fold, v1's per-head weights or the XLA half's raw weights), chosen from
``AM_TPU_V4_STAGES`` and ``AM_TPU_ATTN_V1`` as they stand at this call.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.base import resolve_device
from .models.clap import ClapAudio, init_projection_params
from .models.htsat import HTSATConfig, init_params

__all__ = ["params_from_numpy"]


def params_from_numpy(d: dict[str, np.ndarray], cfg: HTSATConfig, device="cuda",
                      dtype: torch.dtype = torch.float32) -> ClapAudio:
    """Fold ``d`` into a :class:`ClapAudio` on ``device``; ``dtype`` is the
    compute dtype of the Swin tower (bf16 or f32).  Raises on missing keys
    (a layout mismatch must fail loudly, not embed garbage)."""
    expected = set(init_params(cfg, seed=0)) | set(init_projection_params(cfg))
    missing = expected - set(d)
    if missing:
        raise ValueError(
            f"parameter dict incomplete for {cfg}: {len(missing)} of {len(expected)} "
            f"keys missing, e.g. {sorted(missing)[:5]}"
        )
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    return ClapAudio(d, cfg, dtype).to(resolve_device(device)).eval()
