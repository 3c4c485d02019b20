"""CLAP checkpoints and numpy parameter dicts -> the port's modules.

``convert_checkpoint`` turns a LAION or HF CLAP state dict into the
framework-free numpy dict with HF Clap names and f32 arrays, as the JAX
package's ``convert_checkpoint`` (audio_metrics_tpu/models/clap.py:395-474)
does, a copy of it, so that one checkpoint gives the same dict in both
packages; ``init_params`` and ``init_projection_params`` give dicts of the
same layout.  ``params_from_numpy`` folds such a dict into the modules.
Every fold the kernels need happens then, once: each Swin block takes the
layout of the path it runs (``models.htsat.SwinBlock``: the v4/v3
fold, v1's per-head weights or the XLA half's raw weights), chosen from
``AM_TPU_V4_STAGES`` and ``AM_TPU_ATTN_V1`` as they stand at this call.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.base import resolve_device
from .models.clap import ClapAudio, init_projection_params
from .models.htsat import HTSATConfig, init_params

__all__ = ["convert_checkpoint", "expected_param_keys", "params_from_numpy"]

# LAION state-dict fragment renames (structural facts of the two formats)
_LAION_RENAMES = [
    ("audio_branch.", "audio_encoder."),
    ("bn0.", "batch_norm."),
    ("attn.qkv.", "attention.qkv."),  # split below
    ("attn.proj.", "attention.output.dense."),
    ("attn.relative_position_bias_table", "attention.self.relative_position_bias_table"),
    ("mlp.fc1.", "intermediate.dense."),
    ("mlp.fc2.", "output.dense."),
    ("norm1.", "layernorm_before."),
    ("norm2.", "layernorm_after."),
    ("audio_projection.0.", "audio_projection.linear1."),
    ("audio_projection.2.", "audio_projection.linear2."),
]
_KEEP_PREFIXES = ("audio_encoder.", "audio_projection.")


def expected_param_keys(cfg: HTSATConfig) -> set:
    """The exact key set the forward consumes for ``cfg``."""
    return set(init_params(cfg, seed=0)) | set(init_projection_params(cfg))


def convert_checkpoint(state_dict: dict, cfg: HTSATConfig | None = None,
                       strict: bool = False) -> dict:
    """A CLAP checkpoint's state dict (LAION ``.pt`` or HF) -> the numpy
    parameter dict: ``module.`` / ``model.`` / ``audio_model.`` prefixes
    dropped, LAION names renamed to HF Clap's, each fused qkv split into
    query / key / value thirds; text-tower and classifier weights dropped
    (audio is embedded only).  With ``cfg`` the result holds exactly the
    keys the forward consumes (dropping LAION's DSP-frontend weights and
    buffers such as ``relative_position_index``); with ``strict`` as well,
    a checkpoint that does not cover them raises ``ValueError``, listing
    the missing keys.  Values may be torch tensors or arrays."""
    flat = {}
    for key, val in state_dict.items():
        arr = np.asarray(val.detach().cpu().numpy() if hasattr(val, "detach") else val)
        for prefix in ("module.", "model.", "audio_model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
        for old, new in _LAION_RENAMES:
            key = key.replace(old, new)
        flat[key] = arr.astype(np.float32)

    params = {}
    for key, arr in flat.items():
        if not key.startswith(_KEEP_PREFIXES):
            continue
        if ".attention.qkv." in key:
            d = arr.shape[0] // 3
            for name, chunk in zip(("query", "key", "value"),
                                   (arr[:d], arr[d:2 * d], arr[2 * d:])):
                params[key.replace(".attention.qkv.", f".attention.self.{name}.")] = chunk
        else:
            params[key] = arr

    if cfg is not None:
        expected = expected_param_keys(cfg)
        missing = expected - set(params)
        if strict and missing:
            raise ValueError(
                f"CLAP checkpoint conversion incomplete for {cfg}: {len(missing)} of "
                f"{len(expected)} keys missing, e.g. {sorted(missing)[:5]} — wrong checkpoint "
                "or layout drift"
            )
        params = {k: v for k, v in params.items() if k in expected}
    return params


def params_from_numpy(d: dict[str, np.ndarray], cfg: HTSATConfig, device="cuda",
                      dtype: torch.dtype = torch.float32) -> ClapAudio:
    """Fold ``d`` into a :class:`ClapAudio` on ``device``; ``dtype`` is the
    compute dtype of the Swin tower (bf16 or f32).  Raises on missing keys
    (a layout mismatch must fail loudly, not embed garbage)."""
    expected = expected_param_keys(cfg)
    missing = expected - set(d)
    if missing:
        raise ValueError(
            f"parameter dict incomplete for {cfg}: {len(missing)} of {len(expected)} "
            f"keys missing, e.g. {sorted(missing)[:5]}"
        )
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    return ClapAudio(d, cfg, dtype).to(resolve_device(device)).eval()
