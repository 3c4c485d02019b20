"""Embedder protocol (counterpart of audio_metrics_tpu/models/base.py).

An embedder has ``sr`` (the sample rate it expects), ``device`` (where its
weights live) and ``embed(audio) -> (batch, d)`` for a float32
``(batch, n_samples)`` tensor on that device.
"""

from __future__ import annotations

import logging
import os

import torch

__all__ = ["Embedder", "resolve_device"]

logger = logging.getLogger(__name__)


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    this process has no card (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def _require_random_weights_optin(name: str, ckpt, allowed: bool) -> None:
    """Raise unless random weights were explicitly opted into
    (audio_metrics_tpu/models/base.py:27-46): metric values from randomly
    initialised embedders are meaningless."""
    if allowed or os.environ.get("AM_TPU_ALLOW_RANDOM_WEIGHTS"):
        logger.warning(
            "%s: no checkpoint available; using seeded random weights "
            "(benchmark-valid FLOPs, NOT metric-valid values)", name
        )
        return
    raise RuntimeError(
        f"{name}: checkpoint unavailable"
        + (f" ({ckpt})" if ckpt else " (no ckpt specified)")
        + ". Pass params= (the model's numpy parameter dict), provision the checkpoint "
        "under $AM_TPU_CKPT_DIR or the cache (utils/get_url.py), or "
        "allow_random_weights=True / AM_TPU_ALLOW_RANDOM_WEIGHTS=1 to run with "
        "seeded random weights (benchmarking only — metric values from random "
        "weights are meaningless)."
    )


class Embedder:
    sr: int = 48000
    device: torch.device = torch.device("cpu")

    def embed(self, audio: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError
