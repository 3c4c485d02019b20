"""Deterministic fake embedder for tests and pipeline benchmarks.

Counterpart of ``audio_metrics_tpu/models/dummy.py``: ``embedding =
outer(1e3 * std(audio, axis=1), arange(10))`` in f32 (population std, as
``jnp.std``), no checkpoint, no network.
"""

from __future__ import annotations

import torch

from .base import Embedder, resolve_device

__all__ = ["DummyEmbedder"]


class DummyEmbedder(Embedder):
    names = ("embedding",)

    def __init__(self, sr: int = 16000, device="cuda"):
        self.sr = sr
        self.device = resolve_device(device)

    @torch.no_grad()
    def embed(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, n) -> (B, 10) f32."""
        scale = 1e3 * torch.std(audio.float(), dim=1, correction=0)
        return torch.outer(scale, torch.arange(10, dtype=torch.float32, device=audio.device))
