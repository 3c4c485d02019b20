"""Embedder protocol (counterpart of audio_metrics_tpu/models/base.py).

An embedder has ``sr`` (the sample rate it expects), ``device`` (where its
weights live), ``embed(audio) -> (batch, d)`` for a float32 ``(batch,
n_samples)`` tensor on that device, and ``replicate(device)``, a copy of
it on another device (a mesh keeps one per device:
``parallel.mesh.Mesh.replicas``; the JAX package's ``Embedder.shard``
replicates its parameters over a mesh instead, its models/base.py:74).

Every embedder also speaks the reference's protocol (its clap.py:21-44,
vggish.py:14-33), which the JAX package documents as its extension point:
``forward(data) -> {"embedding": (batch, d)}`` (also ``embedder(data)``)
for ``data["audio"]`` 1-D or 2-D, numpy or a tensor.  An object of the
user's that has ``sr`` and ``forward(data)`` only (an ``nn.Module`` of its
own, say) becomes an embedder of the port through :func:`as_embedder`;
``AudioMetrics`` and ``embedding_pipeline`` call it on what they are given.
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np
import torch
from torch import nn

__all__ = ["Embedder", "ForwardEmbedder", "as_embedder", "resolve_device"]

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


def _held_tensors(obj) -> list[torch.Tensor]:
    """The tensors ``obj`` holds: its own tensor attributes, and the
    parameters, buffers and tensor attributes of every module it is or
    holds."""
    modules = [v for v in vars(obj).values() if isinstance(v, nn.Module)]
    if isinstance(obj, nn.Module):
        modules.append(obj)
    held = [v for v in vars(obj).values() if isinstance(v, torch.Tensor)]
    for module in modules:
        for m in module.modules():
            held += [t for t in (*m._parameters.values(), *m._buffers.values()) if t is not None]
            held += [v for v in vars(m).values() if isinstance(v, torch.Tensor)]
    return held


def audio_batch(audio, device) -> torch.Tensor:
    """``audio`` (n,) or (batch, n), numpy, a tensor or an array-like, as a
    (batch, n) f32 tensor on ``device``."""
    if not isinstance(audio, torch.Tensor):
        audio = torch.as_tensor(np.asarray(audio, np.float32))
    audio = audio.to(device, torch.float32)
    if audio.ndim == 1:
        audio = audio[None]
    if audio.ndim != 2:
        raise ValueError(f"audio must be (n,) or (batch, n), got shape {tuple(audio.shape)}")
    return audio


class Embedder:
    sr: int = 48000
    device: torch.device = torch.device("cpu")

    def embed(self, audio: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, data: dict) -> dict:
        """The reference protocol: ``{"embedding": (batch, d) f32}`` for
        ``data["audio"]``, (n,) or (batch, n), moved to ``self.device``."""
        return {"embedding": self.embed(audio_batch(data["audio"], self.device))}

    def __call__(self, data: dict) -> dict:
        return self.forward(data)

    def replicate(self, device) -> "Embedder":
        """A new embedder on ``device`` with this one's weights: a deep copy
        in which every tensor held from load (the modules' parameters and
        buffers, among them the folded (N, K) kernel operands, the frontend
        tables and any weight codes, and tensor attributes) is copied to
        ``device``, never shared with this embedder, also on its own
        device.  Tables made at a call (``ops.mel.device_table``) are kept
        per device already."""
        dev = resolve_device(device)
        memo = {}
        for t in _held_tensors(self):
            new = t.detach().to(dev, copy=True)
            memo[id(t)] = nn.Parameter(new, t.requires_grad) if isinstance(t, nn.Parameter) \
                else new
        out = copy.deepcopy(self, memo)
        out.device = dev
        return out


class ForwardEmbedder:
    """An object with ``sr`` and ``forward(data) -> {"embedding": ...}`` as
    an embedder of the port: ``embed(audio)`` passes the (batch, n) f32
    tensor on ``device`` as ``{"audio": audio}`` under ``no_grad`` and
    returns the ``"embedding"`` as f32 on ``device`` (the object may return
    a tensor, a numpy array or any array-like).  It has no ``replicate``:
    a mesh over other devices raises ``TypeError`` (``Mesh.replicas``),
    while shards on its own device share it."""

    def __init__(self, obj, device):
        self.obj = obj
        self.sr = obj.sr
        self.device = resolve_device(device)

    @torch.no_grad()
    def embed(self, audio: torch.Tensor) -> torch.Tensor:
        out = self.obj.forward({"audio": audio})["embedding"]
        if not isinstance(out, torch.Tensor):
            out = torch.as_tensor(np.asarray(out))
        return out.to(self.device, torch.float32)

    def forward(self, data: dict) -> dict:
        return self.obj.forward(data)

    def __call__(self, data: dict) -> dict:
        return self.forward(data)


def as_embedder(obj, device="cuda"):
    """A :class:`ForwardEmbedder` of ``obj`` when it has ``forward`` but no
    ``embed``, on ``obj.device`` where it has one, else on ``device``;
    any other ``obj`` (an embedder of the port) itself."""
    if hasattr(obj, "embed") or not hasattr(obj, "forward"):
        return obj
    return ForwardEmbedder(obj, getattr(obj, "device", device))
