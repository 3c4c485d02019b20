"""Embedder registry (counterpart of audio_metrics_tpu/models/__init__.py).

The JAX package's eight names: the six LAION-CLAP names build
:class:`LaionCLAP` from their checkpoint (``ckpt`` = its URL, resolved
locally first: ``$AM_TPU_CKPT_DIR/<basename>``, then the cache;
``utils.get_url.resolve_checkpoint``), in f32 by default; ``vggish`` builds
:class:`VGGish` from the torchvggish checkpoint the same way; ``dummy`` the
checkpoint-free :class:`DummyEmbedder`.  ``get_embedder(name,
**overrides)`` passes ``overrides`` (``device=``, ``cfg=``,
``compute_dtype=``) to the constructor.
"""

from __future__ import annotations

from .base import Embedder
from .dummy import DummyEmbedder

__all__ = ["Embedder", "DummyEmbedder", "EMBEDDERS", "DEFAULT_EMBEDDER", "get_embedder"]


def _clap(**kwargs):
    from .clap import LaionCLAP

    return LaionCLAP(**kwargs)


def _vggish(**kwargs):
    from .vggish import VGGish

    return VGGish(**kwargs)


def _clap_kwargs(music: bool, layer: str | None) -> dict:
    from .clap import LAION_CLAP_MUSIC_CHECKPOINT_URL, LAION_CLAP_MUSIC_SPEECH_CHECKPOINT_URL

    ckpt = LAION_CLAP_MUSIC_CHECKPOINT_URL if music else LAION_CLAP_MUSIC_SPEECH_CHECKPOINT_URL
    kwargs = {"ckpt": ckpt}
    if layer is not None:
        kwargs["layer"] = layer
    return kwargs


EMBEDDERS = {
    "laion_clap_music": (_clap, lambda: _clap_kwargs(True, None)),
    "laion_clap_music_l-2": (_clap, lambda: _clap_kwargs(True, "audio_projection.0")),
    "laion_clap_music_l-1": (_clap, lambda: _clap_kwargs(True, "audio_projection.2")),
    "laion_clap_music_speech": (_clap, lambda: _clap_kwargs(False, None)),
    "laion_clap_music_speech_l-2": (_clap, lambda: _clap_kwargs(False, "audio_projection.0")),
    "laion_clap_music_speech_l-1": (_clap, lambda: _clap_kwargs(False, "audio_projection.2")),
    "vggish": (_vggish, dict),
    "dummy": (DummyEmbedder, dict),
}

DEFAULT_EMBEDDER = "laion_clap_music"


def get_embedder(name: str | None = None, **overrides) -> Embedder:
    """Build a registered embedder; ``overrides`` (e.g. ``device=``) are
    passed to its constructor."""
    info = EMBEDDERS.get(name or DEFAULT_EMBEDDER)
    if info is None:
        raise ValueError(f"Unknown embedder {name}, must be one of {list(EMBEDDERS)}")
    factory, kwargs_factory = info
    return factory(**{**kwargs_factory(), **overrides})
