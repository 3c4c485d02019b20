"""Embedder registry (counterpart of audio_metrics_tpu/models/__init__.py).

The six LAION-CLAP names build :class:`LaionCLAP` from their checkpoint
(``ckpt`` = its URL, resolved locally first: ``$AM_TPU_CKPT_DIR/<basename>``,
then the cache; ``utils.get_url.resolve_checkpoint``), in f32 by default.
``get_embedder(name, **overrides)`` passes ``overrides`` (``device=``,
``cfg=``, ``compute_dtype=``) to the constructor.  ``vggish`` raises
``NotImplementedError``.
"""

from __future__ import annotations

from .base import Embedder

__all__ = ["Embedder", "EMBEDDERS", "DEFAULT_EMBEDDER", "get_embedder"]


def _clap(**kwargs):
    from .clap import LaionCLAP

    return LaionCLAP(**kwargs)


def _vggish(**kwargs):
    raise NotImplementedError(
        "VGGish is not ported yet: ROADMAP.md Queue 1 item 4 (models/vggish.py and "
        "its mel convention)"
    )


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
