"""ops of the PyTorch port (see the module docstrings); the windowing
helpers under the JAX package's names (audio_metrics_tpu/ops/__init__.py)."""

from .windowing import audio_slicer, multi_audio_slicer, window_length

__all__ = ["audio_slicer", "multi_audio_slicer", "window_length"]
