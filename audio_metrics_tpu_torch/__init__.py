"""audio-metrics-tpu-torch: the PyTorch / CUDA port of audio_metrics_tpu.

Distribution metrics over audio embeddings (FAD and KD so far) with the
LAION-CLAP HTSAT embedder, for NVIDIA Hopper cards.  Hand-written CUDA
kernels carry the hot path (kernels/csrc/); each has a plain PyTorch
version that CPU tensors run.  This package never imports JAX and changes
no global mode.

    from audio_metrics_tpu_torch import AudioMetrics
"""

__version__ = "0.1.0"

from .audio_metrics import AudioMetrics  # noqa: E402

__all__ = ["AudioMetrics", "__version__"]
