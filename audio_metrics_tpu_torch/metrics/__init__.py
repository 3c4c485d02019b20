"""The metrics of the port, under the JAX package's names
(audio_metrics_tpu/metrics/__init__.py): on ``AudioMetricsData``
(``frechet_distance``, ``kernel_distance``, ``prdc``, ``apa``,
``apa_compute_d_x_xp``) and on raw features (``kid_features_to_metric``,
``nearest_neighbour_distances``; ``prdc.pairwise_distance_stats``)."""

from .apa import apa, apa_compute_d_x_xp
from .fad import frechet_distance
from .kd import kernel_distance, kid_features_to_metric
from .prdc import nearest_neighbour_distances, prdc

__all__ = [
    "frechet_distance",
    "kernel_distance",
    "kid_features_to_metric",
    "prdc",
    "nearest_neighbour_distances",
    "apa",
    "apa_compute_d_x_xp",
]
