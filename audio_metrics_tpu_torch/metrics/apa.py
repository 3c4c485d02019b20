"""Accompaniment Prompt Adherence.

Counterpart of ``audio_metrics_tpu/metrics/apa.py`` (the reference's
metrics/apa.py:5-32): ``APA = 1/2 + (d(y,x') - d(y,x)) / (2 max(d(x,x'),
|d(y,x') - d(y,x)|))`` over host float64 Frechet distances between the
candidate mixes (y), the reference mixes (x) and the misaligned reference
mixes (x').
"""

from __future__ import annotations

from ..data import AudioMetricsData
from .fad import frechet_distance

__all__ = ["apa", "apa_compute_d_x_xp"]


def apa_compute_d_x_xp(reference: AudioMetricsData, anti_reference: AudioMetricsData) -> float:
    return frechet_distance(reference, anti_reference)


def apa(candidate: AudioMetricsData, reference: AudioMetricsData,
        anti_reference: AudioMetricsData, d_x_xp: float | None = None) -> float:
    d_y_x = frechet_distance(candidate, reference)
    d_y_xp = frechet_distance(candidate, anti_reference)
    if d_x_xp is None:
        d_x_xp = frechet_distance(reference, anti_reference)
    return _apa(d_y_x, d_y_xp, d_x_xp)


def _apa(d_y_x: float, d_y_xp: float, d_x_xp: float) -> float:
    """The formula on the three distances, each clamped at 0; 0 when all
    three are 0."""
    d_y_x = max(0.0, d_y_x)
    d_y_xp = max(0.0, d_y_xp)
    d_x_xp = max(0.0, d_x_xp)
    numerator = d_y_xp - d_y_x
    denominator = d_x_xp
    if abs(numerator) > denominator:
        denominator = abs(numerator)
    if denominator <= 0:
        return 0.0
    return 0.5 + numerator / (2.0 * denominator)
