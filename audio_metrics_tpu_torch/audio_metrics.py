"""Top-level AudioMetrics API of the port.

Counterpart of ``audio_metrics_tpu/audio_metrics.py`` for the metrics this
slice ports: FAD (device Newton-Schulz tail when the candidate covariance
is full rank, host float64 otherwise) and KD (device subset Gram sums),
over stems already in memory.  Result keys are the JAX package's: ``fad``,
``kernel_distance_mean``, ``kernel_distance_std``.
"""

from __future__ import annotations

from .data import AudioMetricsData
from .metrics.fad import fad_device_tail, frechet_distance
from .metrics.kd import kernel_distance
from .models import get_embedder
from .parallel.pipeline import ItemCategory, embedding_pipeline

__all__ = ["AudioMetrics"]

_PORTED = ("fad", "kd")


class AudioMetrics:
    def __init__(self, metrics=("fad",), embedder=None, win_dur=5.0, input_sr=None,
                 batch_size=32, device="cuda", n_pca=None):
        """``embedder``: an embedder object, or a registry name built on
        ``device``.  Metrics other than ``fad`` and ``kd``, and ``n_pca``,
        raise ``NotImplementedError``."""
        if n_pca is not None:
            raise NotImplementedError(
                "n_pca (IncrementalPCA projection) is not ported yet (ROADMAP.md Queue 1 "
                "item 6)"
            )
        for m in metrics:
            if m not in _PORTED:
                raise NotImplementedError(
                    f"metric {m!r} is not ported yet (ROADMAP.md: PRDC is next, then "
                    "APA and the rest of Queue 1); the port computes 'fad' and 'kd'"
                )
        self.metrics = list(metrics)
        if embedder is None or isinstance(embedder, str):
            embedder = get_embedder(embedder, device=device)
        self.embedder = embedder
        self.win_dur = win_dur
        self.input_sr = input_sr
        self.batch_size = batch_size
        self.stem_reference = AudioMetricsData(self.store_embeddings)

    @property
    def store_embeddings(self) -> bool:
        return "kd" in self.metrics

    def _run_pipeline(self, waveforms) -> AudioMetricsData:
        return embedding_pipeline(
            waveforms, self.embedder, store_stem_embeddings=self.store_embeddings,
            batch_size=self.batch_size, win_dur=self.win_dur, input_sr=self.input_sr,
        )[ItemCategory.stem]

    def add_reference(self, reference) -> None:
        self.stem_reference += self._run_pipeline(reference)
        self.stem_reference.recompute_stats()

    def reset_reference(self) -> None:
        self.stem_reference = AudioMetricsData(self.store_embeddings)

    def __call__(self, candidate) -> dict:
        return self.evaluate(candidate)

    def evaluate(self, candidate) -> dict:
        if len(self.stem_reference) == 0:
            raise ValueError(
                "The reference dataset is empty: call add_reference() with audio "
                f"longer than win_dur ({self.win_dur}s) first"
            )
        cand = self._run_pipeline(candidate)
        if len(cand) == 0:
            raise ValueError("No stem candidate embeddings were computed")
        ref = self.stem_reference
        result = {}
        if "fad" in self.metrics:
            fad = fad_device_tail(cand, ref)
            result["fad"] = frechet_distance(cand, ref) if fad is None else fad
        if "kd" in self.metrics:
            result.update(kernel_distance(cand, ref))
        return result
