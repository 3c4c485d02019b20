"""Top-level AudioMetrics API of the port.

Counterpart of ``audio_metrics_tpu/audio_metrics.py`` for the metrics the
port computes: FAD (device Newton-Schulz tail when the candidate covariance
is full rank, host float64 otherwise), KD (device subset Gram sums) and
PRDC (device k-NN radii and pairwise sweeps, host float64 means), over
stems already in memory, and the state files (``save_state`` /
``load_state``) in the JAX package's ``.npz`` layout.  Result keys and
their order are the JAX package's: ``fad``, ``kernel_distance_mean``,
``kernel_distance_std``, ``precision``, ``recall``, ``density``,
``coverage``.
"""

from __future__ import annotations

from pathlib import Path

from .data import AudioMetricsData
from .metrics.fad import fad_device_tail, frechet_distance
from .metrics.kd import kernel_distance
from .metrics.prdc import prdc
from .models import get_embedder
from .parallel.pipeline import ItemCategory, embedding_pipeline
from .utils.serialize import load_state_dict, save_state_dict

__all__ = ["AudioMetrics"]

_PORTED = ("fad", "kd", "prdc")
# metrics that need the stored embeddings, not only mean and covariance
_NEED_EMBEDDINGS = ("kd", "prdc")
# AudioMetricsData entries of the JAX package's state file; only the stems
# reference is ported (the others belong to APA and n_pca)
_AMD = ("stem_reference", "mix_reference", "mix_anti_reference", "stem_reference_pca",
        "mix_reference_pca", "mix_anti_reference_pca")


class AudioMetrics:
    def __init__(self, metrics=("fad",), embedder=None, win_dur=5.0, input_sr=None,
                 batch_size=32, device="cuda", n_pca=None, device_indices=None):
        """``embedder``: an embedder object, or a registry name built on
        ``device``.  Metrics other than ``fad``, ``kd`` and ``prdc``,
        ``n_pca`` and ``device_indices`` raise ``NotImplementedError``."""
        if device_indices is not None:
            raise NotImplementedError(
                "device_indices (multi-GPU) is not ported yet (ROADMAP.md Queue 1 item 10); "
                "pass device="
            )
        if n_pca is not None:
            raise NotImplementedError(
                "n_pca (IncrementalPCA projection) is not ported yet (ROADMAP.md Queue 1 "
                "item 6)"
            )
        for m in metrics:
            if m not in _PORTED:
                raise NotImplementedError(
                    f"metric {m!r} is not ported yet (ROADMAP.md Queue 1: APA is item 5, "
                    "fad_inf item 7); the port computes 'fad', 'kd' and 'prdc'"
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
        return any(m in _NEED_EMBEDDINGS for m in self.metrics)

    def _run_pipeline(self, waveforms) -> AudioMetricsData:
        return embedding_pipeline(
            waveforms, self.embedder, store_stem_embeddings=self.store_embeddings,
            batch_size=self.batch_size, win_dur=self.win_dur, input_sr=self.input_sr,
        )[ItemCategory.stem]

    def add_reference(self, reference) -> None:
        self.stem_reference += self._run_pipeline(reference)
        self.stem_reference.recompute_stats()

    def precompile(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "precompile is not ported yet (ROADMAP.md Queue 1 item 2); PyTorch runs eagerly "
            "and the kernels build at first use"
        )

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
        if "prdc" in self.metrics:
            k = max(1, min(10, len(ref), len(cand)))
            result.update(prdc(ref, cand, k))
        return result

    # -- persistence (audio_metrics_tpu/audio_metrics.py:517-548) -----------
    def save_state(self, fp: str | Path) -> None:
        """Write the reference to an ``.npz`` file in the JAX package's
        layout, which either package loads."""
        state = {
            "win_dur": self.win_dur,
            "hop_dur": None,
            "input_sr": self.input_sr,
            "batch_size": self.batch_size,
            "metrics": list(self.metrics),
            "apa_d_x_xp": None,
        }
        for attr in _AMD:
            item = getattr(self, attr, None)
            state[attr] = item.serialize() if item else None
        state["stem_projection"] = state["mix_projection"] = None
        save_state_dict(state, fp)

    def load_state(self, fp: str | Path) -> None:
        """Restore the reference (embeddings and radii on the embedder's
        device) and ``win_dur``, ``input_sr``, ``batch_size`` from a state
        file of either package.  The instance keeps its own ``metrics``, as
        the JAX package's ``load_state`` does (its :546).  APA and n_pca
        state (mix references, PCA projections, ``apa_d_x_xp``) and
        overlapping windows (``hop_dur``) raise: they are not ported."""
        state = load_state_dict(fp)
        unported = [k for k in (*_AMD[1:], "stem_projection", "mix_projection", "apa_d_x_xp",
                                "hop_dur") if state.get(k) is not None]
        if unported:
            raise NotImplementedError(
                f"state entries {unported} belong to APA, n_pca or overlapping windows, which "
                "are not ported yet (ROADMAP.md Queue 1 items 5-6)"
            )
        item = state.get("stem_reference")
        if item is not None and item.get("n") is not None:
            self.stem_reference = AudioMetricsData.deserialize(item, device=self.embedder.device)
        elif item is not None:
            self.stem_reference = AudioMetricsData(item.get("store_embeddings", True))
        for key in ("win_dur", "input_sr", "batch_size"):
            if key in state:
                setattr(self, key, state[key])
