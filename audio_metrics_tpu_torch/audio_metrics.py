"""Top-level AudioMetrics API of the port.

Counterpart of ``audio_metrics_tpu/audio_metrics.py`` for the metrics the
port computes: FAD (device Newton-Schulz tail when the candidate covariance
is full rank, host float64 otherwise), KD (device subset Gram sums) and
PRDC (device k-NN radii and pairwise sweeps, host float64 means), over
stems already in memory, with the JAX package's stems options (overlapping
windows, resampling, the ``n_pca`` projection, ``timings``, ``precompile``)
and the state files (``save_state`` / ``load_state``) in its ``.npz``
layout.  Result keys and their order are the JAX package's: ``fad``,
``kernel_distance_mean``, ``kernel_distance_std``, ``precision``,
``recall``, ``density``, ``coverage``.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from .data import AudioMetricsData
from .metrics.fad import fad_device_tail, frechet_distance
from .metrics.kd import kernel_distance
from .metrics.prdc import prdc
from .models import get_embedder
from .parallel.pipeline import ItemCategory, embedding_pipeline
from .projection import IncrementalPCA
from .utils.serialize import load_state_dict, save_state_dict

__all__ = ["AudioMetrics"]

_PORTED = ("fad", "kd", "prdc")
# metrics that need the stored embeddings, not only mean and covariance
_NEED_EMBEDDINGS = ("kd", "prdc")
# AudioMetricsData entries of the JAX package's state file; the mix entries
# belong to APA
_AMD = ("stem_reference", "mix_reference", "mix_anti_reference", "stem_reference_pca",
        "mix_reference_pca", "mix_anti_reference_pca")
# state entries of APA (ROADMAP.md Queue 1 item 5), which load_state refuses
_APA_STATE = ("mix_reference", "mix_anti_reference", "mix_reference_pca",
              "mix_anti_reference_pca", "apa_d_x_xp", "mix_projection")


class AudioMetrics:
    def __init__(self, metrics=("apa", "fad"), n_pca=None, device_indices=None, embedder=None,
                 mix_function=None, win_dur=5.0, hop_dur=None, input_sr=None, batch_size=32,
                 progress=False, dcn_slices=None, device="cuda"):
        """The JAX package's parameters in its order, then ``device``.
        ``embedder``: an embedder object, or a registry name built on
        ``device``.  ``hop_dur`` (seconds): overlapping windows.
        ``input_sr``: the rate of the audio given, resampled on the device
        when it is not the embedder's.  ``n_pca``: FAD, KD and PRDC on the
        embeddings projected onto ``n_pca`` principal components of the
        reference (an incremental PCA fitted at the first evaluate after
        each ``add_reference``).  ``progress`` is accepted and does nothing
        (``parallel.pipeline.embedding_pipeline`` says where the JAX package
        shows a bar).
        What is not ported raises ``NotImplementedError`` citing its
        ROADMAP.md Queue 1 item: metrics other than ``fad``, ``kd`` and
        ``prdc`` (so the default, which holds APA: pass ``metrics=``), and
        ``device_indices``, ``mix_function`` and ``dcn_slices`` away from
        their defaults."""
        unported = (
            (device_indices is not None, "device_indices (multi-GPU); pass device=", 10),
            (mix_function is not None, "mix_function (the APA mixes)", 5),
            (dcn_slices is not None, "dcn_slices (multi-host)", 10),
        )
        for given, what, item in unported:
            if given:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})")
        for m in metrics:
            if m not in _PORTED:
                raise NotImplementedError(
                    f"metric {m!r} is not ported yet (ROADMAP.md Queue 1: APA, the JAX "
                    "package's default with FAD, is item 5, fad_inf item 7); the port "
                    "computes 'fad', 'kd' and 'prdc': pass metrics= explicitly"
                )
        self.metrics = list(metrics)
        if embedder is None or isinstance(embedder, str):
            embedder = get_embedder(embedder, device=device)
        self.embedder = embedder
        self.win_dur = win_dur
        self.hop_dur = hop_dur
        self.input_sr = input_sr
        self.batch_size = batch_size
        self.progress = progress
        self.stem_projection = None if n_pca is None else IncrementalPCA(n_components=n_pca)
        self.stem_reference = AudioMetricsData(self.store_embeddings)
        self.stem_reference_pca = None
        self.timings: dict = {}

    @property
    def store_embeddings(self) -> bool:
        return self.stem_projection is not None or any(m in _NEED_EMBEDDINGS for m in self.metrics)

    def _run_pipeline(self, waveforms) -> AudioMetricsData:
        return embedding_pipeline(
            waveforms, self.embedder, store_stem_embeddings=self.store_embeddings,
            batch_size=self.batch_size, win_dur=self.win_dur, hop_dur=self.hop_dur,
            input_sr=self.input_sr, progress=self.progress,
        )[ItemCategory.stem]

    def add_reference(self, reference) -> None:
        self.stem_reference_pca = None  # the projection is refitted on the new reference
        self.stem_reference += self._run_pipeline(reference)
        self.stem_reference.recompute_stats()

    def precompile(self, n_items: int = 256) -> None:
        """Warm-up hook (audio_metrics_tpu/audio_metrics.py:233-266): build
        the kernel library on a card, then run one ``add_reference`` and one
        ``evaluate`` of ``n_items`` windows of seeded synthetic audio on the
        embedder's device, so that the first real ``evaluate`` pays neither
        the build nor the first-call costs.  Then restore the instance: the
        reference, its projected cache and the projection's fit (a deep
        copy).  The JAX package does not restore the projection, so with
        ``n_pca`` its later metrics come from a projection fitted on noise
        (ROADMAP Queue 3); the port does."""
        device = self.embedder.device
        if device.type == "cuda":
            from .kernels import build

            build()
        snapshot = {a: getattr(self, a) for a in ("stem_reference", "stem_reference_pca")}
        snapshot["stem_projection"] = copy.deepcopy(self.stem_projection)
        sr = self.input_sr if self.input_sr is not None else self.embedder.sr
        shape = (n_items, int(round(self.win_dur * sr)))
        gen = torch.Generator(device=device).manual_seed(0)
        try:
            self.reset_reference()
            self.add_reference(0.2 * torch.randn(shape, generator=gen, device=device))
            self.evaluate(0.2 * torch.randn(shape, generator=gen, device=device))
        finally:
            for a, v in snapshot.items():
                setattr(self, a, v)

    def reset_reference(self) -> None:
        self.stem_reference = AudioMetricsData(self.store_embeddings)
        self.stem_reference_pca = None

    # -- the n_pca projection (audio_metrics_tpu/audio_metrics.py:271-292) --
    @staticmethod
    def _projected_stats(projection, embeddings, store_embeddings) -> AudioMetricsData:
        """Project raw embeddings and accumulate their statistics."""
        stats = AudioMetricsData(store_embeddings)
        stats.add(projection.transform(embeddings))
        return stats

    def ensure_stem_projection(self, ref: AudioMetricsData, cand: AudioMetricsData):
        """``(ref, cand)`` projected, when ``n_pca`` is set: the projection
        is fitted once, on the reference only, and its projected reference
        cached until the next ``add_reference``, so that repeated evaluates
        stay comparable."""
        if self.stem_projection is None:
            return ref, cand
        store = any(m in _NEED_EMBEDDINGS for m in self.metrics)
        if self.stem_reference_pca is None:
            self.stem_projection.partial_fit(ref.embeddings)
            self.stem_reference_pca = self._projected_stats(self.stem_projection, ref.embeddings,
                                                            store)
        return self.stem_reference_pca, self._projected_stats(self.stem_projection,
                                                              cand.embeddings, store)

    def __call__(self, candidate) -> dict:
        return self.evaluate(candidate)

    def evaluate(self, candidate) -> dict:
        """The configured metrics of ``candidate`` against the reference.

        Wall-clock seconds of the stages of the last call are kept in
        ``self.timings`` under the JAX package's keys (audio_metrics.py:
        315-498): ``pipeline`` (windowing, resampling, the forwards
        enqueued), ``projection`` (``n_pca``), ``fad``, ``kd_dispatch``,
        ``prdc_dispatch``, and ``finalize``, the whole metric tail after the
        projection (in the JAX package, from its coalesced pull to the
        return).  No synchronisation is added for them.  The forwards are
        enqueued asynchronously, but after each one the batch's row count
        goes to the device as a host scalar (``data.batch_moments``), a copy
        that waits for the stream: so ``pipeline`` holds the device time of
        every forward, and what is left of the loop (the last batch's
        moments) lands in the first stage that reads a device value:
        ``projection`` with ``n_pca`` (the fit reads the embeddings), else
        ``fad`` (its device tail reads the candidate's moments,
        metrics/fad.py:117), else ``kd_dispatch`` (metrics/kd.py:201-202),
        else ``prdc_dispatch``.  Each metric stage here returns host
        values, so the dispatches include their own syncs."""
        self.timings = {}
        t0 = time.perf_counter()
        if len(self.stem_reference) == 0:
            raise ValueError(
                "The reference dataset is empty: call add_reference() with audio "
                f"longer than win_dur ({self.win_dur}s) first"
            )
        cand = self._run_pipeline(candidate)
        if len(cand) == 0:
            raise ValueError("No stem candidate embeddings were computed")
        self.timings["pipeline"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref, cand = self.ensure_stem_projection(self.stem_reference, cand)
        t_tail = time.perf_counter()
        self.timings["projection"] = t_tail - t0
        result = {}
        if "fad" in self.metrics:
            t0 = time.perf_counter()
            fad = None if self.stem_projection is not None else fad_device_tail(cand, ref)
            result["fad"] = frechet_distance(cand, ref) if fad is None else fad
            self.timings["fad"] = time.perf_counter() - t0
        if "kd" in self.metrics:
            t0 = time.perf_counter()
            result.update(kernel_distance(cand, ref))
            self.timings["kd_dispatch"] = time.perf_counter() - t0
        if "prdc" in self.metrics:
            t0 = time.perf_counter()
            k = max(1, min(10, len(ref), len(cand)))
            result.update(prdc(ref, cand, k))
            self.timings["prdc_dispatch"] = time.perf_counter() - t0
        self.timings["finalize"] = time.perf_counter() - t_tail
        return result

    # -- persistence (audio_metrics_tpu/audio_metrics.py:517-548) -----------
    def save_state(self, fp: str | Path) -> None:
        """Write the reference, its projected cache and the projection to an
        ``.npz`` file in the JAX package's layout, which either package
        loads."""
        state = {
            "win_dur": self.win_dur,
            "hop_dur": self.hop_dur,
            "input_sr": self.input_sr,
            "batch_size": self.batch_size,
            "metrics": list(self.metrics),
            "apa_d_x_xp": None,
        }
        for attr in _AMD:
            item = getattr(self, attr, None)
            state[attr] = item.serialize() if item else None
        proj = self.stem_projection
        state["stem_projection"] = None if proj is None else proj.__getstate__()
        state["mix_projection"] = None
        save_state_dict(state, fp)

    def load_state(self, fp: str | Path) -> None:
        """Restore the reference and its projected cache (embeddings and
        radii on the embedder's device), the projection's fit (when this
        instance has ``n_pca``, as in the JAX package), and ``win_dur``,
        ``hop_dur``, ``input_sr``, ``batch_size`` from a state file of
        either package.  The instance keeps its own ``metrics``, as the JAX
        package's ``load_state`` does (its :546).  APA state raises: the
        mix references, ``apa_d_x_xp`` and a fitted ``mix_projection`` (the
        JAX package writes an unfitted one whenever ``n_pca`` is set)."""
        state = load_state_dict(fp)
        unported = [k for k in _APA_STATE if state.get(k) is not None
                    and (k != "mix_projection" or "components_" in state[k])]
        if unported:
            raise NotImplementedError(
                f"state entries {unported} belong to APA, which is not ported yet "
                "(ROADMAP.md Queue 1 item 5)"
            )
        for attr in ("stem_reference", "stem_reference_pca"):
            item = state.get(attr)
            if item is not None and item.get("n") is not None:
                setattr(self, attr, AudioMetricsData.deserialize(item, device=self.embedder.device))
            elif item is not None:
                setattr(self, attr, AudioMetricsData(item.get("store_embeddings", True)))
        if state.get("stem_projection") is not None and self.stem_projection is not None:
            self.stem_projection.__setstate__(state["stem_projection"])
        for key in ("win_dur", "hop_dur", "input_sr", "batch_size"):
            if key in state:
                setattr(self, key, state[key])
