"""Top-level AudioMetrics API of the port.

Counterpart of ``audio_metrics_tpu/audio_metrics.py``: APA over mixes of
context+stem pairs (the registry mixes of ``ops.mix`` or a user callable),
FAD (device Newton-Schulz tail when the candidate's moments are one
device triple of full rank, host float64 otherwise), KD (device subset
Gram sums), PRDC (device k-NN radii and pairwise sweeps, host float64
means) and FAD-inf (device subset sweep, host float64 fit) over the stems,
for audio in a tensor or array or an iterable of songs of any length, with
the JAX package's options (overlapping windows, resampling, the ``n_pca``
projections, ``timings``, ``precompile``) and the state files
(``save_state`` / ``load_state``) in its ``.npz`` layout.  Result keys and
their order are the JAX package's: ``fad``, ``kernel_distance_mean``,
``kernel_distance_std``, ``precision``, ``recall``, ``density``,
``coverage``, ``fad_inf``, ``fad_inf_slope``, then ``apa``.
"""

from __future__ import annotations

import copy
import math
import os
import time
import warnings
from pathlib import Path

import torch

from .data import AudioMetricsData
from .metrics.apa import apa, apa_compute_d_x_xp
from .metrics.fad import FadInfUnavailable, fad_device_tail, fad_inf_parts, frechet_distance
from .metrics.kd import kernel_distance
from .metrics.prdc import prdc
from .models import get_embedder
from .models.base import as_embedder
from .ops.mix import DEFAULT_MIX_FUNCTION, MIX_FUNCTIONS
from .parallel.mesh import make_mesh
from .parallel.pipeline import ItemCategory, embedding_pipeline
from .projection import IncrementalPCA
from .utils.serialize import load_state_dict, save_state_dict

__all__ = ["AudioMetrics"]

_METRICS = ("apa", "fad", "fad_inf", "kd", "prdc")
# metrics that need the stored embeddings, not only mean and covariance
_NEED_EMBEDDINGS = ("kd", "prdc", "fad_inf")
# AudioMetricsData entries of the state file
_AMD = ("stem_reference", "mix_reference", "mix_anti_reference", "stem_reference_pca",
        "mix_reference_pca", "mix_anti_reference_pca")


class AudioMetrics:
    def __init__(self, metrics=("apa", "fad"), n_pca=None, device_indices=None, embedder=None,
                 mix_function=None, win_dur=5.0, hop_dur=None, input_sr=None, batch_size=32,
                 progress=False, dcn_slices=None, device="cuda"):
        """The JAX package's parameters in its order, then ``device``.
        ``metrics``: any of ``apa``, ``fad``, ``fad_inf``, ``kd``, ``prdc``
        (another name raises ``ValueError``; the JAX package ignores it);
        APA takes context+stem pairs, the others the stems (channel 1 of
        pairs, or mono audio): an (N, n_samples, 2) or (N, n_samples)
        tensor or array, or an iterable of songs of any length,
        (n_samples, 2) or (n_samples,) each.  ``embedder``: an
        embedder of the port, an object with ``sr`` and ``forward(data)``
        only (the reference's protocol; ``models.base.as_embedder`` wraps
        it, on its ``device`` attribute or else on ``device``), or a
        registry name built on ``device`` (``get_embedder``).
        ``mix_function``: a name of ``ops.mix.MIX_FUNCTIONS`` (default
        ``L0``) or a callable ``f(audio[n, 2], sr) -> mono[n]``, run per
        item on the host.  ``hop_dur`` (seconds): overlapping windows.
        ``input_sr``: the rate of the audio given, resampled on the device
        when it is not the embedder's.  ``n_pca``: every metric on the
        embeddings projected onto ``n_pca`` principal components of the
        reference (incremental PCAs of the stems and of the mixes, each
        fitted at the first evaluate after an ``add_reference``).
        ``progress`` is accepted and does nothing (``parallel.pipeline.
        embedding_pipeline`` says where the JAX package shows a bar).
        ``device_indices``: the devices of the embedder's platform to
        spread the work over (``self.mesh``, ``parallel.mesh.make_mesh``):
        on ``cuda`` distinct indices of visible cards, on ``cpu`` k
        distinct indices give k CPU shards.  None (or an empty list) is
        the embedder's own device alone, the card ``device`` names: where
        the JAX package spreads over every device by default, the port
        asks for the cards, since a mesh over four H100s measured no
        faster than one card (PERF.md §7).  ``dcn_slices`` (or
        ``AM_TPU_DCN_SLICES``, read here): the ``(dcn, data)`` layout of
        the mesh.  Bad indices raise
        ``ValueError``.  The mesh's first device holds the stored
        embeddings and the loaded state; with several shards the
        embeddings, KD and PRDC spread over them, and FAD takes its host
        float64 path (one moment triple a shard)."""
        for m in metrics:
            if m not in _METRICS:
                raise ValueError(f"unknown metric {m!r}; the metrics are "
                                 f"{', '.join(map(repr, _METRICS))}")
        self.metrics = list(metrics)
        self.need_apa = "apa" in self.metrics
        self.device = device
        if embedder is None or isinstance(embedder, str):
            embedder = self.get_embedder(embedder)
        else:
            embedder = as_embedder(embedder, device)
        self.embedder = embedder
        if dcn_slices is None:
            dcn_slices = int(os.environ.get("AM_TPU_DCN_SLICES", "0")) or None
        if device_indices is None or len(device_indices) == 0:
            self.mesh = make_mesh(devices=[embedder.device], dcn_slices=dcn_slices)
        else:
            self.mesh = make_mesh(device_indices, dcn_slices=dcn_slices,
                                  device=embedder.device)
        if mix_function is None or isinstance(mix_function, str):
            mix_function = self.get_mix_function(mix_function)
        self.mix_function = mix_function
        self.win_dur = win_dur
        self.hop_dur = hop_dur
        self.input_sr = input_sr
        self.batch_size = batch_size
        self.progress = progress
        self.stem_projection = None if n_pca is None else IncrementalPCA(n_components=n_pca)
        self.mix_projection = None if n_pca is None else IncrementalPCA(n_components=n_pca)
        self.apa_d_x_xp = None
        self.timings: dict = {}
        self.mix_reference = self.mix_anti_reference = self.stem_reference = None
        self.reset_reference()

    @property
    def stems_mode(self) -> bool:
        return any(m != "apa" for m in self.metrics)

    @property
    def store_mix_embeddings(self) -> bool:
        return self.need_apa and self.mix_projection is not None

    @property
    def store_stem_embeddings(self) -> bool:
        return self.stem_projection is not None or any(m in _NEED_EMBEDDINGS for m in self.metrics)

    def get_embedder(self, embedder):
        """The registry embedder named ``embedder`` (default
        ``laion_clap_music``) built on this instance's ``device``
        (audio_metrics_tpu/audio_metrics.py:171-179); an unknown name
        raises ``ValueError``."""
        return get_embedder(embedder, device=self.device)

    @staticmethod
    def get_mix_function(mix_function):
        """The registry mix named ``mix_function`` (default ``L0``)."""
        func = MIX_FUNCTIONS.get(mix_function or DEFAULT_MIX_FUNCTION)
        if func is None:
            raise ValueError(f"Unknown mix_function {mix_function}, must be one of "
                             f"{MIX_FUNCTIONS.keys()}")
        return func

    def _run_pipeline(self, waveforms, apa_mode, timings=None) -> dict:
        return embedding_pipeline(
            waveforms, self.embedder, mix_function=self.mix_function, apa_mode=apa_mode,
            stems_mode=self.stems_mode, store_mix_embeddings=self.store_mix_embeddings,
            store_stem_embeddings=self.store_stem_embeddings, batch_size=self.batch_size,
            win_dur=self.win_dur, hop_dur=self.hop_dur, input_sr=self.input_sr,
            progress=self.progress, timings=timings, mesh=self.mesh,
        )

    def add_reference(self, reference) -> None:
        """Embed ``reference`` and add it to the reference sets: the stems,
        and with APA the aligned mixes and the misaligned mixes (each
        context with another window's stem, a fresh random pairing at each
        call, as in the JAX package).  The projections are refitted, and
        ``apa_d_x_xp`` recomputed, at the next evaluate."""
        out = self._run_pipeline(reference, "reference" if self.need_apa else None)
        stem = out.get(ItemCategory.stem)
        if stem is not None:
            self.stem_reference_pca = None
            self.stem_reference += stem
            self.stem_reference.recompute_stats()
        mix = out.get(ItemCategory.aligned)
        if mix is not None:
            # the JAX package keeps apa_d_x_xp from before the reference grew
            self.mix_reference_pca = self.mix_anti_reference_pca = self.apa_d_x_xp = None
            self.mix_reference += mix
        anti = out.get(ItemCategory.misaligned)
        if anti is not None:
            self.mix_anti_reference += anti

    def precompile(self, n_items: int = 256) -> None:
        """Warm-up hook (audio_metrics_tpu/audio_metrics.py:233-266): build
        the kernel library on a card, then run one ``add_reference`` and one
        ``evaluate`` of ``n_items`` windows of seeded synthetic audio
        ((n_items, win, 2) pairs with APA; over a mesh of several shards at
        least a batch a shard, so that every replica runs) on the mesh's
        first device, so that the first real ``evaluate`` pays neither the
        build nor the first-call costs.  Then restore the instance: the references, their
        projected caches, ``apa_d_x_xp`` and the projections' fits (deep
        copies).  The JAX package does not restore the projections, so with
        ``n_pca`` its later metrics come from projections fitted on noise
        (ROADMAP Queue 3); the port does."""
        device = self.mesh.home
        if device.type == "cuda":
            from .kernels import build

            build()
        if self.mesh.size > 1:
            n_items = max(n_items, self.batch_size * self.mesh.size)
        snapshot = {a: getattr(self, a) for a in _AMD + ("apa_d_x_xp",)}
        snapshot["stem_projection"] = copy.deepcopy(self.stem_projection)
        snapshot["mix_projection"] = copy.deepcopy(self.mix_projection)
        sr = self.input_sr if self.input_sr is not None else self.embedder.sr
        win = int(round(self.win_dur * sr))
        shape = (n_items, win, 2) if self.need_apa else (n_items, win)
        gen = torch.Generator(device=device).manual_seed(0)
        try:
            self.reset_reference()
            self.add_reference(0.2 * torch.randn(shape, generator=gen, device=device))
            self.evaluate(0.2 * torch.randn(shape, generator=gen, device=device))
        finally:
            for a, v in snapshot.items():
                setattr(self, a, v)

    def reset_reference(self) -> None:
        if self.need_apa:
            self.apa_d_x_xp = None
            self.mix_reference = AudioMetricsData(self.store_mix_embeddings)
            self.mix_anti_reference = AudioMetricsData(self.store_mix_embeddings)
        if self.stems_mode:
            self.stem_reference = AudioMetricsData(self.store_stem_embeddings)
        self.mix_reference_pca = self.mix_anti_reference_pca = self.stem_reference_pca = None

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

    def ensure_mix_projection(self, ref: AudioMetricsData, anti_ref: AudioMetricsData,
                              cand: AudioMetricsData):
        """``(ref, anti_ref, cand)`` projected, when ``n_pca`` is set
        (audio_metrics_tpu/audio_metrics.py:293-310): the mix projection is
        fitted once, on the reference mixes only; APA reads mean and
        covariance alone, so no projected embeddings are kept."""
        if self.mix_projection is None:
            return ref, anti_ref, cand
        if self.mix_reference_pca is None:
            self.mix_projection.partial_fit(ref.embeddings)
            self.mix_reference_pca = self._projected_stats(self.mix_projection, ref.embeddings,
                                                           False)
            self.mix_anti_reference_pca = self._projected_stats(self.mix_projection,
                                                                anti_ref.embeddings, False)
        return self.mix_reference_pca, self.mix_anti_reference_pca, self._projected_stats(
            self.mix_projection, cand.embeddings, False)

    def __call__(self, candidate) -> dict:
        return self.evaluate(candidate)

    def evaluate(self, candidate) -> dict:
        """The configured metrics of ``candidate`` against the reference.

        Wall-clock seconds of the stages of the last call are kept in
        ``self.timings`` under the JAX package's keys (audio_metrics.py:
        315-498): ``pipeline`` (windowing, resampling, mixing, the forwards
        enqueued), ``projection`` (``n_pca``, and APA's d(x, x') at the
        first evaluate after an ``add_reference``), ``fad``,
        ``kd_dispatch``, ``prdc_dispatch``, ``fad_inf_dispatch``,
        ``finalize`` (the whole stems metric tail after the projection; in
        the JAX package, from its coalesced pull to the return), and
        ``apa``.  No synchronisation is
        added for them.  The forwards are enqueued asynchronously and the
        embed loop sends no host value to the card (a batch's row count is
        filled in on the device, ``data.batch_moments``; over a mesh,
        ``parallel.pipeline.sharded_embed_loop``), so ``pipeline`` ends
        when the last forward is enqueued (the pair path's one read of its
        mix flags waits for the mixes), and the wait for the card lands in
        the first stage that reads a device value: ``projection`` with
        ``n_pca`` or at APA's first evaluate, else ``fad`` (its device tail,
        ``metrics.fad.fad_device_tail``, pulls a trace square root or M's
        eigenvalues and the candidate's mean; under
        ``AM_TPU_FAD_TAIL=host``, read at each call, the candidate's
        moments for the float64 ``frechet_distance``), else
        ``kd_dispatch`` (the pull of its Gram sums), else
        ``prdc_dispatch``, else ``apa``.  Each metric stage here returns
        host values, so the dispatches include their own syncs.  Songs
        given as an iterable take the
        host-fed path (``parallel.pipeline.embedding_pipeline``), which
        sends no host value to the card after a forward: there ``pipeline``
        ends with the one pull of the moments, which waits for the card,
        and two more keys split it: ``pipeline_feed``, the host's seconds
        making batches (windows, shuffles, stacking), and
        ``pipeline_drain``, the wait at that pull.
        Pairs given without APA are the stems of their channel 1; mono
        audio given with APA raises ``ValueError``.

        ``fad_inf`` where its sweep cannot run (no stored candidate
        embeddings, n <= d + 1, no reference Cholesky factor, or fewer
        than two distinct subset sizes) gives ``fad_inf`` and
        ``fad_inf_slope`` as nan, with a warning naming the cause; the
        JAX package drops both keys without a word (ROADMAP Queue 3)."""
        self.assert_reference()
        self.timings = {}
        t0 = time.perf_counter()
        fed: dict = {}
        out = self._run_pipeline(candidate, "candidate" if self.need_apa else None, fed)
        stem_cand, apa_cand = out.get(ItemCategory.stem), out.get(ItemCategory.aligned)
        if self.stems_mode and not stem_cand:
            raise ValueError("No stem candidate embeddings were computed")
        if self.need_apa and not apa_cand:
            raise ValueError("No apa candidate embeddings were computed")
        self.timings["pipeline"] = time.perf_counter() - t0
        self.timings.update({f"pipeline_{k}": v for k, v in fed.items()})
        t0 = time.perf_counter()
        ref, cand = self.stem_reference, stem_cand
        if self.stems_mode:
            ref, cand = self.ensure_stem_projection(ref, cand)
        if self.need_apa:
            apa_ref, apa_anti_ref, apa_cand = self.ensure_mix_projection(
                self.mix_reference, self.mix_anti_reference, apa_cand)
            if self.apa_d_x_xp is None:
                self.apa_d_x_xp = apa_compute_d_x_xp(apa_ref, apa_anti_ref)
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
            result.update(kernel_distance(cand, ref, mesh=self.mesh))
            self.timings["kd_dispatch"] = time.perf_counter() - t0
        if "prdc" in self.metrics:
            t0 = time.perf_counter()
            k = max(1, min(10, len(ref), len(cand)))
            result.update(prdc(ref, cand, k, mesh=self.mesh))
            self.timings["prdc_dispatch"] = time.perf_counter() - t0
        if "fad_inf" in self.metrics:
            t0 = time.perf_counter()
            result.update(self._fad_inf(cand, ref))
            self.timings["fad_inf_dispatch"] = time.perf_counter() - t0
        self.timings["finalize"] = time.perf_counter() - t_tail
        if self.need_apa:
            t0 = time.perf_counter()
            result["apa"] = apa(apa_cand, apa_ref, apa_anti_ref, self.apa_d_x_xp)
            self.timings["apa"] = time.perf_counter() - t0
        return result

    @staticmethod
    def _fad_inf(cand: AudioMetricsData, ref: AudioMetricsData) -> dict:
        try:
            arrays, reduce_fn = fad_inf_parts(cand, ref)
        except FadInfUnavailable as exc:
            warnings.warn(f"fad_inf and fad_inf_slope are nan: {exc}")
            return {"fad_inf": math.nan, "fad_inf_slope": math.nan}
        return reduce_fn(tuple(a.double().cpu().numpy() for a in arrays))

    def assert_reference(self) -> None:
        """Raise ``ValueError`` when a reference set the metrics need is
        empty (audio_metrics_tpu/audio_metrics.py:501-514)."""
        if (self.stems_mode and not self.stem_reference) or (
                self.need_apa and not self.mix_reference):
            raise ValueError(
                "The reference dataset is empty. This can have various causes:"
                "  - You have not called AudioMetrics.add_reference()"
                "  - You have called AudioMetrics.add_reference() with an empty dataset"
                f"  - The duration of your audio is shorter than `win_dur` ({self.win_dur}s)."
                "    (You can specify your own `win_dur` when instantiating AudioMetrics)"
            )

    # -- persistence (audio_metrics_tpu/audio_metrics.py:517-548) -----------
    def save_state(self, fp: str | Path) -> None:
        """Write the references, their projected caches, ``apa_d_x_xp`` and
        the projections to an ``.npz`` file in the JAX package's layout,
        which either package loads."""
        state = {
            "win_dur": self.win_dur,
            "hop_dur": self.hop_dur,
            "input_sr": self.input_sr,
            "batch_size": self.batch_size,
            "metrics": list(self.metrics),
            "apa_d_x_xp": self.apa_d_x_xp,
        }
        for attr in _AMD:
            item = getattr(self, attr, None)
            state[attr] = item.serialize() if item else None
        for attr in ("stem_projection", "mix_projection"):
            proj = getattr(self, attr)
            state[attr] = None if proj is None else proj.__getstate__()
        save_state_dict(state, fp)

    def load_state(self, fp: str | Path) -> None:
        """Restore the references and their projected caches (embeddings and
        radii on the mesh's first device), the projections' fits (when this
        instance has ``n_pca``, as in the JAX package), ``apa_d_x_xp``, and
        ``win_dur``, ``hop_dur``, ``input_sr``, ``batch_size`` from a state
        file of either package.  The instance keeps its own ``metrics``, as
        the JAX package's ``load_state`` does (its :546)."""
        state = load_state_dict(fp)
        for attr in _AMD:
            item = state.get(attr)
            if item is not None and item.get("n") is not None:
                setattr(self, attr, AudioMetricsData.deserialize(item, device=self.mesh.home))
            elif item is not None:
                setattr(self, attr, AudioMetricsData(item.get("store_embeddings", True)))
        for attr in ("stem_projection", "mix_projection"):
            if state.get(attr) is not None and getattr(self, attr) is not None:
                getattr(self, attr).__setstate__(state[attr])
        for key in ("win_dur", "hop_dur", "input_sr", "batch_size", "apa_d_x_xp"):
            if key in state:
                setattr(self, key, state[key])
