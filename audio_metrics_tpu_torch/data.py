"""Streaming statistics of embedding distributions.

Counterpart of ``audio_metrics_tpu/data.py``.  Host statistics (mean,
covariance) are float64 numpy, as in the reference; per-batch moments are
computed on the device in f32 with the CENTERED second moment (a raw x^T x
in f32 cancels against n mu mu^T when |mean| >> std).  Embeddings and the
PRDC k-NN radii stay on the device as tensors.  ``AudioMetricsData`` is
also a user's accumulator, as in the JAX package (exported at the top
level): ``add`` takes numpy or array-like rows as well as tensors, ``+`` and
``+=`` merge two of them.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .models.base import resolve_device

__all__ = ["AudioMetricsData", "as_rows", "batch_moments", "ensure_ndarray",
           "flush_pending_stats", "pull"]


def ensure_ndarray(x) -> np.ndarray:
    """``x`` as a numpy array (audio_metrics_tpu/data.py:30-42): numpy
    arrays as they are, torch tensors detached and copied to the host from
    any device, other array-likes through ``np.asarray``."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_rows(x, device) -> torch.Tensor:
    """Rows as f32: a tensor on its own device; numpy arrays and
    array-likes on ``device`` (raises when it names a card and there is
    none)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def batch_moments(e: torch.Tensor, mask: torch.Tensor | None = None):
    """``(n, sum_x, sum (x-mu)(x-mu)^T)`` over the (masked) rows, f32
    (audio_metrics_tpu/data.py:45-88).  Without a mask ``n`` is the row
    count, filled in on the device: nothing waits for the device's
    stream."""
    e = e.float()
    if mask is None:
        n = torch.full((), float(e.shape[0]), device=e.device)
        s1 = e.sum(dim=0)
        c = e - s1 / max(e.shape[0], 1)
    else:
        m = mask.float()
        n = m.sum()
        s1 = (e * m[:, None]).sum(dim=0)
        c = (e - s1 / torch.clamp(n, min=1.0)) * m[:, None]
    return n, s1, c.T @ c


def pull(tensors) -> list[np.ndarray]:
    """Host copies of ``tensors``, numpy arrays equal to each tensor's
    ``.cpu().numpy()``, after ONE wait for the card: each card tensor is
    copied without a wait into pinned host memory on its card's current
    stream, then that stream is synchronized once (once a card, where the
    tensors lie on several).  The counterpart of the JAX package's one
    ``jax.device_get`` of a tuple of arrays; CPU tensors come back as
    ``.numpy()`` views, as ``.cpu().numpy()`` gives them."""
    tensors = [t.detach() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if t.is_cuda else t
            for t in tensors]
    for h, t in zip(host, tensors):
        if t.is_cuda:
            h.copy_(t, non_blocking=True)
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in host]


def flush_pending_stats(amds, extra=None):
    """Merge the pending device moments of several accumulators into their
    host stats, in arrival order, with ONE pull (audio_metrics_tpu/
    data.py:155-194) that also carries ``extra``, a sequence of tensors
    (the FAD device tail's under ``AM_TPU_FAD_TAIL=packed``); returns their
    host copies (``pull``), or None without ``extra``.  Each accumulator's
    lock is held from taking its triples to merging them, so a reader on
    another thread sees the stats before or after, never between.  The
    packed-triangle pull of the JAX package (its :89-152) is not ported."""
    amds = list({id(a): a for a in amds if a is not None}.values())
    with contextlib.ExitStack() as stack:
        for a in sorted(amds, key=id):  # one order for every caller: no deadlock
            stack.enter_context(a._pending_lock)
        taken = [(a, a._pending) for a in amds if a._pending]
        if not taken and extra is None:
            return None
        moments = [t for _, pending in taken for _, s1, m2 in pending for t in (s1, m2)]
        host = pull(moments + ([] if extra is None else list(extra)))
        i = 0
        for a, pending in taken:
            a._pending = []
            for n, _, _ in pending:
                a._merge(n, host[i].astype(np.float64), host[i + 1].astype(np.float64))
                i += 2
        return None if extra is None else host[i:]


class AudioMetricsData:
    """Mean / covariance (f64, host), the embeddings (device) and their
    PRDC k-NN radii (device, ``radii["radii_{k}"]``) of one category
    (audio_metrics_tpu/data.py:196-562, the reference's data.py:18-113).
    Moments from the embed loop arrive as device tensors and are merged into
    the host stats when ``mean``, ``cov`` or ``stats()`` is read
    (``_pending``, under ``_pending_lock``: the evaluate's FAD thread reads
    stats; ``flush_pending_stats``); ``n`` counts them without a pull.

    ``device``: where rows given as numpy or array-likes are stored (to
    ``add``, ``add_moments``, the ``embeddings`` setter); resolved only when
    such rows arrive, so that an accumulator fed tensors never asks for a
    card.  Tensors stay on their own device.

    Unlike the JAX package, whose ``__iadd__`` keeps radii computed before
    the merge (so a second reference batch reuses the first batch's radii),
    every change of the embeddings here drops the cached radii: ``add_embeddings``,
    ``__iadd__``, the ``embeddings`` setter and ``recompute_stats``."""

    def __init__(self, store_embeddings: bool = True, device="cuda"):
        self._mean: np.ndarray | None = None
        self._cov: np.ndarray | None = None
        self._n: int | None = None
        self.store_embeddings = bool(store_embeddings)
        self.device = device
        self._chunks: list[torch.Tensor] = []
        self._emb: torch.Tensor | None = None
        self._pending: list[tuple[int, torch.Tensor, torch.Tensor]] = []
        self._pending_lock = threading.RLock()
        self.cache: dict = {}  # per-object device caches (FAD Cholesky, KD Gram sums)
        self.radii: dict[str, torch.Tensor] = {}

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_pending_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._pending_lock = threading.RLock()

    def __len__(self) -> int:
        """Row count, known without pulling pending device moments (the
        FAD device tail consumes them in place)."""
        return self.n or 0

    @property
    def mean(self) -> np.ndarray | None:
        self._flush()
        return self._mean

    @mean.setter
    def mean(self, value) -> None:
        self._mean = value

    @property
    def cov(self) -> np.ndarray | None:
        self._flush()
        return self._cov

    @cov.setter
    def cov(self, value) -> None:
        self._cov = value

    @property
    def n(self) -> int | None:
        """Rows accumulated, pending device moments counted without a pull
        (their counts are host integers); None before any."""
        with self._pending_lock:
            if self._n is None and not self._pending:
                return None
            return (self._n or 0) + sum(n for n, _, _ in self._pending)

    @n.setter
    def n(self, value) -> None:
        self._n = value

    # -- stats --------------------------------------------------------
    def stats(self):
        """(mean, cov, n) with pending device moments merged."""
        self._flush()
        return self._mean, self._cov, self._n

    def add_moments_device(self, n: int, s1: torch.Tensor, m2: torch.Tensor) -> None:
        """Queue a device moment triple; ``n`` is host-known."""
        if n > 0:
            with self._pending_lock:
                self._pending.append((int(n), s1, m2))

    def add_moments(self, n, s1, m2, embeddings=None) -> None:
        """Merge moments ``(n, sum_x, centered sum)`` (numpy or tensors of
        any float dtype; merged in float64 on the host) into the stats now,
        and store ``embeddings``, the rows they were taken over, when
        ``store_embeddings`` (audio_metrics_tpu/data.py:296-315); the
        host-fed pipeline's one pull per run."""
        self._flush()
        n = int(round(float(n)))
        if n <= 0:
            return
        self._merge(n, ensure_ndarray(s1).astype(np.float64),
                    ensure_ndarray(m2).astype(np.float64))
        if self.store_embeddings and embeddings is not None:
            self.add_embeddings(as_rows(embeddings, self.device))

    def _flush(self) -> None:
        flush_pending_stats([self])

    def _merge(self, n: int, s1: np.ndarray, m2: np.ndarray) -> None:
        mean = s1 / n
        cov = np.zeros_like(m2) if n == 1 else m2 / (n - 1)
        self._update_stats(mean, cov, n)

    def _update_stats(self, mean, cov, n: int) -> None:
        """Chan merge of (mean, cov, n) pairs (reference data.py:77-94), on
        the host stats with nothing pending."""
        if self._n is None:
            self._mean, self._cov, self._n = mean.astype(np.float64), cov.astype(np.float64), n
            return
        n_self, n_total = self._n, self._n + n
        diff = self._mean - mean
        self._cov = (
            (n_self - 1) / (n_total - 1) * self._cov
            + (n - 1) / (n_total - 1) * cov
            + (n_self * n / n_total) / (n_total - 1) * np.outer(diff, diff)
        )
        self._mean = (n_self * self._mean + n * mean) / n_total
        self._n = n_total

    def recompute_stats(self) -> None:
        """Exact stats from the stored embeddings: centered f32 moments on the
        device, f64 finals on the host (audio_metrics_tpu/data.py:431-469)."""
        e = self.embeddings
        if e is None:
            return
        with self._pending_lock:
            self._pending = []
        self.radii = {}
        n, s1, m2 = batch_moments(e)
        self._mean, self._cov, self._n = None, None, None
        s1, m2 = pull((s1, m2))
        self._merge(int(e.shape[0]), s1.astype(np.float64), m2.astype(np.float64))

    def chol_cov(self) -> np.ndarray | None:
        """f64 Cholesky factor of ``cov`` (cached by array identity), or None
        when ``cov`` is absent or not positive definite."""
        _, cov, _ = self.stats()
        if cov is None:
            return None
        hit = self.cache.get("chol")
        if hit is not None and hit[0] is cov:
            return hit[1]
        try:
            l = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            l = None
        self.cache["chol"] = (cov, l)
        return l

    def add(self, embeddings) -> None:
        """Accumulate a batch of embeddings, a tensor, a numpy array or an
        array-like (audio_metrics_tpu/data.py:273-294): float64 mean and
        covariance on the host, merged in arrival order; the f32 rows kept
        when ``store_embeddings``, a tensor's on its device, others on
        ``self.device``."""
        if not isinstance(embeddings, torch.Tensor):
            embeddings = np.asarray(embeddings)
        if embeddings.ndim != 2:
            raise ValueError(f"embeddings must be 2-D, got shape {tuple(embeddings.shape)}")
        n = embeddings.shape[0]
        if n == 0:
            return
        self._flush()
        if isinstance(embeddings, torch.Tensor):
            e = embeddings.double().cpu().numpy()
        else:
            e = embeddings.astype(np.float64)
        mean = e.mean(axis=0)
        c = e - mean
        cov = np.zeros((e.shape[1],) * 2) if n == 1 else c.T @ c / (n - 1)
        self._update_stats(mean, cov, n)
        if self.store_embeddings:  # rows it does not keep are never moved
            self.add_embeddings(as_rows(embeddings, self.device))

    # -- embeddings ---------------------------------------------------
    def add_embeddings(self, e: torch.Tensor) -> None:
        if self.store_embeddings:
            self._chunks.append(e)
            self._emb = None
            self.radii = {}

    @property
    def has_embeddings(self) -> bool:
        return bool(self._chunks)

    @property
    def embeddings(self) -> torch.Tensor | None:
        """Device-resident concatenation of the stored embeddings (cached;
        its identity keys the KD reference cache)."""
        if not self._chunks:
            return None
        if self._emb is None:
            self._emb = self._chunks[0] if len(self._chunks) == 1 else torch.cat(self._chunks)
        return self._emb

    @embeddings.setter
    def embeddings(self, value) -> None:
        """Replace the stored rows (the stats stay as they are; see
        ``recompute_stats``): a tensor's f32 rows on its device, others on
        ``self.device``; None drops them."""
        self._chunks = [] if value is None else [as_rows(value, self.device)]
        self._emb = None
        self.radii = {}

    def __iadd__(self, other: "AudioMetricsData") -> "AudioMetricsData":
        """Merge ``other`` in (audio_metrics_tpu/data.py:513-528): its stats
        by the Chan update, its stored rows when both store them.  An empty
        accumulator takes ``other``'s ``store_embeddings``; otherwise the
        two flags must agree (``ValueError``)."""
        if not isinstance(other, AudioMetricsData):
            raise TypeError(f"cannot add {type(other).__name__} to AudioMetricsData")
        if other.n is None:
            return self
        if self.n is None:
            self.store_embeddings = other.store_embeddings
        if self.store_embeddings != other.store_embeddings:
            raise ValueError(f"store_embeddings differ: {self.store_embeddings} here, "
                             f"{other.store_embeddings} in the set added")
        mean, cov, n = other.stats()
        self._flush()
        self._update_stats(mean, cov, n)
        if self.store_embeddings:
            self._chunks.extend(other._chunks)
            self._emb = None
        self.radii = {}
        return self

    def __add__(self, other: "AudioMetricsData") -> "AudioMetricsData":
        """A new accumulator holding both (audio_metrics_tpu/data.py:
        530-534); neither operand changes."""
        new = AudioMetricsData(device=self.device)
        new += self
        new += other
        return new

    def get_radii(self, k_neighbor: int) -> torch.Tensor | None:
        """k-NN radii of the stored embeddings, cached per k
        (audio_metrics_tpu/data.py:494-505)."""
        key = f"radii_{k_neighbor}"
        if self.radii.get(key) is None and self.has_embeddings:
            from .ops.distance import knn_radii

            self.radii[key] = knn_radii(self.embeddings.float(), k_neighbor)
        return self.radii.get(key)

    # -- persistence (audio_metrics_tpu/data.py:539-562) -----------------
    def serialize(self) -> dict:
        """The JAX package's layout: numpy arrays and plain scalars."""
        mean, cov, n = self.stats()
        e = self.embeddings
        return {
            "mean": mean,
            "cov": cov,
            "n": n,
            "store_embeddings": self.store_embeddings,
            "embeddings": None if e is None else e.float().cpu().numpy(),
            "radii": {k: v.cpu().numpy() for k, v in self.radii.items()},
        }

    @classmethod
    def deserialize(cls, state: dict, device="cuda") -> "AudioMetricsData":
        """Inverse of :meth:`serialize`; embeddings and radii come back as
        f32 tensors on ``device`` (raises when it names a card and there is
        none), which the new object keeps as its ``device``.  Radii of
        another length than the stored embeddings are dropped (the next
        PRDC recomputes them): the JAX
        package's ``__iadd__`` keeps radii from before its reference grew
        (its data.py:513-528), and its ``save_state`` writes them."""
        device = resolve_device(device)
        self = cls(store_embeddings=state.get("store_embeddings", True), device=device)
        n = state.get("n")
        self._mean, self._cov = state.get("mean"), state.get("cov")
        self._n = None if n is None else int(n)
        emb = state.get("embeddings")
        rows = 0
        if emb is not None:
            self._chunks = [torch.as_tensor(np.asarray(emb, np.float32), device=device)]
            rows = self._chunks[0].shape[0]
        self.radii = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                      for k, v in (state.get("radii") or {}).items() if len(v) == rows}
        return self
