"""Streaming statistics of embedding distributions.

Counterpart of ``audio_metrics_tpu/data.py``.  Host statistics (mean,
covariance) are float64 numpy, as in the reference; per-batch moments are
computed on the device in f32 with the CENTERED second moment (a raw x^T x
in f32 cancels against n mu mu^T when |mean| >> std).  Embeddings and the
PRDC k-NN radii stay on the device as tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["AudioMetricsData", "batch_moments"]


def batch_moments(e: torch.Tensor, mask: torch.Tensor | None = None):
    """``(n, sum_x, sum (x-mu)(x-mu)^T)`` over the (masked) rows, f32
    (audio_metrics_tpu/data.py:45-88)."""
    e = e.float()
    if mask is None:
        n = torch.tensor(float(e.shape[0]), device=e.device)
        s1 = e.sum(dim=0)
        c = e - s1 / max(e.shape[0], 1)
    else:
        m = mask.float()
        n = m.sum()
        s1 = (e * m[:, None]).sum(dim=0)
        c = (e - s1 / torch.clamp(n, min=1.0)) * m[:, None]
    return n, s1, c.T @ c


class AudioMetricsData:
    """Mean / covariance (f64, host), the embeddings (device) and their
    PRDC k-NN radii (device, ``radii["radii_{k}"]``) of one category.
    Moments from the embed loop arrive as device tensors and are merged into
    the host stats on first read (``_pending``).

    Unlike the JAX package, whose ``__iadd__`` keeps radii computed before
    the merge (so a second reference batch reuses the first batch's radii),
    every change of the embeddings here drops the cached radii: ``add_embeddings``,
    ``__iadd__`` and ``recompute_stats``."""

    def __init__(self, store_embeddings: bool = True):
        self.mean: np.ndarray | None = None
        self.cov: np.ndarray | None = None
        self.n: int | None = None
        self.store_embeddings = bool(store_embeddings)
        self._chunks: list[torch.Tensor] = []
        self._emb: torch.Tensor | None = None
        self._pending: list[tuple[int, torch.Tensor, torch.Tensor]] = []
        self.cache: dict = {}  # per-object device caches (FAD Cholesky, KD Gram sums)
        self.radii: dict[str, torch.Tensor] = {}

    def __len__(self) -> int:
        """Row count, known without pulling pending device moments (the
        FAD device tail consumes them in place)."""
        return (self.n or 0) + sum(n for n, _, _ in self._pending)

    # -- stats --------------------------------------------------------
    def stats(self):
        """(mean, cov, n) with pending device moments merged."""
        self._flush()
        return self.mean, self.cov, self.n

    def add_moments_device(self, n: int, s1: torch.Tensor, m2: torch.Tensor) -> None:
        """Queue a device moment triple; ``n`` is host-known."""
        if n > 0:
            self._pending.append((int(n), s1, m2))

    def _flush(self) -> None:
        pending, self._pending = self._pending, []
        for n, s1, m2 in pending:
            self._merge(n, s1.double().cpu().numpy(), m2.double().cpu().numpy())

    def _merge(self, n: int, s1: np.ndarray, m2: np.ndarray) -> None:
        mean = s1 / n
        cov = np.zeros_like(m2) if n == 1 else m2 / (n - 1)
        self._update_stats(mean, cov, n)

    def _update_stats(self, mean, cov, n: int) -> None:
        """Chan merge of (mean, cov, n) pairs (reference data.py:77-94)."""
        if self.n is None:
            self.mean, self.cov, self.n = mean.astype(np.float64), cov.astype(np.float64), n
            return
        n_total = self.n + n
        diff = self.mean - mean
        self.cov = (
            (self.n - 1) / (n_total - 1) * self.cov
            + (n - 1) / (n_total - 1) * cov
            + (self.n * n / n_total) / (n_total - 1) * np.outer(diff, diff)
        )
        self.mean = (self.n * self.mean + n * mean) / n_total
        self.n = n_total

    def recompute_stats(self) -> None:
        """Exact stats from the stored embeddings: centered f32 moments on the
        device, f64 finals on the host (audio_metrics_tpu/data.py:431-469)."""
        e = self.embeddings
        if e is None:
            return
        self._pending = []
        self.radii = {}
        n, s1, m2 = batch_moments(e)
        self.mean, self.cov, self.n = None, None, None
        self._merge(int(e.shape[0]), s1.double().cpu().numpy(), m2.double().cpu().numpy())

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

    def __iadd__(self, other: "AudioMetricsData") -> "AudioMetricsData":
        mean, cov, n = other.stats()
        if n is None:
            return self
        self._flush()
        self._update_stats(mean, cov, n)
        if self.store_embeddings:
            self._chunks.extend(other._chunks)
            self._emb = None
        self.radii = {}
        return self

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
    def deserialize(cls, state: dict, device="cpu") -> "AudioMetricsData":
        """Inverse of :meth:`serialize`; embeddings and radii come back as
        f32 tensors on ``device``.  Radii of another length than the stored
        embeddings are dropped (the next PRDC recomputes them): the JAX
        package's ``__iadd__`` keeps radii from before its reference grew
        (its data.py:513-528), and its ``save_state`` writes them."""
        self = cls(store_embeddings=state.get("store_embeddings", True))
        n = state.get("n")
        self.mean, self.cov = state.get("mean"), state.get("cov")
        self.n = None if n is None else int(n)
        emb = state.get("embeddings")
        rows = 0
        if emb is not None:
            self._chunks = [torch.as_tensor(np.asarray(emb, np.float32), device=device)]
            rows = self._chunks[0].shape[0]
        self.radii = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                      for k, v in (state.get("radii") or {}).items() if len(v) == rows}
        return self
