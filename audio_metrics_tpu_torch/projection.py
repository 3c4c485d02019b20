"""Incremental PCA projection.

The port's copy of ``audio_metrics_tpu/projection.py`` (Ross et al.'s
incremental SVD update, sklearn's ``partial_fit`` math and its
``svd_flip(u_based_decision=False)`` signs).  The fit runs on the host in
float64, once per reference set.  ``transform``, the per-evaluate step,
runs ``(X - mean) @ components^T`` on the input's device in f32 from 4096
rows up, and in numpy float64 below; either way it returns an f32 tensor on
the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.precision import full_f32

__all__ = ["IncrementalPCA"]

# the device transform pays off only past this many rows
_DEVICE_TRANSFORM_MIN_ROWS = 4096


def _as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _svd_flip_vt(u: np.ndarray, vt: np.ndarray):
    """Deterministic SVD signs based on rows of vt (sklearn svd_flip,
    u_based_decision=False)."""
    max_abs_rows = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), max_abs_rows])
    signs[signs == 0] = 1.0
    return u * signs[np.newaxis, :], vt * signs[:, np.newaxis]


class IncrementalPCA:
    def __init__(self, n_components: int | None = None, whiten: bool = False):
        self.n_components = n_components
        self.whiten = whiten

    def _is_fitted(self) -> bool:
        return getattr(self, "components_", None) is not None

    def partial_fit(self, X) -> "IncrementalPCA":
        X = _as_numpy(X).astype(np.float64, copy=True)
        if X.ndim != 2:
            raise ValueError("X must be 2-D")
        n_samples, n_features = X.shape

        first_pass = not self._is_fitted()
        if self.n_components is None:
            n_components = min(n_samples, n_features) if first_pass else self.components_.shape[0]
        else:
            if self.n_components > n_features:
                raise ValueError(f"n_components={self.n_components} invalid for "
                                 f"n_features={n_features}")
            if first_pass and self.n_components > n_samples:
                raise ValueError(f"n_components={self.n_components} must be <= batch size "
                                 f"{n_samples} for the first partial_fit call.")
            n_components = self.n_components
        self.n_components_ = n_components

        if first_pass:
            self.n_samples_seen_ = 0
            self.mean_ = np.zeros(n_features)
            self.var_ = np.zeros(n_features)

        # incremental mean / variance (Chan, Golub, LeVeque)
        last_count = float(self.n_samples_seen_)
        last_sum = self.mean_ * last_count
        new_sum = X.sum(axis=0)
        new_count = float(n_samples)
        total_count = last_count + new_count
        col_mean = (last_sum + new_sum) / total_count

        temp = X - new_sum / new_count
        correction = temp.sum(axis=0)
        new_unnorm_var = (temp**2).sum(axis=0) - correction**2 / new_count
        if last_count == 0:
            updated_unnorm_var = new_unnorm_var
        else:
            last_over_new = last_count / new_count
            updated_unnorm_var = (
                self.var_ * last_count
                + new_unnorm_var
                + last_over_new / total_count * (last_sum / last_over_new - new_sum) ** 2
            )
        col_var = updated_unnorm_var / total_count

        if self.n_samples_seen_ == 0:
            X -= col_mean
        else:
            col_batch_mean = X.mean(axis=0)
            X -= col_batch_mean
            mean_correction = np.sqrt((self.n_samples_seen_ / total_count) * n_samples) * (
                self.mean_ - col_batch_mean)
            X = np.vstack((self.singular_values_.reshape((-1, 1)) * self.components_, X,
                           mean_correction))

        u, s, vt = np.linalg.svd(X, full_matrices=False)
        u, vt = _svd_flip_vt(u, vt)
        explained_variance = s**2 / (total_count - 1)
        explained_variance_ratio = s**2 / np.sum(col_var * total_count)

        self.n_samples_seen_ = int(total_count)
        self.components_ = vt[:n_components]
        self.singular_values_ = s[:n_components]
        self.mean_ = col_mean
        self.var_ = col_var
        self.explained_variance_ = explained_variance[:n_components]
        self.explained_variance_ratio_ = explained_variance_ratio[:n_components]
        if n_components not in (n_samples, n_features):
            self.noise_variance_ = float(explained_variance[n_components:].mean())
        else:
            self.noise_variance_ = 0.0
        return self

    def fit(self, X) -> "IncrementalPCA":
        return self.partial_fit(X)

    def transform(self, X) -> torch.Tensor:
        """(N, d) tensor or array -> (N, n_components) f32 tensor on ``X``'s
        device (the CPU for an array)."""
        if not self._is_fitted():
            raise RuntimeError("IncrementalPCA is not fitted")
        x = torch.as_tensor(X)
        if x.shape[0] >= _DEVICE_TRANSFORM_MIN_ROWS:
            mean = torch.as_tensor(self.mean_, dtype=torch.float32, device=x.device)
            comp = torch.as_tensor(self.components_, dtype=torch.float32, device=x.device)
            with full_f32():
                out = (x.float() - mean) @ comp.T
            if self.whiten:
                out = out / torch.sqrt(torch.as_tensor(self.explained_variance_,
                                                       dtype=torch.float32, device=x.device))
            return out
        out = (_as_numpy(x).astype(np.float64) - self.mean_) @ self.components_.T
        if self.whiten:
            out = out / np.sqrt(self.explained_variance_)
        return torch.from_numpy(out.astype(np.float32)).to(x.device)

    # -- serialization (the JAX package's state layout) ------------------
    _state_arrays = ("components_", "mean_", "var_", "singular_values_", "explained_variance_",
                     "explained_variance_ratio_")
    _state_scalars = ("n_components", "n_components_", "n_samples_seen_", "noise_variance_",
                      "whiten")

    def __getstate__(self) -> dict:
        state = {k: np.asarray(getattr(self, k)) for k in self._state_arrays if hasattr(self, k)}
        state.update({k: getattr(self, k) for k in self._state_scalars if hasattr(self, k)})
        return state

    def __setstate__(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, np.asarray(v, dtype=np.float64) if k in self._state_arrays else v)
