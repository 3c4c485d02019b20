"""Fixed-length windows of device-resident audio.

Counterpart of ``audio_metrics_tpu/ops/windowing.py`` (``window_length``)
and ``parallel/pipeline.py::_device_windows`` and ``_device_windows_pair``
(:459-489): windows at a fixed hop, a partial trailing window dropped,
item-major order.
"""

from __future__ import annotations

import torch

__all__ = ["window_length", "device_windows"]


def window_length(sr: int | float, win_dur: float) -> int:
    return int(sr * win_dur)


def device_windows(waveforms: torch.Tensor, win_len: int, hop_len: int):
    """(N, n_samples) -> (N*k, win_len) windows (views where possible), or
    None when the items are shorter than one window; (N, n_samples, C)
    context+stem pairs -> (N*k, win_len, C) likewise (the JAX package's
    ``_device_windows_pair``)."""
    n = waveforms.shape[1]
    if n < win_len:
        return None
    if n == win_len:
        return waveforms
    k = (n - win_len) // hop_len + 1
    rest = waveforms.shape[2:]
    if hop_len == win_len:
        return waveforms[:, : k * win_len].reshape(-1, win_len, *rest)
    w = waveforms.unfold(1, win_len, hop_len)[:, :k]  # (N, k, *rest, win_len)
    return w.movedim(-1, 2).reshape(-1, win_len, *rest)
