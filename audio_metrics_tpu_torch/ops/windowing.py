"""Fixed-length windows of device-resident audio.

Counterpart of ``audio_metrics_tpu/ops/windowing.py`` (``window_length``)
and ``parallel/pipeline.py::_device_windows`` (:459-476): windows at a
fixed hop, a partial trailing window dropped, item-major order.
"""

from __future__ import annotations

import torch

__all__ = ["window_length", "device_windows"]


def window_length(sr: int | float, win_dur: float) -> int:
    return int(sr * win_dur)


def device_windows(waveforms: torch.Tensor, win_len: int, hop_len: int):
    """(N, n_samples) -> (N*k, win_len) windows (views where possible), or
    None when the items are shorter than one window."""
    n = waveforms.shape[1]
    if n < win_len:
        return None
    if n == win_len:
        return waveforms
    k = (n - win_len) // hop_len + 1
    if hop_len == win_len:
        return waveforms[:, : k * win_len].reshape(-1, win_len)
    return waveforms.unfold(1, win_len, hop_len)[:, :k].reshape(-1, win_len)
