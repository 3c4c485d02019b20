"""Fixed-length windows of audio, on the host and on the device.

Counterpart of ``audio_metrics_tpu/ops/windowing.py`` (the host slicers,
:23-48, which feed the host-fed pipeline) and ``parallel/pipeline.py::
_device_windows`` and ``_device_windows_pair`` (:459-489): windows at a
fixed hop, a partial trailing window dropped, item-major order.
"""

from __future__ import annotations

import torch

__all__ = ["audio_slicer", "device_windows", "multi_audio_slicer", "slice_windows",
           "window_length"]


def window_length(sr: int | float, win_dur: float) -> int:
    return int(sr * win_dur)


def slice_windows(audio, win_len: int, hop_len: int):
    """Yield ``win_len``-sample views of ``audio`` (any sliceable, along its
    first axis) every ``hop_len`` samples; a trailing segment shorter than
    ``win_len`` is never yielded."""
    end = len(audio) - win_len
    start = 0
    while start <= end:
        yield audio[start : start + win_len]
        start += hop_len


def audio_slicer(item, win_dur, sr, hop_dur=None, drop_last=True):
    """The windows of one song.  With ``drop_last=False`` a song shorter
    than a window yields itself whole (the window shrinks to the song), a
    quirk of the reference that the JAX package keeps."""
    win_len = window_length(sr, win_dur)
    if not drop_last:
        win_len = min(win_len, len(item))
    hop_len = win_len if hop_dur is None else window_length(sr, hop_dur)
    return slice_windows(item, win_len, hop_len)


def multi_audio_slicer(items, win_dur, sr, hop_dur=None, drop_last=True):
    """The windows of each song of ``items`` in turn."""
    for item in items:
        yield from audio_slicer(item, win_dur, sr, hop_dur, drop_last)


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
