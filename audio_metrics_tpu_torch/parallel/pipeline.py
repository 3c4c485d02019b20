"""The embedding pipeline, device-resident stems.

Counterpart of the device-resident stems branch of
``audio_metrics_tpu/parallel/pipeline.py::embedding_pipeline`` (:822-843)
and its fused embed loop (:222-283, :400-458).  The JAX package compiles
the whole batch loop into one program; PyTorch runs eagerly, so the loop is
a Python loop over batches that keeps the same carry: the f32 Chan merge of
centered moments on the device, and embeddings written into one
preallocated buffer.

Input forms other than a 2-D array of mono stems (pairs for APA, iterables
of songs for the host-fed path) and resampling are not ported yet.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch

from ..data import AudioMetricsData, batch_moments
from ..ops.windowing import device_windows, window_length

__all__ = ["ItemCategory", "embedding_pipeline"]


class ItemCategory(IntEnum):
    """Window categories (reference embed.py:18-21)."""

    aligned = 1
    misaligned = 2
    stem = 3


@torch.no_grad()
def fused_embed_loop(embed, windows: torch.Tensor, batch_size: int):
    """Embed (N, win_len) windows batch by batch.  Returns the (N, d) f32
    embedding buffer and the (n, s1, m2) f32 moments, merged batch by batch
    with the Chan update of centered second moments."""
    n_total = windows.shape[0]
    buf = n_a = s1_a = m2_a = None
    for start in range(0, n_total, batch_size):
        emb = embed(windows[start : start + batch_size]).float()
        n, s1, m2 = batch_moments(emb)
        if buf is None:
            buf = torch.empty((n_total, emb.shape[1]), dtype=torch.float32, device=emb.device)
            n_a, s1_a, m2_a = n, s1, m2
        else:
            n_t = n_a + n
            dm = s1 / n - s1_a / n_a
            m2_a = m2_a + m2 + (n_a * n / n_t) * torch.outer(dm, dm)
            n_a, s1_a = n_t, s1_a + s1
        buf[start : start + emb.shape[0]] = emb
    return buf, (n_a, s1_a, m2_a)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1); the port takes a 2-D "
        "(items, samples) tensor of mono stems at the embedder's sample rate"
    )


def embedding_pipeline(
    waveforms,
    embedder,
    stems_mode: bool = True,
    apa_mode=None,
    store_stem_embeddings: bool = False,
    batch_size: int = 32,
    win_dur: float = 5.0,
    input_sr: int | None = None,
) -> dict:
    """Embed device-resident stems and accumulate their statistics.

    ``waveforms``: a (N, n_samples) tensor or numpy array of mono stems; a
    CPU tensor or array is moved to the embedder's device.  Returns
    ``{ItemCategory.stem: AudioMetricsData}``."""
    if apa_mode is not None or not stems_mode:
        raise _not_ported("the APA (context+stem pair) path")
    if input_sr is not None and input_sr != embedder.sr:
        raise _not_ported("resampling")
    if isinstance(waveforms, np.ndarray):
        waveforms = torch.from_numpy(waveforms)
    if isinstance(waveforms, torch.Tensor) and waveforms.ndim == 3 and waveforms.shape[-1] == 2:
        raise _not_ported("the APA (context+stem pair) path")
    if not isinstance(waveforms, torch.Tensor) or waveforms.ndim != 2:
        raise _not_ported("the host-fed path (iterables of songs, stereo pairs)")
    waveforms = waveforms.to(embedder.device, torch.float32)
    win_len = window_length(embedder.sr, win_dur)
    w = device_windows(waveforms, win_len, win_len)
    amd = AudioMetricsData(store_stem_embeddings)
    if w is not None:
        buf, (n, s1, m2) = fused_embed_loop(embedder.embed, w, batch_size)
        amd.add_moments_device(w.shape[0], s1, m2)
        amd.add_embeddings(buf)
    return {ItemCategory.stem: amd}
