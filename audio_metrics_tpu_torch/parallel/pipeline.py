"""The embedding pipeline, device-resident stems.

Counterpart of the device-resident stems branch of
``audio_metrics_tpu/parallel/pipeline.py::embedding_pipeline`` (:822-843),
its fused embed loop and OOM retry (:222-283, :400-458), and its device
resampling of windows (:695, :958).  The JAX package compiles the whole
batch loop into one program; PyTorch runs eagerly, so the loop is a Python
loop over batches that keeps the same carry: the f32 Chan merge of centered
moments on the device, and embeddings written into one preallocated buffer.

Input forms other than a 2-D array of mono stems (pairs for APA, iterables
of songs for the host-fed path) are not ported yet.
"""

from __future__ import annotations

import logging
import os
from enum import IntEnum

import numpy as np
import torch

from ..data import AudioMetricsData, batch_moments
from ..ops.resample import resample_batch
from ..ops.windowing import device_windows, window_length

__all__ = ["ItemCategory", "embedding_pipeline"]

logger = logging.getLogger(__name__)


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


def run_fused_embed(embed, windows: torch.Tensor, batch_size: int):
    """``fused_embed_loop`` with the JAX package's elastic retry
    (pipeline.py:425-443): when the loop runs out of device memory
    (``torch.OutOfMemoryError``), its partial buffer and moments are
    dropped, the allocator's cache is emptied, and the whole loop runs again
    at half the batch; an OOM at a batch of 64 or less, and any other
    exception, is re-raised.  PyTorch allocates eagerly, so an OOM surfaces
    inside the loop, at the allocation that fails, and not at a later sync:
    the JAX package's retry misses an OOM that surfaces at its first
    blocking pull (ROADMAP Queue 3, "OOM retry scope"); this one cannot."""
    while True:
        try:
            return fused_embed_loop(embed, windows, batch_size)
        except torch.OutOfMemoryError:
            if batch_size <= 64:
                raise
        # out of the except block, the exception and its traceback, which
        # holds the loop's frame with its partial buffer, are released
        torch.cuda.empty_cache()
        batch_size //= 2
        logger.warning("fused embed loop exhausted device memory; retrying at batch_size=%d",
                       batch_size)


def embedding_pipeline(
    waveforms,
    embedder,
    stems_mode: bool = True,
    apa_mode=None,
    store_stem_embeddings: bool = False,
    batch_size: int = 32,
    win_dur: float = 5.0,
    hop_dur: float | None = None,
    input_sr: int | None = None,
    progress: bool = False,
) -> dict:
    """Embed device-resident stems and accumulate their statistics.

    ``waveforms``: a (N, n_samples) tensor or numpy array of mono stems at
    ``input_sr`` (default: the embedder's rate); a CPU tensor or array is
    moved to the embedder's device.  Windows of ``win_dur`` seconds every
    ``hop_dur`` seconds (default ``win_dur``) are cut at the input rate, in
    item-major order; with ``input_sr`` other than the embedder's rate each
    batch of windows is resampled on the device before the embedder
    (``AM_TPU_RESAMPLE_QUALITY``, "hq" or "vhq", read at each call, as in
    the JAX package).  ``progress`` does nothing here: the JAX package's
    fused device-resident path returns before its progress bar (:843,
    :926); only its resampling of device arrays, a batch loop there and the
    fused loop here, shows one.  Returns ``{ItemCategory.stem: AudioMetricsData}``."""
    if isinstance(waveforms, np.ndarray):
        waveforms = torch.from_numpy(waveforms)
    is_tensor = isinstance(waveforms, torch.Tensor)
    if (apa_mode is not None or not stems_mode
            or (is_tensor and waveforms.ndim == 3 and waveforms.shape[-1] == 2)):
        raise NotImplementedError("the APA (context+stem pair) path is not ported yet "
                                  "(ROADMAP.md Queue 1 item 5)")
    if not is_tensor or waveforms.ndim != 2:
        raise NotImplementedError(
            "the host-fed path (iterables of songs, stereo pairs) is not ported yet "
            "(ROADMAP.md Queue 1 item 8); the port takes a 2-D (items, samples) tensor of "
            "mono stems")
    waveforms = waveforms.to(embedder.device, torch.float32)
    in_sr = input_sr if input_sr is not None else embedder.sr
    win_len = window_length(in_sr, win_dur)
    hop_len = win_len if hop_dur is None else window_length(in_sr, hop_dur)
    w = device_windows(waveforms, win_len, hop_len)
    embed = embedder.embed
    if in_sr != embedder.sr:
        quality = os.environ.get("AM_TPU_RESAMPLE_QUALITY", "hq")

        def embed(x):
            return embedder.embed(resample_batch(x, in_sr, embedder.sr, quality))

    amd = AudioMetricsData(store_stem_embeddings)
    if w is not None:
        buf, (n, s1, m2) = run_fused_embed(embed, w, batch_size)
        amd.add_moments_device(w.shape[0], s1, m2)
        amd.add_embeddings(buf)
    return {ItemCategory.stem: amd}
