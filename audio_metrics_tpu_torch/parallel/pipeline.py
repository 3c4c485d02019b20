"""The embedding pipeline, device-resident audio.

Counterpart of the device-resident branches of
``audio_metrics_tpu/parallel/pipeline.py::embedding_pipeline``: mono stems
(:822-843) and context+stem pairs for APA (``_device_pair_eval``,
:492-578), its fused embed loop and OOM retry (:222-283, :400-458), and
its device resampling of windows (:695, :958).  The JAX package compiles
the whole batch loop into one program; PyTorch runs eagerly, so the loop is
a Python loop over batches that keeps the same carry: the f32 Chan merge of
centered moments on the device, and embeddings written into one
preallocated buffer.

Iterables of songs (the host-fed path) are not ported yet.
"""

from __future__ import annotations

import logging
import os
from enum import IntEnum

import numpy as np
import torch

from ..data import AudioMetricsData, batch_moments
from ..ops.resample import resample_batch
from ..ops.mix import emit_mix_diagnostics
from ..ops.windowing import device_windows, window_length

__all__ = ["ItemCategory", "derangement", "device_mix", "device_pair_eval", "embedding_pipeline"]

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


def _resampler(in_sr: int, sr: int):
    """Batches of windows, (B, n) or (B, n, C), resampled from ``in_sr`` to
    ``sr`` on their device (``AM_TPU_RESAMPLE_QUALITY``, "hq" or "vhq",
    read at each pipeline call, as in the JAX package); the identity when
    the rates agree."""
    if in_sr == sr:
        return lambda x: x
    quality = os.environ.get("AM_TPU_RESAMPLE_QUALITY", "hq")
    return lambda x: resample_batch(x, in_sr, sr, quality)


def _embed_set(embed, windows: torch.Tensor, batch_size: int, store: bool) -> AudioMetricsData:
    """One category's windows through ``run_fused_embed``: their moments
    (on the device until read) and, when ``store``, their embeddings."""
    amd = AudioMetricsData(store)
    buf, (_, s1, m2) = run_fused_embed(embed, windows, batch_size)
    amd.add_moments_device(windows.shape[0], s1, m2)
    amd.add_embeddings(buf)
    return amd


def derangement(n: int, seed=None) -> np.ndarray:
    """A permutation of ``range(n)`` with no fixed point (for n > 1), drawn
    call for call as the JAX package draws it (pipeline.py:559-569), so that
    the same ``seed`` pairs the same windows in both packages: a conjugated
    nonzero cyclic shift, ``pairing[p[k]] = p[(k + s) % n]``.  A plain
    permutation has about one fixed point, which would leak an aligned pair
    into the misaligned set."""
    rng = np.random.default_rng(seed)
    if n <= 1:
        return np.zeros(1, np.int64)  # degenerate: the window with itself
    p = rng.permutation(n)
    s = int(rng.integers(1, n))
    out = np.empty(n, np.int64)
    out[p] = np.roll(p, -s)
    return out


def device_mix(mix_function, audio: torch.Tensor, sr: int, diag=None) -> torch.Tensor:
    """A mix of a (B, n, 2) batch (audio_metrics_tpu/parallel/pipeline.py:
    678-692): a registry mix (``is_batched_mix``) on the batch's device,
    its flags collected in ``diag``; any other callable follows the
    reference protocol ``f(audio[n, 2], sr) -> mono[n]``, one item at a
    time on the host, its mixes taken back to the batch's device."""
    if getattr(mix_function, "is_batched_mix", False):
        return mix_function(audio, sr=sr, diag=diag)
    out = [np.asarray(torch.as_tensor(mix_function(a, sr=sr)).cpu(), np.float32)
           for a in audio.cpu().numpy()]
    return torch.from_numpy(np.stack(out)).to(audio.device)


def device_pair_eval(w: torch.Tensor, embedder, mix_function, in_sr: int, apa_mode,
                     stems_mode: bool, batch_size: int, seed, store_mix: bool,
                     store_stem: bool) -> dict:
    """(N*k, win, 2) pair windows at ``in_sr`` -> per-category
    ``AudioMetricsData`` (audio_metrics_tpu/parallel/pipeline.py:492-578).
    Each set is mixed whole, in chunks of 64 pairs for registry mixes (16
    for callables, which run on the host), each chunk resampled to the
    embedder's rate first when ``in_sr`` is not it, then embedded through
    the fused loop: the aligned pairs; for ``apa_mode="reference"`` the
    misaligned ones, each context with the stem of window
    ``derangement(N*k, seed)[i]``; with ``stems_mode`` the stems (channel
    1).  The mix flags are read and warned about once, at the end."""
    n_w = w.shape[0]
    sr = embedder.sr
    resample = _resampler(in_sr, sr)
    chunk = 64 if getattr(mix_function, "is_batched_mix", False) else 16
    mix_diag: list = []

    def mix_all(pairs_at):
        outs = []
        for i in range(0, n_w, chunk):
            pairs = resample(pairs_at(i, min(chunk, n_w - i)))
            outs.append(device_mix(mix_function, pairs, sr, diag=mix_diag))
        return torch.cat(outs)

    out = {ItemCategory.aligned: _embed_set(embedder.embed, mix_all(lambda i, c: w[i : i + c]),
                                            batch_size, store_mix)}
    if apa_mode == "reference":
        perm = torch.from_numpy(derangement(n_w, seed)).to(w.device)

        def mis_at(i, c):
            return torch.stack([w[i : i + c, :, 0], w[perm[i : i + c], :, 1]], dim=2)

        out[ItemCategory.misaligned] = _embed_set(embedder.embed, mix_all(mis_at), batch_size,
                                                  store_mix)
    if stems_mode:
        out[ItemCategory.stem] = _embed_set(lambda x: embedder.embed(resample(x)),
                                            w[:, :, 1].contiguous(), batch_size, store_stem)
    emit_mix_diagnostics(mix_diag)
    return out


def embedding_pipeline(
    waveforms,
    embedder,
    mix_function=None,
    apa_mode=None,
    stems_mode: bool = True,
    store_mix_embeddings: bool = False,
    store_stem_embeddings: bool = False,
    batch_size: int = 32,
    win_dur: float = 5.0,
    hop_dur: float | None = None,
    seed: int | None = None,
    input_sr: int | None = None,
    progress: bool = False,
) -> dict:
    """Embed device-resident audio and accumulate per-category statistics
    (audio_metrics_tpu/parallel/pipeline.py:744-843, its device-resident
    branches).

    ``waveforms``: a tensor or numpy array at ``input_sr`` (default: the
    embedder's rate), moved to the embedder's device: (N, n_samples) mono
    stems, or (N, n_samples, 2) context+stem pairs.  Windows of ``win_dur``
    seconds every ``hop_dur`` seconds (default ``win_dur``) are cut at the
    input rate, in item-major order; with ``input_sr`` other than the
    embedder's rate each batch is resampled on the device
    (``AM_TPU_RESAMPLE_QUALITY``, "hq" or "vhq", read at each call).
    ``apa_mode`` ("reference", "candidate" or None) asks for the mixes of
    the pairs through ``mix_function`` (``device_pair_eval``; ``seed``
    draws the misaligned pairing); without it, pairs yield the stems of
    channel 1, as the JAX package's ``serialize_items`` does.  ``progress``
    does nothing here: the JAX package's device-resident paths return
    before its progress bar (:843, :926).  Returns ``{ItemCategory:
    AudioMetricsData}``."""
    if isinstance(waveforms, np.ndarray):
        waveforms = torch.from_numpy(waveforms)
    pairs = isinstance(waveforms, torch.Tensor) and waveforms.ndim == 3
    if not isinstance(waveforms, torch.Tensor) or waveforms.ndim not in (2, 3) or (
            pairs and waveforms.shape[-1] != 2):
        raise NotImplementedError(
            "the host-fed path (iterables of songs) is not ported yet (ROADMAP.md Queue 1 "
            "item 8); the port takes a (items, samples) tensor of mono stems or an (items, "
            "samples, 2) tensor of context+stem pairs")
    if apa_mode is not None and not pairs:
        raise ValueError("When computing APA items should be tensors/arrays of shape "
                         "[n_samples, 2] (pairing context and stem)")
    waveforms = waveforms.to(embedder.device, torch.float32)
    in_sr = input_sr if input_sr is not None else embedder.sr
    win_len = window_length(in_sr, win_dur)
    hop_len = win_len if hop_dur is None else window_length(in_sr, hop_dur)
    w = device_windows(waveforms, win_len, hop_len)
    if apa_mode is not None:
        if w is None:
            return {}
        return device_pair_eval(w, embedder, mix_function, in_sr, apa_mode, stems_mode,
                                batch_size, seed, store_mix_embeddings, store_stem_embeddings)
    if not stems_mode:
        return {}
    if w is None:
        return {ItemCategory.stem: AudioMetricsData(store_stem_embeddings)}
    if pairs:
        w = w[:, :, 1].contiguous()
    resample = _resampler(in_sr, embedder.sr)
    return {ItemCategory.stem: _embed_set(lambda x: embedder.embed(resample(x)), w, batch_size,
                                          store_stem_embeddings)}
