"""The embedding pipeline: audio on the device, or songs fed from the host.

Counterpart of ``audio_metrics_tpu/parallel/pipeline.py::
embedding_pipeline``.

- Stacked audio (a 2-D or 3-D tensor or array) takes the device-resident
  branches: mono stems (:822-843) and context+stem pairs for APA
  (``_device_pair_eval``, :492-578), the fused embed loop and OOM retry
  (:222-283, :400-458), device resampling of windows (:695, :958).  The
  JAX package compiles the whole batch loop into one program; PyTorch runs
  eagerly, so the loop is a Python loop over batches that keeps the same
  carry: the f32 Chan merge of centered moments on the device, and
  embeddings written into one preallocated buffer.
- Anything else is an iterable of songs of any length, mono (n,) or
  context+stem (n, 2), the reference's own input form, and takes the
  host-fed branch (:853-1024): on the host, the song and window shuffles
  (APA reference sets), windows, categorized items and batches of one kind
  (the Python feeder, or the C++ batcher of ``native_loader``); on the
  card, each batch resampled, mixed (pairs), embedded, and its moments
  merged per category in float64 (pulled once at the end).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import warnings
from enum import IntEnum
from itertools import tee

import numpy as np
import torch

from ..data import AudioMetricsData, batch_moments, ensure_ndarray
from ..models.base import as_embedder
from ..ops.mix import emit_mix_diagnostics
from ..ops.resample import resample_batch
from ..ops.windowing import device_windows, multi_audio_slicer, window_length
from .shuffle import shuffle_stream

__all__ = ["ItemCategory", "batch_accumulator", "derangement", "device_mix", "device_pair_eval",
           "embedding_pipeline", "mix_pair", "serialize_items", "shard_blocks",
           "sharded_embed_loop"]

logger = logging.getLogger(__name__)


class ItemCategory(IntEnum):
    """Window categories (reference embed.py:18-21)."""

    aligned = 1
    misaligned = 2
    stem = 3


# ----------------------------------------------------------------------
# host-side stream stages (audio_metrics_tpu/parallel/pipeline.py:60-214)
# ----------------------------------------------------------------------
_APA_SHAPE = ("When computing APA items should be tensors/arrays of shape [n_samples, 2] "
              "(pairing context and stem)")


def serialize_items(items1, items2=None, apa_mode=False, stems_mode=False):
    """Categorized items of windows (reference embed.py:44-66): for each
    (paired) window, the aligned pair, the misaligned pair (the context of
    ``items1``'s window with the stem of ``items2``'s) and the stem (the
    last channel, or the mono window itself), as asked for."""
    item_pairs = ((item, None) for item in items1) if items2 is None else zip(items1, items2)
    for item1, item2 in item_pairs:
        item1 = ensure_ndarray(item1)
        if apa_mode:
            if item1.ndim != 2:
                raise ValueError(_APA_SHAPE)
            yield {"audio": item1, "category": ItemCategory.aligned}
            if item2 is not None:
                item2 = ensure_ndarray(item2)
                if item2.ndim != 2:
                    raise ValueError(_APA_SHAPE)
                misaligned = np.column_stack((item1[:, 0], item2[:, 1]))
                yield {"audio": misaligned, "category": ItemCategory.misaligned}
        if stems_mode:
            stem = item1[:, -1] if item1.ndim == 2 else item1
            yield {"audio": stem, "category": ItemCategory.stem}


def mix_pair(data, mix_func, sr):
    """One item's mix (reference embed.py:86-90): stems pass through,
    context+stem pairs are mixed to mono by ``mix_func(audio, sr=sr)``."""
    if data["category"] == ItemCategory.stem:
        return {"audio": data["audio"]}
    return {"audio": ensure_ndarray(mix_func(data["audio"], sr=sr))}


def batch_accumulator(items, batch_size=32):
    """Stacked batches of items (reference embed.py:24-41), kept for the
    reference's API; the pipeline batches with ``_bucketed_batches``."""
    audio, category = [], []
    for item in items:
        audio.append(item["audio"])
        category.append(item["category"])
        if len(audio) == batch_size:
            yield {"audio": np.stack(audio), "category": np.array(category)}
            audio, category = [], []
    if audio:
        yield {"audio": np.stack(audio), "category": np.array(category)}


def _bucketed_batches(items, batch_size, pin_memory=False):
    """Categorized items grouped into batches of one kind: "pair" (aligned
    and misaligned windows, to be mixed) and "mono" (stems).  Yields
    ``(kind, audio, category[B], valid[B])`` with B = ``batch_size``:
    ``audio`` an f32 tensor of the real rows only (a partial last batch is
    not padded; the JAX package pads it on its device to its compiled
    shape), stacked straight into pinned host memory with ``pin_memory``;
    ``valid`` marks the real rows, a prefix."""

    def flush(kind, audio_list, cat_list):
        n = len(audio_list)
        audio = torch.empty((n, *np.shape(audio_list[0])), dtype=torch.float32,
                            pin_memory=pin_memory)
        np.stack(audio_list, out=audio.numpy())
        category = np.zeros(batch_size, dtype=np.int32)
        category[:n] = cat_list
        valid = np.zeros(batch_size, dtype=bool)
        valid[:n] = True
        return kind, audio, category, valid

    buckets = {"pair": ([], []), "mono": ([], [])}
    for item in items:
        kind = "mono" if item["category"] == ItemCategory.stem else "pair"
        audio_list, cat_list = buckets[kind]
        audio_list.append(item["audio"])
        cat_list.append(int(item["category"]))
        if len(audio_list) == batch_size:
            yield flush(kind, audio_list, cat_list)
            buckets[kind] = ([], [])
    for kind, (audio_list, cat_list) in buckets.items():
        if audio_list:
            yield flush(kind, audio_list, cat_list)


def _native_batches(waveforms, batch_size, win_len, apa_mode, stems_mode, seed, song_buffer,
                    win_buffer, win_min_age, pin_memory=False):
    """Batches from the C++ batcher: a feeder thread streams the songs in
    (each ctypes call releases the GIL and blocks on the batcher's
    backpressure) while the caller takes finished batches."""
    from .native_loader import NativeBatcher

    nb = NativeBatcher(batch_size=batch_size, win_len=win_len, apa_mode=apa_mode,
                       stems_mode=stems_mode, song_buffer=song_buffer, win_buffer=win_buffer,
                       win_min_age=win_min_age,
                       seed=seed if seed is not None else random.getrandbits(63),
                       pin_memory=pin_memory)
    errors = []

    def feeder():
        try:
            for song in waveforms:
                nb.feed(ensure_ndarray(song))
        except Exception as exc:  # raised in the caller after the batches
            errors.append(exc)
        finally:
            nb.finish()

    thread = threading.Thread(target=feeder, daemon=True)
    thread.start()
    try:
        yield from nb
        thread.join()
    finally:
        # left mid-iteration (the consumer broke off, raised or was
        # collected): unblock the feeder and join it BEFORE the batcher is
        # dropped, which would free the loader under a feed() in progress
        nb.cancel()
        thread.join(timeout=30)
        if thread.is_alive():
            # cancel() unblocks waits in the native layer only; a feeder
            # stuck in the caller's song iterator cannot be interrupted
            logger.warning("native batcher feeder thread did not exit within 30 s after "
                           "cancel(); the song iterator seems blocked; the thread is left "
                           "as a daemon")
    if errors:
        raise errors[0]


def _progress_iter(items, source, desc, unit="song"):
    """A tqdm bar over a host stream when tqdm imports, with the total of
    ``len(source)`` where it has one; else ``items`` as they are."""
    try:
        from tqdm import tqdm
    except ImportError:
        return items
    try:
        total = len(source)
    except TypeError:
        total = None
    return tqdm(items, desc=desc, total=total, leave=False, unit=unit)


def _quantize_host(audio: np.ndarray):
    """The int16 transfer encoding (``AM_TPU_TRANSFER_INT16=1``; ~96 dB
    SNR, half the bytes of f32): ``(codes, scale)`` with scale the batch's
    peak."""
    scale = float(max(np.abs(audio).max(), 1e-9))
    q = np.clip(audio * (32767.0 / scale), -32767, 32767).astype(np.int16)
    return q, np.float32(scale)


def _dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """``q * (scale / 32767)`` in f32 on ``q``'s device, the JAX package's
    order and rounding (the factor is one f32 division)."""
    return q.float() * float(np.float32(scale) / np.float32(32767.0))


def _upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``: to a card from pinned memory, without
    waiting (PyTorch's pinned allocator keeps the buffer until the copy is
    done); on the CPU, ``t`` itself."""
    if device.type != "cuda":
        return t
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


@torch.no_grad()
def fused_embed_loop(embed, windows: torch.Tensor, batch_size: int):
    """Embed (N, win_len) windows batch by batch.  Returns the (N, d) f32
    embedding buffer and the (n, s1, m2) f32 moments, merged batch by batch
    with the Chan update of centered second moments.  Each batch's row
    count is filled in on the device, so the loop never waits for the
    card."""
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


def shard_blocks(n: int, batch_size: int, shards: int) -> list[tuple[int, int]]:
    """The JAX package's shard boundaries (pipeline.py:285-397): contiguous
    blocks of ``ceil(n / (batch_size * shards)) * batch_size`` rows, so
    that every shard but the last runs whole batches; a shard past the
    rows gets an empty block."""
    per = -(-n // (batch_size * shards)) * batch_size
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(shards)]


def sharded_embed_loop(embedders, windows: torch.Tensor, batch_size: int, mesh):
    """``fused_embed_loop`` over a mesh: shard i embeds its block of
    ``windows`` (``shard_blocks``) with ``embedders[i]`` on its own device
    and stream.  Returns the (N, d) embeddings gathered in row order on the
    mesh's first device, and one ``(n, s1, m2)`` triple a shard with rows,
    in shard order, on its device.  No OOM retry, as in the JAX package
    (pipeline.py:406-420)."""
    blocks = shard_blocks(windows.shape[0], batch_size, mesh.size)

    def run(shard, i):
        lo, hi = blocks[i]
        w = windows[lo:hi].to(shard.device, non_blocking=True)
        return fused_embed_loop(embedders[i], w, batch_size)

    out = mesh.map(run, [i if hi > lo else None for i, (lo, hi) in enumerate(blocks)])
    parts = [(hi - lo, r) for (lo, hi), r in zip(blocks, out) if r is not None]
    buf = torch.cat([b.to(mesh.home) for _, (b, _) in parts])
    return buf, [(n, s1, m2) for n, (_, (_, s1, m2)) in parts]


def _embed_set(embedder, windows: torch.Tensor, batch_size: int, store: bool, mesh=None,
               pre=None) -> AudioMetricsData:
    """One category's windows through ``run_fused_embed`` (with a mesh of
    several shards, ``sharded_embed_loop``), ``pre`` (the resampler) applied
    to each batch first: their moments (on the device until read; one
    triple a shard) and, when ``store``, their embeddings."""
    def embed_of(e):
        return e.embed if pre is None else (lambda x: e.embed(pre(x)))

    amd = AudioMetricsData(store)
    if mesh is not None and mesh.size > 1:
        buf, triples = sharded_embed_loop([embed_of(e) for e in mesh.replicas(embedder)],
                                          windows, batch_size, mesh)
    else:
        buf, (_, s1, m2) = run_fused_embed(embed_of(embedder), windows, batch_size)
        triples = [(windows.shape[0], s1, m2)]
    for triple in triples:
        amd.add_moments_device(*triple)
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
                     store_stem: bool, mesh=None) -> dict:
    """(N*k, win, 2) pair windows at ``in_sr`` -> per-category
    ``AudioMetricsData`` (audio_metrics_tpu/parallel/pipeline.py:492-578).
    Each set is mixed whole on ``w``'s device, in chunks of 64 pairs for
    registry mixes (16 for callables, which run on the host), each chunk
    resampled to the embedder's rate first when ``in_sr`` is not it, then
    embedded through the fused loop (sharded over ``mesh``, :516-520): the
    aligned pairs; for ``apa_mode="reference"`` the misaligned ones, each
    context with the stem of window ``derangement(N*k, seed)[i]``; with
    ``stems_mode`` the stems (channel 1, resampled batch by batch in the
    loop).  The mix flags are read and warned about once, at the end."""
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

    out = {ItemCategory.aligned: _embed_set(embedder, mix_all(lambda i, c: w[i : i + c]),
                                            batch_size, store_mix, mesh)}
    if apa_mode == "reference":
        perm = torch.from_numpy(derangement(n_w, seed)).to(w.device)

        def mis_at(i, c):
            return torch.stack([w[i : i + c, :, 0], w[perm[i : i + c], :, 1]], dim=2)

        out[ItemCategory.misaligned] = _embed_set(embedder, mix_all(mis_at), batch_size,
                                                  store_mix, mesh)
    if stems_mode:
        out[ItemCategory.stem] = _embed_set(embedder, w[:, :, 1].contiguous(), batch_size,
                                            store_stem, mesh, pre=resample)
    emit_mix_diagnostics(mix_diag)
    return out


def _host_fed_batches(waveforms, win_dur, hop_dur, in_sr, apa_mode, stems_mode, batch_size,
                      song_buffer_size, win_buffer_size, win_min_age, seed, use_native,
                      progress, pin_memory):
    """The host-fed branch's batches (audio_metrics_tpu/parallel/pipeline.py:
    853-894): the C++ batcher's when ``use_native``, else the Python
    feeder's, where APA reference sets shuffle their songs (``song_buffer_
    size``) and, for the misaligned pairs, a copy of their windows
    (``win_buffer_size``, ``win_min_age``), both from ``seed``."""
    if use_native:
        if progress:
            waveforms = _progress_iter(iter(waveforms), waveforms, "songs")
        return _native_batches(waveforms, batch_size, window_length(in_sr, win_dur), apa_mode,
                               stems_mode, seed, song_buffer_size, win_buffer_size, win_min_age,
                               pin_memory=pin_memory)
    items = iter(waveforms)
    if progress:
        items = _progress_iter(items, waveforms, "songs")
    if apa_mode == "reference":
        # songs shuffled, so that misaligned pairs cross song boundaries
        items = shuffle_stream((ensure_ndarray(x) for x in items), buffer_size=song_buffer_size,
                               seed=seed)
    windows = multi_audio_slicer(items, win_dur, sr=in_sr, hop_dur=hop_dur)
    shuffled = None
    if apa_mode == "reference":
        windows, shuffled = tee(windows)
        shuffled = shuffle_stream(shuffled, buffer_size=win_buffer_size, min_age=win_min_age,
                                  seed=seed)
    return _bucketed_batches(serialize_items(windows, shuffled, apa_mode, stems_mode),
                             batch_size, pin_memory=pin_memory)


def _merge_f64(acc, n2: int, s2: torch.Tensor, m2: torch.Tensor):
    """Chan merge of ``(n, sum_x, centered sum)`` into ``acc`` in float64 on
    the device (audio_metrics_tpu/parallel/pipeline.py:634-661); the counts
    are host integers."""
    s2, m2 = s2.double(), m2.double()
    if acc is None:
        return n2, s2, m2
    n1, s1, m1 = acc
    n_t = n1 + n2
    d = s2 / n2 - s1 / n1
    return n_t, s1 + s2, m1 + m2 + (n1 * n2 / n_t) * torch.outer(d, d)


@torch.no_grad()
def _embed_rows(embedder, kind, audio, scale, category, wanted, acc: dict, mix_function,
                resample, debug_nan: bool, mix_diag: list) -> dict:
    """One host batch's real rows (or a shard's slice of them) on
    ``embedder``'s device: ``audio`` an f32 host tensor, or int16 codes
    with their batch's ``scale``, uploaded without a wait, resampled, mixed
    (pairs), embedded; each category's rows in ``wanted`` merged into
    ``acc`` in float64; returns ``{category: its embeddings}``.  It runs
    under no_grad of its own: a mesh calls it on its shards' host threads,
    and grad mode is local to a thread."""
    device = embedder.device
    if scale is not None:
        audio = _dequantize(_upload(audio, device), scale)
    else:
        audio = _upload(audio, device)
    audio = resample(audio)
    if kind == "pair":
        mono = device_mix(mix_function, audio, embedder.sr, diag=mix_diag)
        if debug_nan:
            bad = int((~torch.isfinite(mono)).sum())
            if bad:
                warnings.warn(f"mix produced {bad} non-finite samples")
    else:
        mono = audio
    emb = embedder.embed(mono).float()
    n = len(category)
    out = {}
    for c in np.unique(category):
        c = ItemCategory(int(c))
        if c not in wanted:
            continue
        rows = np.flatnonzero(category == c)
        e = emb if len(rows) == n else emb.index_select(
            0, _upload(torch.from_numpy(rows), device))
        n_c = len(rows)
        s1 = e.sum(dim=0)
        xc = e - s1 / n_c
        acc[c] = _merge_f64(acc.get(c), n_c, s1, xc.T @ xc)
        out[c] = e
    return out


def host_fed_pipeline(batches, embedder, mix_function, apa_mode, stems_mode: bool,
                      store_mix: bool, store_stem: bool, in_sr: int, progress: bool = False,
                      timings: dict | None = None, mesh=None) -> dict:
    """The host-fed branch's loop (audio_metrics_tpu/parallel/pipeline.py:
    896-1024) over ``batches`` of ``(kind, audio, category, valid)``.

    Each batch's real rows go to the embedder's device (from pinned memory
    without waiting, or as int16 codes and a scale under
    ``AM_TPU_TRANSFER_INT16=1``, dequantized there), are resampled from
    ``in_sr`` when it is not the embedder's rate, mixed by ``mix_function``
    (pairs; ``AM_TPU_DEBUG_NAN`` counts the non-finite samples of the mix,
    one sync a batch) and embedded.  Only real rows are embedded: PyTorch
    needs no fixed shape, and the JAX package masks its pad rows out.
    Each category's rows are gathered by indices known on the host, their
    f32 moments taken with their host count and merged in float64 on the
    device, so no host value is sent after a forward and the host cuts the
    next batch while the card runs this one; the moments are pulled at the
    end and merged in float64 on the host (``AudioMetricsData.
    add_moments``), so that FAD takes its host path, as for host-fed input
    in the JAX package.  Stored embeddings stay on the device in the JAX
    package's row order.  ``timings`` (optional) receives ``feed`` (host
    seconds spent making the batches) and ``drain`` (the wait for the card
    at the final pull).

    With a ``mesh`` of several shards each batch (of a multiple of the
    mesh's size, :780-781) is cut into as many contiguous slices, one a
    shard, each embedded by the shard's replica on its device and stream
    with an accumulator of its own (int16 codes are made for the whole
    batch, one scale); the accumulators are merged on the host in float64,
    in shard order, and the stored embeddings gathered in row order on the
    mesh's first device."""
    sharded = mesh is not None and mesh.size > 1
    embedders = mesh.replicas(embedder) if sharded else [embedder]
    home = mesh.home if sharded else embedder.device
    resample = _resampler(in_sr, embedder.sr)
    transfer_int16 = os.environ.get("AM_TPU_TRANSFER_INT16") == "1"
    debug_nan = bool(os.environ.get("AM_TPU_DEBUG_NAN"))
    out: dict[ItemCategory, AudioMetricsData] = {}
    if apa_mode is not None:
        out[ItemCategory.aligned] = AudioMetricsData(store_mix)
    if apa_mode == "reference":
        out[ItemCategory.misaligned] = AudioMetricsData(store_mix)
    if stems_mode:
        out[ItemCategory.stem] = AudioMetricsData(store_stem)
    accs = [{} for _ in embedders]
    chunks: dict = {c: [] for c in out}
    mix_diag: list = []
    if progress:
        batches = _progress_iter(batches, None, "embedding batches", unit="batch")
    feed = 0.0
    batches = iter(batches)
    with torch.no_grad():
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            feed += time.perf_counter() - t0
            if batch is None:
                break
            kind, audio, category, valid = batch
            n = int(valid.sum())  # the real rows are a prefix
            category = category[:n]
            audio = audio[:n]
            scale = None
            if transfer_int16:
                q, scale = _quantize_host(audio.numpy())
                audio = torch.from_numpy(q)
            if not sharded:
                parts = [_embed_rows(embedder, kind, audio, scale, category, out, accs[0],
                                     mix_function, resample, debug_nan, mix_diag)]
            else:
                per = len(valid) // mesh.size
                blocks = [(min(i * per, n), min((i + 1) * per, n)) for i in range(mesh.size)]

                def run(shard, i):
                    lo, hi = blocks[i]
                    diag: list = []
                    rows = _embed_rows(embedders[i], kind, audio[lo:hi], scale, category[lo:hi],
                                       out, accs[i], mix_function, resample, debug_nan, diag)
                    return rows, diag

                parts = []
                for r in mesh.map(run, [i if hi > lo else None
                                        for i, (lo, hi) in enumerate(blocks)], wait=False):
                    if r is not None:
                        parts.append(r[0])
                        # the flags of all shards are read in one copy, from one device
                        mix_diag.extend({k: v.to(home) for k, v in flags.items()}
                                        for flags in r[1])
            for part in parts:
                for c, e in part.items():
                    chunks[c].append(e)
    emit_mix_diagnostics(mix_diag)
    t0 = time.perf_counter()

    def pull(acc):
        return {c: (n, s1.cpu().numpy(), m2.cpu().numpy()) for c, (n, s1, m2) in acc.items()}

    pulled = [pull(accs[0])] if not sharded else mesh.map(lambda shard, acc: pull(acc), accs)
    for acc in pulled:
        for c, (n, s1, m2) in (acc or {}).items():
            out[c].add_moments(n, s1, m2)
    for c, es in chunks.items():
        for e in es:
            out[c].add_embeddings(e.to(home))
    if timings is not None:
        timings.update(feed=feed, drain=time.perf_counter() - t0)
    return out


def embedding_pipeline(
    waveforms,
    embedder,
    mix_function,
    apa_mode=None,
    stems_mode: bool = False,
    store_mix_embeddings: bool = False,
    store_stem_embeddings: bool = False,
    batch_size: int = 32,
    win_dur: float = 5.0,
    hop_dur: float | None = None,
    song_buffer_size: int = 100,
    win_buffer_size: int = 1000,
    win_min_age: int = 100,
    seed: int | None = None,
    input_sr: int | None = None,
    mesh=None,
    use_native: bool | None = None,
    progress: bool = False,
    *,
    timings: dict | None = None,
) -> dict:
    """Embed audio and accumulate per-category statistics
    (audio_metrics_tpu/parallel/pipeline.py:744-1024), with the JAX
    package's arguments in its order and at its defaults (``mix_function``
    positional, None where no pair is mixed; ``stems_mode`` False), then
    ``timings``.  Returns ``{ItemCategory: AudioMetricsData}``.

    ``embedder``: an embedder of the port, or an object with ``sr`` and
    ``forward(data)`` only (``models.base.as_embedder``; on its ``device``
    attribute, else the mesh's first device, else ``cuda``).

    ``waveforms`` at ``input_sr`` (default: the embedder's rate), either
    stacked or songs:

    - a tensor or numpy array, (N, n_samples) mono stems or (N, n_samples,
      2) context+stem pairs, moved to the embedder's device whole: the
      device-resident branches.  Windows of ``win_dur`` seconds every
      ``hop_dur`` seconds (default ``win_dur``) are cut at the input rate
      in item-major order; each batch is resampled on the device when
      ``input_sr`` is not the embedder's rate (``AM_TPU_RESAMPLE_QUALITY``,
      "hq" or "vhq", read at each call).  ``apa_mode`` ("reference",
      "candidate" or None) asks for the mixes of the pairs through
      ``mix_function`` (``device_pair_eval``; ``seed`` draws the
      misaligned pairing); without it, pairs yield the stems of channel 1,
      as ``serialize_items`` does.  ``progress`` does nothing there: the
      JAX package's device-resident paths return before its progress bar
      (:843, :926).
    - anything else, an iterable (list, tuple, generator) of songs of any
      length, each (n,) or (n, 2), numpy arrays, tensors or array-likes:
      the host-fed branch (``host_fed_pipeline``), whose windows keep the
      item-major order in stems mode, with the Python feeder or, with
      ``use_native`` (default: ``AM_TPU_NATIVE_LOADER=1``), the C++
      batcher, which raises when it cannot be built or loaded and cuts no
      overlapping windows: with ``hop_dur`` the Python feeder serves, as
      in the JAX package.  For APA reference sets the songs, and a copy of
      the windows that the misaligned pairs draw their stems from, are
      shuffled (``song_buffer_size``; ``win_buffer_size``, ``win_min_age``)
      from ``seed`` (None: Python's global ``random``).  ``progress`` shows
      tqdm bars over the songs and batches when tqdm imports.  ``timings``
      receives the host-fed branch's ``feed`` and ``drain`` seconds.

    ``mesh`` (``parallel.mesh.Mesh``): with several shards every branch
    embeds on all of them (``sharded_embed_loop``; the host-fed batches cut
    in slices), ``batch_size`` rounded up to a multiple of the mesh's size
    (:780-781), stacked audio moved to the mesh's first device, where the
    stored embeddings are gathered; a mesh of one shard runs its embedder
    replica alone (the embedder itself on its own device)."""
    embedder = as_embedder(embedder, "cuda" if mesh is None else mesh.home)
    if mesh is not None and mesh.size == 1:
        embedder, mesh = mesh.replicas(embedder)[0], None
    if mesh is not None and batch_size % mesh.size:
        batch_size = -(-batch_size // mesh.size) * mesh.size
    home = embedder.device if mesh is None else mesh.home
    if isinstance(waveforms, np.ndarray) and waveforms.ndim in (2, 3):
        waveforms = torch.from_numpy(waveforms)
    stacked = isinstance(waveforms, torch.Tensor) and (
        waveforms.ndim == 2 or (waveforms.ndim == 3 and waveforms.shape[-1] == 2))
    in_sr = input_sr if input_sr is not None else embedder.sr
    if not stacked:
        if use_native is None:
            use_native = os.environ.get("AM_TPU_NATIVE_LOADER") == "1"
        pin_memory = home.type == "cuda" and os.environ.get("AM_TPU_TRANSFER_INT16") != "1"
        batches = _host_fed_batches(
            waveforms, win_dur, hop_dur, in_sr, apa_mode, stems_mode, batch_size,
            song_buffer_size, win_buffer_size, win_min_age, seed,
            use_native and hop_dur is None, progress, pin_memory)
        return host_fed_pipeline(batches, embedder, mix_function, apa_mode, stems_mode,
                                 store_mix_embeddings, store_stem_embeddings, in_sr,
                                 progress=progress, timings=timings, mesh=mesh)
    pairs = waveforms.ndim == 3
    if apa_mode is not None and not pairs:
        raise ValueError("When computing APA items should be tensors/arrays of shape "
                         "[n_samples, 2] (pairing context and stem)")
    waveforms = waveforms.to(home, torch.float32)
    win_len = window_length(in_sr, win_dur)
    hop_len = win_len if hop_dur is None else window_length(in_sr, hop_dur)
    w = device_windows(waveforms, win_len, hop_len)
    if apa_mode is not None:
        if w is None:
            return {}
        return device_pair_eval(w, embedder, mix_function, in_sr, apa_mode, stems_mode,
                                batch_size, seed, store_mix_embeddings, store_stem_embeddings,
                                mesh)
    if not stems_mode:
        return {}
    if w is None:
        return {ItemCategory.stem: AudioMetricsData(store_stem_embeddings)}
    if pairs:
        w = w[:, :, 1].contiguous()
    return {ItemCategory.stem: _embed_set(embedder, w, batch_size, store_stem_embeddings, mesh,
                                          pre=_resampler(in_sr, embedder.sr))}
