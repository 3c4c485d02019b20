"""The host-fed path, the port against the JAX package on the CPU: iterables
of songs of any length through ``embedding_pipeline`` and ``AudioMetrics``.

- stems from a list and from a generator (no ``len``): n, mean,
  covariance and stored embeddings against the JAX ``embedding_pipeline``,
  also resampled (``input_sr``) and with overlapping windows (``hop_dur``);
- APA ``reference`` and ``candidate`` sets with a seed: the aligned,
  misaligned and stem embeddings in the JAX package's row order, through
  the Python feeder and the C++ batcher;
- mono songs given to APA raise the JAX package's ``ValueError``; songs
  shorter than a window give empty sets;
- the int16 transfer's dequantized batch is the JAX package's bitwise;
  ``AM_TPU_DEBUG_NAN`` warns;
- ``shuffle_stream`` gives the JAX copy's order and keeps ``min_age``;
- the port's ``NativeBatcher`` yields the JAX batcher's batches bitwise
  in all three modes, ``cancel`` unblocks a blocked feeder, and an
  asked-for batcher that cannot be built raises;
- ``AudioMetrics`` with fad, kd, prdc and fad_inf over lists and
  generators against the JAX package's, and APA over lists of pairs.

Most cases run the seeded projection embedder of tests/test_torch_options.py
on both sides, at 16 kHz with 1 s windows.
"""

import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_metrics_tpu.parallel.pipeline as jax_pipeline
from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.ops.mix import MIX_FUNCTIONS as JAX_MIX
from audio_metrics_tpu.parallel.native_loader import NativeBatcher as JaxNativeBatcher
from audio_metrics_tpu.parallel.shuffle import shuffle_stream as jax_shuffle_stream
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.ops.mix import MIX_FUNCTIONS
from audio_metrics_tpu_torch.ops.windowing import audio_slicer, multi_audio_slicer
from audio_metrics_tpu_torch.parallel import native_loader
from audio_metrics_tpu_torch.parallel import pipeline
from audio_metrics_tpu_torch.parallel.pipeline import ItemCategory, embedding_pipeline
from audio_metrics_tpu_torch.parallel.shuffle import shuffle_stream
from audio_metrics_tpu_torch.testing import prdc_mismatches, seeded_songs
from test_torch_options import SR, JaxProj, Proj

WIN = SR  # 1 s windows
STEMS_KEYS = ["fad", "kernel_distance_mean", "kernel_distance_std", "precision", "recall",
              "density", "coverage", "fad_inf", "fad_inf_slope"]


def _songs(seed, n_windows=14, pairs=False, sr=SR, candidate=False):
    return seeded_songs(n_windows, int(sr), sr, seed, pairs=pairs, candidate=candidate,
                        max_windows=4)


def _jax_run(waveforms, mix=None, **kw):
    return jax_pipeline.embedding_pipeline(waveforms, JaxProj(), mix, win_dur=1.0, **kw)


def _port_run(waveforms, mix=None, **kw):
    return embedding_pipeline(waveforms, Proj(), mix, win_dur=1.0, **kw)


def _same_sets(got, want, rtol=1e-6):
    """Per category: n, mean and covariance within f32 rounding of the
    JAX package's, the stored embeddings equal to rounding in the same row
    order."""
    assert list(got) == [ItemCategory(int(c)) for c in want]
    for c, w in want.items():
        g = got[ItemCategory(int(c))]
        mean, cov, n = g.stats()
        assert n == w.n, c
        np.testing.assert_allclose(mean, np.asarray(w.mean), rtol=rtol, atol=1e-8)
        np.testing.assert_allclose(cov, np.asarray(w.cov), rtol=1e-5, atol=1e-9)
        if w.store_embeddings:
            np.testing.assert_allclose(g.embeddings.numpy(), np.asarray(w.embeddings),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("form", ["list", "generator", "tensors"])
def test_stems_from_songs_match_jax(form):
    """Mono songs of 1.1-4.9 s (partial last windows dropped) as a list, a
    generator (no ``len``) and a list of torch tensors: the same stem set
    as the JAX package's host-fed pipeline, batch 4 over 14 windows."""
    songs = _songs(0)
    want = _jax_run(songs, stems_mode=True, store_stem_embeddings=True, batch_size=4)
    given = {"list": songs, "generator": (s for s in songs),
             "tensors": [torch.from_numpy(s) for s in songs]}[form]
    got = _port_run(given, stems_mode=True, store_stem_embeddings=True, batch_size=4)
    assert got[ItemCategory.stem].stats()[2] == 14
    _same_sets(got, want)


def test_stems_resampled_and_overlapping_match_jax():
    """Songs at 22.05 kHz, windows cut at that rate and resampled per batch
    on the device; and overlapping windows (``hop_dur`` 0.4 s of 1 s)."""
    songs = _songs(1, n_windows=4, sr=22050)
    kw = dict(stems_mode=True, store_stem_embeddings=True, batch_size=4, input_sr=22050)
    _same_sets(_port_run(songs, **kw), _jax_run(songs, **kw), rtol=1e-5)
    songs = _songs(2, n_windows=6)
    kw = dict(stems_mode=True, store_stem_embeddings=True, batch_size=4, hop_dur=0.4)
    got, want = _port_run(songs, **kw), _jax_run(songs, **kw)
    assert got[ItemCategory.stem].stats()[2] > 6
    _same_sets(got, want)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("apa_mode", ["reference", "candidate"])
def test_apa_sets_from_songs_match_jax(apa_mode, use_native):
    """Context+stem songs through the PP mix with seed 5, small shuffle
    buffers: the aligned, misaligned and stem sets, embeddings in the JAX
    package's row order, through the Python feeder and the C++ batcher."""
    songs = _songs(3, n_windows=12, pairs=True)
    kw = dict(apa_mode=apa_mode, stems_mode=True, store_mix_embeddings=True,
              store_stem_embeddings=True, batch_size=4, seed=5, song_buffer_size=3,
              win_buffer_size=6, win_min_age=2, use_native=use_native)
    want = _jax_run(songs, JAX_MIX["PP"], **kw)
    got = _port_run(songs, MIX_FUNCTIONS["PP"], **kw)
    cats = [ItemCategory.aligned, ItemCategory.misaligned, ItemCategory.stem]
    assert list(got) == (cats if apa_mode == "reference" else cats[::2])
    _same_sets(got, want)


def test_mono_songs_to_apa_raise_and_short_songs_give_empty_sets():
    songs = _songs(4, n_windows=3)
    for use_native in (False, True):
        with pytest.raises(ValueError, match="pairing context and stem"):
            _port_run(songs, MIX_FUNCTIONS["PP"], apa_mode="candidate", use_native=use_native)
    with pytest.raises(ValueError, match="pairing context and stem"):
        _jax_run(songs, JAX_MIX["PP"], apa_mode="candidate")
    short = [np.zeros(WIN - 1, np.float32), np.zeros(WIN // 3, np.float32)]
    got = _port_run(short, stems_mode=True, store_stem_embeddings=True)
    want = _jax_run(short, stems_mode=True, store_stem_embeddings=True)
    assert list(got) == [ItemCategory.stem] and got[ItemCategory.stem].stats()[2] is None
    assert want[jax_pipeline.ItemCategory.stem].n is None
    assert got[ItemCategory.stem].embeddings is None


def test_int16_transfer_is_jax_bitwise(monkeypatch):
    """``AM_TPU_TRANSFER_INT16=1``: the codes, the scale and the dequantized
    batch equal the JAX package's bitwise; through the pipeline the stem
    set equals the JAX package's under the same variable."""
    audio = np.stack([s[:WIN] for s in _songs(5, n_windows=3)])
    audio[0, 7] = 1.7  # a peak above 1
    q, scale = pipeline._quantize_host(audio)
    jq, jscale = jax_pipeline._quantize_host(audio)
    np.testing.assert_array_equal(q, jq)
    assert scale == jscale and scale.dtype == np.float32
    got = pipeline._dequantize(torch.from_numpy(q), scale).numpy()
    want = np.asarray(jax_pipeline._dequantize_jit(jnp.asarray(jq), jscale))
    np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("AM_TPU_TRANSFER_INT16", "1")
    songs = _songs(6, n_windows=5)
    kw = dict(stems_mode=True, store_stem_embeddings=True, batch_size=4)
    _same_sets(_port_run(songs, **kw), _jax_run(songs, **kw))


def test_debug_nan_warns(monkeypatch):
    """``AM_TPU_DEBUG_NAN``: a mix with non-finite samples warns with their
    count (a host callable that returns nan in one sample per item)."""

    def bad_mix(audio, sr=None):
        out = audio.mean(axis=1)
        out[3] = np.nan
        return out

    songs = _songs(7, n_windows=2, pairs=True)
    monkeypatch.setenv("AM_TPU_DEBUG_NAN", "1")
    with pytest.warns(UserWarning, match="mix produced 2 non-finite samples"):
        _port_run(songs, bad_mix, apa_mode="candidate", stems_mode=False, batch_size=4)
    monkeypatch.delenv("AM_TPU_DEBUG_NAN")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _port_run(songs, bad_mix, apa_mode="candidate", stems_mode=False, batch_size=4)


def check_shuffle(shuffle):
    """``shuffle`` (the port's ``shuffle_stream``) yields the JAX copy's
    order for a seed, every item once, and no item within ``min_age``
    insertions of entering the buffer."""
    for n, buf, age, seed in ((200, 16, 5, 3), (40, 50, 10, 9), (300, 32, 31, 0)):
        got = list(shuffle(range(n), buffer_size=buf, min_age=age, seed=seed))
        assert got == list(jax_shuffle_stream(range(n), buffer_size=buf, min_age=age,
                                              seed=seed))
        assert sorted(got) == list(range(n))
        if n > buf:  # the streaming part: item i inserted as the (i - buf)-th push
            for pos, item in enumerate(got[: n - buf]):
                assert item <= pos + buf - 1 - min(age, buf - 1), (item, pos)


def test_shuffle_stream_matches_jax():
    check_shuffle(shuffle_stream)


def test_shuffle_stream_without_seed_draws_from_the_global_random():
    import random

    random.seed(11)
    got = list(shuffle_stream(range(50), buffer_size=8))
    random.seed(11)
    assert got == list(jax_shuffle_stream(range(50), buffer_size=8))


def test_slicers_match_jax():
    """The host slicers, the ``drop_last=False`` quirk included."""
    from audio_metrics_tpu.ops import windowing as jw

    x = np.arange(1000)
    for hop in (None, 0.03):
        got = [w.tolist() for w in multi_audio_slicer([x, x[:250]], 0.1, 1000, hop)]
        want = [w.tolist() for w in jw.multi_audio_slicer([x, x[:250]], 0.1, 1000, hop)]
        assert got == want
    assert [w.tolist() for w in audio_slicer(x[:50], 0.1, 1000, drop_last=False)] == \
        [x[:50].tolist()]


def _batches(cls, songs, **kw):
    nb = cls(**kw)
    feeder = threading.Thread(target=lambda: ([nb.feed(s) for s in songs], nb.finish()))
    feeder.start()
    out = list(nb)
    feeder.join(timeout=30)
    assert not feeder.is_alive()
    return out


@pytest.mark.parametrize("apa_mode,pairs", [(None, False), (None, True), ("reference", True),
                                            ("candidate", True)])
def test_native_batcher_matches_jax_bitwise(apa_mode, pairs):
    rng = np.random.default_rng(0)
    songs = [rng.standard_normal((int(rng.integers(50, 900)),) + ((2,) if pairs else ()))
             .astype(np.float32) for _ in range(12)]
    kw = dict(batch_size=4, win_len=100, apa_mode=apa_mode, stems_mode=True, song_buffer=3,
              win_buffer=6, win_min_age=2, seed=11)
    got = _batches(native_loader.NativeBatcher, songs, **kw)
    want = _batches(JaxNativeBatcher, songs, **kw)
    assert len(got) == len(want) > 2
    for (gk, ga, gc, gv), (wk, wa, wc, wv) in zip(got, want):
        assert gk == wk and isinstance(ga, torch.Tensor)
        np.testing.assert_array_equal(ga.numpy(), wa)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gv, wv)


def test_native_cancel_unblocks_a_blocked_feeder():
    nb = native_loader.NativeBatcher(batch_size=2, win_len=1000, stems_mode=True,
                                     max_ready_batches=1)
    song = np.zeros(4000, np.float32)
    fed = []

    def feeder():
        for i in range(200):  # far beyond the 64 songs + ready batches it holds
            nb.feed(song)
            fed.append(i)
        nb.finish()

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    time.sleep(0.3)
    assert t.is_alive(), "the feeder should wait on the batcher's backpressure"
    nb.cancel()
    t.join(timeout=10)
    assert not t.is_alive(), "cancel() did not unblock the feeder"
    assert len(list(nb)) <= 1 + len(fed)


def test_native_pipeline_abandoned_consumer_returns():
    gen = pipeline._native_batches(iter(_songs(8, n_windows=40)), 2, 500, None, True, 0, 4, 8,
                                   0)
    next(gen)
    gen.close()  # GeneratorExit at the yield: cancel, then join the feeder


def test_asked_for_native_batcher_that_cannot_build_raises(monkeypatch, tmp_path):
    """No silent fallback: with ``use_native=True`` or
    ``AM_TPU_NATIVE_LOADER=1``, a batcher whose source does not compile
    raises ``NativeLoaderError`` with the compiler's message (the JAX
    package falls back to its Python feeder).  ``hop_dur`` still routes to
    the Python feeder, as documented."""
    bad = tmp_path / "am_dataloader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "_SOURCE", bad)
    monkeypatch.setattr(native_loader, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    songs = _songs(9, n_windows=2)
    with pytest.raises(native_loader.NativeLoaderError, match="failed to build"):
        _port_run(songs, stems_mode=True, use_native=True)
    monkeypatch.setenv("AM_TPU_NATIVE_LOADER", "1")
    with pytest.raises(native_loader.NativeLoaderError):
        _port_run(songs, stems_mode=True)
    out = _port_run(songs, stems_mode=True, hop_dur=0.5)
    assert out[ItemCategory.stem].stats()[2] > 2


def test_native_and_python_feeders_give_the_same_stems():
    songs = _songs(10, n_windows=9)
    kw = dict(stems_mode=True, store_stem_embeddings=True, batch_size=4)
    a, b = _port_run(songs, use_native=True, **kw), _port_run(songs, use_native=False, **kw)
    np.testing.assert_array_equal(a[ItemCategory.stem].embeddings.numpy(),
                                  b[ItemCategory.stem].embeddings.numpy())


@pytest.mark.parametrize("form", ["list", "generator"])
def test_audio_metrics_on_songs_matches_jax(form):
    """``AudioMetrics(metrics=["fad", "kd", "prdc", "fad_inf"],
    device="cpu")`` with songs of varied length in ``add_reference`` and
    ``evaluate``: the JAX package's keys in its order, FAD and FAD-inf
    and KD within 1e-3 relative, PRDC equal up to near-ties (the
    candidates of ``testing.seeded_songs``, half of them quieter over a
    tone, made three times louder, so that KD is not the difference of two
    equal sums);
    ``timings`` splits the host-fed ``pipeline`` into ``pipeline_feed`` and
    ``pipeline_drain``."""
    ref = _songs(11, n_windows=60)
    cand = [3 * s for s in _songs(12, n_windows=56, candidate=True)]
    kw = dict(metrics=["fad", "kd", "prdc", "fad_inf"], win_dur=1.0, batch_size=8)
    jam = JaxAudioMetrics(embedder=JaxProj(), device_indices=[0], **kw)
    am = AudioMetrics(embedder=Proj(), device="cpu", **kw)
    given = (lambda s: iter(s)) if form == "generator" else (lambda s: s)
    jam.add_reference(ref)
    am.add_reference(given(ref))
    want, got = jam.evaluate(cand), am.evaluate(given(cand))
    assert list(got) == list(want) == STEMS_KEYS
    for key in ("fad", "kernel_distance_mean", "kernel_distance_std", "fad_inf",
                "fad_inf_slope"):
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
    if any(got[k] != want[k] for k in ("precision", "recall", "density", "coverage")):
        n, bad = prdc_mismatches(am.stem_reference.embeddings,
                                 am._run_pipeline(cand, None)[ItemCategory.stem].embeddings,
                                 jam.stem_reference.embeddings,
                                 jam._run_pipeline(cand, None)[ItemCategory.stem].embeddings)
        assert bad == 0, (n, got, want)
    assert {"pipeline", "pipeline_feed", "pipeline_drain"} <= set(am.timings)


def test_audio_metrics_apa_on_pair_songs():
    """APA + FAD over lists of context+stem songs, the PP mix: finite,
    APA in [0, 1], and through the C++ batcher the same reference sizes."""
    ref, cand = _songs(13, n_windows=24, pairs=True), _songs(14, n_windows=20, pairs=True)
    sizes = []
    for use_native in ("0", "1"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("AM_TPU_NATIVE_LOADER", use_native)
            am = AudioMetrics(metrics=["apa", "fad"], embedder=Proj(), mix_function="PP",
                              win_dur=1.0, batch_size=8, device="cpu")
            am.add_reference(ref)
            out = am.evaluate(cand)
        assert list(out) == ["fad", "apa"] and all(np.isfinite(v) for v in out.values())
        assert 0.0 <= out["apa"] <= 1.0
        sizes.append((len(am.mix_reference), len(am.mix_anti_reference),
                      len(am.stem_reference)))
    assert sizes[0] == sizes[1] == (24, 24, 24)


def test_host_stages_match_jax():
    """The reference's host stages, as the JAX package exports them:
    ``serialize_items`` (categories and audio), ``mix_pair``,
    ``batch_accumulator``, and ``parallel.stream``'s ``cpu_parallel`` (on
    threads) and ``device_map_stream``, in input order."""
    from audio_metrics_tpu.parallel import stream as jax_stream
    from audio_metrics_tpu_torch.parallel import stream

    pairs = [np.asarray(s[:300]) for s in _songs(15, n_windows=4, pairs=True)]
    kw = dict(apa_mode=True, stems_mode=True)
    got = list(pipeline.serialize_items(pairs, pairs[::-1], **kw))
    want = list(jax_pipeline.serialize_items(pairs, pairs[::-1], **kw))
    assert [int(g["category"]) for g in got] == [int(w["category"]) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["audio"], w["audio"])
    mixed = [pipeline.mix_pair(g, lambda a, sr: a.sum(axis=1), 16000)["audio"] for g in got]
    jmixed = [jax_pipeline.mix_pair(w, lambda a, sr: a.sum(axis=1), 16000)["audio"]
              for w in want]
    for g, w in zip(mixed, jmixed):
        np.testing.assert_array_equal(g, w)
    stems = [g for g in got if g["category"] == ItemCategory.stem]
    for g, w in zip(pipeline.batch_accumulator(stems, 3),
                    jax_pipeline.batch_accumulator(stems, 3)):
        np.testing.assert_array_equal(g["audio"], w["audio"])
        np.testing.assert_array_equal(g["category"], w["category"])
    square = lambda x: x * x  # noqa: E731
    assert list(stream.cpu_parallel(range(20), square, n_workers=3, use_threads=True)) == \
        list(jax_stream.cpu_parallel(range(20), square, n_workers=3, use_threads=True)) == \
        [i * i for i in range(20)]
    assert list(stream.device_map_stream(iter(range(7)), square, depth=3)) == \
        [i * i for i in range(7)]
