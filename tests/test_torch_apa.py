"""The APA path of the port against the JAX package, on the CPU: the pair
pipeline (aligned, misaligned and stem sets at the same ``seed``, user
callables, resampled pairs) and ``AudioMetrics`` with APA end to end
(state files in both directions, ``n_pca``, ``precompile``, the result
keys).

Same numpy inputs, made from a seed, through both packages: 2 s pairs at
16 kHz through the dummy embedder (``PP``, with per-pair amplitudes the
dummy sees), and 4 pairs of 5 s at 48 kHz through the small HTSAT of
tests/test_torch_slice.py in f32 (``L0``).
"""

import copy
import warnings

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
from audio_metrics_tpu.models.dummy import DummyEmbedder as JaxDummy
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.ops import mix as jax_mix
from audio_metrics_tpu.parallel import pipeline as jax_pipeline
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.models.clap import LaionCLAP
from audio_metrics_tpu_torch.models.dummy import DummyEmbedder
from audio_metrics_tpu_torch.models.htsat import HTSATConfig
from audio_metrics_tpu_torch.ops import mix
from audio_metrics_tpu_torch.ops.windowing import device_windows
from audio_metrics_tpu_torch.parallel import pipeline
from audio_metrics_tpu_torch.parallel.pipeline import ItemCategory, derangement

# the module: ``metrics`` exports the function ``apa`` under the same name
port_apa = importlib.import_module("audio_metrics_tpu_torch.metrics.apa")

SR = 16000
N = 2 * SR


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the pair pipeline ----------------------------------------------------------
def _dummy_pairs(seed, n, corr=True):
    """Pairs the dummy embedder can tell apart: per-pair amplitudes, the
    stem's equal to the context's when ``corr``."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.5, (n, 1))
    b = a if corr else rng.uniform(0.05, 0.5, (n, 1))
    return np.stack([a * rng.standard_normal((n, N)), b * rng.standard_normal((n, N))],
                    axis=2).astype(np.float32)


def _jax_pipeline(x, emb, mix_name, apa_mode, mix_fn=None, **kw):
    return jax_pipeline.embedding_pipeline(
        x, emb, mix_fn or jax_mix.MIX_FUNCTIONS[mix_name], apa_mode=apa_mode,
        stems_mode=True, store_mix_embeddings=True, store_stem_embeddings=True, **kw)


def _port_pipeline(module, x, emb, mix_name, apa_mode, mix_fn=None, **kw):
    return module.embedding_pipeline(
        x, emb, mix_fn or mix.MIX_FUNCTIONS[mix_name], apa_mode=apa_mode, stems_mode=True,
        store_mix_embeddings=True, store_stem_embeddings=True, **kw)


def _assert_sets(got, want, cats, atol=0.0, rtol=0.0, cov_atol=0.0):
    """Each category's stored embeddings and mean under (``atol``,
    ``rtol``), its covariance under (``cov_atol``, 1e-5)."""
    assert sorted(got) == sorted(cats)
    for c in cats:
        g, w = got[c], want[c]
        g.stats()  # merges the pending device moments
        assert g.n == w.n, c
        np.testing.assert_allclose(g.embeddings.numpy(), np.asarray(w.embeddings), rtol=rtol,
                                   atol=atol, err_msg=str(c))
        np.testing.assert_allclose(g.mean, w.mean, rtol=rtol, atol=atol, err_msg=str(c))
        np.testing.assert_allclose(g.cov, w.cov, rtol=1e-5, atol=cov_atol, err_msg=str(c))


def check_pair_pipeline(module):
    """``module.embedding_pipeline`` on 40 pairs of 2 s (hop 1 s: 120
    windows) at seed 7 through the dummy embedder, ``PP``: the aligned,
    misaligned and stem sets and their stored embeddings against the JAX
    package's ``_device_pair_eval`` (rtol 1e-6 on embeddings up to ~3000,
    which the two packages' f32 std computes apart by 2e-7 relative); in
    candidate mode no misaligned set."""
    x = _dummy_pairs(0, 40)
    kw = dict(batch_size=16, win_dur=1.0, hop_dur=0.5, seed=7)
    want = _jax_pipeline(jnp.asarray(x), JaxDummy(), "PP", "reference", **kw)
    got = _port_pipeline(module, _t(x), DummyEmbedder(device="cpu"), "PP", "reference", **kw)
    _assert_sets(got, want, list(ItemCategory), rtol=1e-6)
    got = _port_pipeline(module, _t(x), DummyEmbedder(device="cpu"), "PP", "candidate", **kw)
    assert ItemCategory.misaligned not in got and len(got[ItemCategory.aligned]) == 120


def test_pair_pipeline_matches_jax_dummy():
    check_pair_pipeline(pipeline)


def test_derangement_matches_jax_and_has_no_fixed_point():
    for n, seed in ((120, 7), (2, 0), (33, None)):
        d = derangement(n, seed)
        assert sorted(d) == list(range(n)) and not np.any(d == np.arange(n))
    rng = np.random.default_rng(7)
    p = rng.permutation(50)
    s = int(rng.integers(1, 50))
    want = np.empty(50, np.int64)
    want[p] = np.roll(p, -s)
    np.testing.assert_array_equal(derangement(50, 7), want)
    np.testing.assert_array_equal(derangement(1, 3), [0])


def test_pair_windows_match_jax():
    """``device_windows`` on (N, n, 2) pairs is the JAX package's
    ``_device_windows_pair``."""
    x = np.random.default_rng(0).standard_normal((3, 1000, 2)).astype(np.float32)
    for win, hop in ((300, 300), (300, 200), (1000, 1000)):
        want = np.asarray(jax_pipeline._device_windows_pair(jnp.asarray(x), win, hop))
        np.testing.assert_array_equal(device_windows(_t(x), win, hop).numpy(), want)
    assert device_windows(_t(x), 1200, 1200) is None


def test_user_callable_mix_runs_per_item_in_chunks_of_16():
    """A user callable ``f(audio[n, 2], sr) -> mono[n]`` runs on the host
    per item (numpy in), 16 pairs a chunk; the sets equal the JAX
    package's."""
    calls = []

    def user_mix(audio, sr):
        calls.append((type(audio), audio.shape, sr))
        return 0.7 * audio[:, 0] + 0.3 * audio[:, 1]

    x = _dummy_pairs(1, 40)
    kw = dict(batch_size=16, win_dur=1.0, seed=3)
    want = _jax_pipeline(jnp.asarray(x), JaxDummy(), None, "reference", mix_fn=user_mix, **kw)
    calls.clear()
    got = _port_pipeline(pipeline, _t(x), DummyEmbedder(device="cpu"), None, "reference",
                         mix_fn=user_mix, **kw)
    assert calls == [(np.ndarray, (SR, 2), SR)] * 160  # 80 windows, aligned + misaligned
    _assert_sets(got, want, list(ItemCategory), rtol=1e-6)
    seen = []
    orig = pipeline.device_mix
    try:
        pipeline.device_mix = lambda f, a, sr, diag=None: seen.append(a.shape[0]) or orig(
            f, a, sr, diag)
        _port_pipeline(pipeline, _t(x), DummyEmbedder(device="cpu"), None, "candidate",
                       mix_fn=user_mix, **kw)
    finally:
        pipeline.device_mix = orig
    assert seen == [16] * 5


def test_pairs_at_another_rate_match_jax():
    """Pairs at 32 kHz for the 16 kHz dummy embedder: each chunk
    resampled on the device before the mix (the port), the JAX package's
    host batch loop given numpy pairs: aligned and stem sets agree (its
    misaligned set comes from another shuffle)."""
    sr_in = 32000
    rng = np.random.default_rng(4)
    a = rng.uniform(0.05, 0.5, (4, 1))
    x = np.stack([a * rng.standard_normal((4, sr_in)), a * rng.standard_normal((4, sr_in))],
                 axis=2).astype(np.float32)
    kw = dict(batch_size=4, win_dur=0.5, input_sr=sr_in)
    want = _jax_pipeline(x, JaxDummy(), "L0", "reference", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _port_pipeline(pipeline, _t(x), DummyEmbedder(device="cpu"), "L0", "reference",
                             **kw)
    for c in (ItemCategory.aligned, ItemCategory.stem):
        assert got[c].stats()[2] == want[c].n == 8
        np.testing.assert_allclose(got[c].mean, want[c].mean, rtol=1e-4)
        np.testing.assert_allclose(np.diag(got[c].cov), np.diag(want[c].cov), rtol=1e-3)


def test_pairs_without_apa_are_stems_of_channel_1():
    x = _dummy_pairs(2, 4)
    emb = DummyEmbedder(device="cpu")
    got = pipeline.embedding_pipeline(_t(x), emb, None, stems_mode=True, win_dur=1.0,
                                      store_stem_embeddings=True)
    want = pipeline.embedding_pipeline(_t(x[:, :, 1]), emb, None, stems_mode=True, win_dur=1.0,
                                       store_stem_embeddings=True)
    assert list(got) == [ItemCategory.stem]
    assert torch.equal(got[ItemCategory.stem].embeddings, want[ItemCategory.stem].embeddings)
    with pytest.raises(ValueError, match="pairing context and stem"):
        pipeline.embedding_pipeline(_t(x[:, :, 0]), emb, mix.MIX_FUNCTIONS["PP"],
                                    apa_mode="reference")


# -- the small HTSAT, f32 -------------------------------------------------------
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
SR_CLAP = 48000


def _clap_pairs(seed, n, aligned=True):
    """(n, 5 s, 2) pairs at 48 kHz: a tone of random pitch and envelope
    over noise in the context, its octave under the same envelope in the
    stem (another pair's pitch and envelope where not ``aligned``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(5 * SR_CLAP) / SR_CLAP
    f = rng.uniform(110, 880, (n, 1))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1, 8, (n, 1)) * t))
    ctx = env * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal((n, t.size))
    if not aligned:
        f, env = np.roll(f, 1, axis=0), np.roll(env, 1, axis=0)
    stem = env * np.sin(2 * np.pi * 2 * f * t) + 0.02 * rng.standard_normal((n, t.size))
    return np.stack([ctx, 0.5 * stem], axis=2).astype(np.float32)


@pytest.fixture(scope="module")
def clap():
    from test_torch_slice import _params

    p = _params(HTSATConfig(**SMALL))
    return dict(jax=JaxLaionCLAP(params=p, cfg=JaxHTSATConfig(**SMALL)),
                port=LaionCLAP(params=p, cfg=HTSATConfig(**SMALL), device="cpu"))


def test_pair_pipeline_matches_jax_small_htsat(clap):
    """L0 on 4 pairs of 5 s at seed 7 through the small HTSAT in f32: the
    three sets and their embeddings at the slice test's tolerances
    (embeddings atol 1e-6; their covariance, entries ~1e-5, atol 1e-8)."""
    x = _clap_pairs(0, 4)
    kw = dict(batch_size=4, win_dur=5.0, seed=7)
    want = _jax_pipeline(jnp.asarray(x), clap["jax"], "L0", "reference", **kw)
    got = _port_pipeline(pipeline, _t(x), clap["port"], "L0", "reference", **kw)
    _assert_sets(got, want, list(ItemCategory), atol=1e-6, cov_atol=1e-8)


def _am_pair(clap, **kw):
    jam = JaxAudioMetrics(embedder=clap["jax"], input_sr=SR_CLAP, batch_size=4,
                          device_indices=[0], **kw)
    am = AudioMetrics(embedder=clap["port"], input_sr=SR_CLAP, batch_size=4, device="cpu", **kw)
    return jam, am


def _assert_apa_close(got, want):
    """FAD rel 1e-5 (tests/test_torch_slice.py); APA abs 1e-4: each
    distance moves by ~1e-7 relative, APA by that over d(x, x') (reading
    ~2e-6)."""
    assert list(got) == list(want)
    if "fad" in want:
        assert got["fad"] == pytest.approx(want["fad"], rel=1e-5)
    assert got["apa"] == pytest.approx(want["apa"], abs=1e-4)
    assert 0.0 <= got["apa"] <= 1.0


def test_jax_apa_state_evaluates_equal_in_the_port(clap, tmp_path):
    """JAX ``add_reference`` and ``save_state``, port ``load_state``; both
    evaluate the same candidate pairs through ``AudioMetrics()``'s
    metrics, APA then FAD; then the port's state back into JAX."""
    jam, am = _am_pair(clap)
    assert jam.metrics == am.metrics == ["apa", "fad"]
    jam.add_reference(jnp.asarray(_clap_pairs(1, 4)))
    f = tmp_path / "jax_apa.npz"
    jam.save_state(f)
    am.load_state(f)
    assert am.apa_d_x_xp is None and am.mix_anti_reference.n == 4
    cand = _clap_pairs(2, 4, aligned=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jam.evaluate(jnp.asarray(cand))
        got = am.evaluate(cand)
    assert list(am.timings)[-1] == "apa" and am.apa_d_x_xp == pytest.approx(jam.apa_d_x_xp,
                                                                             rel=1e-9)
    _assert_apa_close(got, want)

    back = tmp_path / "port_apa.npz"
    am.save_state(back)
    jam2, _ = _am_pair(clap)
    jam2.load_state(back)
    assert jam2.apa_d_x_xp == am.apa_d_x_xp
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _assert_apa_close(got, jam2.evaluate(jnp.asarray(cand)))


def test_apa_surface_errors(clap):
    """The JAX package's errors: mono audio given to an APA instance, an
    empty reference, an unknown mix."""
    am = AudioMetrics(metrics=["apa"], embedder=DummyEmbedder(device="cpu"), win_dur=1.0,
                      device="cpu")
    with pytest.raises(ValueError, match="pairing context and stem"):
        am.add_reference(_dummy_pairs(0, 2)[:, :, 0])
    with pytest.raises(ValueError, match="reference dataset is empty"):
        am.evaluate(_dummy_pairs(0, 2))
    with pytest.raises(ValueError, match="Unknown mix_function"):
        AudioMetrics(metrics=["apa"], embedder=clap["port"], mix_function="L9", device="cpu")


def _dummy_am(cls, **kw):
    extra = dict(device_indices=[0]) if cls is JaxAudioMetrics else dict(device="cpu")
    emb = JaxDummy() if cls is JaxAudioMetrics else DummyEmbedder(device="cpu")
    return cls(embedder=emb, win_dur=1.0, input_sr=SR, batch_size=16, **extra, **kw)


def test_pp_dummy_orders_aligned_above_shuffled():
    """``PP`` with per-pair amplitudes, which the dummy sees (under ``L0``
    every mix reads -20 LUFS and the dummy sees nothing): aligned
    candidates score well above shuffled ones, with every metric, in the
    JAX package's key order."""
    am = _dummy_am(AudioMetrics, metrics=["fad", "kd", "prdc", "apa"], mix_function="PP")
    am.add_reference(_dummy_pairs(0, 40))
    good = am.evaluate(_dummy_pairs(1, 40))
    bad = am.evaluate(_dummy_pairs(2, 40, corr=False))
    timings = list(am.timings)
    jam = _dummy_am(JaxAudioMetrics, metrics=["fad", "kd", "prdc", "apa"], mix_function="PP")
    jam.add_reference(jnp.asarray(_dummy_pairs(0, 40)))
    assert list(good) == list(jam.evaluate(jnp.asarray(_dummy_pairs(1, 40)))) == [
        "fad", "kernel_distance_mean", "kernel_distance_std", "precision", "recall",
        "density", "coverage", "apa"]
    assert good["apa"] > bad["apa"] + 0.2, (good, bad)
    assert timings == list(jam.timings)
    assert timings[:2] == ["pipeline", "projection"] and timings[-2:] == ["finalize", "apa"]
    assert "finalize_pull" in timings


def test_add_reference_again_recomputes_d_x_xp():
    """The port drops ``apa_d_x_xp`` when the reference grows (the JAX
    package keeps the value of the smaller reference)."""
    am = _dummy_am(AudioMetrics, metrics=["apa"], mix_function="PP")
    am.add_reference(_dummy_pairs(0, 20))
    am.evaluate(_dummy_pairs(1, 20))
    first = am.apa_d_x_xp
    am.add_reference(_dummy_pairs(3, 20))
    assert am.apa_d_x_xp is None and am.mix_reference.n == 80
    am.evaluate(_dummy_pairs(1, 20))
    assert am.apa_d_x_xp == port_apa.apa_compute_d_x_xp(am.mix_reference, am.mix_anti_reference)
    assert am.apa_d_x_xp != first


def test_n_pca_projects_the_mix_sets_as_jax(tmp_path):
    """``n_pca``: the mix projection is fitted on the reference mixes
    only; with the same reference state both packages give the same APA,
    and the fitted projections cross the state files both ways."""
    jam = _dummy_am(JaxAudioMetrics, metrics=["apa", "fad"], mix_function="PP", n_pca=4)
    jam.add_reference(jnp.asarray(_dummy_pairs(0, 40)))
    f = tmp_path / "jax_pca.npz"
    jam.save_state(f)
    am = _dummy_am(AudioMetrics, metrics=["apa", "fad"], mix_function="PP", n_pca=4)
    am.load_state(f)
    assert am.store_mix_embeddings and am.mix_reference.embeddings.shape == (80, 10)
    cand = _dummy_pairs(1, 40, corr=False)
    want = jam.evaluate(jnp.asarray(cand))
    got = am.evaluate(cand)
    assert am.mix_projection.__getstate__()["components_"].shape == (4, 10)
    assert got["apa"] == pytest.approx(want["apa"], abs=1e-6)
    assert got["fad"] == pytest.approx(want["fad"], rel=1e-5)
    back = tmp_path / "port_pca.npz"
    am.save_state(back)
    jam2 = _dummy_am(JaxAudioMetrics, metrics=["apa", "fad"], mix_function="PP", n_pca=4)
    jam2.load_state(back)
    np.testing.assert_allclose(jam2.mix_projection.components_,
                               am.mix_projection.__getstate__()["components_"], rtol=0, atol=0)
    assert jam2.evaluate(jnp.asarray(cand))["apa"] == pytest.approx(got["apa"], abs=1e-6)


def test_precompile_with_pairs_leaves_the_state_bitwise():
    am = _dummy_am(AudioMetrics, metrics=["apa", "fad"], mix_function="PP", n_pca=4)
    am.add_reference(_dummy_pairs(0, 20))
    before = am.evaluate(_dummy_pairs(1, 20))
    snap = {a: getattr(am, a) for a in ("mix_reference", "mix_anti_reference",
                                        "stem_reference", "mix_reference_pca", "apa_d_x_xp")}
    fits = [copy.deepcopy(p.__getstate__()) for p in (am.stem_projection, am.mix_projection)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        am.precompile(n_items=8)
    assert all(getattr(am, a) is v for a, v in snap.items())
    for p, fit in zip((am.stem_projection, am.mix_projection), fits):
        state = p.__getstate__()
        for k in fit:
            np.testing.assert_array_equal(state[k], fit[k], err_msg=k)
    assert am.evaluate(_dummy_pairs(1, 20)) == before
