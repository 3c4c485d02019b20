"""The FAD+KD+PRDC slice and the state files, the port against the JAX
package on the CPU.

Same numpy parameter dict (a small HTSAT: spec 256 and 64 mels as
HTSAT-base, narrower and shallower), same seeded 5 s clips, through
``AudioMetrics(metrics=["fad", "kd", "prdc"])`` of both packages in f32;
12 + 12 clips, so that PRDC's k = min(10, n) = 10 < n.  Then a state saved
by either package is loaded by the other and evaluates to the values of
the instance that saved it.

Tolerances: embeddings atol 1e-6 (unit vectors, f32 products summed in
other orders, measured ~1e-7); FAD rel 1e-5 and KD abs 1e-7 as in
tests/test_torch_slice.py; PRDC equal (comparisons of distances between
embeddings that agree to ~1e-7 against radii ~1e-1 apart).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.models.clap import LaionCLAP, init_projection_params
from audio_metrics_tpu_torch.models.htsat import HTSATConfig, init_params

SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
SR = 48000
METRICS = ["fad", "kd", "prdc"]
KEYS = ["fad", "kernel_distance_mean", "kernel_distance_std", "precision", "recall",
        "density", "coverage"]


def _params(cfg):
    rng = np.random.default_rng(1)
    p = init_params(cfg, seed=0)
    p.update(init_projection_params(cfg, seed=0))
    for k in p:
        if k.endswith(".bias") or "bias_table" in k:
            p[k] = rng.normal(scale=0.1, size=p[k].shape).astype(np.float32)
    p["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    return p


def _clips(seed, n):
    """Noise, with a tone of random pitch in every other clip."""
    rng = np.random.default_rng(seed)
    t = np.arange(5 * SR) / SR
    tone = np.sin(2 * np.pi * rng.uniform(100, 2000, size=(n, 1)) * t) * (np.arange(n) % 2)[:, None]
    return (0.1 * rng.standard_normal((n, 5 * SR)) + 0.2 * tone).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    ref, cand = _clips(0, 12), _clips(1, 12)
    jax_emb = JaxLaionCLAP(params=p, cfg=JaxHTSATConfig(**SMALL))
    port_emb = LaionCLAP(params=p, cfg=cfg, device="cpu")

    def jax_am():
        return JaxAudioMetrics(metrics=METRICS, embedder=jax_emb, win_dur=5.0, input_sr=SR,
                               batch_size=4, device_indices=[0])

    def port_am():
        return AudioMetrics(metrics=METRICS, embedder=port_emb, win_dur=5.0, input_sr=SR,
                            batch_size=4, device="cpu")

    jam = jax_am()
    jam.add_reference(jnp.asarray(ref))
    am = port_am()
    am.add_reference(ref)
    return dict(jam=jam, am=am, jax_am=jax_am, port_am=port_am, cand=cand,
                want=jam.evaluate(jnp.asarray(cand)), got=am.evaluate(cand))


def _assert_same(got, want):
    assert list(got) == KEYS
    assert got["fad"] == pytest.approx(want["fad"], rel=1e-5)
    for k in ("kernel_distance_mean", "kernel_distance_std"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-7), k
    for k in KEYS[3:]:
        assert got[k] == want[k], k


def test_fad_kd_prdc_slice_matches_jax(setup):
    np.testing.assert_allclose(setup["am"].stem_reference.embeddings.numpy(),
                               np.asarray(setup["jam"].stem_reference.embeddings), atol=1e-6)
    _assert_same(setup["got"], setup["want"])
    assert all(0 <= setup["got"][k] <= 1 for k in ("precision", "recall", "coverage"))
    assert setup["got"]["density"] > 0


def test_jax_state_loads_into_the_port(setup, tmp_path):
    """The JAX instance's reference (with its cached radii) saved by the
    JAX package, loaded by the port: same values; the port keeps its own
    metrics."""
    f = tmp_path / "jax_state.npz"
    setup["jam"].save_state(f)
    am = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=setup["am"].embedder,
                      win_dur=1.0, device="cpu")
    am.load_state(f)
    assert am.win_dur == 5.0 and am.input_sr == SR and am.metrics == METRICS
    assert set(am.stem_reference.radii) == {"radii_10"}
    assert isinstance(am.stem_reference.radii["radii_10"], torch.Tensor)
    _assert_same(am.evaluate(setup["cand"]), setup["want"])


def test_port_state_loads_into_jax(setup, tmp_path):
    f = tmp_path / "port_state.npz"
    setup["am"].save_state(f)
    jam = setup["jax_am"]()
    jam.load_state(f)
    assert jam.stem_reference.n == 12
    _assert_same(setup["got"], jam.evaluate(jnp.asarray(setup["cand"])))


def test_port_state_round_trip(setup, tmp_path):
    f = tmp_path / "round_trip.npz"
    setup["am"].save_state(f)
    am = setup["port_am"]()
    am.load_state(f)
    ref, back = setup["am"].stem_reference, am.stem_reference
    assert torch.equal(ref.embeddings, back.embeddings)
    np.testing.assert_array_equal(ref.stats()[1], back.stats()[1])
    assert all(torch.equal(ref.radii[k], back.radii[k]) for k in ref.radii)
    assert am.evaluate(setup["cand"]) == setup["got"]


def test_jax_apa_state_loads_and_evaluates_equal(setup, tmp_path):
    """A JAX state file with APA entries (mix references and d(x, x')),
    loaded by the port: the same entries, and the same APA on the same
    mix candidates."""
    from audio_metrics_tpu.data import AudioMetricsData as JaxData
    from audio_metrics_tpu_torch.data import AudioMetricsData
    from audio_metrics_tpu_torch.metrics.apa import apa

    rng = np.random.default_rng(0)
    jam = JaxAudioMetrics(metrics=["apa", "fad"], embedder="dummy", win_dur=1.0,
                          device_indices=[0])
    jam.mix_reference.add(rng.normal(size=(40, 8)).astype(np.float32))
    jam.mix_anti_reference.add(rng.normal(0.3, size=(40, 8)).astype(np.float32))
    jam.apa_d_x_xp = 0.25
    f = tmp_path / "apa_state.npz"
    jam.save_state(f)
    am = setup["port_am"]()
    am.load_state(f)
    assert am.apa_d_x_xp == 0.25 and am.mix_reference.n == am.mix_anti_reference.n == 40
    np.testing.assert_array_equal(am.mix_reference.cov, jam.mix_reference.cov)
    cand = rng.normal(0.1, size=(40, 8)).astype(np.float32)
    jc, pc = JaxData(False), AudioMetricsData(False)
    jc.add(cand)
    pc.add(torch.from_numpy(cand))
    from audio_metrics_tpu.metrics.apa import apa as jax_apa

    want = jax_apa(jc, jam.mix_reference, jam.mix_anti_reference, jam.apa_d_x_xp)
    got = apa(pc, am.mix_reference, am.mix_anti_reference, am.apa_d_x_xp)
    assert got == pytest.approx(want, rel=1e-9) and 0 < got < 1


def test_jax_state_with_stale_radii_loads_into_the_port(setup, tmp_path):
    """A valid JAX file whose radii are older than its reference: the JAX
    ``__iadd__`` keeps the radii of the first ``add_reference`` through the
    second (its data.py:513-528).  The port drops them on load, and its
    PRDC recomputes them: the values of a port reference built from the
    same embeddings."""
    jam = setup["jax_am"]()
    jam.add_reference(jnp.asarray(_clips(0, 12)))
    jam.evaluate(jnp.asarray(setup["cand"]))
    jam.add_reference(jnp.asarray(_clips(2, 4)))
    assert len(jam.stem_reference.radii["radii_10"]) == 12
    assert jam.stem_reference.n == 16
    f = tmp_path / "stale_radii.npz"
    jam.save_state(f)

    am = setup["port_am"]()
    am.load_state(f)
    assert am.stem_reference.radii == {}
    got = am.evaluate(setup["cand"])
    assert am.stem_reference.radii["radii_10"].shape == (16,)

    fresh = setup["port_am"]()
    fresh.stem_reference.add_embeddings(am.stem_reference.embeddings.clone())
    fresh.stem_reference.recompute_stats()
    want = fresh.evaluate(setup["cand"])
    for k in KEYS[3:]:
        assert got[k] == want[k], k


def _options_pair():
    """A JAX and a port instance with ``hop_dur`` and ``n_pca``, on the
    seeded projection embedder of tests/test_torch_options.py, and 4 + 4
    seeded 1 s clips in 0.5 s windows at a 0.25 s hop (12 windows a set)."""
    from test_torch_options import JaxProj, Proj, _clips

    kw = dict(metrics=METRICS, n_pca=4, win_dur=0.5, hop_dur=0.25, batch_size=8)
    return (JaxAudioMetrics(embedder=JaxProj(), device_indices=[0], **kw),
            AudioMetrics(embedder=Proj(), device="cpu", **kw),
            _clips(8, 4, 1.0), _clips(9, 4, 1.0, loudest=0.25))


def _assert_close(got, want):
    """The options' slice bounds (tests/test_torch_options.py): FAD and KD
    rel 1e-3, PRDC equal (12 projected rows a set, far from ties here)."""
    assert list(got) == KEYS
    for k in KEYS[:3]:
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    for k in KEYS[3:]:
        assert got[k] == want[k], k


def _projection_state_equal(a, b):
    sa, sb = a.__getstate__(), b.__getstate__()
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_options_state_round_trips_between_packages(tmp_path):
    """A JAX state file with ``hop_dur`` and a fitted ``stem_projection``
    (and the unfitted ``mix_projection`` that the JAX package writes
    whenever ``n_pca`` is set) loads into the port: ``hop_dur``,
    ``win_dur``, the projection's fit and the projected reference come
    back, and the port evaluates to the JAX values.  The port's state file
    loads into the JAX package the same way."""
    jam, am, ref, cand = _options_pair()
    jam.add_reference(jnp.asarray(ref))
    want = jam.evaluate(jnp.asarray(cand))
    f = tmp_path / "jax_options.npz"
    jam.save_state(f)
    port = _options_pair()[1]
    port.load_state(f)
    assert (port.win_dur, port.hop_dur) == (0.5, 0.25)
    _projection_state_equal(port.stem_projection, jam.stem_projection)
    assert port.stem_reference_pca.n == port.stem_reference.n == 12
    _assert_close(port.evaluate(cand), want)

    am.add_reference(ref)
    got = am.evaluate(cand)
    _assert_close(got, want)
    f = tmp_path / "port_options.npz"
    am.save_state(f)
    back = _options_pair()[0]
    back.load_state(f)
    assert (back.win_dur, back.hop_dur) == (0.5, 0.25)
    _projection_state_equal(back.stem_projection, am.stem_projection)
    _assert_close(back.evaluate(jnp.asarray(cand)), got)
