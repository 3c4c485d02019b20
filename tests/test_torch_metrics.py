"""FAD and KD of the port against the JAX package on identical embeddings."""

import numpy as np
import pytest
import torch

from audio_metrics_tpu.data import AudioMetricsData as JaxData
from audio_metrics_tpu.metrics.fad import frechet_distance as jax_frechet_distance
from audio_metrics_tpu.metrics.kd import (
    _subset_indices as jax_subset_indices,
    kid_features_to_metric,
    mmd2 as jax_mmd2,
)
from audio_metrics_tpu_torch.data import AudioMetricsData, batch_moments, pull
from audio_metrics_tpu_torch.metrics.fad import fad_device_tail, frechet_distance
from audio_metrics_tpu_torch.metrics.kd import _subset_indices, kernel_distance, mmd2


def _sets(d, n_ref, n_cand, seed=0, rank=None):
    """Correlated Gaussian embedding sets whose distributions differ."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((rank or d, d)) / np.sqrt(d)
    ref = rng.standard_normal((n_ref, rank or d)) @ mix
    cand = 1.3 * rng.standard_normal((n_cand, rank or d)) @ mix + 0.2
    return ref.astype(np.float32), cand.astype(np.float32)


def _port_data(e: np.ndarray, f64_stats: bool) -> AudioMetricsData:
    amd = AudioMetricsData()
    amd.add_embeddings(torch.from_numpy(e))
    if f64_stats:  # the host f64 statistics the JAX package's add() computes
        e64 = e.astype(np.float64)
        amd.mean, amd.cov, amd.n = e64.mean(0), np.cov(e64, rowvar=False), len(e)
    else:
        amd.recompute_stats()
    return amd


@pytest.mark.parametrize("d,n,rank", [(32, 96, None), (64, 40, None), (48, 200, 8)])
def test_fad_f64_path_matches_jax(d, n, rank):
    """Host float64 FAD on identical embeddings: 1e-6 relative (the verify
    skill's bound for FAD against the reference), across a full-rank
    candidate, n < d (rank-deficient covariances, eigh route) and a low-rank
    embedding."""
    ref, cand = _sets(d, n, n, seed=d + n, rank=rank)
    jr, jc = JaxData(), JaxData()
    jr.add(ref)
    jc.add(cand)
    want = jax_frechet_distance(jc, jr)
    got = frechet_distance(_port_data(cand, True), _port_data(ref, True))
    assert got == pytest.approx(want, rel=1e-6)


def test_fad_device_tail_matches_host_f64():
    """The nsdev tail (f32 similarity transform + Newton-Schulz) against the
    JAX host f64 path on a full-rank candidate: rel 1e-5, the bound of
    tests/test_fad_device_tail.py:81."""
    d, n = 32, 96
    ref, cand = _sets(d, n, n, seed=7)
    jr, jc = JaxData(), JaxData()
    jr.add(ref)
    jc.add(cand)
    want = jax_frechet_distance(jc, jr)
    c = AudioMetricsData()
    _, s1, m2 = batch_moments(torch.from_numpy(cand))
    c.add_moments_device(n, s1, m2)
    tail = fad_device_tail(c, _port_data(ref, True))
    assert tail is not None
    arrays, finish, defer = tail
    assert defer  # nsdev: the arrays ride the evaluate's last pull
    got = finish(pull(arrays))
    assert got == pytest.approx(want, rel=1e-5)
    assert len(c._pending) == 1  # the candidate's moments stay pending
    # and the flushed f32 moments reproduce the f64 statistics
    np.testing.assert_allclose(c.stats()[1], np.cov(cand.astype(np.float64), rowvar=False),
                               rtol=1e-5, atol=1e-6)


def test_fad_device_tail_declines_rank_deficient():
    ref, cand = _sets(64, 40, 40)
    c = AudioMetricsData()
    c.add_moments_device(40, *batch_moments(torch.from_numpy(cand))[1:])
    assert fad_device_tail(c, _port_data(ref, True)) is None  # n <= d


@pytest.mark.parametrize("kernel_type", ["polynomial", "rbf"])
def test_kd_matches_jax(kernel_type):
    """KD on identical f32 embeddings: subset indices bit-identical to the
    JAX package (same default_rng(1234) call order); mean and std within
    1e-6 relative (f32 Gram entries summed in another order, f64 finals)."""
    ref, cand = _sets(32, 300, 250, seed=3)
    kw = dict(kid_subsets=20, kid_subset_size=100, kernel_type=kernel_type)
    want = kid_features_to_metric(cand, ref, **kw)
    got = kernel_distance(_port_data(cand, False), _port_data(ref, False), **kw)
    for i, j in zip(_subset_indices(250, 300, 20, 100, 1234),
                    jax_subset_indices(250, 300, 20, 100, 1234)):
        np.testing.assert_array_equal(i, j)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_kd_reference_cache_is_reused():
    ref, cand = _sets(16, 120, 120, seed=4)
    r = _port_data(ref, False)
    first = kernel_distance(_port_data(cand, False), r, kid_subsets=5, kid_subset_size=50)
    cached = [v for k, v in r.cache.items() if k[0] == "kd_ref"]
    assert len(cached) == 1
    again = kernel_distance(_port_data(cand, False), r, kid_subsets=5, kid_subset_size=50)
    assert again == first
    assert [v for k, v in r.cache.items() if k[0] == "kd_ref"][0][1] is cached[0][1]


class _LinearEmbedder:
    """Full-rank linear embedding of the first 256 samples (the JAX suite's
    FullRankEmbedder, tests/test_fad_device_tail.py:23-45)."""

    sr = 16000
    device = torch.device("cpu")

    def __init__(self):
        rng = np.random.default_rng(7)
        self.w = rng.standard_normal((256, 32)).astype(np.float32)

    def embed(self, audio):
        return audio[:, :256] @ torch.from_numpy(self.w)


def test_audio_metrics_takes_device_tail_and_matches_jax(monkeypatch):
    """Through AudioMetrics with n > d the FAD comes from the device tail
    (the host path is made to fail) and matches the JAX package's
    AudioMetrics on the same embedder and clips: FAD rel 1e-5 (both f32
    Newton-Schulz tails; the JAX suite's device-tail bound), KD rel 1e-5
    (f32 Gram sums in another order, distributions apart)."""
    import jax.numpy as jnp

    from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
    from audio_metrics_tpu.models.base import Embedder as JaxEmbedder
    import audio_metrics_tpu_torch.audio_metrics as am_mod
    from audio_metrics_tpu_torch import AudioMetrics

    lin = _LinearEmbedder()

    class JaxLinear(JaxEmbedder):
        sr = 16000

        def forward(self, data):
            return {"embedding": jnp.dot(jnp.asarray(data["audio"])[:, :256], lin.w)}

        @property
        def embed_fn(self):
            return lambda params, audio: jnp.dot(audio[:, :256], lin.w)

    rng = np.random.default_rng(0)
    ref = (0.2 * rng.standard_normal((96, 16000))).astype(np.float32)
    cand = (0.3 * rng.standard_normal((96, 16000))).astype(np.float32)
    jam = JaxAudioMetrics(metrics=["fad", "kd"], embedder=JaxLinear(), win_dur=1.0,
                          input_sr=16000, batch_size=32, device_indices=[0])
    jam.add_reference(jnp.asarray(ref))
    want = jam.evaluate(jnp.asarray(cand))

    def no_host_path(*a, **k):
        raise AssertionError("host FAD path taken although n > d")

    monkeypatch.setattr(am_mod, "frechet_distance", no_host_path)
    am = AudioMetrics(metrics=["fad", "kd"], embedder=lin, win_dur=1.0, input_sr=16000,
                      batch_size=32, device="cpu")
    am.add_reference(ref)
    got = am.evaluate(cand)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_mmd2_formula_matches_jax():
    rng = np.random.default_rng(9)
    k = [rng.random((20, 20)) for _ in range(3)]
    for est in ("biased", "unbiased", "u-statistic"):
        assert mmd2(*k, mmd_est=est) == jax_mmd2(*k, mmd_est=est)
