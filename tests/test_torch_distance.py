"""PRDC of the port against the JAX package, on the CPU.

The plain versions of the two distance kernels (k-NN radii, pairwise
statistics) are held against the JAX package's XLA path and its Pallas
kernels in interpret mode, on the same numpy inputs; ``prdc()`` against the
JAX ``prdc()`` on identical embeddings.  Also the two repairs of the port's
caches: the PRDC radii are dropped when a reference grows, and the KD
reference sums are keyed on the values that determine the subset indices.

Tolerances: radii rtol 1e-4, atol 1e-5, the JAX suite's bound for kernel vs
XLA (tests/test_pallas_distance.py:20), since f32 products summed in
another order move |a|^2 + |b|^2 - 2 a.b by a few ulps of the norms.
Booleans and counts are equal except where a float64 recomputation shows a
pair within 1e-5 relative of its radius (``stats_mismatches``); ``ref_min``
rtol 1e-5, atol 1e-6 (test_pallas_distance.py:38).  PRDC values on
identical embeddings are equal.
"""

import numpy as np
import pytest
import torch

from audio_metrics_tpu.data import AudioMetricsData as JaxData
from audio_metrics_tpu.metrics.prdc import (
    nearest_neighbour_distances,
    pairwise_distance_stats,
    prdc as jax_prdc,
)
from audio_metrics_tpu.ops.distance import knn_radii_pallas, pairwise_stats_pallas
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.data import AudioMetricsData
from audio_metrics_tpu_torch.metrics.kd import kernel_distance
from audio_metrics_tpu_torch.metrics.prdc import prdc
from audio_metrics_tpu_torch.ops.distance import (
    knn_radii,
    pairwise_stats,
    prdc_device,
)
from audio_metrics_tpu_torch.testing import stats_mismatches

PRDC_KEYS = ("precision", "recall", "density", "coverage")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,k,d", [(600, 5, 24), (2100, 10, 24), (40, 3, 24), (300, 4, 512)])
def test_knn_radii_plain_matches_xla(n, k, d):
    """Against the blocked XLA path; 2100 rows cross the 2048-row block."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    np.testing.assert_allclose(knn_radii(_t(x), k).numpy(), nearest_neighbour_distances(x, k),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,k", [(600, 5), (40, 3)])
def test_knn_radii_plain_matches_pallas(n, k):
    """Against the TPU kernel itself, interpret mode; 600 rows are ragged
    against both of its tiles (512 x 1024)."""
    rng = np.random.default_rng(n + 1)
    x = rng.normal(size=(n, 24)).astype(np.float32)
    np.testing.assert_allclose(knn_radii(_t(x), k).numpy(),
                               knn_radii_pallas(x, k, interpret=True), rtol=1e-4, atol=1e-5)


def _assert_stats_equal(ref, cand, rr, cr, got, want):
    got = tuple(_t(a) for a in got)
    want = tuple(_t(a) for a in want)
    n, bad = stats_mismatches(_t(ref), _t(cand), got, want, (_t(rr), _t(cr)))
    assert bad == 0, f"{bad} of {n} differing elements are not near-ties"
    np.testing.assert_allclose(got[3].numpy(), want[3].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_pairwise_stats_plain_matches_jax(oracle):
    """The shapes of tests/test_pallas_distance.py:23 (700 x 900, d = 16),
    ragged against every tile."""
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(700, 16)).astype(np.float32)
    cand = rng.normal(loc=0.2, size=(900, 16)).astype(np.float32)
    k = 4
    rr, cr = nearest_neighbour_distances(ref, k), nearest_neighbour_distances(cand, k)
    if oracle == "xla":
        want = pairwise_distance_stats(ref, cand, rr, cr, k)
    else:
        want = pairwise_stats_pallas(ref, cand, rr, cr, interpret=True)
    got = pairwise_stats(_t(ref), _t(cand), _t(rr), _t(cr))
    assert [g.dtype for g in got] == [torch.bool, torch.int32, torch.bool, torch.float32]
    _assert_stats_equal(ref, cand, rr, cr, [g.numpy() for g in got], want)


def test_stats_mismatches_flags_a_wrong_count():
    """The near-tie rule explains rounding flips only: a count off by one
    at a candidate with no pair near a radius is reported."""
    rng = np.random.default_rng(3)
    ref = _t(rng.normal(size=(200, 16)).astype(np.float32))
    cand = _t(rng.normal(size=(150, 16)).astype(np.float32))
    rr, cr = knn_radii(ref, 3), knn_radii(cand, 3)
    want = pairwise_stats(ref, cand, rr, cr)
    assert stats_mismatches(ref, cand, want, want, (rr, cr)) == (0, 0)
    got = list(want)
    got[1] = want[1].clone()
    got[1][7] += 1
    assert stats_mismatches(ref, cand, got, want, (rr, cr)) == (1, 1)


def _sets(d, n_ref, n_cand, seed):
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(n_ref, d)).astype(np.float32)
    cand = (0.1 + 1.1 * rng.normal(size=(n_cand, d))).astype(np.float32)
    return ref, cand


def _pair(ref, cand):
    jr, jc = JaxData(), JaxData()
    jr.add(ref)
    jc.add(cand)
    pr, pc = AudioMetricsData(), AudioMetricsData()
    pr.add_embeddings(_t(ref))
    pc.add_embeddings(_t(cand))
    return (jr, jc), (pr, pc)


@pytest.mark.parametrize("warm", [False, True])
def test_prdc_matches_jax(warm):
    """Equal values on identical embeddings, with the reference radii cold
    (computed here) or warm (cached from an earlier call); both objects end
    with their radii cached."""
    ref, cand = _sets(32, 300, 260, seed=5)
    k = 5
    (jr, jc), (pr, pc) = _pair(ref, cand)
    if warm:
        jr.get_radii(k)
        pr.get_radii(k)
        assert set(pr.radii) == {f"radii_{k}"}
    want = jax_prdc(jr, jc, k)
    got = prdc(pr, pc, k)
    assert list(got) == list(PRDC_KEYS)
    for key in PRDC_KEYS:
        assert got[key] == want[key], key
    assert 0 < got["precision"] < 1 and 0 < got["coverage"] < 1
    for amd in (pr, pc):
        assert amd.radii[f"radii_{k}"].shape == (amd.embeddings.shape[0],)


def test_prdc_device_reuses_given_radii():
    ref, cand = (_t(a) for a in _sets(16, 120, 90, seed=6))
    cold = prdc_device(ref, cand, 4)
    warm = prdc_device(ref, cand, 4, ref_radii=cold[0])
    assert warm[0] is cold[0]
    for c, w in zip(cold, warm):
        assert torch.equal(c, w)


def test_prdc_same_set_is_one():
    """A set against itself: every point lies in its own ball."""
    ref, _ = _sets(16, 150, 1, seed=7)
    pr, pc = AudioMetricsData(), AudioMetricsData()
    pr.add_embeddings(_t(ref))
    pc.add_embeddings(_t(ref))
    got = prdc(pr, pc, 5)
    assert got["precision"] == got["recall"] == got["coverage"] == 1.0


class _LinearEmbedder:
    """A cheap deterministic embedder: 100-sample windows at 100 Hz through
    a fixed linear map to 16 dimensions."""

    sr = 100
    device = torch.device("cpu")
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(100, 16)).astype(np.float32))

    def embed(self, audio):
        return audio @ self.w


def _audio(seed, n):
    return np.random.default_rng(seed).normal(size=(n, 100)).astype(np.float32)


def test_radii_dropped_when_reference_grows():
    """add_reference -> evaluate -> add_reference -> evaluate equals a fresh
    instance given the whole reference at once (the JAX package keeps the
    first reference's radii here; the port drops them)."""
    r1, r2, cand = _audio(1, 40), _audio(2, 30), _audio(3, 50)
    am = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=_LinearEmbedder(),
                      win_dur=1.0, device="cpu")
    am.add_reference(r1)
    first = am.evaluate(cand)
    assert am.stem_reference.radii
    am.add_reference(r2)
    assert not am.stem_reference.radii
    again = am.evaluate(cand)
    fresh = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=_LinearEmbedder(),
                         win_dur=1.0, device="cpu")
    fresh.add_reference(np.concatenate([r1, r2]))
    want = fresh.evaluate(cand)
    assert list(again) == ["fad", "kernel_distance_mean", "kernel_distance_std", *PRDC_KEYS]
    for key in PRDC_KEYS:
        assert again[key] == want[key], key
    assert again["fad"] == pytest.approx(want["fad"], rel=1e-9)
    assert first != again


def test_radii_dropped_by_iadd_and_recompute():
    a, b = AudioMetricsData(), AudioMetricsData()
    a.add_embeddings(_t(_audio(4, 20)))
    a.recompute_stats()
    b.add_embeddings(_t(_audio(5, 20)))
    b.recompute_stats()
    a.get_radii(3)
    a += b
    assert a.radii == {}
    assert a.get_radii(3).shape == (40,)
    a.recompute_stats()
    assert a.radii == {}


def test_kd_reference_cache_over_many_candidate_sizes():
    """Candidates of more sizes than the subset-index cache holds (8),
    twice over, against one reference object: each equals a cold
    kernel_distance on a fresh reference object."""
    rng = np.random.default_rng(8)
    ref = _t(rng.normal(size=(60, 8)).astype(np.float32))
    shared = AudioMetricsData()
    shared.add_embeddings(ref)
    for n1 in [*range(12, 34, 2), *range(12, 34, 2)]:
        cand = AudioMetricsData()
        cand.add_embeddings(_t(rng.normal(size=(n1, 8)).astype(np.float32)))
        fresh = AudioMetricsData()
        fresh.add_embeddings(ref)
        kw = dict(kid_subsets=5, kid_subset_size=10)
        assert kernel_distance(cand, shared, **kw) == kernel_distance(cand, fresh, **kw), n1
