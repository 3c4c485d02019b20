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
    check_depth,
    column_splits,
    knn_radii,
    pairwise_stats,
    prdc_device,
)
from audio_metrics_tpu_torch.testing import near_duplicate_rows, stats_mismatches

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


# ---- the PRDC statistics kernel (#5) on the kNN kernel's product loop ----
#
# Blocks (128-row reference tile, candidate column split) as
# ``column_splits`` sizes them; each 128 x 128 tile's distances reduce to a
# count and an any per column, combined across row tiles as atomicAdd and
# atomicOr combine them, and to an any and a min per row, carried across the
# split's tiles and combined across splits as atomicOr and atomicMin do.
# Emulated here on the plain version's own distances, the reductions must
# equal ``pairwise_stats_plain`` exactly; on distances from the kernel's
# product order (f32 FMAs in depth order from 0, each an exact float64
# product and sum rounded to f32), they equal it up to near-ties, and
# ``ref_min`` within rtol 1e-5 / atol 1e-6.

SMS = 132  # an H100's SM count; the wrapper takes the card's own


def _fma_chain_dists(ref, cand):
    dot = torch.zeros((ref.shape[0], cand.shape[0]), dtype=torch.float32)
    for c in range(ref.shape[1]):
        dot = (dot.double() + ref[:, c, None].double() * cand[None, :, c].double()).float()
    sq_r, sq_c = (ref * ref).sum(1), (cand * cand).sum(1)
    return torch.sqrt(torch.clamp((sq_r[:, None] + sq_c[None, :]) - 2.0 * dot, min=0.0))


def _plain_dists(ref, cand):
    sq_r, sq_c = (ref * ref).sum(1), (cand * cand).sum(1)
    return torch.sqrt(torch.clamp((sq_r[:, None] + sq_c[None, :]) - 2.0 * (ref @ cand.T),
                                  min=0.0))


def _stats_tiled(dist, rr, cr, count_stored=False):
    """The kernel's reductions over ``dist`` (n_ref, n_cand), tile by tile;
    ``count_stored`` stores each tile's count where the kernel adds it."""
    n_ref, n_cand = dist.shape
    splits, split_cols = column_splits(n_ref, n_cand, SMS)
    cand_count = torch.zeros(n_cand, dtype=torch.int32)
    cand_any = torch.zeros(n_cand, dtype=torch.bool)
    ref_any = torch.zeros(n_ref, dtype=torch.bool)
    ref_min = torch.full((n_ref,), float("inf"))
    for r0 in range(0, n_ref, 128):
        rows = slice(r0, min(n_ref, r0 + 128))
        for s in range(splits):
            any_r = torch.zeros(rows.stop - r0, dtype=torch.bool)
            min_r = torch.full((rows.stop - r0,), float("inf"))
            c_end = min(n_cand, (s + 1) * split_cols)
            for c0 in range(s * split_cols, c_end, 128):
                cols = slice(c0, min(c_end, c0 + 128))
                d = dist[rows, cols]
                count = (d < rr[rows, None]).sum(0, dtype=torch.int32)
                cand_count[cols] = count if count_stored else cand_count[cols] + count
                cand_any[cols] |= count > 0
                any_r |= (d < cr[None, cols]).any(1)
                min_r = torch.minimum(min_r, d.min(1).values)
            ref_any[rows] |= any_r
            ref_min[rows] = torch.minimum(ref_min[rows], min_r)
    return cand_any, cand_count, ref_any, ref_min


def _stats_sets(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "near-duplicates":  # unit rows in groups of 8; ref and cand share the groups
        x = near_duplicate_rows(600, 64, seed=5, device="cpu")
        return x[0::2].contiguous(), x[1::2].contiguous()
    n, m = {"gaussian 100 x 77": (100, 77), "gaussian 300 x 129": (300, 129),
            "gaussian 1000 x 1237": (1000, 1237)}[kind]
    ref = rng.normal(size=(n, 512)).astype(np.float32)
    cand = (0.05 + 1.02 * rng.normal(size=(m, 512))).astype(np.float32)
    return torch.from_numpy(ref), torch.from_numpy(cand)


@pytest.mark.parametrize("kind", ["gaussian 100 x 77", "gaussian 300 x 129",
                                  "gaussian 1000 x 1237", "near-duplicates"])
def test_stats_tile_reductions_match_plain(kind):
    ref, cand = _stats_sets(kind)
    k = 3 if kind == "near-duplicates" else 10
    rr, cr = knn_radii(ref, k), knn_radii(cand, k)
    want = pairwise_stats(ref, cand, rr, cr)  # CPU tensors: the plain version
    got = _stats_tiled(_plain_dists(ref, cand), rr, cr)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < float(want[0].float().mean()) < 1 or kind == "near-duplicates"
    got = _stats_tiled(_fma_chain_dists(ref, cand), rr, cr)
    n_diff, bad = stats_mismatches(ref, cand, got, want, (rr, cr))
    assert bad == 0, f"{bad} of {n_diff} differing elements are not near-ties"
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-6)
    if ref.shape[0] > 128:  # the check can fail: counts stored, not added, across row tiles
        stored = _stats_tiled(_plain_dists(ref, cand), rr, cr, count_stored=True)
        assert not torch.equal(stored[1], want[1])


def test_stats_grid_and_depth_check():
    """N = M = 2048 fills an H100: 16 row tiles x 16 one-tile splits; large
    sets: about four blocks per SM.  Rows are read in 16-byte chunks."""
    assert column_splits(2048, 2048, SMS) == (16, 128)
    for n, m in ((10000, 12345), (20480, 20480), (100, 77)):
        splits, split_cols = column_splits(n, m, SMS)
        assert split_cols % 128 == 0 and (splits - 1) * split_cols < m <= splits * split_cols
        assert -(-n // 128) * splits >= 4 * SMS or split_cols == 128
    check_depth("pairwise_stats", 512)
    with pytest.raises(NotImplementedError, match="16-byte"):
        check_depth("pairwise_stats", 6)
