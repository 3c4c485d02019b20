"""The public surface beyond ``AudioMetrics``, the port against the JAX
package on the CPU: ``AudioMetricsData`` as a user's accumulator, the
metric functions on raw features and the package exports.  Same seeded
numpy inputs through both packages; features n <= 256, d <= 32.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_metrics_tpu
import audio_metrics_tpu.metrics as jax_metrics
import audio_metrics_tpu.ops as jax_ops
import audio_metrics_tpu.parallel as jax_parallel
import audio_metrics_tpu.utils as jax_utils
from audio_metrics_tpu.data import AudioMetricsData as JaxData
from audio_metrics_tpu.metrics.prdc import pairwise_distance_stats as jax_pairwise_stats
from audio_metrics_tpu.models.dummy import DummyEmbedder as JaxDummy
from audio_metrics_tpu.parallel.pipeline import embedding_pipeline as jax_pipeline
import audio_metrics_tpu_torch
from audio_metrics_tpu_torch import AudioMetricsData
from audio_metrics_tpu_torch.metrics import (
    frechet_distance,
    kernel_distance,
    kid_features_to_metric,
    nearest_neighbour_distances,
    prdc,
)
from audio_metrics_tpu_torch.metrics.prdc import pairwise_distance_stats
from audio_metrics_tpu_torch.models.dummy import DummyEmbedder
from audio_metrics_tpu_torch.parallel import ItemCategory, embedding_pipeline, make_mesh
from audio_metrics_tpu_torch.testing import stats_mismatches

D = 32


def _sets(seed, n_ref=256, n_cand=200, d=D, scale=1.05, shift=0.05):
    """Correlated Gaussian sets whose distributions differ: at the default
    ``scale`` and ``shift`` every PRDC value lies inside (0, 1); KD takes
    tests/test_torch_metrics.py's 1.3 and 0.2, where the estimate is not a
    cancellation down to f32 rounding of the Gram sums."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((d, d)) / np.sqrt(d)
    ref = rng.standard_normal((n_ref, d)) @ mix
    cand = scale * rng.standard_normal((n_cand, d)) @ mix + shift
    return ref.astype(np.float32), cand.astype(np.float32)


def _port(e, store=True):
    a = AudioMetricsData(store, device="cpu")
    a.add(e)
    return a


def _jax(e, store=True):
    a = JaxData(store)
    a.add(e)
    return a


# -- AudioMetricsData: the five divergences from the JAX package -----------------
def check_pending_stats(cls):
    """Moments queued from the device (``add_moments_device``, as the embed
    loop queues them) count in ``n`` at once and merge into ``mean`` and
    ``cov`` when they are read, in arrival order."""
    rows = _sets(0, 12, 1)[0].astype(np.float64)
    a = cls(True, device="cpu")
    for part in (rows[:5], rows[5:]):
        t = torch.from_numpy(part).float()
        c = t - t.mean(dim=0)
        a.add_moments_device(len(part), t.sum(dim=0), c.T @ c)
    assert a.n == 12 and len(a) == 12
    assert a.mean is not None and a.cov is not None, "pending moments not merged on read"
    np.testing.assert_allclose(a.mean, rows.mean(0), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.cov, np.cov(rows, rowvar=False), rtol=1e-5, atol=1e-6)


def test_pipeline_set_reads_n_and_mean_as_jax():
    """``embedding_pipeline(..., store_stem_embeddings=True)`` of 6 windows:
    ``.n`` is 6 and ``.mean`` / ``.cov`` read the pending device moments, as
    in the JAX package (the parent's plain attributes read None)."""
    x = (0.3 * np.random.default_rng(1).standard_normal((3, 32000))).astype(np.float32)
    x[:, 16000:] *= 0.5
    want = jax_pipeline(jnp.asarray(x), JaxDummy(), None, stems_mode=True,
                        store_stem_embeddings=True, win_dur=1.0)[ItemCategory.stem]
    got = embedding_pipeline(torch.from_numpy(x), DummyEmbedder(device="cpu"), None,
                             stems_mode=True, store_stem_embeddings=True,
                             win_dur=1.0)[ItemCategory.stem]
    assert got.n == want.n == 6
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6)
    np.testing.assert_allclose(got.cov, want.cov, rtol=1e-5, atol=1e-9)
    check_pending_stats(AudioMetricsData)


def check_iadd_adopts_flag(cls):
    """An empty accumulator takes the flag of the set added, and keeps its
    rows; non-empty ones with other flags raise ``ValueError``."""
    rows = _sets(2, 10, 1)[0]
    a, b = cls(False, device="cpu"), cls(True, device="cpu")
    b.add(rows)
    try:
        a += b
    except ValueError as exc:
        raise AssertionError(f"the empty accumulator kept its own flag: {exc}") from exc
    assert a.store_embeddings and a.n == 10
    np.testing.assert_array_equal(a.embeddings.numpy(), rows)
    c = cls(False, device="cpu")
    c.add(rows)
    with pytest.raises(ValueError, match="store_embeddings"):
        a += c


def test_iadd_adopts_the_flag_as_jax():
    rows = _sets(2, 10, 1)[0]
    ja, jb = JaxData(False), _jax(rows)
    ja += jb
    assert ja.store_embeddings and ja.n == 10
    np.testing.assert_array_equal(ja.embeddings, rows)
    check_iadd_adopts_flag(AudioMetricsData)


def test_add_takes_numpy_and_array_likes_as_jax():
    """Numpy rows and nested lists: the JAX package's float64 stats bitwise,
    the f32 rows stored on the accumulator's device."""
    ref, cand = _sets(3, 40, 30)
    want = _jax(ref)
    want.add(cand)
    got = AudioMetricsData(device="cpu")
    got.add(ref)
    got.add(cand.tolist())
    assert got.n == want.n == 70
    np.testing.assert_array_equal(got.mean, want.mean)
    np.testing.assert_array_equal(got.cov, want.cov)
    assert got.embeddings.device.type == "cpu" and got.embeddings.dtype == torch.float32
    np.testing.assert_array_equal(got.embeddings.numpy(), want.embeddings)
    with pytest.raises(ValueError, match="2-D"):
        got.add(ref[0])


def test_add_operator_as_jax():
    """``a + b``: a new accumulator with both sets' stats and rows; neither
    operand changes."""
    ref, cand = _sets(4, 50, 20)
    want = _jax(ref) + _jax(cand)
    a, b = _port(ref), _port(cand)
    got = a + b
    assert got is not a and got.n == want.n == 70 and a.n == 50 and b.n == 20
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-12)
    np.testing.assert_allclose(got.cov, want.cov, rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(got.embeddings.numpy(), want.embeddings)
    assert len(a.embeddings) == 50


def test_embeddings_setter_and_add_moments_as_jax():
    """The ``embeddings`` setter (numpy rows onto the accumulator's device;
    None drops them) and ``add_moments(n, s1, m2, embeddings=)``."""
    ref, cand = _sets(5, 30, 40)
    want, got = JaxData(), AudioMetricsData(device="cpu")
    for a in (want, got):
        a.embeddings = ref
        a.recompute_stats()
    assert got.n == want.n == 30
    np.testing.assert_array_equal(got.embeddings.numpy(), want.embeddings)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.cov, want.cov, rtol=1e-5, atol=1e-6)
    c = cand.astype(np.float64)
    s1, m2 = c.sum(0), (c - c.mean(0)).T @ (c - c.mean(0))
    want.add_moments(40, s1, m2, embeddings=cand)
    got.add_moments(40, torch.from_numpy(s1), m2, embeddings=cand)
    assert got.n == want.n == 70
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.embeddings.numpy(), want.embeddings)
    got.embeddings = None
    assert got.embeddings is None and not got.has_embeddings


def test_entry_points_default_to_the_card():
    """Numpy rows, ``deserialize`` and the functional metrics on numpy
    default to ``cuda``: without a card they raise unless the CPU is asked
    for."""
    ref, cand = _sets(6, 20, 20)
    state = _port(ref).serialize()
    assert AudioMetricsData.deserialize(state, device="cpu").n == 20
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults do not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        AudioMetricsData().add(ref)
    with pytest.raises(RuntimeError, match="CUDA"):
        AudioMetricsData.deserialize(state)
    with pytest.raises(RuntimeError, match="CUDA"):
        nearest_neighbour_distances(ref, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        kid_features_to_metric(cand, ref)
    with pytest.raises(RuntimeError, match="CUDA"):
        frechet_distance(_port(cand), _port(ref), method="newton_schulz")


# -- the metric functions on raw features ----------------------------------------
@pytest.mark.parametrize("kw", [
    dict(kernel_type="polynomial", rng_seed=7),  # subset size 1000 shrinks to 100
    dict(kernel_type="rbf", kid_subsets=20, kid_subset_size=50, kid_sigma=3.0),
    dict(kernel_type="polynomial", kid_subsets=10, kid_subset_size=64, kid_degree=2,
         kid_gamma=0.5, kid_coef0=0.5),
])
def test_kid_features_to_metric_matches_jax(kw):
    """Within 1e-6 relative of the JAX function (the same subsets, f32 Gram
    entries summed in another order); tensors and numpy alike; equal,
    bitwise, to ``kernel_distance`` on the same rows, over a mesh of two
    CPU shards too; ``lazy`` True and ``"parts"`` equal to eager."""
    ref, cand = _sets(7, 256, 200, scale=1.3, shift=0.2)
    want = jax_metrics.kid_features_to_metric(cand, ref, **kw)
    got = kid_features_to_metric(cand, ref, device="cpu", **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert kid_features_to_metric(torch.from_numpy(cand), torch.from_numpy(ref), **kw) == got
    assert kernel_distance(_port(cand), _port(ref), **kw) == got
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert kid_features_to_metric(cand, ref, device="cpu", mesh=mesh, **kw) == got
    assert kid_features_to_metric(cand, ref, device="cpu", lazy=True, **kw)() == got
    arrays, host_reduce = kid_features_to_metric(cand, ref, device="cpu", lazy="parts", **kw)
    assert all(isinstance(a, torch.Tensor) for a in arrays)
    assert host_reduce(tuple(a.numpy() for a in arrays)) == got


def test_kid_rejects_unknown_kernel_and_bad_shapes():
    ref, cand = _sets(8, 20, 20)
    with pytest.raises(NotImplementedError, match="kernel_type"):
        kid_features_to_metric(cand, ref, device="cpu", kernel_type="linear")
    with pytest.raises(ValueError, match="shapes"):
        kid_features_to_metric(cand[:, :8], ref, device="cpu")


def test_nearest_neighbour_distances_and_stats_match_jax():
    """k-NN radii within rtol 1e-4 / atol 1e-5 of the JAX function's, f32
    on the features' device (over a mesh of two CPU shards bitwise the
    whole set's); the four reductions on the same radii: flags and counts
    equal up to near-ties, the minimum distances within the radii's
    bounds."""
    ref, cand = _sets(9)
    k = 5
    rr = nearest_neighbour_distances(ref, k, device="cpu")
    cr = nearest_neighbour_distances(torch.from_numpy(cand), k)
    assert rr.dtype == torch.float32 and rr.device.type == "cpu" and rr.shape == (256,)
    for got, x in ((rr, ref), (cr, cand)):
        np.testing.assert_allclose(got.numpy(), jax_metrics.nearest_neighbour_distances(x, k),
                                   rtol=1e-4, atol=1e-5)
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert torch.equal(nearest_neighbour_distances(ref, k, mesh=mesh, device="cpu"), rr)
    got = pairwise_distance_stats(ref, cand, rr, cr.numpy(), k, device="cpu")
    want = jax_pairwise_stats(ref, cand, rr.numpy(), cr.numpy(), k)
    assert [t.dtype for t in got] == [torch.bool, torch.int32, torch.bool, torch.float32]
    want_t = tuple(torch.from_numpy(np.array(w)) for w in want)
    n_diff, n_bad = stats_mismatches(torch.from_numpy(ref), torch.from_numpy(cand), got, want_t,
                                     (rr, cr))
    assert n_bad == 0, n_diff
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-4, atol=1e-5)
    sharded = pairwise_distance_stats(torch.from_numpy(ref), cand, rr, cr, k, mesh=mesh)
    assert all(torch.equal(a, b) for a, b in zip(sharded, got))


def test_prdc_lazy_equals_eager():
    ref, cand = _sets(10)
    want = prdc(_port(ref), _port(cand), 5)
    assert all(0.0 < v < 1.0 for v in want.values()), want
    assert prdc(_port(ref), _port(cand), 5, lazy=True)() == want
    arrays, host_reduce = prdc(_port(ref), _port(cand), 5, lazy="parts")
    assert host_reduce(tuple(a.numpy() for a in arrays)) == want
    jr, jc = _jax(ref), _jax(cand)
    jwant = jax_metrics.prdc(jr, jc, 5)
    if want != jwant:
        got_radii = (_port(ref).get_radii(5), _port(cand).get_radii(5))
        stats = pairwise_distance_stats(ref, cand, *got_radii, 5, device="cpu")
        jstats = tuple(torch.from_numpy(np.array(a)) for a in jax_pairwise_stats(
            ref, cand, jr.get_radii(5), jc.get_radii(5), 5))
        jradii = tuple(torch.from_numpy(np.array(r)) for r in (jr.get_radii(5),
                                                                  jc.get_radii(5)))
        assert stats_mismatches(torch.from_numpy(ref), torch.from_numpy(cand), stats, jstats,
                                got_radii, jradii)[1] == 0, (want, jwant)


def check_ns_method(fd):
    """``frechet_distance(method="newton_schulz")`` within rtol 1e-4 of
    ``"eigh"`` (tests/test_metrics_golden.py:75-82), at its fixed 30
    iterations whatever ``AM_TPU_FAD_NS_ITERS`` says."""
    ref, cand = _sets(11)
    x, y = _port(cand), _port(ref)
    want = fd(x, y)
    got = fd(x, y, method="newton_schulz", device="cpu")
    assert got == pytest.approx(want, rel=1e-4)
    old = os.environ.get("AM_TPU_FAD_NS_ITERS")
    os.environ["AM_TPU_FAD_NS_ITERS"] = "3"
    try:
        again = fd(x, y, method="newton_schulz", device="cpu")
    finally:
        if old is None:
            os.environ.pop("AM_TPU_FAD_NS_ITERS")
        else:
            os.environ["AM_TPU_FAD_NS_ITERS"] = old
    assert again == got


def test_frechet_distance_newton_schulz():
    """Also within rtol 1e-4 of the JAX package's ``newton_schulz`` (which
    runs in float64 under its x64 mode); an unknown method raises."""
    check_ns_method(frechet_distance)
    ref, cand = _sets(11)
    want = jax_metrics.frechet_distance(_jax(cand), _jax(ref), method="newton_schulz")
    got = frechet_distance(_port(cand), _port(ref), method="newton_schulz", device="cpu")
    assert got == pytest.approx(want, rel=1e-4)
    with pytest.raises(ValueError, match="Unknown FAD method"):
        frechet_distance(_port(cand), _port(ref), method="sqrtm")


# -- exports ------------------------------------------------------------------------
def test_exports_are_the_jax_names():
    """``import audio_metrics_tpu_torch`` exposes ``AudioMetricsData``; each
    subpackage's ``__all__`` the JAX package's names, but the three JAX
    sharding objects of ``parallel``, which have no counterpart."""
    assert set(audio_metrics_tpu.__all__) <= set(audio_metrics_tpu_torch.__all__)
    assert audio_metrics_tpu_torch.AudioMetricsData is AudioMetricsData
    not_ported = {"batch_sharding", "replicated_sharding", "DATA_AXIS"}
    import audio_metrics_tpu_torch.metrics as m
    import audio_metrics_tpu_torch.ops as o
    import audio_metrics_tpu_torch.parallel as p
    import audio_metrics_tpu_torch.utils as u

    for jax_mod, mod in ((jax_metrics, m), (jax_parallel, p), (jax_ops, o), (jax_utils, u)):
        want = set(jax_mod.__all__) - not_ported
        assert set(mod.__all__) == want, mod.__name__
        assert all(callable(getattr(mod, name)) for name in want)
