"""FAD-inf and the Newton-Schulz iteration count, the port against the JAX
package on the CPU.

- ``fad_inf_parts``: the same subsets, the intercept and slope against the
  JAX function and against the float64 oracle of tests/test_fad_inf.py;
- ``fad_inf`` through both ``AudioMetrics``: the same keys in the same
  order, the values within 1e-3 relative;
- the reference's defects, decided in the port: where the sweep cannot
  run, ``fad_inf`` and ``fad_inf_slope`` are nan with a warning naming the
  cause (the JAX package drops both keys, pinned here), n < 4 (d + 2)
  warns and computes what the JAX package computes, and the sweep runs in
  float64 where the JAX package's f32 Newton-Schulz diverges (pinned);
- ``AM_TPU_FAD_NS_ITERS``, read at each call by both packages' device
  tails.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.data import AudioMetricsData as JaxData
from audio_metrics_tpu.data import batch_moments as jax_batch_moments
from audio_metrics_tpu.metrics import fad as jax_fad
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.data import AudioMetricsData, batch_moments, pull
from audio_metrics_tpu_torch.metrics import fad as port_fad
from test_torch_options import SR, JaxProj, Proj, _clips

D = 16


def _sets(n_cand, seed=0, n_ref=300):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((n_ref, D)).astype(np.float32)
    cand = (1.1 * rng.standard_normal((n_cand, D)) + 0.05).astype(np.float32)
    return ref, cand


def _jax_data(e, store=True):
    a = JaxData(store)
    a.add(e)
    return a


def _port_data(e, store=True):
    a = AudioMetricsData(store)
    a.add(torch.from_numpy(e))
    return a


def _oracle(ref, cand, seed, n_points=8, min_frac=0.25):
    """tests/test_fad_inf.py's float64 oracle: the same subsets, numpy FAD
    per subset, the fit against 1 / size."""
    n = len(cand)
    sizes = np.unique(np.round(np.linspace(max(D + 2, min_frac * n), n, n_points))
                      .astype(np.int64))
    rng = np.random.default_rng(seed)
    r = _jax_data(ref)
    fads = []
    for s in sizes:
        idx = np.arange(n) if s == n else rng.permutation(n)[:s]
        sub = cand.astype(np.float64)[idx]
        fads.append(jax_fad._frechet_distance(sub.mean(axis=0), np.cov(sub, rowvar=False),
                                              np.asarray(r.mean), np.asarray(r.cov)))
    slope, intercept = np.polyfit(1.0 / sizes.astype(np.float64), fads, 1)
    return {"fad_inf": intercept, "fad_inf_slope": slope}


def _port_reduce(fad_inf_parts, ref, cand, seed):
    arrays, reduce_fn = fad_inf_parts(_port_data(cand), _port_data(ref), seed=seed)
    return reduce_fn(tuple(a.double().numpy() for a in arrays))


def check_fad_inf_parts(fad_inf_parts):
    """The port's ``fad_inf_parts`` against the JAX function on the same
    embeddings and seed (1e-4 of max(1, |value|)) and against the float64
    oracle (tests/test_fad_inf.py's bounds, 5e-3 and 2e-2), at n = 400 and
    at n = 60 < 4 (d + 2), where the port warns."""
    for n, seed in ((400, 7), (60, 3)):
        ref, cand = _sets(n, seed)
        arrays, reduce_fn = jax_fad.fad_inf_parts(_jax_data(cand), _jax_data(ref), seed=seed)
        want = reduce_fn(jax.device_get(arrays))
        oracle = _oracle(ref, cand, seed)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = _port_reduce(fad_inf_parts, ref, cand, seed)
        assert any("4 (d + 2)" in str(w.message) for w in caught) == (n < 4 * (D + 2))
        assert list(got) == ["fad_inf", "fad_inf_slope"]
        for key, tol in (("fad_inf", 5e-3), ("fad_inf_slope", 2e-2)):
            assert abs(got[key] - want[key]) < 1e-4 * max(1.0, abs(want[key])), (n, key)
            assert abs(got[key] - oracle[key]) < tol * max(1.0, abs(oracle[key])), (n, key)


def test_fad_inf_parts_matches_jax_and_oracle():
    check_fad_inf_parts(port_fad.fad_inf_parts)


def test_fad_inf_subsets_are_the_jax_subsets(monkeypatch):
    """The subset masks the port draws are the JAX package's, bitwise: the
    same sizes, the same ``default_rng(seed)`` permutations in the same
    call order."""
    ref, cand = _sets(120, 1)
    seen = []
    real = torch.from_numpy

    def spy(a):
        if a.ndim == 2 and a.dtype == np.float32 and a.shape[1] == len(cand):
            seen.append(a.copy())
        return real(a)

    monkeypatch.setattr(torch, "from_numpy", spy)
    port_fad.fad_inf_parts(_port_data(cand), _port_data(ref), seed=5)
    monkeypatch.undo()
    jax_masks = []
    real_asarray = jnp.asarray

    def jax_spy(a, *args, **kw):
        if isinstance(a, np.ndarray) and a.ndim == 2 and a.shape[1] == len(cand):
            jax_masks.append(a.copy())
        return real_asarray(a, *args, **kw)

    monkeypatch.setattr(jnp, "asarray", jax_spy)
    jax_fad.fad_inf_parts(_jax_data(cand), _jax_data(ref), seed=5)
    monkeypatch.undo()
    assert len(seen) == 1 and len(jax_masks) == 1
    np.testing.assert_array_equal(seen[0], jax_masks[0])
    assert seen[0].sum(axis=1)[-1] == len(cand) and len(set(seen[0].sum(axis=1))) == len(seen[0])


def _audio_metrics_pair(metrics, n_ref=48, n_cand=40):
    ref, cand = _clips(0, n_ref, 1.0), _clips(1, n_cand, 1.0)
    kw = dict(metrics=metrics, win_dur=1.0, input_sr=SR, batch_size=16)
    jam = JaxAudioMetrics(embedder=JaxProj(), device_indices=[0], **kw)
    jam.add_reference(jnp.asarray(ref))
    am = AudioMetrics(embedder=Proj(), device="cpu", **kw)
    am.add_reference(ref)
    return jam, am, cand


def test_fad_inf_through_audio_metrics_matches_jax():
    """``fad_inf`` among the stems metrics of both ``AudioMetrics``: the
    JAX package's keys in its order (fad, KD, PRDC, then fad_inf and its
    slope), the values within 1e-3 relative; the port records
    ``fad_inf_dispatch``; a second evaluate gives the same values."""
    jam, am, cand = _audio_metrics_pair(["fad", "kd", "prdc", "fad_inf"], n_cand=80)
    want = jam.evaluate(jnp.asarray(cand))
    got = am.evaluate(cand)
    assert list(got) == list(want)
    assert list(got)[-2:] == ["fad_inf", "fad_inf_slope"]
    for key in ("fad", "fad_inf", "fad_inf_slope"):
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
    assert "fad_inf_dispatch" in am.timings
    again = am.evaluate(cand)
    assert (again["fad_inf"], again["fad_inf_slope"]) == (got["fad_inf"], got["fad_inf_slope"])


@pytest.mark.parametrize("cause,match", [
    ("no_embeddings", "no stored embeddings"),
    ("few_rows", r"needs n > d \+ 1"),
    ("no_cholesky", "no Cholesky factor"),
    ("one_size", "fewer than two distinct points"),
])
def test_fad_inf_unavailable_is_nan_with_a_warning(cause, match):
    """Where the sweep cannot run, the port's ``fad_inf_parts`` raises
    ``FadInfUnavailable`` naming the cause, and ``AudioMetrics`` returns
    both keys as nan with one warning carrying it; the JAX function
    returns None (or, for one distinct size, fits a line through one
    point, which the port refuses)."""
    ref, cand = _sets(200, 4)
    c, r = _port_data(cand), _port_data(ref)
    if cause == "no_embeddings":
        c = _port_data(cand, store=False)
    elif cause == "few_rows":
        c = _port_data(cand[: D + 1])
    elif cause == "no_cholesky":
        r = _port_data(np.repeat(ref[:, :1], D, axis=1))  # rank 1
    else:
        c = _port_data(cand[: D + 2])  # sizes [d + 2]: one point
    with pytest.raises(port_fad.FadInfUnavailable, match=match):
        port_fad.fad_inf_parts(c, r)
    with pytest.warns(UserWarning, match=f"fad_inf and fad_inf_slope are nan: .*{match}"):
        arrays, reduce_fn = AudioMetrics._fad_inf_parts(c, r)
    assert arrays == ()  # nothing to pull: the dispatch raised before the sweep
    out = reduce_fn(pull(arrays))
    assert list(out) == ["fad_inf", "fad_inf_slope"] and all(np.isnan(v) for v in out.values())


def test_jax_drops_fad_inf_where_it_cannot_run():
    """The reference's defect, pinned: with fewer candidate windows than d
    + 2 the JAX package returns no ``fad_inf`` key at all, without a
    warning; the port returns both keys as nan and warns."""
    jam, am, _ = _audio_metrics_pair(["fad", "fad_inf"])
    cand = _clips(2, D, 1.0)  # 16 windows: n <= d + 1
    want = jam.evaluate(jnp.asarray(cand))
    assert "fad_inf" not in want and "fad_inf_slope" not in want
    with pytest.warns(UserWarning, match="needs n > d"):
        got = am.evaluate(cand)
    assert list(got) == ["fad", "fad_inf", "fad_inf_slope"]
    assert np.isnan(got["fad_inf"]) and np.isnan(got["fad_inf_slope"])
    assert got["fad"] == pytest.approx(want["fad"], rel=1e-5)


def _jax_tail(cand, ref):
    c = JaxData()
    _, s1, m2 = jax.jit(jax_batch_moments)(cand)
    c.add_moments_device(len(cand), s1, m2)
    arrays, finish, _ = jax_fad.fad_device_tail(c, _jax_data(ref))
    return finish(jax.device_get(arrays))


def _port_tail(cand, ref):
    c = AudioMetricsData()
    _, s1, m2 = batch_moments(torch.from_numpy(cand))
    c.add_moments_device(len(cand), s1, m2)
    arrays, finish, defer = port_fad.fad_device_tail(c, _port_data(ref))
    assert defer  # nsdev: the arrays ride the evaluate's last pull
    return finish(pull(arrays))


def test_ns_iters_variable_moves_the_device_tail_as_in_jax(monkeypatch):
    """``AM_TPU_FAD_NS_ITERS=5``: the port's device-tail FAD equals the JAX
    package's ``nsdev`` tail at 5 iterations within the device tail's rel
    1e-5 (tests/test_fad_device_tail.py:81), and both differ from the FAD
    at the default 30 by far more (5 iterations have not converged).  The
    port's count was the constant 30 before, which reads the 30-iteration
    FAD here."""
    ref, cand = _sets(200, 0)
    default = _port_tail(cand, ref)
    monkeypatch.setenv("AM_TPU_FAD_NS_ITERS", "5")
    want, got = _jax_tail(cand, ref), _port_tail(cand, ref)
    assert got == pytest.approx(want, rel=1e-5)
    assert abs(got - default) > 100 * 1e-5 * abs(default)
    monkeypatch.delenv("AM_TPU_FAD_NS_ITERS")
    assert _port_tail(cand, ref) == default


def test_fad_inf_holds_where_the_f32_sweep_diverges():
    """A candidate near a 10-dimensional subspace of d = 16 (isotropic
    noise at 1e-5): ``M = L^T C_s L`` has eigenvalues ~1e-10 of its
    largest, and the JAX package's f32 Newton-Schulz sweep returns nan (its
    defect, pinned here; on the card, HTSAT-base embeddings did the same at
    d = 512, PERF.md).  The port's float64 sweep reads the float64 oracle
    within 1e-6 of max(1, |value|)."""
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((400, D)).astype(np.float32)
    cand = (rng.standard_normal((200, 10)) @ rng.standard_normal((10, D))
            + 1e-5 * rng.standard_normal((200, D))).astype(np.float32)
    arrays, reduce_fn = jax_fad.fad_inf_parts(_jax_data(cand), _jax_data(ref), seed=1)
    assert np.isnan(reduce_fn(jax.device_get(arrays))["fad_inf"])
    got, want = _port_reduce(port_fad.fad_inf_parts, ref, cand, 1), _oracle(ref, cand, 1)
    for key in got:
        assert abs(got[key] - want[key]) < 1e-6 * max(1.0, abs(want[key])), key
