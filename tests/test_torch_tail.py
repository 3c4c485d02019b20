"""The evaluate tail of the port against the JAX package's, on the CPU.

The JAX package ends ``evaluate`` so (audio_metrics_tpu/audio_metrics.py:
336-494): the FAD tail dispatched after the pipeline, the other categories'
moments flushed in one pull, KD, PRDC and FAD-inf dispatched as
``(device arrays, host_reduce)``, FAD's host work on a thread while they
are pending, then one pull of every pending array; its ``timings`` carry
``finalize_pull`` and ``fad_overlapped``.  Here: ``kernel_distance``'s
``lazy`` against the JAX function's, the ``timings`` keys of both packages
over the configurations that take each branch, the results bitwise equal
to the port's functions called one after another and within the existing
tests' bounds of the JAX package's (APA's keys: tests/test_torch_apa.py::
test_pp_dummy_orders_aligned_above_shuffled), one pull in the default tail, the
thread's exception raised to the caller, and ``flush_pending_stats``
against one ``_flush`` an accumulator.  Same numpy inputs from a seed
through both packages, through the seeded projection embedder of
tests/test_torch_options.py (16-d) on 1 s clips.
"""

import functools
import threading
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.data import AudioMetricsData as JaxData
from audio_metrics_tpu.metrics.kd import kernel_distance as jax_kernel_distance
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch import audio_metrics as port_am
from audio_metrics_tpu_torch import data as port_data
from audio_metrics_tpu_torch.data import AudioMetricsData, flush_pending_stats, pull
from audio_metrics_tpu_torch.metrics import kd as port_kd
from audio_metrics_tpu_torch.metrics.fad import fad_device_tail, fad_inf_parts, frechet_distance
from audio_metrics_tpu_torch.metrics.prdc import prdc
from audio_metrics_tpu_torch.parallel.pipeline import ItemCategory
from audio_metrics_tpu_torch.testing import prdc_mismatches
from test_torch_options import JaxProj, Proj, _clips

KD_KW = dict(kid_subsets=10, kid_subset_size=20)


# -- kernel_distance(lazy=) ---------------------------------------------------
def _kd_sets():
    rng = np.random.default_rng(26)
    ref = rng.standard_normal((64, 16)).astype(np.float32)
    cand = (1.2 * rng.standard_normal((64, 16)) + 0.1).astype(np.float32)
    return cand, ref


def _port_sets(*rows):
    out = []
    for x in rows:
        amd = AudioMetricsData(device="cpu")
        amd.add(torch.from_numpy(x))
        out.append(amd)
    return out


def check_kd_lazy(kernel_distance):
    """``kernel_distance(x, y, lazy=...)`` returns what the JAX function
    returns: the dict at ``False``, a zero-argument finalize at ``True``,
    ``(arrays, host_reduce)`` at ``"parts"``; each gives the eager dict
    bitwise, and the eager dict is the JAX package's within KD's rel 1e-6
    (tests/test_torch_metrics.py)."""
    cand, ref = _kd_sets()
    jc, jr = JaxData(), JaxData()
    jc.add(cand)
    jr.add(ref)
    want = jax_kernel_distance(jc, jr, **KD_KW)
    eager = kernel_distance(*_port_sets(cand, ref), **KD_KW)
    assert isinstance(eager, dict) and list(eager) == list(want)
    for key in want:
        assert eager[key] == pytest.approx(want[key], rel=1e-6), key
    j_fin = jax_kernel_distance(jc, jr, lazy=True, **KD_KW)
    fin = kernel_distance(*_port_sets(cand, ref), lazy=True, **KD_KW)
    assert callable(j_fin) and callable(fin), type(fin)
    assert fin() == eager
    j_parts = jax_kernel_distance(jc, jr, lazy="parts", **KD_KW)
    parts = kernel_distance(*_port_sets(cand, ref), lazy="parts", **KD_KW)
    assert isinstance(j_parts, tuple) and isinstance(parts, tuple), type(parts)
    (arrays, host_reduce), (j_arrays, _) = parts, j_parts
    assert len(arrays) == len(j_arrays) == 3 and callable(host_reduce)
    assert all(isinstance(a, torch.Tensor) for a in arrays)
    assert host_reduce(pull(arrays)) == eager


def test_kernel_distance_honours_lazy_as_jax():
    check_kd_lazy(port_kd.kernel_distance)


def test_kd_subset_indices_stay_on_the_device():
    """The subset indices are uploaded once per index arrays and device,
    then reused: a second call at the same sizes uploads no index."""
    cand, ref = _kd_sets()
    port_kd._DEVICE_INDICES.clear()
    first = port_kd.kernel_distance(*_port_sets(cand, ref), **KD_KW)
    held = dict(port_kd._DEVICE_INDICES)
    assert len(held) == 1
    sets = _port_sets(cand, ref)
    with mock.patch.object(torch, "tensor", side_effect=AssertionError("an index upload")):
        again = port_kd.kernel_distance(*sets, **KD_KW)
    assert again == first
    assert all(port_kd._DEVICE_INDICES[k] is v for k, v in held.items())


# -- the evaluate tail ------------------------------------------------------------
# name: (metrics, candidate clips, AudioMetrics options, AM_TPU_FAD_TAIL)
CONFIGS = {
    "nsdev": (["fad", "kd", "prdc"], 24, {}, None),  # n = 24 > d = 16: the default tail
    "host_fad": (["fad", "kd", "prdc"], 12, {}, None),  # n <= d: FAD on the thread
    "fad": (["fad"], 24, {}, None),
    "fad_inf": (["fad", "kd", "prdc", "fad_inf"], 24, {}, None),
    "n_pca": (["fad", "kd", "prdc"], 24, dict(n_pca=4), None),
    "packed": (["fad", "kd", "prdc"], 24, {}, "packed"),
}


def _captured(am):
    """``am`` whose ``_run_pipeline`` keeps its last output in ``am.last``."""
    run = am._run_pipeline

    def keep(*args, **kwargs):
        am.last = run(*args, **kwargs)
        return am.last

    am._run_pipeline = keep
    return am


def _evaluate_pair(name, monkeypatch, am_cls=AudioMetrics):
    metrics, n, options, tail = CONFIGS[name]
    if tail is not None:
        monkeypatch.setenv("AM_TPU_FAD_TAIL", tail)
    ref, cand = _clips(31, 32, 1.0), _clips(32, n, 1.0, loudest=0.3)
    jam = _captured(JaxAudioMetrics(metrics=metrics, embedder=JaxProj(), win_dur=1.0,
                                    batch_size=64, device_indices=[0], **options))
    jam.add_reference(jnp.asarray(ref))
    want = jam.evaluate(jnp.asarray(cand))
    am = _captured(am_cls(metrics=metrics, embedder=Proj(), win_dur=1.0, batch_size=64,
                          device="cpu", **options))
    am.add_reference(ref)
    got = am.evaluate(cand)
    return am, got, jam, want


def sequential(am):
    """The metrics of ``am``'s last candidate (``am.last``) by the port's
    functions called one after another, each pulling its own arrays."""
    ref, cand = am.ensure_stem_projection(am.stem_reference, am.last[ItemCategory.stem])
    out = {}
    if "fad" in am.metrics:
        tail = None if am.stem_projection is not None else fad_device_tail(cand, ref)
        out["fad"] = frechet_distance(cand, ref) if tail is None else tail[1](pull(tail[0]))
    if "kd" in am.metrics:
        out.update(port_kd.kernel_distance(cand, ref, mesh=am.mesh))
    if "prdc" in am.metrics:
        out.update(prdc(ref, cand, max(1, min(10, len(ref), len(cand))), mesh=am.mesh))
    if "fad_inf" in am.metrics:
        arrays, reduce_fn = fad_inf_parts(cand, ref)
        out.update(reduce_fn(pull(arrays)))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tail_keys_and_values_match_jax(name, monkeypatch):
    """For each configuration the ``timings`` keys, in order, are the JAX
    package's; the results are bitwise those of the port's functions
    called in sequence on the same candidate set, in the JAX key order,
    and within the existing bounds of the JAX package's (FAD and KD rel
    1e-3, tests/test_torch_options.py; PRDC equal up to near-ties)."""
    am, got, jam, want = _evaluate_pair(name, monkeypatch)
    assert list(am.timings) == list(jam.timings), (am.timings, jam.timings)
    assert all(v >= 0 for v in am.timings.values())
    assert got == sequential(am)
    assert list(got) == list(want)
    for key in ("fad", "kernel_distance_mean", "kernel_distance_std", "fad_inf"):
        if key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-3), key
    if "prdc" in am.metrics and any(got[k] != want[k] for k in
                                    ("precision", "recall", "density", "coverage")):
        ref_p, cand_p = am.ensure_stem_projection(am.stem_reference, am.last[ItemCategory.stem])
        ref_j, cand_j = jam.ensure_stem_projection(jam.stem_reference,
                                                   jam.last[ItemCategory.stem])
        n, bad = prdc_mismatches(ref_p.embeddings, cand_p.embeddings, ref_j.embeddings,
                                 cand_j.embeddings)
        assert bad == 0, (n, got, want)


def _counting_pulls(module):
    """A patcher of ``pull`` in ``module`` (the port's ``audio_metrics`` or
    a copy of it) and in ``data`` that records each call's tensors."""
    calls = []

    def counted(tensors):
        tensors = list(tensors)
        calls.append(tensors)
        return real(tensors)

    real = port_data.pull
    stack = [mock.patch.object(module, "pull", counted),
             mock.patch.object(port_data, "pull", counted)]
    return calls, stack


def check_one_pull(module):
    """The default configuration (FAD's nsdev tail, KD, PRDC) and the same
    with FAD-inf pull once in an evaluate, that one pull carrying every
    tensor that KD, PRDC, FAD-inf and the deferred FAD tail dispatched."""
    for name, metrics in (("nsdev", ["fad", "kd", "prdc"]),
                          ("fad_inf", ["fad", "kd", "prdc", "fad_inf"])):
        _, n, _, _ = CONFIGS[name]
        am = module.AudioMetrics(metrics=metrics, embedder=Proj(), win_dur=1.0, batch_size=64,
                                 device="cpu")
        am.add_reference(_clips(31, 32, 1.0))
        dispatched = []

        def keep(fn, *args, **kwargs):
            out = fn(*args, **kwargs)
            dispatched.extend(out[0])
            return out

        calls, patches = _counting_pulls(module)
        patches += [mock.patch.object(module, f, functools.partial(keep, getattr(module, f)))
                    for f in ("kernel_distance", "prdc", "fad_inf_parts", "fad_device_tail")]
        for p in patches:
            p.start()
        try:
            am.evaluate(_clips(32, n, 1.0, loudest=0.3))
        finally:
            for p in patches:
                p.stop()
        want = 3 + 5 + 3 + (3 if "fad_inf" in metrics else 0)
        assert len(dispatched) == want, (name, len(dispatched))
        assert len(calls) == 1, (name, [len(c) for c in calls])
        assert {id(t) for t in dispatched} <= {id(t) for t in calls[0]}, name


def test_default_tail_pulls_once():
    check_one_pull(port_am)


def check_worker_error(module):
    """FAD on the host (n <= d) runs on a thread of its own while KD and
    PRDC are pending, under the caller's grad mode; an exception raised
    there reaches the caller of ``evaluate``."""
    seen = {}

    def fails(cand, ref):
        seen["thread"] = threading.current_thread() is not threading.main_thread()
        seen["grad"] = torch.is_grad_enabled()
        raise RuntimeError("planted in the FAD thread")

    am = module.AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=Proj(), win_dur=1.0,
                             device="cpu")
    am.add_reference(_clips(31, 32, 1.0))
    with mock.patch.object(module, "frechet_distance", fails), torch.no_grad():
        try:
            am.evaluate(_clips(32, 12, 1.0))
        except RuntimeError as exc:
            assert "planted in the FAD thread" in str(exc)
        else:
            raise AssertionError("the FAD thread's exception did not reach the caller")
    assert seen == {"thread": True, "grad": False}


def test_fad_thread_error_reaches_the_caller():
    check_worker_error(port_am)


# -- data.flush_pending_stats and data.pull -----------------------------------------
def _pending_sets(seed):
    """Two accumulators, each with stats and 2 or 3 pending f32 triples."""
    rng = np.random.default_rng(seed)
    out = []
    for k in (2, 3):
        amd = AudioMetricsData(store_embeddings=False, device="cpu")
        amd.add(rng.standard_normal((20, 8)))
        for _ in range(k):
            e = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32) + 0.5)
            _, s1, m2 = port_data.batch_moments(e)
            amd.add_moments_device(10, s1, m2)
        out.append(amd)
    return out


def test_flush_pending_stats_equals_one_flush_a_set():
    """``flush_pending_stats`` over two accumulators, with an extra tensor,
    merges their stats bitwise as one ``_flush`` of each does, in one pull
    that also returns the extra tensor's host copy."""
    (a, b), (a2, b2) = _pending_sets(5), _pending_sets(5)
    extra = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    calls, patches = _counting_pulls(port_am)
    with patches[1]:
        host = flush_pending_stats([a, b, a], extra=[extra])
        assert len(calls) == 1 and len(calls[0]) == 2 * (2 + 3) + 1
        assert flush_pending_stats([a, b]) is None and len(calls) == 1  # nothing pending
    assert len(host) == 1 and host[0].dtype == np.int32
    np.testing.assert_array_equal(host[0], extra.numpy())
    a2._flush()
    b2._flush()
    for got, want in ((a, a2), (b, b2)):
        assert not got._pending and got.n == want.n == got.stats()[2]
        assert np.array_equal(got.mean, want.mean) and np.array_equal(got.cov, want.cov)


def test_pull_is_bitwise_cpu_numpy():
    """``pull`` returns each tensor's ``.cpu().numpy()`` bitwise, in its
    dtype and shape (on the CPU, without a copy, as ``.cpu().numpy()``)."""
    rng = np.random.default_rng(9)
    tensors = [torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
               torch.from_numpy(rng.standard_normal(5)),
               torch.from_numpy(rng.integers(-2**40, 2**40, 7, dtype=np.int64)),
               torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 7, dtype=np.int64)).int(),
               torch.from_numpy(rng.standard_normal(6) > 0),
               torch.tensor(np.float32(3.25)) / 7]
    for got, t in zip(pull(tensors), tensors):
        want = t.cpu().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert pull([]) == []


def test_pending_stats_under_concurrent_readers():
    """Twelve reader threads (more than an 8-core host's cores) read
    ``n``, ``mean`` and ``stats()`` of one accumulator (each read may
    flush) while the main thread queues 200 triples, with a switch
    interval of 1 us: every count read lies between 0 and the rows queued
    and never falls, and the final stats equal a serial merge of the same
    triples bitwise (a triple merged twice or lost would break both).  A
    deep copy with triples pending keeps its own lock and merges them
    alike."""
    import copy
    import sys

    rng = np.random.default_rng(3)
    triples = [port_data.batch_moments(torch.from_numpy(
        rng.standard_normal((4, 6)).astype(np.float32)))[1:] for _ in range(200)]
    serial = AudioMetricsData(store_embeddings=False, device="cpu")
    for s1, m2 in triples:
        serial.add_moments_device(4, s1, m2)
    twin = copy.deepcopy(serial)
    serial_stats = serial.stats()
    shared = AudioMetricsData(store_embeddings=False, device="cpu")
    done, bad = threading.Event(), []

    def read():
        last = 0
        while not done.is_set():
            n = shared.n or 0
            shared.stats() if n % 3 else shared.mean
            if not last <= n <= 4 * len(triples):
                bad.append((last, n))
            last = n

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    readers = [threading.Thread(target=read) for _ in range(12)]
    try:
        for t in readers:
            t.start()
        for s1, m2 in triples:
            shared.add_moments_device(4, s1, m2)
    finally:
        done.set()
        for t in readers:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers) and not bad, bad[:3]
    for got in (shared.stats(), twin.stats()):
        assert got[2] == serial_stats[2] == 4 * len(triples)
        assert np.array_equal(got[0], serial_stats[0]) and np.array_equal(got[1], serial_stats[1])
