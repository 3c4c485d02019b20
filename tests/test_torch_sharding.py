"""Multi-shard evaluation of the port on the CPU.

The port's mesh (``parallel.mesh``) holds several shards on one device, as
the JAX suite runs its multi-chip paths on 8 virtual CPU devices
(tests/conftest.py).  Each case of ``tests/test_sharding.py`` runs here on
a mesh of 8 CPU shards (or a (dcn, data) layout of them) and is held
against the port on one shard and against the JAX package on its 8-device
mesh, under the JAX tests' tolerances; where the shard boundaries fall on
batch boundaries the embeddings are bitwise equal.  Then what only the
port has: the empty shards, #4's query-row range, the replicas, and the
host threads (launch counters, ``full_f32``, ``Kernel.launch``).
"""

import random
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.data import AudioMetricsData as JaxAMD
from audio_metrics_tpu.data import batch_moments as jax_batch_moments
from audio_metrics_tpu.metrics.kd import kid_features_to_metric
from audio_metrics_tpu.metrics.prdc import nearest_neighbour_distances, pairwise_distance_stats
from audio_metrics_tpu.metrics.prdc import prdc as jax_prdc
from audio_metrics_tpu.models import DummyEmbedder as JaxDummy
from audio_metrics_tpu.parallel.mesh import DATA_AXIS
from audio_metrics_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio_metrics_tpu.parallel.pipeline import _run_fused_embed
from audio_metrics_tpu_torch import AudioMetrics, kernels
from audio_metrics_tpu_torch.data import AudioMetricsData, batch_moments
from audio_metrics_tpu_torch.metrics import kd as port_kd
from audio_metrics_tpu_torch.metrics.prdc import prdc, sharded_knn_radii, sharded_pairwise_stats
from audio_metrics_tpu_torch.models import DummyEmbedder
from audio_metrics_tpu_torch.ops.distance import knn_radii, knn_radii_plain, pairwise_stats
from audio_metrics_tpu_torch.parallel import pipeline
from audio_metrics_tpu_torch.parallel.mesh import check_device_indices, make_mesh
from audio_metrics_tpu_torch.testing import stats_mismatches
from audio_metrics_tpu_torch.utils import precision

CPU = torch.device("cpu")
SR = 16000


def mesh8(dcn_slices=None):
    return make_mesh(devices=[CPU] * 8, dcn_slices=dcn_slices)


def mix_func(audio, sr=None):
    return audio.mean(axis=1)


class JaxFullRank(JaxDummy):
    """``tests/test_sharding.py``'s ``FullRankDummy``: each of 10 dims the
    std of a stride-slice of the window, full rank."""

    def forward(self, data):
        audio = jnp.asarray(data["audio"], dtype=jnp.float32)
        segs = audio.reshape(audio.shape[0], -1, 10)
        emb = 1e2 * jnp.std(segs, axis=1) * (1.0 + jnp.arange(10, dtype=jnp.float32))
        return {"embedding": emb}


class FullRank:
    """The port's side of ``JaxFullRank``; records each call's rows."""

    sr = SR
    device = CPU

    def __init__(self):
        self.batches = []

    def embed(self, audio):
        self.batches.append(audio.shape[0])
        segs = audio.float().reshape(audio.shape[0], -1, 10)
        return 1e2 * torch.std(segs, dim=1, correction=0) * (1.0 + torch.arange(10.0))


def amd(e):
    a = AudioMetricsData(True)
    a.add(torch.from_numpy(e))
    return a


def jax_amd(e):
    a = JaxAMD(True)
    a.add(e)
    return a


def close(got: dict, want: dict, rtol, atol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


# -- meshes --------------------------------------------------------------------
def test_mesh_construction():
    mesh = mesh8()
    assert mesh.size == jax_make_mesh().size == 8 and mesh.shape == (8,)
    sub = make_mesh(device_indices=[0, 2, 4, 6], device="cpu")
    assert sub.size == jax_make_mesh(device_indices=[0, 2, 4, 6]).size == 4
    assert make_mesh(device="cpu").size == 1 and mesh.home == CPU
    # the index checks, with a count of cards as on a host with 8
    assert check_device_indices(None, 8) == list(range(8))
    assert check_device_indices([3, 1], 8) == [3, 1]
    for bad in ([0, 0], [8], [-1], []):
        with pytest.raises(ValueError):
            check_device_indices(bad, 8)
    with pytest.raises(ValueError):
        make_mesh(device_indices=[1, 1], device="cpu")


def test_explicit_bad_device_indices_raise():
    with pytest.raises((RuntimeError, ValueError, IndexError)):
        JaxAudioMetrics(metrics=["fad"], embedder="dummy", device_indices=[99, 100])
    with pytest.raises(ValueError):
        check_device_indices([99, 100], 8)  # a host with 8 cards
    with pytest.raises(ValueError, match="more than once"):
        AudioMetrics(metrics=["fad"], embedder=DummyEmbedder(device="cpu"), device="cpu",
                     device_indices=[0, 0])


def test_dcn_mesh_construction():
    mesh, jmesh = mesh8(dcn_slices=2), jax_make_mesh(dcn_slices=2)
    assert mesh.axis_names == jmesh.axis_names == ("dcn", "data")
    assert mesh.shape == jmesh.devices.shape == (2, 4) and mesh.size == 8
    with pytest.raises(ValueError):
        mesh8(dcn_slices=3)
    with pytest.raises(ValueError):
        jax_make_mesh(dcn_slices=3)


# -- moments and the embed loop ---------------------------------------------
def test_sharded_moments_match_single_device():
    """Eight shards' masked moments merged in float64 on the host against
    one device's, and against the JAX package's on its sharded arrays
    (s1 rtol/atol 1e-5, the centered sum 1e-4)."""
    rng = np.random.default_rng(0)
    e = rng.normal(size=(64, 16)).astype(np.float32)
    mask = rng.random(64) < 0.7
    jmesh = jax_make_mesh()
    sharding = NamedSharding(jmesh, PartitionSpec(DATA_AXIS))
    n_j, s1_j, m2_j = jax.tree.map(np.asarray, jax_batch_moments(
        jax.device_put(e, sharding), jax.device_put(mask, sharding)))
    n1, s1, m2 = batch_moments(torch.from_numpy(e), torch.from_numpy(mask))
    merged = AudioMetricsData(False)
    for rows in np.split(np.arange(64), 8):
        n, a, b = batch_moments(torch.from_numpy(e[rows]), torch.from_numpy(mask[rows]))
        merged.add_moments_device(int(n), a, b)
    mean, cov, n = merged.stats()
    assert n == int(n1) == int(n_j)
    for got in (np.asarray(s1), mean * n):
        np.testing.assert_allclose(got, s1_j, rtol=1e-5, atol=1e-5)
    for got in (np.asarray(m2), cov * (n - 1)):
        np.testing.assert_allclose(got, m2_j, rtol=1e-4, atol=1e-4)


def check_fused_loop(sharded_embed_loop, dcn=None, n=100, batch=16):
    """``sharded_embed_loop`` on 8 shards (or a DCN layout) against the
    one-device loop: embeddings bitwise equal (the shards' blocks are whole
    batches), moments under the JAX tests' bounds (:157).  Returns the
    embeddings, the triples and the windows."""
    emb = DummyEmbedder(device="cpu")
    w = np.random.default_rng(5).normal(size=(n, 4000)).astype(np.float32)
    buf1, trip1 = pipeline.fused_embed_loop(emb.embed, torch.from_numpy(w), batch)
    buf8, trips = sharded_embed_loop([emb.embed] * 8, torch.from_numpy(w), batch, mesh8(dcn))
    assert torch.equal(buf8, buf1)
    assert len(trips) == -(-n // -(-n // (8 * batch) * batch))
    one, many = AudioMetricsData(False), AudioMetricsData(False)
    one.add_moments_device(n, trip1[1], trip1[2])
    for t in trips:
        many.add_moments_device(*t)
    assert one.stats()[2] == many.stats()[2] == n
    np.testing.assert_allclose(many.mean, one.mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(many.cov, one.cov, rtol=1e-4, atol=1e-5)
    return buf8, many, w


@pytest.mark.parametrize("dcn,n,batch", [(None, 100, 16), (4, 70, 8)])
def test_fused_embed_loop_sharded_matches_single(dcn, n, batch):
    """``check_fused_loop``, and against the JAX sharded fused loop
    (embeddings rtol 1e-5 / atol 1e-6, moments as there)."""
    buf8, many, w = check_fused_loop(pipeline.sharded_embed_loop, dcn, n, batch)
    jbuf, jtrips = _run_fused_embed(JaxDummy(), jnp.asarray(w), n, batch, jax_make_mesh(
        dcn_slices=dcn))
    np.testing.assert_allclose(buf8.numpy(), np.asarray(jbuf)[:n], rtol=1e-5, atol=1e-6)
    jx = JaxAMD(False)
    for t in jtrips:
        jx.add_moments(*t)
    assert jx.n == n
    np.testing.assert_allclose(many.mean, jx.mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(many.cov, jx.cov, rtol=1e-4, atol=1e-5)


def test_empty_shards_add_no_triple():
    """40 windows at batch 16 over 8 shards: blocks of 16, so shards 3-7
    have no rows, run nothing and add no moment triple; the merged
    statistics are the one-device ones under the JAX tests' bounds (the
    JAX layout of ``test_fad_inf_sharded_matches_single``)."""
    fr = FullRank()
    w = torch.from_numpy(np.random.default_rng(3).random((40, 5 * SR)).astype(np.float32))
    assert pipeline.shard_blocks(40, 16, 8)[2:4] == [(32, 40), (40, 40)]
    a8 = pipeline._embed_set(fr, w, 16, True, mesh8())
    assert len(a8._pending) == 3 and sorted(fr.batches) == [8, 16, 16]
    a1 = pipeline._embed_set(FullRank(), w, 16, True)
    assert torch.equal(a8.embeddings, a1.embeddings)
    (m8, c8, n8), (m1, c1, n1) = a8.stats(), a1.stats()
    assert n8 == n1 == 40
    np.testing.assert_allclose(m8, m1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c8, c1, rtol=1e-4, atol=1e-5)


# -- KD and PRDC -------------------------------------------------------------------
def check_kd_sharded(kd, dcn=None, seed=3):
    """``kd.kernel_distance`` (of the module ``kd``) on 8 shards with chunks
    of 2 subsets (a smaller chunk budget, so that every shard gets a run)
    equals its one-device value exactly.  Returns it and the features."""
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(400, 24)).astype(np.float32)
    f2 = rng.normal(loc=0.1, size=(380, 24)).astype(np.float32)
    kwargs = dict(kid_subsets=16, kid_subset_size=128)
    saved, kd.CHUNK_BYTES = kd.CHUNK_BYTES, 2 * 2 * 128 * 128 * 4
    try:
        assert all(r is not None for r in kd.shard_chunks(16, 128, 8))
        got = kd.kernel_distance(amd(f1), amd(f2), mesh=mesh8(dcn), **kwargs)
        assert got == kd.kernel_distance(amd(f1), amd(f2), **kwargs)
    finally:
        kd.CHUNK_BYTES = saved
    return got, f1, f2, kwargs


@pytest.mark.parametrize("dcn", [None, 2])
def test_kd_sharded_matches_single(dcn):
    """``check_kd_sharded``, and the JAX package's sharded KD at rtol 1e-6
    (mean) / 1e-5 (std)."""
    got, f1, f2, kwargs = check_kd_sharded(port_kd, dcn, 3 if dcn is None else 8)
    want = kid_features_to_metric(f1, f2, mesh=jax_make_mesh(dcn_slices=dcn), **kwargs)
    np.testing.assert_allclose(got["kernel_distance_mean"], want["kernel_distance_mean"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["kernel_distance_std"], want["kernel_distance_std"], rtol=1e-5)


@pytest.mark.parametrize("dcn", [None, 2])
def test_prdc_radii_sharded_matches_single(dcn):
    """Radii a block of rows a shard: bitwise the one-device radii; the
    JAX package's sharded radii at rtol 1e-4 / atol 1e-5."""
    x = np.random.default_rng(4 if dcn is None else 8).normal(size=(500, 16)).astype(np.float32)
    got = sharded_knn_radii(torch.from_numpy(x), 5, mesh8(dcn))
    assert torch.equal(got, knn_radii(torch.from_numpy(x), 5))
    want = nearest_neighbour_distances(x, 5, mesh=jax_make_mesh(dcn_slices=dcn))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_knn_query_row_range_is_the_whole_sets_rows():
    """#4's plain version over query-row blocks (any boundaries, 128-row
    tiles or not) concatenates to the whole set's radii bitwise; a range
    outside the set raises."""
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(700, 20)).astype(np.float32))
    whole = knn_radii_plain(x, 7)
    for cuts in ([0, 128, 256, 700], [0, 1, 333, 699, 700], [0, 350, 700]):
        parts = [knn_radii_plain(x, 7, a, b - a) for a, b in zip(cuts, cuts[1:])]
        assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(knn_radii(x, 7, 600), whole[600:])
    for row0, n_q in ((650, 51), (-1, 3), (5, 0)):
        with pytest.raises(ValueError):
            knn_radii_plain(x, 7, row0, n_q)


def check_stats_sweep(sharded_pairwise_stats):
    """The four reductions a block of reference rows a shard, combined,
    equal the one-device sweep (counts summed, flags OR-ed, rows
    concatenated).  Returns them and the inputs."""
    rng = np.random.default_rng(14)
    ref = rng.normal(size=(500, 16)).astype(np.float32)
    cand = rng.normal(loc=0.2, size=(430, 16)).astype(np.float32)
    rr, cr = nearest_neighbour_distances(ref, 5), nearest_neighbour_distances(cand, 5)
    t = [torch.tensor(np.asarray(a, np.float32)) for a in (ref, cand, rr, cr)]
    got = sharded_pairwise_stats(*t, mesh8())
    for g, w in zip(got, pairwise_stats(*t)):
        assert torch.equal(g, w)
    return got, (ref, cand, rr, cr), t


def test_prdc_stats_sweep_sharded_matches_single():
    """``check_stats_sweep``, and the JAX package's sharded sweep: flags
    and counts under the near-tie rule, ``ref_min`` rtol 1e-5 / atol
    1e-6."""
    got, (ref, cand, rr, cr), t = check_stats_sweep(sharded_pairwise_stats)
    want = [torch.from_numpy(np.asarray(a)) for a in
            pairwise_distance_stats(ref, cand, rr, cr, 5, mesh=jax_make_mesh())]
    np.testing.assert_allclose(got[3].numpy(), want[3].numpy(), rtol=1e-5, atol=1e-6)
    n_diff, n_bad = stats_mismatches(t[0], t[1], got, want, (t[2], t[3]))
    assert n_bad == 0, n_diff


def test_prdc_sharded_matches_single_public():
    rng = np.random.default_rng(15)
    ref_e = rng.normal(size=(600, 12)).astype(np.float32)
    cand_e = rng.normal(loc=0.15, size=(550, 12)).astype(np.float32)
    got = prdc(amd(ref_e), amd(cand_e), 5, mesh=mesh8())
    assert got == prdc(amd(ref_e), amd(cand_e), 5)
    close(got, jax_prdc(jax_amd(ref_e), jax_amd(cand_e), 5, mesh=jax_make_mesh()), rtol=1e-6)


# -- the public API ------------------------------------------------------------------
@pytest.mark.parametrize("dcn", [None, 2])
def test_pipeline_sharded_matches_unsharded(dcn):
    """Lists of 16 context+stem pairs (the host-fed path, as the JAX test's
    numpy pairs take there), fad + kd + prdc + apa, batch 16: 8 shards (or
    2 x 4 DCN) against one shard and against the JAX package's 8 devices,
    rtol 2e-3 / atol 1e-6 (FAD's square root amplifies the f32 merge
    order); the APA shuffles from the global ``random``, seeded alike.
    Against the JAX package KD is held through the stored embeddings (rtol
    1e-5): on this fixture's embeddings (norms ~1e3) the polynomial Gram
    entries reach ~1e13 while the estimate is ~1e8, so two implementations'
    f32 Gram sums differ there by ~1e-2 of it (each package's sharded run
    equals its own one-device run, whose sums round alike)."""
    rng = np.random.default_rng(1 if dcn is None else 9)
    reference = list(rng.random((16, 5 * SR, 2)).astype(np.float32))
    candidate = list(rng.random((16, 5 * SR, 2)).astype(np.float32))
    seed = 42 if dcn is None else 43
    metrics = ["fad", "kd", "prdc", "apa"]

    def port(device_indices, dcn_slices=None):
        am = AudioMetrics(metrics=metrics, embedder=FullRank(), mix_function=mix_func,
                          batch_size=16, device="cpu", device_indices=device_indices,
                          dcn_slices=dcn_slices)
        random.seed(seed)
        am.add_reference(reference)
        return am.evaluate(candidate), am

    multi, am = port(list(range(8)), dcn)
    assert am.mesh.size == 8 and am.mesh.shape == ((8,) if dcn is None else (2, 4))
    single, _ = port([0])
    close(multi, single, rtol=2e-3, atol=1e-6)
    jam = JaxAudioMetrics(embedder=JaxFullRank(), mix_function=mix_func, metrics=metrics,
                          device_indices=None, batch_size=16, dcn_slices=dcn)
    random.seed(seed)
    jam.add_reference(np.stack(reference))
    want = jam.evaluate(np.stack(candidate))
    np.testing.assert_allclose(am.stem_reference.embeddings.numpy(),
                               np.asarray(jam.stem_reference.embeddings), rtol=1e-5)
    kd = ("kernel_distance_mean", "kernel_distance_std")
    close({k: v for k, v in multi.items() if k not in kd},
          {k: v for k, v in want.items() if k not in kd}, rtol=2e-3, atol=1e-6)


def test_batch_size_rounded_to_mesh():
    """batch_size 10 over 8 shards rounds up to 16: each host batch is cut
    into 8 slices of 2 rows."""
    rng = np.random.default_rng(2)
    ref, cand = rng.random((12, 5 * SR)), rng.random((12, 5 * SR))
    fr = FullRank()
    am = AudioMetrics(embedder=fr, metrics=["fad"], batch_size=10, device="cpu",
                      device_indices=list(range(8)))
    am.add_reference(list(ref))
    out = am.evaluate(list(cand))
    assert set(fr.batches) == {2}
    single = AudioMetrics(embedder=FullRank(), metrics=["fad"], batch_size=10, device="cpu")
    single.add_reference(list(ref))
    jam = JaxAudioMetrics(embedder=JaxFullRank(), mix_function=mix_func, metrics=["fad"],
                          batch_size=10)
    jam.add_reference(ref)
    assert np.isfinite(out["fad"])
    close(out, single.evaluate(list(cand)), rtol=2e-3)
    close(out, jam.evaluate(cand), rtol=2e-3)


def test_device_resident_eval_sharded_matches_single(monkeypatch):
    """Stacked pairs on the device (the pair path: mixes on the first
    device, each category through the sharded loop), ``PP``, the dummy
    embedder: 8 shards against one (the derangement seeded alike, so that
    both draw one misaligned set) and against the JAX package's 8 devices,
    rtol 2e-4 / atol 2e-5."""
    rng = np.random.default_rng(6)

    def apairs(n):
        amp = rng.uniform(0.05, 0.5, size=(n, 1, 1))
        return (amp * rng.normal(size=(n, 5 * SR, 2))).astype(np.float32)

    ref, cand = apairs(12), apairs(12)
    derangement = pipeline.derangement
    monkeypatch.setattr(pipeline, "derangement", lambda n, seed=None: derangement(n, 7))
    kw = dict(metrics=["apa", "fad", "kd", "prdc"], mix_function="PP", win_dur=5.0,
              input_sr=SR)

    def port(device_indices):
        am = AudioMetrics(embedder=DummyEmbedder(device="cpu"), device="cpu",
                          device_indices=device_indices, **kw)
        am.add_reference(torch.from_numpy(ref))
        return am.evaluate(torch.from_numpy(cand)), am

    multi, am = port(list(range(8)))
    single, am1 = port([0])
    assert torch.equal(am.stem_reference.embeddings, am1.stem_reference.embeddings)
    close(multi, single, rtol=2e-4, atol=2e-5)
    jam = JaxAudioMetrics(embedder="dummy", device_indices=None, **kw)
    jam.add_reference(jnp.asarray(ref))
    close(multi, jam.evaluate(jnp.asarray(cand)), rtol=2e-4, atol=2e-5)


def test_fad_inf_sharded_matches_single():
    """fad + fad_inf over the gathered embeddings: 40 clips, batch 16, 8
    shards (3 with rows) against one shard and the JAX package's 8
    devices, rtol 2e-3 / atol 1e-6."""
    rng = np.random.default_rng(9)
    ref, cand = rng.random((40, 5 * SR)), rng.random((40, 5 * SR))

    def port(device_indices):
        am = AudioMetrics(embedder=FullRank(), metrics=["fad", "fad_inf"], batch_size=16,
                          device="cpu", device_indices=device_indices)
        am.add_reference(torch.from_numpy(ref))
        return am.evaluate(torch.from_numpy(cand))

    multi = port(list(range(8)))
    close(multi, port([0]), rtol=2e-3, atol=1e-6)
    jam = JaxAudioMetrics(embedder=JaxFullRank(), mix_function=mix_func,
                          metrics=["fad", "fad_inf"], batch_size=16)
    jam.add_reference(ref)
    close(multi, jam.evaluate(cand), rtol=2e-3, atol=1e-6)


def test_clap_small_sharded_matches_single():
    """The small HTSAT of ``tests/test_torch_slice.py`` in f32 through the
    public API: 8 clips, batch 4, 2 shards (whole batches) against one
    shard: embeddings bitwise, f64 reference moments rtol 1e-5 / 1e-4, the
    metrics rtol 1e-4 (FAD 5e-3); and the reference set through the JAX
    package's fused loop on its 8 devices at batch 8, the JAX test's run
    (``tests/test_sharding.py``'s moment bounds; embeddings atol 1e-6, as
    ``tests/test_torch_slice.py`` holds the one-device forward)."""
    from test_torch_slice import SMALL, _clips, _params

    from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
    from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSATConfig

    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    ref, cand = _clips(0, 8), _clips(1, 8)
    clap = LaionCLAP(params=p, cfg=cfg, device="cpu")

    def port(device_indices):
        am = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=clap, win_dur=5.0,
                          input_sr=48000, batch_size=4, device="cpu",
                          device_indices=device_indices)
        am.add_reference(torch.from_numpy(ref))
        return am.evaluate(torch.from_numpy(cand)), am

    multi, am = port([0, 1])
    single, am1 = port([0])
    assert torch.equal(am.stem_reference.embeddings, am1.stem_reference.embeddings)
    np.testing.assert_allclose(am.stem_reference.mean, am1.stem_reference.mean, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(am.stem_reference.cov, am1.stem_reference.cov, rtol=1e-4,
                               atol=1e-7)
    for k in single:
        np.testing.assert_allclose(multi[k], single[k], rtol=5e-3 if k == "fad" else 1e-4,
                                   atol=1e-6, err_msg=k)
    jbuf, jtrips = _run_fused_embed(JaxLaionCLAP(params=p, cfg=JaxHTSATConfig(**SMALL)),
                                    jnp.asarray(ref), 8, 8, jax_make_mesh())
    np.testing.assert_allclose(am.stem_reference.embeddings.numpy(), np.asarray(jbuf)[:8],
                               atol=1e-6)
    jx = JaxAMD(False)
    for t in jtrips:
        jx.add_moments(*t)
    np.testing.assert_allclose(am.stem_reference.mean, jx.mean, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(am.stem_reference.cov, jx.cov, rtol=1e-4, atol=1e-7)


# -- replicas and host threads ---------------------------------------------------
def test_replicate_copies_every_held_tensor():
    """``replicate`` on the embedder's own device: a new object whose
    tensors (the folded operands, the frontend tables) share no storage
    with the original's, embeddings bitwise equal; the mesh keeps the
    embedder itself on its device."""
    from test_torch_slice import SMALL, _clips, _params

    from audio_metrics_tpu_torch.models.base import _held_tensors
    from audio_metrics_tpu_torch.models.clap import LaionCLAP
    from audio_metrics_tpu_torch.models.htsat import HTSATConfig

    cfg = HTSATConfig(**SMALL)
    clap = LaionCLAP(params=_params(cfg), cfg=cfg, device="cpu")
    twin = clap.replicate("cpu")
    held, twin_held = _held_tensors(clap), _held_tensors(twin)
    assert twin is not clap and twin.model is not clap.model and len(held) == len(twin_held)
    assert not {t.data_ptr() for t in held} & {t.data_ptr() for t in twin_held}
    x = torch.from_numpy(_clips(2, 2))
    assert torch.equal(twin.embed(x), clap.embed(x))
    assert mesh8().replicas(clap) == [clap] * 8


def test_launch_counter_is_exact_across_threads():
    """``Kernel.count`` from 16 threads, 2000 times each, with the
    interpreter switching threads every microsecond: no update is lost."""
    k = kernels.Kernel("test", "-", "-")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [k.count() for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert k.launches == 16 * 2000


def test_launch_sets_nothing_on_the_entry_point(monkeypatch):
    """``Kernel.launch`` passes ctypes instances and sets no ``argtypes``
    or ``restype`` on the shared entry point (host threads launch at
    once)."""
    calls = []

    class Entry:
        def __call__(self, *cargs):
            calls.append(cargs)
            return 0

        def __setattr__(self, name, value):
            raise AssertionError(f"launch set {name} on the entry point")

    class Lib:
        am_test = Entry()

    monkeypatch.setattr(kernels, "build", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 5})())
    import contextlib

    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    kernels.Kernel("test", "-", "-").launch("am_test", torch.zeros(4), 3, 1.5)
    (cargs,) = calls
    assert [type(a).__name__ for a in cargs] == ["c_void_p", "c_int", "c_float", "c_void_p"]


def test_full_f32_regions_of_threads_nest():
    """TF32 stays off while any thread's region is open, and the caller's
    setting comes back when the last one ends, whatever order they end in."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        first_in, second_in, first_out = threading.Event(), threading.Event(), threading.Event()
        seen = []

        def first():
            with precision.full_f32():
                first_in.set()
                second_in.wait(10)
            first_out.set()

        def second():
            first_in.wait(10)
            with precision.full_f32():
                second_in.set()
                first_out.wait(10)
                seen.append((torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32))

        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert seen == [(False, False)]
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_mesh_map_raises_a_shards_error_after_all_end():
    done = []

    def fn(shard, i):
        if i == 2:
            raise RuntimeError("shard 2 failed")
        done.append(i)
        return i

    with pytest.raises(RuntimeError, match="shard 2"):
        mesh8().map(fn, list(range(8)))
    assert sorted(done) == [0, 1, 3, 4, 5, 6, 7]
    assert mesh8().map(lambda shard, i: i * i, [1, None, 3, None, None, None, None, 2]) == [
        1, None, 9, None, None, None, None, 4]


def test_replicas_without_replicate_raise():
    """An embedder held on another device than a shard's, with no
    ``replicate``, cannot run there: the mesh says so and how to avoid it."""

    class Elsewhere:
        device = torch.device("meta")

    with pytest.raises(TypeError, match=r"device_indices=\[i\]"):
        make_mesh(device="cpu").replicas(Elsewhere())
    fr = FullRank()
    assert mesh8().replicas(fr) == [fr] * 8


class GradFullRank(FullRank):
    """``FullRank`` scaled by a weight that requires grad, with an ``embed``
    that sets no grad mode of its own: it records a graph wherever grad
    mode is on."""

    def __init__(self, device=CPU):
        super().__init__()
        self.device = torch.device(device)
        self.w = torch.ones(10, device=self.device, requires_grad=True)

    def embed(self, audio):
        return super().embed(audio.cpu()).to(self.device) * self.w


def test_embed_rows_records_no_graph_on_a_fresh_thread():
    """A mesh runs ``_embed_rows`` on its shards' host threads, where grad
    mode is the thread's default, on: with an embedder whose weight
    requires grad, neither its rows nor the moments merged into the
    accumulator carry a graph."""
    rng = np.random.default_rng(5)
    audio = torch.from_numpy(rng.random((6, SR)).astype(np.float32))
    category = np.full(6, int(pipeline.ItemCategory.stem), dtype=np.int32)
    acc, rows, seen = {}, {}, []

    def run():
        seen.append(torch.is_grad_enabled())
        rows.update(pipeline._embed_rows(GradFullRank(), "mono", audio, None, category,
                                         {pipeline.ItemCategory.stem}, acc, None,
                                         lambda x: x, False, []))

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert seen == [True] and set(rows) == set(acc) == {pipeline.ItemCategory.stem}
    assert all(e.grad_fn is None and not e.requires_grad for e in rows.values())
    assert all(t.grad_fn is None for _, s1, m2 in acc.values() for t in (s1, m2))


@pytest.mark.parametrize("device_indices", [None, []])
def test_default_mesh_is_the_embedders_device(device_indices):
    """Without ``device_indices`` (or with none) an ``AudioMetrics`` runs on
    its embedder's device alone; a layout of one device into 2 DCN slices
    raises."""
    am = AudioMetrics(embedder=FullRank(), metrics=["fad"], device="cpu",
                      device_indices=device_indices)
    assert am.mesh.devices == [CPU] and am.mesh.shape == (1,)
    with pytest.raises(ValueError, match="1 devices do not divide into 2 DCN slices"):
        AudioMetrics(embedder=FullRank(), metrics=["fad"], device="cpu",
                     device_indices=device_indices, dcn_slices=2)


def test_metrics_without_a_mesh_are_the_one_shard_mesh():
    """KD and PRDC called without a mesh run on a mesh of the embeddings'
    device alone: the values of an explicit one-shard mesh, bitwise, and
    one cached reference term for both calls."""
    rng = np.random.default_rng(6)
    e1, e2 = rng.normal(size=(96, 16)).astype(np.float32), rng.normal(size=(80, 16))
    x, y = amd(e1), amd(e2.astype(np.float32))
    kw = dict(kid_subsets=7, kid_subset_size=20)
    one = make_mesh(device="cpu")
    assert port_kd.kernel_distance(x, y, **kw) == port_kd.kernel_distance(x, y, mesh=one, **kw)
    assert len([k for k in y.cache if k[0] == "kd_ref"]) == 1
    got = prdc(y, x, 5)
    for a in (x, y):
        a.radii.clear()
    assert prdc(y, x, 5, mesh=one) == got
