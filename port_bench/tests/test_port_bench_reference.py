"""The plain reference against the port on the CPU at small sizes (the port
on its kernels' plain versions): the same weights and audio give the same
embeddings, and the reference metrics agree with the port's functions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _tiny import tiny_cell
from port_bench import harness
from port_bench.reference import metrics as ref_metrics
from port_bench.reference.clap_htsat import slaney_mel_filterbank
from port_bench.traffic import Traffic


@pytest.mark.parametrize("embed_dim,clips", [(32, 4), (96, 2)])
def test_reference_forward_matches_the_port(embed_dim, clips):
    cell = tiny_cell()
    cfg = dict(cell.config, embed_dim=embed_dim)
    fam = harness.family(cfg)
    params = fam.make_params(cfg, 2**31 + 5, "cpu")
    mix = dict(cell.traffic, reference_clips=clips, candidate_clips=clips, pool_sets=1)
    audio = Traffic(mix, 9, "cpu").pool[0]
    got = fam.build_port(cfg, params, "cpu").embed(audio)
    want = fam.build_reference(cfg, params, "cpu").embed(audio)
    assert float((got.double() - want.double()).norm(dim=1).max()) < 2e-6


def test_weights_cover_the_ports_parameter_keys():
    from audio_metrics_tpu_torch.convert import expected_param_keys

    for name in ("clap-music-base-f32", "clap-audio-tiny-f32"):
        cfg = harness.load_json(harness.ROOT / "configs" / f"{name}.json")
        fam = harness.family(cfg)
        shapes = {n: s for n, s, _ in fam.param_shapes(cfg)}
        assert set(shapes) == expected_param_keys(fam.port_config(cfg))
        n = sum(int(np.prod(s)) for s in shapes.values())
        assert n / 1e6 == pytest.approx({"clap-music-base-f32": 68.6,
                                         "clap-audio-tiny-f32": 28.2}[name], abs=0.1)


def test_same_seed_same_weights_and_inputs():
    cell = tiny_cell()
    fam = harness.family(cell.config)
    a, b = (fam.make_params(cell.config, 2**40 + 1, "cpu") for _ in range(2))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    t1, t2 = Traffic(cell.traffic, 2**40 + 1, "cpu"), Traffic(cell.traffic, 2**40 + 1, "cpu")
    # the CPU's vectorised sin may round the last place otherwise between two
    # calls; a card's elementwise kernels give the same bits
    torch.testing.assert_close(t1.reference, t2.reference, rtol=0, atol=1e-6)
    torch.testing.assert_close(t1.candidate(3), t2.candidate(3), rtol=0, atol=1e-6)
    assert not torch.equal(t1.candidate(0), t1.candidate(2))  # a new set every evaluate


def test_filterbank_matches_the_ports():
    from audio_metrics_tpu_torch.ops.mel import mel_filter_bank

    got = slaney_mel_filterbank(513, 64, 50.0, 14000.0, 48000)
    want = mel_filter_bank(513, 64, 50.0, 14000.0, 48000, norm="slaney", mel_scale="slaney")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def _sets(seed, n=300, m=260, d=32):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal((n, d)).astype(np.float32)
    cand = (1.2 * rng.standard_normal((m, d)) + 0.3).astype(np.float32)
    return ref, cand


def test_reference_metrics_match_the_ports_functions():
    from audio_metrics_tpu_torch import AudioMetricsData
    from audio_metrics_tpu_torch.metrics import frechet_distance, kid_features_to_metric, prdc

    ref, cand = _sets(3)
    r64, c64 = torch.from_numpy(ref).double(), torch.from_numpy(cand).double()
    r, c = AudioMetricsData(device="cpu"), AudioMetricsData(device="cpu")
    r.add(ref)
    c.add(cand)
    want_fad = ref_metrics.frechet_distance(*ref_metrics.moments(c64), *ref_metrics.moments(r64))
    assert frechet_distance(c, r) == pytest.approx(want_fad, rel=1e-9)
    kd_mean, kd_std = ref_metrics.kernel_distance(c64, r64)
    got = kid_features_to_metric(cand, ref, device="cpu")
    assert got["kernel_distance_mean"] == pytest.approx(kd_mean, rel=1e-4)
    assert got["kernel_distance_std"] == pytest.approx(kd_std, rel=1e-2)
    assert prdc(r, c, 10) == pytest.approx(ref_metrics.prdc(r64, c64, 10), abs=0)


def test_kid_subsets_are_the_libraries_draw():
    from audio_metrics_tpu_torch.metrics.kd import _subset_indices

    got = ref_metrics.kid_subsets(2048, 256)
    want = _subset_indices(2048, 256, 100, 128, 1234)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_reference_rows_split_over_models_keep_their_order():
    from port_bench.check import embed_rows

    class Rows:
        device = torch.device("cpu")

        def __init__(self, scale):
            self.scale = scale

        def embed(self, audio):
            return audio[:, :3] * self.scale

    audio = torch.arange(70 * 5, dtype=torch.float32).view(70, 5)
    got = embed_rows([Rows(1.0), Rows(1.0), Rows(1.0), Rows(1.0)], audio)
    assert torch.equal(got, audio[:, :3])


def _unit_rows(n, seed):
    g = torch.Generator().manual_seed(seed)
    e = torch.randn(n, 16, generator=g, dtype=torch.float64)
    return e / e.norm(dim=1, keepdim=True)


def test_set_distance_needs_no_row_order_and_sees_one_row_moved():
    from port_bench.check import set_distance

    a = _unit_rows(40, 1)
    assert set_distance(a[torch.randperm(40)], a, "cpu") == 0.0
    b = a.clone()
    b[7, 0] += 1e-3
    assert set_distance(b, a, "cpu") == pytest.approx(1e-3, rel=1e-6)
    # half the rows embedded twice: the other half has no row near it
    assert set_distance(torch.cat([a[:20], a[:20]]), a, "cpu") > 0.1
    assert set_distance(None, a, "cpu") == float("inf")


@pytest.mark.parametrize("fault,number", [("kd_subsets_shifted", "kd_err"),
                                          ("prdc_k_minus_one", "prdc_err"),
                                          ("prdc_k_plus_one", "prdc_err")])
def test_planted_metric_faults_move_their_number_alone(fault, number):
    from port_bench.calibrate import fault_side
    from port_bench.check import nearest, numbers, set_metrics

    cell = tiny_cell()
    ref_emb, cand = _unit_rows(24, 2), {0: _unit_rows(16, 3) * 0.9 + _unit_rows(16, 4) * 0.1}
    ref = dict(ref_emb=ref_emb, cand_emb=cand,
               results=set_metrics(ref_emb, cand, torch.float64, nearest(cell), "cpu"))
    got = numbers(fault_side(cell, ref, fault, "cpu"), ref, "cpu")
    assert got[number] > 0
    assert all(v == 0 for k, v in got.items() if k != number), got
    assert ref_metrics.kid_subsets(24, 16)[0].max() < 24  # the draw is put back
