"""The frozen yardstick against hand counts, and the trace arithmetic on
synthetic timelines."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from port_bench import tracing, yardstick
from port_bench.harness import Eval

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def hand_count(c, depths, heads_win=64):
    """24 T C^2 + 4 T win^2 C a block, written out stage by stage."""
    total = 0.0
    for i, (res, depth) in enumerate(zip((64, 32, 16, 8), depths)):
        ch, t = c * 2**i, res * res
        total += depth * (24 * t * ch * ch + 4 * t * heads_win * ch)
    return total


@pytest.mark.parametrize("name,depths,c,gflop", [
    ("clap-music-base-f32", (2, 2, 12, 2), 128, 29.83),
    ("clap-audio-tiny-f32", (2, 2, 6, 2), 96, 11.35),
])
def test_swin_block_operations_against_a_hand_count(name, depths, c, gflop):
    ops = yardstick.swin_block_ops(cfg(name))
    assert ops == hand_count(c, depths)
    assert round(ops / 1e9, 2) == gflop


def test_forward_operations_add_the_frontend_merges_and_projection():
    c = cfg("clap-music-base-f32")
    n = 5 * 48000
    assert yardstick.fb_bins(__import__("port_bench.reference.clap_htsat", fromlist=["x"])
                             .slaney_mel_filterbank(513, 64, 50, 14000, 48000)) == 299
    assert yardstick.frames_needed(c, n) == 504  # one 500-frame period and two at each seam
    assert yardstick.frames_needed(c, 7 * 48000) == 1001
    frontend = 2 * 504 * 1024 * 2 * 299 + 2 * 504 * 299 * 64 + 8 * 1024 * 64
    patch = 2 * 4096 * 16 * 128
    merges = sum(2 * (r // 2) ** 2 * 4 * ch * 2 * ch for r, ch in ((64, 128), (32, 256),
                                                                   (16, 512)))
    proj = 2 * (1024 * 512 + 512 * 512)
    assert yardstick.forward_ops(c, n) == pytest.approx(
        yardstick.swin_block_ops(c) + frontend + patch + merges + proj, rel=1e-12)


def test_bounds_count_f32_once_at_the_config_peak():
    c = cfg("clap-music-base-f32")
    # HTSAT-base's blocks on 64 clips: 29.83 G x 64 at 495 TFLOP/s, operations bind
    assert yardstick.swin_blocks_bound_s(c, 64) == pytest.approx(
        yardstick.swin_block_ops(c) * 64 / 495e12, rel=1e-9)
    m = yardstick.merges_bound_s(c, 64)
    assert 0 < m < yardstick.swin_blocks_bound_s(c, 64) / 10


def test_union_counts_two_overlapping_streams_once():
    a = [(0, 10), (20, 30)]
    b = [(5, 15), (25, 40), (50, 60)]
    assert yardstick.union_s([(s * 10**9, e * 10**9) for s, e in a + b]) == 45.0
    assert yardstick.gaps(a + b, 0, 70) == [(15, 20), (40, 50), (60, 70)]
    assert yardstick.gaps(a + b, 2, 8) == []


def test_short_names():
    assert yardstick.short("void am::gemm_tf32x3_kernel<128, 3>(float*)") == \
        "gemm_tf32x3_kernel<128, 3>"
    assert yardstick.short("knn_split_kernel(float const*)") == "knn_split_kernel"
    assert yardstick.short("x" * 100) == "x" * 80


class _Ev:
    def __init__(self, dev, s, e, name, kind="CUDA"):
        import torch

        self._v = (dev, s, e, name, getattr(torch.autograd.DeviceType, kind))

    def device_index(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def name(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def test_read_trace_on_a_synthetic_two_card_timeline():
    timings = {"pipeline": 4e-9, "projection": 1e-9, "kd_dispatch": 1e-9,
               "prdc_dispatch": 1e-9, "finalize_pull": 1e-9, "finalize": 2e-9}
    evals = [Eval(0, 0, 0, 0, 10, 4, timings, {}, traced=True),
             Eval(1, 0, 0, 12, 22, 4, timings, {}, traced=True),
             Eval(2, 0, 0, 30, 40, 4, timings, {}, traced=False)]
    events = [_Ev(0, 0, 4, "void am::gemm_tf32x3_kernel<1>(x)"),
              _Ev(1, 2, 6, "void am::gemm_tf32x3_kernel<1>(x)"),
              _Ev(0, 13, 16, "window_attn_kernel<32>"), _Ev(0, 1, 30, "cpu op", "CPU"),
              _Ev(0, 21, 35, "ln_rows_kernel")]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t = tracing.read_trace(prof, evals, [0, 1])
    assert t["window_s"] == 22e-9
    assert t["busy_per_device"] == [pytest.approx(8e-9), pytest.approx(4e-9)]
    assert t["busy_s"] == pytest.approx(6e-9)
    assert t["breakdown"]["device_ops"][0] == ["gemm_tf32x3_kernel<1>", pytest.approx(8e-9)]
    # idle 6-13 (middle 9.5: the first evaluate's return), 16-21 (18.5: the
    # second's PRDC dispatch); the third evaluate is not traced
    idle = dict((round(s * 1e9), n) for n, s in t["breakdown"]["idle_gaps"])
    assert idle == {7: "evaluate.return", 5: "evaluate.prdc_dispatch"}
