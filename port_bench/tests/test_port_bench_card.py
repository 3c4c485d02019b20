"""On the card: a cell's run comes out correct, and the control (the plain
reference in f32 with TF32 on, in the program's place) fails the cell's
limits.  Skipped without a card."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import check, harness


def _card(chips=1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA card(s)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["music-f32-eval2048", "audio-tiny-f32-eval2048",
                                  "music-f32-eval256"])
def test_program_passes_and_control_fails_at_the_cells_size(cell):
    _card()
    c = harness.load_cell(cell)
    run, prog, traffic, params, picks, _, failures = harness.execute(
        c, 2**31 + 99, 0.0, False, time.perf_counter(), min_evals=2)
    devices = [torch.device("cuda", 0)]
    ref = check.reference_side(c, params, traffic, picks, devices)
    ctl = check.reference_side(c, params, traffic, picks, devices, control=True)
    got = check.numbers(prog, ref, devices[0])
    bad = check.numbers(ctl, ref, devices[0])
    assert not failures
    assert all(got[k] <= c.limits[k] for k in check.NUMBERS), got
    assert any(bad[k] > c.limits[k] for k in check.NUMBERS), bad


@pytest.mark.cuda
def test_a_short_run_prints_a_correct_line():
    _card()
    line, err = harness.run_cell(harness.load_cell("music-f32-eval256"), 2**33 + 1, 2.0, True,
                                 time.perf_counter())
    assert line["correct"], err
    assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]
    assert set(line["metrics"]) == {"tail_ms", "pipeline_ms", "device_idle_share.small"}
