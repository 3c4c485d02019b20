"""A cell that a CPU test run can hold: HTSAT-tiny's layout at 32 columns,
small sets, the port on its plain versions."""

from __future__ import annotations

import json
from pathlib import Path

from port_bench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
LIMITS = {"emb_err": 1e-5, "fad_err": 1e-4, "kd_err": 5.0, "prdc_err": 0.05}


def tiny_cell(chips: int = 1, **limits) -> harness.Cell:
    cfg = dict(harness.load_json(ROOT / "configs" / "clap-audio-tiny-f32.json"), embed_dim=32)
    mix = dict(harness.load_json(ROOT / "traffic" / "eval2048.json"), reference_clips=24,
               candidate_clips=16, judge_clips=32, trace_seconds=0.5,
               batch_size=8)
    e2e = [m for m in BENCH["end_to_end"] if m["name"] in ("setup_s", "eval_clips_per_s")]
    return harness.Cell("tiny-cpu", cfg, mix, chips, dict(LIMITS, **limits), e2e, [])
