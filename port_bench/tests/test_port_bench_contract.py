"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from port_bench import harness
from port_bench.check import NUMBERS
from port_bench.run import parse

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_run_seconds_fit_a_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_at_most_a_quarter_of_the_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)]
        per = [m for m in BENCH["per_layer"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:  # each moves an end-to-end metric that the cell reports
            assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = json.loads((ROOT / "workloads" / f"{cell}.json").read_text())
    assert {k: spec[k] for k in entry} == entry
    assert set(c.limits) == set(NUMBERS)
    assert c.traffic["name"] == entry["traffic"]
    assert c.config["name"] == entry["config"]
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_config_files_state_their_source_and_cuts():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert (REPO / cfg["reference"]).exists()
        assert harness.family(cfg).param_shapes(cfg)


def test_every_config_and_traffic_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert (ROOT / "traffic" / f"{w['traffic']}.json").exists()


def test_paths_hold_only_names_of_the_allowed_characters():
    for p in ROOT.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(REPO).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel


def test_command_arguments():
    args = parse(["--workload", "music-f32-eval2048", "--seed", str(2**31 + 7),
                  "--seconds", "30", "--trace", "1"])
    assert (args.workload, args.seed, args.seconds, args.trace) == (
        "music-f32-eval2048", 2**31 + 7, 30.0, 1)
    with pytest.raises(SystemExit):
        parse(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


def test_harness_reads_no_run_environment():
    for path in ROOT.rglob("*.py"):
        if path.parent.name != "tests":
            assert "BENCH_RUN" not in path.read_text(), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("audio_metrics_tpu_torch", "audio_metrics_tpu",
                                               "jax", "jaxlib", "flax"), (path, n)
