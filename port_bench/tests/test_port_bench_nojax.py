"""Nothing that a run loads is JAX or the JAX package, compared by whole
top-level names."""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

from port_bench import harness

REPO = Path(__file__).resolve().parents[2]


def test_a_whole_run_loads_no_jax():
    code = textwrap.dedent("""
        import sys, time
        sys.path.insert(0, {repo!r})
        sys.path.insert(0, {tests!r})
        from _tiny import tiny_cell
        from port_bench import calibrate, check, harness, tracing
        from port_bench.reference import clap_htsat, metrics
        for m in harness.load_json(harness.REPO / "BENCHMARK.json")["per_layer"]:
            harness.metric_reader(m["name"])
        line, _ = harness.run_cell(tiny_cell(), 7, 0.5, False, time.perf_counter(), "cpu")
        assert "audio_metrics_tpu_torch" in sys.modules
        print(harness.forbidden_modules())
    """).format(repo=str(REPO), tests=str(Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("audio_metrics_tpu_torch", "audio_metrics_tpu_torch.kernels", "jaxtyping",
                 "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "audio_metrics_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["audio_metrics_tpu", "jaxlib"]
