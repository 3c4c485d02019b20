"""One run of one cell: set-up, the measured window, the traced sub-window,
the check against the plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs[].file``) and traffic
mix (``port_bench/traffic/<traffic>.json``); ``port_bench/workloads/
<cell>.json`` holds its correctness limits; each metric that the cell
reports is read by ``port_bench/metrics/<metric>.py``; the configuration's
``family`` names the module under ``port_bench/families/`` that makes its
weights and builds the port's embedder and the reference on them.

The window is a closed loop with one client: ``AudioMetrics.evaluate`` on
a candidate set that no earlier call got (a pool set times a gain, made on
the card when due), called again as soon as the last returned, until
``--seconds`` have passed.  ``evaluate`` returns host floats, so the card
has drained when it returns.  With ``--trace 1`` the profiler records the
device's operations over a sub-window of whole evaluates (the mix's
``trace_seconds``, from the window's second evaluate on); the program's
``timings`` cover every evaluate.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_metrics_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench_path: Path = REPO / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix, limits and the metrics it reports."""
    bench = load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {bench_path}")
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == entry["config"])
    applies = lambda m: "workloads" not in m or name in m["workloads"]
    return Cell(
        name=name,
        config=load_json(REPO / cfg_file),
        traffic=load_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
        chips=entry["chips"],
        limits=load_json(ROOT / "workloads" / f"{name}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def family(cfg: dict):
    return importlib.import_module(f"port_bench.families.{cfg['family']}")


def metric_reader(name: str):
    """``read(run)`` of ``port_bench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}",
                                                  ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Eval:
    k: int
    call: float  # perf_counter seconds
    ret: float
    call_ns: int  # time.time_ns, the profiler's clock
    ret_ns: int
    clips: int
    timings: dict
    result: dict
    traced: bool = False


@dataclass
class Run:
    cell: Cell
    seed: int
    setup_s: float
    window_start: float
    evals: list = field(default_factory=list)
    trace: dict | None = None
    setup_stages: dict = field(default_factory=dict)

    @property
    def untraced(self) -> list:
        return [e for e in self.evals if not e.traced]


def _devices(cell: Cell, device_type: str) -> list:
    """The cell's cards, or the CPU."""
    import torch

    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(cell.chips)]
    return [torch.device("cpu")]


def _sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _profiler(device_type: str):
    """The profiler of the cards' operations (on the CPU, of its operators,
    which name no device operation), kept in memory."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA if device_type == "cuda"
                               else ProfilerActivity.CPU])


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
            device_type: str = "cuda", min_evals: int = 1):
    """Set-up, window and the program's outputs of one run.  The window
    lasts ``seconds`` and runs at least ``min_evals`` evaluates.  Returns
    ``(run, program side, traffic, params, picks, memory peak, failures)``;
    the program's state is freed before it returns."""
    import torch

    from audio_metrics_tpu_torch import AudioMetrics

    from .recording import Recording
    from .traffic import Traffic

    fam, mix = family(cell.config), cell.traffic
    devices = _devices(cell, device_type)
    home = devices[0]
    marks = [("imports", time.perf_counter())]
    traffic = Traffic(mix, seed, home)
    marks.append(("inputs", time.perf_counter()))
    params = fam.make_params(cell.config, traffic.weights_seed, home)
    marks.append(("weights", time.perf_counter()))
    if device_type == "cuda":
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    embedder = Recording(fam.build_port(cell.config, params, home))
    am = AudioMetrics(metrics=mix["metrics"], embedder=embedder, win_dur=mix["win_dur"],
                      input_sr=mix["sample_rate"], batch_size=mix["batch_size"],
                      device_indices=list(range(cell.chips)) if cell.chips > 1 else None,
                      device=str(home))
    marks.append(("port_build", time.perf_counter()))
    am.add_reference(traffic.reference)
    _sync(devices)
    marks.append(("add_reference", time.perf_counter()))
    ref_rows = embedder.take()
    am.evaluate(traffic.warm_candidate())
    embedder.take()
    marks.append(("warm_evaluate", time.perf_counter()))
    if trace:
        with _profiler(device_type):  # loads the tracer in set-up
            torch.ones(1, device=home).add_(1)
            _sync(devices)
    _sync(devices)

    captured = []  # what each evaluate of the window embedded, for the check
    setup_s = time.perf_counter() - t_start
    run = Run(cell=cell, seed=seed, setup_s=setup_s, window_start=time.perf_counter())
    t = t_start
    for name, mark in marks:  # seconds of each stage of set-up
        run.setup_stages[name], t = mark - t, mark
    t_end = run.window_start + seconds
    prof, traced_from, failures = None, None, []
    k = 0
    while time.perf_counter() < t_end or k < min_evals:
        if trace and prof is None and k == 1:
            prof = _profiler(device_type)
            prof.start()
            traced_from = time.perf_counter()
        cand = traffic.candidate(k)
        call_ns, call = time.time_ns(), time.perf_counter()
        try:
            result = am.evaluate(cand)
        except Exception as exc:  # counted as failed; the window ends
            failures.append(f"evaluate {k}: {exc!r}")
            break
        ret, ret_ns = time.perf_counter(), time.time_ns()
        captured.append(embedder.take())
        run.evals.append(Eval(k, call, ret, call_ns, ret_ns, mix["candidate_clips"],
                              dict(am.timings), result, traced=traced_from is not None))
        del cand
        k += 1
        if traced_from is not None and ret - traced_from >= mix["trace_seconds"]:
            traced_from = None
            prof.stop()
    if traced_from is not None:
        prof.stop()
    _sync(devices)
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
            if device_type == "cuda" else 0)

    # the program's outputs that the check judges, moved to the host
    rng = np.random.default_rng(traffic.judge_seed)
    n_pick = min(len(run.evals), max(1, math.ceil(mix["judge_clips"] / mix["candidate_clips"])))
    picks = sorted(rng.choice(len(run.evals), n_pick, replace=False).tolist()) if run.evals \
        else []
    rows = lambda parts: torch.cat([p.float().cpu() for p in parts]) if parts else None
    prog = dict(ref_emb=rows(ref_rows),
                cand_emb={run.evals[i].k: rows(captured[i]) for i in picks},
                results={run.evals[i].k: run.evals[i].result for i in picks})
    if prof is not None:
        from .tracing import read_trace

        run.trace = read_trace(prof, run.evals, [d.index for d in devices])
    del am, embedder, captured, ref_rows, prof
    gc.collect()
    if device_type == "cuda":
        torch.cuda.empty_cache()
    return run, prog, traffic, params, [run.evals[i].k for i in picks], peak, failures


def result_metrics(run: Run, entries: list) -> dict:
    out = {}
    for m in entries:
        value = metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _finite(x):
    return x if x is None or math.isfinite(x) else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device_type: str = "cuda", min_evals: int = 1) -> tuple[dict, list[str]]:
    """One run: its result line (``checks`` last) and the lines that go
    to standard error, the checks last."""
    import torch

    from .check import judge, passed

    run, prog, traffic, params, picks, peak, failures = execute(
        cell, seed, seconds, trace, t_start, device_type, min_evals)
    checks = judge(cell, params, traffic, prog, picks, _devices(cell, device_type))
    correct = not failures and bool(run.evals) and passed(checks)
    kind = torch.cuda.get_device_name(0) if device_type == "cuda" else "cpu"
    device = {"platform": "gpu" if device_type == "cuda" else "cpu", "kind": kind,
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(run.evals) + len(failures),
            "failed": len(failures),
            "metrics": result_metrics(run, cell.per_layer if trace else cell.end_to_end),
            "device": device}
    if trace and run.trace is not None:
        device["busy_s"], device["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        line["breakdown"] = run.trace["breakdown"]
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    build = None
    if device_type == "cuda":
        from audio_metrics_tpu_torch import kernels

        build = kernels.build_seconds
    err = [f"port_bench: {cell.name} seed {seed}: set-up {run.setup_s!r} s (nvcc build {build} "
           f"s), {len(run.evals)} evaluates in the window, checked {picks}",
           "port_bench: set-up stages (s): " + json.dumps(run.setup_stages),
           "port_bench: median ms of the untraced evaluates' timings: " + json.dumps(
               {k: 1e3 * float(np.median([e.timings[k] for e in run.untraced if k in e.timings]))
                for k in dict.fromkeys(k for e in run.untraced for k in e.timings)})]
    err += [f"port_bench: failed: {f}" for f in failures]
    err += [f"check {k} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['limit'] is not None and c['value'] <= c['limit'] else 'FAIL'}"
            for k, c in checks.items()]
    return line, err


def main(args, t_start: float) -> int:
    import torch

    cell = load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    line, err = run_cell(cell, args.seed % (1 << 63), args.seconds, bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the process holds {', '.join(bad)}: nothing the benchmark runs "
              "may load JAX or the JAX package", file=sys.stderr)
        return 3
    print("\n".join(err), file=sys.stderr)
    print(json.dumps(line))
    return 0
