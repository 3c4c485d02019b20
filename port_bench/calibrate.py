"""The readings that the correctness limits are set from (not run by the
benchmark's own runs).

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed, in one process: the cell's set-up and a short window at its
own load (as many evaluates as a run checks), then the plain reference on
the same weights and audio (f32 with TF32 off, metrics in float64), and,
for the seeds of ``--control-seeds``, the control (the reference in the
nearest precision below the configuration's f32: forward and metrics in
f32 with TF32 on) and the planted faults of the metric stage (``FAULTS``:
the reference's float64 metrics, each with one fault, in the program's
place).  Prints one JSON line a seed: the compared numbers of each side
against the reference's, and the metric values of each side; with
``--out`` appends them to that file too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


FAULTS = ("kd_subsets_shifted", "prdc_k_minus_one", "prdc_k_plus_one")


def fault_side(cell, ref: dict, fault: str, device) -> dict:
    """``ref`` with its metrics taken again in float64 with one fault of
    ``FAULTS`` planted in the metric stage: KD's subsets each one row
    further on, or PRDC's radii one neighbour nearer or further."""
    import torch

    from port_bench import check
    from port_bench.reference import metrics

    k, draw = check.nearest(cell), metrics.kid_subsets

    def shifted(n_x, n_y, *args, **kwargs):
        ix, iy = draw(n_x, n_y, *args, **kwargs)
        return (ix + 1) % n_x, (iy + 1) % n_y

    if fault == "kd_subsets_shifted":
        metrics.kid_subsets = shifted
    try:
        k = {"prdc_k_minus_one": k - 1, "prdc_k_plus_one": k + 1}.get(fault, k)
        results = check.set_metrics(ref["ref_emb"], ref["cand_emb"], torch.float64, k, device)
    finally:
        metrics.kid_subsets = draw
    return dict(ref, results=results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import math

    import torch

    from port_bench.check import numbers, reference_side
    from port_bench.harness import _devices, execute, load_cell

    cell = load_cell(args.workload)
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    devices = _devices(cell, "cuda")
    mix = cell.traffic
    n_pick = max(1, math.ceil(mix["judge_clips"] / mix["candidate_clips"]))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, prog, traffic, params, picks, peak, failures = execute(
            cell, seed, 0.0, False, t0, min_evals=n_pick)
        ref = reference_side(cell, params, traffic, picks, devices)
        out = {"workload": cell.name, "seed": seed, "picks": picks, "failures": failures,
               "memory_peak_bytes": peak, "program": numbers(prog, ref, devices[0]),
               "values": {"program": prog["results"], "reference": ref["results"]}}
        if seed in control_seeds:
            ctl = reference_side(cell, params, traffic, picks, devices, control=True)
            out["control"] = numbers(ctl, ref, devices[0])
            out["values"]["control"] = ctl["results"]
            for fault in FAULTS:
                side = fault_side(cell, ref, fault, devices[0])
                out[fault] = numbers(side, ref, devices[0])
                out["values"][fault] = side["results"]
        out["seconds"] = time.perf_counter() - t0
        line = json.dumps(out, default=str)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del run, prog, traffic, params, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
