"""The benchmark of ``audio_metrics_tpu_torch`` on NVIDIA cards.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (``harness.run_cell``): set-up, a
closed loop of ``AudioMetrics.evaluate`` for ``--seconds``, the check of
what the loop produced against the plain reference, then prints the
checks on standard error and one JSON line on standard output: the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics and the
breakdown of the traced sub-window.  Exits non-zero, printing no result,
without as many cards as the cell asks for, or when the process has loaded
JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from port_bench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
