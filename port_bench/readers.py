"""Arithmetic that several metric readers share.  Each reader
(``port_bench/metrics/<metric>.py``) has one function, ``read(run)``,
which returns the metric's value from a finished run, or None where the
run holds nothing to read it from (the harness then leaves the metric
out of the result line)."""

from __future__ import annotations

import statistics


def clips_per_s(run):
    """Candidate clips of every evaluate completed in the window, over the
    seconds from the window's start to the return of the last of them."""
    if not run.evals:
        return None
    return sum(e.clips for e in run.evals) / (run.evals[-1].ret - run.window_start)


def idle_pct(run):
    """Percent of the traced window in which a card ran nothing, the mean
    over the cards used: each card's busy time is the union of its
    operations' intervals."""
    if run.trace is None or run.trace["window_s"] <= 0 or run.trace["busy_s"] <= 0:
        return None
    busy = run.trace["busy_per_device"]
    return 100.0 * (1.0 - sum(busy) / len(busy) / run.trace["window_s"])


def pipeline_ms_per_clip(run):
    """The program's ``timings["pipeline"]`` summed over the window's
    untraced evaluates, over their candidate clips, in ms."""
    evals = [e for e in run.untraced if "pipeline" in e.timings]
    if not evals:
        return None
    return 1e3 * sum(e.timings["pipeline"] for e in evals) / sum(e.clips for e in evals)


def median_ms(values):
    values = list(values)
    return 1e3 * statistics.median(values) if values else None
