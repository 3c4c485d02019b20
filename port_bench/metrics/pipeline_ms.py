"""``parallel.pipeline``: the median of ``timings["pipeline"]`` over the
window's untraced evaluates, in ms."""

from port_bench.readers import median_ms


def read(run):
    return median_ms(e.timings["pipeline"] for e in run.untraced if "pipeline" in e.timings)
