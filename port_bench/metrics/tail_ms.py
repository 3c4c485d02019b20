"""``AudioMetrics.evaluate``'s tail (the projection, KD, PRDC and FAD's
work, the one pull, the reduces): the median over the window's untraced
evaluates of (evaluate's host-clock wall - ``timings["pipeline"]``), in
ms."""

from port_bench.readers import median_ms


def read(run):
    return median_ms(e.ret - e.call - e.timings["pipeline"] for e in run.untraced
                     if "pipeline" in e.timings)
