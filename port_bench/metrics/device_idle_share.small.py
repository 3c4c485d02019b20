"""Percent of the traced window in which the card ran no operation: 1 -
(the union of its operations' intervals in the profiler's timeline) / the
window."""

from port_bench.readers import idle_pct


def read(run):
    return idle_pct(run)
