"""Candidate clips of every evaluate completed in the window, over the
time from the window's start to the return of the last of them."""

from port_bench.readers import clips_per_s


def read(run):
    return clips_per_s(run)
