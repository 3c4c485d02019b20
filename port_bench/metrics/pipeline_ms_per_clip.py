"""``parallel.pipeline``'s embed loop, per candidate clip: the program's
``timings["pipeline"]`` (windowing, the forwards enqueued, the tail's
dispatch and the flush's wait for the card) summed over the window's
untraced evaluates, over their clips, in ms."""

from port_bench.readers import pipeline_ms_per_clip


def read(run):
    return pipeline_ms_per_clip(run)
