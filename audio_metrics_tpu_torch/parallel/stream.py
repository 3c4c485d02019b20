"""Host-side streaming maps, for preprocessing streams of one's own.

A copy of ``audio_metrics_tpu/parallel/stream.py`` (framework-free; the
port imports nothing of the JAX package).  Both keep a bounded window of
work in flight in one deque, drained from the front in submission order,
so results come out in input order (the reference emits them in completion
order), and block on the oldest piece of work once the window is full.

- :func:`cpu_parallel`: a parallel map over an iterator on a thread or
  process pool (the reference's ``util/cpu_parallel.py``).
- :func:`device_map_stream`: a map over a stream of batches with ``depth``
  results in flight.  CUDA launches return before the card finishes, so a
  function that enqueues work on the card overlaps the host's preparation
  of the next batches with the card's work on this one.
"""

from __future__ import annotations

import concurrent.futures as cf
from collections import deque

__all__ = ["cpu_parallel", "device_map_stream"]


def _emit(fut, item, discard_input):
    """One finished piece of work as its output record."""
    result = fut.result()
    if discard_input:
        return result
    item.update(result)
    return item


def cpu_parallel(iterator, target, n_workers=0, desc=None, use_threads=False,
                 discard_input=True, in_buffer_size=None, out_buffer_size=None):
    """A streaming parallel map with at most ``in_buffer_size +
    out_buffer_size`` items in flight (each ``2 * max(n_workers, 1)`` by
    default), emitted in input order.  The reference's keyword surface;
    ``desc`` (a progress label there) is accepted and ignored."""
    del desc
    pool_cls = cf.ThreadPoolExecutor if use_threads else cf.ProcessPoolExecutor
    fallback = 2 * max(n_workers, 1)
    window = (in_buffer_size if in_buffer_size is not None else fallback) + (
        out_buffer_size if out_buffer_size is not None else fallback)
    with pool_cls(max_workers=n_workers or None) as pool:
        inflight = deque()
        for item in iterator:
            inflight.append((pool.submit(target, item), item))
            # emit the head of the line when it is done; once the window is
            # full, wait for the oldest
            while inflight and (len(inflight) > window or inflight[0][0].done()):
                yield _emit(*inflight.popleft(), discard_input)
        while inflight:
            yield _emit(*inflight.popleft(), discard_input)


def device_map_stream(batches, fn, depth: int = 2):
    """``fn`` over a stream of batches with ``depth`` results held back, in
    order."""
    window = deque()
    for batch in batches:
        window.append(fn(batch))
        if len(window) > depth:
            yield window.popleft()
    while window:
        yield window.popleft()
