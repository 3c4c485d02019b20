"""Streaming shuffle with a minimum re-emission age.

A copy of ``audio_metrics_tpu/parallel/shuffle.py`` (framework-free; the
port imports nothing of the JAX package), so that one seed gives one order
in both packages.  Two containers:

- ``pool``: items old enough to be emitted (unordered; O(1) swap-pop);
- ``aging``: a FIFO of the ``min_age`` most recent insertions, which are
  protected from emission for that long.

Each incoming item displaces one uniformly chosen pool item (which is
yielded), enters the aging FIFO, and pushes the FIFO's oldest entry into
the pool.  So an item is never re-emitted within ``min_age`` insertions of
entering the buffer, which the misaligned pairs rely on: a window is never
paired with itself.
"""

from __future__ import annotations

import itertools
import random
from collections import deque

__all__ = ["shuffle_stream"]


def shuffle_stream(iterator, buffer_size=100, seed=None, min_age=0, desc=None):
    """Yield the items of ``iterator`` in a shuffled order through a buffer
    of ``buffer_size``: ``random.Random(seed)``, or the global ``random``
    when ``seed`` is None.  ``desc`` (a progress label in the reference) is
    accepted and ignored."""
    del desc
    rng = random if seed is None else random.Random(seed)
    iterator = iter(iterator)

    held = list(itertools.islice(iterator, buffer_size))
    if not held:
        return

    # protect at most len(held) - 1 recent insertions, so that the pool is
    # never empty; the FIFO starts with the newest items of the first fill
    protected = min(min_age, len(held) - 1)
    aging = deque(held[len(held) - protected:])
    pool = held[: len(held) - protected]

    for item in iterator:
        r = rng.randrange(len(pool))
        pool[r], pool[-1] = pool[-1], pool[r]
        yield pool.pop()
        aging.append(item)
        pool.append(aging.popleft())

    tail = pool + list(aging)
    rng.shuffle(tail)
    yield from tail
