"""The port's embedder as the timed path drives it, with what it returns
kept for the check.

``AudioMetrics`` takes any embedder that has ``embed``, ``sr`` and
``device`` (and ``replicate(device)`` to run on several cards).  The
harness hands it its own embedder wrapped in :class:`Recording`, which
passes every call on and keeps a copy of each ``embed`` output, so the
check reads the embeddings of exactly the audio that the window embedded
without reaching into the program's internals.
"""

from __future__ import annotations


class Recording:
    """``inner`` with a copy of each ``embed`` output appended to ``log``
    (shared with its replicas, whose shard threads append to it too);
    every other attribute is ``inner``'s."""

    def __init__(self, inner, log: list | None = None):
        self.inner = inner
        self.log = [] if log is None else log

    def embed(self, audio):
        out = self.inner.embed(audio)
        self.log.append(out.detach().clone())
        return out

    def replicate(self, device):
        return Recording(self.inner.replicate(device), self.log)

    def __getattr__(self, name):
        if name == "inner":  # not set yet (a copy being made): no recursion
            raise AttributeError(name)
        return getattr(self.inner, name)

    def take(self) -> list:
        """The outputs kept since the last ``take``, in the order they came."""
        out = list(self.log)
        self.log.clear()
        return out
