"""Device meshes: the shards an evaluation is spread over.

Counterpart of ``audio_metrics_tpu/parallel/mesh.py``.  The JAX package is
single-controller: one process sees every device, its mesh is a layout of
``jax.devices()``, and its only cross-device traffic is KB-sized moment and
metric partials, merged on the host or by tiny collectives (its :12-17).
The port keeps that shape without ``torch.distributed``: one process, a
:class:`Mesh` of shards, each a device and a CUDA stream of its own, one
host thread per shard while a sharded stage runs (:meth:`Mesh.map`), one
embedder replica per distinct device (:meth:`Mesh.replicas`), and peer
copies (``.to(device)``) for the partials and for the gathered embeddings,
which live on the mesh's first device.  The reference's own multi-GPU
backend is a thread pool over model replicas (``audio_metrics_tpu/parallel/
mesh.py:3-8``).

``make_mesh(dcn_slices=k)`` lays the shards out as ``(dcn, data)``, k rows,
read in row-major order, which is the JAX package's compound batch axis; a
host's cards are all "one slice" to PyTorch, so the layout changes no
result.
"""

from __future__ import annotations

import contextlib
import operator
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch

__all__ = ["DATA_AXIS", "DCN_AXIS", "Mesh", "Shard", "check_device_indices", "make_mesh"]

DATA_AXIS = "data"
DCN_AXIS = "dcn"


class Shard(NamedTuple):
    """One place of a mesh: a device, and on a card a stream of its own."""

    device: torch.device
    stream: "torch.cuda.Stream | None"

    def context(self):
        """The shard's device and stream made current (nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack


def normalize_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _tensors(tree):
    """The tensors in nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class Mesh:
    """An ordered list of shards (``shards``; ``devices``, one a shard,
    repeats allowed), laid out as ``shape`` over ``axis_names``."""

    def __init__(self, devices, shape=None, axis_names=(DATA_AXIS,)):
        devices = [normalize_device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = (len(devices),) if shape is None else tuple(shape)
        self.axis_names = tuple(axis_names)
        self.shards = tuple(
            Shard(d, torch.cuda.Stream(device=d) if d.type == "cuda" else None)
            for d in devices)
        self._replicas: dict = {}

    @property
    def size(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> list[torch.device]:
        return [s.device for s in self.shards]

    @property
    def home(self) -> torch.device:
        """The first shard's device: where the gathered embeddings, the
        merged partials and every metric's tail live."""
        return self.shards[0].device

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, shape={self.shape})"

    def copies(self, *tensors) -> dict:
        """``{device: tensors there}`` for the mesh's devices: the tensors
        themselves on their own device, one peer copy on each other device
        (made here, on the caller's streams; ``map`` makes the shards wait
        for them)."""
        out = {}
        for dev in self.devices:
            if dev not in out:
                out[dev] = tuple(t if t.device == dev else t.to(dev) for t in tensors)
        return out

    def replicas(self, embedder) -> list:
        """One embedder a shard: ``embedder`` itself on its own device, a
        replica (``embedder.replicate``) on each other device, made once per
        device and kept."""
        key = id(embedder)
        hit = self._replicas.get(key)
        if hit is None or hit[0] is not embedder:
            own = normalize_device(embedder.device)
            hit = self._replicas[key] = (embedder, {own: embedder})
        by_device = hit[1]
        for dev in self.devices:
            if dev not in by_device:
                if not hasattr(embedder, "replicate"):
                    raise TypeError(f"{type(embedder).__name__} has no replicate(device), so it "
                                    f"cannot run on {dev}; name its device alone "
                                    "(device_indices=[i])")
                by_device[dev] = embedder.replicate(dev)
        return [by_device[dev] for dev in self.devices]

    def map(self, fn, jobs, wait: bool = True) -> list:
        """``fn(shard, job)`` for every shard whose ``job`` (``jobs[i]``)
        is not None, each on a host thread of its own with the shard's
        device and stream current (a single job, and the jobs of a mesh of
        CPU shards one after another, on the calling thread: PyTorch's CPU
        ops are threaded already, and their rounding depends on the threads
        they get); the results in shard order (None where there was no
        job).  A host thread has grad mode on whatever the caller's is, so
        ``fn`` sets what it needs itself.  With
        ``wait`` each shard's stream first waits for the caller's current
        streams on the mesh's devices (work the caller enqueued on them: the
        inputs, their copies).  Afterwards the
        caller's current streams wait for the shards' streams, and each
        tensor in the results is recorded as used on its device's current
        stream (``record_stream``), so that the caller reads the results and
        frees them safely.  The first exception of a shard is raised once
        every shard has ended."""
        if len(jobs) != self.size:
            raise ValueError(f"{len(jobs)} jobs for {self.size} shards")
        cards = sorted({s.device for s in self.shards if s.stream is not None}, key=str)
        ready = {}
        if wait:
            for dev in cards:
                ready[dev] = torch.cuda.Event()
                ready[dev].record(torch.cuda.current_stream(dev))

        def run(shard, job):
            with shard.context():
                if shard.stream is not None:
                    for ev in ready.values():
                        shard.stream.wait_event(ev)
                return fn(shard, job)

        todo = [(i, s, job) for i, (s, job) in enumerate(zip(self.shards, jobs))
                if job is not None]
        if cards and len(todo) > 1:
            with ThreadPoolExecutor(max_workers=len(todo)) as pool:
                futures = [(i, s, pool.submit(run, s, job)) for i, s, job in todo]
            outcomes = [(i, s, fut.result) for i, s, fut in futures]
        else:
            outcomes = [(i, s, lambda s=s, job=job: run(s, job)) for i, s, job in todo]
        results = [None] * self.size
        errors = []
        for i, shard, outcome in outcomes:
            try:
                results[i] = outcome()
            except Exception as exc:  # every shard has ended (or runs); raised below
                errors.append(exc)
                continue
            if shard.stream is not None:
                for dev in cards:
                    torch.cuda.current_stream(dev).wait_stream(shard.stream)
                for t in _tensors(results[i]):
                    if t.is_cuda:
                        t.record_stream(torch.cuda.current_stream(t.device))
        if errors:
            raise errors[0]
        return results


def check_device_indices(device_indices, count: int | None) -> list[int]:
    """``device_indices`` as a list of distinct indices into ``count``
    devices (``count`` None: no upper bound, as for CPU shards); None means
    all ``count`` of them.  Raises ``ValueError`` on an empty list, a
    repeated index or one out of range (``tests/test_sharding.py:339-343``:
    indices the user gave never fall back to fewer devices)."""
    if device_indices is None:
        if count is None:
            raise ValueError("device_indices None needs a device count")
        return list(range(count))
    indices = [operator.index(i) for i in device_indices]
    if not indices:
        raise ValueError("device_indices is empty")
    if len(set(indices)) != len(indices):
        raise ValueError(f"device_indices {indices} name a device more than once")
    bad = [i for i in indices if i < 0 or (count is not None and i >= count)]
    if bad:
        raise ValueError(f"device_indices {bad} out of range: {count} devices visible")
    return indices


def make_mesh(device_indices=None, devices=None, dcn_slices=None, device="cuda") -> Mesh:
    """A mesh of shards.

    ``devices``: any list of ``torch.device`` (or names), repeats included:
    several shards on one device is how one card, or the CPU, runs the
    multi-shard code, in place of the JAX suite's virtual devices
    (``--xla_force_host_platform_device_count=8``).  Else ``device_indices``
    on ``device``'s platform: on ``cuda`` indices of the visible cards,
    distinct and below ``torch.cuda.device_count()`` (None: every visible
    card); on ``cpu`` each of k distinct indices gives one CPU shard (None:
    one shard).  ``dcn_slices`` > 1 lays the shards out as ``(dcn, data)``
    with that many rows, and raises ``ValueError`` when they do not divide
    (the JAX package's :60-64)."""
    if devices is None:
        platform = torch.device(device).type
        if platform == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("a CUDA mesh was requested but CUDA is not available")
            devices = [torch.device("cuda", i) for i in
                       check_device_indices(device_indices, torch.cuda.device_count())]
        elif device_indices is None:
            devices = [torch.device(platform)]
        else:
            devices = [torch.device(platform)] * len(check_device_indices(device_indices, None))
    devices = list(devices)
    if dcn_slices and int(dcn_slices) > 1:
        dcn_slices = int(dcn_slices)
        if len(devices) % dcn_slices:
            raise ValueError(f"{len(devices)} devices do not divide into {dcn_slices} DCN "
                             "slices")
        return Mesh(devices, (dcn_slices, len(devices) // dcn_slices), (DCN_AXIS, DATA_AXIS))
    return Mesh(devices)
