"""ctypes bindings of the native (C++) streaming window batcher.

Counterpart of ``audio_metrics_tpu/parallel/native_loader.py``.  The
batcher (``audio_metrics_tpu_torch/native/am_dataloader.cc``, the port's own
copy of the JAX package's ``native/am_dataloader.cc``) does the host-fed
pipeline's feeder work (window slicing, the song and window shuffles,
misaligned pairs, padded batches) in a C++ thread, off the GIL, while the
card runs the batch before.  Its output contract is the Python feeder's
(``parallel.pipeline._bucketed_batches``), with the same windows and, for
the same seed, the JAX package's batcher's batches bitwise.

The library is built at first use with the host's C++ compiler (``g++
-O3 -std=c++17 -fPIC -pthread``, the flags of the JAX package's
``native/Makefile``) into ``native/build/``, under a name that carries the
hash of the source, so that an edited source is never served by a stale
library.  When the batcher is asked for and cannot be built or loaded,
``load_library`` raises: the port has no silent fallback to the Python
feeder (the JAX package falls back without a word, ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

__all__ = ["NativeBatcher", "NativeLoaderError", "load_library"]

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "am_dataloader.cc"
_BUILD_DIR = _SOURCE.parent / "build"
_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared"]
_lib = None
_lib_lock = threading.Lock()

_APA_MODES = {None: 0, "reference": 1, "candidate": 2}
_APA_ERROR = ("When computing APA items should be tensors/arrays of shape [n_samples, 2] "
              "(pairing context and stem)")


class NativeLoaderError(RuntimeError):
    """The native batcher was asked for and cannot be built or loaded."""


def _build(source: Path, build_dir: Path) -> Path:
    """The library of ``source``, compiled unless a library of the same
    source text and flags is there; written under a temporary name and
    renamed, so that concurrent builds never load a half-written file."""
    try:
        text = source.read_bytes()
    except OSError as exc:
        raise NativeLoaderError(f"the native batcher's source {source} cannot be read: "
                                f"{exc}") from exc
    digest = hashlib.sha256(text + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    lib_path = build_dir / f"libam_dataloader-{digest}.so"
    if lib_path.exists():
        return lib_path
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        os.unlink(tmp)
        raise NativeLoaderError(f"the native batcher cannot be built: {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeLoaderError(f"the native batcher failed to build (g++ exit "
                                f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def load_library():
    """The batcher's library (built at first use, then cached in this
    process); raises ``NativeLoaderError`` when it cannot be built or
    loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _build(_SOURCE, _BUILD_DIR)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            raise NativeLoaderError(f"the native batcher {path} cannot be loaded: "
                                    f"{exc}") from exc
        lib.amdl_create.restype = ctypes.c_void_p
        lib.amdl_create.argtypes = [ctypes.c_int] * 7 + [ctypes.c_uint64, ctypes.c_int]
        lib.amdl_feed.restype = None
        lib.amdl_feed.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64, ctypes.c_int]
        for name in ("amdl_finish", "amdl_cancel", "amdl_destroy"):
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.amdl_next_batch.restype = ctypes.c_int
        lib.amdl_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.amdl_error.restype = ctypes.c_int
        lib.amdl_error.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeBatcher:
    """A streaming batcher on the C++ loader::

        nb = NativeBatcher(batch_size, win_len, apa_mode="reference",
                           stems_mode=True, seed=0)
        for song in songs:          # in a feeder thread
            nb.feed(song)           # (n_samples,) or (n_samples, 2)
        nb.finish()
        for kind, audio, category, valid in nb:
            ...

    Yields ``(kind, audio, category[B], valid[B])`` with B = ``batch_size``
    and ``kind`` "pair" or "mono": ``audio`` a (B, win_len, 2) or (B,
    win_len) f32 tensor, rows past the valid prefix zero, in a fresh buffer
    each batch (pinned host memory with ``pin_memory``, for an asynchronous
    upload whose buffer PyTorch's pinned allocator keeps until the copy is
    done).  Teardown with a feeder thread: ``cancel()``, join the feeder,
    then drop the batcher; destroying it while a feeder is inside
    ``feed()`` is a use-after-free in the native layer."""

    def __init__(self, batch_size: int, win_len: int, apa_mode=None, stems_mode: bool = False,
                 song_buffer: int = 100, win_buffer: int = 1000, win_min_age: int = 100,
                 seed: int = 0, max_ready_batches: int = 4, pin_memory: bool = False):
        self._lib = load_library()
        self.batch_size, self.win_len, self.pin_memory = batch_size, win_len, pin_memory
        self._handle = self._lib.amdl_create(batch_size, win_len, _APA_MODES[apa_mode],
                                             int(stems_mode), song_buffer, win_buffer,
                                             win_min_age, seed, max_ready_batches)
        self._finished = False

    def feed(self, song) -> None:
        """Queue one song (copied once, on the native side); blocks while
        the loader's queues are full."""
        arr = np.ascontiguousarray(song, dtype=np.float32)
        channels = 1 if arr.ndim == 1 else arr.shape[1]
        self._lib.amdl_feed(self._handle, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            arr.shape[0], channels)

    def finish(self) -> None:
        if not self._finished:
            self._lib.amdl_finish(self._handle)
            self._finished = True

    def cancel(self) -> None:
        """Unblock every thread waiting in ``feed()`` or the iteration."""
        if self._handle:
            self._lib.amdl_cancel(self._handle)
            self._finished = True

    def __iter__(self):
        b, w = self.batch_size, self.win_len
        kind, n = ctypes.c_int(), ctypes.c_int()
        while True:
            # pair-sized, which holds a mono batch too
            audio = torch.empty((b, w, 2), dtype=torch.float32, pin_memory=self.pin_memory)
            category = np.empty(b, np.int32)
            valid = np.empty(b, np.uint8)
            status = self._lib.amdl_next_batch(
                self._handle, audio.data_ptr(),
                category.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(kind), ctypes.byref(n))
            if status != 1:
                break
            if self._lib.amdl_error(self._handle):
                raise ValueError(_APA_ERROR)
            if kind.value == 0:
                yield "pair", audio, category, valid.astype(bool)
            else:
                yield "mono", audio.view(-1)[: b * w].view(b, w), category, valid.astype(bool)
        if self._lib.amdl_error(self._handle):
            raise ValueError(_APA_ERROR)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.amdl_destroy(handle)
            self._handle = None
