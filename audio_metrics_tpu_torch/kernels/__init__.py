"""Hand-written Hopper kernels: build, load, launch, count.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, at first use, into ``build/``
next to this file (the file name carries a hash of the sources, so an edited
source rebuilds).  The library is loaded with ``ctypes``; every pointer and
the stream are passed as ``c_void_p``, every size as ``c_int``, and every C
entry point returns ``cudaGetLastError()``, which :meth:`Kernel.launch`
checks and raises on.

Nothing here runs at import: the CPU test suite imports every module on a
host without ``nvcc`` or a card.

Dispatch rule (the ops modules): a CPU tensor goes to the kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises.  There is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["Kernel", "KERNELS", "build", "require_cuda"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None  # wall time of the last nvcc build


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; cached per process."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        for src in _sources():
            h.update(src.name.encode())
            h.update(src.read_bytes())
        h.update(" ".join(_NVCC_FLAGS).encode())
        so = _BUILD / f"libam_kernels_{h.hexdigest()[:16]}.so"
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                   *map(str, sorted(_CSRC.glob("*.cu")))]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)
        _lib = ctypes.CDLL(str(so))
        return _lib


def require_cuda(*tensors: torch.Tensor, dtype=torch.bfloat16) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor of ``dtype`` on one device (the kernels read raw pointers with
    fixed strides, 16 bytes per vector load)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"kernel operands must share one CUDA device, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and 16-byte aligned")
        if t.dtype != dtype:
            raise NotImplementedError(f"the CUDA kernels take {dtype} here, got {t.dtype}")


def _arg(a):
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if isinstance(a, float):
        return ctypes.c_float(a)
    return ctypes.c_int(int(a))


class Kernel:
    """One hand-written kernel (a family of launches behind one wrapper).

    ``launches`` counts wrapper calls that launched the kernel on a card;
    the plain version never touches it.
    """

    def __init__(self, name: str, source: str, replaces: str):
        self.name, self.source, self.replaces = name, source, replaces
        self.launches = 0

    def launch(self, symbol: str, *args) -> None:
        """Call one C entry point on the current stream and raise on a
        launch error (a refused launch never runs, and a later synchronize
        would not report it)."""
        lib = build()
        fn = getattr(lib, symbol)
        cargs = [*map(_arg, args), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]
        fn.argtypes = [type(a) for a in cargs]
        fn.restype = ctypes.c_int
        rc = fn(*cargs)
        if rc != 0:
            raise RuntimeError(f"{self.name}: {symbol} failed with cudaError {rc}")


KERNELS = {
    k.name: k
    for k in (
        Kernel(
            "swin_block",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/attention.py:1109",
        ),
        Kernel(
            "patch_merge",
            "audio_metrics_tpu_torch/kernels/csrc/patch_merge.cu",
            "audio_metrics_tpu/ops/merge.py:138",
        ),
        Kernel(
            "clap_frontend",
            "audio_metrics_tpu_torch/kernels/csrc/frontend.cu",
            "audio_metrics_tpu/ops/frontend_fused.py:401",
        ),
    )
}
