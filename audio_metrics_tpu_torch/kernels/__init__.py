"""Hand-written Hopper kernels: build, load, launch, count.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together: a build then takes
about the time of its largest source, not the sum of all sources) and
linked into ONE
shared library with a plain C interface, at first use, into ``build/``
next to this file (the file name carries a hash of the sources, so an edited
source rebuilds).  The library is loaded with ``ctypes``; every pointer and
the stream are passed as ``c_void_p``, every size as ``c_int``, and every C
entry point returns ``cudaGetLastError()``, which :meth:`Kernel.launch`
checks and raises on.

Nothing here runs at import: the CPU test suite imports every module on a
host without ``nvcc`` or a card.

Dispatch rule (the ops modules): a CPU tensor goes to the kernel's plain
PyTorch version; a CUDA tensor launches the kernel for its dtype or raises.
Every kernel of the Swin path has a bf16 and an f32 instantiation, as the
JAX kernels take the activation dtype (the f32 block, its halves and the
patch merge run their products as three TF32 products on the tensor cores;
the int8 MLP's products are int8 in both, on the bf16 wgmma core's
ring); the frontend, the log-mels and the PRDC kernels take the one dtype
the JAX package runs them in.  Any
other dtype raises (f16).  There is no fallback, and no cast between
dtypes.
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

__all__ = ["Kernel", "KERNELS", "build", "check_s8_gemm", "check_sm90_gemm", "check_tf32x3_gemm",
           "require_cuda"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
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
            tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
            t0 = time.perf_counter()
            objs, procs = [], []
            for src in sorted(_CSRC.glob("*.cu")):
                obj = _BUILD / f"{src.stem}.{tag}.o"
                objs.append(obj)
                procs.append(subprocess.Popen(
                    [_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ))
            outs = [(p.communicate()[0], p.returncode) for p in procs]
            failed = [out for out, rc in outs if rc != 0]
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            if not failed:
                link = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(tmp),
                                       *map(str, objs)], capture_output=True, text=True)
                if link.returncode != 0:
                    failed.append(link.stdout + link.stderr)
            build_seconds = time.perf_counter() - t0
            for obj in objs:
                obj.unlink(missing_ok=True)
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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


def check_sm90_gemm(name: str, n: int, k: int, *strides: int) -> None:
    """Raise ``NotImplementedError`` unless the wgmma core
    (``csrc/gemm_sm90.cuh``) takes a product of ``n`` output columns over a
    depth ``k``: ``n`` a multiple of one of its column tiles, 64 (or 128),
    or 96 (HTSAT-tiny's 3C = 288 and C = 96); ``k`` a multiple of 16, a
    whole wgmma instruction (its K step is 64: the tensor maps zero-fill a
    step that runs past ``k``, whole instructions of zeros); and every row
    and batch stride of its operands (``strides``, in elements) a multiple
    of 8, the 16 bytes a tensor map asks for."""
    if (n % 64 and n % 96) or k % 16 or any(s % 8 for s in strides):
        raise NotImplementedError(
            f"{name}: the wgmma GEMM core takes N multiples of 64 or 96, K multiples of 16 "
            f"and strides of 8 elements, got N={n} K={k} strides={strides}"
        )


def check_s8_gemm(name: str, n: int, k: int, *strides: int) -> None:
    """Raise ``NotImplementedError`` unless the wgmma core
    (``csrc/gemm_sm90.cuh``) takes an int8 product of ``n`` output columns
    over a depth ``k``: ``n`` a multiple of one of its column tiles, 64 (or
    128), or 96 (HTSAT-tiny's fc2 at C = 96); ``k`` and every row stride of
    its operands (``strides``, in codes) a multiple of 16, the 16 bytes a
    tensor map asks for.  ``k`` need not fill a K step of 128 codes: the
    tensor maps zero-fill the rest, which adds exact zeros to an integer
    sum."""
    if (n % 64 and n % 96) or k % 16 or any(s % 16 for s in strides):
        raise NotImplementedError(
            f"{name}: the int8 wgmma GEMM core takes N multiples of 64 or 96, K multiples of "
            f"16 and strides of 16 codes, got N={n} K={k} strides={strides}"
        )


def check_tf32x3_gemm(name: str, n: int, k: int, *strides: int) -> None:
    """Raise ``NotImplementedError`` unless the 3xTF32 wgmma core
    (``csrc/gemm_tf32x3_sm90.cuh``) takes an f32 product of ``n`` output
    columns over a depth ``k``: ``n`` a multiple of one of its column tiles,
    64 (or 128), or 96 (HTSAT-tiny's 3C = 288 and C = 96); ``k`` of 32 (its
    K step, 128 bytes); and every row stride of its operands (``strides``,
    in elements) a multiple of 4, the 16 bytes a tensor map asks for."""
    if (n % 64 and n % 96) or k % 32 or any(s % 4 for s in strides):
        raise NotImplementedError(
            f"{name}: the 3xTF32 GEMM core takes N multiples of 64 or 96, K multiples of 32 "
            f"and strides of 4 elements, got N={n} K={k} strides={strides}"
        )


def _arg(a):
    if a is None:  # a null pointer (an optional operand)
        return ctypes.c_void_p(None)
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if isinstance(a, float):
        return ctypes.c_float(a)
    return ctypes.c_int(int(a))


class Kernel:
    """One hand-written kernel (a family of launches behind one wrapper).

    ``launches`` counts wrapper calls that launched the kernel on a card
    (each wrapper calls :meth:`count` once, under a lock: the shards of a
    mesh launch from one host thread each); the plain version never
    touches it.
    """

    def __init__(self, name: str, source: str, replaces: str):
        self.name, self.source, self.replaces = name, source, replaces
        self.launches = 0
        self._count_lock = threading.Lock()

    def count(self) -> None:
        """Add one launch to ``launches``."""
        with self._count_lock:
            self.launches += 1

    def launch(self, symbol: str, *args) -> None:
        """Call one C entry point on the operands' card, on that card's
        current stream, and raise on a launch error (a refused launch never
        runs, and a later synchronize would not report it).  The first
        tensor argument names the card (``require_cuda`` has checked that
        all operands share it), whichever card is current.  Every argument
        goes as a ctypes instance (``_arg``), which fixes its C type, and
        the entry points return ``int``, ctypes' default: so nothing of the
        shared function object is set per call, and host threads may launch
        at once."""
        lib = build()
        fn = getattr(lib, symbol)
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*map(_arg, args), ctypes.c_void_p(stream))
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
        Kernel(
            "knn_radii",
            "audio_metrics_tpu_torch/kernels/csrc/distance.cu",
            "audio_metrics_tpu/ops/distance.py:131",
        ),
        Kernel(
            "prdc_stats",
            "audio_metrics_tpu_torch/kernels/csrc/distance.cu",
            "audio_metrics_tpu/ops/distance.py:236,257",
        ),
        Kernel(
            "log_mel",
            "audio_metrics_tpu_torch/kernels/csrc/log_mel.cu",
            "audio_metrics_tpu/ops/mel.py:554",
        ),
        Kernel(
            "swin_attn_v3",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/attention.py:869",
        ),
        Kernel(
            "swin_mlp",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/mlp.py:147",
        ),
        Kernel(
            "swin_attn_v1",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/attention.py:400",
        ),
        Kernel(
            "log_mel_v1",
            "audio_metrics_tpu_torch/kernels/csrc/log_mel.cu",
            "audio_metrics_tpu/ops/mel.py:360",
        ),
        Kernel(
            "swin_attn_v2",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/attention.py:363",
        ),
        Kernel(
            "swin_mlp_int8",
            "audio_metrics_tpu_torch/kernels/csrc/mlp_int8.cu",
            "audio_metrics_tpu/ops/mlp.py:228",
        ),
        # the f32 instantiations of #1, #2 and #8-#12 (the JAX kernels take
        # the activation dtype): one wrapper each with its bf16 twin, their
        # own launch counts
        Kernel(
            "swin_block_f32",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/attention.py:1109",
        ),
        Kernel(
            "patch_merge_f32",
            "audio_metrics_tpu_torch/kernels/csrc/patch_merge.cu",
            "audio_metrics_tpu/ops/merge.py:138",
        ),
        Kernel(
            "swin_attn_v3_f32",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/attention.py:869",
        ),
        Kernel(
            "swin_mlp_f32",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/mlp.py:147",
        ),
        Kernel(
            "swin_attn_v1_f32",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/attention.py:400",
        ),
        Kernel(
            "swin_attn_v2_f32",
            "audio_metrics_tpu_torch/kernels/csrc/swin_block.cu",
            "audio_metrics_tpu/ops/attention.py:363",
        ),
        Kernel(
            "swin_mlp_int8_f32",
            "audio_metrics_tpu_torch/kernels/csrc/mlp_int8.cu",
            "audio_metrics_tpu/ops/mlp.py:228",
        ),
        # the merged one-window form of #10 and #11 (window = resolution =
        # 16, AM_TPU_MERGED_ATTN): their wrappers launch the same entries,
        # whose attention is then merged_attn.cuh's; one count a wrapper
        # and dtype
        *(Kernel(f"swin_attn_{v}_merged{dt}",
                 "audio_metrics_tpu_torch/kernels/csrc/merged_attn.cuh",
                 f"audio_metrics_tpu/ops/attention.py:{line}")
          for v, line in (("v1", 400), ("v2", 363)) for dt in ("", "_f32")),
    )
}
