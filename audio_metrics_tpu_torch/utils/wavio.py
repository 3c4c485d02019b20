"""Minimal WAV I/O (stdlib + numpy).

A copy of ``audio_metrics_tpu/utils/wavio.py`` (framework-free; the port
imports nothing of the JAX package): a RIFF/WAVE reader and writer for
PCM16 and IEEE float32, mono or multichannel, in place of the reference's
``soundfile``.  One difference: the RIFF chunk size written is the file
size - 8, as the WAV format defines it; the JAX copy writes 4 bytes more.
Files that either package writes read back equal in both.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ["write_wav", "read_wav"]

_FMT_PCM = 1
_FMT_FLOAT = 3


def write_wav(path, data: np.ndarray, sr: int, dtype: str = "float32") -> None:
    """data: (n_samples,) or (n_samples, n_channels), values in [-1, 1]."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n_samples, n_ch = data.shape
    if dtype == "float32":
        payload = data.astype("<f4").tobytes()
        fmt, bits = _FMT_FLOAT, 32
    elif dtype == "int16":
        clipped = np.clip(data, -1.0, 1.0)
        payload = (clipped * 32767.0).astype("<i2").tobytes()
        fmt, bits = _FMT_PCM, 16
    else:
        raise ValueError(f"unsupported dtype {dtype}")
    byte_rate = sr * n_ch * bits // 8
    block_align = n_ch * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", fmt, n_ch, sr, byte_rate, block_align, bits)
    riff = b"WAVE"
    riff += b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
    riff += b"data" + struct.pack("<I", len(payload)) + payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)  # file size - 8


def read_wav(path) -> tuple[np.ndarray, int]:
    """Returns (data (n_samples, n_channels) float32 in [-1, 1], sr)."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, sr, _, _, bits = fmt
    if audio_fmt == _FMT_FLOAT and bits == 32:
        arr = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_fmt == _FMT_PCM and bits == 16:
        arr = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_fmt == _FMT_PCM and bits == 32:
        arr = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"{path}: unsupported format {audio_fmt}/{bits}bit")
    return arr.reshape(-1, n_ch), sr
