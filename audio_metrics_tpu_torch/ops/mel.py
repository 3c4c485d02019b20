"""Log-mel spectrogram as products, and the halo log-mel kernel's wrapper.

Counterpart of ``audio_metrics_tpu/ops/mel.py``: the filterbank and
windowed-DFT tables are the same numpy code (:48-145, :222-228); framing is
a hop-strided view, the DFT a product with the ``window * cos`` /
``window * sin`` basis, and the mel projection a second product
(:151-219, :574-668).  ``log_mel_halo`` has the contract of
``log_mel_pallas_halo`` (:374-571) and ``log_mel_v1`` that of
``log_mel_pallas`` (:231-371); both launch kernels/csrc/log_mel.cu's DFT +
mel kernel on the wgmma core, through the frame maps that ``halo_dft_map``
(frames in place in hop rows) and ``v1_dft_map`` (a frame matrix)
tabulate.
``log_mel_spectrogram`` dispatches bf16 compute to one of them as
:625-644 dispatches to the TPU kernels: to ``log_mel_v1`` when
``AM_TPU_MEL_V1`` is set, else to ``log_mel_halo``.  The variable is read
at call time (the JAX package reads it once at import).  The CLAP 5 s path
does not come here in bf16: it goes through the fused frontend
(ops/frontend_fused.py).

Dispatch of ``log_mel_halo`` and ``log_mel_v1``: a CPU tensor runs the
``*_plain`` version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import KERNELS, require_cuda

__all__ = [
    "mel_filter_bank",
    "stft_power",
    "log_mel_spectrogram",
    "halo_dft_map",
    "v1_dft_map",
    "log_mel_halo",
    "log_mel_halo_plain",
    "log_mel_v1",
    "log_mel_v1_plain",
    "plain_operands",
]

KERNEL = KERNELS["log_mel"]
KERNEL_V1 = KERNELS["log_mel_v1"]
_LOG_MODES = {"db": 0, "natural": 1}
BM, BK = 128, 64  # the wgmma core's row tile and K step (kernels/csrc/gemm_sm90.cuh)
MEL_GROUP = 64    # mel bins of a group of the kernels' epilogue (CLAP and VGGish: one)


def _hertz_to_mel(freq, mel_scale: str):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = freq >= min_log_hz
    return np.where(
        above, min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep, mels
    )


def _mel_to_hertz(mels, mel_scale: str):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@lru_cache(maxsize=None)
def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
    norm: str | None = None,
    mel_scale: str = "htk",
    triangle_domain: str = "hz",
    zero_dc: bool = False,
) -> np.ndarray:
    """Triangular mel filterbank (num_frequency_bins, num_mel_filters).
    ``triangle_domain="hz"``: librosa construction (slopes in hertz);
    ``"mel"`` with ``zero_dc=True``: torchvggish's
    ``spectrogram_to_mel_matrix`` (slopes in mel units, DC row zeroed)."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)
    mel_min = _hertz_to_mel(min_frequency, mel_scale)
    mel_max = _hertz_to_mel(max_frequency, mel_scale)
    mel_points = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hertz(mel_points, mel_scale)
    if triangle_domain == "mel":
        with np.errstate(divide="ignore", invalid="ignore"):
            spec_mels = _hertz_to_mel(fft_freqs, mel_scale)
            lower = mel_points[:-2][np.newaxis, :]
            center = mel_points[1:-1][np.newaxis, :]
            upper = mel_points[2:][np.newaxis, :]
            up_slope = (spec_mels[:, np.newaxis] - lower) / (center - lower)
            down_slope = (upper - spec_mels[:, np.newaxis]) / (upper - center)
            weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    else:
        fdiff = np.diff(filter_freqs)
        slopes = filter_freqs[np.newaxis, :] - fft_freqs[:, np.newaxis]
        down = -slopes[:, :-2] / fdiff[:-1]
        up = slopes[:, 2:] / fdiff[1:]
        weights = np.maximum(0.0, np.minimum(down, up))
    if zero_dc:
        weights[0, :] = 0.0
    if norm == "slaney":
        enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
        weights *= enorm[np.newaxis, :]
    return weights


@lru_cache(maxsize=None)
def _dft_matrices(frame_length: int, n_fft: int, window: str):
    """(frame_length, n_bins) windowed cos/sin matrices for a real DFT."""
    if window == "hann":
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_length) / frame_length)
    elif window == "ones":
        win = np.ones(frame_length)
    else:
        raise ValueError(f"unknown window {window!r}")
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[None, :]
    t = np.arange(frame_length)[:, None]
    angle = 2.0 * np.pi * k * t / n_fft
    cos_m = (np.cos(angle) * win[:, None]).astype(np.float32)
    sin_m = (-np.sin(angle) * win[:, None]).astype(np.float32)
    return cos_m, sin_m


@lru_cache(maxsize=None)
def _dft_basis(frame_length: int, n_fft: int) -> np.ndarray:
    """(frame_length, 2 * n_bins) [cos | sin] Hann-windowed real-DFT basis."""
    return np.concatenate(_dft_matrices(frame_length, n_fft, "hann"), axis=1)


@lru_cache(maxsize=64)
def device_table(make, args: tuple, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``make(*args)``, a cached numpy table builder, as a ``dtype`` tensor
    on ``device``, uploaded once per device and kept: the f32 mel chain's
    DFT basis, filterbank, tiled-mel row index and bicubic matrix (the bf16
    frontend holds its tables from load, ``ops.frontend_fused.
    frontend_tables``).  Read it, do not change it."""
    return torch.from_numpy(np.ascontiguousarray(make(*args))).to(device, dtype)


def _fb_support_bins(fb: np.ndarray) -> int:
    """Highest frequency bin with any mel-filter weight, rounded up to a
    multiple of 128 — bins above fmax contribute nothing and are dropped
    from the DFT basis."""
    nz = np.nonzero(np.any(fb != 0.0, axis=1))[0]
    hi = int(nz[-1]) + 1 if len(nz) else fb.shape[0]
    return min(fb.shape[0], -(-hi // 128) * 128)


def _reflect_pad(x: torch.Tensor, frame_length: int) -> torch.Tensor:
    """torch.stft's ``center``: reflect by frame_length // 2 at both ends
    (the edge sample itself is not repeated)."""
    pad = frame_length // 2
    return F.pad(x, (pad, pad), mode="reflect")


def stft_power(audio, frame_length: int, hop_length: int, n_fft: int | None = None,
               center: bool = True, compute_dtype=None, power: float = 2.0):
    """Magnitude (``power`` 1) or power (``power`` 2) spectrogram of
    Hann-windowed frames via a DFT product: (B, n) -> (B, frames,
    n_fft//2+1) f32.  ``center`` reflect-pads by frame_length//2.
    ``compute_dtype`` rounds the frame samples and the basis (bf16 on the
    bf16 forward); the product accumulates in f32 either way.  Any other
    power is ``sqrt(max(|X|^2, 1e-30)) ** power`` (audio_metrics_tpu/ops/
    mel.py:215-218)."""
    x = audio.float()
    if center:
        x = _reflect_pad(x, frame_length)
    n_fft = n_fft or frame_length
    n_bins = n_fft // 2 + 1
    basis = device_table(_dft_basis, (frame_length, n_fft), x.device)
    dt = compute_dtype or torch.float32
    frames = x.unfold(1, frame_length, hop_length)  # (B, frames, frame_length) view
    acc = torch.matmul(frames.to(dt).float(), basis.to(dt).float())
    re, im = acc[..., :n_bins], acc[..., n_bins:]
    sq = re * re + im * im
    if power == 2.0:
        return sq
    return torch.sqrt(torch.clamp(sq, min=1e-30)) ** power


def _log(mel, log_mode: str, log_offset: float):
    if log_mode == "db":  # the kernels' form of 10*log10(max(m, 1e-10))
        return 10.0 * (torch.log(torch.clamp(mel, min=1e-10)) * 0.43429448190325176)
    if log_mode == "natural":
        return torch.log(mel + log_offset)
    raise ValueError(f"unknown log_mode {log_mode!r}")


def plain_operands(x, width: int, *, frame_length, hop_length, n_fft, fb):
    """``(frames, basis, fb_rows)`` of the plain log-mels over the frames of
    ``width`` samples of the padded f32 signal ``x``: the bf16 frames (B,
    n_frames, width) and the bf16 basis (width, 2*n_keep) [cos | sin] cut to
    the filterbank support (``_fb_support_bins``) with zero rows past the
    frame length, both as f32, and the (n_keep, n_mels) f32 filterbank
    rows."""
    n_keep = _fb_support_bins(fb)
    cos_m, sin_m = _dft_matrices(frame_length, n_fft, "hann")
    basis = np.zeros((width, 2 * n_keep), np.float32)
    basis[:frame_length, :n_keep] = cos_m[:, :n_keep]
    basis[:frame_length, n_keep:] = sin_m[:, :n_keep]
    basis = torch.from_numpy(basis).to(x.device, torch.bfloat16).float()
    frames = x.unfold(1, width, hop_length).to(torch.bfloat16).float()
    fb_t = torch.from_numpy(np.ascontiguousarray(fb[:n_keep], np.float32)).to(x.device)
    return frames, basis, fb_t


def _log_mel_plain(x, width: int, *, frame_length, hop_length, n_fft, fb, log_mode, log_offset,
                   out_affine, out_dtype):
    """The kernels' arithmetic over the frames of ``width`` samples of the
    padded f32 signal ``x`` (``plain_operands``): f32 accumulation of the
    bf16 product, power, f32 mel product, log, affine, cast."""
    frames, basis, fb_t = plain_operands(x, width, frame_length=frame_length,
                                         hop_length=hop_length, n_fft=n_fft, fb=fb)
    n_keep = fb_t.shape[0]
    acc = torch.matmul(frames, basis)
    re, im = acc[..., :n_keep], acc[..., n_keep:]
    lm = _log(torch.matmul(re * re + im * im, fb_t), log_mode, log_offset)
    if out_affine is not None:
        sc, of = out_affine
        lm = lm * sc.float() + of.float()
    return lm.to(out_dtype or torch.float32)


def log_mel_halo_plain(audio, *, frame_length: int, hop_length: int, n_fft: int, fb: np.ndarray,
                       center: bool = True, log_mode: str = "db", log_offset: float = 0.01,
                       out_affine=None, out_dtype=None):
    """The halo kernel's arithmetic in plain tensor ops: frames of
    ``frame_length`` samples."""
    x = audio.float()
    if center:
        x = _reflect_pad(x, frame_length)
    return _log_mel_plain(x, frame_length, frame_length=frame_length, hop_length=hop_length,
                          n_fft=n_fft, fb=fb, log_mode=log_mode, log_offset=log_offset,
                          out_affine=out_affine, out_dtype=out_dtype)


def _v1_signal(audio, frame_length: int, hop_length: int, center: bool = True):
    """``(x, n_frames, width)``: the f32 signal the frames of
    ``log_mel_pallas`` (mel.py:262-269) are cut from, reflect-padded when
    ``center`` and zero-padded to hold the last frame, each frame the
    chunk-padded n_chunks * hop samples wide."""
    x = audio.float()
    if center:
        x = _reflect_pad(x, frame_length)
    n_frames = (x.shape[1] - frame_length) // hop_length + 1
    if n_frames < 1:
        raise ValueError(f"{x.shape[1]} samples hold no {frame_length}-sample frame")
    width = -(-frame_length // hop_length) * hop_length
    x = F.pad(x, (0, max(0, (n_frames - 1) * hop_length + width - x.shape[1])))
    return x, n_frames, width


def log_mel_v1_plain(audio, *, frame_length: int, hop_length: int, n_fft: int, fb: np.ndarray,
                     center: bool = True, log_mode: str = "db", log_offset: float = 0.01,
                     out_affine=None, out_dtype=None):
    """The v1 kernel's arithmetic in plain tensor ops: frames of the
    chunk-padded width n_chunks * hop, zero past the signal (the basis rows
    past the frame length are zero)."""
    x, n_frames, width = _v1_signal(audio, frame_length, hop_length, center)
    return _log_mel_plain(x, width, frame_length=frame_length, hop_length=hop_length,
                          n_fft=n_fft, fb=fb, log_mode=log_mode, log_offset=log_offset,
                          out_affine=out_affine, out_dtype=out_dtype)[:, :n_frames]


@lru_cache(maxsize=16)
def _kernel_tables(frame_length: int, k_pad: int, n_fft: int, fb_bytes: bytes, n_mels: int,
                   chunk, device: str):
    """The log-mel kernels' tables on ``device``, in the layout in which the
    wgmma core reads them: the bf16 basis transposed, (2*n_keep, k_pad), cos
    and sin rows interleaved, and the f32 filterbank rows in groups of 64
    mels, (groups * n_keep, 64): group g's n_keep rows hold mels 64g to 64g
    + 63, zero past n_mels; n_keep padded with zero rows / basis rows to a
    multiple of 64 (the kernel's N tile of 64 bins).  Basis column k holds
    frame sample k below frame_length, zero from there to k_pad; with
    ``chunk`` = (hop, hop_pad) (the halo kernel at a hop that is not a
    multiple of 8) column c*hop_pad + i holds sample c*hop + i for i < hop,
    zero at the hop row's pad and past frame_length (the TPU kernel's
    chunked basis, audio_metrics_tpu/ops/mel.py:440-446)."""
    fb = np.frombuffer(fb_bytes, np.float32).reshape(-1, n_mels)
    n_keep = _fb_support_bins(fb)
    n_keep_p = -(-n_keep // 64) * 64
    cos_m, sin_m = _dft_matrices(frame_length, n_fft, "hann")
    cols = np.arange(k_pad)
    if chunk is None:
        t = cols
    else:
        hop, hop_pad = chunk
        c, i = np.divmod(cols, hop_pad)
        t = np.where(i < hop, c * hop + i, frame_length)
    cols, t = cols[t < frame_length], t[t < frame_length]
    basis = np.zeros((2 * n_keep_p, k_pad), np.float32)
    basis[0 : 2 * n_keep : 2, cols] = cos_m[t, :n_keep].T
    basis[1 : 2 * n_keep : 2, cols] = sin_m[t, :n_keep].T
    groups = -(-n_mels // MEL_GROUP)
    fb_p = np.zeros((n_keep_p, groups * MEL_GROUP), np.float32)
    fb_p[:n_keep, :n_mels] = fb[:n_keep]
    fb_p = fb_p.reshape(n_keep_p, groups, MEL_GROUP).transpose(1, 0, 2).reshape(-1, MEL_GROUP)
    return (torch.from_numpy(basis).to(device, torch.bfloat16),
            torch.from_numpy(np.ascontiguousarray(fb_p)).to(device), n_keep_p)


def _frame_geometry(n: int, frame_length: int, hop_length: int, center: bool):
    """(half, n_frames, k_pad) of the log-mel kernels' frames of ``n``
    samples: the reflect pad (frame_length // 2 when ``center``), the frame
    count, and the frame padded to the 64-element TMA box, against zero
    basis columns."""
    half = frame_length // 2 if center else 0
    if center and n <= half:
        raise ValueError(f"reflect pad of {half} needs more than {half} samples, got {n}")
    n_frames = (n + 2 * half - frame_length) // hop_length + 1
    if n_frames < 1:
        raise ValueError(f"{n + 2 * half} samples hold no {frame_length}-sample frame")
    return half, n_frames, -(-frame_length // BK) * BK


@lru_cache(maxsize=None)
def halo_dft_map(b: int, n: int, frame_length: int, hop_length: int, center: bool) -> dict:
    """The 3-D TMA map through which the halo kernel reads its DFT's A, the
    frames, in place from the bf16 hop-row signal (B, clip_stride) that its
    first launch writes: dims (k_pad, n_frames, B) and box innermost first,
    strides (of dims 1-2) in elements.  The signal lies in rows of
    ``hop_pad`` samples, the hop rounded up to a multiple of 8 (the 16-byte
    frame stride TMA asks for): row r holds samples [r*hop, (r+1)*hop) of
    row z of the reflect-padded (``half`` = frame_length // 2 when
    ``center``) signal, then hop_pad - hop zeros, as the TPU kernel pads its
    hop rows (audio_metrics_tpu/ops/mel.py:436-438).  Frame r of clip z is
    then the span [r*hop_pad, r*hop_pad + k_pad) of the rows, its n_chunks =
    ceil(frame_length / hop) chunks each a row, against a basis zero at the
    pads (``chunk`` = (hop, hop_pad), the basis layout of ``_kernel_tables``);
    k_pad is the span of its frame_length samples, frame_length +
    (n_chunks - 1)*(hop_pad - hop), padded to the 64-element swizzle box,
    against zero basis columns.  At a hop that is a multiple of 8 hop_pad =
    hop: no pads, k_pad the frame padded to 64, ``chunk`` None (the v1
    kernel's basis).  ``n_frames``: frames per clip.  The kernel reads these
    numbers and computes none of them.  Cached: read it, do not change it."""
    half, n_frames, _ = _frame_geometry(n, frame_length, hop_length, center)
    hop_pad = -(-hop_length // 8) * 8
    n_chunks = -(-frame_length // hop_length)
    k_pad = -(-(frame_length + (n_chunks - 1) * (hop_pad - hop_length)) // BK) * BK
    clip_stride = -(-((n_frames - 1) * hop_pad + k_pad) // 8) * 8
    return dict(dims=(k_pad, n_frames, b), strides=(hop_pad, clip_stride),
                box=(BK, BM, 1), half=half, n_frames=n_frames,
                chunk=None if hop_pad == hop_length else (hop_length, hop_pad))


@lru_cache(maxsize=None)
def v1_dft_map(b: int, n: int, frame_length: int, hop_length: int, center: bool) -> dict:
    """The TMA map through which the v1 kernel reads its DFT's A, the bf16
    frame matrix (B*n_frames, k_pad) that its first launch writes: one run
    of rows, dims (k_pad, B*n_frames, 1) and box innermost first, strides
    (of dims 1-2) in elements, the TPU kernel's flat row tiling (a 128-row
    tile may span two clips).  Row z*n_frames + r holds frame r of clip z,
    samples [r*hop, r*hop + frame_length) of the reflect-padded (``half``)
    signal, zero past it and from frame_length to k_pad.  The pitch is
    k_pad, not the hop, so any hop is served.  ``n_frames``: frames per
    clip; ``chunk`` None, the contiguous frame's basis (``_kernel_tables``).
    The kernel reads these numbers and computes none of them.  Cached: read
    it, do not change it."""
    half, n_frames, k_pad = _frame_geometry(n, frame_length, hop_length, center)
    rows = b * n_frames
    if rows * k_pad >= 2**31:
        raise ValueError(f"log_mel_v1 kernel: {rows} x {k_pad} frame samples pass 32-bit "
                         "indices; call it on fewer clips")
    return dict(dims=(k_pad, rows, 1), strides=(k_pad, rows * k_pad), box=(BK, BM, 1),
                half=half, n_frames=n_frames, chunk=None)


def _log_mel_cuda(kernel, symbol, audio, amap, scratch, framing, *, frame_length, n_fft, fb,
                  log_mode, log_offset, out_affine, out_dtype):
    """Launch one of the log-mel kernels on (B, n) f32 ``audio``: ``amap``
    its DFT's A map and basis layout, ``scratch`` the shape of the bf16
    rows its first launch writes, ``framing`` the arguments that follow the
    output in its C entry.  Any mel count: the filterbank in groups of 64
    mels, the affine's scale and offset padded with zeros to whole
    groups."""
    out_dtype = out_dtype or torch.float32
    b, n = audio.shape
    if audio.dtype != torch.float32:
        raise NotImplementedError(f"{kernel.name} kernel takes (B, n) float32 audio, got "
                                  f"{audio.dtype}")
    if log_mode not in _LOG_MODES or out_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"{kernel.name} kernel: log_mode {log_mode!r}, out {out_dtype}")
    fb = np.ascontiguousarray(fb, np.float32)
    n_mels = fb.shape[1]
    if n_mels < 1:
        raise NotImplementedError(f"{kernel.name} kernel: a filterbank of no mel bins")
    basis_t, fb_p, n_keep = _kernel_tables(frame_length, amap["dims"][0], n_fft, fb.tobytes(),
                                           n_mels, amap["chunk"], str(audio.device))
    sc = of = None
    if out_affine is not None:
        pad = (0, -(-n_mels // MEL_GROUP) * MEL_GROUP - n_mels)
        sc, of = (F.pad(t.to(audio.device, torch.float32).reshape(-1), pad).contiguous()
                  for t in out_affine)
        require_cuda(sc, of, dtype=torch.float32)
    audio = audio.contiguous()
    require_cuda(audio, fb_p, dtype=torch.float32)
    rows = torch.empty(scratch, dtype=torch.bfloat16, device=audio.device)
    out = torch.empty((b, amap["n_frames"], n_mels), dtype=out_dtype, device=audio.device)
    kernel.launch(symbol, audio, n, amap["half"], rows, *amap["dims"], *amap["strides"],
                  *amap["box"], basis_t, n_keep, fb_p, sc, of, n_mels, _LOG_MODES[log_mode],
                  float(log_offset), int(out_dtype == torch.bfloat16), out, *framing)
    kernel.count()
    return out


def _log_mel_halo_cuda(audio, *, frame_length, hop_length, n_fft, fb, center, **kw):
    b, n = audio.shape
    amap = halo_dft_map(b, n, frame_length, hop_length, center)
    return _log_mel_cuda(KERNEL, "am_log_mel", audio, amap, (b, amap["strides"][1]),
                         (hop_length,), frame_length=frame_length, n_fft=n_fft, fb=fb, **kw)


def log_mel_halo(audio, *, frame_length: int, hop_length: int, n_fft: int, fb: np.ndarray,
                 center: bool = True, log_mode: str = "db", log_offset: float = 0.01,
                 out_affine=None, out_dtype=None):
    """audio (B, n) f32 -> log-mel (B, n_frames, n_mels) of ``out_dtype``
    (default f32): bf16 DFT of Hann frames (``center`` reflect-pads by
    frame_length//2), power, the ``fb`` (n_fft//2+1, n_mels) mel product in
    f32, ``log_mode`` "db" (10*log10(max(m, 1e-10))) or "natural"
    (log(m + log_offset)), then ``lm * scale + offset`` for ``out_affine``."""
    fn = log_mel_halo_plain if audio.device.type == "cpu" else _log_mel_halo_cuda
    return fn(audio, frame_length=frame_length, hop_length=hop_length, n_fft=n_fft, fb=fb,
              center=center, log_mode=log_mode, log_offset=log_offset, out_affine=out_affine,
              out_dtype=out_dtype)


def _log_mel_v1_cuda(audio, *, frame_length, hop_length, n_fft, fb, center, **kw):
    b, n = audio.shape
    amap = v1_dft_map(b, n, frame_length, hop_length, center)
    k_pad, rows, _ = amap["dims"]
    return _log_mel_cuda(KERNEL_V1, "am_log_mel_v1", audio, amap, (rows, k_pad),
                         (b, amap["n_frames"], hop_length, frame_length),
                         frame_length=frame_length, n_fft=n_fft, fb=fb, **kw)


def log_mel_v1(audio, *, frame_length: int, hop_length: int, n_fft: int, fb: np.ndarray,
               center: bool = True, log_mode: str = "db", log_offset: float = 0.01,
               out_affine=None, out_dtype=None):
    """``log_mel_halo``'s function with the frames materialised: (B, n) f32
    -> (B, n_frames, n_mels) of ``out_dtype``."""
    fn = log_mel_v1_plain if audio.device.type == "cpu" else _log_mel_v1_cuda
    return fn(audio, frame_length=frame_length, hop_length=hop_length, n_fft=n_fft, fb=fb,
              center=center, log_mode=log_mode, log_offset=log_offset, out_affine=out_affine,
              out_dtype=out_dtype)


def log_mel_spectrogram(audio, sampling_rate: int, frame_length: int, hop_length: int,
                        n_mels: int, fmin: float, fmax: float, n_fft: int | None = None,
                        center: bool = True,
                        mel_norm: str | None = "slaney", mel_scale: str = "slaney",
                        triangle_domain: str = "hz", zero_dc: bool = False,
                        log_mode: str = "db", log_offset: float = 0.01, compute_dtype=None,
                        out_affine=None, out_dtype=None, power: float = 2.0):
    """audio (B, n) -> log-mel (B, frames, n_mels) of the ``power``
    spectrogram (2.0, CLAP; 1.0, the magnitude, VGGish): ``log_mode`` "db"
    (10*log10(max(mel, 1e-10)), the CLAP convention) or "natural"
    (log(mel + log_offset), VGGish).  ``out_affine`` (scale, offset) is a
    per-bin affine applied to the log-mel (the bf16 CLAP forward folds
    BatchNorm here); ``out_dtype`` the output dtype (default f32).  bf16
    compute at ``power`` 2.0 goes to the halo log-mel wrapper, or to
    ``log_mel_v1`` when ``AM_TPU_MEL_V1`` is set (read here, at call
    time): a CUDA tensor launches the kernel, a CPU tensor takes its plain
    version.  Any other power runs the products, as the JAX dispatch
    (:625-631) sends only power 2.0 to a kernel."""
    fb_args = ((n_fft or frame_length) // 2 + 1, n_mels, float(fmin), float(fmax),
               int(sampling_rate), mel_norm, mel_scale, triangle_domain, zero_dc)
    fb = mel_filter_bank(*fb_args).astype(np.float32)
    if compute_dtype == torch.bfloat16 and power == 2.0:
        fn = log_mel_v1 if os.environ.get("AM_TPU_MEL_V1") else log_mel_halo
        return fn(
            audio, frame_length=frame_length, hop_length=hop_length,
            n_fft=n_fft or frame_length, fb=fb, center=center, log_mode=log_mode,
            log_offset=log_offset, out_affine=out_affine, out_dtype=out_dtype,
        )
    spec = stft_power(audio, frame_length, hop_length, n_fft=n_fft, center=center,
                      compute_dtype=compute_dtype, power=power)
    mel = torch.matmul(spec, device_table(mel_filter_bank, fb_args, spec.device))
    if log_mode == "db":
        lm = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    elif log_mode == "natural":
        lm = torch.log(mel + log_offset)
    else:
        raise ValueError(f"unknown log_mode {log_mode!r}")
    if out_affine is not None:
        sc, of = out_affine
        lm = lm * sc.float() + of.float()
    return lm.to(out_dtype or torch.float32)
