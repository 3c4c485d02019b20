"""Fused CLAP frontend: repeat-pad clip in, Swin patch tokens out.

Counterpart of ``audio_metrics_tpu/ops/frontend_fused.py`` (:63-434).  The
static planning (``_plan``, ``_interp_phase_rows``, ``_patch_selector``,
``fused_frontend_supported``) is the same numpy code; the kernel is
kernels/csrc/frontend.cu, and the plain version is the unfused chain
``models.clap.clap_mel_tiled`` -> ``models.htsat.frontend_tokens``.

Dispatch: a CPU tensor runs :func:`clap_tokens_fused_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..kernels import KERNELS, check_sm90_gemm, require_cuda

__all__ = [
    "clap_tokens_fused",
    "clap_tokens_fused_plain",
    "check_frontend_gemms",
    "frontend_tables",
    "fused_frontend_supported",
]

KERNEL = KERNELS["clap_frontend"]
FRAME, HOP = 1024, 480


@lru_cache(maxsize=None)
def _plan(n: int, sr: int, frame: int, hop: int, n_mels: int, spec: int, ps: int):
    """Static geometry for an n-sample repeat-pad clip (frontend_fused.py:
    63-125): head = left reflect pad + one clip period + lookahead, mid =
    period-repeated head rows, tail = right reflect pad; hop-row layout of
    the kernel's signal buffer; token geometry."""
    max_samples = 10 * sr
    if max_samples % n or n % hop or n < frame:
        raise ValueError(f"{n} samples is not a repeat-pad clip at {sr} Hz")
    p = n // hop  # frames per clip period
    half = frame // 2
    n_frames = max_samples // hop + 1
    t_tail0 = (max_samples - half) // hop + 1
    n_chunks = -(-frame // hop)
    head_frames = p + 2
    tail_frames = n_frames - t_tail0
    # hop rows: head frames need head_frames + n_chunks - 1 rows, rounded to
    # 8 like the TPU kernel's DMA slices; the tail's rows follow
    tail_row0 = -(-(head_frames + n_chunks - 1) // 8) * 8
    tail_rows = -(-(tail_frames + n_chunks - 1) // 8) * 8
    frame_rows = -(-(tail_row0 + tail_frames) // 64) * 64  # DFT product rows
    clip_stride = -(-((frame_rows - 1) * hop + frame) // 8) * 8
    ratio = spec // n_mels
    spec_w = spec * ratio
    return dict(
        p=p, half=half, extra=hop + half, n_frames=n_frames, head_frames=head_frames,
        t_tail0=t_tail0, tail_row0=tail_row0, tail_rows=tail_rows,
        frame_rows=frame_rows, clip_stride=clip_stride, ratio=ratio, spec_w=spec_w,
        gw=spec_w // ratio // ps, fb=n_mels // ps, mel_pad=-(-n_frames // 128) * 128,
    )


@lru_cache(maxsize=None)
def _interp_phase_rows(n_frames: int, spec_w: int, ratio: int, ps: int, pad_cols: int):
    """(ps, spec_w // ps, pad_cols) f32: the bicubic interp matrix with rows
    regrouped by patch-column phase dh — rows [dh, chunk*gw + g] pick interp
    output index chunk*(spec_w//ratio) + g*ps + dh."""
    from ..models.htsat import _bicubic_matrix

    wi = _bicubic_matrix(n_frames, spec_w)  # (spec_w, n_frames)
    chunk_w = spec_w // ratio
    gw = chunk_w // ps
    out = np.zeros((ps, ratio * gw, pad_cols), np.float32)
    for dh in range(ps):
        for chunk in range(ratio):
            for g in range(gw):
                out[dh, chunk * gw + g, :n_frames] = wi[chunk * chunk_w + g * ps + dh]
    return out


@lru_cache(maxsize=None)
def _patch_selector(n_mels: int, ps: int):
    """(ps * n_mels * fb, ps*ps) 0/1 f32 selector S with
    S[(dh*n_mels + f) * fb + fblk, p] = 1 iff p = (f - ps*fblk)*ps + dh and
    ps*fblk <= f < ps*(fblk+1); (S @ wp).reshape(ps*n_mels, fb*C) is the
    zero-padded block patch-embed operand."""
    fb = n_mels // ps
    s = np.zeros((ps * n_mels * fb, ps * ps), np.float32)
    for dh in range(ps):
        for f in range(n_mels):
            fblk = f // ps
            dv = f - ps * fblk
            s[(dh * n_mels + f) * fb + fblk, dv * ps + dh] = 1.0
    return s


def fused_frontend_supported(n: int, sr: int, cfg) -> bool:
    """The fused path covers the repeat-pad geometry: the clip tiles a whole
    number of times, the frequency axis equals the mel bins, chunks and
    patches align (always true for HTSAT-base 5 s windows at 48 kHz)."""
    max_samples = 10 * sr
    spec_h = cfg.spec_size // cfg.freq_ratio
    return (
        n < max_samples
        and max_samples % n == 0
        and n % HOP == 0
        and n >= FRAME
        and cfg.num_mel_bins == spec_h
        and spec_h % cfg.patch_size == 0
        and cfg.spec_size % cfg.patch_size == 0
    )


def frontend_tables(params: dict, cfg, fb_matrix: np.ndarray, sr: int) -> dict:
    """Numpy f32 tables of both versions, built once per weight load.

    Plain version: ``bn_scale``/``bn_offset`` (eval BatchNorm folded to a
    per-bin affine), ``patch_w`` (ps*ps, C) input-major, ``patch_b``,
    ``ln_w``/``ln_b``.  Kernel: ``basis_t`` (2*n_keep, frame), the DFT
    basis cut to the filterbank support with cos/sin rows interleaved,
    ``fb`` (n_keep, n_mels), ``wi`` (ps*rg, mel_pad) phase-split interp
    rows, ``qcat_t`` (fbk*C, ps*n_mels), the zero-padded block patch-embed
    operand, and ``pbias`` (fbk*C).  The two ``_t`` matrices are held
    transposed, (N, K): the K-major layout in which the wgmma core
    (kernels/csrc/gemm_sm90.cuh) reads both operands of a product."""
    from .mel import _dft_matrices, _fb_support_bins

    f32 = lambda k: np.asarray(params[k], np.float32)
    ps, n_mels, c = cfg.patch_size, cfg.num_mel_bins, cfg.embed_dim
    bn_s = f32("audio_encoder.batch_norm.weight") / np.sqrt(
        f32("audio_encoder.batch_norm.running_var") + np.float32(1e-5)
    )
    bn_o = f32("audio_encoder.batch_norm.bias") - f32("audio_encoder.batch_norm.running_mean") * bn_s
    patch_w = f32("audio_encoder.patch_embed.proj.weight").reshape(-1, ps * ps).T

    cos_m, sin_m = _dft_matrices(FRAME, FRAME, "hann")
    n_keep = _fb_support_bins(fb_matrix)
    basis = np.empty((FRAME, 2 * n_keep), np.float32)
    basis[:, 0::2] = cos_m[:, :n_keep]
    basis[:, 1::2] = sin_m[:, :n_keep]
    n_frames = 10 * sr // HOP + 1
    ratio = cfg.spec_size // n_mels
    mel_pad = -(-n_frames // 128) * 128
    wi = _interp_phase_rows(n_frames, cfg.spec_size * ratio, ratio, ps, mel_pad)
    fbk = n_mels // ps
    qcat = (_patch_selector(n_mels, ps) @ patch_w).reshape(ps * n_mels, fbk * c)
    return dict(
        bn_scale=bn_s, bn_offset=bn_o, patch_w=np.ascontiguousarray(patch_w),
        patch_b=f32("audio_encoder.patch_embed.proj.bias"),
        ln_w=f32("audio_encoder.patch_embed.norm.weight"),
        ln_b=f32("audio_encoder.patch_embed.norm.bias"),
        basis_t=np.ascontiguousarray(basis.T),
        fb=np.ascontiguousarray(fb_matrix[:n_keep], np.float32),
        wi=wi.reshape(ps * wi.shape[1], mel_pad), qcat_t=np.ascontiguousarray(qcat.T),
        pbias=np.tile(f32("audio_encoder.patch_embed.proj.bias"), fbk),
    )


# bf16 tables of the kernel (the rest stay f32)
BF16_TABLES = ("basis_t", "wi", "qcat_t")


def clap_tokens_fused_plain(audio, t, *, sr: int, cfg):
    """The unfused chain: repeat-pad log-mel in bf16 with BatchNorm folded
    into the dB epilogue (models/clap.clap_mel_tiled, through the halo
    log-mel kernel's plain version on any device: no kernel runs here),
    then models/htsat.frontend_tokens.  audio (B, n) f32 -> (B, grid^2, C)
    bf16."""
    from ..models.clap import clap_mel_tiled
    from ..models.htsat import frontend_tokens

    mel = clap_mel_tiled(
        audio, compute_dtype=torch.bfloat16, out_affine=(t.bn_scale, t.bn_offset),
        out_dtype=torch.bfloat16, plain=True,
    )
    return frontend_tokens(mel, t.patch_w, t.patch_b, t.ln_w, t.ln_b, cfg, torch.bfloat16)


def check_frontend_gemms(n_keep: int, cfg, pln: dict) -> None:
    """Raise ``NotImplementedError`` unless the wgmma core takes the
    frontend's three products (``kernels.check_sm90_gemm``): the DFT of
    frames ``HOP`` apart in clips ``clip_stride`` apart, the interp product
    over the transposed mel, the patch product."""
    n_mels, ps, mel_pad = cfg.num_mel_bins, cfg.patch_size, pln["mel_pad"]
    check_sm90_gemm("clap_frontend DFT", 2 * n_keep, FRAME, HOP, pln["clip_stride"])
    check_sm90_gemm("clap_frontend interp", n_mels, mel_pad, n_mels * mel_pad)
    check_sm90_gemm("clap_frontend patch", pln["fb"] * cfg.embed_dim, ps * n_mels)


def _clap_tokens_fused_cuda(audio, t, *, sr, cfg):
    b, n = audio.shape
    require_cuda(audio, dtype=torch.float32)
    require_cuda(t.basis_t, t.wi, t.qcat_t)
    ps, n_mels, c = cfg.patch_size, cfg.num_mel_bins, cfg.embed_dim
    pln = _plan(n, sr, FRAME, HOP, n_mels, cfg.spec_size, ps)
    n_keep = t.fb.shape[0]
    rg, fbk = pln["ratio"] * pln["gw"], pln["fb"]
    check_frontend_gemms(n_keep, cfg, pln)

    # the kernel builds the bf16 hop rows (the TPU kernel's signal rows):
    # head = left reflect pad + one period + lookahead, cut at tail_row0
    # rows; tail = last period's end + right reflect pad
    # (frontend_fused.py:227-232)
    half, extra = pln["half"], pln["extra"]
    head_len = min(half + n + extra, pln["tail_row0"] * HOP)
    dev = audio.device
    hops = torch.empty((b, pln["clip_stride"]), dtype=torch.bfloat16, device=dev)
    frame_rows, mel_pad = pln["frame_rows"], pln["mel_pad"]
    power = torch.empty((b, frame_rows, n_keep), dtype=torch.float32, device=dev)
    mel_t = torch.empty((b, n_mels, mel_pad), dtype=torch.bfloat16, device=dev)
    xi = torch.empty((b, rg, ps * n_mels), dtype=torch.bfloat16, device=dev)
    tok = torch.empty((b * rg, fbk * c), dtype=torch.float32, device=dev)
    out = torch.empty((b, rg * fbk, c), dtype=torch.bfloat16, device=dev)
    KERNEL.launch(
        "am_clap_frontend", audio, n, half, extra, head_len, hops, pln["clip_stride"], HOP,
        FRAME, frame_rows, t.basis_t, n_keep, power, t.fb, t.bn_scale, t.bn_offset, n_mels,
        pln["p"],
        pln["head_frames"], pln["t_tail0"], pln["tail_row0"], pln["n_frames"], mel_pad,
        mel_t, t.wi, ps, rg, xi, t.qcat_t, t.pbias, fbk, c, tok, t.ln_w, t.ln_b,
        float(cfg.layer_norm_eps), pln["gw"], out, b,
    )
    KERNEL.launches += 1
    return out


def clap_tokens_fused(audio, t, *, sr: int, cfg):
    """audio (B, n) repeat-pad clip f32 -> patch tokens (B, grid^2, C) bf16.
    ``t`` holds the :func:`frontend_tables` as tensors (attributes)."""
    fn = clap_tokens_fused_plain if audio.device.type == "cpu" else _clap_tokens_fused_cuda
    return fn(audio, t, sr=sr, cfg=cfg)
