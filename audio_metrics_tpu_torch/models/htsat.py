"""HTSAT (Hierarchical Token-Semantic Audio Transformer) encoder in PyTorch.

Counterpart of ``audio_metrics_tpu/models/htsat.py``.  The numpy half
(configs, ``init_params``, the static index/mask/interp tables) is copied
so that the same seed gives the same parameter dict in both packages.  The
model half holds the weights already laid out for the path each block takes
— for the kernels the LN1 affine and 1/sqrt(d) scale in ``wqkv``/``bq3``,
the value bias in ``bp``, the bias+mask table, and the patch-merge LN fold
— computed once when the weights load, not on every forward.

Which path a Swin block takes follows the JAX package's ``_swin_block``
(:528-631) and the same three environment variables, read once when the
encoder is built (the JAX package reads the first two at import, the third
when it traces a forward): under ``AM_TPU_MERGED_ATTN`` the blocks with
window < resolution <= 16 (stage 2) run their attention half as v1 over
one 256-token window an image (window = resolution, the shift kept, the
dense table of :func:`_merged_bias_mask`), whatever the other two say;
``AM_TPU_V4_STAGES`` (default ``2u,2s,0u,0s,1u,1s,3u``) lists the
``{stage}{u|s}`` entries whose other blocks run whole (v4); the rest run
their attention half as v3, or, under ``AM_TPU_ATTN_V1``, as v1 at stages
of >= 16 windows and as the XLA attention elsewhere; then the fused MLP
where a forward has >= 1024 tokens or >= 16384 rows, else the XLA MLP.

Parameter naming follows the HF Clap state dict, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..ops.attention import (
    merged_live_tiles,
    swin_attention_half_v1,
    swin_attention_half_v1_plain,
    swin_attention_half_v3,
    swin_attention_half_v3_plain,
    swin_block,
    swin_block_operands,
    swin_block_plain,
    v1_operands,
    window_attention_xla,
)
from ..ops.mel import device_table
from ..ops.merge import merge_weight_t, patch_merge, patch_merge_plain
from ..ops.mlp import layer_norm, mlp_block, mlp_block_plain, mlp_operands, mlp_xla
from ..utils.precision import full_f32

__all__ = [
    "HTSATConfig",
    "HTSAT_BASE",
    "HTSAT_TINY",
    "HTSATEncoder",
    "init_params",
    "frontend_tokens",
    "layer_norm",
]


@dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    num_mel_bins: int = 64
    embed_dim: int = 128  # patch_embeds_hidden_size
    depths: tuple = (2, 2, 12, 2)
    num_heads: tuple = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @property
    def grid_size(self) -> int:
        return self.spec_size // self.patch_stride


# the reference's HTSAT-base (laion_clap amodel="HTSAT-base")
HTSAT_BASE = HTSATConfig(embed_dim=128, depths=(2, 2, 12, 2))
# HF transformers' default ClapAudioConfig (laion/clap-htsat-unfused)
HTSAT_TINY = HTSATConfig(embed_dim=96, depths=(2, 2, 6, 2))


# ----------------------------------------------------------------------
# static tables (host, cached) — audio_metrics_tpu/models/htsat.py:115-198
# ----------------------------------------------------------------------
@lru_cache(maxsize=None)
def _relative_position_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)  # (window^2, window^2)


@lru_cache(maxsize=None)
def _shift_attn_mask(height: int, width: int, window: int, shift: int) -> np.ndarray:
    """Attention mask for shifted-window attention: (n_windows, w^2, w^2)."""
    img = np.zeros((height, width))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = count
            count += 1
    win = img.reshape(height // window, window, width // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=None)
def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) 1-D bicubic interpolation matrix, align_corners=True,
    border-replicated taps (torch F.interpolate semantics), a = -0.75."""
    a = -0.75

    def kernel(x):
        x = np.abs(x)
        return np.where(
            x <= 1,
            (a + 2) * x**3 - (a + 3) * x**2 + 1,
            np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
        )

    w = np.zeros((n_out, n_in))
    if n_out == 1:
        src = np.zeros(1)
    else:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.floor(src).astype(int)
    frac = src - i0
    for tap in (-1, 0, 1, 2):
        idx = np.clip(i0 + tap, 0, n_in - 1)
        wt = kernel(frac - tap)
        np.add.at(w, (np.arange(n_out), idx), wt)
    return w.astype(np.float32)


# ----------------------------------------------------------------------
# init — audio_metrics_tpu/models/htsat.py:994-1045 (same rng call order)
# ----------------------------------------------------------------------
def init_params(cfg: HTSATConfig = HTSAT_BASE, seed: int = 0) -> dict:
    """Seeded random parameters with HF Clap naming."""
    rng = np.random.default_rng(seed)
    p = {}

    def lin(prefix, d_in, d_out, bias=True):
        p[f"{prefix}.weight"] = (
            rng.normal(scale=0.02, size=(d_out, d_in)).astype(np.float32)
        )
        if bias:
            p[f"{prefix}.bias"] = np.zeros(d_out, np.float32)

    def ln(prefix, d):
        p[f"{prefix}.weight"] = np.ones(d, np.float32)
        p[f"{prefix}.bias"] = np.zeros(d, np.float32)

    nm = cfg.num_mel_bins
    p["audio_encoder.batch_norm.weight"] = np.ones(nm, np.float32)
    p["audio_encoder.batch_norm.bias"] = np.zeros(nm, np.float32)
    p["audio_encoder.batch_norm.running_mean"] = np.zeros(nm, np.float32)
    p["audio_encoder.batch_norm.running_var"] = np.ones(nm, np.float32)

    ps = cfg.patch_size
    p["audio_encoder.patch_embed.proj.weight"] = rng.normal(
        scale=0.02, size=(cfg.embed_dim, 1, ps, ps)
    ).astype(np.float32)
    p["audio_encoder.patch_embed.proj.bias"] = np.zeros(cfg.embed_dim, np.float32)
    ln("audio_encoder.patch_embed.norm", cfg.embed_dim)

    for i, depth in enumerate(cfg.depths):
        dim = cfg.embed_dim * 2**i
        for j in range(depth):
            pre = f"audio_encoder.layers.{i}.blocks.{j}"
            ln(f"{pre}.layernorm_before", dim)
            for name in ("query", "key", "value"):
                lin(f"{pre}.attention.self.{name}", dim, dim, bias=cfg.qkv_bias)
            p[f"{pre}.attention.self.relative_position_bias_table"] = rng.normal(
                scale=0.02,
                size=((2 * cfg.window_size - 1) ** 2, cfg.num_heads[i]),
            ).astype(np.float32)
            lin(f"{pre}.attention.output.dense", dim, dim)
            ln(f"{pre}.layernorm_after", dim)
            hidden = int(cfg.mlp_ratio * dim)
            lin(f"{pre}.intermediate.dense", dim, hidden)
            lin(f"{pre}.output.dense", hidden, dim)
        if i < len(cfg.depths) - 1:
            pre = f"audio_encoder.layers.{i}.downsample"
            ln(f"{pre}.norm", 4 * dim)
            lin(f"{pre}.reduction", 4 * dim, 2 * dim, bias=False)

    ln("audio_encoder.norm", cfg.num_features)
    return p


# ----------------------------------------------------------------------
# weight layouts (numpy f32, once at load)
# ----------------------------------------------------------------------
def _bias_mask(p: dict, pre: str, resolution: int, shift: int, num_heads: int,
               window: int) -> np.ndarray:
    """(nW or 1, heads, n, n) additive relative-position bias + shift mask
    (audio_metrics_tpu/models/htsat.py:338-345, :414-421)."""
    n = window * window
    table = np.asarray(p[f"{pre}.self.relative_position_bias_table"], np.float32)
    idx = _relative_position_index(window).reshape(-1)
    bias = table[idx].reshape(n, n, num_heads).transpose(2, 0, 1)
    if shift > 0:
        bm = bias[None] + _shift_attn_mask(resolution, resolution, window, shift)[:, None]
    else:
        bm = bias[None]
    return np.ascontiguousarray(bm, np.float32)


@lru_cache(maxsize=None)
def _merged_window_index(resolution: int, window: int):
    """Token -> (window id, position within its window) of the merged
    one-window layout (audio_metrics_tpu/models/htsat.py:143-153): tokens in
    the rolled image's raster order, windows (row-block, col-block) in row
    order, as :func:`_shift_attn_mask` numbers them."""
    idx = np.arange(resolution)
    rr, cc = np.meshgrid(idx, idx, indexing="ij")
    wid = (rr // window) * (resolution // window) + (cc // window)
    pid = (rr % window) * window + (cc % window)
    return wid.reshape(-1), pid.reshape(-1)


def _merged_bias_mask(bm: np.ndarray, resolution: int, window: int) -> np.ndarray:
    """A per-window (nW or 1, heads, n, n) bias+mask table scattered onto
    the dense (1, heads, R^2, R^2) table of one window over the whole image
    (audio_metrics_tpu/models/htsat.py:156-172): pairs of two windows get
    -1e9, whose probability underflows to exactly 0 in the f32 softmax, so
    the one-window attention equals the per-window one.  4 MB a block at
    stage 2 (16 heads of 256^2 f32), made once at load."""
    wid, pid = _merged_window_index(resolution, window)
    same = wid[:, None] == wid[None, :]
    if bm.shape[0] == 1:
        dense = bm[0][:, pid[:, None], pid[None, :]]  # (heads, N, N)
    else:
        dense = bm[wid[:, None], :, pid[:, None], pid[None, :]].transpose(2, 0, 1)
    return np.ascontiguousarray(np.where(same[None, None], dense[None], np.float32(-1e9)),
                                np.float32)


def _mlp_weights(p: dict, prefix: str) -> dict:
    """LN2 and the MLP, input-major (htsat.py:612-631)."""
    f32 = lambda k: np.asarray(p[k], np.float32)
    return dict(
        ln2_w=f32(f"{prefix}.layernorm_after.weight"),
        ln2_b=f32(f"{prefix}.layernorm_after.bias"),
        w1=f32(f"{prefix}.intermediate.dense.weight").T,
        b1=f32(f"{prefix}.intermediate.dense.bias"),
        w2=f32(f"{prefix}.output.dense.weight").T,
        b2=f32(f"{prefix}.output.dense.bias"),
    )


def _v3_kernel_weights(p: dict, prefix: str, resolution: int, shift: int,
                       num_heads: int, window: int) -> dict:
    """audio_metrics_tpu/models/htsat.py:370-422, for the v4 and v3 paths:
    fused (C, 3C) ``wqkv`` with the 1/sqrt(d) scale folded into q and the
    LN1 affine folded into weights and bias, the key bias dropped (constant
    per score row), the value bias folded into the projection bias (softmax
    rows sum to 1), and the (nW or 1, heads, n, n) additive bias+mask
    table; with LN2 and the MLP.  All f32 numpy."""
    f32 = lambda k: np.asarray(p[k], np.float32)
    pre = f"{prefix}.attention"
    c = p[f"{pre}.self.query.weight"].shape[0]
    d = c // num_heads
    scale = np.float32(1.0 / np.sqrt(d))

    wqkv_f32 = np.concatenate(
        [
            f32(f"{pre}.self.query.weight").T * scale,
            f32(f"{pre}.self.key.weight").T,
            f32(f"{pre}.self.value.weight").T,
        ],
        axis=1,
    )
    ln_w = f32(f"{prefix}.layernorm_before.weight")
    ln_b = f32(f"{prefix}.layernorm_before.bias")
    wqkv = ln_w[:, None] * wqkv_f32
    bq3 = (
        np.concatenate(
            [f32(f"{pre}.self.query.bias") * scale, np.zeros(2 * c, np.float32)]
        )
        + ln_b @ wqkv_f32
    )
    wp = f32(f"{pre}.output.dense.weight").T
    bv = f32(f"{pre}.self.value.bias")
    bp = f32(f"{pre}.output.dense.bias") + bv @ wp
    return dict(
        wqkv=wqkv, bq3=bq3, wp=wp, bp=bp,
        bm=_bias_mask(p, pre, resolution, shift, num_heads, window),
        **_mlp_weights(p, prefix),
    )


def _v1_kernel_weights(p: dict, prefix: str, resolution: int, shift: int,
                       num_heads: int, window: int) -> dict:
    """audio_metrics_tpu/models/htsat.py:320-345, for the v1 path: per-head
    ``wq``/``wk``/``wv`` (heads, C, d) with the 1/sqrt(d) scale in wq and
    ``bq`` (heads, d), ``wp`` (heads, d, C), the value bias folded into
    ``bp``, the LN1 affine kept apart, the bias+mask table; with LN2 and the
    MLP.  ``bq`` is scaled as there: by the float64 1/sqrt(d), rounded once
    to f32 (the JAX package multiplies by a Python float with x64 on), ``wq``
    by that scale in f32."""
    f32 = lambda k: np.asarray(p[k], np.float32)
    pre = f"{prefix}.attention"
    c = p[f"{pre}.self.query.weight"].shape[0]
    d = c // num_heads
    scale = np.float32(1.0 / np.sqrt(d))
    heads = lambda w: w.T.reshape(c, num_heads, d).transpose(1, 0, 2)
    wp = f32(f"{pre}.output.dense.weight").T.reshape(num_heads, d, c)
    bv = f32(f"{pre}.self.value.bias").reshape(num_heads, d)
    return dict(
        ln1_w=f32(f"{prefix}.layernorm_before.weight"),
        ln1_b=f32(f"{prefix}.layernorm_before.bias"),
        wq=heads(f32(f"{pre}.self.query.weight")) * scale,
        bq=(f32(f"{pre}.self.query.bias").reshape(num_heads, d).astype(np.float64)
            * (1.0 / np.sqrt(d))).astype(np.float32),
        wk=heads(f32(f"{pre}.self.key.weight")),
        wv=heads(f32(f"{pre}.self.value.weight")),
        wp=wp,
        bp=f32(f"{pre}.output.dense.bias") + np.einsum("hd,hdc->c", bv, wp),
        bm=_bias_mask(p, pre, resolution, shift, num_heads, window),
        **_mlp_weights(p, prefix),
    )


def _merged_kernel_weights(p: dict, prefix: str, resolution: int, shift: int,
                           num_heads: int, window: int) -> dict:
    """The merged path's weights (``AM_TPU_MERGED_ATTN``,
    audio_metrics_tpu/models/htsat.py:347-349): v1's, with its (nW or 1,
    heads, 64, 64) table scattered onto the dense (1, heads, R^2, R^2) one
    (:func:`_merged_bias_mask`)."""
    w = _v1_kernel_weights(p, prefix, resolution, shift, num_heads, window)
    w["bm"] = _merged_bias_mask(w["bm"], resolution, window)
    return w


def _v2_kernel_weights(p: dict, prefix: str, resolution: int, shift: int,
                       num_heads: int, window: int) -> dict:
    """The layout of the v2 attention half (``ops.attention.
    swin_attention_half_v2``), which no block path takes: v1's weights side
    by side, ``wqkv`` (C, 3C) = [Wq^T/sqrt(d), Wk^T, Wv^T], ``bq3`` (3C,)
    with the scaled q bias and zeros on k and v, ``wp`` (C, C), and v1's
    ``bp``, ``bm`` and LN1 affine, as tests/test_pallas_model_kernels.py:
    422-439 builds them; with LN2 and the MLP."""
    w = _v1_kernel_weights(p, prefix, resolution, shift, num_heads, window)
    h, c, d = w["wq"].shape
    cols = lambda a: a.transpose(1, 0, 2).reshape(c, h * d)
    w["wqkv"] = np.concatenate([cols(w.pop(k)) for k in ("wq", "wk", "wv")], axis=1)
    w["bq3"] = np.concatenate([w.pop("bq").reshape(-1), np.zeros(2 * c, np.float32)])
    w["wp"] = w["wp"].reshape(h * d, c)
    return w


def _xla_weights(p: dict, prefix: str, resolution: int, shift: int,
                 num_heads: int, window: int) -> dict:
    """The raw weights of the XLA attention half (htsat.py:237-285,
    :584-607): fused (C, 3C) ``wqkv`` and (3C,) ``bqkv`` unscaled, ``wp``
    and ``bp`` as given, the gathered (heads, n, n) relative-position bias
    and the (nW, n, n) shift mask apart; with LN2 and the MLP."""
    f32 = lambda k: np.asarray(p[k], np.float32)
    pre = f"{prefix}.attention"
    names = ("query", "key", "value")
    n = window * window
    table = f32(f"{pre}.self.relative_position_bias_table")
    idx = _relative_position_index(window).reshape(-1)
    w = dict(
        ln1_w=f32(f"{prefix}.layernorm_before.weight"),
        ln1_b=f32(f"{prefix}.layernorm_before.bias"),
        wqkv=np.concatenate([f32(f"{pre}.self.{k}.weight").T for k in names], axis=1),
        bqkv=np.concatenate([f32(f"{pre}.self.{k}.bias") for k in names]),
        wp=f32(f"{pre}.output.dense.weight").T,
        bp=f32(f"{pre}.output.dense.bias"),
        rel_bias=table[idx].reshape(n, n, num_heads).transpose(2, 0, 1),
        **_mlp_weights(p, prefix),
    )
    if shift > 0:
        w["mask"] = _shift_attn_mask(resolution, resolution, window, shift)
    return w


def _merge_weights(p: dict, prefix: str) -> dict:
    """audio_metrics_tpu/models/htsat.py:697-716: LN(concat) @ W ==
    rs * sum_j x_j @ (g W)_j - rs*mu*(g @ W) + b @ W, with the concat
    blocks in [x00, x10, x01, x11] order."""
    g = np.asarray(p[f"{prefix}.norm.weight"], np.float32)
    be = np.asarray(p[f"{prefix}.norm.bias"], np.float32)
    w_io = np.asarray(p[f"{prefix}.reduction.weight"], np.float32).T  # (4c, oc)
    c = w_io.shape[0] // 4
    return dict(
        wg=(g[:, None] * w_io).reshape(4, c, w_io.shape[1]),
        svec=g @ w_io,
        tvec=be @ w_io,
    )


_MATRICES = ("wqkv", "wp", "w1", "w2", "wg", "wq", "wk", "wv")  # held in the compute dtype
_WEIGHTS = {"v4": _v3_kernel_weights, "v3": _v3_kernel_weights, "v1": _v1_kernel_weights,
            "merged": _merged_kernel_weights, "xla": _xla_weights}
_DEFAULT_V4_STAGES = "2u,2s,0u,0s,1u,1s,3u"


class _Folded(nn.Module):
    """Buffers from a dict of folded numpy weights: matrices in the compute
    dtype, vectors and tables in f32."""

    def __init__(self, weights: dict, dtype: torch.dtype):
        super().__init__()
        for name, arr in weights.items():
            t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
            self.register_buffer(name, t.to(dtype) if name in _MATRICES else t)


def attention_choice(stage: int, shift: int, n_windows: int, v4_stages: frozenset,
                     attn_v1: bool, merged_attn: bool = False, resolution: int = 0) -> str:
    """The attention path of one block, in the dispatch order of
    audio_metrics_tpu/models/htsat.py:553-584 (``shift`` after the
    one-window rule): "merged" (v1 over one window of the whole image) if
    ``AM_TPU_MERGED_ATTN`` is set and window < ``resolution`` <= 16 (more
    than one window, at most 256 tokens), before the other rules; else "v4"
    (the whole block in one kernel) if the block's ``{stage}{u|s}`` entry
    is in the table and ``AM_TPU_ATTN_V1`` is unset; else "v3" if it is
    unset; else "v1" at >= 16 windows; else "xla"."""
    if merged_attn and n_windows > 1 and resolution <= 16:
        return "merged"
    if not attn_v1:
        return "v4" if f"{stage}{'s' if shift else 'u'}" in v4_stages else "v3"
    return "v1" if n_windows >= 16 else "xla"


class SwinBlock(_Folded):
    """One Swin block.  ``attention`` is its path ("merged", "v4", "v3",
    "v1" or "xla", :func:`attention_choice`; "merged" runs v1 at window =
    resolution); it holds the weights in that path's
    layout, and since they loaded what its kernels read besides
    (:meth:`kernel_operands`).  ``forward(x)`` runs the kernel wrappers (or
    the XLA halves, in f32 under ``full_f32``); ``forward(x, plain=True)``
    the kernels' plain versions on any device."""

    def __init__(self, p, prefix, cfg: HTSATConfig, resolution: int, shift: int,
                 heads: int, dtype, attention: str = "v4"):
        window = cfg.window_size
        if resolution <= window:  # htsat.py:534-536: one window, no shift
            window, shift = resolution, 0
        super().__init__(
            _WEIGHTS[attention](p, prefix, resolution, shift, heads, window), dtype
        )
        if attention == "merged":  # htsat.py:347-349: one window spanning the image
            window = resolution
        self.attention = attention
        self.resolution, self.window, self.shift = resolution, window, shift
        self.heads, self.eps = heads, cfg.layer_norm_eps
        # what the kernels read besides: the whole block's transposed (bf16)
        # or split (f32) matrices and column sums, which the v3 half and the
        # MLP read too; else the MLP's, and the v1 half's in the same form
        if attention in ("v4", "v3"):
            ops = swin_block_operands(self.wqkv, self.wp, self.w1, self.w2)
        else:
            ops = mlp_operands(self.w1, self.w2)  # the fused MLP at a large enough batch
            if attention in ("v1", "merged"):
                ops.update(v1_operands(self.wq, self.bq, self.wk, self.wv, self.wp))
            if attention == "merged":  # the table's live key tiles, made from its values
                ops["live"] = merged_live_tiles(self.bm)
        for name, t in ops.items():
            self.register_buffer(name, t)
        self._operand_names = tuple(ops)

    def kernel_operands(self) -> dict:
        """What this block's kernels read besides the plain versions'
        operands, held as buffers since the weights loaded: the whole
        block's :func:`ops.attention.swin_block_operands` (v4 and v3 blocks,
        whose attention half and MLP read it); else the MLP's
        :func:`ops.mlp.mlp_operands`, with v1 and merged blocks'
        :func:`ops.attention.v1_operands`, and merged blocks' live-tile
        lists of their table (``live``, :func:`ops.attention.
        merged_live_tiles`)."""
        return {k: getattr(self, k) for k in self._operand_names}

    def fused_mlp(self, batch: int) -> bool:
        """htsat.py:547-551: the MLP kernel where the forward has >= 1024
        tokens or >= 16384 rows; the XLA MLP below that."""
        tokens = self.resolution * self.resolution
        return tokens >= 1024 or batch * tokens >= 16384

    def _xla_precision(self, x):
        """The XLA halves hold full f32 products in f32 (TF32 off), as the
        f32 mel chain does: a caller's global TF32 setting never reaches
        them, as it reaches no f32 kernel."""
        return full_f32() if x.dtype == torch.float32 else contextlib.nullcontext()

    def forward(self, x, plain: bool = False):
        b, n, c = x.shape
        r = self.resolution
        x4 = x.view(b, r, r, c)
        geo = dict(heads=self.heads, window=self.window, shift=self.shift, eps=self.eps)
        mlp = (self.ln2_w, self.ln2_b, self.w1, self.b1, self.w2, self.b2)
        ops = {} if plain else dict(operands=self.kernel_operands())
        if self.attention == "v4":
            args = (x4, self.wqkv, self.bq3, self.wp, self.bp, self.bm, *mlp)
            fn = swin_block_plain if plain else swin_block
            return fn(*args, **geo, **ops).view(b, n, c)
        if self.attention == "v3":
            fn = swin_attention_half_v3_plain if plain else swin_attention_half_v3
            x4 = fn(x4, self.wqkv, self.bq3, self.wp, self.bp, self.bm, **geo, **ops)
        elif self.attention in ("v1", "merged"):
            fn = swin_attention_half_v1_plain if plain else swin_attention_half_v1
            x4 = fn(x4, self.ln1_w, self.ln1_b, self.wq, self.bq, self.wk, self.wv, self.wp,
                    self.bp, self.bm, **geo, **ops)
        else:
            with self._xla_precision(x):
                x4 = window_attention_xla(x4, self.ln1_w, self.ln1_b, self.wqkv, self.bqkv,
                                          self.wp, self.bp, self.rel_bias,
                                          getattr(self, "mask", None), **geo)
        if not self.fused_mlp(b):
            with self._xla_precision(x):
                return mlp_xla(x4.view(b, n, c), *mlp, eps=self.eps)
        fn = mlp_block_plain if plain else mlp_block
        return fn(x4.view(b, n, c), *mlp, eps=self.eps, **ops)


class PatchMerge(_Folded):
    """One patch merge; holds the kernel's K-major weight ``wg_t``
    (``ops.merge.merge_weight_t``) beside ``wg`` since the weights
    loaded."""

    def __init__(self, p, prefix, cfg: HTSATConfig, resolution: int, dtype):
        super().__init__(_merge_weights(p, prefix), dtype)
        self.resolution, self.eps = resolution, cfg.layer_norm_eps
        self.register_buffer("wg_t", merge_weight_t(self.wg))

    def forward(self, x, plain: bool = False):
        r = self.resolution
        fn = patch_merge_plain if plain else patch_merge
        return fn(x, self.wg, self.svec, self.tvec, h=r, w=r, eps=self.eps, wg_t=self.wg_t)


class HTSATEncoder(nn.Module):
    """Patch tokens (B, grid^2, C) -> pooled latent (B, num_features) f32:
    the Swin stages, final LN, token-semantic regroup, average pool
    (audio_metrics_tpu/models/htsat.py:947-988).

    ``AM_TPU_MERGED_ATTN``, ``AM_TPU_V4_STAGES`` and ``AM_TPU_ATTN_V1``
    are read here, when the encoder is built, and fix each block's path
    (:func:`attention_choice`); the JAX package reads the last two once at
    import, the first when it traces a forward."""

    def __init__(self, p: dict, cfg: HTSATConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList()
        self.merges = nn.ModuleList()
        v4_stages = frozenset(
            e.strip() for e in os.environ.get("AM_TPU_V4_STAGES", _DEFAULT_V4_STAGES).split(",")
            if e.strip()
        )
        attn_v1 = bool(os.environ.get("AM_TPU_ATTN_V1"))
        merged_attn = bool(os.environ.get("AM_TPU_MERGED_ATTN"))
        resolution = cfg.grid_size
        for i, depth in enumerate(cfg.depths):
            stage = nn.ModuleList()
            window = min(cfg.window_size, resolution)
            for j in range(depth):
                shift = 0 if j % 2 == 0 or resolution <= window else cfg.window_size // 2
                attention = attention_choice(i, shift, (resolution // window) ** 2, v4_stages,
                                             attn_v1, merged_attn, resolution)
                stage.append(SwinBlock(
                    p, f"audio_encoder.layers.{i}.blocks.{j}", cfg, resolution,
                    shift, cfg.num_heads[i], dtype, attention=attention,
                ))
            self.blocks.append(stage)
            if i < len(cfg.depths) - 1:
                self.merges.append(PatchMerge(
                    p, f"audio_encoder.layers.{i}.downsample", cfg, resolution, dtype
                ))
                resolution //= 2
        self.final_resolution = resolution
        for name in ("weight", "bias"):
            self.register_buffer(
                f"norm_{name}",
                torch.from_numpy(np.asarray(p[f"audio_encoder.norm.{name}"], np.float32)),
            )

    def forward(self, x, plain: bool = False):
        """``plain=True`` runs the kernels' plain versions on any device."""
        for i, stage in enumerate(self.blocks):
            for block in stage:
                x = block(x, plain)
            if i < len(self.merges):
                x = self.merges[i](x, plain)
        x = layer_norm(x, self.norm_weight, self.norm_bias, self.cfg.layer_norm_eps)

        # token-semantic regroup + average pool (ClapAudioEncoder tail)
        bsz, _, c = x.shape
        r = self.final_resolution
        x = x.transpose(1, 2).reshape(bsz, c, r, r)
        c_freq_bin = r // self.cfg.freq_ratio
        x = x.reshape(bsz, c, r // c_freq_bin, c_freq_bin, r)
        x = x.permute(0, 1, 3, 2, 4).reshape(bsz, c, -1)
        return x.float().mean(dim=-1)


# ----------------------------------------------------------------------
# plain frontend — audio_metrics_tpu/models/htsat.py:841-907
# ----------------------------------------------------------------------
def frontend_tokens(mel, patch_w, patch_b, ln_w, ln_b, cfg: HTSATConfig, compute_dtype):
    """BatchNorm'd (B, T, F) log-mel -> patch tokens (B, N, C).

    ``patch_w`` is the (ps*ps, C) input-major patch-embed weight.  The
    time-interpolated mel reshapes straight into patch rows in token order
    (the (B, 1, spec, spec) image never exists).  bf16 compute runs the
    interp product on bf16 operands, as the JAX package does; f32 keeps f32.
    """
    ratio, ps = cfg.freq_ratio, cfg.patch_size
    spec_w = cfg.spec_size * ratio
    spec_h = cfg.spec_size // ratio
    bsz, t, f = mel.shape
    chunk_w = spec_w // ratio
    if f != spec_h or spec_h % ps or chunk_w % ps or t > spec_w:
        raise ValueError(f"mel {tuple(mel.shape)} does not tile the patch grid of {cfg}")
    op_dt = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    if t < spec_w:
        w = device_table(_bicubic_matrix, (t, spec_w), mel.device, op_dt)
        x = torch.matmul(w.float(), mel.to(op_dt).float())  # f32 accumulation
    else:
        x = mel.float()
    gw = chunk_w // ps
    fb = spec_h // ps
    a = x.reshape(bsz, ratio, gw, ps, fb, ps)
    a = a.permute(0, 1, 4, 2, 5, 3).reshape(bsz, ratio * fb * gw, ps * ps)
    tok = torch.matmul(
        a.to(compute_dtype).float(), patch_w.to(compute_dtype).float()
    ) + patch_b.float()
    return layer_norm(tok.to(compute_dtype), ln_w, ln_b, cfg.layer_norm_eps)
