"""Swin attention: the whole-block kernel, the attention-half kernels and
the XLA attention half.

Counterparts in ``audio_metrics_tpu``:

- ``swin_block``: ``ops/attention.py::swin_block_pallas_v4`` (:1137-1193,
  kernel ``_swin_block_kernel_v4`` :951), kernels/csrc/swin_block.cu;
- ``swin_attention_half_v3``: ``swin_attention_block_pallas_v3`` (:902-948)
  with ``ln_w=None`` (kernel ``_attn_block_kernel_v3`` :793),
  kernels/csrc/swin_block.cu::am_swin_attn_v3 (the whole block's launches
  1-4);
- ``swin_attention_half_v1``: ``swin_attention_block_pallas`` (:426-470,
  kernel ``_attn_block_kernel`` :111), kernels/csrc/swin_block.cu::
  am_swin_attn_v1 (the whole block's launches 1-4 with the LN1 affine in
  the window pass and a plain qkv bias);
- ``swin_attention_half_v2``: ``swin_attention_block_pallas_v2`` (:473-511,
  kernel ``_attn_block_kernel_v2`` :226), kernels/csrc/swin_block.cu::
  am_swin_attn_v2 (v1's launches).  A public op that no model path calls,
  in the JAX package as here;
- the merged one-window form of v1 and v2: window = resolution = 16 (one
  256-token window an image, HTSAT's stage 2 under ``AM_TPU_MERGED_ATTN``,
  models/htsat.py:553-563 there) with a dense (1, heads, 256, 256) table
  (``models.htsat._merged_bias_mask``): the same wrappers and entries,
  whose attention launch is then kernels/csrc/merged_attn.cuh's over the
  key tiles the table's live-tile map names (:func:`merged_live_tiles`,
  held with the operands at load as ``live``), each counted apart
  (``KERNELS["swin_attn_v1_merged"]``, ``_v2_merged``, each with its
  ``_f32`` twin);
- ``window_attention_xla``: the XLA attention half of
  ``models/htsat.py::_swin_block`` (:584-607, ``_window_attention``
  :237-285), the JAX package's own non-kernel path: it runs on both
  devices and is the plain version of no kernel.

Weight layouts (``models.htsat``, folded once at load): v4 and v3 take
``models.htsat._v3_kernel_weights``: ``wqkv`` (C, 3C) with the LN1 affine
and 1/sqrt(d) folded in, ``bq3`` (3C,), ``wp`` (C, C), ``bp`` (C,)
absorbing the value bias, ``bm`` (nW or 1, heads, n, n) bias+mask; v4 adds
``w1`` (C, 4C), ``w2`` (4C, C) input-major, and its kernel reads each
matrix transposed and the column sums of ``wqkv`` (:func:`swin_block_operands`,
made at load; the v3 half reads the same).  v1 takes the per-head layout
of ``models/htsat.py:320-345``: ``wq``/``wk``/``wv`` (heads, C, d) with wq
pre-scaled, ``bq`` (heads, d) pre-scaled, ``wp`` (heads, d, C), ``bp`` and
``bm`` as v3, the LN1 affine unfolded.  v2 takes v1's weights side by side
(``models.htsat._v2_kernel_weights``): ``wqkv`` (C, 3C) = [Wq^T/sqrt(d),
Wk^T, Wv^T], ``bq3`` (3C,) with zeros on k and v, ``wp`` (C, C), ``bp`` and
``bm`` as v1, the LN1 affine unfolded.  Matrices in the activation dtype,
vectors and tables f32.

Dispatch of each kernel wrapper: a CPU tensor runs its ``*_plain``
version; a CUDA tensor launches the hand-written kernel for its dtype or
raises.  The whole block and each attention half have a kernel for each
activation dtype the JAX kernels take: bf16 launches ``am_swin_block``,
``am_swin_attn_v3``, ``_v1``, ``_v2``; f32 ``am_swin_block_f32``,
``am_swin_attn_v3_f32``, ``_v1_f32``, ``_v2_f32`` (kernels/csrc/
swin_block.cu, each with its own launch count, ``KERNELS["swin_block_f32"]``
etc.).  Every kernel reads its matrices K-major, made once at load and
passed as ``operands=``: the block and the v3 half
:func:`swin_block_operands`, the v1 half :func:`v1_operands`, the v2 half
:func:`half_operands`; in bf16 each matrix transposed, (N, K), for the
wgmma core, in f32 that matrix's (2, N, K) TF32 hi-over-lo stack for the
3xTF32 core.  Any other dtype raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import KERNELS, check_sm90_gemm, check_tf32x3_gemm, require_cuda
from .mlp import layer_norm, mlp_operands
from .tf32 import k_major, k_major_operand

__all__ = [
    "check_block_gemms",
    "half_operands",
    "merged_live_tiles",
    "swin_block",
    "swin_block_operands",
    "swin_block_plain",
    "swin_attention_half_v3",
    "swin_attention_half_v3_plain",
    "swin_attention_half_v1",
    "swin_attention_half_v1_plain",
    "swin_attention_half_v2",
    "swin_attention_half_v2_plain",
    "v1_operands",
    "window_attention_xla",
]

KERNEL = KERNELS["swin_block"]
KERNEL_F32 = KERNELS["swin_block_f32"]
KERNEL_V3 = KERNELS["swin_attn_v3"]
KERNEL_V3_F32 = KERNELS["swin_attn_v3_f32"]


def _mm(a, b):
    """Product of ``a`` and ``b`` as rounded (bf16 or f32), accumulated in
    f32 — what the kernel's tensor-core products compute."""
    return torch.matmul(a.float(), b.float())


def _partition(x, window: int, shift: int):
    """(B, H, W, C) rolled by -shift -> (B*nW*window^2, C) rows in window
    order."""
    b, h, w, c = x.shape
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, c)


def _unpartition(rows, b: int, h: int, w: int, window: int, shift: int):
    """Inverse of :func:`_partition`: window-order rows -> (B, H, W, C)
    rolled by +shift."""
    c = rows.shape[-1]
    x = rows.reshape(b, h // window, w // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    return torch.roll(x, shifts=(shift, shift), dims=(1, 2)) if shift else x


def _window_context(y, bm, heads: int):
    """Window-order qkv rows ``y`` (windows*n, 3C), q pre-scaled, in the
    activation dtype, and the (nbm, heads, n, n) f32 bias+mask table
    (window g reads table g % nbm) -> the context rows (windows*n, C):
    scores + bias/mask and softmax in f32, probabilities and context rounded
    to the activation dtype.  The plain version of the window attention
    launch at n = 64 (kernels/csrc/window_attn.cuh, ``am_window_attn`` /
    ``am_window_attn_f32``) and of the merged one at n = 256 (kernels/csrc/
    merged_attn.cuh, launch 3 of the v1 and v2 halves there)."""
    dt, n = y.dtype, bm.shape[-1]
    c = y.shape[1] // 3
    g, d = y.shape[0] // n, c // heads
    q, k, v = (
        y[:, i * c : (i + 1) * c].reshape(g, n, heads, d).transpose(1, 2) for i in range(3)
    )
    s = _mm(q, k.transpose(-1, -2))  # (g, heads, n, n) f32
    s = (s.reshape(-1, bm.shape[0], heads, n, n) + bm[None]).reshape(g, heads, n, n)
    p = torch.softmax(s, dim=-1).to(dt)
    return _mm(p, v).to(dt).transpose(1, 2).reshape(g * n, c)


def _attention_residual(x, y, wp, bp, bm, heads: int, window: int, shift: int):
    """x (B, H, W, C) and its window-order qkv rows ``y`` (rows, 3C), q
    pre-scaled, in the activation dtype -> x + un-roll(un-partition(ctx @ wp
    + bp)) in f32.  Scores + bias/mask and softmax in f32; probabilities and
    context rounded to the activation dtype (scores are not rounded, unlike
    the JAX XLA block, htsat.py:264-266)."""
    b, h, w, _ = x.shape
    ctx = _window_context(y, bm, heads)
    return _unpartition(_mm(ctx, wp) + bp, b, h, w, window, shift) + x.float()


def _qkv_ln_folded(x, wqkv, bq3, window: int, shift: int, eps: float):
    """Window-order qkv rows with LN1 folded through the product:
    rs * (x @ W) - rs * mu * (1 @ W) + bq3, rounded to the activation
    dtype (what the kernels' EPI_QKV epilogue computes)."""
    xw = _partition(x, window, shift)
    xwf = xw.float()
    mu = xwf.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt((xwf - mu).square().mean(dim=-1, keepdim=True) + eps)
    csum = wqkv.float().sum(dim=0)
    return (_mm(xw, wqkv) * rs - (rs * mu) * csum + bq3).to(x.dtype)


MERGED_TOKENS = 256  # the merged one-window form: window = resolution = 16
MERGED_PATCHES = 4  # the merged kernel's blocks a head: the 8x8 patches of the 16x16 image
MERGED_TILES = MERGED_TOKENS // 8  # its key tiles of 8 keys
MERGED_DEAD = -1e9  # table entries at or below it are masked (the JAX package's -1e9)
MERGED_MARGIN = 1e6  # a row whose live entries all lie this close above -1e9 keeps every key


def merged_live_tiles(bm: torch.Tensor) -> torch.Tensor:
    """The live-tile map of a merged (nbm, heads, 256, 256) f32 table, made
    from its values alone, for the merged kernel (kernels/csrc/
    merged_attn.cuh): per (table, head, block), the key tiles (keys 8t to
    8t + 7) that hold an entry above -1e9 in one of the block's 64 query
    rows, ascending.  The kernel's block p holds the rows of the 8x8 patch
    (p // 2, p % 2) of the rolled 16x16 image, tokens (8 (p // 2) + i) * 16
    + 8 (p % 2) + j.  (nbm, heads, 4, T) int32 on ``bm``'s device, each
    list padded with -1 to the longest, T.

    A dead tile's entries give probabilities exp(s + t - max) = 0 in the f32
    softmax, t <= -1e9 and max at least a live entry's score plus its table
    value, so the kernel drops their scores, exps, sum terms and P.V
    products and its result is the dense one.  That holds where each row's
    largest entry exceeds -1e9 by more than ~104 plus the spread of its
    scores.  So a block lists all 32 tiles (the dense computation) where
    one of its rows has no entry above -1e9 + 1e6 (``MERGED_MARGIN``): a
    row masked everywhere, or one whose live entries sit near -1e9.  Scores
    spread far less than 1e6 at any input the model sees; at its tables
    (bias ~1, shift mask -100) a patch is a window: 8 of 32 tiles live."""
    nbm, heads, n, n2 = bm.shape
    if (n, n2) != (MERGED_TOKENS, MERGED_TOKENS):
        raise ValueError(f"merged_live_tiles takes (nbm, heads, 256, 256) tables, got "
                         f"{tuple(bm.shape)}")
    rows = bm.reshape(nbm, heads, 2, 8, 2, 8, MERGED_TOKENS)  # (pr, i, pc, j) x keys
    rows = rows.permute(0, 1, 2, 4, 3, 5, 6).reshape(nbm, heads, MERGED_PATCHES, 64,
                                                      MERGED_TILES, 8)
    near = (rows.amax(dim=(-2, -1)) <= MERGED_DEAD + MERGED_MARGIN).any(-1)  # (nbm, heads, 4)
    live = (rows > MERGED_DEAD).any(-1).any(-2) | near[..., None]
    # a stable sort of the dead flags puts the live tiles first, in order
    dead_first, order = (~live).to(torch.uint8).sort(dim=-1, stable=True)
    width = int(live.sum(-1).max())
    return torch.where(dead_first == 0, order, -1)[..., :width].to(torch.int32).contiguous()


_TABLE_MAPS = WeakIdKeyDictionary()  # table -> (its version, merged_live_tiles(table))
_MAPS_CHECKED = WeakIdKeyDictionary()  # lists -> (the table map they equal, their version)


def _version(t):
    """``t``'s version counter (moved by each change in place); None for an
    inference tensor, which has none."""
    return None if t.is_inference() else t._version


def _table_map(bm):
    """:func:`merged_live_tiles` of ``bm``, made once for each version of
    its values."""
    version, kept = _version(bm), _TABLE_MAPS.get(bm)
    if version is not None and kept is not None and kept[0] == version:
        return kept[1]
    live = merged_live_tiles(bm)
    if version is not None:
        _TABLE_MAPS[bm] = (version, live)
    return live


def _merged_live(name: str, operands, bm, heads: int):
    """The live-tile lists that the merged kernel ``name`` reads with the
    table ``bm``: ``operands["live"]``, made at load, else made from ``bm``
    now (:func:`merged_live_tiles`).  ``ValueError`` where they do not fit
    the table: not (nbm, heads, 4, T) int32, or not the table's own map (held
    against it once for each version of both)."""
    live = None if operands is None else operands.get("live")
    if live is None:
        return _table_map(bm)
    if (live.dim() != 4 or tuple(live.shape[:3]) != (bm.shape[0], heads, MERGED_PATCHES)
            or not 1 <= live.shape[3] <= MERGED_TILES or live.dtype != torch.int32):
        raise ValueError(f"{name} reads the table's live-tile lists as ({bm.shape[0]}, {heads}, "
                         f"{MERGED_PATCHES}, 1..{MERGED_TILES}) int32 (merged_live_tiles(bm)), "
                         f"got {tuple(live.shape)} {live.dtype}")
    want, version = _table_map(bm), _version(live)
    checked = _MAPS_CHECKED.get(live)
    if version is None or checked is None or checked[0] is not want or checked[1] != version:
        if not torch.equal(live, want):
            raise ValueError(f"{name}: the live-tile lists passed are not those of the table "
                             "(merged_live_tiles(bm))")
        if version is not None:
            _MAPS_CHECKED[live] = (want, version)
    return live


def _check_windows(name, x, heads, window, bm, merged: bool = False):
    """The windows that the attention kernels take: 8x8, or, where
    ``merged`` (#10 and #11), also the merged one-window form, window =
    resolution with R^2 = 256 tokens (``AM_TPU_MERGED_ATTN`` at stage 2);
    and the (nbm, heads, n, n) table of n = window^2 tokens, nbm the
    windows of an image or 1.  Any other window raises
    ``NotImplementedError`` naming the roadmap, any other table
    ``ValueError``, before a launch."""
    b, r, r2, c = x.shape
    one = merged and window == r and r * r == MERGED_TOKENS
    if r != r2 or r % window or not (window * window == 64 or one):
        form = " or one 16x16 window (window = resolution)" if merged else ""
        raise NotImplementedError(
            f"{name} takes 8x8 windows{form}, got R={r} window={window} (ROADMAP.md, "
            "'What still raises')"
        )
    n = window * window
    if bm.dim() != 4 or bm.shape[1:] != (heads, n, n) or bm.shape[0] not in (
            1, (r // window) ** 2):
        raise ValueError(f"{name} reads a ({r // window}^2 or 1, {heads}, {n}, {n}) "
                         f"bias/mask table, got {tuple(bm.shape)}")


def _check_geometry(name, x, heads, window, bm, merged: bool = False):
    """:func:`_check_windows`, and heads that the attention kernels take
    (kernels/csrc/window_attn.cuh, merged_attn.cuh): 24 or 32 wide
    (HTSAT-tiny and HTSAT-base), for the whole block (#1) and the attention
    halves (#8, #10, #11) alike, which share their launches."""
    c = x.shape[-1]
    if not (heads > 0 and c % heads == 0 and c // heads in (24, 32)):
        raise NotImplementedError(
            f"{name} kernel takes 24- or 32-wide heads, got C={c} heads={heads}"
        )
    _check_windows(name, x, heads, window, bm, merged)


# ----------------------------------------------------------------------
# #1 whole block (v4)
# ----------------------------------------------------------------------
def swin_block_plain(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2, *,
                     heads: int, window: int, shift: int, eps: float = 1e-5):
    """x (B, R, R, C) -> same dtype.  Rounds where the kernel rounds: qkv,
    probabilities, context, the LN2 output and the GELU output go to the
    activation dtype; the residual and every statistic stay f32.  Unlike
    the JAX XLA block (htsat.py:264-266) scores are not rounded."""
    dt = x.dtype
    y = _qkv_ln_folded(x, wqkv, bq3, window, shift, eps)
    res = _attention_residual(x, y, wp, bp, bm, heads, window, shift)

    mu2 = res.mean(dim=-1, keepdim=True)
    var2 = (res - mu2).square().mean(dim=-1, keepdim=True)
    hn = ((res - mu2) * torch.rsqrt(var2 + eps) * ln2_w + ln2_b).to(dt)
    h1 = F.gelu(_mm(hn, w1) + b1, approximate="none").to(dt)
    return (res + _mm(h1, w2) + b2).to(dt)


def swin_block_operands(wqkv, wp, w1, w2) -> dict:
    """What the whole-block kernel reads besides the plain version's
    operands, made once when the weights load (``models.htsat.SwinBlock``):
    each matrix transposed to (N, K), the K-major layout in which the wgmma
    cores read both operands; in f32 that (N, K) matrix split into its TF32
    hi and lo parts, stacked (2, N, K) (``ops.tf32.tf32_split``), what the
    3xTF32 core (kernels/csrc/gemm_tf32x3_sm90.cuh) reads; and ``csum``, the
    f32 column sums of ``wqkv`` as held (1 @ W of the LN1 fold, what
    :func:`_qkv_ln_folded` sums)."""
    return dict(wqkv_t=k_major(wqkv), wp_t=k_major(wp), **mlp_operands(w1, w2),
                csum=wqkv.float().sum(dim=0))


BLOCK_PRODUCTS = ("wqkv_t", "wp_t", "w1_t", "w2_t")  # the whole block's products
HALF_PRODUCTS = BLOCK_PRODUCTS[:2]  # an attention half's: qkv and proj


def _product_shapes(c: int) -> dict:
    """(N, K) of each product of a block of width ``c``."""
    return dict(wqkv_t=(3 * c, c), wp_t=(c, c), w1_t=(4 * c, c), w2_t=(c, 4 * c))


def check_block_gemms(name: str, c: int, dtype, products=BLOCK_PRODUCTS) -> None:
    """Raise ``NotImplementedError`` unless the kernel ``name`` of ``dtype``
    takes a width of ``c``: its LN1 pass holds a row in one warp's registers
    (C <= 1024), and its ``products`` (the whole block's four, or an
    attention half's qkv and proj) run on the wgmma core of its dtype,
    ``kernels.check_tf32x3_gemm`` in f32, else ``kernels.check_sm90_gemm``
    (C a multiple of 64, or of 96 as HTSAT-tiny's C = 96, 192, 384, 768)."""
    if c > 1024:
        raise NotImplementedError(f"{name}: the LN1 pass takes C <= 1024, got C={c}")
    check = check_tf32x3_gemm if dtype == torch.float32 else check_sm90_gemm
    shapes = _product_shapes(c)
    for product in products:
        n, k = shapes[product]
        check(name, n, k, k)


_BLOCK_OPERANDS = "swin_block_operands(wqkv, wp, w1, w2)"


def _block_matrices(kernel: str, o, c: int, names, made_by: str, dtype) -> list:
    """The matrices ``names`` of ``o`` in the :func:`ops.tf32.k_major` form of
    ``dtype``, each checked by :func:`ops.tf32.k_major_operand`."""
    nk = _product_shapes(c)
    return [k_major_operand(kernel, o, name, *nk[name], made_by, dtype) for name in names]


def _block_operands(kernel: str, o, c: int, names, dtype) -> list:
    """The matrices ``names`` of a block's :func:`swin_block_operands`
    ``o``, then its column sums ``csum`` (3C,), each checked."""
    mats = _block_matrices(kernel, o, c, names, _BLOCK_OPERANDS, dtype)
    if o["csum"].shape != (3 * c,):
        raise ValueError(f"{kernel} reads csum as ({3 * c},), got {tuple(o['csum'].shape)}")
    return mats + [o["csum"]]


def _block_scratch(x, dtype):
    """The whole-block kernel's scratch (kernels/csrc/swin_block.cu):
    stats, qkv, ctx, res, hbuf, h1, out."""
    b, r, _, c = x.shape
    m, dev = b * r * r, x.device
    return (torch.empty((2, m), dtype=torch.float32, device=dev),
            torch.empty((m, 3 * c), dtype=dtype, device=dev),
            torch.empty((m, c), dtype=dtype, device=dev),
            torch.empty((m, c), dtype=torch.float32, device=dev),
            torch.empty((m, c), dtype=dtype, device=dev),
            torch.empty((m, 4 * c), dtype=dtype, device=dev),
            torch.empty_like(x))


def _swin_block_f32_cuda(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2, *,
                         heads, window, shift, eps, operands):
    b, r, _, c = x.shape
    check_block_gemms("swin_block f32", c, torch.float32)
    wqkv_t, wp_t, w1_t, w2_t, csum = _block_operands(
        "swin_block f32", operands, c, BLOCK_PRODUCTS, torch.float32)
    require_cuda(x, wqkv_t, wp_t, w1_t, w2_t, csum, bq3, bp, bm, ln2_w, ln2_b, b1, b2,
                 dtype=torch.float32)
    _check_geometry("swin_block_f32", x, heads, window, bm)
    scratch = _block_scratch(x, torch.float32)
    KERNEL_F32.launch(
        "am_swin_block_f32", x, wqkv_t, csum, bq3, wp_t, bp, bm, bm.shape[0],
        ln2_w, ln2_b, w1_t, b1, w2_t, b2, b, r, c, heads, window, shift, float(eps), *scratch,
    )
    KERNEL_F32.count()
    return scratch[-1]


def _swin_block_cuda(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2, *,
                     heads, window, shift, eps, operands):
    b, r, _, c = x.shape
    check_block_gemms("swin_block", c, x.dtype)
    wqkv_t, wp_t, w1_t, w2_t, csum = _block_operands(
        "swin_block", operands, c, BLOCK_PRODUCTS, x.dtype)
    require_cuda(x, wqkv_t, wp_t, w1_t, w2_t)
    require_cuda(csum, bq3, bp, bm, ln2_w, ln2_b, b1, b2, dtype=torch.float32)
    _check_geometry("swin_block", x, heads, window, bm)
    scratch = _block_scratch(x, x.dtype)
    KERNEL.launch(
        "am_swin_block", x, wqkv_t, csum, bq3, wp_t, bp, bm, bm.shape[0], ln2_w, ln2_b, w1_t, b1,
        w2_t, b2, b, r, c, heads, window, shift, float(eps), *scratch,
    )
    KERNEL.count()
    return scratch[-1]


def swin_block(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2, *,
               heads: int, window: int, shift: int, eps: float = 1e-5, operands=None):
    """Whole Swin block, (B, R, R, C) -> (B, R, R, C).  ``operands``: the
    kernel's :func:`swin_block_operands` of these weights, made at load;
    a CUDA tensor needs them, a CPU tensor ignores them.  On the card an
    f32 tensor launches the f32 kernel, any other the bf16 one (which
    raises on a dtype but bf16)."""
    if x.device.type == "cpu":
        return swin_block_plain(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2,
                                heads=heads, window=window, shift=shift, eps=eps)
    fn = _swin_block_f32_cuda if x.dtype == torch.float32 else _swin_block_cuda
    return fn(x, wqkv, bq3, wp, bp, bm, ln2_w, ln2_b, w1, b1, w2, b2, heads=heads,
              window=window, shift=shift, eps=eps, operands=operands)



# ----------------------------------------------------------------------
# #8 attention half, LN1 affine folded (v3)
# ----------------------------------------------------------------------
def swin_attention_half_v3_plain(x, wqkv, bq3, wp, bp, bm, *, heads: int, window: int,
                                 shift: int, eps: float = 1e-5):
    """x (B, R, R, C) -> x + WindowAttention(LN1(x)), same dtype: the
    whole block's attention half with its f32 residual rounded to the
    activation dtype."""
    y = _qkv_ln_folded(x, wqkv, bq3, window, shift, eps)
    return _attention_residual(x, y, wp, bp, bm, heads, window, shift).to(x.dtype)


def _half_scratch(x, stats: bool):
    """An attention half's scratch (kernels/csrc/swin_block.cu): the f32
    LN1 statistics (v3 only), then in the activation dtype the
    window-ordered rows, qkv, ctx, out."""
    b, r, _, c = x.shape
    m, dev = b * r * r, x.device
    rows = lambda *shape: torch.empty(shape, dtype=x.dtype, device=dev)
    stat = (torch.empty((2, m), dtype=torch.float32, device=dev),) if stats else ()
    return stat + (rows(m, c), rows(m, 3 * c), rows(m, c), torch.empty_like(x))


def _attention_half_v3_f32_cuda(x, bq3, bp, bm, *, heads, window, shift, eps, operands):
    b, r, _, c = x.shape
    check_block_gemms("swin_attn_v3_f32", c, torch.float32, HALF_PRODUCTS)
    wqkv_t, wp_t, csum = _block_operands("swin_attn_v3_f32", operands, c, HALF_PRODUCTS,
                                         torch.float32)
    require_cuda(x, wqkv_t, csum, bq3, wp_t, bp, bm, dtype=torch.float32)
    _check_geometry("swin_attn_v3_f32", x, heads, window, bm)
    scratch = _half_scratch(x, stats=True)
    KERNEL_V3_F32.launch("am_swin_attn_v3_f32", x, wqkv_t, csum, bq3, wp_t, bp, bm,
                         bm.shape[0], b, r, c, heads, window, shift, float(eps), *scratch)
    KERNEL_V3_F32.count()
    return scratch[-1]


def _attention_half_v3_cuda(x, bq3, bp, bm, *, heads, window, shift, eps, operands):
    b, r, _, c = x.shape
    check_block_gemms("swin_attn_v3", c, x.dtype, HALF_PRODUCTS)
    wqkv_t, wp_t, csum = _block_operands("swin_attn_v3", operands, c, HALF_PRODUCTS, x.dtype)
    require_cuda(x, wqkv_t, wp_t)
    require_cuda(csum, bq3, bp, bm, dtype=torch.float32)
    _check_geometry("swin_attn_v3", x, heads, window, bm)
    scratch = _half_scratch(x, stats=True)
    KERNEL_V3.launch("am_swin_attn_v3", x, wqkv_t, csum, bq3, wp_t, bp, bm,
                     bm.shape[0], b, r, c, heads, window, shift, float(eps), *scratch)
    KERNEL_V3.count()
    return scratch[-1]


def swin_attention_half_v3(x, wqkv, bq3, wp, bp, bm, *, heads: int, window: int, shift: int,
                           eps: float = 1e-5, operands=None):
    """Attention half of a Swin block, (B, R, R, C) -> (B, R, R, C).
    ``operands``: the kernel's :func:`swin_block_operands` of the block's
    weights (it reads ``wqkv_t``, ``wp_t``, ``csum``), made at load; a
    CUDA tensor needs them, a CPU tensor ignores them."""
    geo = dict(heads=heads, window=window, shift=shift, eps=eps)
    if x.device.type == "cpu":
        return swin_attention_half_v3_plain(x, wqkv, bq3, wp, bp, bm, **geo)
    fn = _attention_half_v3_f32_cuda if x.dtype == torch.float32 else _attention_half_v3_cuda
    return fn(x, bq3, bp, bm, **geo, operands=operands)


# ----------------------------------------------------------------------
# #10 attention half, per-head weights, LN1 affine in the kernel (v1)
# ----------------------------------------------------------------------
def _head_columns(wq, bq, wk, wv, wp):
    """Per-head operands -> one product's: (heads, C, d) -> (C, heads*d)
    side by side as (C, 3C) qkv, (heads, d) bq -> a (3C,) bias with zeros
    on k and v, (heads, d, C) wp -> (heads*d, C).  Pure reshapes."""
    h, c, d = wq.shape
    cols = lambda w: w.permute(1, 0, 2).reshape(c, h * d)
    wqkv = torch.cat([cols(wq), cols(wk), cols(wv)], dim=1)
    bqkv = torch.cat([bq.reshape(-1), bq.new_zeros(2 * h * d)])
    return wqkv, bqkv, wp.reshape(h * d, wp.shape[-1])


def half_operands(wqkv, wp) -> dict:
    """What the attention-half kernels with the LN1 affine in the kernel
    (v1, v2) read besides the plain version's operands, made once at load:
    the (C, 3C) qkv and (C, C) proj operands in their :func:`ops.tf32.
    k_major` form, transposed to (N, K) in bf16, and in f32 that matrix's
    (2, N, K) TF32 hi-over-lo stack."""
    return dict(wqkv_t=k_major(wqkv), wp_t=k_major(wp))


def v1_operands(wq, bq, wk, wv, wp) -> dict:
    """:func:`half_operands` of v1's per-head weights laid side by side
    (:func:`_head_columns`), with the (3C,) qkv bias ``bq3`` they give: the
    v1 kernel's operands, made once at load (``models.htsat.SwinBlock``)."""
    wqkv, bq3, wp2 = _head_columns(wq, bq, wk, wv, wp)
    return dict(half_operands(wqkv, wp2), bq3=bq3.contiguous())


def swin_attention_half_v1_plain(x, ln_w, ln_b, wq, bq, wk, wv, wp, bp, bm, *, heads: int,
                                 window: int, shift: int, eps: float = 1e-5):
    """x (B, R, R, C) -> x + WindowAttention(LN1(x)), same dtype: v2's plain
    version on the per-head operands laid side by side."""
    _check_windows("swin_attn_v1", x, heads, window, bm, merged=True)
    return swin_attention_half_v2_plain(x, ln_w, ln_b, *_head_columns(wq, bq, wk, wv, wp), bp,
                                        bm, heads=heads, window=window, shift=shift, eps=eps)


def _attention_ln_affine_cuda(version, x, ln_w, ln_b, bq3, bp, bm, *, heads, window, shift, eps,
                              operands, made_by):
    """Launch ``version``'s ("v1" or "v2") entry of x's dtype on the
    :func:`half_operands` form of the (C, 3C) / (C, C) operands, counted on
    its kernel, or on its merged form's at window = resolution = 16, which
    also reads the table's live-tile lists (:func:`_merged_live`)."""
    b, r, _, c = x.shape
    f32 = "_f32" if x.dtype == torch.float32 else ""
    merged = "_merged" if window * window == MERGED_TOKENS else ""
    kernel = KERNELS[f"swin_attn_{version}{merged}{f32}"]
    _check_geometry(kernel.name, x, heads, window, bm, merged=True)
    check_block_gemms(kernel.name, c, x.dtype, HALF_PRODUCTS)
    wqkv_t, wp_t = _block_matrices(kernel.name, operands, c, HALF_PRODUCTS, made_by,
                                   x.dtype)
    live = _merged_live(kernel.name, operands, bm, heads) if merged else None
    require_cuda(x, wqkv_t, wp_t, dtype=x.dtype)
    require_cuda(ln_w, ln_b, bq3, bp, bm, dtype=torch.float32)
    if live is not None:
        require_cuda(live, dtype=torch.int32)
    if bq3.shape != (3 * c,):
        raise ValueError(f"{kernel.name} reads bq3 as ({3 * c},), got {tuple(bq3.shape)}")
    scratch = _half_scratch(x, stats=False)
    kernel.launch(f"am_swin_attn_{version}{f32}", x, ln_w, ln_b, wqkv_t, bq3, wp_t, bp, bm,
                  bm.shape[0], live, 0 if live is None else live.shape[-1], b, r, c, heads,
                  window, shift, float(eps), *scratch)
    kernel.count()
    return scratch[-1]


def swin_attention_half_v1(x, ln_w, ln_b, wq, bq, wk, wv, wp, bp, bm, *, heads: int,
                           window: int, shift: int, eps: float = 1e-5, operands=None):
    """Attention half of a Swin block with per-head weights, (B, R, R, C)
    -> (B, R, R, C); 8x8 windows, or the merged one-window form (window =
    resolution = 16, ``bm`` (1, heads, 256, 256)).  ``operands``: the
    kernel's :func:`v1_operands` of these weights, made at load; a CUDA
    tensor needs them, a CPU tensor ignores them.  The merged form also
    reads ``operands["live"]``, the table's :func:`merged_live_tiles`
    (made from ``bm`` at the call where it is missing)."""
    geo = dict(heads=heads, window=window, shift=shift, eps=eps)
    if x.device.type == "cpu":
        return swin_attention_half_v1_plain(x, ln_w, ln_b, wq, bq, wk, wv, wp, bp, bm, **geo)
    bq3 = None if operands is None else operands["bq3"]
    return _attention_ln_affine_cuda("v1", x, ln_w, ln_b, bq3, bp, bm, **geo, operands=operands,
                                     made_by="v1_operands(wq, bq, wk, wv, wp)")


# ----------------------------------------------------------------------
# #11 attention half, (C, 3C) qkv and (C, C) projection, LN1 affine in the
# kernel (v2)
# ----------------------------------------------------------------------
def swin_attention_half_v2_plain(x, ln_w, ln_b, wqkv, bq3, wp, bp, bm, *, heads: int,
                                 window: int, shift: int, eps: float = 1e-5):
    """x (B, R, R, C) -> x + WindowAttention(LN1(x)), same dtype: LN1 with
    its affine in f32 rounded to the activation dtype, q/k/v (q with its
    bias) rounded, then as v3.  The JAX kernel's per-head contractions over
    lane-masked k and v add only zeros beyond the head's d lanes, so they are
    the d-wide per-head products taken here."""
    _check_windows("swin_attn_v2", x, heads, window, bm, merged=True)
    xw = _partition(layer_norm(x, ln_w, ln_b, eps), window, shift)
    y = (_mm(xw, wqkv) + bq3).to(x.dtype)
    return _attention_residual(x, y, wp, bp, bm, heads, window, shift).to(x.dtype)


def swin_attention_half_v2(x, ln_w, ln_b, wqkv, bq3, wp, bp, bm, *, heads: int, window: int,
                           shift: int, eps: float = 1e-5, operands=None):
    """Attention half of a Swin block under v2's contract, (B, R, R, C) ->
    (B, R, R, C); 8x8 windows, or the merged one-window form as v1.
    ``operands``: the kernel's :func:`half_operands` of ``wqkv`` and ``wp``,
    made once by the caller (and, for the merged form, ``live``: the
    table's :func:`merged_live_tiles`, else made from ``bm`` at the call);
    a CUDA tensor needs them, a CPU tensor ignores them."""
    geo = dict(heads=heads, window=window, shift=shift, eps=eps)
    if x.device.type == "cpu":
        return swin_attention_half_v2_plain(x, ln_w, ln_b, wqkv, bq3, wp, bp, bm, **geo)
    return _attention_ln_affine_cuda("v2", x, ln_w, ln_b, bq3, bp, bm, **geo, operands=operands,
                                     made_by="half_operands(wqkv, wp)")


# ----------------------------------------------------------------------
# the XLA attention half (no kernel)
# ----------------------------------------------------------------------
def window_attention_xla(x, ln_w, ln_b, wqkv, bqkv, wp, bp, rel_bias, mask, *, heads: int,
                         window: int, shift: int, eps: float = 1e-5):
    """x (B, R, R, C) -> x + WindowAttention(LN1(x)) as the JAX package's
    XLA path computes it.  Raw weights: ``wqkv`` (C, 3C) = [Wq^T, Wk^T,
    Wv^T] and ``wp`` (C, C) = Wo^T in the activation dtype, ``bqkv`` (3C,)
    and ``bp`` the raw biases, ``rel_bias`` (heads, n, n) the gathered
    relative-position table, ``mask`` (nW, n, n) or None, all f32.  Every
    step rounds to the activation dtype as there: qkv, the scores (then
    divided by sqrt(d) in that dtype), the bias and mask adds, the
    probabilities (softmax in f32), the context, the projection; the
    residual sum is taken in the activation dtype."""
    b, h, w, c = x.shape
    dt, n = x.dtype, window * window
    d = c // heads
    xw = _partition(layer_norm(x, ln_w, ln_b, eps), window, shift)
    g = xw.shape[0] // n
    y = (_mm(xw, wqkv) + bqkv).to(dt)
    q, k, v = (
        y[:, i * c : (i + 1) * c].reshape(g, n, heads, d).transpose(1, 2) for i in range(3)
    )
    s = _mm(q, k.transpose(-1, -2)).to(dt)
    s = s / torch.tensor(np.sqrt(d), dtype=dt)
    s = s + rel_bias.to(dt)[None]
    if mask is not None:
        s = (s.reshape(b, -1, heads, n, n) + mask.to(dt)[None, :, None]).reshape(g, heads, n, n)
    p = torch.softmax(s.float(), dim=-1).to(dt)
    ctx = _mm(p, v).to(dt).transpose(1, 2).reshape(g * n, c)
    o = (_mm(ctx, wp) + bp).to(dt)
    return x + _unpartition(o, b, h, w, window, shift)
