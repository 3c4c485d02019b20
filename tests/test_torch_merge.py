"""The patch merge (#2) on the wgmma core: its host side, on the CPU.

The kernel (kernels/csrc/patch_merge.cu) reads A, the 2x2 quadrant concat,
through a 4-D TMA map of the unmerged tokens, made from
``ops.merge.merge_a_map``'s dims, strides and box, at the box coordinates
its table gives for each K step (the kernel reads the same table and
computes no coordinate).  Here the map is
materialised with ``torch.as_strided`` (rows past the map's extent
zero-filled, as TMA fills them) and must reproduce the plain version's
quadrant concat bitwise at every merge of HTSAT-base and at ragged
batches.  The K-major weight equals the JAX package's own ``wg`` (captured
where its model hands it to its kernel) transposed, bitwise.  The
statistics helper equals the JAX kernel's statistics, read out of
``patch_merge_pallas`` in interpret mode through weights that expose them
(f32: rs * x and mu * rs; 1e-6 relative, a few f32 roundings apart).
Shapes the kernel does not take raise.  The kernel itself runs on a card
only (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import audio_metrics_tpu.models.htsat as jax_htsat
import audio_metrics_tpu.ops.merge as jax_merge
from audio_metrics_tpu.models.htsat import HTSAT_BASE
from audio_metrics_tpu_torch.models.htsat import PatchMerge, init_params
from audio_metrics_tpu_torch.ops.merge import (
    BK,
    BK_F32,
    BM,
    _quadrants,
    check_merge_gemm,
    merge_a_map,
    merge_k_order,
    merge_stats,
    merge_weight_t,
    patch_merge,
)

cfg = HTSAT_BASE
MERGES = [(0, 64, 128), (1, 32, 256), (2, 16, 512)]  # (stage, R, C) of HTSAT-base
TINY_MERGES = [(0, 64, 96), (1, 32, 192), (2, 16, 384)]  # of HTSAT-tiny


def _box(x_flat, amap, coords):
    """One TMA box of the map over ``x_flat``: the map's whole extent as an
    ``as_strided`` view (dims outermost first), the box cut from it, and
    zeros where the box runs past the extent."""
    dims, strides, box = amap["dims"], (1, *amap["strides"]), amap["box"]
    view = torch.as_strided(x_flat, dims[::-1], strides[::-1])
    cut = view[tuple(slice(c, c + b) for c, b in zip(coords[::-1], box[::-1]))]
    pad = []
    for i in range(4):  # F.pad takes the innermost dim first
        pad += [0, box[i] - cut.shape[3 - i]]
    return F.pad(cut, pad)


def _a_through_the_map(x, r, c, bk=BK):
    """A (tiles * 128, 4C) as the kernel's producer loads it: for every
    128-row tile t and K step of ``bk`` (64 bf16, or 32 for the f32
    kernel), the box at the table's origin of the step moved t boxes along
    the outermost dim (the kernel's ``MergeA``), laid out as TMA lays it in
    shared memory (innermost dim fastest): 128 rows of ``bk``."""
    b = x.shape[0]
    m = b * (r // 2) ** 2
    amap = merge_a_map(b, r, c, bk)
    flat = x.reshape(-1)
    tiles = -(-m // BM)
    a = torch.empty((tiles * BM, 4 * c), dtype=x.dtype)
    for t in range(tiles):
        for step in range(4 * c // bk):
            o = amap["origin"][step]
            box = _box(flat, amap, (*o[:3], o[3] + t * amap["box"][3]))
            a[t * BM:(t + 1) * BM, step * bk:(step + 1) * bk] = box.reshape(BM, bk)
    return a, m


@pytest.mark.parametrize("dtype,bk", [(torch.bfloat16, BK), (torch.float32, BK_F32)])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("stage,r,c", MERGES + TINY_MERGES[:1])
def test_tensor_map_reproduces_the_quadrant_concat(stage, r, c, b, dtype, bk):
    """B = 3 and B = 1: at R = 16, 192 and 64 rows, a tile and a half and
    half a tile; at R = 64 and 32 whole tiles of whole images.  bf16 in K
    steps of 64, f32 (the f32 kernel's map) in K steps of 32; at HTSAT-
    tiny's C = 96 the bf16 steps run over the quadrants in ``merge_k_order``
    (dy-major), the concat's own order everywhere else."""
    g = torch.Generator().manual_seed(stage + 10 * b)
    x = torch.randn((b, r * r, c), generator=g).to(dtype)
    a, m = _a_through_the_map(x, r, c, bk)
    order = list(merge_k_order(c, bk))
    assert (order != [0, 1, 2, 3]) == (dtype == torch.bfloat16 and c == 96)
    want = _quadrants(x, r, r).reshape(-1, 4, c)[:, order].reshape(-1, 4 * c)
    assert torch.equal(a[:m], want)
    assert not a[m:].any()


def test_tensor_map_catches_swapped_quadrants():
    """The check can fail: the dy/dx order swapped in the coordinates reads
    [x00, x01, x10, x11]."""
    r, c = 16, 128
    x = torch.randn((2, r * r, c), generator=torch.Generator().manual_seed(3))
    amap, flat = merge_a_map(2, r, c), x.reshape(-1)
    step = c // BK  # the first K step of quadrant 1, x10: (dy, dx) = (1, 0)
    c0, c1, dy, row = amap["origin"][step]
    assert (c0, dy) == (0, 1)
    right = _box(flat, amap, (c0, c1, dy, row)).reshape(BM, BK)
    swapped = _box(flat, amap, (c0 + c, c1, 0, row)).reshape(BM, BK)  # (dy, dx) = (0, 1)
    want = _quadrants(x, r, r).reshape(-1, 4 * c)[:BM, c:c + BK]
    assert torch.equal(right, want) and not torch.equal(swapped, want)


def _jax_merge_operands(params, stage, r):
    """``wg``, ``svec``, ``tvec`` exactly as the JAX model hands them to its
    merge kernel: ``_patch_merging`` with the kernel route forced and the
    kernel replaced by a recorder."""
    seen = {}

    def record(x, wg, svec, tvec, **kw):
        seen.update(wg=wg, svec=svec, tvec=tvec)
        b, n, c = x.shape
        return jnp.zeros((b, n // 4, wg.shape[-1]), x.dtype)

    saved = jax_htsat._use_pallas_merge, jax_merge.patch_merge_pallas
    jax_htsat._use_pallas_merge, jax_merge.patch_merge_pallas = (lambda stage=-1: True), record
    try:
        c = cfg.embed_dim * 2**stage
        jax_htsat._patch_merging(jnp.zeros((1, r * r, c), jnp.bfloat16),
                                 {k: jnp.asarray(v) for k, v in params.items()},
                                 f"audio_encoder.layers.{stage}.downsample", cfg, r)
    finally:
        jax_htsat._use_pallas_merge, jax_merge.patch_merge_pallas = saved
    return seen


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    p = init_params(cfg, seed=0)
    for k, v in p.items():
        if "downsample.norm" in k:
            p[k] = (float(k.endswith(".weight")) + rng.normal(scale=0.3, size=v.shape)).astype(
                np.float32)
    return p


@pytest.mark.parametrize("stage,r,c", MERGES)
def test_k_major_weight_is_the_jax_wg_transposed(params, stage, r, c):
    merge = PatchMerge(params, f"audio_encoder.layers.{stage}.downsample", cfg, r,
                       torch.bfloat16)
    jax_ops = _jax_merge_operands(params, stage, r)
    want = torch.from_numpy(np.array(jax_ops["wg"].view(jnp.uint16))).view(torch.bfloat16)
    assert want.shape == (4, c, 2 * c)
    assert merge.wg_t.shape == (2 * c, 4 * c) and merge.wg_t.is_contiguous()
    assert torch.equal(merge.wg_t.t(), want.reshape(4 * c, 2 * c))
    assert torch.equal(merge.wg_t, merge_weight_t(merge.wg))
    # g @ W and b @ W: f32 sums over 4C products in another order (numpy
    # here, XLA there), ~1e-6 of the largest
    for name in ("svec", "tvec"):
        want = np.asarray(jax_ops[name])
        np.testing.assert_allclose(getattr(merge, name).numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("offset", [0.0, 50.0])
def test_stats_match_the_jax_kernel(offset):
    """The JAX kernel in f32 (interpret) with column 0 of the folded weight
    picking x00[..., 0] (out = rs * x00_0) and column 1 zero with svec -1
    (out = mu * rs); a common-mode offset of 50 defeats a raw-moment
    variance (tests/test_pallas_model_kernels.py:917-966)."""
    rng = np.random.default_rng(7)
    b, h, c, oc = 2, 16, 128, 256
    x = (offset + rng.standard_normal((b, h * h, c))).astype(np.float32)
    x[..., 0] = np.where(np.abs(x[..., 0] - offset) < 0.1, offset + 1.0, x[..., 0])
    wg = np.zeros((4, c, oc), np.float32)
    wg[0, 0, 0] = 1.0
    svec, tvec = np.zeros(oc, np.float32), np.zeros(oc, np.float32)
    svec[1] = -1.0
    out = np.asarray(jax_merge.patch_merge_pallas(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(svec), jnp.asarray(tvec), h=h, w=h,
        eps=cfg.layer_norm_eps, interpret=True)).reshape(-1, oc)
    x00 = x.reshape(b, h, h, c)[:, 0::2, 0::2, 0].reshape(-1)
    rs_jax = out[:, 0] / x00
    mu_jax = out[:, 1] / rs_jax
    mu, rs = merge_stats(torch.from_numpy(x), h=h, w=h, eps=cfg.layer_norm_eps)
    np.testing.assert_allclose(rs.numpy(), rs_jax, rtol=1e-6)
    np.testing.assert_allclose(mu.numpy(), mu_jax, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r,c,ok", [
    (64, 128, True), (32, 256, True), (16, 512, True), (8, 1024, True), (256, 64, True),
    (64, 96, True),     # HTSAT-tiny's width: K steps of 64 dy-major, in one 2C pixel-pair row
    (64, 160, True),    # the same at another multiple of 32
    (64, 80, False),    # C % 32 != 0: a K step of 64 would straddle two pixel-pair rows
    (64, 98, False),
    (6, 128, False),    # R/2 = 3 does not divide a 128-row tile
    (512, 64, False),   # R/2 = 256: a tile would hold half an output grid row
    (1, 128, False),
    (8, 1088, False),   # 68 K steps: more than the kernel's table of 64 holds
])
def test_merge_shape_check(r, c, ok):
    if ok:
        check_merge_gemm(r, c)
    else:
        with pytest.raises(NotImplementedError):
            check_merge_gemm(r, c)


def test_plain_merge_does_not_read_the_kernel_weight(params):
    """On the CPU the wrapper runs the plain version, which reads ``wg``."""
    merge = PatchMerge(params, "audio_encoder.layers.2.downsample", cfg, 16, torch.float32)
    x = torch.randn((1, 256, 512), generator=torch.Generator().manual_seed(4))
    args = (x, merge.wg, merge.svec, merge.tvec)
    kw = dict(h=16, w=16, eps=merge.eps)
    assert torch.equal(patch_merge(*args, **kw), patch_merge(*args, **kw, wg_t=merge.wg_t))
    assert torch.equal(patch_merge(*args, **kw), merge(x))
