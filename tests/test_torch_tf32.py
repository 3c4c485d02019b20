"""The 3xTF32 products of the f32 Swin block, its halves and the patch
merge, on the CPU.

On the card the f32 whole block's four products, its halves' (the v3, v1
and v2 attention halves, the fused MLP) and the f32 merge's
product run on the tensor cores as three TF32 products
(kernels/csrc/gemm_tf32x3_sm90.cuh): each operand split into TF32 hi and lo
parts (``ops.tf32``), A_lo @ B_hi + A_hi @ B_lo + A_hi @ B_hi.  Here:

- the split against a numpy reference that rounds by arithmetic, not by
  bits;
- the weights the kernels read, split once at load;
- the f32 plain block, halves and merge with their products replaced by
  the emulated 3xTF32 product (``testing.tf32x3_matmul``) against the JAX
  package's f32 kernels (``swin_block_pallas_v4`` and ``mlp_block_pallas``
  with exact-erf GELU, ``swin_attention_block_pallas_v3`` (the LN1 affine
  folded), ``swin_attention_block_pallas`` (v1), ``_v2`` and
  ``patch_merge_pallas``, in interpret mode), within ``chip_smoke.py``'s
  f32 bounds at every stage each runs (the halves take the whole block's
  bounds, relative to what each adds); with one TF32 product (hi @ hi) the
  same comparison reads at least 10x above them, so the check can fail.
  The block and the attention halves also run with the window
  attention's batched products (q @ k^T, P @ V) as the kernel computes
  them on the card (kernels/csrc/window_attn.cuh: three TF32 products, a
  fresh sum per K step of 32, the steps added in f32), and with one TF32
  product there, which must again read 10x above the bounds;
- the shapes the f32 kernels take (the f32 merge's A through the shared
  4-D tensor map, at K steps of 32, is held in tests/test_torch_merge.py);
- the f32 mel chain's tables, uploaded once per device;
- the row counts at which the card checks run the f32 MLP reach every edge
  of its products' schedule (``testing.mlp_f32_schedule``, read against
  the kernel's constants).

Small HTSAT (``tests/test_torch_slice.py``'s: widths 32-256, two blocks a
stage) under weights at std 1/sqrt(fan_in), as ``chip_smoke.check_params``
draws them, so that both halves of a block move its output by O(1).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu.ops.attention import (
    swin_attention_block_pallas,
    swin_attention_block_pallas_v2,
    swin_attention_block_pallas_v3,
    swin_block_pallas_v4,
)
from audio_metrics_tpu.ops.merge import patch_merge_pallas
from audio_metrics_tpu.ops.mlp import mlp_block_pallas
from audio_metrics_tpu_torch.models.clap import clap_mel_tiled
from audio_metrics_tpu_torch.models.htsat import (
    HTSATConfig,
    PatchMerge,
    SwinBlock,
    _Folded,
    _v2_kernel_weights,
    init_params,
)
from audio_metrics_tpu_torch.ops import attention, merge, mel, mlp
from audio_metrics_tpu_torch.ops.attention import (
    check_block_gemms,
    swin_attention_half_v1_plain,
    swin_attention_half_v2_plain,
    swin_attention_half_v3_plain,
)
from audio_metrics_tpu_torch.ops.mlp import mlp_block_plain
from audio_metrics_tpu_torch.ops.merge import check_merge_f32
from audio_metrics_tpu_torch.ops.tf32 import tf32_round, tf32_split
from audio_metrics_tpu_torch.testing import (
    RS_BK,
    RS_BM,
    RS_SHARE_K,
    mlp_f32_edge_rows,
    mlp_f32_schedule,
    tf32x3_matmul,
)

cfg = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
# chip_smoke.py's f32 bounds: (mean abs error / mean |signal|, max abs error),
# the block's relative bound per stage; the signal is out - x for the block,
# the output for the merge
BLOCK_REL, BLOCK_MAX = (1e-6, 2e-6, 2.5e-6, 4e-6), 5e-5
MERGE_REL, MERGE_MAX = 3e-6, 3e-5
STAGE_SHIFTS = [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)]


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """Round to 10 mantissa bits, to nearest with ties away from zero, by
    float64 arithmetic: |x| / ulp rounded half up, times ulp."""
    x = x.astype(np.float64)
    _, e = np.frexp(np.abs(x))  # |x| = m * 2^e, m in [0.5, 1)
    ulp = np.ldexp(1.0, e - 11)
    return (np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp).astype(np.float32)


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_round_matches_the_arithmetic_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096), rng.uniform(-1e3, 1e3, 4096),
                        np.ldexp(rng.standard_normal(1024), rng.integers(-60, 60, 1024))])
    x = x.astype(np.float32)
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _rna_reference(x))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_tf32_round_ties_go_away_from_zero(sign):
    """1 + 2^-11 lies halfway between 1 and 1 + 2^-10: it rounds to the
    larger magnitude, for either sign; 1 + 2^-11 - 2^-23 rounds down."""
    x = sign * torch.tensor([1 + 2.0**-11, 2 * (1 + 2.0**-11), 1 + 2.0**-11 - 2.0**-23],
                            dtype=torch.float32)
    want = sign * torch.tensor([1 + 2.0**-10, 2 * (1 + 2.0**-10), 1.0], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    np.testing.assert_array_equal(tf32_round(x).numpy(), _rna_reference(x.numpy()))


def test_tf32_split_parts_hold_the_weight():
    """hi and lo have their 13 low bits zero, and hi + lo is within 2^-22
    of w relative."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((96, 64)).astype(np.float32))
    hi, lo = tf32_split(w)
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    rel = ((hi.double() + lo.double() - w.double()).abs() / w.double().abs()).max().item()
    assert rel <= 2.0**-22
    assert ((hi.double() - w.double()).abs() / w.double().abs()).max().item() <= 2.0**-11


def test_tf32x3_matmul_sums_each_k_step_apart():
    """``k_step``: each slice of 32 in depth is its own 3xTF32 product, the
    slices added in f32 in depth order; all of it within 2^-20 of the
    float64 product, relative to |a| @ |b|."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 16, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 64, 32)).astype(np.float32))
    got = tf32x3_matmul(a, b, k_step=32)
    want = tf32x3_matmul(a[..., :32], b[..., :32, :]) + tf32x3_matmul(a[..., 32:], b[..., 32:, :])
    assert torch.equal(got, want)
    assert torch.equal(tf32x3_matmul(a, b, k_step=64), tf32x3_matmul(a, b))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    assert ((got.double() - exact).abs() / scale).max().item() <= 2.0**-20


def _params():
    """init_params re-drawn as chip_smoke.check_params draws them."""
    rng = np.random.default_rng(0)
    params = init_params(cfg, seed=0)
    for k, v in params.items():
        if k.endswith(".bias") or "bias_table" in k:
            params[k] = rng.normal(scale=0.5, size=v.shape).astype(np.float32)
        elif v.ndim == 2:
            params[k] = rng.normal(scale=v.shape[1] ** -0.5, size=v.shape).astype(np.float32)
        elif k.endswith(".weight") and "norm" in k:
            params[k] = (1.0 + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
    return params


PARAMS = _params()


def _block(stage, shift, attention="v4"):
    res = cfg.grid_size // 2**stage
    prefix = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
    return SwinBlock(PARAMS, prefix, cfg, res, shift, cfg.num_heads[stage], torch.float32,
                     attention=attention), res


def test_f32_operands_are_the_split_weights():
    """In f32 the kernels read each matrix as (N, K), split at load."""
    block, _ = _block(1, 4)
    for name, w in (("wqkv_t", block.wqkv), ("wp_t", block.wp), ("w1_t", block.w1),
                    ("w2_t", block.w2)):
        held = getattr(block, name)
        assert held.shape == (2, w.shape[1], w.shape[0])
        assert torch.equal(held, tf32_split(w.t()))
    m = PatchMerge(PARAMS, "audio_encoder.layers.1.downsample", cfg, cfg.grid_size // 2,
                   torch.float32)
    assert torch.equal(m.wg_t, tf32_split(m.wg.reshape(-1, m.wg.shape[-1]).t()))
    bf = SwinBlock(PARAMS, "audio_encoder.layers.1.blocks.0", cfg, cfg.grid_size // 2, 0,
                   cfg.num_heads[1], torch.bfloat16)
    assert bf.wqkv_t.shape == bf.wqkv.t().shape  # bf16: transposed only


# (TF32 products of the weight products, of the window attention's batched
# products: 0 keeps those f32)
PRODUCTS = [pytest.param(3, 0, id="3-attn_f32"), pytest.param(1, 0, id="1-attn_f32"),
            pytest.param(3, 3, id="3-attn_3xtf32"), pytest.param(3, 1, id="3-attn_1xtf32")]


def _products(monkeypatch, terms, attn=0):
    """The plain versions' weight products (the operands' second factor a
    matrix: qkv, proj, fc1, fc2, the MLP half's and the merge's) as the
    kernels' 3xTF32 product, or one TF32 product; the window attention's
    batched products f32 (``attn`` 0) or as the f32 window attention
    kernel's ``attn`` TF32 products, a fresh sum per K step of 32."""
    f32 = attention._mm

    def mm(a, b):
        if b.dim() == 2:
            return tf32x3_matmul(a, b, terms)
        return tf32x3_matmul(a, b, attn, k_step=32) if attn else f32(a, b)

    monkeypatch.setattr(attention, "_mm", mm)
    monkeypatch.setattr(merge, "_mm", lambda a, b: tf32x3_matmul(a, b, terms))
    monkeypatch.setattr(mlp, "_mm", lambda a, b: tf32x3_matmul(a, b, terms))


def _held(got, want, x, stage, terms, attn=0):
    """The f32 bounds of ``stage`` on the error relative to what the kernel
    adds (out - x) with three TF32 products (or f32) everywhere; 10x above
    them with one TF32 product in the weight or the attention products."""
    err = np.abs(np.asarray(got).reshape(want.shape) - want)
    rel = err.mean() / np.abs(want - x.reshape(want.shape)).mean()
    if terms == 3 and attn != 1:
        assert rel <= BLOCK_REL[stage] and err.max() <= BLOCK_MAX, (rel, err.max())
    else:
        assert rel >= 10 * BLOCK_REL[stage], rel


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


j = lambda t: jnp.asarray(t.numpy())


@pytest.mark.parametrize("terms,attn", PRODUCTS)
@pytest.mark.parametrize("stage,shift", STAGE_SHIFTS)
def test_block_3xtf32_against_the_jax_f32_kernel(monkeypatch, stage, shift, terms, attn):
    block, res = _block(stage, shift)
    c = block.wqkv.shape[0]
    x = np.random.default_rng(10 * stage + shift).standard_normal((1, res, res, c))
    x = x.astype(np.float32)
    j = lambda t: jnp.asarray(t.numpy())
    want = np.asarray(swin_block_pallas_v4(
        jnp.asarray(x), None, None, j(block.wqkv), j(block.bq3), j(block.wp), j(block.bp),
        j(block.bm), j(block.ln2_w), j(block.ln2_b), j(block.w1), j(block.b1), j(block.w2),
        j(block.b2), block.heads, block.window, block.shift, eps=block.eps, gelu="exact",
        interpret=True,
    ))
    _products(monkeypatch, terms, attn)
    _held(block(torch.from_numpy(x).reshape(1, res * res, c), plain=True).numpy(), want, x,
          stage, terms, attn)


@pytest.mark.parametrize("terms,attn", PRODUCTS)
@pytest.mark.parametrize("stage,shift", STAGE_SHIFTS)
def test_attention_half_v3_3xtf32_against_the_jax_f32_kernel(monkeypatch, stage, shift, terms,
                                                             attn):
    """#8 in f32: the v3 half (the LN1 affine folded into wqkv and bq3)."""
    block, res = _block(stage, shift, "v3")
    x = _x(20 + 10 * stage + shift, (1, res, res, block.wqkv.shape[0]))
    geo = dict(heads=block.heads, window=block.window, shift=block.shift, eps=block.eps)
    w = (block.wqkv, block.bq3, block.wp, block.bp, block.bm)
    want = np.asarray(swin_attention_block_pallas_v3(
        jnp.asarray(x), None, None, *map(j, w), block.heads, block.window, block.shift,
        eps=block.eps, interpret=True,
    ))
    _products(monkeypatch, terms, attn)
    _held(swin_attention_half_v3_plain(torch.from_numpy(x), *w, **geo).numpy(), want, x,
          stage, terms, attn)


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_mlp_3xtf32_against_the_jax_f32_kernel(monkeypatch, stage, terms):
    """#9 in f32: the fused MLP (exact-erf GELU) on one image's rows."""
    block, res = _block(stage, 0, "v3")
    c = block.w1.shape[0]
    x = _x(30 + stage, (1, res * res, c))
    w = (block.ln2_w, block.ln2_b, block.w1, block.b1, block.w2, block.b2)
    want = np.asarray(mlp_block_pallas(jnp.asarray(x), *map(j, w), eps=block.eps, gelu="exact",
                                       interpret=True))
    _products(monkeypatch, terms)
    _held(mlp_block_plain(torch.from_numpy(x), *w, eps=block.eps).numpy(), want, x, stage, terms)


@pytest.mark.parametrize("terms,attn", PRODUCTS)
@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4)])
def test_attention_half_v1_3xtf32_against_the_jax_f32_kernel(monkeypatch, stage, shift, terms,
                                                             attn):
    """#10 in f32: the v1 half (per-head weights, the LN1 affine in the
    kernel) at the stages of >= 16 windows, where the path runs it."""
    block, res = _block(stage, shift, "v1")
    x = _x(40 + 10 * stage + shift, (1, res, res, block.bp.shape[0]))
    geo = dict(heads=block.heads, window=block.window, shift=block.shift, eps=block.eps)
    w = (block.ln1_w, block.ln1_b, block.wq, block.bq, block.wk, block.wv, block.wp, block.bp,
         block.bm)
    want = np.asarray(swin_attention_block_pallas(
        jnp.asarray(x), *map(j, w), block.heads, block.window, block.shift, eps=block.eps,
        interpret=True,
    ))
    _products(monkeypatch, terms, attn)
    _held(swin_attention_half_v1_plain(torch.from_numpy(x), *w, **geo).numpy(), want, x, stage,
          terms, attn)


@pytest.mark.parametrize("terms,attn", PRODUCTS)
@pytest.mark.parametrize("stage,shift", STAGE_SHIFTS)
def test_attention_half_v2_3xtf32_against_the_jax_f32_kernel(monkeypatch, stage, shift, terms,
                                                             attn):
    """#11 in f32: the v2 half ((C, 3C) qkv, (C, C) proj, the LN1 affine in
    the kernel)."""
    block, res = _block(stage, shift, "v3")
    prefix = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
    v2 = _Folded(_v2_kernel_weights(PARAMS, prefix, res, block.shift, block.heads,
                                    block.window), torch.float32)
    w = (v2.ln1_w, v2.ln1_b, v2.wqkv, v2.bq3, v2.wp, v2.bp, v2.bm)
    x = _x(50 + 10 * stage + shift, (1, res, res, v2.bp.shape[0]))
    geo = dict(heads=block.heads, window=block.window, shift=block.shift, eps=block.eps)
    want = np.asarray(swin_attention_block_pallas_v2(
        jnp.asarray(x), *map(j, w), block.heads, block.window, block.shift, eps=block.eps,
        interpret=True,
    ))
    _products(monkeypatch, terms, attn)
    _held(swin_attention_half_v2_plain(torch.from_numpy(x), *w, **geo).numpy(), want, x, stage,
          terms, attn)


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_merge_3xtf32_against_the_jax_f32_kernel(monkeypatch, stage, terms):
    res = cfg.grid_size // 2**stage
    c = cfg.embed_dim * 2**stage
    m = PatchMerge(PARAMS, f"audio_encoder.layers.{stage}.downsample", cfg, res, torch.float32)
    x = np.random.default_rng(stage).standard_normal((1, res * res, c)).astype(np.float32)
    want = np.asarray(patch_merge_pallas(
        jnp.asarray(x), jnp.asarray(m.wg.numpy()), jnp.asarray(m.svec.numpy()),
        jnp.asarray(m.tvec.numpy()), h=res, w=res, eps=m.eps, interpret=True,
    ))
    _products(monkeypatch, terms)
    got = m(torch.from_numpy(x), plain=True).numpy()
    err = np.abs(got - want)
    rel = err.mean() / np.abs(want).mean()
    if terms == 3:
        assert rel <= MERGE_REL and err.max() <= MERGE_MAX, (rel, err.max())
    else:
        assert rel >= 10 * MERGE_REL, rel


def test_f32_mel_chain_tables_are_built_once_per_device():
    """Two f32 tiled log-mels of the same clips are bitwise equal, and the
    second uploads no table: every lookup of ``device_table`` hits."""
    audio = torch.from_numpy(
        (0.1 * np.random.default_rng(2).standard_normal((2, 5 * 48000))).astype(np.float32))
    mel.device_table.cache_clear()
    first = clap_mel_tiled(audio)
    built = mel.device_table.cache_info()
    second = clap_mel_tiled(audio)
    after = mel.device_table.cache_info()
    assert torch.equal(first, second)
    assert built.misses == after.misses == 3  # DFT basis, filterbank, mid-frame index
    assert after.hits > built.hits


@pytest.mark.parametrize("r,c,ok", [
    (64, 128, True), (32, 256, True), (16, 512, True), (64, 96, True), (64, 160, True),
    (64, 48, False),    # a K step of 32 would straddle two quadrants
    (8, 1024, False),   # 128 K steps of 32: more than the kernel's table of 64 holds
    (6, 128, False),    # R/2 = 3 does not divide a 128-row tile
    (512, 64, False),   # R/2 = 256: a tile would hold half an output grid row
])
def test_f32_merge_shape_check(r, c, ok):
    if ok:
        check_merge_f32(r, c)
    else:
        with pytest.raises(NotImplementedError):
            check_merge_f32(r, c)


@pytest.mark.parametrize("c,ok", [(128, True), (256, True), (512, True), (1024, True),
                                  (96, True), (98, False), (160, False), (1088, False)])
def test_f32_block_shape_check(c, ok):
    """Every HTSAT-base and HTSAT-tiny width passes (tiny's 3C = 288 and C =
    96 on the core's 96-column tile); K = 98 is no whole K step of 32, N =
    160 on no column tile, and the LN1 pass takes C <= 1024."""
    if ok:
        check_block_gemms("swin_block f32", c, torch.float32)
    else:
        with pytest.raises(NotImplementedError):
            check_block_gemms("swin_block f32", c, torch.float32)


def test_mlp_f32_edge_rows_reach_every_edge_of_the_schedule():
    """On an H100's 132 SMs, over C = 96-1024, each of the f32 MLP's products
    meets at the edge row counts: one tile a block and an odd count above 1;
    a last row tile within consumer 0's 64 rows and one reaching into
    consumer 1's; depths on both sides of RS_SHARE_K; and fc1 an odd number
    of K steps.  The schedule model reads the kernel's tile and depth
    constants."""
    src = (Path(__file__).resolve().parents[1] / "audio_metrics_tpu_torch" / "kernels" / "csrc"
           / "gemm_tf32x3_sm90.cuh").read_text()
    assert f"constexpr int BM = {RS_BM}, BK = {RS_BK}," in src
    assert (f"RS_SHARE_K = EPI == EPI_GELU ? {RS_SHARE_K['fc1']} : {RS_SHARE_K['fc2']};"
            in src)
    seen = {"fc1": set(), "fc2": set()}
    for c in (96, 128, 256, 512, 1024):
        for m in mlp_f32_edge_rows(c, 132).values():
            for name, s in mlp_f32_schedule(c, m, 132).items():
                per = s["per_block"]
                seen[name] |= {("per block", "one" if per == 1 else "odd" if per % 2 else "even"),
                               ("last rows in consumer 0's half", s["last_rows"] <= 64),
                               ("shared", s["shared"]), ("odd K steps", s["ksteps"] % 2 == 1)}
    for name, edges in seen.items():
        assert {("per block", "one"), ("per block", "odd")} <= edges, name
        assert {("last rows in consumer 0's half", True),
                ("last rows in consumer 0's half", False)} <= edges, name
        assert {("shared", True), ("shared", False)} <= edges, name
    assert ("odd K steps", True) in seen["fc1"]
