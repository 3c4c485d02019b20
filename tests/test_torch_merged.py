"""The merged one-window form of the v1 and v2 attention halves against the
JAX package, on the CPU.

Under ``AM_TPU_MERGED_ATTN`` the JAX package runs the blocks with window <
resolution <= 16 (stage 2) as one attention over the whole 16x16 image
(window = resolution, 256 tokens) through its v1 kernel, on a dense
(1, heads, 256, 256) table that scatters each window's bias and shift mask
and puts -1e9 between two windows (``_merged_bias_mask``,
audio_metrics_tpu/models/htsat.py:143-172, :553-563).  Held here: the
port's table equal to the JAX one bitwise; the port's v1 half at window 16
(its plain version, which the kernels on the card are held to) against
the JAX v1 kernel in interpret mode on that table, as
tests/test_pallas_model_kernels.py:125-180 calls it; v2 equal to v1 at
window 16; the small HTSAT forward under the switch against the JAX
forward, which takes the per-window XLA path on the CPU (the JAX suite
shows the merged kernel equal to it); and each block's path under the
switch with the other two.

Tolerances, as tests/test_torch_split.py's for the v1 half: f32 atol 5e-5
(the JAX suite's kernel-vs-XLA bound in interpret mode); bf16 the mean abs
error at most 1e-4 of the mean size of what the half adds, max abs at most
0.0625 (the JAX kernel and the port round q, k, v, the probabilities and
the context at the same points; they differ by the odd bf16 rounding flip
of a sum taken in another order).  The forward: embeddings atol 1e-6, the
slice's bound (tests/test_torch_slice.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.models.htsat import _merged_bias_mask as jax_merged_bias_mask
from audio_metrics_tpu.ops.attention import swin_attention_block_pallas
from audio_metrics_tpu_torch.models.clap import LaionCLAP, init_projection_params
from audio_metrics_tpu_torch.models.htsat import (
    HTSAT_BASE,
    HTSAT_TINY,
    HTSATConfig,
    HTSATEncoder,
    SwinBlock,
    _bias_mask,
    _merged_bias_mask,
    _merged_kernel_weights,
    _v2_kernel_weights,
    init_params,
)
from audio_metrics_tpu_torch.ops.attention import (
    swin_attention_half_v1,
    swin_attention_half_v2,
)

SMALL = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
CONFIGS = {"base": HTSAT_BASE, "tiny": HTSAT_TINY, "small": SMALL}
SR = 48000
F32_ATOL = 5e-5
BF16_REL, BF16_MAX = 1e-4, 0.0625
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
V1_NAMES = ("ln1_w", "ln1_b", "wq", "bq", "wk", "wv", "wp", "bp", "bm")
V2_NAMES = ("ln1_w", "ln1_b", "wqkv", "bq3", "wp", "bp", "bm")
MATRICES = ("wq", "wk", "wv", "wp", "wqkv")
SWITCHES = ("AM_TPU_MERGED_ATTN", "AM_TPU_V4_STAGES", "AM_TPU_ATTN_V1")


def _stage2_params(rng, cfg):
    """Block 1 of stage 2 (R = 16, window 8): matrices at std
    1/sqrt(fan_in), biases and the bias table at std 0.5, LN affines
    around 1 and 0, so that the attention moves the output by O(1)."""
    c, heads = cfg.embed_dim * 4, cfg.num_heads[2]
    pre = "audio_encoder.layers.2.blocks.1"
    nrm = lambda *s, scale: rng.normal(scale=scale, size=s).astype(np.float32)
    p = {
        f"{pre}.layernorm_before.weight": 1.0 + nrm(c, scale=0.1),
        f"{pre}.layernorm_before.bias": nrm(c, scale=0.3),
        f"{pre}.attention.self.relative_position_bias_table": nrm(
            (2 * cfg.window_size - 1) ** 2, heads, scale=0.5
        ),
        f"{pre}.layernorm_after.weight": 1.0 + nrm(c, scale=0.1),
        f"{pre}.layernorm_after.bias": nrm(c, scale=0.3),
    }
    for name, (d_in, d_out) in {
        "attention.self.query": (c, c), "attention.self.key": (c, c),
        "attention.self.value": (c, c), "attention.output.dense": (c, c),
        "intermediate.dense": (c, 4 * c), "output.dense": (4 * c, c),
    }.items():
        p[f"{pre}.{name}.weight"] = nrm(d_out, d_in, scale=d_in**-0.5)
        p[f"{pre}.{name}.bias"] = nrm(d_out, scale=0.5)
    return p, pre, c, heads


def _tensors(w: dict, names, dtype):
    return [torch.from_numpy(np.ascontiguousarray(w[k], np.float32)).to(
        dtype if k in MATRICES else torch.float32) for k in names]


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("config", ["base", "tiny", "small"])
def test_merged_table_equals_jax(config, shift):
    """The dense table of stage 2 (R = 16, window 8, 16 heads at base and
    tiny, 4 at the small config), from the per-window table of an
    unshifted block (one table) and of a shifted one (a table a window),
    bitwise the JAX ``_merged_bias_mask``'s."""
    cfg = CONFIGS[config]
    heads = cfg.num_heads[2]
    pre = "audio_encoder.layers.2.blocks.0.attention"
    rng = np.random.default_rng(10 + shift)
    p = {f"{pre}.self.relative_position_bias_table": rng.normal(
        scale=0.5, size=((2 * cfg.window_size - 1) ** 2, heads)).astype(np.float32)}
    bm = _bias_mask(p, pre, 16, shift, heads, 8)
    assert bm.shape == ((4 if shift else 1), heads, 64, 64)
    got = _merged_bias_mask(bm, 16, 8)
    want = np.asarray(jax_merged_bias_mask(jnp.asarray(bm), 16, 8))
    assert got.shape == want.shape == (1, heads, 256, 256) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got == np.float32(-1e9)).sum() == heads * 256 * (256 - 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_half_v1_matches_pallas(dtype, shift=4):
    """The v1 half at window = resolution = 16 on the merged table of a
    shifted block (stage 2 of HTSAT-base, B = 2) against the JAX v1 kernel
    in interpret mode on the same table and weights; the unshifted block's
    table differs only in where its entries come from (the table test
    above)."""
    rng = np.random.default_rng(900 + shift)
    p, pre, c, heads = _stage2_params(rng, HTSAT_BASE)
    tdt, jdt = DTYPES[dtype]
    x = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    w = _merged_kernel_weights(p, pre, 16, shift, heads, 8)
    assert w["bm"].shape == (1, heads, 256, 256)
    want = np.asarray(swin_attention_block_pallas(
        jnp.asarray(x, jdt), *(jnp.asarray(w[k], jdt if k in MATRICES else jnp.float32)
                               for k in V1_NAMES),
        heads, 16, shift, eps=HTSAT_BASE.layer_norm_eps, interpret=True,
    ), np.float32)
    xt = torch.from_numpy(x).to(tdt)
    got = swin_attention_half_v1(xt, *_tensors(w, V1_NAMES, tdt), heads=heads, window=16,
                                 shift=shift, eps=HTSAT_BASE.layer_norm_eps)
    assert got.dtype == tdt
    got = got.float().numpy()
    err = np.abs(got - want)
    assert np.isfinite(got).all()
    if dtype == "float32":
        assert err.max() <= F32_ATOL, err.max()
    else:
        rel = err.mean() / np.abs(want - xt.float().numpy()).mean()
        assert rel <= BF16_REL and err.max() <= BF16_MAX, (rel, err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_half_v2_equals_v1(dtype):
    """v2's weights are v1's laid side by side, so at window 16 on the
    merged table the two halves compute on equal operands: equal
    outputs (HTSAT-tiny's stage 2, heads of 24, shifted)."""
    rng = np.random.default_rng(910)
    p, pre, c, heads = _stage2_params(rng, HTSAT_TINY)
    tdt = DTYPES[dtype][0]
    xt = torch.from_numpy(rng.normal(size=(1, 16, 16, c)).astype(np.float32)).to(tdt)
    geo = dict(heads=heads, window=16, shift=4, eps=HTSAT_TINY.layer_norm_eps)
    v1 = _tensors(_merged_kernel_weights(p, pre, 16, 4, heads, 8), V1_NAMES, tdt)
    w2 = _v2_kernel_weights(p, pre, 16, 4, heads, 8)
    w2["bm"] = _merged_bias_mask(w2["bm"], 16, 8)
    got = swin_attention_half_v2(xt, *_tensors(w2, V2_NAMES, tdt), **geo)
    assert torch.equal(got, swin_attention_half_v1(xt, *v1, **geo))


def _small_params():
    """The small config's seeded weights with nontrivial biases, bias
    tables and norms (tests/test_torch_slice.py's)."""
    rng = np.random.default_rng(1)
    p = init_params(SMALL, seed=0)
    p.update(init_projection_params(SMALL, seed=0))
    for k in p:
        if k.endswith(".bias") or "bias_table" in k:
            p[k] = rng.normal(scale=0.1, size=p[k].shape).astype(np.float32)
    p["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    return p


def test_small_forward_merged_matches_jax(monkeypatch):
    """The small HTSAT in f32 under ``AM_TPU_MERGED_ATTN=1``: its two
    stage-2 blocks (one shifted) take the merged path, the others the
    default; embeddings of two 5 s clips against the JAX forward."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("AM_TPU_MERGED_ATTN", "1")
    p = _small_params()
    rng = np.random.default_rng(3)
    t = np.arange(5 * SR) / SR
    audio = (0.1 * rng.standard_normal((2, 5 * SR))
             + 0.2 * np.sin(2 * np.pi * rng.uniform(100, 2000, size=(2, 1)) * t)).astype(np.float32)
    clap = LaionCLAP(params=p, cfg=SMALL, device="cpu")
    blocks = clap.model.encoder.blocks
    assert [b.attention for b in blocks[2]] == ["merged", "merged"]
    assert [(b.window, b.shift, tuple(b.bm.shape)) for b in blocks[2]] == [
        (16, 0, (1, 4, 256, 256)), (16, 4, (1, 4, 256, 256))]
    got = clap.embed(torch.from_numpy(audio)).numpy()
    want = np.asarray(JaxLaionCLAP(params=p, cfg=JaxHTSATConfig(
        embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))).forward(
        {"audio": jnp.asarray(audio)})["embedding"])
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("env,want", [
    ({"AM_TPU_MERGED_ATTN": "1"},
     ["v4"] * 4 + ["merged"] * 2 + ["v4"] * 2),
    ({"AM_TPU_MERGED_ATTN": "1", "AM_TPU_V4_STAGES": ""},
     ["v3"] * 4 + ["merged"] * 2 + ["v3"] * 2),
    ({"AM_TPU_MERGED_ATTN": "1", "AM_TPU_ATTN_V1": "1"},
     ["v1"] * 4 + ["merged"] * 2 + ["xla"] * 2),
])
def test_attention_choice_merged(monkeypatch, env, want):
    """``AM_TPU_MERGED_ATTN`` takes stage 2 (R = 16 > window 8) before the
    other rules and composes with both other switches; stages 0 and 1 (R =
    64, 32) and stage 3 (one window) are never merged."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    enc = HTSATEncoder(init_params(SMALL, seed=0), SMALL, torch.float32)
    assert [b.attention for stage in enc.blocks for b in stage] == want
    merged = [b for stage in enc.blocks for b in stage if b.attention == "merged"]
    assert all(b.resolution == b.window == 16 for b in merged)
    block = SwinBlock(init_params(SMALL, seed=0), "audio_encoder.layers.2.blocks.0", SMALL, 16,
                      0, 4, torch.float32, attention="merged")
    assert set(block.kernel_operands()) == {"w1_t", "w2_t", "wqkv_t", "wp_t", "bq3"}
