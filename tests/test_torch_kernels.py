"""Parity of the port's kernel modules with the JAX package, on the CPU.

For each of the three kernels on the CLAP FAD+KD path (Swin block v4,
patch merge, fused frontend) the port's plain PyTorch version is held
against the JAX function it replaces — the XLA path and the Pallas kernel
in interpret mode — on the same numpy inputs.  The kernels themselves are
held against these plain versions on a card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from audio_metrics_tpu.models.clap import clap_mel_tiled as jax_clap_mel_tiled
from audio_metrics_tpu.models.htsat import (
    HTSAT_BASE,
    _patch_merging as jax_patch_merging,
    _swin_block as jax_swin_block,
    frontend_tokens as jax_frontend_tokens,
)
from audio_metrics_tpu.ops.attention import swin_block_pallas_v4
from audio_metrics_tpu.ops.frontend_fused import clap_tokens_fused as jax_tokens_fused
from audio_metrics_tpu.ops.merge import patch_merge_pallas
from audio_metrics_tpu_torch.models.clap import (
    SAMPLE_RATE,
    ClapFrontend,
    _clap_fb,
    clap_mel_tiled,
)
from audio_metrics_tpu_torch.models.htsat import (
    PatchMerge,
    SwinBlock,
    _merge_weights,
    _v3_kernel_weights,
    frontend_tokens,
)
from audio_metrics_tpu_torch.ops.attention import swin_block_plain
from audio_metrics_tpu_torch.ops.frontend_fused import clap_tokens_fused

cfg = HTSAT_BASE


def _block_params(rng, stage):
    """Random weights of block 0 of ``stage`` with nontrivial biases, bias
    table and LN affines, so that every fold is exercised."""
    c = cfg.embed_dim * 2**stage
    heads = cfg.num_heads[stage]
    pre = f"audio_encoder.layers.{stage}.blocks.0"
    nrm = lambda *s, scale=0.02: rng.normal(scale=scale, size=s).astype(np.float32)
    p = {
        f"{pre}.layernorm_before.weight": 1.0 + nrm(c, scale=0.1),
        f"{pre}.layernorm_before.bias": nrm(c, scale=0.5),
        f"{pre}.attention.self.relative_position_bias_table": nrm(
            (2 * cfg.window_size - 1) ** 2, heads, scale=0.5
        ),
        f"{pre}.layernorm_after.weight": 1.0 + nrm(c, scale=0.1),
        f"{pre}.layernorm_after.bias": nrm(c, scale=0.5),
    }
    for name, (d_in, d_out) in {
        "attention.self.query": (c, c), "attention.self.key": (c, c),
        "attention.self.value": (c, c), "attention.output.dense": (c, c),
        "intermediate.dense": (c, 4 * c), "output.dense": (4 * c, c),
    }.items():
        p[f"{pre}.{name}.weight"] = nrm(d_out, d_in)
        p[f"{pre}.{name}.bias"] = nrm(d_out, scale=0.5)
    return p, pre, c, heads


def _stage_geometry(stage, shift):
    res = cfg.grid_size // 2**stage
    window = min(cfg.window_size, res)
    return res, window, (0 if res <= window else shift)


def _port_block(p, pre, stage, shift, dtype=torch.float32):
    res, _, _ = _stage_geometry(stage, shift)
    return SwinBlock(p, pre, cfg, res, shift, cfg.num_heads[stage], dtype)


STAGE_SHIFTS = [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)]


@pytest.mark.parametrize("stage,shift", STAGE_SHIFTS)
def test_swin_block_plain_matches_xla(stage, shift):
    """Plain block vs the JAX XLA block, f32, every stage shifted and
    unshifted.  atol 2e-4: the JAX suite's bound for the v4 kernel against
    the same XLA block (tests/test_pallas_model_kernels.py:641); the port's
    folds (LN through qkv, value bias through proj) reassociate f32 sums."""
    rng = np.random.default_rng(100 + 10 * stage + shift)
    p, pre, c, heads = _block_params(rng, stage)
    res, window, shift = _stage_geometry(stage, shift)
    x = rng.normal(size=(2, res * res, c)).astype(np.float32)
    want = np.asarray(jax_swin_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, pre, cfg, res, shift, heads
    ))
    got = _port_block(p, pre, stage, shift)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("stage,shift", [(0, 4), (3, 0)])
def test_swin_block_plain_matches_pallas_v4(stage, shift):
    """Plain block vs the TPU kernel itself (interpret mode, exact-erf
    GELU) on the same folded weights: atol 2e-4 as in
    tests/test_pallas_model_kernels.py:588."""
    rng = np.random.default_rng(200 + stage)
    p, pre, c, heads = _block_params(rng, stage)
    res, window, shift = _stage_geometry(stage, shift)
    w = _v3_kernel_weights(p, pre, res, shift, heads, window)
    x = rng.normal(size=(1, res, res, c)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in w.items()}
    want = np.asarray(swin_block_pallas_v4(
        jnp.asarray(x), None, None, j["wqkv"], j["bq3"], j["wp"], j["bp"], j["bm"],
        j["ln2_w"], j["ln2_b"], j["w1"], j["b1"], j["w2"], j["b2"], heads, window, shift,
        eps=cfg.layer_norm_eps, gelu="exact", interpret=True,
    ))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in w.items()}
    got = swin_block_plain(
        torch.from_numpy(x), t["wqkv"], t["bq3"], t["wp"], t["bp"], t["bm"], t["ln2_w"],
        t["ln2_b"], t["w1"], t["b1"], t["w2"], t["b2"],
        heads=heads, window=window, shift=shift, eps=cfg.layer_norm_eps,
    ).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def _merge_params(rng, c, oc):
    return {
        "m.norm.weight": rng.standard_normal(4 * c).astype(np.float32),
        "m.norm.bias": rng.standard_normal(4 * c).astype(np.float32),
        "m.reduction.weight": (0.05 * rng.standard_normal((oc, 4 * c))).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_merge_plain_matches_pallas_and_conv(dtype):
    """Plain merge vs patch_merge_pallas (interpret) and the XLA conv form,
    with the adversarial common-mode offset of
    tests/test_pallas_model_kernels.py:917-966 (a raw-moment variance
    would cancel).  f32: 1e-4 relative to the output scale (the three
    compute the same folded algebra in f32, summed in different orders);
    bf16: the JAX suite's 2e-2 of scale (output quantisation) and
    correlation > 0.99999."""
    rng = np.random.default_rng(5)
    b, h, c, oc = 2, 8, 128, 256
    x = (50.0 + rng.standard_normal((b, h * h, c))).astype(np.float32)
    p = _merge_params(rng, c, oc)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    w = _merge_weights(p, "m")
    want_conv = np.asarray(
        jax_patch_merging(jnp.asarray(x, jdt), {k: jnp.asarray(v) for k, v in p.items()},
                          "m", cfg, h), np.float32,
    )
    want_kernel = np.asarray(patch_merge_pallas(
        jnp.asarray(x, jdt), jnp.asarray(w["wg"], jdt), jnp.asarray(w["svec"]),
        jnp.asarray(w["tvec"]), h=h, w=h, eps=cfg.layer_norm_eps, interpret=True,
    ), np.float32)
    merge = PatchMerge(p, "m", cfg, h, tdt)
    got = merge(torch.from_numpy(x).to(tdt)).float().numpy()
    assert got.shape == (b, (h // 2) ** 2, oc)
    scale = np.abs(want_conv).max()
    for want in (want_conv, want_kernel):
        if dtype == "float32":
            assert np.abs(got - want).max() / scale < 1e-4
        else:
            assert np.abs(got - want).max() / scale < 2e-2
            assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


def _frontend_params(rng):
    """Nontrivial BatchNorm, patch bias and LayerNorm, as in
    tests/test_frontend_fused.py:76-103."""
    d, c, ps = cfg.num_mel_bins, cfg.embed_dim, cfg.patch_size
    return {
        "audio_encoder.batch_norm.running_mean": rng.normal(scale=2.0, size=d),
        "audio_encoder.batch_norm.running_var": rng.uniform(0.5, 3.0, size=d),
        "audio_encoder.batch_norm.weight": rng.normal(loc=1.0, scale=0.2, size=d),
        "audio_encoder.batch_norm.bias": rng.normal(size=d),
        "audio_encoder.patch_embed.proj.weight": rng.normal(scale=0.02, size=(c, 1, ps, ps)),
        "audio_encoder.patch_embed.proj.bias": rng.normal(scale=0.3, size=c),
        "audio_encoder.patch_embed.norm.weight": rng.normal(loc=1.0, scale=0.1, size=c),
        "audio_encoder.patch_embed.norm.bias": rng.normal(scale=0.3, size=c),
    }


def test_frontend_plain_matches_fused_kernel():
    """Plain frontend (bf16) vs clap_tokens_fused in interpret mode, with
    the bf16 bounds of tests/test_frontend_fused.py:139-143 (mean < 0.01,
    max < 0.12: bf16 rounding at the LN input and bf16 mel/interp
    accumulation order; post-LN values are O(1))."""
    rng = np.random.default_rng(11)
    params = {k: np.asarray(v, np.float32) for k, v in _frontend_params(rng).items()}
    audio = (0.2 * rng.normal(size=(1, 5 * SAMPLE_RATE))).astype(np.float32)
    fr = ClapFrontend(params, cfg)
    want = np.asarray(jax_tokens_fused(
        jnp.asarray(audio), sr=SAMPLE_RATE, cfg=cfg, fb_matrix=_clap_fb(),
        bn_scale=jnp.asarray(fr.bn_scale.numpy()),
        bn_offset=jnp.asarray(fr.bn_offset.numpy()), patch_w=jnp.asarray(fr.patch_w.numpy()),
        patch_b=jnp.asarray(fr.patch_b.numpy()), ln_w=jnp.asarray(fr.ln_w.numpy()),
        ln_b=jnp.asarray(fr.ln_b.numpy()), interpret=True,
    ), np.float32)
    got = clap_tokens_fused(torch.from_numpy(audio), fr, sr=SAMPLE_RATE, cfg=cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (1, cfg.grid_size**2, cfg.embed_dim)
    err = np.abs(got.float().numpy() - want)
    assert err.mean() < 0.01, err.mean()
    assert err.max() < 0.12, err.max()


def test_frontend_f32_matches_unfused_chain():
    """The port's f32 chain (clap_mel_tiled -> BatchNorm -> frontend_tokens)
    vs the JAX one on the same clip.  The mel is compared in dB at atol
    2e-3 (f32 DFT products summed in different orders; 10*log10 of the
    smallest bins amplifies that) and the tokens at atol 2e-3 (post-LN
    O(1) values)."""
    rng = np.random.default_rng(12)
    params = {k: np.asarray(v, np.float32) for k, v in _frontend_params(rng).items()}
    audio = (0.2 * rng.normal(size=(1, 5 * SAMPLE_RATE))).astype(np.float32)
    want_mel = np.asarray(jax_clap_mel_tiled(jnp.asarray(audio)))
    mel = clap_mel_tiled(torch.from_numpy(audio))
    np.testing.assert_allclose(mel.numpy(), want_mel, atol=2e-3)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    bn = lambda m: (m - jp["audio_encoder.batch_norm.running_mean"]) / jnp.sqrt(
        jp["audio_encoder.batch_norm.running_var"] + 1e-5
    ) * jp["audio_encoder.batch_norm.weight"] + jp["audio_encoder.batch_norm.bias"]
    want = np.asarray(jax_frontend_tokens(jp, bn(jnp.asarray(want_mel)), cfg, jnp.float32))
    fr = ClapFrontend(params, cfg)
    m = (mel - fr.running_mean) * torch.rsqrt(fr.running_var + 1e-5) * fr.weight + fr.bias
    got = frontend_tokens(m, fr.patch_w, fr.patch_b, fr.ln_w, fr.ln_b, cfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
