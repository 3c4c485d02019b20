"""The split Swin block and the opt-in ops at HTSAT-tiny's widths (C = 96,
heads 24 wide) against the JAX package, on the CPU.

Per kernel, at C = 96, 4 heads of 24, window 8, R = 16, B = 1, unshifted
and shifted: the plain versions of the v3 attention half (#8), the fused
MLP (#9), the v1 attention half (#10), the v2 attention half (#11) and the
int8 MLP (#12), each against the Pallas kernel it replaces in interpret
mode on the same numpy weights and inputs, in f32 and bf16.  Then the slice,
``AudioMetrics(["fad", "kd", "prdc"])`` on the narrow tiny-shaped config of
tests/test_torch_tiny.py in f32 under ``AM_TPU_V4_STAGES=""`` and
``AM_TPU_ATTN_V1=1``, against the JAX package (which takes XLA on the CPU
whatever the variables say), as tests/test_torch_split.py's
``test_split_slice_matches_jax`` does for HTSAT-base.

Tolerances: those that tests/test_torch_split.py and
tests/test_torch_opt_in.py hold HTSAT-base's stages to (f32 atol 5e-5;
bf16 mean abs error relative to what the half adds and max abs 0.0625, per
kind; the int8 branch within 2e-3 relative Frobenius of the JAX kernel's
and 0.02 of the exact float64 branch; v2 bf16 stage 0's 1e-4).  The kernels
run on a card only (``chip_smoke.py`` phase 20).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.models.htsat import _v3_kernel_weights as jax_v3_kernel_weights
from audio_metrics_tpu.ops.attention import (
    swin_attention_block_pallas,
    swin_attention_block_pallas_v2,
    swin_attention_block_pallas_v3,
)
from audio_metrics_tpu.ops.mlp import mlp_block_pallas, mlp_block_pallas_int8
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.models.clap import LaionCLAP
from audio_metrics_tpu_torch.models.htsat import (
    HTSATConfig,
    _v1_kernel_weights,
    _v2_kernel_weights,
    _v3_kernel_weights,
)
from audio_metrics_tpu_torch.ops.attention import (
    swin_attention_half_v1,
    swin_attention_half_v2,
    swin_attention_half_v3,
)
from audio_metrics_tpu_torch.ops.mlp import mlp_block, mlp_block_int8

from test_torch_opt_in import INT8_VS_EXACT, INT8_VS_JAX, _int8_fixture
from test_torch_split import BF16_MAX, BF16_REL, DTYPES, F32_ATOL, _unchanged_launches
from test_torch_tiny import C, HEADS, NARROW, R, SR, _block_params, _clips, _params, cfg

V2_BF16_REL = 1e-4  # tests/test_torch_opt_in.py's stage-0 bound
MATRICES = ("wqkv", "wp", "wq", "wk", "wv", "w1", "w2")
WINDOW = 8


def _tensors(w: dict, names, dtype):
    """Numpy weights -> tensors, matrices in ``dtype``, the rest f32."""
    return [torch.from_numpy(np.ascontiguousarray(w[k], np.float32)).to(
        dtype if k in MATRICES else torch.float32) for k in names]


def _jax(w: dict, names, dtype):
    return [jnp.asarray(w[k], dtype if k in MATRICES else jnp.float32) for k in names]


def _close(got, want, x, dtype, rel_tol):
    """f32: atol F32_ATOL; bf16: mean abs error / mean |want - x| <=
    ``rel_tol`` and max abs error <= BF16_MAX."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= F32_ATOL, err.max()
    else:
        rel = err.mean() / np.abs(want - x.float().numpy()).mean()
        assert rel <= rel_tol and err.max() <= BF16_MAX, (rel, err.max())


def _case(seed, shift, dtype):
    rng = np.random.default_rng(seed + shift)
    p, pre = _block_params(rng)
    x = rng.normal(size=(1, R, R, C)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return p, pre, x, torch.from_numpy(x).to(tdt), tdt, jdt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 4])
def test_attention_v3_at_24_wide_heads_matches_pallas(shift, dtype):
    """#8: the v3 half's plain version against ``swin_attention_block_pallas_v3``."""
    p, pre, x, xt, tdt, jdt = _case(900, shift, dtype)
    jw = jax_v3_kernel_weights({k: jnp.asarray(v) for k, v in p.items()}, pre, R, shift, HEADS,
                               WINDOW, jdt)
    want = swin_attention_block_pallas_v3(jnp.asarray(x, jdt), None, None, *jw, HEADS, WINDOW,
                                          shift, eps=cfg.layer_norm_eps, interpret=True)
    w = _v3_kernel_weights(p, pre, R, shift, HEADS, WINDOW)
    got = _unchanged_launches(lambda: swin_attention_half_v3(
        xt, *_tensors(w, ("wqkv", "bq3", "wp", "bp", "bm"), tdt), heads=HEADS, window=WINDOW,
        shift=shift, eps=cfg.layer_norm_eps))
    assert got.dtype == tdt
    _close(got, want, xt, dtype, BF16_REL["v3"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_at_96_matches_pallas(dtype):
    """#9: the fused MLP's plain version against ``mlp_block_pallas``
    (exact-erf GELU) on 2 x 128 rows of C = 96."""
    p, pre, _, _, tdt, jdt = _case(910, 0, dtype)
    x = np.random.default_rng(911).normal(size=(2, 128, C)).astype(np.float32)
    w = _v3_kernel_weights(p, pre, R, 0, HEADS, WINDOW)
    names = ("ln2_w", "ln2_b", "w1", "b1", "w2", "b2")
    want = mlp_block_pallas(jnp.asarray(x, jdt), *_jax(w, names, jdt), eps=cfg.layer_norm_eps,
                            gelu="exact", interpret=True)
    xt = torch.from_numpy(x).to(tdt)
    got = _unchanged_launches(lambda: mlp_block(xt, *_tensors(w, names, tdt),
                                                eps=cfg.layer_norm_eps))
    assert got.dtype == tdt
    _close(got, want, xt, dtype, BF16_REL["mlp"])


V1_NAMES = ("ln1_w", "ln1_b", "wq", "bq", "wk", "wv", "wp", "bp", "bm")
V2_NAMES = ("ln1_w", "ln1_b", "wqkv", "bq3", "wp", "bp", "bm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 4])
def test_attention_v1_at_24_wide_heads_matches_pallas(shift, dtype):
    """#10: the v1 half's plain version (per-head weights) against
    ``swin_attention_block_pallas``."""
    p, pre, x, xt, tdt, jdt = _case(920, shift, dtype)
    w = _v1_kernel_weights(p, pre, R, shift, HEADS, WINDOW)
    want = swin_attention_block_pallas(jnp.asarray(x, jdt), *_jax(w, V1_NAMES, jdt), HEADS,
                                       WINDOW, shift, eps=cfg.layer_norm_eps, interpret=True)
    got = _unchanged_launches(lambda: swin_attention_half_v1(
        xt, *_tensors(w, V1_NAMES, tdt), heads=HEADS, window=WINDOW, shift=shift,
        eps=cfg.layer_norm_eps))
    _close(got, want, xt, dtype, BF16_REL["v1"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 4])
def test_attention_v2_at_24_wide_heads_matches_pallas(shift, dtype):
    """#11: the v2 half's plain version against
    ``swin_attention_block_pallas_v2``, and equal to the v1 half's on the
    same weights laid side by side."""
    p, pre, x, xt, tdt, jdt = _case(930, shift, dtype)
    w = _v2_kernel_weights(p, pre, R, shift, HEADS, WINDOW)
    want = swin_attention_block_pallas_v2(jnp.asarray(x, jdt), *_jax(w, V2_NAMES, jdt),
                                          heads=HEADS, window=WINDOW, shift=shift,
                                          eps=cfg.layer_norm_eps, interpret=True)
    geo = dict(heads=HEADS, window=WINDOW, shift=shift, eps=cfg.layer_norm_eps)
    got = _unchanged_launches(lambda: swin_attention_half_v2(xt, *_tensors(w, V2_NAMES, tdt),
                                                             **geo))
    assert got.dtype == tdt
    _close(got, want, xt, dtype, V2_BF16_REL)
    v1 = _tensors(_v1_kernel_weights(p, pre, R, shift, HEADS, WINDOW), V1_NAMES, tdt)
    assert torch.equal(got, swin_attention_half_v1(xt, *v1, **geo))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_int8_at_96_matches_pallas(dtype):
    """#12: the int8 MLP's plain version against ``mlp_block_pallas_int8``
    at C = 96 (4 x 256 rows): the branch within INT8_VS_JAX of the JAX
    kernel's and INT8_VS_EXACT of the exact float64 branch."""
    from scipy.special import erf

    tdt, jdt = DTYPES[dtype]
    x, w = _int8_fixture(C, seed=17)
    want = mlp_block_pallas_int8(jnp.asarray(x, jdt), *map(jnp.asarray, w), interpret=True)
    xt = torch.from_numpy(x).to(tdt)
    got = _unchanged_launches(lambda: mlp_block_int8(xt, *map(torch.from_numpy, w)))
    assert got.dtype == tdt and got.shape == xt.shape
    xf = xt.float().numpy().astype(np.float64)
    branch = got.float().numpy().astype(np.float64) - xf
    branch_jax = np.asarray(want, np.float64) - xf
    assert np.isfinite(branch).all()
    rel = np.linalg.norm(branch - branch_jax) / np.linalg.norm(branch_jax)
    assert rel < INT8_VS_JAX, rel
    lnw, lnb, w1, b1, w2, b2 = (a.astype(np.float64) for a in w)
    mu = xf.mean(-1, keepdims=True)
    xn = (xf - mu) / np.sqrt(((xf - mu) ** 2).mean(-1, keepdims=True) + 1e-5) * lnw + lnb
    h = xn @ w1 + b1
    exact = (h * 0.5 * (1 + erf(h / np.sqrt(2)))) @ w2 + b2
    assert np.linalg.norm(branch - exact) / np.linalg.norm(exact) < INT8_VS_EXACT


# ----------------------------------------------------------------------
# the slice on the split path
# ----------------------------------------------------------------------
METRICS = ["fad", "kd", "prdc"]


@pytest.fixture(scope="module")
def jax_narrow():
    """The JAX package's f32 evaluate of the narrow tiny config (XLA blocks
    on the CPU whatever the variables say), the clips of
    tests/test_torch_tiny.py."""
    ccfg = JaxHTSATConfig(**NARROW)
    p = _params(ccfg)
    jam = JaxAudioMetrics(metrics=METRICS, embedder=JaxLaionCLAP(params=p, cfg=ccfg),
                          win_dur=5.0, input_sr=SR, batch_size=4, device_indices=[0])
    jam.add_reference(jnp.asarray(_clips(0, 6)))
    return p, jam.evaluate(jnp.asarray(_clips(1, 6))), np.asarray(jam.stem_reference.embeddings)


@pytest.mark.parametrize("env,path", [({"AM_TPU_V4_STAGES": ""}, "v3"),
                                      ({"AM_TPU_ATTN_V1": "1"}, "v1")])
def test_tiny_split_slice_matches_jax(monkeypatch, jax_narrow, env, path):
    """Heads of 24 on the split blocks, f32: tests/test_torch_slice.py's
    bounds (embeddings atol 1e-6, FAD rel 1e-5, KD abs 1e-7), PRDC equal."""
    for k in ("AM_TPU_V4_STAGES", "AM_TPU_ATTN_V1"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p, want, want_emb = jax_narrow
    ccfg = HTSATConfig(**NARROW)
    clap = LaionCLAP(params=p, cfg=ccfg, device="cpu")
    assert {b.attention for st in clap.model.encoder.blocks[:2] for b in st} == {path}
    am = AudioMetrics(metrics=METRICS, embedder=clap, win_dur=5.0, input_sr=SR, batch_size=4,
                      device="cpu")
    am.add_reference(torch.from_numpy(_clips(0, 6)))
    got = _unchanged_launches(lambda: am.evaluate(_clips(1, 6)))
    np.testing.assert_allclose(am.stem_reference.embeddings.numpy(), want_emb, atol=1e-6)
    assert set(got) == set(want)
    assert got["fad"] == pytest.approx(want["fad"], rel=1e-5)
    for k in ("kernel_distance_mean", "kernel_distance_std"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-7), k
    for k in ("precision", "recall", "density", "coverage"):
        assert got[k] == want[k], k
