"""The two opt-in ops against the JAX package, on the CPU.

The JAX package exports two kernels that no model path calls: the v2
attention half (``swin_attention_block_pallas_v2``) and the W8A8 int8 MLP
(``mlp_block_pallas_int8``).  The port's counterparts
(``swin_attention_half_v2``, ``mlp_block_int8``) take their plain versions
on CPU tensors; these tests hold them against the Pallas kernels in
interpret mode on the same numpy weights and inputs, and hold the v2 half
against the v1 half and the port's weight prep against the JAX wrapper's.

Tolerances.  v2, f32: atol 5e-5, the JAX suite's v2-vs-v1 bound
(tests/test_pallas_model_kernels.py:453); readings <= 2.1e-6.  v2, bf16:
both sides round qkv, probabilities, context and output at the same points
and sum in f32 in other orders, so a value may differ by a bf16 rounding
flip and what it propagates: mean abs error relative to the mean size of
what the half adds (out - x) at most ``V2_BF16_REL`` per stage, max abs
error at most 0.0625 (tests/test_torch_split.py's v1 bounds).  Readings
1.1e-5 (stage 0), 7.1e-6 (stage 2) and 0.9e-4 to 2.4e-4 over four seeds at
stage 3: one window of C = 1024, where a flip in one token's q, k or v
reaches all 1024 outputs of the tokens it touches through the projection;
so stage 3's bound is 1e-3, 4x its largest reading.  int8: the branch
(out - x) within 2e-3 relative Frobenius of the JAX kernel's branch: the
codes are equal but where the JAX kernel's A&S 7.1.26 erf (within 1.5e-7 of
erf) or an f32 statistic summed in another order moves a quotient across a
half, and one flipped code moves its row's products by one quantisation
step; readings 6.6e-8 to 4.7e-5.  And the branch within 0.02 of the exact
float64 branch, the JAX test's own bound for W8A8 quantisation error
(tests/test_pallas_model_kernels.py:291-292); readings ~0.01.  The weights'
codes and scales the kernel holds from load (``mlp_int8_operands``) equal
the JAX wrapper's prep exactly, and a call given them equals one without
them bitwise.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy.special import erf

from audio_metrics_tpu.ops.attention import swin_attention_block_pallas_v2
from audio_metrics_tpu.ops.mlp import mlp_block_pallas_int8
from audio_metrics_tpu_torch.convert import params_from_numpy
from audio_metrics_tpu_torch.kernels import KERNELS, check_s8_gemm
from audio_metrics_tpu_torch.models.clap import ClapAudio, init_projection_params
from audio_metrics_tpu_torch.models.htsat import (
    HTSAT_BASE,
    HTSATConfig,
    _v1_kernel_weights,
    _v2_kernel_weights,
    init_params,
)
from audio_metrics_tpu_torch.ops.attention import (
    swin_attention_half_v1,
    swin_attention_half_v2,
)
from audio_metrics_tpu_torch.ops.mlp import (
    _mlp_shape,
    mlp_block_int8,
    mlp_int8_operands,
    quantize_columns,
)

from test_torch_split import _block_params, _geometry

cfg = HTSAT_BASE
F32_ATOL = 5e-5
V2_BF16_REL = {0: 1e-4, 2: 1e-4, 3: 1e-3}
BF16_MAX = 0.0625
INT8_VS_JAX = 2e-3
INT8_VS_EXACT = 0.02
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
V2_NAMES = ("ln1_w", "ln1_b", "wqkv", "bq3", "wp", "bp", "bm")
MATRICES = ("wqkv", "wp", "wq", "wk", "wv")


def _unchanged_launches(fn):
    before = {k: v.launches for k, v in KERNELS.items()}
    out = fn()
    assert {k: v.launches for k, v in KERNELS.items()} == before  # CPU: plain versions
    return out


def _tensors(w: dict, names, dtype):
    """Numpy weights -> tensors, matrices in ``dtype``, the rest f32."""
    return [torch.from_numpy(np.ascontiguousarray(w[k], np.float32)).to(
        dtype if k in MATRICES else torch.float32) for k in names]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage,shift", [(0, 4), (2, 4), (3, 0)])
def test_attention_v2_plain_matches_pallas(stage, shift, dtype):
    rng = np.random.default_rng(700 + 10 * stage + shift)
    p, pre, c, heads = _block_params(rng, stage)
    res, window, shift = _geometry(stage, shift)
    tdt, jdt = DTYPES[dtype]
    x = rng.normal(size=(1, res, res, c)).astype(np.float32)
    w = _v2_kernel_weights(p, pre, res, shift, heads, window)
    want = swin_attention_block_pallas_v2(
        jnp.asarray(x, jdt),
        *(jnp.asarray(w[k], jdt if k in MATRICES else jnp.float32) for k in V2_NAMES),
        heads=heads, window=window, shift=shift, eps=cfg.layer_norm_eps, interpret=True,
    )
    xt = torch.from_numpy(x).to(tdt)
    got = _unchanged_launches(lambda: swin_attention_half_v2(
        xt, *_tensors(w, V2_NAMES, tdt), heads=heads, window=window, shift=shift,
        eps=cfg.layer_norm_eps,
    ))
    assert got.dtype == tdt
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= F32_ATOL, err.max()
    else:
        rel = err.mean() / np.abs(want - xt.float().numpy()).mean()
        assert rel <= V2_BF16_REL[stage] and err.max() <= BF16_MAX, (rel, err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage,shift", [(0, 4), (1, 0)])
def test_attention_v2_plain_equals_v1_plain(stage, shift, dtype):
    """``_v2_kernel_weights`` lays v1's per-head weights side by side, so
    the two halves compute on equal operands: equal outputs."""
    rng = np.random.default_rng(800 + 10 * stage + shift)
    p, pre, c, heads = _block_params(rng, stage)
    res, window, shift = _geometry(stage, shift)
    tdt = DTYPES[dtype][0]
    xt = torch.from_numpy(rng.normal(size=(1, res, res, c)).astype(np.float32)).to(tdt)
    geo = dict(heads=heads, window=window, shift=shift, eps=cfg.layer_norm_eps)
    v1 = _tensors(_v1_kernel_weights(p, pre, res, shift, heads, window),
                  ("ln1_w", "ln1_b", "wq", "bq", "wk", "wv", "wp", "bp", "bm"), tdt)
    v2 = _tensors(_v2_kernel_weights(p, pre, res, shift, heads, window), V2_NAMES, tdt)
    got = _unchanged_launches(lambda: swin_attention_half_v2(xt, *v2, **geo))
    assert torch.equal(got, swin_attention_half_v1(xt, *v1, **geo))


def test_attention_v2_merged_form_not_ported():
    """Window = resolution (the merged one-window form) raises, naming the
    roadmap entry, as v1 does."""
    rng = np.random.default_rng(2)
    p, pre, c, heads = _block_params(rng, 2)
    w = _tensors(_v2_kernel_weights(p, pre, 16, 0, heads, 8), V2_NAMES, torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        swin_attention_half_v2(torch.zeros((1, 16, 16, c)), *w, heads=heads, window=16, shift=0)


def _int8_fixture(c, seed=11):
    """tests/test_pallas_model_kernels.py:274-282 at C = 128; at other
    widths the weight std scales by sqrt(128 / C), so the branch keeps its
    size."""
    rng = np.random.default_rng(seed)
    g = np.sqrt(128 / c)
    x = rng.normal(size=(4, 256, c)).astype(np.float32)
    lnw = rng.normal(1.0, 0.1, size=c).astype(np.float32)
    lnb = rng.normal(0.0, 0.1, size=c).astype(np.float32)
    w1 = rng.normal(scale=0.09 * g, size=(c, 4 * c)).astype(np.float32)
    b1 = rng.normal(size=4 * c).astype(np.float32)
    w2 = rng.normal(scale=0.04 * g, size=(4 * c, c)).astype(np.float32)
    b2 = rng.normal(size=c).astype(np.float32)
    return x, (lnw, lnb, w1, b1, w2, b2)


@pytest.mark.parametrize("c,dtype", [(128, "float32"), (256, "float32"), (128, "bfloat16")])
def test_mlp_int8_plain_matches_pallas(c, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w = _int8_fixture(c)
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
    rel = np.linalg.norm(branch - exact) / np.linalg.norm(exact)
    assert rel < INT8_VS_EXACT, rel


def test_quantize_columns_matches_jax_wrapper():
    """Codes and scales equal to the JAX wrapper's ``quant_cols``
    (audio_metrics_tpu/ops/mlp.py:216-220, the same jnp ops), on weights
    with exact halves, a zero column and mixed column sizes."""
    rng = np.random.default_rng(12)
    w = rng.normal(size=(128, 512)).astype(np.float32) * rng.uniform(0.01, 2.0, 512).astype(
        np.float32)
    w[:, 3] = 0.0
    w[:4, 5] = [1.0, -1.0, 0.5 / 127, -1.5 / 127]  # quotients at and near halves
    w[4:, 5] = 0.0
    wj = jnp.asarray(w)
    s_j = jnp.maximum(jnp.max(jnp.abs(wj), axis=0, keepdims=True),
                      jnp.float32(1e-12)) * jnp.float32(1.0 / 127.0)
    q_j = jnp.round(wj.astype(jnp.float32) / s_j).astype(jnp.int8)
    q, s = quantize_columns(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (1, 512)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    assert int(q.abs().max()) == 127 and not q[:, 3].any()


def _jax_quant_cols(w):
    """The JAX wrapper's ``quant_cols`` (audio_metrics_tpu/ops/mlp.py:216-220)."""
    wj = jnp.asarray(w)
    s = jnp.maximum(jnp.max(jnp.abs(wj), axis=0, keepdims=True),
                    jnp.float32(1e-12)) * jnp.float32(1.0 / 127.0)
    return np.asarray(jnp.round(wj.astype(jnp.float32) / s).astype(jnp.int8)), np.asarray(s)


@pytest.mark.parametrize("c", [128, 256])
def test_mlp_int8_operands_match_jax_prep(c):
    """The held operands: the JAX prep's codes transposed to (N, K),
    contiguous int8, and its (1, N) scales, exactly."""
    _, (_, _, w1, _, w2, _) = _int8_fixture(c)
    ops = mlp_int8_operands(torch.from_numpy(w1), torch.from_numpy(w2))
    for i, w, n in ((1, w1, 4 * c), (2, w2, c)):
        q_j, s_j = _jax_quant_cols(w)
        q, s = ops[f"q{i}t"], ops[f"s{i}"]
        assert q.dtype == torch.int8 and q.shape == (n, w.shape[0]) and q.is_contiguous()
        assert s.dtype == torch.float32 and s.shape == (1, n)
        np.testing.assert_array_equal(q.numpy(), q_j.T)
        np.testing.assert_array_equal(s.numpy(), s_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_int8_held_operands_equal_per_call(dtype):
    """On CPU tensors a call given ``operands=mlp_int8_operands(w1, w2)``
    equals the call without them bitwise, and lies within ``INT8_VS_JAX`` of
    the Pallas kernel in interpret mode."""
    tdt, jdt = DTYPES[dtype]
    x, w = _int8_fixture(128, seed=13)
    wt = [torch.from_numpy(a) for a in w]
    xt = torch.from_numpy(x).to(tdt)
    ops = mlp_int8_operands(wt[2], wt[4])
    got = _unchanged_launches(lambda: mlp_block_int8(xt, *wt, operands=ops))
    assert torch.equal(got, mlp_block_int8(xt, *wt))
    want = mlp_block_pallas_int8(jnp.asarray(x, jdt), *map(jnp.asarray, w), interpret=True)
    xf = xt.float().numpy().astype(np.float64)
    branch = got.float().numpy().astype(np.float64) - xf
    branch_jax = np.asarray(want, np.float64) - xf
    rel = np.linalg.norm(branch - branch_jax) / np.linalg.norm(branch_jax)
    assert rel < INT8_VS_JAX, rel


@pytest.mark.parametrize("name,wrong", [
    ("q1t", lambda o: o["q1t"].t().contiguous()),  # not transposed
    ("q1t", lambda o: o["q1t"][:, :64].contiguous()),  # another width's
    ("s1", lambda o: o["s1"].view(-1)),  # scales flattened
    ("q2t", lambda o: o["q2t"].float()),  # codes not int8
    ("s2", lambda o: o["s2"].double()),
], ids=["q1t-untransposed", "q1t-width", "s1-flat", "q2t-f32", "s2-f64"])
def test_mlp_int8_held_operands_checked(name, wrong):
    """Held operands of another shape or dtype raise ``ValueError`` naming
    the operand, on the CPU as on the card."""
    x, w = _int8_fixture(128)
    wt = [torch.from_numpy(a) for a in w]
    ops = mlp_int8_operands(wt[2], wt[4])
    with pytest.raises(ValueError, match=name):
        mlp_block_int8(torch.from_numpy(x), *wt, operands=dict(ops, **{name: wrong(ops)}))


@pytest.mark.parametrize("c,ok", [(64, True), (128, True), (1024, True), (96, True),
                                  (160, False), (192, True), (768, True)])
def test_int8_gemm_shape_check(c, ok):
    """The int8 MLP's shape check, its two products on the int8 core
    (``kernels.check_s8_gemm``): the core takes them at C = 64 (fc1's K of
    64 codes is half a K step, zero-filled by the tensor maps), at
    HTSAT-base's widths and at HTSAT-tiny's (C = 96: fc2's N = 96 on the
    96-column tile); C = 160 (fc2's N a multiple of neither 64 nor 96) is
    refused."""
    args = ("test", torch.empty((2, c)), (c, 4 * c), (4 * c, c), check_s8_gemm)
    if ok:
        assert _mlp_shape(*args) == (2, c)
    else:
        with pytest.raises(NotImplementedError, match="int8 wgmma"):
            _mlp_shape(*args)


def test_params_from_numpy_device():
    """The converter defaults to the card, like the port's other entry
    points; asked for the CPU it builds a CPU module."""
    assert inspect.signature(params_from_numpy).parameters["device"].default == "cuda"
    small = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    p = init_params(small, seed=0)
    p.update(init_projection_params(small, seed=0))
    model = params_from_numpy(p, small, device="cpu")
    assert isinstance(model, ClapAudio)
    assert {t.device.type for t in model.buffers()} == {"cpu"}
