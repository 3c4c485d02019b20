"""The split Swin block against the JAX package, on the CPU.

The plain versions of the three kernels of the split block are held against
the Pallas kernels they replace, in interpret mode, on the same numpy
weights and inputs: the v3 attention half (``swin_attention_block_pallas_v3``
with the LN affine pre-folded, head-grouped and not), the v1 attention half
(``swin_attention_block_pallas`` with the per-head weights of
models/htsat.py:320-345) and the fused MLP (``mlp_block_pallas`` with
exact-erf GELU).  The XLA halves (``window_attention_xla``, ``mlp_xla``)
are held against the JAX ``_swin_block``, which takes XLA on the CPU.
Then which path each block takes under ``AM_TPU_V4_STAGES`` and
``AM_TPU_ATTN_V1``, and the slice end to end.

Weights: every matrix at std 1/sqrt(fan_in), biases, bias tables and LN
affines away from 0/1, so that the attention and MLP branches move the
output by O(1) and a wrong map or fold cannot hide under the residual.

Tolerances.  f32: atol 5e-5, the JAX suite's kernel-vs-XLA bound in
interpret mode (tests/test_pallas_model_kernels.py:122, :226); both sides
compute the same algebra in f32 in other orders (the v3 kernel's
reduce-free softmax, the per-head sums of v1).  bf16: both sides round at
nearly the same points but not all (the JAX v3 kernel rounds the
unnormalised exponentials, the port the probabilities; XLA rounds scores),
so a value may differ by a bf16 rounding flip and what it propagates:
mean abs error relative to the mean size of what the half adds (out - x)
at most ``BF16_REL`` for the test's kind, and max abs error at most 0.0625
(two bf16 ulps of a value in [4, 8); the JAX suite's bf16 bound for the v3
kernel is 0.25, tests/test_pallas_model_kernels.py:850).  Readings: f32
max abs <= 3.8e-6; bf16 max abs 0.03125, relative 1.3e-3 (v3: the rounded
exponentials) and 1.5e-3 (XLA: rounded scores), 2.1e-5 (v1), 6.8e-6 (MLP).
Each bf16 bound is 3-7x its reading.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
from audio_metrics_tpu.models.htsat import HTSAT_BASE
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.models.htsat import _swin_block as jax_swin_block
from audio_metrics_tpu.models.htsat import _v3_kernel_weights as jax_v3_kernel_weights
from audio_metrics_tpu.ops.attention import (
    swin_attention_block_pallas,
    swin_attention_block_pallas_v3,
)
from audio_metrics_tpu.ops.mlp import mlp_block_pallas
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.kernels import KERNELS
from audio_metrics_tpu_torch.models import htsat as htsat_mod
from audio_metrics_tpu_torch.models.clap import LaionCLAP, init_projection_params
from audio_metrics_tpu_torch.models.htsat import (
    HTSATConfig,
    HTSATEncoder,
    SwinBlock,
    _v1_kernel_weights,
    _v3_kernel_weights,
    init_params,
)
from audio_metrics_tpu_torch.ops import attention as attention_mod
from audio_metrics_tpu_torch.ops import mel as mel_mod
from audio_metrics_tpu_torch.ops import mlp as mlp_mod
from audio_metrics_tpu_torch.ops.attention import (
    swin_attention_half_v1,
    swin_attention_half_v3,
)
from audio_metrics_tpu_torch.ops.mlp import mlp_block

cfg = HTSAT_BASE
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
SR = 48000
F32_ATOL = 5e-5
BF16_REL = {"v3": 5e-3, "xla": 5e-3, "v1": 1e-4, "mlp": 5e-5}
BF16_MAX = 0.0625
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _block_params(rng, stage):
    """Block 0 of ``stage``: matrices at std 1/sqrt(fan_in), biases and the
    bias table at std 0.5, LN affines around 1 and 0."""
    c = cfg.embed_dim * 2**stage
    heads = cfg.num_heads[stage]
    pre = f"audio_encoder.layers.{stage}.blocks.0"
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


def _geometry(stage, shift):
    res = cfg.grid_size // 2**stage
    window = min(cfg.window_size, res)
    return res, window, (0 if res <= window else shift)


def _torch(w: dict, dtype):
    """Folded numpy weights -> tensors, matrices in ``dtype``."""
    out = {}
    for k, v in w.items():
        t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
        out[k] = t.to(dtype) if k in ("wqkv", "wp", "w1", "w2", "wq", "wk", "wv") else t
    return out


def _close(got, want, x, dtype, kind):
    """f32: atol F32_ATOL; bf16: mean abs error / mean |want - x| and max
    abs error (module docstring)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= F32_ATOL, err.max()
    else:
        rel = err.mean() / np.abs(want - np.asarray(x, np.float32)).mean()
        assert rel <= BF16_REL[kind] and err.max() <= BF16_MAX, (rel, err.max())


def _unchanged_launches(fn):
    before = {k: v.launches for k, v in KERNELS.items()}
    out = fn()
    assert {k: v.launches for k, v in KERNELS.items()} == before  # CPU: plain versions
    return out


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage,shift", [(0, 4), (1, 4), (2, 4), (3, 0)])
def test_attention_v3_plain_matches_pallas(stage, shift, dtype, grouped):
    rng = np.random.default_rng(300 + 10 * stage + shift)
    p, pre, c, heads = _block_params(rng, stage)
    res, window, shift = _geometry(stage, shift)
    tdt, jdt = DTYPES[dtype]
    x = rng.normal(size=(1, res, res, c)).astype(np.float32)
    jw = jax_v3_kernel_weights({k: jnp.asarray(v) for k, v in p.items()}, pre, res, shift,
                               heads, window, jdt)
    want = swin_attention_block_pallas_v3(
        jnp.asarray(x, jdt), None, None, *jw, heads, window, shift, eps=cfg.layer_norm_eps,
        grouped=grouped, interpret=True,
    )
    w = _torch(_v3_kernel_weights(p, pre, res, shift, heads, window), tdt)
    xt = torch.from_numpy(x).to(tdt)
    got = _unchanged_launches(lambda: swin_attention_half_v3(
        xt, w["wqkv"], w["bq3"], w["wp"], w["bp"], w["bm"], heads=heads, window=window,
        shift=shift, eps=cfg.layer_norm_eps,
    ))
    assert got.dtype == tdt
    _close(got.float().numpy(), want, xt.float().numpy(), dtype, "v3")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 4), (1, 4)])
def test_attention_v1_plain_matches_pallas(stage, shift, dtype):
    rng = np.random.default_rng(400 + 10 * stage + shift)
    p, pre, c, heads = _block_params(rng, stage)
    res, window, shift = _geometry(stage, shift)
    tdt, jdt = DTYPES[dtype]
    x = rng.normal(size=(1, res, res, c)).astype(np.float32)
    w = _v1_kernel_weights(p, pre, res, shift, heads, window)
    mats = ("wq", "wk", "wv", "wp")
    want = swin_attention_block_pallas(
        jnp.asarray(x, jdt), *(jnp.asarray(w[k], jdt if k in mats else jnp.float32)
                               for k in ("ln1_w", "ln1_b", "wq", "bq", "wk", "wv", "wp", "bp",
                                         "bm")),
        heads, window, shift, eps=cfg.layer_norm_eps, interpret=True,
    )
    t = _torch(w, tdt)
    xt = torch.from_numpy(x).to(tdt)
    got = _unchanged_launches(lambda: swin_attention_half_v1(
        xt, t["ln1_w"], t["ln1_b"], t["wq"], t["bq"], t["wk"], t["wv"], t["wp"], t["bp"],
        t["bm"], heads=heads, window=window, shift=shift, eps=cfg.layer_norm_eps,
    ))
    _close(got.float().numpy(), want, xt.float().numpy(), dtype, "v1")


def test_attention_v1_merged_form_not_ported():
    """The merged one-window form (window = resolution = 16, htsat.py:
    347-349) is ported on its dense (1, heads, 256, 256) table only: at
    window 16 a per-window (1, heads, 64, 64) table raises, and so does a
    window of 16 that is not the whole image (R = 32), naming the roadmap
    entry."""
    rng = np.random.default_rng(1)
    p, pre, c, heads = _block_params(rng, 2)
    t = _torch(_v1_kernel_weights(p, pre, 16, 0, heads, 8), torch.float32)
    args = (t["ln1_w"], t["ln1_b"], t["wq"], t["bq"], t["wk"], t["wv"], t["wp"], t["bp"])
    with pytest.raises(ValueError, match="table"):
        swin_attention_half_v1(torch.zeros((1, 16, 16, c)), *args, t["bm"], heads=heads,
                               window=16, shift=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        swin_attention_half_v1(torch.zeros((1, 32, 32, c)), *args,
                               torch.zeros((1, heads, 256, 256)), heads=heads, window=16,
                               shift=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage", [0, 2])
def test_mlp_plain_matches_pallas(stage, dtype):
    rng = np.random.default_rng(500 + stage)
    p, pre, c, _ = _block_params(rng, stage)
    tdt, jdt = DTYPES[dtype]
    x = rng.normal(size=(2, 128, c)).astype(np.float32)
    w = _v3_kernel_weights(p, pre, 8, 0, cfg.num_heads[stage], 8)
    names = ("ln2_w", "ln2_b", "w1", "b1", "w2", "b2")
    want = mlp_block_pallas(
        jnp.asarray(x, jdt),
        *(jnp.asarray(w[k], jdt if k in ("w1", "w2") else jnp.float32) for k in names),
        eps=cfg.layer_norm_eps, gelu="exact", interpret=True,
    )
    t = _torch(w, tdt)
    xt = torch.from_numpy(x).to(tdt)
    got = _unchanged_launches(lambda: mlp_block(xt, *(t[k] for k in names),
                                                eps=cfg.layer_norm_eps))
    assert got.dtype == tdt
    _close(got.float().numpy(), want, xt.float().numpy(), dtype, "mlp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage,shift", [(2, 4), (3, 0)])
def test_xla_halves_match_jax_block(stage, shift, dtype):
    """``window_attention_xla`` then ``mlp_xla`` (a block whose path is
    "xla", at one image: 256 or 64 rows take the XLA MLP) against the JAX
    block on the CPU, which takes XLA for both halves."""
    rng = np.random.default_rng(600 + 10 * stage + shift)
    p, pre, c, heads = _block_params(rng, stage)
    res, _, shift = _geometry(stage, shift)
    tdt, jdt = DTYPES[dtype]
    x = rng.normal(size=(1, res * res, c)).astype(np.float32)
    want = jax_swin_block(jnp.asarray(x, jdt), {k: jnp.asarray(v) for k, v in p.items()}, pre,
                          cfg, res, shift, heads, stage=stage)
    block = SwinBlock(p, pre, cfg, res, shift, heads, tdt, attention="xla")
    assert not block.fused_mlp(1)
    xt = torch.from_numpy(x).to(tdt)
    got = _unchanged_launches(lambda: block(xt))
    assert got.dtype == tdt
    _close(got.float().numpy(), want, xt.float().numpy(), dtype, "xla")


# ----------------------------------------------------------------------
# path selection
# ----------------------------------------------------------------------
@pytest.mark.parametrize("env,want", [
    ({}, ["v4"] * 8),
    ({"AM_TPU_V4_STAGES": ""}, ["v3"] * 8),
    ({"AM_TPU_V4_STAGES": "2u,2s,0u,0s"}, ["v4", "v4", "v3", "v3", "v4", "v4", "v3", "v3"]),
    ({"AM_TPU_V4_STAGES": "1s,3u"}, ["v3", "v3", "v3", "v4", "v3", "v3", "v4", "v4"]),
    ({"AM_TPU_ATTN_V1": "1"}, ["v1"] * 4 + ["xla"] * 4),
])
def test_attention_choice_per_block(monkeypatch, env, want):
    """Each block's path in the dispatch order of htsat.py:564-584, the
    variables read when the encoder is built; stage 3 (one window) is all
    "3u" entries."""
    for k in ("AM_TPU_V4_STAGES", "AM_TPU_ATTN_V1"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    small = HTSATConfig(**SMALL)
    enc = HTSATEncoder(init_params(small, seed=0), small, torch.float32)
    assert [b.attention for stage in enc.blocks for b in stage] == want


def _spies(monkeypatch):
    """Count the calls of every plain function and XLA half a forward can
    reach."""
    calls = {}

    def spy(mod, name):
        orig = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    for name in ("swin_block_plain", "swin_attention_half_v3_plain",
                 "swin_attention_half_v1_plain"):
        spy(attention_mod, name)
    spy(mlp_mod, "mlp_block_plain")
    spy(htsat_mod, "window_attention_xla")
    spy(htsat_mod, "mlp_xla")
    return calls


@pytest.mark.parametrize("env,want", [
    ({"AM_TPU_V4_STAGES": ""},
     {"swin_attention_half_v3_plain": 8, "mlp_block_plain": 4, "mlp_xla": 4}),
    ({"AM_TPU_V4_STAGES": "2u,2s,0u,0s"},
     {"swin_block_plain": 4, "swin_attention_half_v3_plain": 4, "mlp_block_plain": 2,
      "mlp_xla": 2}),
    ({"AM_TPU_ATTN_V1": "1"},
     {"swin_attention_half_v1_plain": 4, "window_attention_xla": 4, "mlp_block_plain": 4,
      "mlp_xla": 4}),
])
def test_forward_reaches_the_chosen_plain_functions(monkeypatch, env, want):
    """One image through the small encoder (8 blocks): stages 0 and 1 have
    4096 and 1024 tokens and take the fused MLP, stages 2 and 3 at 256 and
    64 rows take the XLA MLP."""
    for k in ("AM_TPU_V4_STAGES", "AM_TPU_ATTN_V1"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    small = HTSATConfig(**SMALL)
    enc = HTSATEncoder(init_params(small, seed=0), small, torch.float32)
    calls = _spies(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 4096, 32)).astype(np.float32))
    out = enc(x)
    assert out.shape == (1, small.num_features) and torch.isfinite(out).all()
    assert calls == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xla_halves_hold_full_f32_in_f32(monkeypatch, dtype):
    """Under ``AM_TPU_ATTN_V1`` stages 2 and 3 take the XLA attention half
    and, at one image, the XLA MLP: in f32 each runs inside
    ``utils.precision.full_f32`` (TF32 off, whatever the caller set), as the
    f32 mel chain does; in bf16 neither enters it."""
    import contextlib

    depth, seen = [], []

    @contextlib.contextmanager
    def recording():
        depth.append(1)
        try:
            yield
        finally:
            depth.pop()

    monkeypatch.setattr(htsat_mod, "full_f32", recording)
    for name in ("window_attention_xla", "mlp_xla"):
        orig = getattr(htsat_mod, name)
        monkeypatch.setattr(htsat_mod, name, lambda *a, _o=orig, _n=name, **k: (
            seen.append((_n, bool(depth))), _o(*a, **k))[1])
    monkeypatch.delenv("AM_TPU_V4_STAGES", raising=False)
    monkeypatch.setenv("AM_TPU_ATTN_V1", "1")
    small = HTSATConfig(**SMALL)
    enc = HTSATEncoder(init_params(small, seed=0), small, dtype)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 4096, 32)).astype(np.float32))
    out = enc(x.to(dtype))
    assert torch.isfinite(out).all()
    inside = dtype == torch.float32
    assert seen == [("window_attention_xla", inside), ("mlp_xla", inside)] * 4


def test_mlp_row_rule_at_two_batch_sizes(monkeypatch):
    """A stage-2 block (256 tokens) takes the XLA MLP at one image and the
    fused MLP at 64 images (16384 rows); stage 0 (4096 tokens) always the
    fused one."""
    rng = np.random.default_rng(7)
    small = HTSATConfig(**SMALL)
    p = init_params(small, seed=0)
    pre = "audio_encoder.layers.2.blocks.0"
    block = SwinBlock(p, pre, small, 16, 0, 4, torch.float32, attention="v3")
    assert not block.fused_mlp(1) and not block.fused_mlp(63) and block.fused_mlp(64)
    block0 = SwinBlock(p, "audio_encoder.layers.0.blocks.0", small, 64, 0, 1, torch.float32,
                       attention="v3")
    assert block0.fused_mlp(1)
    for batch, fused in ((1, 0), (64, 1)):
        calls = _spies(monkeypatch)
        x = torch.from_numpy(rng.normal(size=(batch, 256, 128)).astype(np.float32))
        block(x)
        assert calls.get("mlp_block_plain", 0) == fused
        assert calls.get("mlp_xla", 0) == 1 - fused


# ----------------------------------------------------------------------
# the slice
# ----------------------------------------------------------------------
def _params(small):
    """Seeded weights with nontrivial biases, bias tables and norms (the
    weights of tests/test_torch_slice.py)."""
    rng = np.random.default_rng(1)
    p = init_params(small, seed=0)
    p.update(init_projection_params(small, seed=0))
    for k in p:
        if k.endswith(".bias") or "bias_table" in k:
            p[k] = rng.normal(scale=0.1, size=p[k].shape).astype(np.float32)
    p["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    return p


def _clips(seed, n, seconds=5):
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * SR) / SR
    tone = np.sin(2 * np.pi * rng.uniform(100, 2000, size=(n, 1)) * t)
    return (0.1 * rng.standard_normal((n, seconds * SR)) + 0.2 * tone).astype(np.float32)


METRICS = ["fad", "kd", "prdc"]


@pytest.fixture(scope="module")
def jax_slice():
    """The JAX package's evaluate on the CPU (XLA blocks whatever the
    variables say)."""
    small = JaxHTSATConfig(**SMALL)
    jam = JaxAudioMetrics(metrics=METRICS, embedder=JaxLaionCLAP(params=_params(small),
                                                                cfg=small),
                          win_dur=5.0, input_sr=SR, batch_size=4, device_indices=[0])
    jam.add_reference(jnp.asarray(_clips(0, 6)))
    return jam.evaluate(jnp.asarray(_clips(1, 6))), np.asarray(jam.stem_reference.embeddings)


@pytest.mark.parametrize("env,path", [({"AM_TPU_V4_STAGES": ""}, "v3"),
                                      ({"AM_TPU_ATTN_V1": "1"}, "v1")])
def test_split_slice_matches_jax(monkeypatch, jax_slice, env, path):
    """``AudioMetrics(metrics=["fad", "kd", "prdc"])`` in f32 with the
    split blocks against the JAX package: the tolerances of
    tests/test_torch_slice.py::test_fad_kd_slice_matches_jax (embeddings
    atol 1e-6, FAD rel 1e-5, KD abs 1e-7); PRDC equal (fractions of 6
    clips; no near-tie at these embeddings)."""
    for k in ("AM_TPU_V4_STAGES", "AM_TPU_ATTN_V1"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, want_emb = jax_slice
    small = HTSATConfig(**SMALL)
    clap = LaionCLAP(params=_params(small), cfg=small, device="cpu")
    assert {b.attention for st in clap.model.encoder.blocks[:2] for b in st} == {path}
    am = AudioMetrics(metrics=METRICS, embedder=clap, win_dur=5.0, input_sr=SR, batch_size=4,
                      device="cpu")
    am.add_reference(torch.from_numpy(_clips(0, 6)))
    got = am.evaluate(_clips(1, 6))
    np.testing.assert_allclose(am.stem_reference.embeddings.numpy(), want_emb, atol=1e-6)
    assert set(got) == set(want)
    assert got["fad"] == pytest.approx(want["fad"], rel=1e-5)
    for k in ("kernel_distance_mean", "kernel_distance_std"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-7), k
    for k in ("precision", "recall", "density", "coverage"):
        assert got[k] == want[k], k


def test_10s_path_mel_v1_matches_halo(monkeypatch):
    """The 10 s CLAP path in bf16 with ``AM_TPU_MEL_V1=1`` (the v1 log-mel's
    plain version, frames 1440 wide) against the halo log-mel's: both round
    frames and basis to bf16 and sum in f32, in other orders; the bf16 mel
    and the bf16 encoder turn that into embeddings 1 - cos <= 1e-4 apart."""
    monkeypatch.delenv("AM_TPU_MEL_V1", raising=False)
    small = HTSATConfig(**SMALL)
    clap = LaionCLAP(params=_params(small), cfg=small, device="cpu", compute_dtype="bfloat16")
    audio = torch.from_numpy(_clips(2, 2, seconds=10))
    calls = {}
    for name in ("log_mel_halo_plain", "log_mel_v1_plain"):
        orig = getattr(mel_mod, name)
        monkeypatch.setattr(mel_mod, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1), _o(*a, **kw))[1])
    halo = clap.embed(audio)
    assert calls == {"log_mel_halo_plain": 1}
    monkeypatch.setenv("AM_TPU_MEL_V1", "1")
    v1 = clap.embed(audio)
    assert calls == {"log_mel_halo_plain": 1, "log_mel_v1_plain": 1}
    cos = (halo * v1).sum(dim=1)
    assert torch.all(1 - cos <= 1e-4), 1 - cos
