"""The host side of the wgmma GEMM core (kernels/csrc/gemm_sm90.cuh), on the CPU.

The whole Swin block (#1), its v3, v1 and v2 attention halves and fused
MLP (#8-#11) and the fused frontend (#3) read their matrices K-major,
transposed once when the weights load, and the v3 qkv product reads the
column sums of ``wqkv`` made at load.  Each is held here against the JAX
package's own weights: the transposed matrices (and v1's qkv bias) equal
the JAX layout bitwise, and the column sums equal the f32 sums of the
bf16 ``wqkv`` that the JAX v4 kernel takes
(audio_metrics_tpu/ops/attention.py:751).  The new shape checks raise
``NotImplementedError`` on shapes the core does not take.  The kernels
themselves run on a card only (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from audio_metrics_tpu.models import htsat as jax_htsat
from audio_metrics_tpu.models.htsat import HTSAT_BASE, _v3_kernel_weights as jax_v3_weights
from audio_metrics_tpu.ops import attention as jax_attention
from audio_metrics_tpu.ops.frontend_fused import _patch_selector as jax_patch_selector
from audio_metrics_tpu.ops.mel import _dft_matrices as jax_dft_matrices
from audio_metrics_tpu.ops.mel import _fb_support_bins as jax_fb_support_bins
from audio_metrics_tpu_torch.kernels import check_s8_gemm, check_sm90_gemm
from audio_metrics_tpu_torch.models.clap import ClapFrontend, _clap_fb
from audio_metrics_tpu_torch.models.htsat import (
    HTSATConfig, SwinBlock, _Folded, _v2_kernel_weights, init_params,
)
from audio_metrics_tpu_torch.ops.attention import (
    check_block_gemms, half_operands, swin_block_operands,
)
from audio_metrics_tpu_torch.ops.mlp import mlp_operands
from audio_metrics_tpu_torch.ops.frontend_fused import FRAME, HOP, _plan, check_frontend_gemms
from audio_metrics_tpu_torch.ops.tf32 import tf32_split

cfg = HTSAT_BASE


@pytest.fixture(scope="module")
def params():
    """HTSAT-base random weights with LN affines away from 1/0, so that the
    LN1 fold moves every column sum."""
    rng = np.random.default_rng(0)
    p = init_params(cfg, seed=0)
    for k, v in p.items():
        if k.endswith(".weight") and "norm" in k:
            p[k] = (1.0 + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
        elif k.endswith(".bias"):
            p[k] = rng.normal(scale=0.5, size=v.shape).astype(np.float32)
    return p


def _bf16(a) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor (bitwise)."""
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.bfloat16).view(jnp.uint16))).view(
        torch.bfloat16)


def _jax_v1_columns(monkeypatch, params, pre, res, shift, heads, window):
    """The JAX package's own bf16 v1 weights (models/htsat.py:320-336: wq
    and bq scaled by 1/sqrt(d), wk, wv, wp), captured where it hands them
    to its v1 kernel, laid side by side as one product's operands: (C, 3C)
    qkv = [wq | wk | wv] by head, the (3C,) bias bq with zeros on k and v,
    (C, C) proj; as torch tensors, bitwise."""
    got = {}

    def capture(x, ln_w, ln_b, wq, bq, wk, wv, wp, bp, bm, *args, **kwargs):
        got.update(wq=wq, bq=bq, wk=wk, wv=wv, wp=wp)
        return x

    monkeypatch.setattr(jax_attention, "swin_attention_block_pallas", capture)
    c = params[f"{pre}.attention.self.query.weight"].shape[0]
    jax_htsat._attention_half_pallas(
        jnp.zeros((1, res * res, c), jnp.bfloat16),
        {k: jnp.asarray(v) for k, v in params.items() if k.startswith(pre)}, pre, cfg, res, shift,
        heads, window)
    cols = lambda w: jnp.transpose(w, (1, 0, 2)).reshape(c, c)
    wqkv = jnp.concatenate([cols(got[k]) for k in ("wq", "wk", "wv")], axis=1)
    bq3 = np.concatenate([np.asarray(got["bq"]).reshape(-1), np.zeros(2 * c, np.float32)])
    return _bf16(wqkv), torch.from_numpy(bq3), _bf16(got["wp"].reshape(c, c))


@pytest.mark.parametrize("half,stage,shift", [("v1", 0, 0), ("v1", 1, 4), ("v2", 0, 4),
                                              ("v2", 3, 0)])
def test_ln_affine_operands_at_load_match_jax(monkeypatch, params, half, stage, shift):
    """The bf16 v1 and v2 halves read (N, K) K-major operands made at load:
    a v1 block's ``v1_operands`` and ``half_operands`` of v2's bf16 (C, 3C)
    / (C, C) pair are the JAX package's own bf16 v1 weights laid side by
    side and transposed, bitwise, and v1's ``bq3`` its scaled q bias with
    zeros on k and v."""
    res = cfg.grid_size // 2**stage
    window = min(cfg.window_size, res)
    pre = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
    heads = cfg.num_heads[stage]
    wqkv, bq3, wp = _jax_v1_columns(monkeypatch, params, pre, res, shift, heads, window)
    if half == "v1":
        block = SwinBlock(params, pre, cfg, res, shift, heads, torch.bfloat16, attention="v1")
        ops = block.kernel_operands()
        assert ops["bq3"].dtype == torch.float32 and torch.equal(ops["bq3"], bq3)
    else:
        w = _Folded(_v2_kernel_weights(params, pre, res, shift, heads, window), torch.bfloat16)
        ops = half_operands(w.wqkv, w.wp)
        assert set(ops) == {"wqkv_t", "wp_t"} and torch.equal(w.bq3, bq3)
    for name, want in (("wqkv_t", wqkv), ("wp_t", wp)):
        assert ops[name].dtype == torch.bfloat16 and ops[name].is_contiguous()
        assert ops[name].shape == want.t().shape and torch.equal(ops[name].t(), want), name


@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 4), (1, 4), (2, 0), (3, 0)])
def test_block_operands_at_load_match_jax(params, stage, shift):
    res = cfg.grid_size // 2**stage
    window = min(cfg.window_size, res)
    shift = 0 if res <= window else shift
    pre = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
    block = SwinBlock(params, pre, cfg, res, shift, cfg.num_heads[stage], torch.bfloat16)
    assert block.attention == "v4"
    wqkv, _, wp, _, _ = jax_v3_weights({k: jnp.asarray(v) for k, v in params.items()}, pre, res,
                                       shift, cfg.num_heads[stage], window, jnp.bfloat16)
    w1 = _bf16(params[f"{pre}.intermediate.dense.weight"].T)
    w2 = _bf16(params[f"{pre}.output.dense.weight"].T)
    ops = block.kernel_operands()
    for name, want in (("wqkv_t", _bf16(wqkv)), ("wp_t", _bf16(wp)), ("w1_t", w1), ("w2_t", w2)):
        got = ops[name]
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.equal(got.t(), want), name
    # the column sums: exactly those of the block's bf16 wqkv, and the JAX
    # kernel's f32 sums of the same bf16 weights up to summation order
    assert ops["csum"].dtype == torch.float32
    assert torch.equal(ops["csum"], block.wqkv.float().sum(dim=0))
    jax_csum = np.asarray(jnp.sum(wqkv.astype(jnp.float32), axis=0))
    np.testing.assert_allclose(ops["csum"].numpy(), jax_csum, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("attention", ["v3", "v1", "xla"])
def test_split_blocks_hold_their_kernel_operands(monkeypatch, params, attention):
    """A bf16 v3 block holds the whole block's operands from load (its
    attention half and fused MLP read them): each matrix the JAX v3 layout
    transposed, and the column sums of its bf16 ``wqkv``; a bf16 v1 block
    holds the fused MLP's ``w1_t`` and ``w2_t`` and its attention half's
    ``wqkv_t``, ``wp_t`` (the JAX v1 layout side by side, transposed) and
    ``bq3``; an XLA block the fused MLP's alone.  All held as buffers, so
    they move with the block."""
    pre = "audio_encoder.layers.1.blocks.1"
    block = SwinBlock(params, pre, cfg, 32, 4, cfg.num_heads[1], torch.bfloat16,
                      attention=attention)
    want = {"w1_t": _bf16(params[f"{pre}.intermediate.dense.weight"].T),
            "w2_t": _bf16(params[f"{pre}.output.dense.weight"].T)}
    if attention == "v3":
        wqkv, _, wp, _, _ = jax_v3_weights({k: jnp.asarray(v) for k, v in params.items()}, pre,
                                           32, 4, cfg.num_heads[1], cfg.window_size, jnp.bfloat16)
        want.update(wqkv_t=_bf16(wqkv), wp_t=_bf16(wp))
    if attention == "v1":
        wqkv, bq3, wp = _jax_v1_columns(monkeypatch, params, pre, 32, 4, cfg.num_heads[1],
                                        cfg.window_size)
        want.update(wqkv_t=wqkv, wp_t=wp)
    ops = block.kernel_operands()
    extra = {"v3": {"csum"}, "v1": {"bq3"}, "xla": set()}[attention]
    assert set(ops) == set(want) | extra
    for name, w in want.items():
        assert ops[name].dtype == torch.bfloat16 and ops[name].is_contiguous()
        assert torch.equal(ops[name].t(), w), name
    if attention == "v3":
        assert torch.equal(ops["csum"], block.wqkv.float().sum(dim=0))
    if attention == "v1":
        assert torch.equal(ops["bq3"], bq3)
    buffers = dict(block.named_buffers())
    assert all(buffers[name] is t for name, t in ops.items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_operands_of_any_dtype(dtype):
    """``mlp_operands`` holds ``w1`` and ``w2`` transposed in bf16 and as
    their transposes' TF32 hi over lo stacks in f32: the same matrices a
    whole block's ``swin_block_operands`` holds."""
    g = torch.Generator().manual_seed(1)
    w = [torch.randn(shape, generator=g).to(dtype) for shape in
         ((128, 384), (128, 128), (128, 512), (512, 128))]
    ops = mlp_operands(w[2], w[3])
    assert set(ops) == {"w1_t", "w2_t"}
    block_ops = swin_block_operands(*w)
    for name, m in (("w1_t", w[2]), ("w2_t", w[3])):
        want = tf32_split(m.t()) if dtype == torch.float32 else m.t()
        assert ops[name].dtype == dtype and ops[name].is_contiguous()
        assert torch.equal(ops[name], want) and torch.equal(ops[name], block_ops[name])


@pytest.mark.parametrize("attention", ["v3", "v1", "xla"])
def test_split_forward_hands_the_wrappers_their_operands(monkeypatch, attention):
    """A bf16 split block's forward passes its operands held from load to
    the attention-half wrapper and to the fused MLP's (stage 1 of the small
    config at 2 images: 2048 rows of 1024 tokens, the fused MLP)."""
    from audio_metrics_tpu_torch.models import htsat

    calls = {}

    def spy(name):
        def wrapper(x, *args, **kwargs):
            calls[name] = kwargs.get("operands")
            return x
        return wrapper

    for name in ("swin_attention_half_v3", "swin_attention_half_v1", "mlp_block"):
        monkeypatch.setattr(htsat, name, spy(name))
    small = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    block = SwinBlock(init_params(small, seed=0), "audio_encoder.layers.1.blocks.1", small, 32,
                      4, 2, torch.bfloat16, attention=attention)
    block(torch.zeros((2, 32 * 32, 64), dtype=torch.bfloat16))
    ops = block.kernel_operands()
    want = {"mlp_block"} | ({f"swin_attention_half_{attention}"} if attention != "xla" else set())
    assert set(calls) == want
    for got in calls.values():
        assert got.keys() == ops.keys() and all(got[k] is ops[k] for k in ops)
    assert {"w1_t", "w2_t"} <= ops.keys()
    if attention == "v3":
        assert {"wqkv_t", "wp_t", "csum"} <= ops.keys()
    if attention == "v1":
        assert {"wqkv_t", "wp_t", "bq3"} <= ops.keys()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_operands_of_any_dtype(dtype):
    """``swin_block_operands`` keeps each matrix's dtype and sums in f32;
    in bf16 it holds each matrix transposed, in f32 the transposed
    matrix's TF32 hi over lo parts (the 3xTF32 core's operand)."""
    g = torch.Generator().manual_seed(0)
    w = [torch.randn(shape, generator=g).to(dtype) for shape in
         ((128, 384), (128, 128), (128, 512), (512, 128))]
    ops = swin_block_operands(*w)
    for name, m in zip(("wqkv_t", "wp_t", "w1_t", "w2_t"), w):
        want = tf32_split(m.t()) if dtype == torch.float32 else m.t()
        assert ops[name].dtype == dtype and torch.equal(ops[name], want)
    assert torch.equal(ops["csum"], w[0].float().sum(dim=0))


def test_frontend_tables_transposed_match_jax(params):
    """``basis_t``: the DFT basis cut to the filterbank support, cos/sin
    rows interleaved; ``qcat_t``: the zero-padded block patch-embed operand
    (the JAX package's ``qcat``), both transposed and bf16."""
    fr = ClapFrontend(params, cfg)
    fb = _clap_fb()
    n_keep = jax_fb_support_bins(fb)
    cos_m, sin_m = jax_dft_matrices(FRAME, FRAME, "hann")
    want = np.empty((2 * n_keep, FRAME), np.float32)
    want[0::2], want[1::2] = cos_m[:, :n_keep].T, sin_m[:, :n_keep].T
    assert fr.basis_t.shape == (2 * n_keep, FRAME) and fr.basis_t.dtype == torch.bfloat16
    assert torch.equal(fr.basis_t, _bf16(want))

    ps, n_mels, c = cfg.patch_size, cfg.num_mel_bins, cfg.embed_dim
    fbk = n_mels // ps
    patch_w = params["audio_encoder.patch_embed.proj.weight"].reshape(-1, ps * ps).T
    qcat = jnp.dot(jnp.asarray(jax_patch_selector(n_mels, ps)), jnp.asarray(patch_w))
    qcat = qcat.reshape(ps * n_mels, fbk * c)
    assert fr.qcat_t.shape == (fbk * c, ps * n_mels)
    assert torch.equal(fr.qcat_t.t(), _bf16(qcat))


@pytest.mark.parametrize(
    "n,k,strides,ok",
    [
        (384, 128, (128,), True),
        (64, 1024, (1024, 65536), True),
        (768, 1024, (HOP, 246304), True),
        (96, 128, (128,), True),    # N = 96 (HTSAT-tiny's proj, fc2): one 96-column tile
        (128, 96, (96,), True),     # K = 96: a second K step of 64, half zero-filled
        (288, 96, (96,), True),     # HTSAT-tiny's stage-0 qkv: three 96-column tiles
        (160, 128, (128,), False),  # N a multiple of neither 64 nor 96
        (128, 72, (72,), False),    # K not a multiple of 16
        (128, 128, (124,), False),  # a row stride off 16 bytes
        (128, 128, (128, 12), False),  # a batch stride off 16 bytes
    ],
)
def test_sm90_gemm_shape_check(n, k, strides, ok):
    if ok:
        check_sm90_gemm("test", n, k, *strides)
    else:
        with pytest.raises(NotImplementedError):
            check_sm90_gemm("test", n, k, *strides)


@pytest.mark.parametrize(
    "n,k,strides,ok",
    [
        (256, 64, (64,), True),     # K of half a 128-code step: zero-filled
        (128, 4096, (4096,), True),
        (256, 48, (48,), True),
        (96, 384, (384,), False),   # N not a multiple of 64
        (256, 24, (24,), False),    # K off 16 bytes
        (256, 64, (72,), False),    # a row stride off 16 bytes
    ],
)
def test_s8_gemm_shape_check(n, k, strides, ok):
    """The wgmma core on int8 codes: any K of whole 16-byte rows."""
    if ok:
        check_s8_gemm("test", n, k, *strides)
    else:
        with pytest.raises(NotImplementedError):
            check_s8_gemm("test", n, k, *strides)


@pytest.mark.parametrize("c,ok", [(128, True), (256, True), (1024, True), (192, True),
                                  (96, True), (98, False), (160, False), (1088, False),
                                  (2048, False)])
def test_block_shape_check(c, ok):
    """C = 96 (HTSAT-tiny's width) runs its N = 288 and N = 96 products on
    96-column tiles and K = 96 in two steps of 64; C = 98 has a K of no
    whole wgmma instruction, C = 160 an N = C on no column tile; C > 1024 is
    wider than the LN1 pass holds."""
    if ok:
        check_block_gemms(c)
    else:
        with pytest.raises(NotImplementedError):
            check_block_gemms(c)


def test_frontend_shape_check():
    """HTSAT-base at 5 s, 48 kHz passes, and so does HTSAT-tiny's C = 96
    (patch product N = 16 * 96); a filterbank support of 400 bins (DFT N =
    800) and 98-wide tokens (N = 1568) are multiples of neither 64 nor 96
    and raise."""
    pln = _plan(5 * 48000, 48000, FRAME, HOP, cfg.num_mel_bins, cfg.spec_size, cfg.patch_size)
    check_frontend_gemms(384, cfg, pln)
    check_frontend_gemms(384, HTSATConfig(embed_dim=96), pln)
    with pytest.raises(NotImplementedError):
        check_frontend_gemms(400, cfg, pln)
    with pytest.raises(NotImplementedError):
        check_frontend_gemms(384, HTSATConfig(embed_dim=98), pln)
