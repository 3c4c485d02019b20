"""The host side of the wgmma GEMM core (kernels/csrc/gemm_sm90.cuh), on the CPU.

The whole Swin block (#1), its v3 attention half and fused MLP (#8, #9)
and the fused frontend (#3) read their matrices K-major, transposed once
when the weights load, and the qkv product reads the column sums of
``wqkv`` made at load.  Each is held here against the
JAX package's own weights: the transposed matrices equal the JAX layout
bitwise, and the column sums equal the f32 sums of the bf16 ``wqkv`` that
the JAX v4 kernel takes (audio_metrics_tpu/ops/attention.py:751).  The new
shape checks raise ``NotImplementedError`` on shapes the core does not
take.  The kernels themselves run on a card only (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from audio_metrics_tpu.models.htsat import HTSAT_BASE, _v3_kernel_weights as jax_v3_weights
from audio_metrics_tpu.ops.frontend_fused import _patch_selector as jax_patch_selector
from audio_metrics_tpu.ops.mel import _dft_matrices as jax_dft_matrices
from audio_metrics_tpu.ops.mel import _fb_support_bins as jax_fb_support_bins
from audio_metrics_tpu_torch.kernels import check_sm90_gemm
from audio_metrics_tpu_torch.models.clap import ClapFrontend, _clap_fb
from audio_metrics_tpu_torch.models.htsat import HTSATConfig, SwinBlock, init_params
from audio_metrics_tpu_torch.ops.attention import check_block_gemms, swin_block_operands
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
def test_split_blocks_hold_their_kernel_operands(params, attention):
    """A bf16 v3 block holds the whole block's operands from load (its
    attention half and fused MLP read them): each matrix the JAX v3 layout
    transposed, and the column sums of its bf16 ``wqkv``; a bf16 v1 or XLA
    block holds the fused MLP's ``w1_t`` and ``w2_t`` alone.  All held as
    buffers, so they move with the block."""
    pre = "audio_encoder.layers.1.blocks.1"
    block = SwinBlock(params, pre, cfg, 32, 4, cfg.num_heads[1], torch.bfloat16,
                      attention=attention)
    want = {"w1_t": _bf16(params[f"{pre}.intermediate.dense.weight"].T),
            "w2_t": _bf16(params[f"{pre}.output.dense.weight"].T)}
    if attention == "v3":
        wqkv, _, wp, _, _ = jax_v3_weights({k: jnp.asarray(v) for k, v in params.items()}, pre,
                                           32, 4, cfg.num_heads[1], cfg.window_size, jnp.bfloat16)
        want.update(wqkv_t=_bf16(wqkv), wp_t=_bf16(wp))
    ops = block.kernel_operands()
    assert set(ops) == set(want) | ({"csum"} if attention == "v3" else set())
    for name, w in want.items():
        assert ops[name].dtype == torch.bfloat16 and ops[name].is_contiguous()
        assert torch.equal(ops[name].t(), w), name
    if attention == "v3":
        assert torch.equal(ops["csum"], block.wqkv.float().sum(dim=0))
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
        (96, 128, (128,), False),   # N not a multiple of 64
        (128, 96, (96,), False),    # K not a multiple of 64
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


@pytest.mark.parametrize("c,ok", [(128, True), (256, True), (1024, True), (192, True),
                                  (96, False), (1088, False), (2048, False)])
def test_block_shape_check(c, ok):
    """C = 96 (HTSAT-tiny's width) has products of N = 288; C > 1024 is
    wider than the LN1 pass holds."""
    if ok:
        check_block_gemms(c)
    else:
        with pytest.raises(NotImplementedError):
            check_block_gemms(c)


def test_frontend_shape_check():
    """HTSAT-base at 5 s, 48 kHz passes, and so does HTSAT-tiny's C = 96
    (patch product N = 16 * 96); a filterbank support of 400 bins (DFT N =
    800) and 98-wide tokens (N = 1568) are not multiples of 64 and raise."""
    pln = _plan(5 * 48000, 48000, FRAME, HOP, cfg.num_mel_bins, cfg.spec_size, cfg.patch_size)
    check_frontend_gemms(384, cfg, pln)
    check_frontend_gemms(384, HTSATConfig(embed_dim=96), pln)
    with pytest.raises(NotImplementedError):
        check_frontend_gemms(400, cfg, pln)
    with pytest.raises(NotImplementedError):
        check_frontend_gemms(384, HTSATConfig(embed_dim=98), pln)
