"""HTSAT-tiny's widths (C = 96 * 2^i, heads 24 wide) in the port against the
JAX package, on the CPU.

HTSAT-tiny (``HTSAT_TINY``: embed 96, depths 2/2/6/2, heads 4/8/16/32) is
the audio tower of LAION-CLAP's general-audio checkpoints.  Per module, at
C = 96, 4 heads of 24, window 8, R = 16, B = 1: the whole Swin block's
plain version against the TPU kernel itself (``swin_block_pallas_v4`` in
interpret mode, exact-erf GELU), unshifted and shifted; the patch merge's
against ``patch_merge_pallas`` in interpret mode, with the operands the
card's kernel reads (its quadrants in ``merge_k_order``, the weight in the
same order) giving the same product.  The slice: ``AudioMetrics(["fad",
"kd", "prdc"])`` of both packages on a narrow tiny-shaped config (24-wide
heads, one block a stage) in f32 and bf16, under the bounds that
tests/test_torch_slice.py holds HTSAT-base's slice to.  And the shapes that
the widened kernels still refuse raise before a launch.  The kernels run on
a card only (``chip_smoke.py`` phase 19).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.ops.attention import swin_block_pallas_v4
from audio_metrics_tpu.ops.merge import patch_merge_pallas
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.models.clap import LaionCLAP, init_projection_params
from audio_metrics_tpu_torch.models.htsat import (
    HTSAT_TINY,
    HTSATConfig,
    PatchMerge,
    _merge_weights,
    _v3_kernel_weights,
    init_params,
)
from audio_metrics_tpu_torch.ops.attention import (
    _check_geometry,
    check_block_f32,
    check_block_gemms,
    swin_block_plain,
)
from audio_metrics_tpu_torch.ops.merge import (
    _quadrants,
    check_merge_f32,
    check_merge_gemm,
    merge_k_order,
    merge_weight_t,
)
from audio_metrics_tpu_torch.ops.tf32 import tf32_split

cfg = HTSAT_TINY
C, HEADS, R = 96, 4, 16  # stage 0's width and heads at a small resolution
NARROW = dict(embed_dim=48, depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 16))  # heads of 24
SR = 48000


def _block_params(rng):
    """Block weights at C = 96 with nontrivial biases, bias table and LN
    affines (tests/test_torch_kernels.py's ``_block_params``)."""
    pre = "audio_encoder.layers.0.blocks.0"
    nrm = lambda *s, scale=0.02: rng.normal(scale=scale, size=s).astype(np.float32)
    p = {
        f"{pre}.layernorm_before.weight": 1.0 + nrm(C, scale=0.1),
        f"{pre}.layernorm_before.bias": nrm(C, scale=0.5),
        f"{pre}.attention.self.relative_position_bias_table": nrm(
            (2 * cfg.window_size - 1) ** 2, HEADS, scale=0.5),
        f"{pre}.layernorm_after.weight": 1.0 + nrm(C, scale=0.1),
        f"{pre}.layernorm_after.bias": nrm(C, scale=0.5),
    }
    for name, (d_in, d_out) in {
        "attention.self.query": (C, C), "attention.self.key": (C, C),
        "attention.self.value": (C, C), "attention.output.dense": (C, C),
        "intermediate.dense": (C, 4 * C), "output.dense": (4 * C, C),
    }.items():
        p[f"{pre}.{name}.weight"] = nrm(d_out, d_in, scale=d_in**-0.5)
        p[f"{pre}.{name}.bias"] = nrm(d_out, scale=0.5)
    return p, pre


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_at_24_wide_heads_matches_pallas_v4(shift):
    """The plain whole block (what the card's #1 is held to) against the
    TPU kernel in interpret mode on the same folded weights, f32, at
    HTSAT-tiny's 24-wide heads (the TPU kernel falls back to one lane
    group, 128 % 24 != 0): atol 2e-4, tests/test_pallas_model_kernels.py:
    588's bound."""
    rng = np.random.default_rng(21 + shift)
    p, pre = _block_params(rng)
    w = _v3_kernel_weights(p, pre, R, shift, HEADS, cfg.window_size)
    x = rng.normal(size=(1, R, R, C)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in w.items()}
    want = np.asarray(swin_block_pallas_v4(
        jnp.asarray(x), None, None, j["wqkv"], j["bq3"], j["wp"], j["bp"], j["bm"],
        j["ln2_w"], j["ln2_b"], j["w1"], j["b1"], j["w2"], j["b2"], HEADS, cfg.window_size,
        shift, eps=cfg.layer_norm_eps, gelu="exact", interpret=True,
    ))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in w.items()}
    got = swin_block_plain(
        torch.from_numpy(x), t["wqkv"], t["bq3"], t["wp"], t["bp"], t["bm"], t["ln2_w"],
        t["ln2_b"], t["w1"], t["b1"], t["w2"], t["b2"],
        heads=HEADS, window=cfg.window_size, shift=shift, eps=cfg.layer_norm_eps,
    ).numpy()
    assert np.abs(got - x).max() > 0.1  # the block moves its input
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_merge_at_96_matches_pallas(dtype):
    """The plain merge at C = 96 against ``patch_merge_pallas`` in
    interpret mode, with a common-mode offset of 50: f32 within 1e-4 of the
    output scale, bf16 within 2e-2 and correlation > 0.99999
    (tests/test_torch_kernels.py's bounds for HTSAT-base's merge)."""
    rng = np.random.default_rng(5)
    b, h, oc = 2, 8, 2 * C
    x = (50.0 + rng.standard_normal((b, h * h, C))).astype(np.float32)
    p = {"m.norm.weight": rng.standard_normal(4 * C).astype(np.float32),
         "m.norm.bias": rng.standard_normal(4 * C).astype(np.float32),
         "m.reduction.weight": (0.05 * rng.standard_normal((oc, 4 * C))).astype(np.float32)}
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    w = _merge_weights(p, "m")
    want = np.asarray(patch_merge_pallas(
        jnp.asarray(x, jdt), jnp.asarray(w["wg"], jdt), jnp.asarray(w["svec"]),
        jnp.asarray(w["tvec"]), h=h, w=h, eps=cfg.layer_norm_eps, interpret=True,
    ), np.float32)
    got = PatchMerge(p, "m", cfg, h, tdt)(torch.from_numpy(x).to(tdt)).float().numpy()
    assert got.shape == (b, (h // 2) ** 2, oc)
    scale = np.abs(want).max()
    if dtype == "float32":
        assert np.abs(got - want).max() / scale < 1e-4
    else:
        assert np.abs(got - want).max() / scale < 2e-2
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.99999


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_merge_kernel_operands_keep_the_product(dtype):
    """What the card's merge multiplies at C = 96: A's quadrants in
    ``merge_k_order`` against ``merge_weight_t``'s columns in the same
    order.  bf16: dy-major, so that each K step of 64 lies in one
    pixel-pair row; in float64 the product equals the concat's against
    ``wg`` to 1e-12.  f32: K steps of 32 lie in one quadrant, the concat's
    order, the weight's TF32 split as at HTSAT-base's widths."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn((2, R * R, C), generator=g).to(dtype)
    wg = torch.randn((4, C, 2 * C), generator=g).to(dtype)
    if dtype == torch.float32:
        assert merge_k_order(C, 32) == (0, 1, 2, 3)
        assert torch.equal(merge_weight_t(wg), tf32_split(wg.reshape(4 * C, 2 * C).t()))
        return
    order = list(merge_k_order(C, 64))
    assert order == [0, 2, 1, 3]
    cat = _quadrants(x, R, R)
    a = cat.reshape(-1, 4, C)[:, order].reshape(-1, 4 * C).double()
    got = a @ merge_weight_t(wg).double().t()
    want = cat.reshape(-1, 4 * C).double() @ wg.reshape(4 * C, 2 * C).double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * want.abs().max().item())


@pytest.mark.parametrize("c,heads,ok", [
    (96, 4, True), (192, 8, True), (384, 16, True), (768, 32, True),  # HTSAT-tiny
    (128, 4, True),    # HTSAT-base's 32-wide heads
    (96, 3, True),     # 32-wide heads at C = 96
    (80, 4, False),    # heads of 20
    (98, 4, False),    # C = 98: no whole head width
])
def test_whole_block_geometry(c, heads, ok):
    """The whole block takes heads 24 or 32 wide; the attention halves
    (#8, #10, #11) stay at 32-wide heads and C % 64 == 0."""
    x = torch.empty((1, 16, 16, c))
    bm = torch.empty((1, heads, 64, 64))
    if ok:
        _check_geometry("swin_block", x, heads, 8, bm, whole=True)
    else:
        with pytest.raises(NotImplementedError):
            _check_geometry("swin_block", x, heads, 8, bm, whole=True)
    if c % 64 or c != 32 * heads:
        with pytest.raises(NotImplementedError):
            _check_geometry("swin_attn_v3", x, heads, 8, bm)


@pytest.mark.parametrize("c,ok", [(96, True), (192, True), (384, True), (768, True),
                                  (98, False), (1088, False)])
def test_widths_the_kernels_take(c, ok):
    """The whole block (bf16 and f32) and the merges (bf16 and f32) at
    HTSAT-tiny's widths; C = 98 and C = 1088 still raise before a launch."""
    checks = [check_block_gemms, check_block_f32, lambda c: check_merge_gemm(16, c),
              lambda c: check_merge_f32(16, c)]
    for check in checks:
        if ok and not (check is checks[3] and c > 512):
            check(c)
        else:
            with pytest.raises(NotImplementedError):
                check(c)


def test_sass_diff_reads_a_dump(monkeypatch):
    """``sass_diff.functions`` keys a ``cuobjdump -sass`` dump by function,
    the anonymous namespace's file hash removed, and keeps instructions
    without their addresses (how HTSAT-base's kernels were held to the
    parent's code on the card)."""
    import subprocess

    from audio_metrics_tpu_torch import sass_diff

    dump = """
\tFunction : _ZN46_GLOBAL__N__1de36ed9_13_swin_block_cu_a4dac7ef18window_attn_kernelILi24EEEvPKf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                       /* 0x0000000000007919 */
\t\tFunction : _ZN46_GLOBAL__N__0badc0de_11_frontend_cu_0badc0de21am_clap_frontend_helperEv
        /*0000*/                   EXIT ;                                   /* 0x000000000000794d */
"""
    monkeypatch.setattr(sass_diff, "_tool", lambda name: name)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a, 0, stdout=dump, stderr=""))
    got = sass_diff.functions("lib.so")
    assert got == {
        "_ZN46ANON18window_attn_kernelILi24EEEvPKf": ["MOV R1, c[0x0][0x28] ; /* 0x00000a00ff017b82 */",
                                                      "S2R R0, SR_TID.X ; /* 0x0000000000007919 */"],
        "_ZN46ANON21am_clap_frontend_helperEv": ["EXIT ; /* 0x000000000000794d */"],
    }


def _params(ccfg):
    """Seeded weights with nontrivial biases, bias tables and norms
    (tests/test_torch_slice.py's)."""
    rng = np.random.default_rng(1)
    p = init_params(ccfg, seed=0)
    p.update(init_projection_params(ccfg, seed=0))
    for k in p:
        if k.endswith(".bias") or "bias_table" in k:
            p[k] = rng.normal(scale=0.1, size=p[k].shape).astype(np.float32)
    p["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    return p


def _clips(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(5 * SR) / SR
    tone = np.sin(2 * np.pi * rng.uniform(100, 2000, size=(n, 1)) * t)
    return (0.1 * rng.standard_normal((n, 5 * SR)) + 0.2 * tone).astype(np.float32)


@pytest.fixture(scope="module")
def narrow():
    ccfg = HTSATConfig(**NARROW)
    return ccfg, _params(ccfg), _clips(0, 6), _clips(1, 6)


def _both(narrow, compute_dtype):
    ccfg, p, ref, cand = narrow
    metrics = ["fad", "kd", "prdc"]
    jam = JaxAudioMetrics(
        metrics=metrics, embedder=JaxLaionCLAP(params=p, cfg=JaxHTSATConfig(**NARROW),
                                               compute_dtype=compute_dtype),
        win_dur=5.0, input_sr=SR, batch_size=4, device_indices=[0],
    )
    jam.add_reference(jnp.asarray(ref))
    want = jam.evaluate(jnp.asarray(cand))
    am = AudioMetrics(
        metrics=metrics, embedder=LaionCLAP(params=p, cfg=ccfg, compute_dtype=compute_dtype,
                                            device="cpu"),
        win_dur=5.0, input_sr=SR, batch_size=4, device="cpu",
    )
    am.add_reference(torch.from_numpy(ref))
    got = am.evaluate(cand)
    return (got, am.stem_reference.embeddings.float().numpy(), want,
            np.asarray(jam.stem_reference.embeddings, np.float32))


def test_tiny_slice_f32_matches_jax(narrow):
    """f32, heads of 24: tests/test_torch_slice.py's bounds, embeddings
    atol 1e-6, FAD rel 1e-5, KD abs 1e-7; PRDC equal (6 + 6 clips whose
    embeddings agree to ~1e-7: no near-tie at these radii)."""
    got, e_got, want, e_want = _both(narrow, None)
    np.testing.assert_allclose(e_got, e_want, atol=1e-6)
    assert set(got) == set(want)
    assert all(np.isfinite(v) for v in got.values())
    assert got["fad"] == pytest.approx(want["fad"], rel=1e-5)
    for k in ("kernel_distance_mean", "kernel_distance_std"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-7), k
    for k in ("precision", "recall", "density", "coverage"):
        assert got[k] == want[k], k


def test_tiny_slice_bf16_close_to_jax(narrow):
    """bf16, heads of 24: every embedding within cosine 0.995 of the JAX
    package's bf16 one and of the port's own f32 one (tests/
    test_torch_slice.py's bf16 bound, the JAX suite's, tests/
    test_models.py:318); finite metrics with the JAX package's keys."""
    ccfg, p, ref, _ = narrow
    got, e_got, want, e_want = _both(narrow, "bfloat16")
    assert set(got) == set(want)
    assert all(np.isfinite(v) for v in got.values())
    unit = lambda e: e / np.linalg.norm(e, axis=1, keepdims=True)
    assert np.all((unit(e_got) * unit(e_want)).sum(axis=1) > 0.995)
    e32 = LaionCLAP(params=p, cfg=ccfg, device="cpu").embed(torch.from_numpy(ref)).numpy()
    assert np.all((unit(e_got) * unit(e32)).sum(axis=1) > 0.995)
