"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance (bf16 kernel vs bf16 plain version on the same inputs): both
round at the same points and differ in f32 summation order only, so a
value differs by the odd bf16 rounding flip (2^-8 relative) and what it
propagates.  The bounds are those of ``chip_smoke.py`` (readings in
PERF.md): mean abs error at most ``REL_MEAN`` of the mean size of what the
kernel adds (out - x for the residual Swin block, the output for the
merge), max abs error at most ``MAX_ABS``.  The weights put every matrix
at std 1/sqrt(fan_in), so both halves of a block move its output by O(1)
and a wrong roll, window map or mask cannot hide under the residual.

The kernels redesigned on the wgmma GEMM core (the whole block, the patch
merge and the frontend) are also held at the main path's batch of 64 and
at a ragged batch of 3, and must repeat bitwise on the same inputs.

The PRDC kernels (f32): radii rtol 1e-4, atol 1e-5 against the plain
version (the JAX suite's kernel-vs-XLA bound); the booleans and counts
equal except where a float64 recomputation shows a pair within 1e-5
relative of its radius (``testing.stats_mismatches``).  The log-mel
kernels, the split block's kernels (v3 and v1 attention halves, the fused
MLP; the v3 half and the MLP on the operands the block holds from load,
and the two in turn against the whole block) and the two opt-in ops (the
v2 attention half, the int8 MLP): the bounds of ``chip_smoke.py``.  The v2 half on v1's operands laid side by
side runs v1's launches: equal outputs.  The v1 log-mel runs the halo
log-mel's DFT + mel kernel over its frame matrix: equal outputs where both
run (hop % 8 == 0).  Their f32 kernels (the f32
block's launches, products as three TF32 products) against their f32
plain versions in full f32 under the f32 block's bounds at each stage, at
B = 4 and a ragged B = 3, with bitwise repeats; the v3 half then the MLP
equal the whole f32 block bitwise (the same launches); the f32 MLP also at
the row counts that reach the edges of its products' schedule
(``testing.mlp_f32_edge_rows``).  The int8 MLP in
f32: the bf16 int8 kernel's bounds.  The int8 MLP in both dtypes reads its
weights' codes held from load (``mlp_int8_operands``), repeats bitwise, and
equals the call that quantises them itself; at a ragged row count and at C
= 64 (half a K step of codes) its rows equal those of a longer call.

Last, the mesh on a card: an ``AudioMetrics`` without ``device_indices``
runs on the card its ``device`` names, and the host-fed path over two
shards of one card (host threads, where grad mode is on) records no graph
for an embedder whose weight requires grad.
"""

import numpy as np
import pytest
import torch

from audio_metrics_tpu_torch.kernels import KERNELS
from audio_metrics_tpu_torch.models.clap import SAMPLE_RATE, ClapFrontend
from audio_metrics_tpu_torch.models.htsat import (
    HTSAT_BASE,
    HTSAT_TINY,
    PatchMerge,
    SwinBlock,
    _Folded,
    _mlp_weights,
    _v2_kernel_weights,
    init_params,
)
from audio_metrics_tpu_torch.ops.attention import (
    half_operands,
    swin_attention_half_v1,
    swin_attention_half_v1_plain,
    swin_attention_half_v2,
    swin_attention_half_v2_plain,
    swin_attention_half_v3,
    swin_attention_half_v3_plain,
    swin_block,
    swin_block_operands,
)
from audio_metrics_tpu_torch.ops.distance import (
    knn_radii,
    knn_radii_plain,
    pairwise_stats,
    pairwise_stats_plain,
)
from audio_metrics_tpu_torch.ops.frontend_fused import clap_tokens_fused, clap_tokens_fused_plain
from audio_metrics_tpu_torch.ops.mel import (
    log_mel_halo,
    log_mel_halo_plain,
    log_mel_v1,
    log_mel_v1_plain,
    mel_filter_bank,
)
from audio_metrics_tpu_torch.ops.merge import merge_weight_t, patch_merge
from audio_metrics_tpu_torch.ops.mlp import (
    mlp_block,
    mlp_block_int8,
    mlp_block_int8_plain,
    mlp_int8_operands,
    mlp_block_plain,
    mlp_operands,
)
from audio_metrics_tpu_torch.testing import (
    mlp_f32_edge_rows,
    near_duplicate_rows,
    stats_mismatches,
)
from audio_metrics_tpu_torch.utils.precision import full_f32

cfg = HTSAT_BASE
pytestmark = pytest.mark.cuda
# (REL_MEAN, MAX_ABS) per kernel, as in chip_smoke.py; the Swin block's
# relative bound is per stage (its error grows with the stage's width)
SWIN_REL = (2e-4, 5e-4, 1.5e-3, 3.5e-3)
SWIN_MAX = 0.0625
MERGE_TOL = (1e-5, 0.03125)
FRONTEND_TOL = (4e-3, 0.0625)
# log-mel (mean abs error / mean |out|, max abs error) per convention
LOG_MEL_TOL = {"clap": (1e-5, 0.25), "vggish": (1e-6, 3e-5)}
# the split block: (REL_MEAN per stage, MAX_ABS), as in chip_smoke.py
ATTN_V3_TOL = ((4e-5, 1e-4, 2.5e-4, 5e-4), 0.0625)
ATTN_V1_TOL = ((1e-4, 2e-4), 0.0625)
MLP_TOL = ((1e-5, 2.5e-5, 6e-5, 1.2e-4), 0.0625)
# the bf16 v3 half then the MLP against the whole block, as in chip_smoke.py
SPLIT_VS_WHOLE_TOL = (1e-2, 0.25)
# the opt-in ops, as in chip_smoke.py
ATTN_V2_TOL = ((1e-4, 2e-4, 5e-4, 1e-3), 0.0625)
MLP_INT8_TOL = ((2.5e-6, 5e-6, 7e-6, 7e-6), 0.0625)
# the int8 MLP's branch (out - x) against the plain version's at a few
# hundred rows, relative Frobenius: a code flipped at a half moves its row's
# products by one quantisation step, which a mean over few rows does not
# absorb; the bound of tests/test_torch_opt_in.py (INT8_VS_JAX)
MLP_INT8_FROB = 2e-3
# the f32 whole block (REL_MEAN per stage, MAX_ABS) and merge against their
# f32 plain versions (the same arithmetic, the products as three TF32
# products on the tensor cores, f32-level accuracy): as in chip_smoke.py
SWIN_F32_TOL = ((1e-6, 2e-6, 2.5e-6, 4e-6), 5e-5)
MERGE_F32_TOL = (3e-6, 3e-5)


@pytest.fixture(scope="module")
def params():
    """HTSAT-base random weights: matrices at std 1/sqrt(fan_in),
    nontrivial biases, bias tables, LayerNorm and BatchNorm affines."""
    rng = np.random.default_rng(0)
    p = init_params(cfg, seed=0)
    for k, v in p.items():
        if k.endswith(".bias") or "bias_table" in k:
            p[k] = rng.normal(scale=0.5, size=v.shape).astype(np.float32)
        elif v.ndim == 2:  # (out, in) linear weights
            p[k] = rng.normal(scale=v.shape[1] ** -0.5, size=v.shape).astype(np.float32)
        elif k.endswith(".weight") and "norm" in k:
            p[k] = (1.0 + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
    p["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 3.0, 64).astype(np.float32)
    return p


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, signal, rel_mean, max_abs):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    rel = err.mean().item() / signal.float().abs().mean().item()
    assert rel <= rel_mean, rel
    assert err.max().item() <= max_abs, err.max().item()


@pytest.mark.parametrize(
    "stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)]
)
def test_swin_block_kernel_matches_plain(cuda, params, stage, shift):
    res = cfg.grid_size // 2**stage
    c = cfg.embed_dim * 2**stage
    block = SwinBlock(
        params, f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}", cfg, res,
        shift, cfg.num_heads[stage], torch.bfloat16,
    ).to(cuda)
    rng = np.random.default_rng(stage + shift)
    x = torch.from_numpy(rng.normal(size=(2, res * res, c)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    before = KERNELS["swin_block"].launches
    got = block(x)
    torch.cuda.synchronize()
    assert KERNELS["swin_block"].launches == before + 1
    want = block(x, plain=True)
    _close(got, want, want.float() - x.float(), SWIN_REL[stage], SWIN_MAX)


@pytest.mark.parametrize("b", [64, 3])
@pytest.mark.parametrize(
    "stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)]
)
def test_swin_block_sm90_core(cuda, params, stage, shift, b):
    """The whole block's wgmma products at the main path's batch (B = 64:
    M = 262144, 65536, 16384, 4096 rows) and at a ragged B = 3 (M = 3 *
    R^2, at stage 3 192 rows: one and a half 128-row tiles) against the
    plain version; a second run on the same inputs is bitwise equal (the
    core has no atomics: a race in its TMA ring would differ)."""
    res = cfg.grid_size // 2**stage
    c = cfg.embed_dim * 2**stage
    block = SwinBlock(
        params, f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}", cfg, res,
        shift, cfg.num_heads[stage], torch.bfloat16,
    ).to(cuda)
    x = _x(cuda, 100 + stage + shift + b, (b, res * res, c))
    got = block(x)
    again = block(x)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = block(x, plain=True)
    _close(got, want, want.float() - x.float(), SWIN_REL[stage], SWIN_MAX)


def test_swin_block_needs_kernel_operands(cuda, params):
    """On the card the whole block reads the transposed matrices and column
    sums made at load; a call without them raises, with them it launches."""
    block = SwinBlock(params, "audio_encoder.layers.2.blocks.1", cfg, 16, 4, 16,
                      torch.bfloat16).to(cuda)
    x = _x(cuda, 110, (1, 16, 16, 512))
    args = (x, block.wqkv, block.bq3, block.wp, block.bp, block.bm, block.ln2_w, block.ln2_b,
            block.w1, block.b1, block.w2, block.b2)
    geo = dict(heads=block.heads, window=block.window, shift=block.shift, eps=block.eps)
    with pytest.raises(ValueError):
        swin_block(*args, **geo)
    got = swin_block(*args, **geo, operands=swin_block_operands(block.wqkv, block.wp, block.w1,
                                                                 block.w2))
    torch.cuda.synchronize()
    assert torch.equal(got, block(x.view(1, 256, 512)).view(got.shape))


@pytest.mark.parametrize("b", [64, 3])
def test_frontend_sm90_core(cuda, params, b):
    """The frontend's DFT, interp and patch products on the wgmma core at
    the main path's batch and at a ragged B = 3 (patch rows 768), against
    the plain version; a second run is bitwise equal."""
    fr = ClapFrontend(params, cfg).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(21 + b)
    audio = 0.2 * torch.randn((b, 5 * SAMPLE_RATE), generator=g, device=cuda)
    before = KERNELS["clap_frontend"].launches
    got = clap_tokens_fused(audio, fr, sr=SAMPLE_RATE, cfg=cfg)
    again = clap_tokens_fused(audio, fr, sr=SAMPLE_RATE, cfg=cfg)
    torch.cuda.synchronize()
    assert KERNELS["clap_frontend"].launches == before + 2
    assert torch.equal(got, again)
    want = clap_tokens_fused_plain(audio, fr, sr=SAMPLE_RATE, cfg=cfg)
    _close(got, want, want, *FRONTEND_TOL)


@pytest.mark.parametrize("b", [4, 3])
@pytest.mark.parametrize(
    "stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)]
)
def test_swin_block_f32_kernel_matches_plain(cuda, params, stage, shift, b):
    """The f32 whole block (3xTF32 products, f32 window attention) against
    the f32 plain version in full f32, at B = 4 and a ragged B = 3; a second
    run is bitwise equal (no atomics)."""
    res = cfg.grid_size // 2**stage
    c = cfg.embed_dim * 2**stage
    block = SwinBlock(
        params, f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}", cfg, res,
        shift, cfg.num_heads[stage], torch.float32,
    ).to(cuda)
    x = _x(cuda, 140 + stage + shift + b, (b, res * res, c)).float()
    before = KERNELS["swin_block_f32"].launches
    got = block(x)
    again = block(x)
    torch.cuda.synchronize()
    assert KERNELS["swin_block_f32"].launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    with full_f32():
        want = block(x, plain=True)
    _close(got, want, want - x, SWIN_F32_TOL[0][stage], SWIN_F32_TOL[1])


@pytest.mark.parametrize("b", [4, 3])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_patch_merge_f32_kernel_matches_plain(cuda, params, stage, b):
    """The f32 merge (statistics pass, 3xTF32 product with A read from the
    quadrants through the 4-D map) against the f32 plain version; bitwise
    repeats."""
    res = cfg.grid_size // 2**stage
    c = cfg.embed_dim * 2**stage
    merge = PatchMerge(
        params, f"audio_encoder.layers.{stage}.downsample", cfg, res, torch.float32
    ).to(cuda)
    x = _x(cuda, 150 + stage + b, (b, res * res, c)).float()
    before = KERNELS["patch_merge_f32"].launches
    got = merge(x)
    again = merge(x)
    torch.cuda.synchronize()
    assert KERNELS["patch_merge_f32"].launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    with full_f32():
        want = merge(x, plain=True)
    _close(got, want, want, *MERGE_F32_TOL)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_patch_merge_kernel_matches_plain(cuda, params, stage):
    res = cfg.grid_size // 2**stage
    c = cfg.embed_dim * 2**stage
    merge = PatchMerge(
        params, f"audio_encoder.layers.{stage}.downsample", cfg, res, torch.bfloat16
    ).to(cuda)
    rng = np.random.default_rng(10 + stage)
    x = torch.from_numpy(rng.normal(size=(2, res * res, c)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    got = merge(x)
    torch.cuda.synchronize()
    want = merge(x, plain=True)
    _close(got, want, want, *MERGE_TOL)


@pytest.mark.parametrize("b", [64, 3])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_patch_merge_sm90_core(cuda, params, stage, b):
    """The merge's product on the wgmma core, A through its 4-D tensor map,
    at the main path's batch (M = 65536, 16384, 4096 rows) and at a ragged
    B = 3 (at merge 2, 192 rows: a tile and a half), against the plain
    version; a second run on the same inputs is bitwise equal."""
    res = cfg.grid_size // 2**stage
    c = cfg.embed_dim * 2**stage
    merge = PatchMerge(
        params, f"audio_encoder.layers.{stage}.downsample", cfg, res, torch.bfloat16
    ).to(cuda)
    x = _x(cuda, 120 + stage + b, (b, res * res, c))
    before = KERNELS["patch_merge"].launches
    got = merge(x)
    again = merge(x)
    torch.cuda.synchronize()
    assert KERNELS["patch_merge"].launches == before + 2
    assert torch.equal(got, again)
    want = merge(x, plain=True)
    _close(got, want, want, *MERGE_TOL)


def test_patch_merge_needs_the_k_major_weight(cuda, params):
    merge = PatchMerge(params, "audio_encoder.layers.2.downsample", cfg, 16,
                       torch.bfloat16).to(cuda)
    x = _x(cuda, 130, (1, 256, 512))
    args = (x, merge.wg, merge.svec, merge.tvec)
    with pytest.raises(ValueError):
        patch_merge(*args, h=16, w=16, eps=merge.eps)
    got = patch_merge(*args, h=16, w=16, eps=merge.eps, wg_t=merge_weight_t(merge.wg))
    torch.cuda.synchronize()
    assert torch.equal(got, merge(x))


def test_frontend_kernel_matches_plain(cuda, params):
    """Bound of tests/test_frontend_fused.py:139-143 (kernel vs unfused
    chain, mean < 0.01, max < 0.12), and the relative bound of
    ``chip_smoke.py``."""
    fr = ClapFrontend(params, cfg).to(cuda)
    rng = np.random.default_rng(20)
    audio = torch.from_numpy((0.2 * rng.normal(size=(2, 5 * SAMPLE_RATE))).astype(np.float32))
    audio = audio.to(cuda)
    got = clap_tokens_fused(audio, fr, sr=SAMPLE_RATE, cfg=cfg)
    torch.cuda.synchronize()
    want = clap_tokens_fused_plain(audio, fr, sr=SAMPLE_RATE, cfg=cfg)
    err = (got.float() - want.float()).abs()
    assert err.mean().item() < 0.01 and err.max().item() < 0.12, (err.mean(), err.max())
    _close(got, want, want, *FRONTEND_TOL)


def test_kernels_raise_on_f32(cuda, params):
    """A CUDA tensor launches the kernel for its dtype or raises: no silent
    plain path and no cast.  f32 now has kernels of its own (the whole block
    and the merge): f32 launches the f32 kernel; f16 has none and raises."""
    merge = PatchMerge(params, "audio_encoder.layers.2.downsample", cfg, 16,
                       torch.float32).to(cuda)
    x = torch.zeros((1, 256, 512), device=cuda)
    before = KERNELS["patch_merge_f32"].launches
    out = merge(x)
    torch.cuda.synchronize()
    assert KERNELS["patch_merge_f32"].launches == before + 1 and out.dtype == torch.float32
    with pytest.raises(NotImplementedError):
        merge(x.half())


def _embeddings(cuda, n, m, d, seed):
    """Seeded Gaussian sets, reference N(0, I) and candidate 0.05 + 1.02
    N(0, I): at d = 512 every PRDC metric then lies inside (0, 1)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    ref = torch.randn((n, d), generator=g, device=cuda)
    return ref, 0.05 + 1.02 * torch.randn((m, d), generator=g, device=cuda)


@pytest.mark.parametrize("n,k", [(2048, 10), (1237, 10), (300, 3)])
def test_knn_radii_kernel_matches_plain(cuda, n, k):
    x, _ = _embeddings(cuda, n, 1, 512, seed=n)
    before = KERNELS["knn_radii"].launches
    got = knn_radii(x, k)
    torch.cuda.synchronize()
    assert KERNELS["knn_radii"].launches == before + 1
    torch.testing.assert_close(got, knn_radii_plain(x, k), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [2048, 1237, 300, 20480])
@pytest.mark.parametrize("k", [4, 11, 128])
def test_knn_radii_split_kernel(cuda, n, k):
    """The column-split kernel at list lengths k = nearest_k + 1 of
    4, 11 (the main path's) and 128 (the widest), with every fifth row
    duplicated (two rows at distance ~0: the k-th is still a genuine
    neighbour); at N = 20480 four splits of 40 tiles."""
    x, _ = _embeddings(cuda, n, 1, 512, seed=n + k)
    x[1::5] = x[0::5][: x[1::5].shape[0]]
    before = KERNELS["knn_radii"].launches
    got = knn_radii(x, k - 1)
    torch.cuda.synchronize()
    assert KERNELS["knn_radii"].launches == before + 1
    torch.testing.assert_close(got, knn_radii_plain(x, k - 1), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("group,noise,k", [(8, 1e-2, 4), (8, 1e-2, 11), (8, 3e-3, 4),
                                           (2048, 3e-3, 11)])
def test_knn_radii_split_kernel_small_radii(cuda, group, noise, k):
    """Unit rows in groups of 8 near-duplicates (at k = 4 the radius is a
    near-duplicate's, ~0.3 at noise 1e-2, ~0.1 at noise 3e-3) and in one
    tight cluster (radii ~0.09, like the main path's embeddings): there
    |a|^2 + |b|^2 - 2 a.b cancels, and a dot product rounded otherwise than
    the plain version's moves radii out of the bound."""
    x = near_duplicate_rows(2048, 512, seed=5, group=group, noise=noise)
    torch.testing.assert_close(knn_radii(x, k - 1), knn_radii_plain(x, k - 1), rtol=1e-4,
                               atol=1e-5)


def test_launch_on_the_operands_card(cuda):
    """Operands on cuda:0 while another card is current: the kernel runs on
    cuda:0, on its stream, and agrees with the plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a launch on the operands' card while another is "
                    "current (tests/test_torch_faults.py pins the guard on the CPU)")
    x, _ = _embeddings(torch.device("cuda", 0), 1237, 1, 512, seed=7)
    with torch.cuda.device(1):
        got = knn_radii(x, 10)
    torch.cuda.synchronize(0)
    assert got.device == torch.device("cuda", 0)
    torch.testing.assert_close(got, knn_radii_plain(x, 10), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,m", [(2048, 2048), (1000, 1237)])
def test_pairwise_stats_kernel_matches_plain(cuda, n, m):
    ref, cand = _embeddings(cuda, n, m, 512, seed=n + m)
    rr, cr = knn_radii_plain(ref, 10), knn_radii_plain(cand, 10)
    before = KERNELS["prdc_stats"].launches
    got = pairwise_stats(ref, cand, rr, cr)
    torch.cuda.synchronize()
    assert KERNELS["prdc_stats"].launches == before + 1
    want = pairwise_stats_plain(ref, cand, rr, cr)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    n_diff, bad = stats_mismatches(ref, cand, got, want, (rr, cr))
    assert bad == 0, f"{bad} of {n_diff} differing elements are not near-ties"
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-6)
    assert 0 < got[0].float().mean() < 1 and 0 < got[2].float().mean() < 1


def test_pairwise_stats_kernel_same_set(cuda):
    x, _ = _embeddings(cuda, 1500, 1, 512, seed=5)
    r = knn_radii(x, 10)
    cand_any, _, ref_any, ref_min = pairwise_stats(x, x, r, r)
    assert bool(cand_any.all()) and bool(ref_any.all()) and bool((ref_min < r).all())


@pytest.mark.parametrize("conv", ["clap", "vggish"])
def test_log_mel_kernel_matches_plain(cuda, params, conv):
    """CLAP: 10 s clips, centered, dB, the BatchNorm affine and bf16 out;
    VGGish: 400-sample frames (K < n_fft), uncentered, natural log, f32."""
    g = torch.Generator(device=cuda).manual_seed(30)
    if conv == "clap":
        fr = ClapFrontend(params, cfg).to(cuda)
        fb = mel_filter_bank(513, 64, 50.0, 14000.0, SAMPLE_RATE, norm="slaney",
                             mel_scale="slaney").astype(np.float32)
        kw = dict(frame_length=1024, hop_length=480, n_fft=1024, fb=fb, center=True,
                  log_mode="db", out_affine=(fr.bn_scale, fr.bn_offset), out_dtype=torch.bfloat16)
        audio = 0.2 * torch.randn((2, 10 * SAMPLE_RATE), generator=g, device=cuda)
    else:
        fb = mel_filter_bank(257, 64, 125.0, 7500.0, 16000, norm=None, mel_scale="htk",
                             triangle_domain="mel", zero_dc=True).astype(np.float32)
        kw = dict(frame_length=400, hop_length=160, n_fft=512, fb=fb, center=False,
                  log_mode="natural")
        audio = 0.2 * torch.randn((2, 3 * 16000 + 77), generator=g, device=cuda)
    before = KERNELS["log_mel"].launches
    got = log_mel_halo(audio, **kw)
    torch.cuda.synchronize()
    assert KERNELS["log_mel"].launches == before + 1
    want = log_mel_halo_plain(audio, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got, want, want, *LOG_MEL_TOL[conv])


@pytest.mark.parametrize("seconds,b", [(10, 64), (7, 3)])
def test_log_mel_sm90_core(cuda, params, seconds, b):
    """The halo log-mel on the wgmma core at the 10 s path's batch and on
    ragged 7 s clips (701 frames: a last row tile of 61 rows), CLAP
    convention, against the plain version; a second run is bitwise equal
    (no atomics)."""
    fr = ClapFrontend(params, cfg).to(cuda)
    fb = mel_filter_bank(513, 64, 50.0, 14000.0, SAMPLE_RATE, norm="slaney",
                         mel_scale="slaney").astype(np.float32)
    kw = dict(frame_length=1024, hop_length=480, n_fft=1024, fb=fb, center=True, log_mode="db",
              out_affine=(fr.bn_scale, fr.bn_offset), out_dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(31 + b)
    audio = 0.2 * torch.randn((b, seconds * SAMPLE_RATE), generator=g, device=cuda)
    got, again = log_mel_halo(audio, **kw), log_mel_halo(audio, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = log_mel_halo_plain(audio, **kw)
    assert got.shape == want.shape == (b, seconds * 100 + 1, 64)
    _close(got, want, want, *LOG_MEL_TOL["clap"])


@pytest.mark.parametrize("n,m", [(10000, 12345), (512, 512)])
def test_pairwise_stats_split_kernel(cuda, n, m):
    """The statistics on #4's product loop where the columns split into
    several runs of tiles, ragged against them (10000 x 12345), and where
    each split is one tile (512 x 512)."""
    ref, cand = _embeddings(cuda, n, m, 512, seed=n + m + 1)
    rr, cr = knn_radii_plain(ref, 10), knn_radii_plain(cand, 10)
    got = pairwise_stats(ref, cand, rr, cr)
    want = pairwise_stats_plain(ref, cand, rr, cr)
    n_diff, bad = stats_mismatches(ref, cand, got, want, (rr, cr))
    assert bad == 0, f"{bad} of {n_diff} differing elements are not near-ties"
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=1e-6)


def _half_block(params, cuda, stage, shift, attention, dtype=torch.bfloat16):
    res = cfg.grid_size // 2**stage
    return SwinBlock(
        params, f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}", cfg, res, shift,
        cfg.num_heads[stage], dtype, attention=attention,
    ).to(cuda), res


def _x(cuda, seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, torch.bfloat16)


@pytest.mark.parametrize(
    "stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)]
)
def test_attention_v3_kernel_matches_plain(cuda, params, stage, shift):
    b, res = _half_block(params, cuda, stage, shift, "v3")
    x = _x(cuda, 40 + stage + shift, (2, res, res, b.wp.shape[0]))
    args = (x, b.wqkv, b.bq3, b.wp, b.bp, b.bm)
    geo = dict(heads=b.heads, window=b.window, shift=b.shift, eps=b.eps)
    before = KERNELS["swin_attn_v3"].launches
    got = swin_attention_half_v3(*args, **geo, operands=b.kernel_operands())
    torch.cuda.synchronize()
    assert KERNELS["swin_attn_v3"].launches == before + 1
    want = swin_attention_half_v3_plain(*args, **geo)
    _close(got, want, want.float() - x.float(), ATTN_V3_TOL[0][stage], ATTN_V3_TOL[1])


@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4)])
def test_attention_v1_kernel_matches_plain(cuda, params, stage, shift):
    b, res = _half_block(params, cuda, stage, shift, "v1")
    x = _x(cuda, 50 + stage + shift, (2, res, res, b.bp.shape[0]))
    args = (x, b.ln1_w, b.ln1_b, b.wq, b.bq, b.wk, b.wv, b.wp, b.bp, b.bm)
    geo = dict(heads=b.heads, window=b.window, shift=b.shift, eps=b.eps)
    before = KERNELS["swin_attn_v1"].launches
    got = swin_attention_half_v1(*args, **geo, operands=b.kernel_operands())
    torch.cuda.synchronize()
    assert KERNELS["swin_attn_v1"].launches == before + 1
    want = swin_attention_half_v1_plain(*args, **geo)
    _close(got, want, want.float() - x.float(), ATTN_V1_TOL[0][stage], ATTN_V1_TOL[1])


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_mlp_kernel_matches_plain(cuda, params, stage):
    """At 2 images: 8192, 2048, 512 and 128 rows (ragged against nothing;
    the row tile is 64)."""
    b, res = _half_block(params, cuda, stage, 0, "v3")
    x = _x(cuda, 60 + stage, (2, res * res, b.w2.shape[1]))
    mlp = (b.ln2_w, b.ln2_b, b.w1, b.b1, b.w2, b.b2)
    before = KERNELS["swin_mlp"].launches
    got = mlp_block(x, *mlp, eps=b.eps, operands=b.kernel_operands())
    torch.cuda.synchronize()
    assert KERNELS["swin_mlp"].launches == before + 1
    want = mlp_block_plain(x, *mlp, eps=b.eps)
    _close(got, want, want.float() - x.float(), MLP_TOL[0][stage], MLP_TOL[1])


@pytest.mark.parametrize(
    "stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)]
)
def test_split_kernels_match_whole_block(cuda, params, stage, shift):
    """#8 then #9 in bf16 against #1 bf16 on the same weights and inputs:
    the same launches but for the bf16 rounding of the mid-block residual
    (the whole block keeps it f32), within ``SPLIT_VS_WHOLE_TOL``."""
    b, res = _half_block(params, cuda, stage, shift, "v3")
    x = _x(cuda, 110 + stage + shift, (2, res, res, b.bp.shape[0]))
    attn = (b.wqkv, b.bq3, b.wp, b.bp, b.bm)
    mlp = (b.ln2_w, b.ln2_b, b.w1, b.b1, b.w2, b.b2)
    geo = dict(heads=b.heads, window=b.window, shift=b.shift, eps=b.eps)
    ops = b.kernel_operands()
    half = swin_attention_half_v3(x, *attn, **geo, operands=ops)
    split = mlp_block(half.view(2, res * res, -1), *mlp, eps=b.eps, operands=ops)
    whole = swin_block(x, *attn, *mlp, **geo, operands=ops)
    torch.cuda.synchronize()
    _close(split.view(whole.shape), whole, whole.float() - x.float(), *SPLIT_VS_WHOLE_TOL)


def _mel_case(params, cuda, conv, b=2, seed=31):
    """(arguments, audio) of a log-mel check: CLAP (10 s, 7 s, or 10 s at
    hop 484; centered, dB, the BatchNorm affine and bf16 out) or VGGish
    (400-sample frames, uncentered, natural log, f32)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if conv.startswith("clap"):
        fr = ClapFrontend(params, cfg).to(cuda)
        fb = mel_filter_bank(513, 64, 50.0, 14000.0, SAMPLE_RATE, norm="slaney",
                             mel_scale="slaney").astype(np.float32)
        kw = dict(frame_length=1024, hop_length=484 if conv.endswith("484") else 480,
                  n_fft=1024, fb=fb, center=True, log_mode="db",
                  out_affine=(fr.bn_scale, fr.bn_offset), out_dtype=torch.bfloat16)
        seconds = 7 if conv == "clap 7 s" else 10
        return kw, 0.2 * torch.randn((b, seconds * SAMPLE_RATE), generator=g, device=cuda)
    fb = mel_filter_bank(257, 64, 125.0, 7500.0, 16000, norm=None, mel_scale="htk",
                         triangle_domain="mel", zero_dc=True).astype(np.float32)
    kw = dict(frame_length=400, hop_length=160, n_fft=512, fb=fb, center=False,
              log_mode="natural")
    return kw, 0.2 * torch.randn((b, 3 * 16000 + 77), generator=g, device=cuda)


@pytest.mark.parametrize("conv", ["clap", "vggish", "clap 7 s", "clap hop 484"])
def test_log_mel_v1_kernel_matches_plain(cuda, params, conv):
    """The v1 log-mel: the halo test's inputs and bounds, CLAP 7 s clips
    (701 frames a clip: tiles span clips) and CLAP at hop 484 (which the
    halo kernel takes in padded hop rows); one launch a call."""
    kw, audio = _mel_case(params, cuda, conv)
    before = KERNELS["log_mel_v1"].launches
    got = log_mel_v1(audio, **kw)
    torch.cuda.synchronize()
    assert KERNELS["log_mel_v1"].launches == before + 1
    want = log_mel_v1_plain(audio, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got, want, want, *LOG_MEL_TOL[conv.split()[0]])


@pytest.mark.parametrize("conv,b", [("clap", 64), ("vggish", 4)])
def test_log_mel_v1_kernel_equals_halo_kernel(cuda, params, conv, b):
    """Where both kernels run (hop % 8 == 0) they share the DFT + mel
    kernel, its tables and the bf16 frame values, and each row's sums
    depend on that row alone: the outputs are bitwise equal."""
    kw, audio = _mel_case(params, cuda, conv, b=b, seed=32)
    got, halo = log_mel_v1(audio, **kw), log_mel_halo(audio, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, halo)


def test_log_mels_raise_on_other_mel_counts(cuda):
    """Both kernels take any mel count (``test_log_mel_kernels_at_other_
    mel_counts``) but none: a filterbank of no mel bins raises
    ``NotImplementedError`` and launches nothing."""
    fb = np.zeros((513, 0), np.float32)
    audio = torch.zeros((1, 48000), device=cuda)
    before = {k: KERNELS[k].launches for k in ("log_mel", "log_mel_v1")}
    for fn in (log_mel_halo, log_mel_v1):
        with pytest.raises(NotImplementedError, match="mel bins"):
            fn(audio, frame_length=1024, hop_length=480, n_fft=1024, fb=fb)
    assert {k: KERNELS[k].launches for k in before} == before


def test_new_kernels_raise_on_other_dtypes(cuda):
    x = torch.zeros((64, 16), dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError):
        knn_radii(x, 3)
    with pytest.raises(NotImplementedError):
        pairwise_stats(x, x, x[:, 0], x[:, 0])
    fb = mel_filter_bank(513, 64, 50.0, 14000.0, SAMPLE_RATE).astype(np.float32)
    with pytest.raises(NotImplementedError):
        log_mel_halo(torch.zeros((1, 48000), dtype=torch.bfloat16, device=cuda),
                     frame_length=1024, hop_length=480, n_fft=1024, fb=fb)
    with pytest.raises(NotImplementedError):
        log_mel_v1(torch.zeros((1, 48000), dtype=torch.bfloat16, device=cuda),
                   frame_length=1024, hop_length=480, n_fft=1024, fb=fb)


def test_split_kernels_raise_on_f32_and_cpu(cuda, params):
    """f32 launches each half's f32 kernel (one launch, f32 out) on the
    operands made at load, and raises without them; f16 raises; a CPU
    operand beside a CUDA one raises; nothing falls back to a plain
    version."""
    b, res = _half_block(params, cuda, 1, 4, "v3", torch.float32)
    v1, _ = _half_block(params, cuda, 1, 4, "v1", torch.float32)
    x = torch.zeros((1, res, res, b.bp.shape[0]), device=cuda)
    geo = dict(heads=b.heads, window=b.window, shift=b.shift, eps=b.eps)
    attn = (b.wqkv, b.bq3, b.wp, b.bp, b.bm)
    mlp = (b.ln2_w, b.ln2_b, b.w1, b.b1, b.w2, b.b2)
    a1 = (v1.ln1_w, v1.ln1_b, v1.wq, v1.bq, v1.wk, v1.wv, v1.wp, v1.bp, v1.bm)
    calls = {
        "swin_attn_v3_f32": lambda t, **o: swin_attention_half_v3(t, *attn, **geo, **o),
        "swin_mlp_f32": lambda t, **o: mlp_block(t.view(1, res * res, -1), *mlp, eps=b.eps, **o),
        "swin_attn_v1_f32": lambda t, **o: swin_attention_half_v1(t, *a1, **geo, **o),
    }
    for name, call in calls.items():
        ops = (v1 if name == "swin_attn_v1_f32" else b).kernel_operands()
        before = KERNELS[name].launches
        out = call(x, operands=ops)
        torch.cuda.synchronize()
        assert KERNELS[name].launches == before + 1 and out.dtype == torch.float32, name
        with pytest.raises(ValueError):  # the operands made at load are missing
            call(x)
        with pytest.raises(NotImplementedError):
            call(x.half(), operands=ops)
    bf, _ = _half_block(params, cuda, 1, 4, "v3")
    ops = dict(bf.kernel_operands(), wqkv_t=bf.kernel_operands()["wqkv_t"].cpu())
    with pytest.raises(ValueError):
        swin_attention_half_v3(x.bfloat16(), bf.wqkv, bf.bq3, bf.wp, bf.bp, bf.bm, **geo,
                               operands=ops)


def _v2_block(params, cuda, stage, shift, dtype=torch.bfloat16):
    """Block weights of ``stage`` in v2's layout (matrices in ``dtype``) and
    the f32 MLP weights the int8 op takes."""
    res = cfg.grid_size // 2**stage
    window = min(cfg.window_size, res)
    shift = 0 if res <= window else shift
    prefix = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
    w = _v2_kernel_weights(params, prefix, res, shift, cfg.num_heads[stage], window)
    v2 = _Folded(w, dtype).to(cuda)
    attn = (v2.ln1_w, v2.ln1_b, v2.wqkv, v2.bq3, v2.wp, v2.bp, v2.bm)
    mlp = _Folded(_mlp_weights(params, prefix), torch.float32).to(cuda)
    geo = dict(heads=cfg.num_heads[stage], window=window, shift=shift, eps=cfg.layer_norm_eps)
    return attn, (mlp.ln2_w, mlp.ln2_b, mlp.w1, mlp.b1, mlp.w2, mlp.b2), geo, res


@pytest.mark.parametrize(
    "stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)]
)
def test_attention_v2_kernel_matches_plain(cuda, params, stage, shift):
    attn, _, geo, res = _v2_block(params, cuda, stage, shift)
    x = _x(cuda, 70 + stage + shift, (2, res, res, attn[-2].shape[0]))
    before = KERNELS["swin_attn_v2"].launches
    got = swin_attention_half_v2(x, *attn, **geo, operands=half_operands(attn[2], attn[4]))
    torch.cuda.synchronize()
    assert KERNELS["swin_attn_v2"].launches == before + 1
    want = swin_attention_half_v2_plain(x, *attn, **geo)
    _close(got, want, want.float() - x.float(), ATTN_V2_TOL[0][stage], ATTN_V2_TOL[1])


@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4)])
def test_attention_v2_kernel_equals_v1_kernel(cuda, params, stage, shift):
    attn, _, geo, res = _v2_block(params, cuda, stage, shift)
    v1, _ = _half_block(params, cuda, stage, shift, "v1")
    x = _x(cuda, 80 + stage + shift, (2, res, res, v1.bp.shape[0]))
    got = swin_attention_half_v2(x, *attn, **geo, operands=half_operands(attn[2], attn[4]))
    want = swin_attention_half_v1(x, v1.ln1_w, v1.ln1_b, v1.wq, v1.bq, v1.wk, v1.wv, v1.wp,
                                  v1.bp, v1.bm, **geo, operands=v1.kernel_operands())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_mlp_int8_kernel_matches_plain(cuda, params, stage):
    """At 2 images: 8192, 2048, 512 and 128 rows, on the weights' codes
    held from load (``mlp_int8_operands``); a second call bitwise equal (the
    kernel's one atomic is an integer max), and so the call without them,
    which quantises the weights itself."""
    _, mlp, _, res = _v2_block(params, cuda, stage, 0)
    x = _x(cuda, 90 + stage, (2, res * res, mlp[-1].shape[0]))
    ops = mlp_int8_operands(mlp[2], mlp[4])
    before = KERNELS["swin_mlp_int8"].launches
    got = mlp_block_int8(x, *mlp, eps=cfg.layer_norm_eps, operands=ops)
    torch.cuda.synchronize()
    assert KERNELS["swin_mlp_int8"].launches == before + 1
    want = mlp_block_int8_plain(x, *mlp, eps=cfg.layer_norm_eps)
    _close(got, want, want.float() - x.float(), MLP_INT8_TOL[0][stage], MLP_INT8_TOL[1])
    assert torch.equal(got, mlp_block_int8(x, *mlp, eps=cfg.layer_norm_eps, operands=ops))
    assert torch.equal(got, mlp_block_int8(x, *mlp, eps=cfg.layer_norm_eps))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows,c", [(333, 64), (200, 128), (4101, 64)])
def test_mlp_int8_kernel_ragged_rows_and_narrow_width(cuda, dtype, rows, c):
    """M not a multiple of the 128-row tile, and C = 64, where fc1's K of 64
    codes is half a K step of 128 (the tensor maps zero-fill the rest): the
    rows equal the same rows of a call on 128 more rows bitwise (each row is
    quantised and summed on its own), and the branch lies within
    ``MLP_INT8_FROB`` of the plain version's."""
    rng = np.random.default_rng(rows + c)
    w = [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.normal(1.0, 0.1, c), rng.normal(0.0, 0.1, c),
        rng.normal(scale=c ** -0.5, size=(c, 4 * c)), rng.normal(size=4 * c),
        rng.normal(scale=(4 * c) ** -0.5, size=(4 * c, c)), rng.normal(size=c))]
    ops = mlp_int8_operands(w[2], w[4])
    x = torch.from_numpy(rng.normal(size=(rows + 128, c)).astype(np.float32)).to(cuda, dtype)
    got = mlp_block_int8(x[:rows].contiguous(), *w, eps=cfg.layer_norm_eps, operands=ops)
    longer = mlp_block_int8(x, *w, eps=cfg.layer_norm_eps, operands=ops)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, longer[:rows])
    want = mlp_block_int8_plain(x[:rows], *w, eps=cfg.layer_norm_eps)
    branch, branch_plain = (v.double() - x[:rows].double() for v in (got, want))
    rel = (torch.linalg.norm(branch - branch_plain) / torch.linalg.norm(branch_plain)).item()
    assert rel <= MLP_INT8_FROB, rel


def test_mlp_int8_kernel_rounds_halves_to_even(cuda, params):
    """With a zero LN weight the LN output is the LN bias: 127, then
    +-(k + 1/2), so sx = 1 and every quotient lies exactly halfway.  The
    kernel must round as its plain version (half to even): the same
    codes, so the same output."""
    _, mlp, _, res = _v2_block(params, cuda, 0, 0)
    x = _x(cuda, 99, (2, res * res, mlp[-1].shape[0]))
    c = x.shape[-1]
    k = torch.arange(1, c, device=cuda)
    ln_b = torch.cat([torch.tensor([127.0], device=cuda), ((k % 20) + 0.5) * (1 - 2 * (k % 2))])
    args = (torch.zeros_like(mlp[0]), ln_b.float(), *mlp[2:])
    got = mlp_block_int8(x, *args, eps=cfg.layer_norm_eps)
    want = mlp_block_int8_plain(x, *args, eps=cfg.layer_norm_eps)
    _close(got, want, want.float() - x.float(), MLP_INT8_TOL[0][0], MLP_INT8_TOL[1])


def test_opt_in_kernels_raise_on_f32_and_cpu(cuda, params):
    """f32 activations launch the f32 kernels (one launch each, f32 out; the
    v2 half on its ``half_operands``, raising without them); f16 raises; a
    CPU operand beside CUDA ones raises; bf16 MLP weights raise (the op
    takes f32 weights)."""
    attn, mlp, geo, res = _v2_block(params, cuda, 1, 4)
    a32 = _v2_block(params, cuda, 1, 4, torch.float32)[0]
    ops = half_operands(a32[2], a32[4])
    x = torch.zeros((1, res, res, attn[-2].shape[0]), device=cuda)
    before = KERNELS["swin_attn_v2_f32"].launches, KERNELS["swin_mlp_int8_f32"].launches
    a = swin_attention_half_v2(x, *a32, **geo, operands=ops)
    m = mlp_block_int8(x.view(1, res * res, -1), *mlp, eps=geo["eps"])
    torch.cuda.synchronize()
    assert (KERNELS["swin_attn_v2_f32"].launches, KERNELS["swin_mlp_int8_f32"].launches) == (
        before[0] + 1, before[1] + 1)
    assert a.dtype == m.dtype == torch.float32
    with pytest.raises(ValueError):
        swin_attention_half_v2(x, *a32, **geo)
    with pytest.raises(NotImplementedError):
        swin_attention_half_v2(x.half(), *a32, **geo, operands=ops)
    with pytest.raises(NotImplementedError):
        mlp_block_int8(x.view(1, res * res, -1).half(), *mlp, eps=geo["eps"])
    with pytest.raises(ValueError):
        swin_attention_half_v2(x.bfloat16(), attn[0].cpu(), *attn[1:], **geo,
                               operands=half_operands(attn[2], attn[4]))
    with pytest.raises(ValueError):
        mlp_block_int8(x.view(1, res * res, -1).bfloat16(), mlp[0].cpu(), *mlp[1:],
                       eps=geo["eps"])
    with pytest.raises(NotImplementedError):
        mlp_block_int8(x.view(1, res * res, -1).bfloat16(), *mlp[:2], mlp[2].bfloat16(),
                       *mlp[3:], eps=geo["eps"])


# ----------------------------------------------------------------------
# the f32 kernels of the split block and the opt-in ops
# ----------------------------------------------------------------------
F32_STAGE_SHIFTS = [(0, 0), (0, 4), (1, 0), (1, 4), (2, 0), (2, 4), (3, 0)]


def _f32_check(name, call, plain, x, stage, tol=SWIN_F32_TOL):
    """``call()`` launches ``name`` once a call, repeats bitwise, and lies
    within ``tol`` at ``stage`` of ``plain()`` in full f32."""
    before = KERNELS[name].launches
    got, again = call(), call()
    torch.cuda.synchronize()
    assert KERNELS[name].launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    with full_f32():
        want = plain()
    _close(got, want, want - x, tol[0][stage], tol[1])
    return got


@pytest.mark.parametrize("b", [4, 3])
@pytest.mark.parametrize("stage,shift", F32_STAGE_SHIFTS)
def test_attention_v3_f32_kernel_matches_plain(cuda, params, stage, shift, b):
    """#8 in f32; then the f32 MLP on its output equals the whole f32
    block bitwise (the same seven launches on the same values)."""
    blk, res = _half_block(params, cuda, stage, shift, "v3", torch.float32)
    x = _x(cuda, 160 + stage + shift + b, (b, res, res, blk.bp.shape[0])).float()
    geo = dict(heads=blk.heads, window=blk.window, shift=blk.shift, eps=blk.eps)
    attn = (blk.wqkv, blk.bq3, blk.wp, blk.bp, blk.bm)
    ops = blk.kernel_operands()
    half = _f32_check("swin_attn_v3_f32",
                      lambda: swin_attention_half_v3(x, *attn, **geo, operands=ops),
                      lambda: swin_attention_half_v3_plain(x, *attn, **geo), x, stage)
    mlp = (blk.ln2_w, blk.ln2_b, blk.w1, blk.b1, blk.w2, blk.b2)
    split = mlp_block(half.view(b, res * res, -1), *mlp, eps=blk.eps, operands=ops)
    whole = swin_block(x, *attn, *mlp, **geo, operands=ops)
    torch.cuda.synchronize()
    assert torch.equal(split.view(whole.shape), whole)


@pytest.mark.parametrize("b", [4, 3])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_mlp_f32_kernel_matches_plain(cuda, params, stage, b):
    blk, res = _half_block(params, cuda, stage, 0, "v3", torch.float32)
    x = _x(cuda, 170 + stage + b, (b, res * res, blk.bp.shape[0])).float()
    mlp = (blk.ln2_w, blk.ln2_b, blk.w1, blk.b1, blk.w2, blk.b2)
    ops = blk.kernel_operands()
    _f32_check("swin_mlp_f32", lambda: mlp_block(x, *mlp, eps=blk.eps, operands=ops),
               lambda: mlp_block_plain(x, *mlp, eps=blk.eps), x, stage)


EDGES = ["M < 64, one tile", "M < 128, one tile", "3 row tiles, the last of 20 rows",
         "one tile a block", "2 or 3 tiles a block"]


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("c", [96, 128])
def test_mlp_f32_kernel_at_schedule_edges(cuda, c, edge):
    """The f32 MLP at the row counts that reach the edges of its products'
    schedule (``testing.mlp_f32_edge_rows`` on this card's SM count: a
    partial last row tile in one consumer's half or both, one tile a block
    and 2 or 3; at C = 96 fc1's odd number of K steps): one launch a call,
    bitwise repeats, the f32 bounds of stage 0.
    The allocator's blocks of the call's sizes are filled with NaN first,
    so a tile that no warpgroup writes shows."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    m = mlp_f32_edge_rows(c, sms)[edge]
    rng = np.random.default_rng(c + len(edge))

    def t(*shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).to(cuda)

    w1, w2 = t(c, 4 * c, std=c**-0.5), t(4 * c, c, std=(4 * c) ** -0.5)
    mlp = (1.0 + t(c, std=0.1), t(c, std=0.5), w1, t(4 * c, std=0.5), w2, t(c, std=0.5))
    ops, x = mlp_operands(w1, w2), t(m, c)

    def call():
        poison = [torch.full((m, w), float("nan"), device=cuda) for w in (c, 4 * c, c)]
        del poison
        return mlp_block(x, *mlp, operands=ops)

    _f32_check("swin_mlp_f32", call, lambda: mlp_block_plain(x, *mlp), x, 0)


@pytest.mark.parametrize("b", [4, 3])
@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4)])
def test_attention_v1_f32_kernel_matches_plain(cuda, params, stage, shift, b):
    """#10 in f32 at the stages the path runs it; #11 in f32 on v1's
    operands laid side by side runs its launches: equal outputs."""
    blk, res = _half_block(params, cuda, stage, shift, "v1", torch.float32)
    x = _x(cuda, 180 + stage + shift + b, (b, res, res, blk.bp.shape[0])).float()
    geo = dict(heads=blk.heads, window=blk.window, shift=blk.shift, eps=blk.eps)
    a1 = (blk.ln1_w, blk.ln1_b, blk.wq, blk.bq, blk.wk, blk.wv, blk.wp, blk.bp, blk.bm)
    ops = blk.kernel_operands()
    got = _f32_check("swin_attn_v1_f32",
                     lambda: swin_attention_half_v1(x, *a1, **geo, operands=ops),
                     lambda: swin_attention_half_v1_plain(x, *a1, **geo), x, stage)
    a2 = _v2_block(params, cuda, stage, shift, torch.float32)[0]
    v2 = swin_attention_half_v2(x, *a2, **geo, operands=half_operands(a2[2], a2[4]))
    torch.cuda.synchronize()
    assert torch.equal(v2, got)


@pytest.mark.parametrize("b", [4, 3])
@pytest.mark.parametrize("stage,shift", F32_STAGE_SHIFTS)
def test_attention_v2_f32_kernel_matches_plain(cuda, params, stage, shift, b):
    attn, _, geo, res = _v2_block(params, cuda, stage, shift, torch.float32)
    x = _x(cuda, 190 + stage + shift + b, (b, res, res, attn[-2].shape[0])).float()
    ops = half_operands(attn[2], attn[4])
    _f32_check("swin_attn_v2_f32", lambda: swin_attention_half_v2(x, *attn, **geo, operands=ops),
               lambda: swin_attention_half_v2_plain(x, *attn, **geo), x, stage)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_mlp_int8_f32_kernel_matches_plain(cuda, params, stage):
    """#12 in f32 at 2 images on the codes held from load, under the bf16
    int8 kernel's bounds, repeating bitwise, and equal to the call without
    held codes; then with every LN output a code and a half (the rounding
    rule)."""
    _, mlp, _, res = _v2_block(params, cuda, stage, 0)
    x = _x(cuda, 200 + stage, (2, res * res, mlp[-1].shape[0])).float()
    ops = mlp_int8_operands(mlp[2], mlp[4])
    got = _f32_check("swin_mlp_int8_f32",
                     lambda: mlp_block_int8(x, *mlp, eps=cfg.layer_norm_eps, operands=ops),
                     lambda: mlp_block_int8_plain(x, *mlp, eps=cfg.layer_norm_eps), x, stage,
                     MLP_INT8_TOL)
    assert torch.equal(got, mlp_block_int8(x, *mlp, eps=cfg.layer_norm_eps))
    if stage == 0:
        c = x.shape[-1]
        k = torch.arange(1, c, device=cuda)
        ln_b = torch.cat([torch.tensor([127.0], device=cuda),
                          ((k % 20) + 0.5) * (1 - 2 * (k % 2))])
        args = (torch.zeros_like(mlp[0]), ln_b.float(), *mlp[2:])
        got = mlp_block_int8(x, *args, eps=cfg.layer_norm_eps)
        want = mlp_block_int8_plain(x, *args, eps=cfg.layer_norm_eps)
        _close(got, want, want - x, MLP_INT8_TOL[0][0], MLP_INT8_TOL[1])


# ----------------------------------------------------------------------
# HTSAT-tiny's widths (C = 96 * 2^i, heads of 24) on the split block's
# kernels and the opt-in ops; the log-mels at other mel counts and hops
# ----------------------------------------------------------------------
TINY_STAGE_SHIFTS = [(0, 0), (0, 4), (1, 4), (2, 4), (3, 0)]
TINY_DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture(scope="module")
def tiny_params():
    """HTSAT-tiny random weights, drawn as ``params``' are."""
    rng = np.random.default_rng(1)
    p = init_params(HTSAT_TINY, seed=0)
    for k, v in p.items():
        if k.endswith(".bias") or "bias_table" in k:
            p[k] = rng.normal(scale=0.5, size=v.shape).astype(np.float32)
        elif v.ndim == 2:
            p[k] = rng.normal(scale=v.shape[1] ** -0.5, size=v.shape).astype(np.float32)
        elif k.endswith(".weight") and "norm" in k:
            p[k] = (1.0 + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
    return p


def _tiny_block(p, cuda, stage, shift, attention, dtype):
    res = HTSAT_TINY.grid_size // 2**stage
    return SwinBlock(p, f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}", HTSAT_TINY,
                     res, shift, HTSAT_TINY.num_heads[stage], dtype,
                     attention=attention).to(cuda), res


def _once(name, call):
    before = KERNELS[name].launches
    got = call()
    torch.cuda.synchronize()
    assert KERNELS[name].launches == before + 1
    return got


@pytest.mark.parametrize("dtype", TINY_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("stage,shift", TINY_STAGE_SHIFTS)
def test_tiny_attention_v3_and_mlp_kernels_match_plain(cuda, tiny_params, stage, shift, dtype):
    """#8 then #9 at tiny's widths (stage 0: qkv N = 288, proj and fc2 N =
    96 on the 96-column tiles, K = 96), one launch each, against their
    plain versions under phase 3's bounds; in f32 the two equal the whole
    f32 block bitwise."""
    blk, res = _tiny_block(tiny_params, cuda, stage, shift, "v3", dtype)
    f32 = dtype == torch.float32
    x = _x(cuda, 300 + stage + shift, (2, res, res, blk.bp.shape[0])).to(dtype)
    geo = dict(heads=blk.heads, window=blk.window, shift=blk.shift, eps=blk.eps)
    attn = (blk.wqkv, blk.bq3, blk.wp, blk.bp, blk.bm)
    mlp = (blk.ln2_w, blk.ln2_b, blk.w1, blk.b1, blk.w2, blk.b2)
    ops = blk.kernel_operands()
    half = _once("swin_attn_v3_f32" if f32 else "swin_attn_v3",
                 lambda: swin_attention_half_v3(x, *attn, **geo, operands=ops))
    h3 = half.view(2, res * res, -1)
    out = _once("swin_mlp_f32" if f32 else "swin_mlp",
                lambda: mlp_block(h3, *mlp, eps=blk.eps, operands=ops))
    with full_f32():
        want_a = swin_attention_half_v3_plain(x, *attn, **geo)
        want_m = mlp_block_plain(h3, *mlp, eps=blk.eps)
    (a_rel, a_max), (m_rel, m_max) = ((SWIN_F32_TOL, SWIN_F32_TOL) if f32 else
                                      (ATTN_V3_TOL, MLP_TOL))
    _close(half, want_a, want_a.float() - x.float(), a_rel[stage], a_max)
    _close(out, want_m, want_m.float() - h3.float(), m_rel[stage], m_max)
    if f32:
        whole = swin_block(x, *attn, *mlp, **geo, operands=ops)
        torch.cuda.synchronize()
        assert torch.equal(out.view(whole.shape), whole)


@pytest.mark.parametrize("dtype", TINY_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("stage,shift", [(0, 0), (0, 4), (1, 0), (1, 4)])
def test_tiny_attention_v1_v2_kernels_match_plain(cuda, tiny_params, stage, shift, dtype):
    """#10 at tiny's widths where ``AM_TPU_ATTN_V1`` runs it (stages 0-1)
    against its plain version; #11 on the same weights laid side by side
    runs its launches: equal outputs."""
    blk, res = _tiny_block(tiny_params, cuda, stage, shift, "v1", dtype)
    f32 = dtype == torch.float32
    x = _x(cuda, 320 + stage + shift, (2, res, res, blk.bp.shape[0])).to(dtype)
    geo = dict(heads=blk.heads, window=blk.window, shift=blk.shift, eps=blk.eps)
    a1 = (blk.ln1_w, blk.ln1_b, blk.wq, blk.bq, blk.wk, blk.wv, blk.wp, blk.bp, blk.bm)
    got = _once("swin_attn_v1_f32" if f32 else "swin_attn_v1",
                lambda: swin_attention_half_v1(x, *a1, **geo, operands=blk.kernel_operands()))
    with full_f32():
        want = swin_attention_half_v1_plain(x, *a1, **geo)
    rel, mx = SWIN_F32_TOL if f32 else ATTN_V1_TOL
    _close(got, want, want.float() - x.float(), rel[stage], mx)
    prefix = f"audio_encoder.layers.{stage}.blocks.{1 if shift else 0}"
    v2 = _Folded(_v2_kernel_weights(tiny_params, prefix, res, blk.shift, blk.heads, blk.window),
                 dtype).to(cuda)
    a2 = (v2.ln1_w, v2.ln1_b, v2.wqkv, v2.bq3, v2.wp, v2.bp, v2.bm)
    same = _once("swin_attn_v2_f32" if f32 else "swin_attn_v2",
                 lambda: swin_attention_half_v2(x, *a2, **geo,
                                                operands=half_operands(v2.wqkv, v2.wp)))
    assert torch.equal(same, got)


@pytest.mark.parametrize("dtype", TINY_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_tiny_mlp_int8_kernel_matches_plain(cuda, tiny_params, stage, dtype):
    """#12 at tiny's widths (stage 0: fc1 K = 96 codes, a zero-filled part
    of a K step; fc2 N = 96 on the int8 96-column tile) on the codes held
    from load, against its plain version, repeating bitwise."""
    res = HTSAT_TINY.grid_size // 2**stage
    prefix = f"audio_encoder.layers.{stage}.blocks.0"
    m = _Folded(_mlp_weights(tiny_params, prefix), torch.float32).to(cuda)
    mlp = (m.ln2_w, m.ln2_b, m.w1, m.b1, m.w2, m.b2)
    x = _x(cuda, 340 + stage, (2, res * res, m.w1.shape[0])).to(dtype)
    ops = mlp_int8_operands(m.w1, m.w2)
    name = "swin_mlp_int8" + ("_f32" if dtype == torch.float32 else "")
    got = _once(name, lambda: mlp_block_int8(x, *mlp, eps=HTSAT_TINY.layer_norm_eps,
                                             operands=ops))
    want = mlp_block_int8_plain(x, *mlp, eps=HTSAT_TINY.layer_norm_eps)
    _close(got, want, want.float() - x.float(), MLP_INT8_TOL[0][stage], MLP_INT8_TOL[1])
    assert torch.equal(got, mlp_block_int8(x, *mlp, eps=HTSAT_TINY.layer_norm_eps, operands=ops))


def _clap_mel_kw(cuda, n_mels, hop, seed):
    """CLAP's frame (centered, dB) at ``hop`` with an ``n_mels`` filterbank,
    a seeded affine and bf16 out."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    fb = mel_filter_bank(513, n_mels, 50.0, 14000.0, SAMPLE_RATE, norm="slaney",
                         mel_scale="slaney").astype(np.float32)
    affine = (1 + 0.3 * torch.randn(n_mels, generator=g, device=cuda),
              torch.randn(n_mels, generator=g, device=cuda))
    return dict(frame_length=1024, hop_length=hop, n_fft=1024, fb=fb, center=True,
                log_mode="db", out_affine=affine, out_dtype=torch.bfloat16), g


@pytest.mark.parametrize("n_mels", [32, 96, 100, 128, 200, 256])
def test_log_mel_kernels_at_other_mel_counts(cuda, n_mels):
    """#6 and #7 at mel counts of part of a group, one and a half groups,
    two, three and a bit, four and one not a multiple of 8, on 2 CLAP 3 s
    clips: one launch a call, within LOG_MEL_TOL of the plain version,
    repeating bitwise, the two kernels equal (one DFT + mel kernel)."""
    kw, g = _clap_mel_kw(cuda, n_mels, 480, 40 + n_mels)
    audio = 0.2 * torch.randn((2, 3 * SAMPLE_RATE), generator=g, device=cuda)
    halo = _once("log_mel", lambda: log_mel_halo(audio, **kw))
    v1 = _once("log_mel_v1", lambda: log_mel_v1(audio, **kw))
    want = log_mel_halo_plain(audio, **kw)
    assert halo.shape == want.shape == (2, 301, n_mels) and halo.dtype == want.dtype
    _close(halo, want, want, *LOG_MEL_TOL["clap"])
    assert torch.equal(halo, log_mel_halo(audio, **kw)) and torch.equal(halo, v1)


@pytest.mark.parametrize("hop,n_mels", [(484, 64), (300, 64), (484, 128)])
def test_log_mel_halo_at_padded_hops(cuda, hop, n_mels):
    """#6 at hops that are not a multiple of 8 (hop rows padded to 488 and
    304 samples) on 2 CLAP 10 s clips: one launch, within LOG_MEL_TOL of
    the plain version, repeating bitwise."""
    kw, g = _clap_mel_kw(cuda, n_mels, hop, 50 + hop)
    audio = 0.2 * torch.randn((2, 10 * SAMPLE_RATE), generator=g, device=cuda)
    got = _once("log_mel", lambda: log_mel_halo(audio, **kw))
    want = log_mel_halo_plain(audio, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got, want, want, *LOG_MEL_TOL["clap"])
    assert torch.equal(got, log_mel_halo(audio, **kw))


class _GradEmbedder:
    """Means of 10 stride slices of a window times a weight that requires
    grad; ``embed`` sets no grad mode of its own."""

    sr = SAMPLE_RATE

    def __init__(self, device):
        self.device = torch.device(device)
        self.w = torch.linspace(1.0, 2.0, 10, device=self.device, requires_grad=True)

    def embed(self, audio):
        return audio.float().reshape(audio.shape[0], -1, 10).std(dim=1) * self.w


def test_default_mesh_is_the_named_card(cuda):
    """``AudioMetrics(device="cuda:i")`` without ``device_indices`` runs
    on card i alone, however many cards the host has."""
    from audio_metrics_tpu_torch import AudioMetrics

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    am = AudioMetrics(metrics=["fad"], embedder=_GradEmbedder(last), device=str(last))
    assert am.mesh.devices == [last] and am.mesh.size == 1


def test_host_fed_mesh_records_no_graph(cuda):
    """Songs through the host-fed path over two shards of card 0, one host
    thread each: no stored embedding carries a graph, and the embeddings
    equal those of one device at the shards' batch of 2 (a reduction's
    rounding may depend on the batch it runs in)."""
    from audio_metrics_tpu_torch import AudioMetrics
    from audio_metrics_tpu_torch.parallel.mesh import make_mesh

    card0 = torch.device("cuda", 0)
    rng = np.random.default_rng(8)
    songs = [rng.random(3 * SAMPLE_RATE + 100 * i).astype(np.float32) for i in range(6)]

    def run(mesh, batch):
        am = AudioMetrics(metrics=["fad", "kd"], embedder=_GradEmbedder(card0), win_dur=1.0,
                          batch_size=batch, device="cuda:0", device_indices=[0])
        if mesh is not None:
            am.mesh = mesh
        am.add_reference(songs)
        return am.stem_reference.embeddings

    two, one = run(make_mesh(devices=[card0] * 2), 4), run(None, 2)
    assert two.grad_fn is None and not two.requires_grad
    assert two.shape == one.shape == (18, 10)
    assert torch.equal(two, one), (two - one).abs().max().item()


# the merged one-window form of #10 and #11 (window = resolution = 16 at
# stage 2, AM_TPU_MERGED_ATTN): the v2 half's stage-2 bounds of each dtype,
# as in chip_smoke.py (MERGED_TOL)
MERGED_TOL = {torch.bfloat16: (ATTN_V2_TOL[0][2], ATTN_V2_TOL[1]),
              torch.float32: (SWIN_F32_TOL[0][2], SWIN_F32_TOL[1])}


@pytest.mark.parametrize("dtype", TINY_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("config", ["base", "tiny"])
def test_merged_attention_kernels_match_plain(cuda, params, tiny_params, config, shift, dtype):
    """The merged v1 half (a ``SwinBlock(..., attention="merged")`` at
    stage 2: 16 heads of 32 or 24, the dense (1, 16, 256, 256) table) at 2
    images against its plain version, one launch on its own count, repeated
    bitwise; the merged v2 half on v1's weights laid side by side runs its
    launches: equal outputs; and on a dense random table, against its
    plain version."""
    from audio_metrics_tpu_torch.models.htsat import _merged_bias_mask

    hcfg, p = (cfg, params) if config == "base" else (HTSAT_TINY, tiny_params)
    prefix = f"audio_encoder.layers.2.blocks.{1 if shift else 0}"
    blk = SwinBlock(p, prefix, hcfg, 16, shift, 16, dtype, attention="merged").to(cuda)
    assert blk.window == 16 and tuple(blk.bm.shape) == (1, 16, 256, 256)
    f32 = "_f32" if dtype == torch.float32 else ""
    x = _x(cuda, 400 + shift, (2, 16, 16, blk.bp.shape[0])).to(dtype)
    geo = dict(heads=16, window=16, shift=blk.shift, eps=blk.eps)
    a1 = (blk.ln1_w, blk.ln1_b, blk.wq, blk.bq, blk.wk, blk.wv, blk.wp, blk.bp, blk.bm)
    per_window = KERNELS["swin_attn_v1" + f32].launches
    got = _once("swin_attn_v1_merged" + f32,
                lambda: swin_attention_half_v1(x, *a1, **geo, operands=blk.kernel_operands()))
    assert KERNELS["swin_attn_v1" + f32].launches == per_window
    assert torch.equal(got, swin_attention_half_v1(x, *a1, **geo,
                                                   operands=blk.kernel_operands()))
    with full_f32():
        want = swin_attention_half_v1_plain(x, *a1, **geo)
    rel, mx = MERGED_TOL[dtype]
    _close(got, want, want.float() - x.float(), rel, mx)
    w2 = _v2_kernel_weights(p, prefix, 16, shift, 16, 8)
    w2["bm"] = _merged_bias_mask(w2["bm"], 16, 8)
    v2 = _Folded(w2, dtype).to(cuda)
    a2 = (v2.ln1_w, v2.ln1_b, v2.wqkv, v2.bq3, v2.wp, v2.bp)
    ops2 = half_operands(v2.wqkv, v2.wp)
    same = _once("swin_attn_v2_merged" + f32,
                 lambda: swin_attention_half_v2(x, *a2, v2.bm, **geo, operands=ops2))
    assert torch.equal(same, got)
    # any (1, heads, 256, 256) table: the kernel assumes no block structure
    dense = torch.from_numpy(np.random.default_rng(420 + shift).normal(
        size=(1, 16, 256, 256)).astype(np.float32)).to(cuda)
    got = _once("swin_attn_v2_merged" + f32,
                lambda: swin_attention_half_v2(x, *a2, dense, **geo, operands=ops2))
    with full_f32():
        want = swin_attention_half_v2_plain(x, *a2, dense, **geo)
    _close(got, want, want.float() - x.float(), rel, mx)


@pytest.mark.parametrize("dtype", TINY_DTYPES, ids=["bf16", "f32"])
def test_merged_live_lists_on_the_card(cuda, params, dtype):
    """The merged half's live-tile lists: made on the card from the table,
    they equal those made on the CPU at load (8 of 32 tiles a block); the
    half on lists made at the call (operands without ``live``) equals the
    half on the lists held from load, bitwise, one launch each; on the
    table with one query group masked everywhere (its block then all live)
    it holds to its plain version; lists that do not fit the table (a
    shape, a dtype, the map of the table with its keys rolled by one tile)
    raise before a launch."""
    from audio_metrics_tpu_torch.ops.attention import MERGED_DEAD, merged_live_tiles

    blk = SwinBlock(params, "audio_encoder.layers.2.blocks.1", cfg, 16, 4, 16, dtype,
                    attention="merged").to(cuda)
    ops = blk.kernel_operands()
    assert tuple(ops["live"].shape) == (1, 16, 4, 8)
    assert torch.equal(merged_live_tiles(blk.bm).cpu(), ops["live"].cpu())
    f32 = "_f32" if dtype == torch.float32 else ""
    x = _x(cuda, 430, (2, 16, 16, 512)).to(dtype)
    geo = dict(heads=16, window=16, shift=blk.shift, eps=blk.eps)
    a1 = (blk.ln1_w, blk.ln1_b, blk.wq, blk.bq, blk.wk, blk.wv, blk.wp, blk.bp)
    made = {k: v for k, v in ops.items() if k != "live"}
    got = _once("swin_attn_v1_merged" + f32,
                lambda: swin_attention_half_v1(x, *a1, blk.bm, **geo, operands=ops))
    again = _once("swin_attn_v1_merged" + f32,
                  lambda: swin_attention_half_v1(x, *a1, blk.bm, **geo, operands=made))
    assert torch.equal(got, again)
    masked = blk.bm.clone()
    masked[:, :, [r * 16 + col for r in (0, 1) for col in range(8)], :] = MERGED_DEAD
    assert merged_live_tiles(masked).shape[-1] == 32
    got = _once("swin_attn_v1_merged" + f32,
                lambda: swin_attention_half_v1(x, *a1, masked, **geo, operands=made))
    with full_f32():
        want = swin_attention_half_v1_plain(x, *a1, masked, **geo)
    rel, mx = MERGED_TOL[dtype]
    _close(got, want, want.float() - x.float(), rel, mx)
    before = {k: v.launches for k, v in KERNELS.items()}
    for wrong in (ops["live"][:, :8].contiguous(), ops["live"].long(),
                  merged_live_tiles(blk.bm.roll(8, dims=-1))):
        with pytest.raises(ValueError, match="live-tile lists"):
            swin_attention_half_v1(x, *a1, blk.bm, **geo, operands=dict(ops, live=wrong))
    assert {k: v.launches for k, v in KERNELS.items()} == before


def test_merged_attention_refuses_other_tables(cuda, params):
    """No launch where the merged form's geometry is wrong: window 16 with
    a per-window (1, heads, 64, 64) table raises ``ValueError``, a window
    of 16 that is not the whole image ``NotImplementedError``."""
    blk = SwinBlock(params, "audio_encoder.layers.2.blocks.0", cfg, 16, 0, 16, torch.bfloat16,
                    attention="merged").to(cuda)
    a1 = (blk.ln1_w, blk.ln1_b, blk.wq, blk.bq, blk.wk, blk.wv, blk.wp, blk.bp)
    ops = blk.kernel_operands()
    before = {k: v.launches for k, v in KERNELS.items()}
    with pytest.raises(ValueError):
        swin_attention_half_v1(_x(cuda, 410, (2, 16, 16, 512)), *a1, blk.bm[:, :, :64, :64].contiguous(),
                               heads=16, window=16, shift=0, operands=ops)
    with pytest.raises(NotImplementedError):
        swin_attention_half_v1(_x(cuda, 411, (1, 32, 32, 512)), *a1, blk.bm, heads=16,
                               window=16, shift=0, operands=ops)
    assert {k: v.launches for k, v in KERNELS.items()} == before
