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

The PRDC kernels (f32): radii rtol 1e-4, atol 1e-5 against the plain
version (the JAX suite's kernel-vs-XLA bound); the booleans and counts
equal except where a float64 recomputation shows a pair within 1e-5
relative of its radius (``testing.stats_mismatches``).  The log-mel
kernel: the bounds of ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from audio_metrics_tpu_torch.kernels import KERNELS
from audio_metrics_tpu_torch.models.clap import SAMPLE_RATE, ClapFrontend
from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE, PatchMerge, SwinBlock, init_params
from audio_metrics_tpu_torch.ops.attention import swin_block, swin_block_plain
from audio_metrics_tpu_torch.ops.distance import (
    knn_radii,
    knn_radii_plain,
    pairwise_stats,
    pairwise_stats_plain,
)
from audio_metrics_tpu_torch.ops.frontend_fused import clap_tokens_fused, clap_tokens_fused_plain
from audio_metrics_tpu_torch.ops.mel import log_mel_halo, log_mel_halo_plain, mel_filter_bank
from audio_metrics_tpu_torch.ops.merge import patch_merge, patch_merge_plain
from audio_metrics_tpu_torch.testing import stats_mismatches

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
    got = block(x, swin_block)
    torch.cuda.synchronize()
    assert KERNELS["swin_block"].launches == before + 1
    want = block(x, swin_block_plain)
    _close(got, want, want.float() - x.float(), SWIN_REL[stage], SWIN_MAX)


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
    got = merge(x, patch_merge)
    torch.cuda.synchronize()
    want = merge(x, patch_merge_plain)
    _close(got, want, want, *MERGE_TOL)


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
    """A CUDA tensor launches the kernel or raises: no silent plain path."""
    merge = PatchMerge(params, "audio_encoder.layers.2.downsample", cfg, 16, torch.float32)
    x = torch.zeros((1, 256, 512), device=cuda)
    with pytest.raises(NotImplementedError):
        merge.to(cuda)(x, patch_merge)


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
