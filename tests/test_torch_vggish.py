"""VGGish, the log-mel at power 1, the registry and the dummy embedder: the
port against the JAX package on the CPU.

Same seeded numpy weights (torchvggish names, random biases so that every
bias is read) and the same seeded clips through both packages.  Tolerances
are the JAX suite's (tests/test_models.py:234, :269) or stated at each test
from its reading.  Both packages' downloads are refused and their caches
are empty directories: a checkpoint is found where the test writes it, or
not at all.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.models import EMBEDDERS as JAX_EMBEDDERS
from audio_metrics_tpu.models.dummy import DummyEmbedder as JaxDummyEmbedder
from audio_metrics_tpu.models import vggish as jax_vggish
from audio_metrics_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from audio_metrics_tpu.utils import get_url as jax_get_url
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.models import EMBEDDERS, DummyEmbedder, get_embedder
from audio_metrics_tpu_torch.models import vggish
from audio_metrics_tpu_torch.ops.mel import log_mel_spectrogram
from audio_metrics_tpu_torch.parallel.pipeline import ItemCategory
from audio_metrics_tpu_torch.testing import prdc_mismatches
from audio_metrics_tpu_torch.utils import get_url

SR = 16000
KEYS = ["fad", "kernel_distance_mean", "kernel_distance_std", "precision", "recall",
        "density", "coverage"]


@pytest.fixture(autouse=True)
def no_download(monkeypatch, tmp_path):
    def refuse(url):
        raise RuntimeError(f"test refused to download {url}")

    monkeypatch.setattr(get_url, "download_url", refuse)
    monkeypatch.setattr(jax_get_url, "download_url", refuse)
    for k in ("AM_TPU_CKPT_DIR", "AM_TPU_CACHE_DIR", "AM_TPU_ALLOW_RANDOM_WEIGHTS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "empty_cache"))


def seeded_params(seed: int = 0) -> dict:
    """torchvggish-named f32 weights at the JAX ``init_params`` scales, with
    N(0, 0.1) biases (``init_params`` zeroes them)."""
    rng = np.random.default_rng(seed)
    p = {}
    for (c_in, c_out), idx in zip(vggish._CONV_CHANNELS, vggish._TORCH_CONV_IDX):
        p[f"features.{idx}.weight"] = rng.standard_normal(
            (c_out, c_in, 3, 3), dtype=np.float32) * np.float32(np.sqrt(2.0 / (c_in * 9)))
        p[f"features.{idx}.bias"] = rng.standard_normal(c_out, dtype=np.float32) * 0.1
    for (d_in, d_out), idx in zip(vggish._FC_DIMS, vggish._TORCH_FC_IDX):
        p[f"embeddings.{idx}.weight"] = rng.standard_normal(
            (d_out, d_in), dtype=np.float32) * np.float32(np.sqrt(2.0 / d_in))
        p[f"embeddings.{idx}.bias"] = rng.standard_normal(d_out, dtype=np.float32) * 0.1
    return p


@pytest.fixture(scope="module")
def params():
    return seeded_params()


def seeded_patches() -> np.ndarray:
    """Log-mel patches of seeded noise with tones: (6, 96, 64) f32."""
    return np.asarray(jax_vggish.vggish_log_mel_patches(_clips(0, 3, 2.0))).reshape(-1, 96, 64)


@pytest.fixture(scope="module")
def patches():
    return seeded_patches()


def _clips(seed, n, seconds, loudest=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = np.sin(2 * np.pi * rng.uniform(100, 3000, size=(n, 1)) * t)
    amp = rng.uniform(0.05, loudest, size=(n, 1))
    return (amp * (rng.standard_normal((n, t.size)) + tone)).astype(np.float32)


def check_vggish_f32(vggish_cls, params, patches):
    """The f32 net against the JAX ``_forward``: rtol 2e-3, atol 2e-4
    (tests/test_models.py:234; reading 1.5e-5 abs on outputs up to ~12)."""
    want = np.asarray(jax_vggish._forward(params, patches))
    got = vggish_cls(params=params, device="cpu").patch_net(torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_vggish_net_f32_matches_jax(params, patches):
    check_vggish_f32(vggish.VGGish, params, patches)


def test_vggish_log_mel_patches_match_jax():
    audio = _clips(1, 2, 3.0)
    want = np.asarray(jax_vggish.vggish_log_mel_patches(audio))
    got = vggish.vggish_log_mel_patches(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, 3, 96, 64)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def _bf16_cudnn_form(params, patches):
    """cuDNN's bf16 reading of the bf16 net, emulated: bf16 products whose
    output is rounded to bf16 before the f32 bias is added, then ReLU and a
    second rounding; the last product's bf16 output plus the f32 bias."""
    import torch.nn.functional as F

    w = {k: torch.from_numpy(v) for k, v in params.items()}
    x = torch.from_numpy(patches)[:, None].bfloat16()
    for i, idx in enumerate(vggish._TORCH_CONV_IDX):
        y = F.conv2d(x, w[f"features.{idx}.weight"].bfloat16(), padding=1)
        x = torch.relu(y.float() + w[f"features.{idx}.bias"][:, None, None]).bfloat16()
        if i in vggish._POOL_AFTER:
            x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for i, idx in enumerate(vggish._TORCH_FC_IDX):
        y = (x @ w[f"embeddings.{idx}.weight"].bfloat16().T).float() + w[f"embeddings.{idx}.bias"]
        x = torch.relu(y).bfloat16() if i < 2 else y
    return x.numpy()


# bf16 net against the JAX bf16 forward: max abs error / max |JAX output|.
# Readings on these inputs: 0.004393 for the kept form (f32 products of
# bf16-rounded operands, the JAX rounding points) and 0.008443 for cuDNN's
# bf16 form (bf16 product outputs, rounded before the bias); the bound is
# 3.4x the kept form's reading.
BF16_REL_TOL = 0.015


def test_vggish_net_bf16_matches_jax(params, patches):
    want = np.asarray(jax_vggish._forward(params, patches, jnp.bfloat16))
    scale = np.abs(want).max()
    got = vggish.VGGish(params=params, compute_dtype="bfloat16", device="cpu").patch_net(
        torch.from_numpy(patches)).numpy()
    kept = np.abs(got - want).max() / scale
    cudnn = np.abs(_bf16_cudnn_form(params, patches) - want).max() / scale
    print(f"bf16 against JAX bf16: kept form {kept:.4g}, cuDNN bf16 form {cudnn:.4g}")
    assert kept <= BF16_REL_TOL, (kept, cudnn)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_log_mel_power_1_matches_jax(compute_dtype):
    """The magnitude log-mel at CLAP's convention (its bf16 is not sent to a
    kernel at power 1, in either package): f32 rtol/atol 1e-5, bf16 (the
    rounded frames and basis, other f32 sums) atol 2e-3 on values ~[-5, 3]."""
    audio = _clips(2, 2, 1.0)
    kw = dict(sampling_rate=SR, frame_length=400, hop_length=160, n_mels=64, fmin=125.0,
              fmax=7500.0, n_fft=512, center=True, mel_norm="slaney", mel_scale="slaney",
              log_mode="natural", log_offset=0.01, power=1.0)
    want = np.asarray(jax_log_mel(audio, compute_dtype=jnp.bfloat16 if compute_dtype else None,
                                  **kw))
    got = log_mel_spectrogram(torch.from_numpy(audio),
                              compute_dtype=torch.bfloat16 if compute_dtype else None,
                              **kw).numpy()
    tol = 2e-3 if compute_dtype else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _write_pth(params, path):
    torch.save({k: torch.from_numpy(v) for k, v in params.items()}, path)


def test_vggish_checkpoints_load(params, tmp_path, monkeypatch):
    """``.pth`` (torch state dict) and ``.npz`` give the parameter dict;
    a missing key raises; without a checkpoint the registry name raises;
    with the URL's file name in ``$AM_TPU_CKPT_DIR`` it builds f32 VGGish
    with the file's weights."""
    pth, npz = tmp_path / "v.pth", tmp_path / "v.npz"
    _write_pth(params, pth)
    np.savez(npz, **params)
    for path in (pth, npz):
        got = vggish.load_checkpoint(str(path))
        assert set(got) == set(params)
        assert all(np.array_equal(got[k], params[k]) for k in params)
    partial = {k: params[k] for k in ("features.0.weight", "features.0.bias")}
    for path, save in ((tmp_path / "p.pth", _write_pth),
                       (tmp_path / "p.npz", lambda p, f: np.savez(f, **p))):
        save(partial, path)
        with pytest.raises(ValueError, match="16 of 18 keys missing"):
            vggish.load_checkpoint(str(path))
    with pytest.raises(RuntimeError, match="checkpoint unavailable"):
        get_embedder("vggish", device="cpu")

    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    _write_pth(params, ckpt_dir / vggish.VGGISH_CHECKPOINT_URL.rsplit("/", 1)[-1])
    monkeypatch.setenv("AM_TPU_CKPT_DIR", str(ckpt_dir))
    emb = get_embedder("vggish", device="cpu")
    assert isinstance(emb, vggish.VGGish) and emb.compute_dtype == torch.float32
    for k, v in params.items():
        assert np.array_equal(getattr(emb, k.replace(".", "_")).numpy(), v), k


def test_registries_have_the_same_names():
    assert list(EMBEDDERS) == list(JAX_EMBEDDERS)


def test_dummy_embedder_matches_jax():
    audio = _clips(3, 4, 0.5)
    want = np.asarray(JaxDummyEmbedder().forward({"audio": audio})["embedding"])
    emb = get_embedder("dummy", device="cpu")
    assert isinstance(emb, DummyEmbedder) and emb.sr == 16000
    np.testing.assert_allclose(emb.embed(torch.from_numpy(audio)).numpy(), want, rtol=1e-6)


def assert_prdc_close(got, want, am, jam, cand):
    """PRDC values equal, or their reductions equal up to near-ties
    (``testing.prdc_mismatches`` on each package's embeddings)."""
    if all(got[k] == want[k] for k in KEYS[3:]):
        return
    n, bad = prdc_mismatches(
        am.stem_reference.embeddings,
        am._run_pipeline(cand, None)[ItemCategory.stem].embeddings,
        jam.stem_reference.embeddings,
        jam._run_pipeline(jnp.asarray(cand), None)[ItemCategory.stem].embeddings)
    assert bad == 0, (n, got, want)


class _JaxVGGishBatched(jax_vggish.VGGish):
    """The JAX VGGish through the JAX pipeline's batch loop (an embedder
    without ``embed_fn``): its fused loop runs the conv stack ~7 s a call on
    the CPU backend, its jitted forward ~0.1 s."""

    embed_fn = None


def test_vggish_slice_matches_jax(params):
    """``AudioMetrics(metrics=["fad", "kd", "prdc"])`` in both packages,
    VGGish f32 at 16 kHz, 12 + 12 1 s clips (the candidates quieter): FAD
    and KD within rel 1e-3 (n = 12 <= d: the host FAD in both), PRDC equal
    up to near-ties."""
    ref, cand = _clips(4, 12, 1.0), _clips(5, 12, 1.0, loudest=0.2)
    jam = JaxAudioMetrics(metrics=["fad", "kd", "prdc"], embedder=_JaxVGGishBatched(params=params),
                          win_dur=1.0, batch_size=12, device_indices=[0])
    jam.add_reference(jnp.asarray(ref))
    want = jam.evaluate(jnp.asarray(cand))
    am = AudioMetrics(metrics=["fad", "kd", "prdc"],
                      embedder=vggish.VGGish(params=params, device="cpu"), win_dur=1.0,
                      batch_size=12, device="cpu")
    am.add_reference(ref)
    got = am.evaluate(cand)
    assert list(got) == KEYS and all(np.isfinite(v) for v in got.values())
    for key in KEYS[:3]:
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
    assert_prdc_close(got, want, am, jam, cand)
