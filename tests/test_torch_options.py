"""The stems options of ``AudioMetrics``, the port against the JAX package
on the CPU: overlapping windows (``hop_dur``), resampling, the ``n_pca``
projection, ``timings``, ``precompile``, the OOM retry and
``AM_TPU_NO_MEL_TILE``; then the slice as a whole under each option.

Most cases run a seeded projection embedder defined here on both sides
(mean over 64-sample frames of tanh(frame @ W), 16-d, full rank over the
windows), which costs nothing next to a model.  Same numpy inputs from a
seed through both packages.
"""

import copy
import logging

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax
import jax.numpy as jnp

import audio_metrics_tpu.models.clap as jax_clap
from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.models.base import Embedder as JaxEmbedder
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.ops.resample import resample_batch as jax_resample_batch
from audio_metrics_tpu.parallel.pipeline import _device_windows
from audio_metrics_tpu.projection import IncrementalPCA as JaxIncrementalPCA
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.models.clap import LaionCLAP, init_projection_params
from audio_metrics_tpu_torch.models.htsat import HTSATConfig, init_params
from audio_metrics_tpu_torch.ops import resample as port_resample
from audio_metrics_tpu_torch.parallel.pipeline import ItemCategory, embedding_pipeline
from audio_metrics_tpu_torch.projection import IncrementalPCA
from audio_metrics_tpu_torch.testing import prdc_mismatches

SR = 16000
FRAME = 64
KEYS = ["fad", "kernel_distance_mean", "kernel_distance_std", "precision", "recall",
        "density", "coverage"]
W_PROJ = (np.random.default_rng(7).standard_normal((FRAME, 16)) / 4).astype(np.float32)


@jax.jit
def _jax_proj(params, audio):
    b, n = audio.shape
    frames = audio[:, : n // FRAME * FRAME].reshape(b, -1, FRAME)
    return jnp.tanh(frames @ params["w"]).mean(axis=1)


class JaxProj(JaxEmbedder):
    sr = SR

    def __init__(self):
        self.params = {"w": jnp.asarray(W_PROJ)}

    @property
    def embed_fn(self):
        return _jax_proj

    def forward(self, data):
        return {"embedding": _jax_proj(self.params, jnp.asarray(data["audio"], jnp.float32))}


class Proj:
    """The port's side of ``JaxProj``; ``limit``: raise ``exc`` on batches
    of more rows (the OOM retry's stand-in); ``batches`` records each call's
    rows, ``windows`` the windows embedded."""

    sr = SR
    device = torch.device("cpu")

    def __init__(self, limit=None, exc=torch.OutOfMemoryError):
        self.limit, self.exc = limit, exc
        self.batches, self.windows = [], []

    def embed(self, audio):
        self.batches.append(audio.shape[0])
        if self.limit is not None and audio.shape[0] > self.limit:
            raise self.exc("CUDA out of memory (stand-in)")
        self.windows.append(audio)
        b, n = audio.shape
        frames = audio[:, : n // FRAME * FRAME].reshape(b, -1, FRAME)
        return torch.tanh(frames @ torch.from_numpy(W_PROJ)).mean(dim=1)


def _clips(seed, n, seconds, sr=SR, loudest=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    tone = np.sin(2 * np.pi * rng.uniform(100, 3000, size=(n, 1)) * t)
    amp = rng.uniform(0.05, loudest, size=(n, 1))
    return (amp * (rng.standard_normal((n, t.size)) + tone)).astype(np.float32)


# -- hop_dur ---------------------------------------------------------------
def check_hop_windows(pipeline):
    """``pipeline`` (``embedding_pipeline``) embeds the JAX package's
    ``_device_windows`` of the clips, bitwise and in their order, with
    ``hop_dur`` 0.3 s under ``win_dur`` 1 s (and 0.5 s at 22.05 kHz, cut at
    the input rate)."""
    for sr, hop_dur in ((SR, 0.3), (22050, 0.5)):
        x = _clips(0, 3, 2.2, sr=sr)
        emb = Proj()
        pipeline(x, emb, None, stems_mode=True, batch_size=4, win_dur=1.0, hop_dur=hop_dur,
                 input_sr=sr)
        got = torch.cat(emb.windows).numpy() if sr == SR else None
        want = np.asarray(_device_windows(jnp.asarray(x), sr, int(sr * hop_dur)))
        assert sum(emb.batches) == want.shape[0] > 6, sr  # more than 2 windows a clip
        if got is not None:
            np.testing.assert_array_equal(got, want)


def test_hop_dur_windows_match_jax():
    check_hop_windows(embedding_pipeline)


# -- resampling --------------------------------------------------------------
@pytest.mark.parametrize("quality", ["hq", "vhq"])
@pytest.mark.parametrize("sr_orig,sr_new", [(44100, 48000), (48000, 16000), (22050, 16000)])
def test_resample_matches_jax_and_scipy(sr_orig, sr_new, quality):
    """Against the JAX function and ``scipy.signal.resample_poly`` (for
    "vhq" given the same Kaiser filter), atol 2e-6 (tests/test_dsp.py:27)."""
    x = np.random.default_rng(sr_orig % 97).standard_normal((2, sr_orig // 4)).astype(np.float32)
    got = port_resample.resample_batch(torch.from_numpy(x), sr_orig, sr_new, quality).numpy()
    want = np.asarray(jax_resample_batch(x, sr_orig, sr_new, quality))
    g = np.gcd(sr_orig, sr_new)
    up, down = sr_new // g, sr_orig // g
    beta, mult = port_resample.RESAMPLE_QUALITIES[quality]
    rate = max(up, down)
    window = port_resample._kaiser_sinc_filter(2 * mult * rate + 1, 1.0 / rate, beta)
    ref = np.stack([ss.resample_poly(r.astype(np.float64), up, down, window=window) for r in x])
    assert got.shape == want.shape == ref.shape == (2, -(-x.shape[1] * up // down))
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(port_resample.resample(x[0], sr_orig, sr_new, quality), got[0],
                               atol=2e-6)


# -- IncrementalPCA ------------------------------------------------------------
@pytest.mark.parametrize("rows", [300, 4096])
def test_incremental_pca_matches_jax(rows):
    """Two ``partial_fit`` calls (the first pass, then the incremental
    update) give the JAX class's fitted state (float64, rtol 1e-10), and
    ``transform`` agrees at atol 1e-6 on both sides of the 4096-row device
    threshold (numpy float64 below it, f32 products from it up), on
    correlated rows of norm ~1, as CLAP's unit embeddings."""
    rng = np.random.default_rng(rows)
    x = (rng.standard_normal((rows, 32)) @ rng.standard_normal((32, 32)) / 32).astype(np.float32)
    port, ref = IncrementalPCA(n_components=8), JaxIncrementalPCA(n_components=8)
    for part in (x[: rows // 2], x[rows // 2 :]):
        port.partial_fit(torch.from_numpy(part))
        ref.partial_fit(part)
    got, want = port.__getstate__(), ref.__getstate__()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-12, err_msg=k)
    out = port.transform(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (rows, 8)
    np.testing.assert_allclose(out.numpy(), ref.transform(x), atol=1e-6)


# -- timings ---------------------------------------------------------------------
def test_timings_keys_after_evaluate():
    """The port writes the JAX package's keys in its order for the same
    configuration, each a wall time in seconds: ``fad`` + ``kd`` +
    ``prdc`` with FAD on the host (n <= d): KD and PRDC dispatched, FAD's
    host work on a thread while they are pending, one pull
    (``finalize_pull``), the join (``fad_overlapped``); ``fad`` alone,
    nothing pending: FAD inline, no pull."""
    ref, cand = _clips(1, 4, 1.0), _clips(2, 4, 1.0)
    want = {("fad", "kd", "prdc"): ["pipeline", "projection", "kd_dispatch", "prdc_dispatch",
                                    "finalize_pull", "fad_overlapped", "finalize"],
            ("fad",): ["pipeline", "projection", "fad", "finalize"]}
    for metrics, keys in want.items():
        jam = JaxAudioMetrics(metrics=list(metrics), embedder=JaxProj(), win_dur=1.0,
                              device_indices=[0])
        jam.add_reference(jnp.asarray(ref))
        jam.evaluate(jnp.asarray(cand))
        am = AudioMetrics(metrics=list(metrics), embedder=Proj(), win_dur=1.0, device="cpu")
        am.add_reference(ref)
        am.evaluate(cand)
        assert list(am.timings) == list(jam.timings) == keys
        assert all(v >= 0 for v in am.timings.values())
        if "finalize_pull" in keys:
            assert am.timings["finalize"] >= am.timings["fad_overlapped"]
            assert am.timings["fad_overlapped"] >= am.timings["finalize_pull"]


# -- precompile ------------------------------------------------------------------
def check_precompile_restores(am_cls):
    """The JAX suite's ``test_precompile_preserves_state``
    (tests/test_audio_metrics.py:264-300) with ``n_pca``: after
    ``precompile`` the reference, its projected cache and the projection's
    fit are what they were (bitwise), and the next evaluate equals the one
    before; on a fresh instance the reference stays empty."""
    data = _clips(11, 8, 1.0)
    am = am_cls(metrics=["fad", "kd", "prdc"], n_pca=4, embedder=Proj(), win_dur=1.0,
                input_sr=SR, batch_size=4, device="cpu")
    am.add_reference(data)
    before = am.evaluate(data)
    ref, ref_pca = am.stem_reference, am.stem_reference_pca
    fit = copy.deepcopy(am.stem_projection.__getstate__())
    am.precompile(n_items=8)
    assert am.stem_reference is ref and am.stem_reference_pca is ref_pca
    assert am.stem_reference.n == 8
    state = am.stem_projection.__getstate__()
    assert state.keys() == fit.keys()
    for k in fit:
        np.testing.assert_array_equal(state[k], fit[k], err_msg=k)
    assert am.evaluate(data) == before

    fresh = am_cls(metrics=["fad"], embedder=Proj(), win_dur=1.0, input_sr=SR, device="cpu")
    fresh.precompile(n_items=4)
    with pytest.raises(ValueError, match="empty"):
        fresh.evaluate(data)


def test_precompile_preserves_state():
    check_precompile_restores(AudioMetrics)


def test_jax_precompile_leaves_the_projection_refitted():
    """Why the port snapshots the projection: the JAX package's
    ``precompile`` restores its references but not ``stem_projection``,
    which its synthetic evaluate has refitted on noise (ROADMAP Queue 3)."""
    data = _clips(11, 8, 1.0)
    jam = JaxAudioMetrics(metrics=["fad", "kd", "prdc"], n_pca=4, embedder=JaxProj(),
                          win_dur=1.0, input_sr=SR, batch_size=4, device_indices=[0])
    jam.add_reference(jnp.asarray(data))
    jam.evaluate(jnp.asarray(data))
    seen = jam.stem_projection.n_samples_seen_
    jam.precompile(n_items=8)
    assert jam.stem_projection.n_samples_seen_ == seen + 8


# -- the OOM retry -----------------------------------------------------------------
def _oom_metrics(embedder, batch_size):
    return AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=embedder, win_dur=0.1,
                        batch_size=batch_size, device="cpu")


def test_oom_retry_halves_the_batch_until_it_fits(caplog):
    """A batch of 256 that runs out of memory above 100 rows is retried at
    128, then 64: the result equals a direct run at 64, and each retry logs
    the JAX package's warning."""
    ref, cand = _clips(3, 300, 0.1), _clips(4, 300, 0.1)
    emb = Proj(limit=100)
    am = _oom_metrics(emb, 256)
    with caplog.at_level(logging.WARNING):
        am.add_reference(ref)
        got = am.evaluate(cand)
    assert emb.batches[:3] == [256, 128, 64]
    assert [r.getMessage() for r in caplog.records].count(
        "fused embed loop exhausted device memory; retrying at batch_size=64") == 2
    direct = _oom_metrics(Proj(), 64)
    direct.add_reference(ref)
    assert got == direct.evaluate(cand)
    assert torch.equal(am.stem_reference.embeddings, direct.stem_reference.embeddings)


@pytest.mark.parametrize("batch_size,exc", [(64, torch.OutOfMemoryError), (256, RuntimeError)])
def test_oom_retry_reraises(batch_size, exc):
    """An OOM at a batch of 64 or less is re-raised, as is any other
    exception, at once."""
    emb = Proj(limit=32, exc=exc)
    with pytest.raises(exc, match="stand-in"):
        _oom_metrics(emb, batch_size).add_reference(_clips(3, 300, 0.1))
    assert emb.batches == [batch_size]


# -- AM_TPU_NO_MEL_TILE ----------------------------------------------------------
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
CLAP_SR = 48000


@pytest.fixture(scope="module")
def clap_params():
    cfg = HTSATConfig(**SMALL)
    rng = np.random.default_rng(1)
    p = init_params(cfg, seed=0)
    p.update(init_projection_params(cfg, seed=0))
    for k in p:
        if k.endswith(".bias") or "bias_table" in k:
            p[k] = rng.normal(scale=0.1, size=p[k].shape).astype(np.float32)
    p["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    return p


@pytest.fixture
def no_mel_tile(monkeypatch):
    """``AM_TPU_NO_MEL_TILE`` for both packages: the port's variable, and
    the JAX module attribute its import set from it (the JAX jit caches are
    cleared around it, since the flag is not part of their key)."""
    monkeypatch.setenv("AM_TPU_NO_MEL_TILE", "1")
    monkeypatch.setattr(jax_clap, "_NO_MEL_TILE", True)
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_no_mel_tile_f32_matches_jax(clap_params, no_mel_tile):
    """f32 2 s clips (which tile 10 s) through the repeat-padded clip's
    centered mel in both packages: embeddings atol 1e-6, as the slice's
    (tests/test_torch_slice.py)."""
    cfg = HTSATConfig(**SMALL)
    audio = _clips(5, 2, 2.0, sr=CLAP_SR)
    want = np.asarray(jax_clap.LaionCLAP(params=clap_params, cfg=JaxHTSATConfig(**SMALL))
                      .forward({"audio": audio})["embedding"])
    got = LaionCLAP(params=clap_params, cfg=cfg, device="cpu").embed(torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_no_mel_tile_bf16_takes_the_halo_log_mel(clap_params, monkeypatch):
    """bf16 2 s clips: by default the fused frontend (#3); under
    ``AM_TPU_NO_MEL_TILE`` one halo log-mel (#6) a forward and no fused
    frontend, embeddings within the bound of a selectable configuration
    against the default (PERF.md section 2: 1 - cos <= 5e-5, max abs <=
    5e-3; the plain versions here)."""
    import audio_metrics_tpu_torch.models.clap as clap
    import audio_metrics_tpu_torch.ops.mel as mel

    calls = {"fused": 0, "halo": 0}
    fused, halo = clap.clap_tokens_fused, mel.log_mel_halo

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(clap, "clap_tokens_fused", count("fused", fused))
    monkeypatch.setattr(mel, "log_mel_halo", count("halo", halo))
    emb = LaionCLAP(params=clap_params, cfg=HTSATConfig(**SMALL), device="cpu",
                    compute_dtype="bfloat16")
    audio = torch.from_numpy(_clips(6, 2, 2.0, sr=CLAP_SR))
    default = emb.embed(audio)
    assert calls == {"fused": 1, "halo": 0}
    monkeypatch.setenv("AM_TPU_NO_MEL_TILE", "1")
    untiled = emb.embed(audio)
    assert calls == {"fused": 1, "halo": 1}
    cos = (default * untiled).sum(dim=1).min().item()
    assert 1 - cos <= 5e-5 and (default - untiled).abs().max().item() <= 5e-3


# -- the slice as a whole ----------------------------------------------------------
@pytest.mark.parametrize("options", [
    dict(hop_dur=0.25), dict(n_pca=4), dict(hop_dur=0.25, input_sr=22050, n_pca=4),
])
def test_slice_with_options_matches_jax(options):
    """``AudioMetrics(metrics=["fad", "kd", "prdc"])`` of both packages with
    the seeded projection embedder, 4 + 4 1 s clips in 0.5 s windows (the candidates
    quieter), under ``hop_dur``, ``n_pca`` and all three with ``input_sr``
    22050 (resampled to the embedder's 16 kHz): FAD and KD within rel 1e-3,
    PRDC equal up to near-ties; the window count is the JAX package's.
    Short windows, few of them: the JAX package's resampling takes ~5 s
    for 24 windows of 1 s on the CPU backend."""
    sr = options.get("input_sr", SR)
    ref, cand = _clips(8, 4, 1.0, sr=sr), _clips(9, 4, 1.0, sr=sr, loudest=0.25)
    kw = dict(metrics=["fad", "kd", "prdc"], win_dur=0.5, batch_size=8, **options)
    jam = JaxAudioMetrics(embedder=JaxProj(), device_indices=[0], **kw)
    jam.add_reference(jnp.asarray(ref))
    want = jam.evaluate(jnp.asarray(cand))
    am = AudioMetrics(embedder=Proj(), device="cpu", **kw)
    am.add_reference(ref)
    got = am.evaluate(cand)
    assert am.stem_reference.n == jam.stem_reference.n == (12 if "hop_dur" in options else 8)
    assert list(got) == KEYS and all(np.isfinite(v) for v in got.values())
    for key in KEYS[:3]:
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
    if any(got[k] != want[k] for k in KEYS[3:]):
        ref_p, cand_p = am.ensure_stem_projection(
            am.stem_reference, am._run_pipeline(cand, None)[ItemCategory.stem])
        ref_j, cand_j = jam.ensure_stem_projection(
            jam.stem_reference, jam._run_pipeline(jnp.asarray(cand), None)[ItemCategory.stem])
        n, bad = prdc_mismatches(ref_p.embeddings, cand_p.embeddings, ref_j.embeddings,
                                 cand_j.embeddings)
        assert bad == 0, (n, got, want)
