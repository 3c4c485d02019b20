"""The FAD+KD slice of the port against the JAX package, on the CPU.

Same numpy parameter dict, same seeded clips, through
``AudioMetrics(metrics=["fad", "kd"])`` of both packages, in f32, with a
small HTSAT (spec 256 and 64 mels as HTSAT-base, narrower and shallower).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.kernels import KERNELS
from audio_metrics_tpu_torch.models.clap import LaionCLAP, init_projection_params
from audio_metrics_tpu_torch.models.htsat import HTSATConfig, init_params

SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
SR = 48000


def _params(cfg):
    """Seeded weights with nontrivial biases, bias tables and norms."""
    rng = np.random.default_rng(1)
    p = init_params(cfg, seed=0)
    p.update(init_projection_params(cfg, seed=0))
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


def test_fad_kd_slice_matches_jax():
    """f32 through both packages.  Embeddings atol 1e-6 (unit vectors; f32
    products summed in other orders through 8 blocks, measured 7e-8).  FAD
    rel 1e-5 (n = 6 < d: the host FAD takes the eigh route; measured
    1.2e-7).  KD abs 1e-7: its polynomial Gram entries are ~1 here (near
    identical unit embeddings, gamma 1/d, coef0 1) and the estimate is a
    difference of their sums, so f32 rounding of the entries (6e-8) bounds
    the agreement in absolute terms (measured 2.4e-8 on the std)."""
    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    ref, cand = _clips(0, 6), _clips(1, 6)

    jam = JaxAudioMetrics(
        metrics=["fad", "kd"], embedder=JaxLaionCLAP(params=p, cfg=JaxHTSATConfig(**SMALL)),
        win_dur=5.0, input_sr=SR, batch_size=4, device_indices=[0],
    )
    jam.add_reference(jnp.asarray(ref))
    want = jam.evaluate(jnp.asarray(cand))

    am = AudioMetrics(
        metrics=["fad", "kd"], embedder=LaionCLAP(params=p, cfg=cfg, device="cpu"),
        win_dur=5.0, input_sr=SR, batch_size=4, device="cpu",
    )
    am.add_reference(torch.from_numpy(ref))
    got = am.evaluate(cand)  # numpy input is moved to the embedder's device

    np.testing.assert_allclose(
        am.stem_reference.embeddings.numpy(), np.asarray(jam.stem_reference.embeddings),
        atol=1e-6,
    )
    assert set(got) == set(want) == {"fad", "kernel_distance_mean", "kernel_distance_std"}
    assert all(np.isfinite(v) for v in got.values())
    assert got["fad"] == pytest.approx(want["fad"], rel=1e-5)
    for k in ("kernel_distance_mean", "kernel_distance_std"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-7), k


def test_slice_bf16_close_to_f32():
    """The bf16 forward (plain versions on the CPU) stays close to f32:
    the JAX suite's cosine bound (tests/test_models.py:318)."""
    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    audio = torch.from_numpy(_clips(2, 2))
    e32 = LaionCLAP(params=p, cfg=cfg, device="cpu").embed(audio)
    e16 = LaionCLAP(params=p, cfg=cfg, device="cpu", compute_dtype="bfloat16").embed(audio)
    assert torch.all((e32 * e16).sum(dim=1) > 0.995)


def test_cpu_runs_plain_versions_only():
    """On CPU tensors every wrapper takes its plain version: no launch is
    counted and no kernel library is built."""
    from audio_metrics_tpu_torch import kernels

    before = {k: v.launches for k, v in KERNELS.items()}
    cfg = HTSATConfig(**SMALL)
    emb = LaionCLAP(params=_params(cfg), cfg=cfg, device="cpu", compute_dtype="bfloat16")
    out = emb.embed(torch.from_numpy(_clips(3, 1)))
    assert out.shape == (1, 512) and torch.isfinite(out).all()
    assert {k: v.launches for k, v in KERNELS.items()} == before
    assert kernels._lib is None


@pytest.mark.parametrize("n,win,hop", [(1000, 300, 300), (1000, 300, 200), (300, 300, 300),
                                       (200, 300, 300)])
def test_device_windows_match_jax(n, win, hop):
    from audio_metrics_tpu.parallel.pipeline import _device_windows
    from audio_metrics_tpu_torch.ops.windowing import device_windows

    x = np.random.default_rng(0).standard_normal((3, n)).astype(np.float32)
    want = _device_windows(jnp.asarray(x), win, hop)
    got = device_windows(torch.from_numpy(x), win, hop)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reset_reference_and_call():
    """evaluate == __call__; reset_reference empties the reference."""
    cfg = HTSATConfig(**SMALL)
    am = AudioMetrics(metrics=["fad"], embedder=LaionCLAP(params=_params(cfg), cfg=cfg,
                                                          device="cpu"), device="cpu")
    clips = _clips(4, 3)
    am.add_reference(clips)
    assert am(clips) == am.evaluate(clips)
    am.reset_reference()
    with pytest.raises(ValueError, match="empty"):
        am.evaluate(clips)


def test_package_imports_no_jax():
    code = (
        "import sys, audio_metrics_tpu_torch, audio_metrics_tpu_torch.convert, "
        "audio_metrics_tpu_torch.models.clap, audio_metrics_tpu_torch.__main__, "
        "audio_metrics_tpu_torch.parallel.native_loader, audio_metrics_tpu_torch.parallel.stream, "
        "audio_metrics_tpu_torch.parallel.mesh, audio_metrics_tpu_torch.utils.example_utils, "
        "audio_metrics_tpu_torch.examples.basic_usage, "
        "audio_metrics_tpu_torch.examples.multi_embedder_sweep, "
        "audio_metrics_tpu_torch.examples.streaming_eval, "
        "audio_metrics_tpu_torch.examples.real_weights_eval, "
        "audio_metrics_tpu_torch.examples.musdb, "
        "audio_metrics_tpu_torch.examples.benchmark_pipeline; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'audio_metrics_tpu')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_unported_surface_raises():
    cfg = HTSATConfig(**SMALL)
    emb = LaionCLAP(params=_params(cfg), cfg=cfg, device="cpu")
    # multi-GPU is ported: indices that name a device twice raise
    with pytest.raises(ValueError, match="more than once"):
        AudioMetrics(metrics=["fad"], embedder=emb, device="cpu", device_indices=[0, 0])
    # APA takes context+stem pairs; mono stems raise the JAX package's error
    with pytest.raises(ValueError, match="pairing context and stem"):
        AudioMetrics(metrics=["apa", "fad"], embedder=emb, device="cpu").add_reference(
            np.zeros((2, 5 * SR), np.float32)
        )
    am = AudioMetrics(metrics=["fad"], embedder=emb, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        am.evaluate(_clips(0, 1))
    # songs of any length in a list take the host-fed path (its partial
    # last windows dropped): a list evaluates
    songs = [*_clips(1, 2), np.concatenate([_clips(2, 1)[0], _clips(3, 1)[0][: 2 * SR]])]
    am.add_reference(songs)
    assert am.stem_reference.n == 3 and np.isfinite(am.evaluate(songs[::-1])["fad"])
    with pytest.raises(ValueError, match="10 s"):  # CLAP takes at most 10 s windows
        AudioMetrics(metrics=["fad"], embedder=emb, device="cpu", win_dur=12.0).add_reference(
            np.zeros((1, 12 * SR), np.float32)
        )
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LaionCLAP(params=_params(cfg), cfg=cfg, device="cuda")
