"""The APA path's signal processing in the port against the JAX package,
on the CPU: the K-weighting and BS.1770 loudness, the limiter, every mix
of the registry and ``mix_preserve_loudness``, and the APA formula.

Same numpy inputs, made from a seed, through both packages: 1 s signals
at 48, 44.1 and 16 kHz (one shape per rate: the JAX functions compile per
shape on the CPU), and 2 s pairs at 16 kHz for the limiter and the
mixes.

Tolerances (readings of the port against the JAX package on these inputs
in brackets): K-weighted signals, max abs error / max |signal|: "blocked"
5e-5 [1.3e-5 at 48 kHz: two f32 orders of the chunk products], "blocked-
parallel" 2e-5 [6.1e-6], "fir" 2e-6 [2.9e-7], "scan" 1e-12 [2e-13];
loudness atol 1e-5 dB [1.9e-6, one f32 ulp of the gating], 1e-9 for
"scan"; limiter atol 1e-5 [2.4e-6 for the scan, 2.4e-7 blocked, on peaks
~2.7]; mixes atol 1e-5 [2.1e-6 on L2's peaks ~3.4].
"""

import warnings

import importlib

import numpy as np
import pytest
import scipy.signal as ss
import torch

import jax.numpy as jnp

from audio_metrics_tpu.metrics.apa import _apa as jax_apa
from audio_metrics_tpu.ops import iir as jax_iir
from audio_metrics_tpu.ops import limiter as jax_limiter
from audio_metrics_tpu.ops import loudness as jax_loudness
from audio_metrics_tpu.ops import mix as jax_mix
from audio_metrics_tpu_torch.ops import limiter, loudness, mix

# the module: ``metrics`` exports the function ``apa`` under the same name
port_apa = importlib.import_module("audio_metrics_tpu_torch.metrics.apa")

SR = 16000
N = 2 * SR
KW_TOL = {"blocked": 5e-5, "blocked-parallel": 2e-5, "fir": 2e-6, "scan": 1e-12}
MIX_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _noise(seed, shape, std=0.1):
    return (std * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def limiter_pairs(seed=0, n=N):
    """Six (n, 2) pairs: a quiet noise bed (std 0.01) with 0.9 impulses
    every 4000 samples in the context of pairs 0-2 (their L0 mixes peak
    above 1 and are limited), a noise context in pair 3, stems of noise
    at std 0.01-0.1; pair 4's stem silent, pair 5 silent."""
    rng = np.random.default_rng(seed)
    ctx = 0.01 * rng.standard_normal((6, n))
    ctx[3] *= 10
    for i in range(3):
        ctx[i, 500 * i :: 4000] = 0.9
    stem = rng.uniform(0.01, 0.1, (6, 1)) * rng.standard_normal((6, n))
    p = np.stack([ctx, stem], axis=2).astype(np.float32)
    p[4, :, 1] = 0.0
    p[5] = 0.0
    return p


# -- loudness -------------------------------------------------------------------
@pytest.mark.parametrize("sr", [48000, 44100, 16000])
@pytest.mark.parametrize("method", ["blocked", "blocked-parallel", "fir", "scan"])
def test_k_weighted_matches_jax(method, sr):
    x = _noise(sr % 101, (2, sr))
    want = np.asarray(jax_loudness.k_weighted(jnp.asarray(x), sr, method))
    got = loudness.k_weighted(_t(x), sr, method).numpy()
    assert got.dtype == want.dtype == (np.float64 if method == "scan" else np.float32)
    assert np.abs(got - want).max() <= KW_TOL[method] * np.abs(want).max()


@pytest.mark.parametrize("sr", [48000, 44100, 16000])
def test_scan_is_scipy_lfilter(sr):
    """The float64 oracle: the K-weighting cascade through
    ``scipy.signal.lfilter`` stage by stage."""
    x = _noise(3, (2, sr))
    b, a = jax_iir.k_weighting_coeffs(float(sr))
    want = x.astype(np.float64)
    for i in range(2):
        want = ss.lfilter(b[i] / a[i, 0], a[i] / a[i, 0], want)
    got = loudness.k_weighted(_t(x), sr, "scan").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def check_loudness(module):
    """``module.integrated_loudness_batch`` against the JAX function on
    1 s of noise whose level steps by 20 dB halfway (the relative gate
    drops the quiet half), every method at 48, 44.1 and 16 kHz."""
    for sr in (48000, 44100, 16000):
        x = _noise(sr % 101, (2, sr))
        x[:, sr // 2 :] *= 0.1
        for method in ("blocked", "blocked-parallel", "fir", "scan"):
            want = np.asarray(jax_loudness.integrated_loudness_batch(x, sr, method))
            got = module.integrated_loudness_batch(_t(x), sr, method)
            assert got.dtype == torch.float64
            tol = 1e-9 if method == "scan" else 1e-5
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol, err_msg=method)


def test_integrated_loudness_matches_jax():
    check_loudness(loudness)


def test_multichannel_gains_and_meter():
    """(B, n, 5) signals weigh the surrounds by 1.41; ``Meter`` is the same
    computation for one item."""
    x = _noise(5, (1, N, 5))
    want = np.asarray(jax_loudness.integrated_loudness_batch(x, SR))
    got = loudness.integrated_loudness_batch(_t(x), SR).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    mono = loudness.integrated_loudness_batch(_t(x[:, :, :1]), SR).numpy()
    assert np.all(got > mono + 5)  # five channels of equal power, two at +1.5 dB
    meter = loudness.Meter(SR, device="cpu")
    assert meter.integrated_loudness(x[0]) == pytest.approx(
        jax_loudness.Meter(SR).integrated_loudness(x[0]), abs=1e-5)
    assert meter.integrated_loudness_numba(x[0]) == pytest.approx(got[0], abs=0)


@pytest.mark.parametrize("method", ["blocked", "scan"])
def test_silence_is_minus_inf_and_short_audio_raises(method):
    """The JAX floor ``max(., 1e-300)`` is 0 in f32: a silent item reads
    -inf (in both packages), as does a quiet one under the absolute gate."""
    x = np.zeros((2, N), np.float32)
    x[1] = _noise(0, N, std=1e-5)
    got = loudness.integrated_loudness_batch(_t(x), SR, method).numpy()
    want = np.asarray(jax_loudness.integrated_loudness_batch(x, SR, method))
    assert np.all(np.isneginf(got)) and np.all(np.isneginf(want))
    with pytest.raises(ValueError, match="too short"):
        loudness.integrated_loudness_batch(torch.zeros(1, int(0.35 * SR)), SR, method)


# -- limiter --------------------------------------------------------------------
def check_limiter(module):
    """``module``'s blocked and scan limiters against the JAX ones on the
    impulse recipe's contexts (peaks above the 0.5 threshold), and against
    each other."""
    x = np.ascontiguousarray(limiter_pairs()[:4, :, 0] * 3)
    blocked = module._limit_blocked(_t(x), 0.99, 0.99, 0.5, 527).numpy()
    scan = module._limit_scan(_t(x), 0.99, 0.99, 0.5, 527).numpy()
    want_b = np.asarray(jax_limiter._limit_blocked(jnp.asarray(x), 0.99, 0.99, 0.5, 527))
    want_s = np.asarray(jax_limiter._limit_scan(jnp.asarray(x), 0.99, 0.99, 0.5, 527))
    for got, want in ((blocked, want_b), (scan, want_s), (blocked, scan)):
        np.testing.assert_allclose(got, want, rtol=0, atol=MIX_TOL)
    assert np.abs(x).max() > 2 and np.abs(blocked).max() < np.abs(x).max()


def test_limiter_matches_jax():
    check_limiter(limiter)


def test_limit_shapes():
    x = limiter_pairs()[0, :, 0] * 3
    np.testing.assert_allclose(limiter.limit_batch(_t(x)).numpy(),
                               np.asarray(jax_limiter.limit_batch(x)), rtol=0, atol=MIX_TOL)
    out = limiter.limit(np.stack([x, x]))
    assert isinstance(out, np.ndarray) and out.shape == (2, N) and out.dtype == np.float32


# -- mixes ----------------------------------------------------------------------
def _messages(record):
    return [str(w.message) for w in record]


@pytest.mark.parametrize("name", ["PP", "P0", "P1", "P2", "L0", "L1", "L2", "preserve"])
def test_mix_matches_jax(name):
    """Every registry mix and ``mix_preserve_loudness`` on the same pairs
    (limited, one-silent and both-silent items among them), batched and one
    window at a time, with the same warnings."""
    p = limiter_pairs()
    port_fn = mix.mix_preserve_loudness if name == "preserve" else mix.MIX_FUNCTIONS[name]
    jax_fn = jax_mix.mix_preserve_loudness if name == "preserve" else jax_mix.MIX_FUNCTIONS[name]
    with warnings.catch_warnings(record=True) as rec_j:
        warnings.simplefilter("always")
        want = np.asarray(jax_fn(p, sr=SR))
    with warnings.catch_warnings(record=True) as rec_p:
        warnings.simplefilter("always")
        got = port_fn(_t(p), sr=SR)
    assert got.dtype == torch.float32 and got.shape == (6, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MIX_TOL)
    assert _messages(rec_p) == _messages(rec_j)
    assert port_fn.is_batched_mix
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = port_fn(_t(p[2]), sr=SR)
    assert one.shape == (N,)
    np.testing.assert_allclose(one.numpy(), want[2], rtol=0, atol=MIX_TOL)


def test_l0_limits_and_normalises():
    """L0: the impulse pairs are limited, the others read -20 LUFS in the
    float64 oracle, the silent pair passes channel 0 through."""
    p = limiter_pairs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = mix.MIX_FUNCTIONS["L0"](_t(p), sr=SR)
    lufs = loudness.integrated_loudness_batch(out, SR, method="scan").numpy()
    np.testing.assert_allclose(lufs[3:5], -20.0, atol=0.01)
    assert np.all(np.abs(lufs[:3] + 20) > 0.01)  # limited: quieter than the target
    assert torch.equal(out[5], torch.zeros(N))


def test_mix_warnings_immediate_and_deferred():
    """``diag=None``: the three warnings at once; ``diag=[]``: none until
    ``emit_mix_diagnostics``, which reads the flags of every batch."""
    p = _t(limiter_pairs())
    fn = mix.MIX_FUNCTIONS["L0"]
    with pytest.warns(UserWarning) as rec:
        fn(p, sr=SR)
    want = ["Both channels silent (1 of 6 windows)", "One channel silent (1 of 6 windows)"]
    assert _messages(rec)[:2] == want and "3 of 6 windows limited" in _messages(rec)[2]
    diag = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn(p[:3], sr=SR, diag=diag)
        fn(p[3:], sr=SR, diag=diag)
    assert len(diag) == 2
    with pytest.warns(UserWarning) as rec:
        mix.emit_mix_diagnostics(diag)
    assert _messages(rec)[:2] == want and "3 of 6 windows limited" in _messages(rec)[2]
    with pytest.raises(ValueError, match="requires sr"):
        fn(p)


# -- the APA formula ------------------------------------------------------------
def check_apa_formula(apa_fn):
    """The cases of tests/test_metrics_golden.py:231-240, and the JAX
    ``_apa`` on random distances."""
    assert apa_fn(0.0, 2.0, 2.0) == 1.0
    assert apa_fn(2.0, 0.0, 2.0) == 0.0
    assert apa_fn(1.0, 1.0, 2.0) == 0.5
    assert apa_fn(0.0, 5.0, 1.0) == 1.0
    assert apa_fn(0.0, 0.0, 0.0) == 0.0
    assert apa_fn(-1.0, 1.0, 1.0) == 1.0
    for d in np.random.default_rng(0).uniform(-0.5, 3.0, (50, 3)):
        assert apa_fn(*d) == jax_apa(*d)


def test_apa_formula():
    check_apa_formula(port_apa._apa)


