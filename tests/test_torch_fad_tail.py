"""``AM_TPU_FAD_TAIL``: the four FAD tails of the port against the JAX
package's, on the CPU.

The JAX package reads the variable at each call (audio_metrics_tpu/
metrics/fad.py:144-145, :205-256): ``nsdev`` (the default), ``eigdev``,
``packed`` or ``host``; a value it does not name takes its ``packed``
branch.  Both packages are handed the same f32 moments (one pending
device triple for the candidate, d = 64 and n = 200; the reference merged
in float64), so the tails differ only where they compute.  Bounds: ``host``
is the float64 ``frechet_distance`` in both, rtol 1e-12; ``packed`` (f32 M,
float64 eigenvalues on the host) and ``eigdev`` (f32 eigenvalues) the f32
class, rtol 1e-5 (tests/test_fad_device_tail.py's bound against the host
path, ~1e-7 read); ``nsdev`` the same.  Then an ``AudioMetrics`` evaluate
under ``AM_TPU_FAD_TAIL=host`` equals the float64 ``frechet_distance`` of
its candidate's moments at rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_metrics_tpu.data import AudioMetricsData as JaxData
from audio_metrics_tpu.metrics.fad import fad_device_tail as jax_fad_device_tail
from audio_metrics_tpu.metrics.fad import frechet_distance as jax_frechet_distance
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.data import AudioMetricsData, batch_moments
from audio_metrics_tpu_torch.metrics.fad import fad_device_tail, frechet_distance

D, N = 64, 200
SR = 16000
W = (np.random.default_rng(7).standard_normal((256, D)) / 8).astype(np.float32)


def _moments(seed, n, shift=0.0):
    """(n, sum, centered sum of squares) of n seeded f32 rows, in f32."""
    e = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32) + np.float32(shift)
    s1 = e.sum(axis=0, dtype=np.float32)
    c = e - s1 / np.float32(n)
    return n, s1, (c.T @ c).astype(np.float32)


def _sets(jax_side: bool):
    """(candidate with one pending device triple, reference) of one
    package, from the same moments."""
    n, s1, m2 = _moments(1, N, shift=0.3)
    rn, rs1, rm2 = _moments(2, 3 * N)
    if jax_side:
        cand, ref = JaxData(store_embeddings=False), JaxData(store_embeddings=False)
        cand.add_moments_device(n, jnp.asarray(s1), jnp.asarray(m2))
    else:
        cand = AudioMetricsData(store_embeddings=False, device="cpu")
        ref = AudioMetricsData(store_embeddings=False, device="cpu")
        cand.add_moments_device(n, torch.from_numpy(s1), torch.from_numpy(m2))
    ref.add_moments(rn, rs1, rm2)
    return cand, ref


def _jax_fad(mode):
    cand, ref = _sets(True)
    out = jax_fad_device_tail(cand, ref, mode=mode)
    if out is None:
        return None, jax_frechet_distance(cand, ref)
    arrs, finish, _ = out
    return finish(jax.device_get(arrs)), None


@pytest.mark.parametrize("mode,rtol", [("host", 1e-12), ("packed", 1e-5), ("eigdev", 1e-5),
                                       ("nsdev", 1e-5), ("eig", 1e-5)])
def test_tail_matches_jax(monkeypatch, mode, rtol):
    """Each mode, read from ``AM_TPU_FAD_TAIL`` at the call, against the
    JAX function given the same mode; "eig", a name the JAX package does
    not know, takes the ``packed`` branch in both.  ``host`` has no device
    tail in either: both callers take the float64 ``frechet_distance``."""
    monkeypatch.setenv("AM_TPU_FAD_TAIL", mode)
    want_tail, want_host = _jax_fad(mode)
    cand, ref = _sets(False)
    got = fad_device_tail(cand, ref)
    assert len(cand._pending) == 1  # the candidate's triple stays in place
    if mode == "host":
        assert got is None and want_tail is None
        got, want = frechet_distance(cand, ref), want_host
    else:
        assert got is not None and want_tail is not None
        want = want_tail
    assert np.isfinite(got) and got == pytest.approx(want, rel=rtol)
    if mode in ("packed", "eig"):  # float64 eigenvalues of the same f32 M: closer still
        assert got == pytest.approx(fad_device_tail(*_sets(False), mode="packed"), rel=0)


class Proj:
    """A full-rank seeded embedder of the port: d = 64 from 256 samples."""

    sr = SR
    device = torch.device("cpu")

    def embed(self, audio):
        return audio[:, :256] @ torch.from_numpy(W)


def test_evaluate_host_tail_is_float64(monkeypatch):
    """``AudioMetrics(metrics=["fad"])`` on 200 + 200 clips in one batch
    (so the candidate's moments are one f32 triple): under
    ``AM_TPU_FAD_TAIL=host`` its FAD is the float64 ``frechet_distance`` of
    those moments against the reference, at rtol 1e-12; the default tail
    (f32 on the device) differs from it at the f32 class."""
    rng = np.random.default_rng(5)
    ref_clips = (0.2 * rng.standard_normal((N, SR))).astype(np.float32)
    cand_clips = (0.25 * rng.standard_normal((N, SR))).astype(np.float32)
    am = AudioMetrics(metrics=["fad"], embedder=Proj(), win_dur=1.0, input_sr=SR,
                      batch_size=N, device="cpu")
    am.add_reference(ref_clips)
    cand = AudioMetricsData(store_embeddings=False, device="cpu")
    n, s1, m2 = batch_moments(Proj().embed(torch.from_numpy(cand_clips)))
    cand.add_moments_device(N, s1, m2)
    want = frechet_distance(cand, am.stem_reference)
    monkeypatch.setenv("AM_TPU_FAD_TAIL", "host")
    assert am.evaluate(cand_clips)["fad"] == pytest.approx(want, rel=1e-12)
    monkeypatch.delenv("AM_TPU_FAD_TAIL")
    default = am.evaluate(cand_clips)["fad"]
    assert default == pytest.approx(want, rel=1e-5) and default != want
