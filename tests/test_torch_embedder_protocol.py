"""The embedder protocol of the port against the JAX package on the CPU:
``forward(data)`` of the shipped embedders (LaionCLAP's host crop of clips
over 10 s, VGGish, the dummy), and an object of the user's with ``sr`` and
``forward(data)`` only through ``AudioMetrics`` (stems, the APA pair path,
the host-fed path) and ``embedding_pipeline``.  Small sizes: the small
HTSAT of tests/test_torch_slice.py in f32, VGGish and the dummy on 1-2 s.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

import audio_metrics_tpu.models.clap as jax_clap
from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu.models.dummy import DummyEmbedder as JaxDummy
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.models.vggish import VGGish as JaxVGGish
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.models import DummyEmbedder
from audio_metrics_tpu_torch.models.base import ForwardEmbedder, as_embedder
from audio_metrics_tpu_torch.models.clap import MAX_SAMPLES, LaionCLAP
from audio_metrics_tpu_torch.models.htsat import HTSATConfig
from audio_metrics_tpu_torch.models.vggish import VGGish
from audio_metrics_tpu_torch.ops.mix import MIX_FUNCTIONS
from audio_metrics_tpu_torch.parallel import ItemCategory, embedding_pipeline, make_mesh
from audio_metrics_tpu_torch.testing import seeded_songs
from test_torch_options import FRAME, SR, W_PROJ, JaxProj, Proj, _clips
from test_torch_slice import SMALL, _params
from test_torch_vggish import seeded_params as vggish_params

SR_CLAP = 48000
KEYS = ["fad", "kernel_distance_mean", "kernel_distance_std", "precision", "recall",
        "density", "coverage"]


class UserProj(nn.Module):
    """A user's embedder written to the reference's protocol: an
    ``nn.Module`` with ``sr`` and ``forward(data)`` only (no ``embed``, no
    ``device``); the projection of ``Proj`` / ``JaxProj``, its weight a
    parameter that requires grad."""

    sr = SR

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(W_PROJ.copy()))

    def forward(self, data):
        audio = data["audio"]
        b, n = audio.shape
        frames = audio[:, : n // FRAME * FRAME].reshape(b, -1, FRAME)
        return {"embedding": torch.tanh(frames @ self.w).mean(dim=1)}


# -- LaionCLAP.forward ---------------------------------------------------------
def _clap_clips(seed, n, seconds):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((n, int(seconds * SR_CLAP)))).astype(np.float32)


def check_clap_crops(clap_cls):
    """``forward`` on a clip of 12 s, twice, hands ``embed`` the JAX
    package's crops for the same seed (its ``_repeatpad_np`` on
    ``default_rng(seed)``, the generator advancing from call to call),
    bitwise."""
    cfg = HTSATConfig(**SMALL)
    emb = clap_cls(params=_params(cfg), cfg=cfg, seed=5, device="cpu")
    seen = []
    emb.embed = lambda audio: seen.append(audio) or torch.zeros(len(audio), 512)
    x = _clap_clips(2, 1, 12)
    rng = np.random.default_rng(5)
    for _ in range(2):
        emb.forward({"audio": x})
        want = jax_clap._repeatpad_np(x, MAX_SAMPLES, rng)
        assert torch.equal(seen.pop(), torch.from_numpy(want)), "the crop is not the JAX one"


def test_clap_forward_matches_jax():
    """``LaionCLAP.forward`` against the JAX one with the same ``seed``, on
    a 12 s clip (cropped on the host) and a 3 s clip given 1-D
    (repeat-padded on the device): embeddings within atol 1e-6
    (tests/test_torch_slice.py's bound); the 12 s clip's bitwise ``embed``
    of the JAX crop; the crops as check_clap_crops holds them."""
    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    port = LaionCLAP(params=p, cfg=cfg, seed=5, device="cpu")
    jax = jax_clap.LaionCLAP(params=p, cfg=JaxHTSATConfig(**SMALL), seed=5)
    long, short = _clap_clips(2, 1, 12), _clap_clips(3, 1, 3)[0]
    for audio in (long, short):
        got = port({"audio": audio})["embedding"]
        want = np.asarray(jax.forward({"audio": audio})["embedding"])
        assert got.shape == want.shape == (1, 512) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        if audio is long:
            crop = jax_clap._repeatpad_np(long, MAX_SAMPLES, np.random.default_rng(5))
            assert torch.equal(port.embed(torch.from_numpy(crop)), got)
    check_clap_crops(LaionCLAP)


# -- VGGish and the dummy -----------------------------------------------------------
def test_vggish_and_dummy_forward_match_jax():
    """``forward`` (and calling the module) on 1-D and 2-D audio: VGGish f32
    within tests/test_torch_vggish.py's rtol 2e-3 / atol 2e-4, the dummy
    within rtol 1e-6 of the JAX ones."""
    p = vggish_params()
    audio = _clips(4, 2, 1.5)
    vg, jvg = VGGish(params=p, device="cpu"), JaxVGGish(params=p)
    want = np.asarray(jvg.forward({"audio": audio})["embedding"])
    got = vg.forward({"audio": audio})["embedding"]
    assert got.shape == (2, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)
    one = vg({"audio": torch.from_numpy(audio[1])})["embedding"]
    np.testing.assert_allclose(one.numpy(), want[1:], rtol=2e-3, atol=2e-4)
    dummy = DummyEmbedder(device="cpu")
    want = np.asarray(JaxDummy().forward({"audio": audio})["embedding"])
    np.testing.assert_allclose(dummy({"audio": audio})["embedding"].numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(dummy.forward({"audio": audio[0]})["embedding"].numpy(),
                               want[:1], rtol=1e-6)


# -- a user's forward-only embedder ------------------------------------------------
def test_user_embedder_through_audio_metrics_matches_jax():
    """``AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=UserProj())``
    against the JAX package's with ``JaxProj``: FAD and KD within 1e-6
    relative, PRDC equal; bitwise the port's ``embed``-based ``Proj``; the
    stored embeddings carry no autograd graph.  The candidates carry a DC
    offset of 0.1, so that KD (0.077) is no cancellation of its Gram sums
    down to their f32 rounding, where a relative bound means nothing."""
    ref, cand = _clips(8, 6, 1.0), _clips(9, 6, 1.0) + np.float32(0.1)
    kw = dict(metrics=["fad", "kd", "prdc"], win_dur=0.5, batch_size=8)
    jam = JaxAudioMetrics(embedder=JaxProj(), device_indices=[0], **kw)
    jam.add_reference(jnp.asarray(ref))
    want = jam.evaluate(jnp.asarray(cand))
    am = AudioMetrics(embedder=UserProj(), device="cpu", **kw)
    assert isinstance(am.embedder, ForwardEmbedder) and am.embedder.device.type == "cpu"
    am.add_reference(ref)
    got = am.evaluate(cand)
    assert list(got) == KEYS
    for key in KEYS[:3]:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    assert [got[k] for k in KEYS[3:]] == [want[k] for k in KEYS[3:]]
    assert not am.stem_reference.embeddings.requires_grad
    own = AudioMetrics(embedder=Proj(), device="cpu", **kw)
    own.add_reference(ref)
    assert own.evaluate(cand) == got


def test_user_embedder_on_the_pair_and_host_fed_paths():
    """The same object through the APA pair path (``embedding_pipeline``,
    ``L0``, seed 7) and the host-fed path (``AudioMetrics`` on a list of
    songs): every set bitwise the one of the port's ``Proj``.  With a
    ``device`` attribute the wrapper takes it; a mesh of shards on that
    device shares the one object."""
    rng = np.random.default_rng(12)
    pairs = (0.2 * rng.standard_normal((4, 2 * SR, 2))).astype(np.float32)
    mesh = make_mesh(devices=["cpu"])
    kw = dict(apa_mode="reference", stems_mode=True, store_mix_embeddings=True,
              store_stem_embeddings=True, win_dur=1.0, batch_size=4, seed=7)
    got = embedding_pipeline(pairs, UserProj(), MIX_FUNCTIONS["L0"], mesh=mesh, **kw)
    want = embedding_pipeline(pairs, Proj(), MIX_FUNCTIONS["L0"], mesh=mesh, **kw)
    assert list(got) == list(want) == [ItemCategory.aligned, ItemCategory.misaligned,
                                       ItemCategory.stem]
    for c in want:
        assert got[c].n == want[c].n == 8
        assert torch.equal(got[c].embeddings, want[c].embeddings), c

    songs, cand = (seeded_songs(12, SR, SR, s, candidate=c, max_windows=4)
                   for s, c in ((13, False), (14, True)))
    results = []
    for emb in (UserProj(), Proj()):
        am = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=emb, win_dur=1.0,
                          batch_size=4, device="cpu")
        am.add_reference(songs)
        results.append(am.evaluate(cand))
    assert results[0] == results[1] and am.stem_reference.n == 12

    class OnDevice(UserProj):
        device = torch.device("cpu")

    wrapped = as_embedder(OnDevice(), "cuda")  # the object's device wins
    assert wrapped.device.type == "cpu" and as_embedder(wrapped) is wrapped
    assert make_mesh(devices=["cpu", "cpu"]).replicas(wrapped) == [wrapped, wrapped]
    assert not hasattr(wrapped, "replicate")


def test_get_embedder_builds_on_the_instance_device():
    am = AudioMetrics(metrics=["fad"], embedder="dummy", device="cpu")
    assert isinstance(am.embedder, DummyEmbedder) and am.embedder.device.type == "cpu"
    other = am.get_embedder("dummy")
    assert isinstance(other, DummyEmbedder) and other is not am.embedder
    assert other.device.type == "cpu"
    with pytest.raises(ValueError, match="Unknown embedder"):
        am.get_embedder("clap_v2")
