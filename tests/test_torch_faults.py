"""Two faults of the port, repaired, on the CPU.

- Kernels launch on their operands' card: ``Kernel.launch`` enters that
  card's device guard and passes that card's current stream, whichever card
  is current.  The CPU has no card, so ``torch.cuda``'s guard and stream
  are stood in for, and the operands report ``cuda:1`` while card 0 is
  current.
- ``AudioMetrics`` takes the JAX package's parameters in the JAX order
  (then ``device``), and every argument the port does not implement raises
  ``NotImplementedError`` away from its default, so that one call never
  returns other keys in the two packages.

- The fused frontend's plain version runs no kernel: its log-mel takes the
  halo log-mel kernel's plain version on any device (it went through
  ``log_mel_halo``, which launches that kernel on a CUDA tensor, so the
  card compared the frontend kernel against a chain holding another
  kernel).  Pinned on the CPU with ``log_mel_halo`` made to raise.

And the planted faults of ``audio_metrics_tpu_torch.plant_faults``, which
show on a card that the smoke's checks fail a wrong kernel: each one's text
occurs exactly once in its source, so that no planted fault is silently
absent when the sources change.
"""

import contextlib
import inspect

import numpy as np
import pytest
import torch

from audio_metrics_tpu import AudioMetrics as JaxAudioMetrics
from audio_metrics_tpu_torch import AudioMetrics, kernels
from audio_metrics_tpu_torch.plant_faults import FAULTS, ROOT


class _OnCard1(torch.Tensor):
    """A CPU tensor that reports ``cuda:1`` as its device."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.fixture
def cards(monkeypatch):
    """torch.cuda's device guard and streams stood in for: card 0 is
    current; the log holds what ``launch`` entered and asked for."""
    log = {"current": 0, "guards": [], "streams": [], "called_on": []}

    @contextlib.contextmanager
    def device(dev):
        old, log["current"] = log["current"], torch.device(dev).index
        log["guards"].append(log["current"])
        try:
            yield
        finally:
            log["current"] = old

    class Stream:
        def __init__(self, index):
            self.cuda_stream = 1000 + index

    def current_stream(dev=None):
        index = log["current"] if dev is None else torch.device(dev).index
        log["streams"].append(index)
        return Stream(index)

    def entry(*cargs):
        log["called_on"].append((log["current"], cargs[-1].value))
        return 0

    class Lib:
        am_test = staticmethod(entry)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(kernels, "build", lambda: Lib())
    return log


def test_launch_takes_the_operands_card_and_its_stream(cards):
    x = torch.Tensor._make_subclass(_OnCard1, torch.zeros(4))
    kernels.Kernel("test", "-", "-").launch("am_test", 3, x, 1.5, x)
    assert cards["guards"] == [1]
    assert cards["streams"] == [1]
    # the entry point ran inside card 1's guard, on card 1's stream
    assert cards["called_on"] == [(1, 1001)]
    assert cards["current"] == 0


def test_launch_raises_on_a_kernel_error(cards, monkeypatch):
    class Lib:
        am_test = staticmethod(lambda *cargs: 700)

    monkeypatch.setattr(kernels, "build", lambda: Lib())
    x = torch.Tensor._make_subclass(_OnCard1, torch.zeros(4))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kernels.Kernel("test", "-", "-").launch("am_test", x)


def test_constructor_has_the_jax_parameters_in_order():
    jax_names = list(inspect.signature(JaxAudioMetrics.__init__).parameters)
    port_names = list(inspect.signature(AudioMetrics.__init__).parameters)
    assert port_names == jax_names + ["device"]
    jax_defaults = {k: p.default for k, p in
                    inspect.signature(JaxAudioMetrics.__init__).parameters.items()}
    port_defaults = {k: p.default for k, p in
                     inspect.signature(AudioMetrics.__init__).parameters.items()}
    assert list(port_defaults["metrics"]) == list(jax_defaults["metrics"]) == ["apa", "fad"]
    for k in jax_names[2:]:
        assert port_defaults[k] == jax_defaults[k], k


class _Embedder:
    device = torch.device("cpu")


@pytest.mark.parametrize("kwargs,match", [
    (dict(), r"metric 'apa'.*item 5.*pass metrics="),
    (dict(metrics=["fad"], hop_dur=2.5), r"hop_dur.*item 1\)"),
    (dict(metrics=["fad"], progress=True), r"progress.*item 2\)"),
    (dict(metrics=["fad"], mix_function="L0"), r"mix_function.*item 5\)"),
    (dict(metrics=["fad"], dcn_slices=2), r"dcn_slices.*item 10\)"),
    (dict(metrics=["fad"], n_pca=16), r"n_pca.*item 6\)"),
    (dict(metrics=["fad"], device_indices=[0]), r"device_indices.*item 10\)"),
])
def test_unported_arguments_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        AudioMetrics(embedder=_Embedder(), device="cpu", **kwargs)


def test_ported_arguments_at_their_defaults_build():
    am = AudioMetrics(["fad", "kd"], None, None, _Embedder(), None, 5.0, None, None, 32, False,
                      None, "cpu")
    assert am.metrics == ["fad", "kd"] and am.win_dur == 5.0 and am.batch_size == 32


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_planted_fault_occurs_once_in_its_source(name):
    path, text, replacement, _ = FAULTS[name]
    assert text != replacement
    assert (ROOT / path).read_text().count(text) == 1


def test_frontend_plain_version_calls_no_kernel_wrapper(monkeypatch):
    from audio_metrics_tpu_torch.models.clap import ClapFrontend
    from audio_metrics_tpu_torch.models.htsat import HTSATConfig, init_params
    from audio_metrics_tpu_torch.ops import mel
    from audio_metrics_tpu_torch.ops.frontend_fused import clap_tokens_fused_plain

    def wrapper(*args, **kwargs):
        raise AssertionError("the plain chain called the halo log-mel kernel's wrapper")

    monkeypatch.setattr(mel, "log_mel_halo", wrapper)
    cfg = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    fr = ClapFrontend(init_params(cfg, seed=0), cfg)
    audio = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 240000)).astype(np.float32))
    tokens = clap_tokens_fused_plain(0.2 * audio, fr, sr=48000, cfg=cfg)
    assert tokens.shape == (1, cfg.grid_size ** 2, cfg.embed_dim)
    assert tokens.dtype == torch.bfloat16 and bool(torch.isfinite(tokens.float()).all())
