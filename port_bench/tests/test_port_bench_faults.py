"""A whole run on the CPU (the harness's look for a card skipped, the port
on its plain versions) comes out correct; with the timed path broken
underneath, ``correct`` comes out false."""

from __future__ import annotations

import time

import pytest
import torch

from _tiny import tiny_cell
from port_bench import harness

SEED = 2**31 + 4321


def run(cell, seconds=1.0):
    line, err = harness.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                                 device_type="cpu", min_evals=2)
    return line, err


def test_sound_run_is_correct_and_prints_the_contract_line():
    line, err = run(tiny_cell())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["metrics"]) == {"setup_s", "eval_clips_per_s"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert err[-1].startswith("check prdc_err") and err[-1].endswith("ok")


def test_sound_run_over_two_shards_is_correct():
    line, _ = run(tiny_cell(chips=2))
    assert line["correct"]


def _stale(monkeypatch):
    """A step that returns its state unchanged: evaluate answers with the
    result of its first call."""
    from audio_metrics_tpu_torch import audio_metrics

    orig, first = audio_metrics.AudioMetrics.evaluate, []

    def evaluate(self, candidate):
        out = orig(self, candidate)
        first.append(out)
        return first[0]

    monkeypatch.setattr(audio_metrics.AudioMetrics, "evaluate", evaluate)


def _half_batch(monkeypatch):
    """Half of each batch left out: its rows are the other half's again, so
    the moments are taken over the rest."""
    from audio_metrics_tpu_torch.models import clap

    orig = clap.LaionCLAP.embed

    def embed(self, audio):
        h = max(1, audio.shape[0] // 2)
        e = orig(self, audio[:h])
        return e.repeat(2, 1)[: audio.shape[0]]

    monkeypatch.setattr(clap.LaionCLAP, "embed", embed)


def _no_exchange(monkeypatch):
    """The exchange between devices left out: the first shard's embeddings
    stand for every shard's."""
    from audio_metrics_tpu_torch.parallel import pipeline

    orig = pipeline.sharded_embed_loop

    def sharded(embedders, windows, batch_size, mesh):
        buf, triples = orig(embedders, windows, batch_size, mesh)
        n0 = int(triples[0][0])
        buf = torch.cat([buf[:n0]] * (-(-buf.shape[0] // n0)))[: buf.shape[0]]
        return buf, [triples[0]] * len(triples)

    monkeypatch.setattr(pipeline, "sharded_embed_loop", sharded)


def _row_altered(monkeypatch):
    """An answer altered where it is produced: one embedding of each batch
    moved by 1e-3."""
    from audio_metrics_tpu_torch.models import clap

    orig = clap.LaionCLAP.embed

    def embed(self, audio):
        e = orig(self, audio).clone()
        e[0, 0] += 1e-3
        return e

    monkeypatch.setattr(clap.LaionCLAP, "embed", embed)


def _fad_altered(monkeypatch):
    """An answer altered where it is produced: FAD 0.1% high."""
    from audio_metrics_tpu_torch import audio_metrics

    orig = audio_metrics.frechet_distance
    monkeypatch.setattr(audio_metrics, "frechet_distance",
                        lambda *a, **k: orig(*a, **k) * 1.001)


@pytest.mark.parametrize("fault,chips", [(_stale, 1), (_half_batch, 1), (_no_exchange, 2),
                                         (_row_altered, 1), (_fad_altered, 1)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, chips):
    fault(monkeypatch)
    line, err = run(tiny_cell(chips=chips))
    assert not line["correct"], err
