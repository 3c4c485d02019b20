"""The port's examples (``audio_metrics_tpu_torch.examples``) on the CPU.

Each example's ``main`` runs in this process at a tiny size with
``--device cpu`` and prints finite numbers; ``real_weights_eval`` without a
checkpoint and ``musdb`` without its package exit with their messages.
Nothing is downloaded: checkpoint downloads are refused here.
"""

import ast
import math
import re
import sys

import pytest

from audio_metrics_tpu_torch.utils import get_url


@pytest.fixture(autouse=True)
def no_download(monkeypatch, tmp_path):
    def refuse(url):
        raise RuntimeError(f"test refused to download {url}")

    monkeypatch.setattr(get_url, "download_url", refuse)
    for k in ("AM_TPU_CKPT_DIR", "AM_TPU_CACHE_DIR", "AM_TPU_ALLOW_RANDOM_WEIGHTS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "empty_cache"))


def finite_dict(out: str, label: str) -> dict:
    line = next(x for x in out.splitlines() if x.startswith(label))
    values = ast.literal_eval(line[len(label):].strip())
    assert values and all(math.isfinite(v) for v in values.values()), line
    return values


def test_basic_usage(capsys):
    from audio_metrics_tpu_torch.examples import basic_usage

    assert basic_usage.main(["--embedder", "dummy", "--n-items", "4", "--sr", "16000",
                             "--seconds", "1", "--win-dur", "0.5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for label in ("real:", "fake:"):
        assert set(finite_dict(out, label)) == {"fad", "apa"}


def test_multi_embedder_sweep(capsys):
    """The dummy and VGGish (seeded random weights, its checkpoint absent)
    through the registry: near candidates beat far ones under both."""
    from audio_metrics_tpu_torch.examples import multi_embedder_sweep

    assert multi_embedder_sweep.main(["--embedders", "dummy,vggish", "--n-clips", "6",
                                      "--input-sr", "16000", "--seconds", "1",
                                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "sweep OK" in out
    fads = [float(x) for x in re.findall(r"fad\s+(\S+) /\s+(\S+)", out)[0]]
    assert len(re.findall(r"^(dummy|vggish)\s", out, re.M)) == 2 and all(map(math.isfinite, fads))


def test_streaming_eval_over_a_cpu_mesh(capsys):
    from audio_metrics_tpu_torch.examples import streaming_eval

    assert streaming_eval.main(["--n-clips", "20", "--seconds", "1", "--batch-size", "6",
                                "--devices", "0-3", "--metrics", "fad,kd",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mesh: Mesh(['cpu', 'cpu', 'cpu', 'cpu'], shape=(4,))" in out
    assert "(20 windows)" in out
    result = ast.literal_eval(out.split("-> ", 1)[1].strip())
    assert set(result) == {"fad", "kernel_distance_mean", "kernel_distance_std"}
    assert all(math.isfinite(v) for v in result.values())


def test_real_weights_eval_exits_without_a_checkpoint(capsys):
    from audio_metrics_tpu_torch.examples import real_weights_eval

    assert real_weights_eval.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "No real CLAP checkpoint" in out and "music_audioset_epoch_15_esc_90.14.pt" in out


def test_musdb_exits_naming_its_package(monkeypatch):
    from audio_metrics_tpu_torch.examples import musdb

    monkeypatch.setitem(sys.modules, "musdb", None)  # not installed
    with pytest.raises(SystemExit, match="`musdb` package"):
        musdb.main(["--device", "cpu"])


def test_benchmark_pipeline_writes_a_trace(capsys, tmp_path):
    from audio_metrics_tpu_torch.examples import benchmark_pipeline

    assert benchmark_pipeline.main(["--n-songs", "2", "--song-duration", "1.5", "--win-dur",
                                    "0.5", "--apa", "--mix-function", "PP", "--batch-size",
                                    "4", "--trace-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rate = float(re.search(r"windows/sec:\s+(\S+)", out).group(1))
    assert math.isfinite(rate) and rate > 0
    assert "category stem: n=6" in out and "category aligned: n=6" in out
    assert (tmp_path / "pipeline_trace.json").stat().st_size > 0
