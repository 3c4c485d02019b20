"""The command line and the WAV utilities of the port, against the JAX
package's on the CPU.

``python -m audio_metrics_tpu_torch {evaluate, convert}`` runs in-process
(``main([...])``, ``--device cpu``) over WAV directories that the port's
``wavio`` writes, beside ``python -m audio_metrics_tpu`` on the same
directories: the same keys and values, the state round trip, the errors,
and ``convert`` writing the JAX command's ``.npz`` arrays.  The port's
``wavio`` writes the RIFF size the WAV format defines (file size - 8; the
JAX copy writes 4 more), and files of either package read equal in both.
"""

import json
import os
import struct
import tempfile

import numpy as np
import pytest
import torch

from audio_metrics_tpu.__main__ import main as jax_main
from audio_metrics_tpu.utils import example_utils as jax_examples
from audio_metrics_tpu.utils.wavio import read_wav as jax_read_wav
from audio_metrics_tpu.utils.wavio import write_wav as jax_write_wav
from audio_metrics_tpu_torch.__main__ import main
from audio_metrics_tpu_torch.utils import example_utils
from audio_metrics_tpu_torch.utils import wavio
from audio_metrics_tpu_torch.utils.wavio import read_wav, write_wav

SR = 16000


def _write_dir(path, n_items, seed, seconds=2.5, dtype="float32", loud=0.2):
    """``n_items`` mono WAV files of seeded noise, each of another length
    between ``seconds`` and twice that."""
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_items):
        n = int(SR * seconds * rng.uniform(1.0, 2.0))
        write_wav(path / f"{i:03d}.wav", loud * rng.standard_normal(n), SR, dtype=dtype)


def _run(fn, argv, capsys):
    assert fn(argv) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_cli_evaluate_matches_jax(tmp_path, capsys, dtype):
    """``evaluate`` over WAV directories (dummy embedder, 2.5-5 s files in
    1 s windows) in both packages: the same keys in the same order, FAD
    and KD within 1e-3 relative, PRDC equal."""
    _write_dir(tmp_path / "ref", 8, seed=0, dtype=dtype)
    _write_dir(tmp_path / "cand", 8, seed=1, dtype=dtype, loud=0.3)
    args = ["evaluate", "--reference", str(tmp_path / "ref"), "--candidate",
            str(tmp_path / "cand"), "--metrics", "fad", "kd", "prdc", "--embedder", "dummy",
            "--win-dur", "1.0", "--batch-size", "8"]
    want = _run(jax_main, args, capsys)
    got = _run(main, args + ["--device", "cpu"], capsys)
    assert list(got) == list(want)
    for key in ("fad", "kernel_distance_mean", "kernel_distance_std"):
        assert got[key] == pytest.approx(want[key], rel=1e-3), key
    for key in ("precision", "recall", "density", "coverage"):
        assert got[key] == want[key], key


def test_cli_state_round_trip(tmp_path, capsys):
    """``--save-state`` with a reference, then ``--load-state`` alone: the
    same FAD (rtol 1e-6); the JAX command reads the port's state file to
    the same FAD."""
    _write_dir(tmp_path / "ref", 6, seed=2)
    _write_dir(tmp_path / "cand", 6, seed=3, loud=0.3)
    state = tmp_path / "ref_state.npz"
    common = ["--metrics", "fad", "--embedder", "dummy", "--win-dur", "1.0"]
    first = _run(main, ["evaluate", "--reference", str(tmp_path / "ref"), "--candidate",
                        str(tmp_path / "cand"), "--save-state", str(state), "--device", "cpu"]
                 + common, capsys)
    second = _run(main, ["evaluate", "--load-state", str(state), "--candidate",
                         str(tmp_path / "cand"), "--input-sr", str(SR), "--device", "cpu"]
                  + common, capsys)
    np.testing.assert_allclose(second["fad"], first["fad"], rtol=1e-6)
    jax_second = _run(jax_main, ["evaluate", "--load-state", str(state), "--candidate",
                                 str(tmp_path / "cand"), "--input-sr", str(SR)] + common, capsys)
    np.testing.assert_allclose(jax_second["fad"], first["fad"], rtol=1e-5)
    assert main(["evaluate", "--reference", str(tmp_path / "ref"), "--save-state",
                 str(tmp_path / "only.npz"), "--device", "cpu"] + common) == 0
    assert (tmp_path / "only.npz").exists()


def test_cli_errors(tmp_path):
    """The JAX command's errors: a directory without WAV files, no
    reference and no state, no candidate and no state to write, two rates
    in one directory."""
    (tmp_path / "empty").mkdir()
    _write_dir(tmp_path / "ref", 2, seed=4)
    write_wav(tmp_path / "ref" / "zz.wav", np.zeros(SR), 22050)
    _write_dir(tmp_path / "ok", 2, seed=5)
    for argv, match in (
        (["evaluate", "--candidate", str(tmp_path / "nope")], "no .wav files"),
        (["evaluate", "--reference", str(tmp_path / "empty")], "no .wav files"),
        (["evaluate", "--candidate", str(tmp_path / "ok")], "need --reference"),
        (["evaluate", "--reference", str(tmp_path / "ok"), "--embedder", "dummy"],
         "need --candidate"),
        (["evaluate", "--reference", str(tmp_path / "ref")], "sample rate 22050"),
    ):
        for fn in (main, jax_main):
            extra = ["--device", "cpu"] if fn is main else []
            with pytest.raises(SystemExit, match=match):
                fn(argv + extra)


def test_cli_convert_writes_the_jax_npz(tmp_path, capsys):
    """``convert`` of a torchvggish ``.pth``: the same arrays, bitwise, as
    the JAX command's; of a LAION CLAP ``.pt`` (HTSAT-base, seeded weights,
    ``module.`` prefix, fused qkv, under ``state_dict``): the parameter
    dict it was written from, bitwise, every key and no other (the JAX
    command's conversion of the same file is held equal to the port's
    ``convert_checkpoint`` in tests/test_torch_ckpt.py)."""
    from audio_metrics_tpu_torch.models.clap import init_projection_params
    from audio_metrics_tpu_torch.models.htsat import HTSAT_BASE, init_params
    from audio_metrics_tpu_torch.testing import laion_state_dict
    from test_torch_vggish import seeded_params

    src = tmp_path / "vggish.pth"
    torch.save({k: torch.from_numpy(v) for k, v in seeded_params().items()}, src)
    got, want = tmp_path / "vggish_port.npz", tmp_path / "vggish_jax.npz"
    assert main(["convert", str(src), str(got), "--arch", "vggish"]) == 0
    assert jax_main(["convert", str(src), str(want), "--arch", "vggish"]) == 0
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files) and len(g.files) == 18
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k])
    src = tmp_path / "clap.pt"
    params = dict(init_params(HTSAT_BASE, seed=1), **init_projection_params(HTSAT_BASE, seed=1))
    torch.save({"state_dict": laion_state_dict(params)}, src)
    assert main(["convert", str(src), str(tmp_path / "clap.npz")]) == 0
    with np.load(tmp_path / "clap.npz") as g:
        assert sorted(g.files) == sorted(params)
        for k in g.files:
            np.testing.assert_array_equal(g[k], params[k])
    capsys.readouterr()


def check_riff_size(write):
    """``write`` (the port's ``write_wav``) gives RIFF size = file size - 8
    in float32 and int16, mono and stereo, and the file reads equal in both
    packages."""
    rng = np.random.default_rng(6)
    with tempfile.TemporaryDirectory() as tmp:
        for shape in ((1001,), (999, 2)):
            for dtype in ("float32", "int16"):
                fp = os.path.join(tmp, f"{dtype}_{len(shape)}.wav")
                write(fp, np.clip(0.4 * rng.standard_normal(shape), -1, 1), SR, dtype=dtype)
                with open(fp, "rb") as f:
                    raw = f.read()
                assert struct.unpack("<I", raw[4:8])[0] == len(raw) - 8, (dtype, shape)
                got, sr = read_wav(fp)
                want, jsr = jax_read_wav(fp)
                assert sr == jsr == SR and got.shape == (shape[0], len(shape))
                np.testing.assert_array_equal(got, want)


def test_wav_riff_size_and_reads_in_both_packages():
    check_riff_size(write_wav)


def test_jax_wav_files_read_equal_in_the_port(tmp_path):
    """The JAX copy's files (RIFF size 4 too large) read equal in the
    port's reader, in both formats."""
    data = 0.3 * np.random.default_rng(7).standard_normal((500, 2))
    for dtype in ("float32", "int16"):
        fp = tmp_path / f"{dtype}.wav"
        jax_write_wav(fp, data, 44100, dtype=dtype)
        raw = fp.read_bytes()
        assert struct.unpack("<I", raw[4:8])[0] == len(raw) - 4  # the JAX copy's size
        got, want = read_wav(fp), jax_read_wav(fp)
        assert got[1] == want[1] == 44100
        np.testing.assert_array_equal(got[0], want[0])
    assert wavio.__all__ == ["write_wav", "read_wav"]


def test_example_utils_write_the_jax_samples(tmp_path):
    """``generate_audio_samples``: the same real/ and fake/ pairs as the
    JAX package's for a seed, read back equal."""
    example_utils.generate_audio_samples(tmp_path / "port", n_items=3, sr=8000,
                                         audio_len=4000, seed=3)
    jax_examples.generate_audio_samples(tmp_path / "jax", n_items=3, sr=8000, audio_len=4000,
                                        seed=3)
    for name in ("real", "fake"):
        for i in range(3):
            got, sr = read_wav(tmp_path / "port" / name / f"sample_{i:02d}.wav")
            want, jsr = jax_read_wav(tmp_path / "jax" / name / f"sample_{i:02d}.wav")
            assert sr == jsr == 8000 and got.shape == (4000, 2)
            np.testing.assert_array_equal(got, want)
