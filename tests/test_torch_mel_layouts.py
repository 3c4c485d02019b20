"""The halo log-mel kernel's (#6) widened layouts against the JAX package, on
the CPU: hop rows padded to a multiple of 8 samples, and the filterbank in
groups of 64 mels.

At a hop that is not a multiple of 8 the kernel writes the signal in rows
of hop_pad samples, the last hop_pad - hop zero (``halo_rows_padded_kernel``)
and reads frame r as the span of its chunks from row r, through the map of
``ops.mel.halo_dft_map``, against the basis of ``_kernel_tables`` whose
columns are zero at the pads.  At a mel count other than 64 the filterbank
(and the affine's scale and offset) are padded with zero columns to whole
groups of 64, each group's rows one after another, and each group's sums
kept apart.  Here the hop rows are built by the kernel's index formula, read
box by box through the map (tests/test_torch_mel.py's helpers), multiplied
by the basis and summed group by group in the kernel's order
(``_fused_epilogue``), then held against ``log_mel_pallas_halo`` in
interpret mode on 2 clips of 1 s (tests/test_torch_mel.py's kernel-vs-JAX
bound: mean abs < 0.02, max abs < 0.5 dB) and against the plain version
under chip_smoke.py's ``LOG_MEL_TOL``.  Two planted faults must fail the
check: the basis read at the hop rows' pads as if the chunks were
contiguous, and a group's filterbank columns shifted by one mel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu.ops.mel import log_mel_pallas_halo
from audio_metrics_tpu_torch.ops.mel import (
    MEL_GROUP,
    _kernel_tables,
    halo_dft_map,
    log_mel_halo_plain,
    mel_filter_bank,
)

from test_torch_mel import (
    LOG_MEL_TOL,
    _frames_through_the_map,
    _fused_epilogue,
    _hop_rows,
    _log_mel_err,
)

SR, FRAME, N_FFT = 48000, 1024, 1024
# (hop, mels): CLAP's frame at hops the 16-byte stride does not divide, and
# mel counts of one group and a half, two groups, three and a bit, and one
# that is not a multiple of 8
CASES = [(484, 128), (300, 96), (484, 200), (480, 100), (300, 64)]


def _operands(hop, n_mels, seed, fault=None):
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy((0.2 * rng.normal(size=(2, SR))).astype(np.float32))
    fb = mel_filter_bank(N_FFT // 2 + 1, n_mels, 50.0, 14000.0, SR, norm="slaney",
                         mel_scale="slaney").astype(np.float32)
    affine = (torch.from_numpy((rng.normal(size=n_mels) * 0.3 + 1).astype(np.float32)),
              torch.from_numpy(rng.normal(size=n_mels).astype(np.float32)))
    kw = dict(frame_length=FRAME, hop_length=hop, n_fft=N_FFT, fb=fb, center=True,
              log_mode="db", out_affine=affine, out_dtype=torch.bfloat16)
    amap = halo_dft_map(2, SR, FRAME, hop, True)
    chunk = amap["chunk"]
    if fault == "contiguous basis":  # the pads read as samples, the chunks contiguous
        chunk = None
    basis_t, fb_p, _ = _kernel_tables(FRAME, amap["dims"][0], N_FFT, fb.tobytes(), n_mels,
                                      chunk, "cpu")
    if fault == "shifted group":
        n_keep_p = fb_p.shape[0] // -(-n_mels // MEL_GROUP)
        fb_p = fb_p.clone()
        fb_p[n_keep_p:2 * n_keep_p] = torch.roll(fb_p[n_keep_p:2 * n_keep_p], 1, dims=1)
    a = _frames_through_the_map(_hop_rows(audio, amap), amap)
    return audio, kw, amap, a, basis_t, fb_p


def _grouped_epilogue(a, basis_t, fb_p, kw):
    """The kernel's arithmetic group by group: each group of 64 mels its
    own sums over the same products (the kernel's launches recompute them),
    against its rows of the filterbank and its columns of the padded
    affine; the groups' columns side by side, cut to n_mels."""
    n_mels = kw["fb"].shape[1]
    groups = -(-n_mels // MEL_GROUP)
    rows = fb_p.shape[0] // groups
    pad = (0, groups * MEL_GROUP - n_mels)
    sc, of = (torch.nn.functional.pad(t, pad) for t in kw["out_affine"])
    out = []
    for g in range(groups):
        cols = slice(g * MEL_GROUP, (g + 1) * MEL_GROUP)
        out.append(_fused_epilogue(a, basis_t, fb_p[g * rows:(g + 1) * rows],
                                   dict(kw, out_affine=(sc[cols], of[cols]))))
    return torch.cat(out, dim=-1)[..., :n_mels]


@pytest.mark.parametrize("hop,n_mels", CASES, ids=[f"hop {h} mels {m}" for h, m in CASES])
def test_padded_hops_and_mel_groups_match_pallas(hop, n_mels):
    audio, kw, amap, a, basis_t, fb_p = _operands(hop, n_mels, seed=hop + n_mels)
    hop_pad, n_frames = amap["strides"][0], amap["n_frames"]
    assert hop_pad % 8 == 0 and 0 <= hop_pad - hop < 8
    assert fb_p.shape == (-(-n_mels // MEL_GROUP) * basis_t.shape[0] // 2, MEL_GROUP)
    got = _grouped_epilogue(a, basis_t, fb_p, kw)[:, :n_frames]
    want = log_mel_halo_plain(audio, **kw)
    assert got.shape == want.shape == (2, n_frames, n_mels) and got.dtype == want.dtype
    rel, mx = _log_mel_err(got, want)
    assert rel <= LOG_MEL_TOL["clap"][0] and mx <= LOG_MEL_TOL["clap"][1], (rel, mx)
    jax_kw = dict(kw, out_affine=tuple(t.numpy() for t in kw["out_affine"]),
                  out_dtype=jnp.bfloat16)
    pallas = np.asarray(log_mel_pallas_halo(jnp.asarray(audio.numpy()), interpret=True,
                                            **jax_kw), np.float32)
    assert pallas.shape == got.shape
    d = np.abs(got.float().numpy() - pallas)
    assert d.mean() < 0.02 and d.max() < 0.5, (d.mean(), d.max())


@pytest.mark.parametrize("fault,hop,n_mels", [("contiguous basis", 484, 128),
                                              ("shifted group", 480, 128),
                                              ("shifted group", 300, 200)])
def test_planted_layout_faults_fail(fault, hop, n_mels):
    """A basis that ignores the hop rows' pads, or a group's filterbank
    columns shifted by one mel, lands far outside the plain version's
    bound."""
    audio, kw, amap, a, basis_t, fb_p = _operands(hop, n_mels, seed=7, fault=fault)
    got = _grouped_epilogue(a, basis_t, fb_p, kw)[:, :amap["n_frames"]]
    rel, mx = _log_mel_err(got, log_mel_halo_plain(audio, **kw))
    assert rel > 10 * LOG_MEL_TOL["clap"][0] and mx > LOG_MEL_TOL["clap"][1], (rel, mx)


def test_padded_basis_columns():
    """At hop 484 (hop_pad 488) column c*488 + i of the basis holds frame
    sample c*484 + i for i < 484 and is zero at the 4 pad columns of each
    chunk and past the frame's last sample; the hop rows' pads are zero.
    At hop 480 the halo's tables are the v1 kernel's (one cached table)."""
    amap = halo_dft_map(2, SR, FRAME, 484, True)
    assert amap["strides"][0] == 488 and amap["dims"][0] == 1088
    fb = mel_filter_bank(N_FFT // 2 + 1, 64, 50.0, 14000.0, SR, norm="slaney",
                         mel_scale="slaney").astype(np.float32)
    padded = _kernel_tables(FRAME, 1088, N_FFT, fb.tobytes(), 64, amap["chunk"], "cpu")[0]
    plain = _kernel_tables(FRAME, 1088, N_FFT, fb.tobytes(), 64, None, "cpu")[0]
    for c in range(3):
        n = min(484, FRAME - 484 * c)
        assert torch.equal(padded[:, 488 * c:488 * c + n], plain[:, 484 * c:484 * c + n])
        assert not padded[:, 488 * c + n:488 * (c + 1)].any()
    assert not padded[:, 488 * 2 + FRAME - 968:].any()
    audio = torch.ones((2, SR))
    rows = _hop_rows(audio, amap).reshape(2, -1)
    assert not rows[:, :488 * 90].reshape(2, 90, 488)[..., 484:].any()
    halo = halo_dft_map(2, SR, FRAME, 480, True)
    assert halo["chunk"] is None and halo["strides"][0] == 480
