"""The halo and v1 log-mels and the CLAP windows that do not tile 10 s,
against the JAX package on the CPU.

``log_mel_halo_plain`` (the plain version of the halo log-mel kernel) is
held against ``log_mel_pallas_halo`` in interpret mode at the CLAP and the
VGGish conventions of tests/test_pallas_model_kernels.py:295-310, under
that file's kernel-vs-XLA bound (mean abs < 0.02, max abs < 0.5 dB or log
units: both round frames and basis to bf16 and sum in f32 in another
order, so they differ by f32 rounding except at near-silent bins); the
affine epilogue with bf16 out within one bf16 ulp of dB-scale values
(atol 0.25, test_pallas_model_kernels.py:378-381).  ``log_mel_v1_plain``
(the plain version of the v1 log-mel kernel) against ``log_mel_pallas`` in
interpret mode under the same bounds: the TPU kernel keeps its basis in
f32 where the port's rounds it to bf16, an error of the size of the bf16
frames' (~0.4 % relative), inside the bound that holds both kernels to the
f32 XLA path.  The plain
``log_mel_spectrogram`` against the JAX XLA path at f32, 1e-4 dB (f32
products in another order over 1024-sample frames).  The CLAP embedder at
10 s and 3 s windows in f32 against ``LaionCLAP`` of the JAX package, atol
1e-6 (unit vectors; measured ~1e-7).

The halo log-mel kernel's host side (its hop rows, frame map, K-major
basis and fused epilogue order) against ``log_mel_halo_plain``, and the v1
kernel's (its frame matrix, read through ``v1_dft_map``) against
``log_mel_v1_plain`` and the halo kernel's A: see the sections below.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.models.htsat import frontend_tokens as jax_frontend_tokens
from audio_metrics_tpu.ops.mel import (
    log_mel_pallas,
    log_mel_pallas_halo,
    log_mel_spectrogram as jax_log_mel_spectrogram,
    mel_filter_bank as jax_mel_filter_bank,
)
from audio_metrics_tpu_torch.kernels import KERNELS
from audio_metrics_tpu_torch.models.clap import (
    LaionCLAP,
    _can_tile_mel,
    init_projection_params,
    repeat_pad,
)
from audio_metrics_tpu_torch.models.htsat import HTSATConfig, frontend_tokens, init_params
from audio_metrics_tpu_torch.ops.mel import (
    _kernel_tables,
    _reflect_pad,
    _v1_signal,
    halo_dft_map,
    log_mel_halo,
    log_mel_halo_plain,
    log_mel_spectrogram,
    log_mel_v1,
    log_mel_v1_plain,
    mel_filter_bank,
    plain_operands,
    v1_dft_map,
)

CONVENTIONS = {
    "clap": dict(sr=48000, frame=1024, hop=480, n_fft=1024, n_mels=64, fmin=50, fmax=14000,
                 center=True, norm="slaney", scale="slaney", domain="hz", zero_dc=False,
                 log_mode="db"),
    "vggish": dict(sr=16000, frame=400, hop=160, n_fft=512, n_mels=64, fmin=125, fmax=7500,
                   center=False, norm=None, scale="htk", domain="mel", zero_dc=True,
                   log_mode="natural"),
}
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))


def _fb(c):
    args = (c["n_fft"] // 2 + 1, c["n_mels"], float(c["fmin"]), float(c["fmax"]), c["sr"])
    kw = dict(norm=c["norm"], mel_scale=c["scale"], triangle_domain=c["domain"],
              zero_dc=c["zero_dc"])
    fb = mel_filter_bank(*args, **kw)
    np.testing.assert_array_equal(fb, jax_mel_filter_bank(*args, **kw))
    return fb.astype(np.float32)


@pytest.mark.parametrize("conv", ["clap", "vggish"])
def test_log_mel_halo_plain_matches_pallas(conv):
    c = CONVENTIONS[conv]
    a = (0.2 * np.random.default_rng(3).normal(size=(3, c["sr"]))).astype(np.float32)
    kw = dict(frame_length=c["frame"], hop_length=c["hop"], n_fft=c["n_fft"], fb=_fb(c),
              center=c["center"], log_mode=c["log_mode"])
    want = np.asarray(log_mel_pallas_halo(jnp.asarray(a), interpret=True, **kw))
    before = KERNELS["log_mel"].launches
    got = log_mel_halo(torch.from_numpy(a), **kw).numpy()
    assert KERNELS["log_mel"].launches == before  # a CPU tensor takes the plain version
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.mean() < 0.02 and d.max() < 0.5, (d.mean(), d.max())


def test_log_mel_halo_plain_affine_epilogue():
    """out_affine / out_dtype == plain output * scale + offset cast to bf16
    (the CLAP BatchNorm fold), and the same epilogue as the TPU kernel's."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy((0.2 * rng.normal(size=(2, 48000))).astype(np.float32))
    fb = _fb(CONVENTIONS["clap"])
    sc = (rng.normal(size=64) * 0.3 + 1.0).astype(np.float32)
    of = rng.normal(size=64).astype(np.float32)
    kw = dict(frame_length=1024, hop_length=480, n_fft=1024, fb=fb, center=True, log_mode="db")
    plain = log_mel_halo(a, **kw)
    fused = log_mel_halo(a, out_affine=(torch.from_numpy(sc), torch.from_numpy(of)),
                         out_dtype=torch.bfloat16, **kw)
    assert fused.dtype == torch.bfloat16
    want = (plain * torch.from_numpy(sc) + torch.from_numpy(of)).to(torch.bfloat16)
    np.testing.assert_allclose(fused.float().numpy(), want.float().numpy(), rtol=0, atol=0.25)
    jax_fused = log_mel_pallas_halo(jnp.asarray(a.numpy()), out_affine=(sc, of),
                                    out_dtype=jnp.bfloat16, interpret=True, **kw)
    np.testing.assert_allclose(fused.float().numpy(), np.asarray(jax_fused, np.float32),
                               rtol=0, atol=0.25)


@pytest.mark.parametrize("conv", ["clap", "vggish", "clap hop 484"])
def test_log_mel_v1_plain_matches_pallas(conv):
    """CLAP: 1024-sample frames in 3 chunks of 480 (1440 wide); VGGish: 400
    in 3 chunks of 160 (480 wide); CLAP at hop 484 (3 chunks, 1452 wide), a
    hop that the halo kernel takes in padded hop rows.  1 s clips."""
    c = CONVENTIONS[conv.split()[0]]
    hop = int(conv.split()[-1]) if "hop" in conv else c["hop"]
    a = (0.2 * np.random.default_rng(13).normal(size=(3, c["sr"]))).astype(np.float32)
    kw = dict(frame_length=c["frame"], hop_length=hop, n_fft=c["n_fft"], fb=_fb(c),
              center=c["center"], log_mode=c["log_mode"])
    want = np.asarray(log_mel_pallas(jnp.asarray(a), interpret=True, **kw))
    before = KERNELS["log_mel_v1"].launches
    got = log_mel_v1(torch.from_numpy(a), **kw).numpy()
    assert KERNELS["log_mel_v1"].launches == before  # a CPU tensor takes the plain version
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.mean() < 0.02 and d.max() < 0.5, (d.mean(), d.max())
    # the halo log-mel's function: equal up to f32 summation order, 1e-3 dB
    halo = log_mel_halo(torch.from_numpy(a), **kw).numpy()
    assert np.abs(got - halo).max() < 1e-3


def test_log_mel_v1_plain_affine_epilogue():
    """The BatchNorm fold with bf16 out, against the plain output and the
    TPU kernel's epilogue: atol 0.25 (one bf16 ulp of dB-scale values)."""
    rng = np.random.default_rng(15)
    a = torch.from_numpy((0.2 * rng.normal(size=(2, 48000))).astype(np.float32))
    fb = _fb(CONVENTIONS["clap"])
    sc = (rng.normal(size=64) * 0.3 + 1.0).astype(np.float32)
    of = rng.normal(size=64).astype(np.float32)
    kw = dict(frame_length=1024, hop_length=480, n_fft=1024, fb=fb, center=True, log_mode="db")
    plain = log_mel_v1(a, **kw)
    fused = log_mel_v1(a, out_affine=(torch.from_numpy(sc), torch.from_numpy(of)),
                       out_dtype=torch.bfloat16, **kw)
    assert fused.dtype == torch.bfloat16
    want = (plain * torch.from_numpy(sc) + torch.from_numpy(of)).to(torch.bfloat16)
    np.testing.assert_allclose(fused.float().numpy(), want.float().numpy(), rtol=0, atol=0.25)
    jax_fused = log_mel_pallas(jnp.asarray(a.numpy()), out_affine=(sc, of),
                               out_dtype=jnp.bfloat16, interpret=True, **kw)
    np.testing.assert_allclose(fused.float().numpy(), np.asarray(jax_fused, np.float32),
                               rtol=0, atol=0.25)


@pytest.mark.parametrize("conv", ["clap", "vggish"])
def test_log_mel_spectrogram_matches_xla(conv):
    """The plain chain with ``center``, both log modes, both triangle
    domains and ``zero_dc``, f32."""
    c = CONVENTIONS[conv]
    a = (0.2 * np.random.default_rng(4).normal(size=(2, c["sr"] // 2))).astype(np.float32)
    kw = dict(sampling_rate=c["sr"], frame_length=c["frame"], hop_length=c["hop"],
              n_mels=c["n_mels"], fmin=c["fmin"], fmax=c["fmax"], n_fft=c["n_fft"],
              center=c["center"], mel_norm=c["norm"], mel_scale=c["scale"],
              triangle_domain=c["domain"], zero_dc=c["zero_dc"], log_mode=c["log_mode"])
    want = np.asarray(jax_log_mel_spectrogram(jnp.asarray(a), **kw))
    got = log_mel_spectrogram(torch.from_numpy(a), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_frontend_tokens_at_1001_frames():
    """The 10 s mel (1001 frames) -> 1024 interpolated frames -> tokens,
    against the JAX frontend; f32, atol 1e-5 (LayerNorm'd tokens of O(1))."""
    cfg = HTSATConfig(**SMALL)
    rng = np.random.default_rng(9)
    mel = rng.normal(scale=5.0, size=(2, 1001, 64)).astype(np.float32)
    w = rng.normal(scale=0.25, size=(cfg.embed_dim, 1, 4, 4)).astype(np.float32)
    pb, lw, lb = (rng.normal(size=cfg.embed_dim).astype(np.float32) for _ in range(3))
    jp = {"audio_encoder.patch_embed.proj.weight": jnp.asarray(w),
          "audio_encoder.patch_embed.proj.bias": jnp.asarray(pb),
          "audio_encoder.patch_embed.norm.weight": jnp.asarray(lw),
          "audio_encoder.patch_embed.norm.bias": jnp.asarray(lb)}
    want = jax_frontend_tokens(jp, jnp.asarray(mel), JaxHTSATConfig(**SMALL), jnp.float32)
    t = torch.from_numpy
    pw = np.ascontiguousarray(w.reshape(cfg.embed_dim, 16).T)
    got = frontend_tokens(t(mel), t(pw), t(pb), t(lw), t(lb), cfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _params(cfg):
    rng = np.random.default_rng(1)
    p = init_params(cfg, seed=0)
    p.update(init_projection_params(cfg, seed=0))
    for k in p:
        if k.endswith(".bias") or "bias_table" in k:
            p[k] = rng.normal(scale=0.1, size=p[k].shape).astype(np.float32)
    p["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    return p


@pytest.mark.parametrize("seconds", [10, 3])
def test_clap_windows_off_the_tiled_path_match_jax(seconds):
    """10 s (the model's own input length) and 3 s (repeat-pad with a zero
    tail) skip the fused frontend and the tiled mel: repeat-pad, centered
    log-mel of the 10 s clip, BatchNorm, frontend, encoder."""
    n = seconds * 48000
    assert not _can_tile_mel(n)
    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    a = (0.2 * np.random.default_rng(seconds).normal(size=(2, n))).astype(np.float32)
    jax_emb = JaxLaionCLAP(params=p, cfg=JaxHTSATConfig(**SMALL))
    want = np.asarray(jax_emb.embed_fn(jax_emb.params, jnp.asarray(a)))
    got = LaionCLAP(params=p, cfg=cfg, device="cpu").embed(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    padded = repeat_pad(torch.from_numpy(a))
    assert padded.shape == (2, 480000)
    assert torch.all(padded[:, (480000 // n) * n :] == 0)


def test_clap_rejects_clips_longer_than_10_s():
    cfg = HTSATConfig(**SMALL)
    emb = LaionCLAP(params=_params(cfg), cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="10 s"):
        emb.embed(torch.zeros((1, 480000 + 480)))


# ---- the halo log-mel kernel (#6) on the wgmma core: its host side ----
#
# The kernel (kernels/csrc/log_mel.cu) writes the bf16 hop-row signal
# (halo_rows_kernel), reads its DFT's A through the 3-D TMA map that
# ``ops.mel.halo_dft_map`` tabulates, B as the K-major basis of
# ``_kernel_tables``, and sums powers into the mel one N
# tile of 64 bins at a time.  Here the hop rows are built by the kernel's
# index formula, the map is materialised with ``torch.as_strided`` box by
# box (rows past the map's extent zero, as TMA fills them), and both
# operands must equal the plain version's frames and basis bitwise; the
# epilogue's order, emulated, must meet chip_smoke.py's LOG_MEL_TOL against
# ``log_mel_halo_plain`` (and two planted faults of it must not).

LOG_MEL_TOL = {"clap": (1e-5, 0.25), "vggish": (1e-6, 3e-5)}  # as in chip_smoke.py
HALO_CASES = {"clap 10 s": ("clap", 10), "clap 7 s": ("clap", 7), "clap 3 s": ("clap", 3),
              "vggish 10 s": ("vggish", 10)}
# the v1 kernel's: the halo's and a hop that is not a multiple of 8
V1_CASES = {**HALO_CASES, "clap hop 484": ("clap", 3, 484)}


def _halo_case(case, b=2, seed=0):
    conv, seconds, *hop = V1_CASES[case]
    c = CONVENTIONS[conv]
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy((0.2 * rng.normal(size=(b, seconds * c["sr"]))).astype(np.float32))
    kw = dict(frame_length=c["frame"], hop_length=hop[0] if hop else c["hop"], n_fft=c["n_fft"],
              fb=_fb(c), center=c["center"], log_mode=c["log_mode"])
    if conv == "clap":  # the BatchNorm fold, bf16 out (the model path)
        kw.update(out_affine=(torch.from_numpy((rng.normal(size=64) * 0.3 + 1).astype(np.float32)),
                              torch.from_numpy(rng.normal(size=64).astype(np.float32))),
                  out_dtype=torch.bfloat16)
    return conv, audio, kw


def _hop_rows(audio, amap):
    """The kernel's first launch: hops[z][j] = bf16(x[half - s]), x[s - half],
    x[2n - 2 - (s - half)], then 0, for j < clip_stride, where s = j at a hop
    that is a multiple of 8; else j = r*hop_pad + i holds s = r*hop + i for i
    < hop and 0 at the row's pad (``halo_rows_padded_kernel``)."""
    n, half, clip_stride = audio.shape[1], amap["half"], amap["strides"][1]
    hop_pad = amap["strides"][0]
    hop = amap["chunk"][0] if amap["chunk"] else hop_pad
    r, i = np.divmod(np.arange(clip_stride), hop_pad)
    s = r * hop + i - half
    src = np.where(s < 0, -s, np.where(s < n, s, 2 * n - 2 - s))
    valid = torch.from_numpy((s < n + half) & (i < hop))
    rows = audio[:, torch.from_numpy(np.clip(src, 0, n - 1))] * valid
    return rows.to(torch.bfloat16)


def _frames_through_the_map(hops, amap):
    """A as the producer loads it: per map batch z (a clip of the halo map)
    and 128-row tile, the boxes of every K step cut from the map's extent
    viewed with ``as_strided``, rows past it zero; (batch, tiles * 128,
    k_pad)."""
    (k_pad, n_frames, b), (hop, clip_stride), box = amap["dims"], amap["strides"], amap["box"]
    assert box == (64, 128, 1) and k_pad % box[0] == 0 and (2 * hop) % 16 == 0
    assert (2 * clip_stride) % 16 == 0
    view = torch.as_strided(hops.reshape(-1), (b, n_frames, k_pad), (clip_stride, hop, 1))
    tiles = -(-n_frames // box[1])
    a = torch.zeros((b, tiles * box[1], k_pad), dtype=hops.dtype)
    for t in range(tiles):
        for k in range(0, k_pad, box[0]):
            cut = view[:, t * box[1]:(t + 1) * box[1], k:k + box[0]]
            a[:, t * box[1]:t * box[1] + cut.shape[1], k:k + box[0]] = cut
    return a


def _kernel_operands(audio, kw):
    amap = halo_dft_map(audio.shape[0], audio.shape[1], kw["frame_length"], kw["hop_length"],
                        kw["center"])
    fb = np.ascontiguousarray(kw["fb"], np.float32)
    basis_t, fb_p, n_keep = _kernel_tables(kw["frame_length"], amap["dims"][0], kw["n_fft"],
                                           fb.tobytes(), fb.shape[1], amap["chunk"], "cpu")
    return amap, _frames_through_the_map(_hop_rows(audio, amap), amap), basis_t, fb_p


@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_map_and_basis_are_the_plain_operands(case):
    """The frames read through the map and the K-major basis equal the plain
    version's bf16 frames and basis bitwise; the K padding reads zero basis
    columns, the rows past n_frames are zero."""
    conv, audio, kw = _halo_case(case)
    amap, a, basis_t, fb_p = _kernel_operands(audio, kw)
    frame, (k_pad, n_frames, b) = kw["frame_length"], amap["dims"]
    x = _reflect_pad(audio, frame) if kw["center"] else audio
    frames, basis, fb_rows = plain_operands(x, frame, frame_length=frame,
                                            hop_length=kw["hop_length"], n_fft=kw["n_fft"],
                                            fb=kw["fb"])
    assert (b, n_frames) == frames.shape[:2] and 0 <= k_pad - frame < 64
    assert torch.equal(a[:, :n_frames, :frame].float(), frames)
    assert not a[:, n_frames:].any()
    n_keep = fb_rows.shape[0]
    assert basis_t.shape == (2 * fb_p.shape[0], k_pad) and fb_p.shape[0] % 64 == 0
    assert torch.equal(basis_t[0:2 * n_keep:2, :frame].float().T, basis[:, :n_keep])
    assert torch.equal(basis_t[1:2 * n_keep:2, :frame].float().T, basis[:, n_keep:])
    assert not basis_t[:, frame:].any() and not basis_t[2 * n_keep:].any()
    assert torch.equal(fb_p[:n_keep], fb_rows) and not fb_p[n_keep:].any()


def _fused_epilogue(a, basis_t, fb_p, kw, reset_every_tile=False, affine_first=False):
    """The kernel's arithmetic in its order: f32 products, then per N tile of
    128 basis rows the 64 powers re^2 + im^2 summed into the mel bin by bin
    (each step an FMA: the exact float64 product and sum, rounded to f32),
    after the last tile log, affine and the output rounding."""
    acc = torch.matmul(a.float(), basis_t.float().T)
    mel = torch.zeros(acc.shape[:2] + (64,), dtype=torch.float32)
    for nt in range(basis_t.shape[0] // 128):
        if reset_every_tile:
            mel.zero_()
        blk = acc[..., nt * 128:(nt + 1) * 128]
        power = blk[..., 0::2] * blk[..., 0::2] + blk[..., 1::2] * blk[..., 1::2]
        for f in range(64):
            w = fb_p[nt * 64 + f].double()
            mel = (mel.double() + power[..., f, None].double() * w).float()
    affine = kw.get("out_affine")
    if affine_first and affine is not None:
        mel = mel * affine[0] + affine[1]
    if kw["log_mode"] == "db":
        lm = 10.0 * (torch.log(torch.clamp(mel, min=1e-10)) * 0.43429448190325176)
    else:
        lm = torch.log(mel + 0.01)
    if affine is not None and not affine_first:
        lm = lm * affine[0] + affine[1]
    return lm.to(kw.get("out_dtype") or torch.float32)


def _log_mel_err(got, want):
    err = (got.float() - want.float()).abs()
    return err.mean().item() / want.float().abs().mean().item(), err.max().item()


@pytest.mark.parametrize("case", ["clap 10 s", "clap 7 s", "clap 3 s", "vggish 10 s"])
def test_halo_fused_epilogue_order_matches_plain(case):
    """Emulated in the kernel's order, within chip_smoke.py's LOG_MEL_TOL of
    ``log_mel_halo_plain``; the check fails with the mel accumulator reset
    at every N tile, and (CLAP, whose BatchNorm fold is an affine) with the
    affine before the log."""
    conv, audio, kw = _halo_case(case, seed=1)
    amap, a, basis_t, fb_p = _kernel_operands(audio, kw)
    n_frames = amap["dims"][1]
    want = log_mel_halo_plain(audio, **kw)
    got = _fused_epilogue(a, basis_t, fb_p, kw)[:, :n_frames]
    assert got.shape == want.shape and got.dtype == want.dtype
    rel, mx = _log_mel_err(got, want)
    rel_tol, max_tol = LOG_MEL_TOL[conv]
    assert rel <= rel_tol and mx <= max_tol, (rel, mx)
    rel, mx = _log_mel_err(_fused_epilogue(a, basis_t, fb_p, kw, reset_every_tile=True)
                           [:, :n_frames], want)
    assert rel > 10 * rel_tol and mx > max_tol
    if conv == "clap":
        rel, mx = _log_mel_err(_fused_epilogue(a, basis_t, fb_p, kw, affine_first=True)
                               [:, :n_frames], want)
        assert rel > 10 * rel_tol and mx > max_tol


@pytest.mark.parametrize("frame,hop,center,k_pad", [(1024, 480, True, 1024), (400, 160, False, 448),
                                                    (1024, 484, True, 1088)])
def test_halo_map_shape_checks(frame, hop, center, k_pad):
    """The frame stride is 16 bytes: the hop rounded up to a multiple of 8
    (484 -> 488, each hop row padded with 4 zeros); K is the span of the
    frame's samples in those rows (1024 + 2 * 4 for 3 chunks of 484) padded
    to the 64-element box; the signal rows hold the last frame's k_pad
    samples."""
    amap = halo_dft_map(2, 48000, frame, hop, center)
    (kp, n_frames, b), (stride, clip_stride) = amap["dims"], amap["strides"]
    assert (kp, b, stride) == (k_pad, 2, -(-hop // 8) * 8) and amap["box"] == (64, 128, 1)
    assert amap["chunk"] == (None if hop % 8 == 0 else (hop, stride))
    assert clip_stride % 8 == 0 and clip_stride >= (n_frames - 1) * hop + kp
    assert n_frames == (48000 + (frame if center else 0) - frame) // hop + 1


# ---- the v1 log-mel kernel (#7) on the wgmma core: its host side ----
#
# The kernel writes the (B*n_frames, k_pad) bf16 frame matrix (its framing
# pass, frame_rows_kernel) and reads it through the map ``ops.mel.
# v1_dft_map`` tabulates, as one run of rows, into the halo kernel's DFT and
# epilogue (the same basis and filterbank tables).  Here the frame matrix is
# built by the framing pass's index formula, read box by box through the
# map, and held against the plain version's frames (``_v1_signal``: the
# TPU wrapper's chunk-padded frames) and against the A of the halo map.


def _frame_rows(audio, amap, frame_length, hop):
    """The framing pass: row z*n_frames + r, column j < frame_length, is
    bf16(sample r*hop + j of clip z's padded signal): x[-s], x[s], x[2n - 2 -
    s] for s = r*hop + j - half, then zero; columns from frame_length to
    k_pad are zero."""
    n, half, n_frames, k_pad = audio.shape[1], amap["half"], amap["n_frames"], amap["dims"][0]
    j = np.arange(k_pad)[None, :]
    s = np.arange(n_frames)[:, None] * hop + j - half
    src = np.where(s < 0, -s, np.where(s < n, s, 2 * n - 2 - s))
    valid = torch.from_numpy((j < frame_length) & (s < n + half))
    rows = audio[:, torch.from_numpy(np.clip(src, 0, n - 1))] * valid
    return rows.reshape(-1, k_pad).to(torch.bfloat16)


def _v1_operands(audio, kw):
    b, n = audio.shape
    frame, hop = kw["frame_length"], kw["hop_length"]
    amap = v1_dft_map(b, n, frame, hop, kw["center"])
    fb = np.ascontiguousarray(kw["fb"], np.float32)
    basis_t, fb_p, n_keep = _kernel_tables(frame, amap["dims"][0], kw["n_fft"], fb.tobytes(),
                                           fb.shape[1], None, "cpu")
    return amap, _frames_through_the_map(_frame_rows(audio, amap, frame, hop), amap), basis_t, fb_p


@pytest.mark.parametrize("case", list(V1_CASES))
def test_v1_map_and_basis_are_the_plain_operands(case):
    """The frame matrix read through the v1 map equals the plain version's
    bf16 frames bitwise in their first frame_length columns and is zero
    from there to k_pad, where the plain basis rows are zero too (so the cut
    of the TPU wrapper's n_chunks*hop width changes no value); the rows past
    B*n_frames read zero; the K-major basis is the plain basis."""
    conv, audio, kw = _halo_case(case)
    amap, a, basis_t, fb_p = _v1_operands(audio, kw)
    frame, (k_pad, rows, one), n_frames = kw["frame_length"], amap["dims"], amap["n_frames"]
    b = audio.shape[0]
    x, n_plain, width = _v1_signal(audio, frame, kw["hop_length"], kw["center"])
    frames, basis, fb_rows = plain_operands(x, width, frame_length=frame,
                                            hop_length=kw["hop_length"], n_fft=kw["n_fft"],
                                            fb=kw["fb"])
    frames = frames[:, :n_plain]
    assert one == 1 and rows == b * n_frames and n_frames == n_plain
    assert 0 <= k_pad - frame < 64 and width >= frame
    got = a[0, :rows].reshape(b, n_frames, k_pad)
    assert torch.equal(got[..., :frame].float(), frames[..., :frame])
    assert not got[..., frame:].any() and not a[0, rows:].any()
    assert not basis[frame:].any()
    n_keep = fb_rows.shape[0]
    assert torch.equal(basis_t[0:2 * n_keep:2, :frame].float().T, basis[:frame, :n_keep])
    assert torch.equal(basis_t[1:2 * n_keep:2, :frame].float().T, basis[:frame, n_keep:])
    assert not basis_t[:, frame:].any() and not basis_t[2 * n_keep:].any()
    assert torch.equal(fb_p[:n_keep], fb_rows) and not fb_p[n_keep:].any()


@pytest.mark.parametrize("case", list(V1_CASES))
def test_v1_fused_epilogue_order_matches_plain(case):
    """The halo kernel's epilogue, emulated in its order over the v1 frame
    matrix (one run of rows: tiles span clips), within chip_smoke.py's
    LOG_MEL_TOL of ``log_mel_v1_plain``; the check fails with the mel
    accumulator reset at every N tile and (CLAP) with the affine before the
    log."""
    conv, audio, kw = _halo_case(case, seed=1)
    amap, a, basis_t, fb_p = _v1_operands(audio, kw)
    b, rows = audio.shape[0], amap["dims"][1]

    def emulated(**fault):
        return _fused_epilogue(a, basis_t, fb_p, kw, **fault)[0, :rows].reshape(b, rows // b, 64)

    want = log_mel_v1_plain(audio, **kw)
    got = emulated()
    assert got.shape == want.shape and got.dtype == want.dtype
    rel, mx = _log_mel_err(got, want)
    rel_tol, max_tol = LOG_MEL_TOL[conv]
    assert rel <= rel_tol and mx <= max_tol, (rel, mx)
    rel, mx = _log_mel_err(emulated(reset_every_tile=True), want)
    assert rel > 10 * rel_tol and mx > max_tol
    if conv == "clap":
        rel, mx = _log_mel_err(emulated(affine_first=True), want)
        assert rel > 10 * rel_tol and mx > max_tol


@pytest.mark.parametrize("case", list(HALO_CASES))
def test_v1_and_halo_read_the_same_a(case):
    """Where both kernels run (hop % 8 == 0), row z*n_frames + r of the A
    that the v1 map reads is row r of clip z's A through the halo map in
    its first frame_length columns; past them the halo reads signal and v1
    zeros, both against zero basis columns, and the two kernels share their
    tables: the products, sums and epilogue are the same row by row, so the
    outputs should be bitwise equal on the card."""
    conv, audio, kw = _halo_case(case)
    amap, a, basis_t, fb_p = _v1_operands(audio, kw)
    hmap, ha, h_basis_t, h_fb_p = _kernel_operands(audio, kw)
    frame, (k_pad, n_frames, b) = kw["frame_length"], hmap["dims"]
    assert amap["dims"] == (k_pad, b * n_frames, 1) and amap["half"] == hmap["half"]
    assert amap["n_frames"] == hmap["n_frames"] == n_frames
    v1 = a[0, :b * n_frames].reshape(b, n_frames, k_pad)
    assert torch.equal(v1[..., :frame], ha[:, :n_frames, :frame])
    assert not v1[..., frame:].any() and not basis_t[:, frame:].any()
    assert h_basis_t is basis_t and h_fb_p is fb_p  # one cached table


@pytest.mark.parametrize("frame,hop,center,k_pad", [(1024, 480, True, 1024), (400, 160, False, 448),
                                                    (1024, 484, True, 1024)])
def test_v1_map_shape_checks(frame, hop, center, k_pad):
    """Any hop (484 too, which the halo map takes in padded hop rows); K is
    the frame padded to the 64-element box; one run of B*n_frames rows at
    pitch k_pad; a clip too short to reflect-pad or to hold a frame, or a
    frame matrix past 32-bit indices, raises ``ValueError``."""
    amap = v1_dft_map(2, 48000, frame, hop, center)
    n_frames = (48000 + (frame if center else 0) - frame) // hop + 1
    assert amap["n_frames"] == n_frames and amap["half"] == (frame // 2 if center else 0)
    assert amap["dims"] == (k_pad, 2 * n_frames, 1) and amap["box"] == (64, 128, 1)
    assert amap["strides"] == (k_pad, 2 * n_frames * k_pad)
    halo = halo_dft_map(2, 48000, frame, hop, center)
    assert halo["n_frames"] == n_frames and halo["strides"][0] == -(-hop // 8) * 8
    if hop % 8 == 0:
        assert halo["dims"][:2] == (k_pad, n_frames)
    else:  # the halo's K spans the padded chunks, v1's the frame alone
        assert halo["dims"][0] > k_pad
    short = frame // 2 if center else frame - 1
    with pytest.raises(ValueError, match="samples"):
        v1_dft_map(2, short, frame, hop, center)
    with pytest.raises(ValueError, match="32-bit"):
        v1_dft_map(4096, 480000, frame, hop, center)
