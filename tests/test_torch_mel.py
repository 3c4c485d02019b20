"""The halo log-mel and the CLAP windows that do not tile 10 s, against the
JAX package on the CPU.

``log_mel_halo_plain`` (the plain version of the halo log-mel kernel) is
held against ``log_mel_pallas_halo`` in interpret mode at the CLAP and the
VGGish conventions of tests/test_pallas_model_kernels.py:295-310, under
that file's kernel-vs-XLA bound (mean abs < 0.02, max abs < 0.5 dB or log
units: both round frames and basis to bf16 and sum in f32 in another
order, so they differ by f32 rounding except at near-silent bins); the
affine epilogue with bf16 out within one bf16 ulp of dB-scale values
(atol 0.25, test_pallas_model_kernels.py:378-381).  The plain
``log_mel_spectrogram`` against the JAX XLA path at f32, 1e-4 dB (f32
products in another order over 1024-sample frames).  The CLAP embedder at
10 s and 3 s windows in f32 against ``LaionCLAP`` of the JAX package, atol
1e-6 (unit vectors; measured ~1e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_metrics_tpu.models.clap import LaionCLAP as JaxLaionCLAP
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.models.htsat import frontend_tokens as jax_frontend_tokens
from audio_metrics_tpu.ops.mel import (
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
    log_mel_halo,
    log_mel_spectrogram,
    mel_filter_bank,
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
