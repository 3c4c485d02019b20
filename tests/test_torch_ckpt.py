"""Checkpoint loading of the port against the JAX package, on the CPU.

A LAION-named state dict written by the test from seeded numpy weights (a
``module.`` prefix, fused qkv, text-tower keys and buffers the converter
drops, a ``state_dict`` wrapper) goes through both packages'
``convert_checkpoint``, ``_load_params`` (``.pt`` and ``.npz``) and
``LaionCLAP(ckpt=)``; the registry builds the default embedder from
``$AM_TPU_CKPT_DIR``.  ``download_url`` is made to raise in every test: no
test reaches the network.
"""

import numpy as np
import pytest
import torch

from audio_metrics_tpu.models import clap as jax_clap
from audio_metrics_tpu.models.htsat import HTSATConfig as JaxHTSATConfig
from audio_metrics_tpu.utils import get_url as jax_get_url
from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.convert import convert_checkpoint, expected_param_keys
from audio_metrics_tpu_torch.models import get_embedder
from audio_metrics_tpu_torch.models.clap import (
    LAION_CLAP_MUSIC_CHECKPOINT_URL,
    LaionCLAP,
    _load_params,
    init_projection_params,
)
from audio_metrics_tpu_torch.models.htsat import HTSATConfig, init_params
from audio_metrics_tpu_torch.testing import laion_state_dict
from audio_metrics_tpu_torch.utils import get_url

SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
SR = 48000
BASENAME = LAION_CLAP_MUSIC_CHECKPOINT_URL.rsplit("/", 1)[-1]


@pytest.fixture(autouse=True)
def no_download(monkeypatch, tmp_path):
    """Both packages' downloads raise, and their cache is an empty
    directory: the search order stops before the download or returns
    None."""
    def refuse(url):
        raise RuntimeError(f"test refused to download {url}")

    monkeypatch.setattr(get_url, "download_url", refuse)
    monkeypatch.setattr(jax_get_url, "download_url", refuse)
    for k in ("AM_TPU_CKPT_DIR", "AM_TPU_CACHE_DIR", "AM_TPU_ALLOW_RANDOM_WEIGHTS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "empty_cache"))


def _params(cfg, seed=1):
    """Seeded weights with every entry drawn (biases, tables and norms too)."""
    rng = np.random.default_rng(seed)
    p = init_params(cfg, seed=0)
    p.update(init_projection_params(cfg, seed=0))
    for k, v in p.items():
        if k.endswith(".bias") or "bias_table" in k:
            p[k] = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
        elif k.endswith(".weight") and ("norm" in k or "batch_norm" in k):
            p[k] = (1 + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
    p["audio_encoder.batch_norm.running_var"] = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    return p


def _laion_checkpoint(p):
    """``p`` under LAION's names, plus what a LAION checkpoint also holds
    and the converter drops, inside a ``state_dict`` wrapper."""
    sd = laion_state_dict(p)
    rng = np.random.default_rng(7)
    sd["module.text_branch.embeddings.word_embeddings.weight"] = torch.from_numpy(
        rng.normal(size=(10, 8)).astype(np.float32))
    sd["module.logit_scale_a"] = torch.tensor(2.5)
    sd["module.audio_branch.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(
        (64, 64))
    sd["module.audio_branch.spectrogram_extractor.stft.conv_real.weight"] = torch.zeros((4, 1, 8))
    return {"state_dict": sd, "epoch": 15}


def _assert_equal_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype == np.float32, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _clips(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(5 * SR) / SR
    tone = np.sin(2 * np.pi * rng.uniform(100, 2000, size=(n, 1)) * t)
    return (0.1 * rng.standard_normal((n, 5 * SR)) + 0.2 * tone).astype(np.float32)


@pytest.mark.parametrize("with_cfg", [False, True])
def test_convert_checkpoint_matches_jax(with_cfg):
    """Equal dicts, keys and arrays, from one LAION-named state dict; with
    ``cfg`` exactly the forward's keys, which are the weights written."""
    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    sd = _laion_checkpoint(p)["state_dict"]
    got = convert_checkpoint(sd, cfg if with_cfg else None)
    want = jax_clap.convert_checkpoint(sd, JaxHTSATConfig(**SMALL) if with_cfg else None)
    _assert_equal_dicts(got, want)
    if with_cfg:
        _assert_equal_dicts(got, p)
    else:  # the DSP frontend and index buffers stay unfiltered
        assert "audio_encoder.layers.0.blocks.0.attn.relative_position_index" in got
        assert not any(k.startswith(("text_branch", "logit")) for k in got)


def test_expected_keys_match_jax():
    for cfg_kw in (SMALL, {}):
        assert expected_param_keys(HTSATConfig(**cfg_kw)) == \
            jax_clap.expected_param_keys(JaxHTSATConfig(**cfg_kw))


@pytest.mark.parametrize("drop", ["audio_branch.layers.1.blocks.0.attn.qkv.weight",
                                  "audio_projection.2.bias"])
def test_strict_raises_on_the_same_missing_keys(drop):
    cfg = HTSATConfig(**SMALL)
    sd = _laion_checkpoint(_params(cfg))["state_dict"]
    del sd[f"module.{drop}"]
    msgs = []
    for fn, c in ((convert_checkpoint, cfg),
                  (jax_clap.convert_checkpoint, JaxHTSATConfig(**SMALL))):
        with pytest.raises(ValueError, match="keys missing") as e:
            fn(sd, c, strict=True)
        msgs.append(str(e.value).split(": ", 1)[1])
    assert msgs[0] == msgs[1]
    assert len(convert_checkpoint(sd, cfg)) < len(expected_param_keys(cfg))  # not strict


@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_load_params_reads_pt_and_npz(tmp_path, fmt):
    """``_load_params`` of both packages on one file: a LAION ``.pt`` under
    ``state_dict``, or an ``.npz`` already in the dict's layout (with an
    extra key it drops)."""
    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    path = tmp_path / f"ckpt.{fmt}"
    if fmt == "pt":
        torch.save(_laion_checkpoint(p), path)
    else:
        np.savez(path, **p, extra_key=np.zeros(3, np.float32))
    got = _load_params(str(path), cfg)
    _assert_equal_dicts(got, p)
    _assert_equal_dicts(got, jax_clap._load_params(str(path), JaxHTSATConfig(**SMALL)))


def test_load_params_npz_missing_key_raises(tmp_path):
    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    del p["audio_encoder.norm.bias"]
    np.savez(tmp_path / "ckpt.npz", **p)
    with pytest.raises(ValueError, match="incomplete"):
        _load_params(str(tmp_path / "ckpt.npz"), cfg)


def test_resolve_checkpoint_search_order(tmp_path, monkeypatch):
    """An explicit path, then ``$AM_TPU_CKPT_DIR/<basename>``, then the
    cache (``$AM_TPU_CACHE_DIR``, else ``$XDG_CACHE_HOME/audio_metrics_tpu``),
    then the download (refused here: None), as the JAX package's."""
    url = LAION_CLAP_MUSIC_CHECKPOINT_URL
    ckpt_dir, cache, xdg = (tmp_path / d for d in ("ckpt", "cache", "xdg"))
    for d in (ckpt_dir, cache, xdg / "audio_metrics_tpu"):
        d.mkdir(parents=True)
        (d / BASENAME).write_bytes(b"x")

    def both():
        got = get_url.resolve_checkpoint(url)
        assert got == jax_get_url.resolve_checkpoint(url)
        return got

    assert both() is None  # nothing provisioned, download refused
    monkeypatch.setenv("XDG_CACHE_HOME", str(xdg))
    assert both() == (xdg / "audio_metrics_tpu" / BASENAME).as_posix()
    monkeypatch.setenv("AM_TPU_CACHE_DIR", str(cache))
    assert get_url.cache_dir() == cache
    assert both() == (cache / BASENAME).as_posix()
    monkeypatch.setenv("AM_TPU_CKPT_DIR", str(ckpt_dir))
    assert both() == (ckpt_dir / BASENAME).as_posix()
    explicit = tmp_path / "mine.pt"
    explicit.write_bytes(b"y")
    assert get_url.resolve_checkpoint(str(explicit)) == str(explicit)


def test_unresolvable_checkpoint_raises_unless_random_weights():
    cfg = HTSATConfig(**SMALL)
    with pytest.raises(RuntimeError, match="checkpoint unavailable"):
        LaionCLAP(ckpt=LAION_CLAP_MUSIC_CHECKPOINT_URL, cfg=cfg, device="cpu")
    emb = LaionCLAP(ckpt=LAION_CLAP_MUSIC_CHECKPOINT_URL, cfg=cfg, device="cpu",
                    allow_random_weights=True)
    assert emb.model.compute_dtype == torch.float32


@pytest.mark.parametrize("name,layer", [("laion_clap_music", "embedding"),
                                        ("laion_clap_music_l-2", "audio_projection.0")])
def test_registry_builds_from_ckpt_dir(tmp_path, monkeypatch, name, layer):
    """The default embedder by name, from the checkpoint provisioned under
    its URL's basename in ``$AM_TPU_CKPT_DIR``: f32, the file's weights."""
    cfg = HTSATConfig(**SMALL)
    p = _params(cfg)
    torch.save(_laion_checkpoint(p), tmp_path / BASENAME)
    monkeypatch.setenv("AM_TPU_CKPT_DIR", str(tmp_path))
    emb = get_embedder(name, cfg=cfg, device="cpu")
    assert isinstance(emb, LaionCLAP) and emb.layer == layer
    assert emb.model.compute_dtype == torch.float32
    np.testing.assert_array_equal(emb.model.linear2_bias.numpy(),
                                  p["audio_projection.linear2.bias"])


def test_ckpt_embeddings_match_jax(tmp_path):
    """``LaionCLAP(ckpt=path)`` of both packages on 2 clips, f32: atol 1e-6,
    the slice's bound (tests/test_torch_slice.py)."""
    cfg = HTSATConfig(**SMALL)
    path = tmp_path / "ckpt.pt"
    torch.save(_laion_checkpoint(_params(cfg)), path)
    audio = _clips(5, 2)
    got = LaionCLAP(ckpt=str(path), cfg=cfg, device="cpu").embed(torch.from_numpy(audio))
    jax_emb = jax_clap.LaionCLAP(ckpt=str(path), cfg=JaxHTSATConfig(**SMALL))
    want = np.asarray(jax_emb.forward({"audio": audio})["embedding"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_audio_metrics_default_embedder_from_ckpt_dir(tmp_path, monkeypatch):
    """The registry's default (``get_embedder(None)``, what ``AudioMetrics``
    builds without an embedder), ``laion_clap_music``, from
    ``$AM_TPU_CKPT_DIR`` at the small config, through an evaluate."""
    cfg = HTSATConfig(**SMALL)
    torch.save(_laion_checkpoint(_params(cfg)), tmp_path / BASENAME)
    monkeypatch.setenv("AM_TPU_CKPT_DIR", str(tmp_path))
    am = AudioMetrics(metrics=["fad", "kd"], embedder=get_embedder(cfg=cfg, device="cpu"),
                      batch_size=4, device="cpu")
    am.add_reference(_clips(0, 4))
    out = am.evaluate(_clips(1, 4))
    assert set(out) == {"fad", "kernel_distance_mean", "kernel_distance_std"}
    assert all(np.isfinite(v) for v in out.values())
