"""Synthetic example data.

A copy of ``audio_metrics_tpu/utils/example_utils.py`` (the reference's
example_utils.py:6-94) over the port's ``wavio``: beat + tone signals,
where "real" pairs hold a harmonic relation between the context mix and
the stem and "fake" pairs do not.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .wavio import write_wav

__all__ = [
    "make_signal",
    "mix_stem_pair",
    "audio_pair_generator",
    "generate_audio_samples",
]


def make_signal(sr, audio_len, beat_rate, tone_freq, rng=None):
    """Noise-onset beats plus a tone at the given rate/frequency."""
    rng = rng or np.random.default_rng()
    beat_period = int(sr // beat_rate)
    signal = np.zeros(audio_len, dtype=np.float32)
    onset_period = beat_period // 10
    tone_length = beat_period // 2
    onset_length = onset_period // 2
    tone_sig = np.sin(tone_freq * 2 * np.pi * np.arange(tone_length) / sr)
    onset_sig = rng.random(onset_length) - 0.5
    for start in range(0, audio_len, beat_period):
        end = min(start + beat_period // 2, audio_len)
        signal[start:end] = tone_sig[: end - start]
        end = min(start + onset_period // 2, audio_len)
        signal[start:end] += onset_sig[: end - start]
    peak = np.max(np.abs(signal))
    if peak > 0:
        signal *= 0.5 / peak
    return signal


def _cfg_pair(rng, matching=True):
    beat_min, beat_max = 0.5, 2.0
    tone_min, tone_max = 100.0, 500.0
    beat_rate_mix = beat_min + rng.random() * (beat_max - beat_min)
    tone_freq_mix = tone_min + rng.random() * (tone_max - tone_min)
    mix_cfg = {"beat_rate": beat_rate_mix, "tone_freq": tone_freq_mix}
    if not matching:
        beat_rate_mix = beat_min + rng.random() * (beat_max - beat_min)
        tone_freq_mix = tone_min + rng.random() * (tone_max - tone_min)
    stem_cfg = {
        "beat_rate": 2.0 ** rng.integers(-3, 4) * beat_rate_mix,
        "tone_freq": 2.0 ** rng.integers(-3, 4) * tone_freq_mix,
    }
    return mix_cfg, stem_cfg


def mix_stem_pair(sr, audio_len, matching=True, rng=None):
    rng = rng or np.random.default_rng()
    mix_cfg, stem_cfg = _cfg_pair(rng, matching)
    mix = make_signal(sr, audio_len, rng=rng, **mix_cfg)
    stem = make_signal(sr, audio_len, rng=rng, **stem_cfg)
    return (mix, stem, sr)


def audio_pair_generator(n_items, sr, audio_len, matching=True, seed=None):
    rng = np.random.default_rng(seed)
    for _ in range(n_items):
        yield mix_stem_pair(sr, audio_len, matching, rng)


def generate_audio_samples(audio_dir, n_items=100, sr=48000, audio_len=None, seed=0):
    """Write real/ (matching) and fake/ (mismatched) wav pairs."""
    if audio_len is None:
        audio_len = 10 * sr
    audio_dir = Path(audio_dir)
    for name, matching in (("real", True), ("fake", False)):
        out_dir = audio_dir / name
        out_dir.mkdir(parents=True, exist_ok=True)
        gen = audio_pair_generator(n_items, sr, audio_len, matching, seed=seed)
        for i, (mix, stem, sr_) in enumerate(gen):
            write_wav(
                out_dir / f"sample_{i:02d}.wav", np.column_stack((mix, stem)), sr_
            )
