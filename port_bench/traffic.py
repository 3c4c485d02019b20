"""The one traffic generator: it reads a traffic mix's parameters and makes
its inputs from the seed.

A mix (``port_bench/traffic/<name>.json``) gives the clip length and rate,
the reference set's size, the candidate sets' size and how many of them
set-up makes (``pool_sets``), the range of the gain each evaluate's set is
scaled by, the ``AudioMetrics`` options it is evaluated under, and the
sound of each set (``reference_sound``, ``candidate_sound``: ``sounds``'s
parameters).  The clips differ from each other in pitch, envelope, level
and noise, and the candidate sets lie half an octave higher and noisier
than the reference, so that each set's embeddings spread and the two sets
overlap in part.  Each set comes from a generator of its own, on the
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sounds(n_clips: int, n_samples: int, sr: int, p: dict, seed: int, device,
           rows: int = 512) -> torch.Tensor:
    """(n_clips, n_samples) f32 clips on ``device``, each ``p["tones"]``
    sines at pitches log-uniform over ``p["octaves"]`` above
    ``p["base_hz"]`` with random weights and phases, under a sine envelope
    of a rate in ``p["envelope_hz"]`` and a random depth, at a level
    log-uniform over ``p["level_log10"]``, over white noise of a std
    log-uniform over ``p["noise_log10"]``; made ``rows`` clips at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    k = p["tones"]
    pitch = p["base_hz"] * 2 ** u(n_clips, k, 1, lo=p["octaves"][0], hi=p["octaves"][1])
    weight = u(n_clips, k, 1)
    weight = weight / weight.sum(dim=1, keepdim=True)
    phase = u(n_clips, k, 1, hi=2 * math.pi)
    rate, depth = u(n_clips, 1, lo=p["envelope_hz"][0], hi=p["envelope_hz"][1]), u(n_clips, 1)
    env_phase = u(n_clips, 1, hi=2 * math.pi)
    level = 10 ** u(n_clips, 1, lo=p["level_log10"][0], hi=p["level_log10"][1])
    noise = 10 ** u(n_clips, 1, lo=p["noise_log10"][0], hi=p["noise_log10"][1])
    t = torch.arange(n_samples, device=device) / sr
    out = torch.empty((n_clips, n_samples), device=device)
    for r in range(0, n_clips, rows):
        sl = slice(r, r + rows)
        x = torch.zeros((min(rows, n_clips - r), n_samples), device=device)
        for j in range(k):
            x += weight[sl, j] * torch.sin(2 * math.pi * pitch[sl, j] * t + phase[sl, j])
        env = 1 - depth[sl] + depth[sl] * 0.5 * (1 + torch.sin(2 * math.pi * rate[sl] * t
                                                               + env_phase[sl]))
        out[sl] = level[sl] * env * x + noise[sl] * torch.randn(x.shape, generator=gen,
                                                                device=device)
    return out


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 32-bit seeds derived from the run's seed."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n, np.uint32)]


class Traffic:
    """The inputs of one run: the reference set, the pool of candidate
    sets, and the gain of each evaluate, all from the seed; with the seeds
    of the weights and of the check's draw of evaluates."""

    def __init__(self, mix: dict, seed: int, device):
        self.mix = mix
        self.n_samples = int(round(mix["clip_seconds"] * mix["sample_rate"]))
        s = seeds(seed, 4 + mix["pool_sets"])
        self.weights_seed, self.judge_seed, gain_seed, ref_seed = s[:4]
        sr = mix["sample_rate"]
        self.reference = sounds(mix["reference_clips"], self.n_samples, sr,
                                mix["reference_sound"], ref_seed, device)
        self.pool = [sounds(mix["candidate_clips"], self.n_samples, sr, mix["candidate_sound"], p,
                            device) for p in s[4:]]
        lo, hi = mix["gain"]
        self._gains = np.random.default_rng(gain_seed).uniform(lo, hi, size=1 << 16)

    def gain(self, k: int) -> float:
        return float(self._gains[k % len(self._gains)])

    def candidate(self, k: int) -> torch.Tensor:
        """Evaluate ``k``'s set: pool set k mod ``pool_sets`` times gain k,
        made on the card when it is due."""
        return self.pool[k % len(self.pool)] * self.gain(k)

    def warm_candidate(self) -> torch.Tensor:
        """The set-up's warm evaluate's set, made as the window's are."""
        return self.pool[-1] * self.gain(len(self._gains) - 1)
