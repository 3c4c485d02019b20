"""Multi-embedder sweep: FAD/KD/PRDC under every registry embedder.

Counterpart of ``examples/3_multi_embedder_sweep.py``: the same reference
and candidate sets scored by each embedder of the port's registry (the two
CLAP checkpoints at three taps each, VGGish, the dummy), one
``AudioMetrics`` per embedder (embedding spaces are not comparable across
embedders).  Without provisioned checkpoints the CLAP and VGGish weights
are seeded random: the sweep shows the registry and the relative scoring,
not metric-valid values.

    python -m audio_metrics_tpu_torch.examples.multi_embedder_sweep [--n-clips 64]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.examples import embedder
from audio_metrics_tpu_torch.models import EMBEDDERS


def synth_sets(n_clips: int, sr: int, seconds: float = 5.0, seed: int = 0):
    """Reference: tonal clips; near: the same family; far: a noisier,
    higher family, which should score worse under every embedder."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr

    def tonal(f0, noise):
        x = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.28)) / k for k in (1, 2, 3))
        return (0.2 * x + noise * rng.normal(size=t.shape)).astype(np.float32)

    ref = np.stack([tonal(rng.uniform(100, 400), 0.02) for _ in range(n_clips)])
    near = np.stack([tonal(rng.uniform(100, 400), 0.02) for _ in range(n_clips)])
    far = np.stack([tonal(rng.uniform(600, 2000), 0.3) for _ in range(n_clips)])
    return ref, near, far


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-clips", type=int, default=64)
    ap.add_argument("--input-sr", type=int, default=48000)
    ap.add_argument("--seconds", type=float, default=5.0, help="clip and window length")
    ap.add_argument("--embedders", default=",".join(EMBEDDERS),
                    help="comma-separated registry names (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ref, near, far = synth_sets(args.n_clips, args.input_sr, args.seconds)
    names = [n for n in args.embedders.split(",") if n]
    print(f"{args.n_clips} clips x {len(names)} embedders")
    worse = []
    for name in names:
        t0 = time.perf_counter()
        am = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=embedder(name, args.device),
                          win_dur=args.seconds, input_sr=args.input_sr, device=args.device)
        am.add_reference(ref)
        r_near, r_far = am.evaluate(near), am.evaluate(far)
        print(f"{name:28s} fad {r_near['fad']:>12.4g} / {r_far['fad']:>12.4g}"
              f"   density {r_near['density']:.2f} / {r_far['density']:.2f}"
              f"   ({time.perf_counter() - t0:.1f}s)")
        if not r_near["fad"] <= r_far["fad"]:
            worse.append(name)
    if worse:
        print(f"sweep: the far candidates scored better under {worse}")
        return 1
    print("sweep OK: near-candidates beat far-candidates on every embedder")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
