"""Streaming eval of a clip generator, spread over devices.

Counterpart of ``examples/4_streaming_eval.py``: a generator of synthetic
clips (nothing materialised) streams through the host-fed path; each batch
is cut across the mesh's shards (``--devices`` -> ``device_indices``), the
per-category moments merge in float64 on the device, and with ``--metrics
fad`` no embedding is stored, so memory is O(d^2) whatever the number of
clips.

    python -m audio_metrics_tpu_torch.examples.streaming_eval --n-clips 2000 --devices 0-3
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.examples import embedder


def clip_stream(n_clips: int, sr: int, seed: int, loud: float, seconds: float = 5.0):
    """Synthetic clips, one at a time: the pipeline never holds more than
    a batch of them."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    for _ in range(n_clips):
        f0 = rng.uniform(80, 800)
        yield (0.2 * np.sin(2 * np.pi * f0 * t) + loud * rng.normal(size=t.shape)).astype(
            np.float32)


def parse_devices(spec: str | None):
    """``"0-7"`` or ``"0,1"`` -> a list of indices; None -> None."""
    if not spec:
        return None
    if "-" in spec:
        lo, hi = spec.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(d) for d in spec.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-clips", type=int, default=100_000)
    ap.add_argument("--input-sr", type=int, default=16000)
    ap.add_argument("--seconds", type=float, default=5.0, help="clip and window length")
    ap.add_argument("--embedder", default="dummy")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--metrics", default="fad",
                    help="comma list; fad alone keeps memory O(d^2) (kd, prdc store embeddings)")
    ap.add_argument("--devices", default=None,
                    help="e.g. '0-3' or '0,1': the devices to spread the batches over")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    am = AudioMetrics(metrics=args.metrics.split(","), embedder=embedder(args.embedder,
                                                                           args.device),
                      win_dur=args.seconds, input_sr=args.input_sr, batch_size=args.batch_size,
                      device_indices=parse_devices(args.devices), device=args.device)
    sr = args.input_sr
    t0 = time.perf_counter()
    am.add_reference(clip_stream(args.n_clips, sr, 0, 0.05, args.seconds))
    t_ref = time.perf_counter() - t0
    print(f"mesh: {am.mesh}")
    print(f"reference: {args.n_clips} clips ({am.stem_reference.n} windows) streamed in "
          f"{t_ref:.1f}s = {args.n_clips / t_ref:.0f} clips/s")
    t0 = time.perf_counter()
    result = am.evaluate(clip_stream(args.n_clips, sr, 1, 0.05, args.seconds))
    t_eval = time.perf_counter() - t0
    print(f"candidate: streamed+scored in {t_eval:.1f}s = {args.n_clips / t_eval:.0f} clips/s "
          f"-> {result}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
