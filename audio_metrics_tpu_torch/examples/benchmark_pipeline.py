"""Per-stage pipeline profiler.

Counterpart of ``examples/benchmark_pipeline.py`` (the reference's
examples/benchmark_pipeline.py:37-66,167-305): the host-fed pipeline's
stages run one after another, each timed by the wall clock (a device stage
up to ``torch.cuda.synchronize()`` on a card), then a stage table,
songs/s, windows/s and the device stages' share.  ``--trace-dir`` writes a
``torch.profiler`` trace of the batch loop (Chrome trace JSON).

    python -m audio_metrics_tpu_torch.examples.benchmark_pipeline --n-songs 50
    python -m audio_metrics_tpu_torch.examples.benchmark_pipeline \\
        --embedder laion_clap_music --batch-size 128 --trace-dir trace/
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from itertools import tee
from pathlib import Path

import numpy as np
import torch

from audio_metrics_tpu_torch.data import AudioMetricsData
from audio_metrics_tpu_torch.examples import embedder as get_embedder
from audio_metrics_tpu_torch.ops.mix import MIX_FUNCTIONS
from audio_metrics_tpu_torch.ops.windowing import multi_audio_slicer
from audio_metrics_tpu_torch.parallel.pipeline import (
    ItemCategory,
    _bucketed_batches,
    _resampler,
    device_mix,
    serialize_items,
)
from audio_metrics_tpu_torch.parallel.shuffle import shuffle_stream


@dataclass
class StageTimer:
    """Wall-clock seconds and item counts per named stage."""

    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def timed(self, name, iterator):
        """``iterator``'s items, the time to make each added to ``name``."""
        while True:
            t0 = time.perf_counter()
            try:
                item = next(iterator)
            except StopIteration:
                return
            self.add(name, time.perf_counter() - t0)
            yield item

    def report(self, total_time, n_songs, n_windows, device_stages=()):
        print(f"\n{'stage':<28}{'time (s)':>10}{'items':>8}{'share':>8}")
        print("-" * 54)
        for name, t in self.times.items():
            share = 100.0 * t / total_time if total_time else 0.0
            print(f"{name:<28}{t:>10.3f}{self.counts[name]:>8}{share:>7.1f}%")
        print("-" * 54)
        print(f"{'total':<28}{total_time:>10.3f}")
        print(f"\nsongs/sec:    {n_songs / total_time:.2f}")
        print(f"windows/sec:  {n_windows / total_time:.2f}")
        device_time = sum(self.times.get(s, 0.0) for s in device_stages)
        if device_time:
            print(f"device-stage share: {100 * device_time / total_time:.1f}%")


def synthetic_songs(n_songs, duration_s, sr, stereo):
    rng = np.random.default_rng(0)
    n = int(duration_s * sr)
    for _ in range(n_songs):
        shape = (n, 2) if stereo else (n,)
        yield (0.2 * rng.normal(size=shape)).astype(np.float32)


def run(args) -> None:
    emb = get_embedder(args.embedder, args.device)
    device = emb.device
    mix_fn = MIX_FUNCTIONS[args.mix_function]
    input_sr = args.input_sr or emb.sr
    resample = _resampler(input_sr, emb.sr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    timer = StageTimer()
    t_start = time.perf_counter()
    songs = timer.timed("generate", synthetic_songs(args.n_songs, args.song_duration, input_sr,
                                                    stereo=args.apa))
    if args.apa:
        songs = timer.timed("shuffle songs", shuffle_stream(songs, buffer_size=100))
    windows = timer.timed("window", multi_audio_slicer(songs, args.win_dur, sr=input_sr))
    shuffled = None
    if args.apa:
        windows, shuffled = tee(windows)
        shuffled = shuffle_stream(shuffled, buffer_size=1000, min_age=100)
    items = timer.timed("serialize", serialize_items(windows, shuffled, apa_mode=args.apa,
                                                     stems_mode=True))
    stats = {}
    n_windows = 0

    def run_batches():
        nonlocal n_windows
        batches = _bucketed_batches(items, args.batch_size, pin_memory=device.type == "cuda")
        for kind, audio, category, valid in batches:
            n = int(valid.sum())
            n_windows += n
            t0 = time.perf_counter()
            audio = resample(audio[:n].to(device))
            sync()
            timer.add("upload+resample [dev]", time.perf_counter() - t0)
            if kind == "pair":
                t0 = time.perf_counter()
                audio = device_mix(mix_fn, audio, emb.sr)
                sync()
                timer.add("mix [dev]", time.perf_counter() - t0)
            t0 = time.perf_counter()
            e = emb.embed(audio).float()
            for c in np.unique(category[:n]):
                rows = torch.from_numpy(np.flatnonzero(category[:n] == c)).to(device)
                stats.setdefault(ItemCategory(int(c)), AudioMetricsData(False)).add(e[rows])
            sync()
            timer.add("embed+moments [dev]", time.perf_counter() - t0)

    if args.trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            run_batches()
        path = Path(args.trace_dir) / "pipeline_trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        print(f"torch.profiler trace written to {path}")
    else:
        run_batches()
    total = time.perf_counter() - t_start
    timer.report(total, args.n_songs, n_windows,
                 ("upload+resample [dev]", "mix [dev]", "embed+moments [dev]"))
    for c, a in stats.items():
        print(f"category {c.name}: n={len(a)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-songs", type=int, default=20)
    ap.add_argument("--song-duration", type=float, default=30.0)
    ap.add_argument("--win-dur", type=float, default=5.0)
    ap.add_argument("--input-sr", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--embedder", default="dummy")
    ap.add_argument("--mix-function", default="L0")
    ap.add_argument("--apa", action="store_true", help="profile the APA path")
    ap.add_argument("--trace-dir", default=None, help="write a torch.profiler trace there")
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
