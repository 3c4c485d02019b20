"""Basic usage: APA + FAD over synthetic context+stem pairs.

Counterpart of ``examples/1_basic_usage.py``: matching ("real") and
mismatched ("fake") context+stem WAV pairs are written to a temporary
directory, the real set is added as the reference, then both sets are
evaluated; the fake set should score worse.

    python -m audio_metrics_tpu_torch.examples.basic_usage [--n-items 20]
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.examples import embedder
from audio_metrics_tpu_torch.utils.example_utils import generate_audio_samples
from audio_metrics_tpu_torch.utils.wavio import read_wav


def wav_dir_iterator(path):
    """(n_samples, 2) context+stem songs of the directory's WAV files."""
    for fp in sorted(Path(path).glob("*.wav")):
        data, _sr = read_wav(fp)
        yield data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-items", type=int, default=20)
    ap.add_argument("--embedder", default="laion_clap_music")
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--seconds", type=float, default=10.0, help="length of each pair")
    ap.add_argument("--win-dur", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir = Path(tmp) / "audio"
        print(f"generating {args.n_items} real/fake samples in {audio_dir}")
        generate_audio_samples(audio_dir, n_items=args.n_items, sr=args.sr,
                               audio_len=int(args.seconds * args.sr))
        metrics = AudioMetrics(metrics=["apa", "fad"], embedder=embedder(args.embedder,
                                                                         args.device),
                               win_dur=args.win_dur, input_sr=args.sr, device=args.device)
        metrics.add_reference(wav_dir_iterator(audio_dir / "real"))
        result_real = metrics.evaluate(wav_dir_iterator(audio_dir / "real"))
        result_fake = metrics.evaluate(wav_dir_iterator(audio_dir / "fake"))
    print("real:", result_real)
    print("fake:", result_fake)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
