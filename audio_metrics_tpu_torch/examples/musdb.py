"""MUSDB18 stems: FAD/KD/PRDC with VGGish over real music stems.

Counterpart of ``examples/2_musdb.py``.  Needs the optional ``musdb``
package and the MUSDB18 dataset on disk (``--root``, or ``MUSDB_PATH``):
nothing is downloaded.  Windowing, resampling from 44.1 kHz to the
embedder's rate, batching and the metrics run on the device.

    python -m audio_metrics_tpu_torch.examples.musdb --root /data/musdb18
"""

from __future__ import annotations

import argparse

import numpy as np

from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.examples import embedder


def musdb_tracks(root, subset, target="vocals", max_tracks=None):
    """Mono ``target`` stems of the ``subset`` tracks, one song at a time."""
    try:
        import musdb
    except ImportError as exc:
        raise SystemExit(
            "this example needs the optional `musdb` package and the MUSDB18 dataset "
            "(https://sigsep.github.io/datasets/musdb.html) on disk") from exc
    db = musdb.DB(root=root, download=False, subsets=subset)
    tracks = db.tracks[:max_tracks] if max_tracks else db.tracks
    for track in tracks:
        yield track.targets[target].audio.mean(axis=1).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="the dataset's directory (else MUSDB_PATH)")
    ap.add_argument("--target", default="vocals")
    ap.add_argument("--max-tracks", type=int, default=20)
    ap.add_argument("--embedder", default="vggish")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reference = musdb_tracks(args.root, "train", args.target, args.max_tracks)
    candidate = musdb_tracks(args.root, "test", args.target, args.max_tracks)
    first = next(reference)  # fails here, before any model is built, without musdb
    am = AudioMetrics(metrics=["fad", "kd", "prdc"], embedder=embedder(args.embedder,
                                                                         args.device),
                      win_dur=5.0, input_sr=44100, device=args.device)
    am.add_reference(_chain(first, reference))
    for k, v in am.evaluate(candidate).items():
        print(f"{k}: {v:.5f}")
    return 0


def _chain(first, rest):
    yield first
    yield from rest


if __name__ == "__main__":
    raise SystemExit(main())
