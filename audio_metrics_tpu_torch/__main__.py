"""Command line: evaluate directories of WAV files, keep reference state,
convert torch checkpoints.

    python -m audio_metrics_tpu_torch evaluate --reference ref/ --candidate cand/
    python -m audio_metrics_tpu_torch evaluate --load-state ref.npz --candidate cand/
    python -m audio_metrics_tpu_torch convert laion_clap.pt clap.npz --arch clap

The JAX package's command line (``python -m audio_metrics_tpu``) with the
same arguments and output, and ``--device`` (default ``cuda``; ``cpu``
runs every kernel's plain version).  Mono files are stems (fad, fad_inf,
kd, prdc); stereo files (context, stem) pairs, which apa needs.  All files
of a directory must share one sample rate, which is the input rate unless
``--input-sr`` is given.  The songs go through the host-fed pipeline
(``parallel.pipeline``), ``AM_TPU_NATIVE_LOADER=1`` selecting the C++
batcher.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _iter_wav_dir(path: Path):
    from .utils.wavio import read_wav

    files = sorted(p for p in path.glob("*.wav"))
    if not files:
        raise SystemExit(f"error: no .wav files in {path}")
    sr0 = None
    items = []
    for fp in files:
        data, sr = read_wav(fp)
        if sr0 is None:
            sr0 = sr
        elif sr != sr0:
            raise SystemExit(f"error: {fp} has sample rate {sr}, expected {sr0} "
                             "(all files in a directory must match)")
        if data.ndim == 2 and data.shape[1] == 1:
            data = data[:, 0]
        items.append(data.astype(np.float32))
    return items, sr0


def _cmd_evaluate(args) -> int:
    from . import AudioMetrics

    reference = candidate = None
    sr = args.input_sr
    if args.candidate:
        candidate, c_sr = _iter_wav_dir(Path(args.candidate))
        sr = sr or c_sr
    if args.reference:
        reference, r_sr = _iter_wav_dir(Path(args.reference))
        sr = sr or r_sr
        if candidate is not None and r_sr != c_sr:
            raise SystemExit(f"error: reference sr {r_sr} != candidate sr {c_sr}")
    if reference is None and not args.load_state:
        raise SystemExit("error: need --reference and/or --load-state")

    am = AudioMetrics(metrics=args.metrics, n_pca=args.n_pca, embedder=args.embedder,
                      mix_function=args.mix_function, win_dur=args.win_dur,
                      hop_dur=args.hop_dur, input_sr=sr, batch_size=args.batch_size,
                      progress=args.progress, device=args.device)
    if args.load_state:
        am.load_state(args.load_state)
    if reference is not None:
        am.add_reference(reference)
    if args.save_state:
        am.save_state(args.save_state)
        print(f"reference state written to {args.save_state}", file=sys.stderr)
    if candidate is None:
        if not args.save_state:
            raise SystemExit("error: need --candidate (or --save-state)")
        return 0
    result = am.evaluate(candidate)
    print(json.dumps({k: float(v) for k, v in result.items()}, indent=2))
    return 0


def _cmd_convert(args) -> int:
    import torch

    state = torch.load(args.src, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    if args.arch == "clap":
        from .convert import convert_checkpoint
        from .models.htsat import HTSAT_BASE

        params = convert_checkpoint(state, cfg=HTSAT_BASE, strict=True)
    else:
        from .models.vggish import convert_torch_state_dict

        params = convert_torch_state_dict(state)
    np.savez(args.out, **{k: np.asarray(v) for k, v in params.items()})
    print(f"wrote {len(params)} arrays to {args.out}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m audio_metrics_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=("Checkpoints resolve via AM_TPU_CKPT_DIR / the download cache; set "
                "AM_TPU_ALLOW_RANDOM_WEIGHTS=1 to run embedders with random weights "
                "(benchmark-valid FLOPs, NOT metric-valid values)."),
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    ev = sub.add_parser("evaluate", help="embed + score WAV directories")
    ev.add_argument("--reference", help="directory of reference .wav files")
    ev.add_argument("--candidate", help="directory of candidate .wav files")
    ev.add_argument("--metrics", nargs="+", default=["fad", "kd", "prdc"],
                    choices=["fad", "fad_inf", "kd", "prdc", "apa"])
    ev.add_argument("--embedder", default=None, help="registry name (default: laion_clap_music)")
    ev.add_argument("--mix-function", default=None, help="registry name (default: L0)")
    ev.add_argument("--win-dur", type=float, default=5.0)
    ev.add_argument("--hop-dur", type=float, default=None)
    ev.add_argument("--input-sr", type=int, default=None)
    ev.add_argument("--n-pca", type=int, default=None)
    ev.add_argument("--batch-size", type=int, default=32)
    ev.add_argument("--progress", action="store_true")
    ev.add_argument("--save-state", help="write reference state (.npz) after add_reference")
    ev.add_argument("--load-state",
                    help="restore reference state (.npz) instead of/before --reference")
    ev.add_argument("--device", default="cuda",
                    help="torch device of the embedder and the metrics (default: cuda)")
    ev.set_defaults(fn=_cmd_evaluate)

    cv = sub.add_parser("convert", help="torch checkpoint -> torch-free .npz params")
    cv.add_argument("src", help="source .pt/.pth checkpoint")
    cv.add_argument("out", help="output .npz path")
    cv.add_argument("--arch", choices=["clap", "vggish"], default="clap")
    cv.set_defaults(fn=_cmd_convert)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
