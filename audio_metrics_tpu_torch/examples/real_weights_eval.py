"""Real-weights end-to-end eval: the metric-validity run.

Counterpart of ``examples/5_real_weights_eval.py``: with the LAION CLAP
music checkpoint provisioned, reference-style synthetic real and fake
context+stem pairs (``utils.example_utils``) are scored with real weights
(FAD, KD, PRDC, APA); the fake set must score worse.  Without the
checkpoint it exits with instructions instead of running random weights.

    AM_TPU_CKPT_DIR=/path/with/music_audioset_epoch_15_esc_90.14.pt \\
        python -m audio_metrics_tpu_torch.examples.real_weights_eval
"""

from __future__ import annotations

import argparse

import numpy as np

from audio_metrics_tpu_torch import AudioMetrics
from audio_metrics_tpu_torch.models.clap import LAION_CLAP_MUSIC_CHECKPOINT_URL
from audio_metrics_tpu_torch.utils.example_utils import mix_stem_pair
from audio_metrics_tpu_torch.utils.get_url import resolve_checkpoint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-items", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if resolve_checkpoint(LAION_CLAP_MUSIC_CHECKPOINT_URL) is None:
        print("No real CLAP checkpoint reachable.  Provision\n"
              f"  {LAION_CLAP_MUSIC_CHECKPOINT_URL.rsplit('/', 1)[-1]}\n"
              "under $AM_TPU_CKPT_DIR (or the cache dir) and re-run.")
        return 1
    sr = 48000
    rng = np.random.default_rng(0)

    def pairs(matching):
        out = []
        for _ in range(args.n_items):
            ctx, stem, _ = mix_stem_pair(sr, 5 * sr, matching, rng)
            out.append(np.stack([ctx, stem], axis=1).astype(np.float32))
        return out

    real, fake = pairs(True), pairs(False)
    am = AudioMetrics(metrics=["apa", "fad", "kd", "prdc"], embedder="laion_clap_music",
                      win_dur=5.0, input_sr=sr, device=args.device)
    am.add_reference(real)
    res_real, res_fake = am.evaluate(real), am.evaluate(fake)
    print("real vs real:", {k: round(float(v), 6) for k, v in res_real.items()})
    print("fake vs real:", {k: round(float(v), 6) for k, v in res_fake.items()})
    if not res_fake["fad"] > res_real["fad"]:
        print("metric-validity check FAILED: the fake set does not score worse")
        return 1
    print("metric-validity check passed (fake scores worse than real)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
