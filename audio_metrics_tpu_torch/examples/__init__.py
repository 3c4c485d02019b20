"""The JAX package's ``examples/`` scripts, on the port.

Each module has ``main(argv=None)`` (its command line; ``--device``,
default ``cuda``) and runs as ``python -m audio_metrics_tpu_torch.examples.
<name>``:

- ``basic_usage``: APA + FAD over synthetic context+stem WAV pairs
  (``examples/1_basic_usage.py``);
- ``musdb``: FAD/KD/PRDC over MUSDB18 stems (``examples/2_musdb.py``);
- ``multi_embedder_sweep``: FAD/KD/PRDC under every registry embedder
  (``examples/3_multi_embedder_sweep.py``);
- ``streaming_eval``: a clip generator through the host-fed path, spread
  over ``--devices`` (``examples/4_streaming_eval.py``);
- ``real_weights_eval``: the metric-validity run on a provisioned LAION
  CLAP checkpoint (``examples/5_real_weights_eval.py``);
- ``benchmark_pipeline``: the per-stage pipeline profiler, with a
  ``torch.profiler`` trace (``examples/benchmark_pipeline.py``).

An embedder named without a checkpoint runs on seeded random weights
(``embedder``), as the JAX examples do: their values are not metric-valid.
"""

from __future__ import annotations

__all__ = ["embedder"]


def embedder(name: str, device: str):
    """The registry embedder ``name`` on ``device``; a CLAP or VGGish
    embedder whose checkpoint cannot be found takes seeded random weights
    (the JAX examples set ``AM_TPU_ALLOW_RANDOM_WEIGHTS``; here it is asked
    for per embedder, so that no process setting changes)."""
    from ..models import get_embedder

    if name == "dummy":
        return get_embedder(name, device=device)
    return get_embedder(name, device=device, allow_random_weights=True)
