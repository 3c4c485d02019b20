"""The whole evaluate's share of the configuration's peak: the model
operations of the window's forwards, counted once from shapes
(``yardstick.forward_ops``: the DFT and mel of the frames a clip needs,
the bicubic stretch, the patch embedding, the Swin blocks, the merges,
the projection), times the candidate clips completed, over the window's
seconds and ``peak_ops_per_s``, in percent."""

from port_bench.readers import clips_per_s
from port_bench.yardstick import forward_ops


def read(run):
    rate = clips_per_s(run)
    if rate is None:
        return None
    cfg, mix = run.cell.config, run.cell.traffic
    n = int(round(mix["win_dur"] * cfg["sample_rate"]))
    return 100.0 * rate * forward_ops(cfg, n) / cfg["peak_ops_per_s"]
