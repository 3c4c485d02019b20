"""Kernels #1 and #2 (the Swin blocks and the patch merges) against their
roofline: the sum of each block's and each merge's bound
(``yardstick.swin_blocks_bound_s``, ``merges_bound_s``) over the traced
evaluates' forwards, over the device time of the kernels that
``swin_roofline.<config>.txt`` names (``yardstick.short`` names), in
percent.  Where a kernel of that list does not run (renamed, or the
forward took another path), or the configuration has no list, the metric
is not read."""

from pathlib import Path

from port_bench.yardstick import merges_bound_s, short, swin_blocks_bound_s


def read(run):
    cfg, batch = run.cell.config, run.cell.traffic["batch_size"]
    listed = Path(__file__).with_name(f"swin_roofline.{cfg['name']}.txt")
    if run.trace is None or not listed.exists():
        return None
    names = {ln.strip() for ln in listed.read_text().splitlines()
             if ln.strip() and not ln.startswith("#")}
    busy = {}
    for _, s, e, n in run.trace["ops"]:
        if short(n) in names:
            busy[short(n)] = busy.get(short(n), 0) + (e - s) / 1e9
    if set(busy) != names:
        return None
    bound = 0.0
    for ev in (e for e in run.evals if e.traced):
        full, rest = divmod(ev.clips, batch)
        bound += full * (swin_blocks_bound_s(cfg, batch) + merges_bound_s(cfg, batch))
        if rest:
            bound += swin_blocks_bound_s(cfg, rest) + merges_bound_s(cfg, rest)
    return 100.0 * bound / sum(busy.values())
