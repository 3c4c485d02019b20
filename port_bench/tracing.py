"""Reading the profiler's record of the traced sub-window.

The profiler (``torch.profiler`` with CUDA activity alone, kept in memory)
gives each operation that ran on a card with its start and end on the
host's wall clock (the clock of ``time.time_ns``).  From them: each card's
busy seconds as the union of its operations' intervals inside the traced
window (two streams that overlap count once), the operations by name
(``yardstick.short``), and the stretches in which no card ran anything,
each named by what the host was doing then: the stage of ``evaluate``
that the program's ``timings`` place there, or the harness's loop between
two evaluates.
"""

from __future__ import annotations

from .yardstick import gaps, short, union_s

_STAGES = ("pipeline", "projection", "kd_dispatch", "prdc_dispatch", "fad_inf_dispatch", "fad")


def host_spans(traced) -> list[tuple[int, int, str]]:
    """(start_ns, end_ns, label) of the host's stages over the traced
    evaluates: the program's consecutive stages from each call, then its
    one pull and the reduces after it, the return, and the harness's loop
    between two evaluates."""
    spans, prev = [], None
    for e in traced:
        if prev is not None:
            spans.append((prev, e.call_ns, "harness.between_evaluates"))
        t = e.call_ns
        for key in _STAGES:
            if key in e.timings:
                d = int(e.timings[key] * 1e9)
                spans.append((t, t + d, f"evaluate.{key}"))
                t += d
        pull = int(e.timings.get("finalize_pull", 0.0) * 1e9)
        fin = int(e.timings.get("finalize", 0.0) * 1e9)
        spans.append((t, t + pull, "evaluate.finalize_pull"))
        spans.append((t + pull, t + max(pull, fin), "evaluate.finalize"))
        spans.append((t + max(pull, fin), e.ret_ns, "evaluate.return"))
        prev = e.ret_ns
    return spans


def label_at(spans, t: int) -> str:
    for s, e, label in spans:
        if s <= t < e:
            return label
    return "host.unknown"


def read_trace(prof, evals, device_indices) -> dict:
    """The traced evaluates' operations (``ops``: (card, start_ns, end_ns,
    name), clipped to the window from the first traced call to the last
    traced return), each card's busy seconds, their mean ``busy_s``, the
    window's ``window_s``, and the ``breakdown``: the 10 operations that
    took most device time and the 10 longest idle stretches."""
    import torch

    traced = [e for e in evals if e.traced]
    if not traced:
        return None
    lo, hi = traced[0].call_ns, traced[-1].ret_ns
    ops = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s, e = max(ev.start_ns(), lo), min(ev.end_ns(), hi)
        if e > s:
            ops.append((ev.device_index(), s, e, ev.name()))
    busy = [union_s([(s, e) for d, s, e, _ in ops if d == dev]) for dev in device_indices]
    by_name: dict = {}
    for _, s, e, name in ops:
        key = short(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
    spans = host_spans(traced)
    idle = sorted(((label_at(spans, (s + e) // 2), (e - s) / 1e9)
                   for s, e in gaps([(s, e) for _, s, e, _ in ops], lo, hi)),
                  key=lambda g: -g[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(
        ops=ops, busy_per_device=busy, busy_s=sum(busy) / len(busy), window_s=(hi - lo) / 1e9,
        breakdown={"device_ops": [[n, s] for n, s in top[:10]],
                   "idle_gaps": [[n, s] for n, s in idle[:10]]},
    )
