"""Context+stem mixing functions, batched on the signals' device.

Counterpart of ``audio_metrics_tpu/ops/mix.py`` (the reference's
mix_functions.py:209-344): each registry mix takes one window ``(n, 2)``
(channel 0 the context, channel 1 the stem) or a batch ``(B, n, 2)`` and
meters, stages gains, sums, normalises and limits the whole batch on its
device.  ``PP`` peak-preserve; ``P0/P1/P2`` peak-normalise (stem -0/-3/-6
dB, out -3 dB); ``L0/L1/L2`` loudness-based (stem -0/-3/-6 dB relative to
the context, out -20 LUFS, brick-wall limited where the peak exceeds 1.0).
Default: ``L0``.  As in the JAX package (x64 on), the loudness-based gains
come from float64 loudness differences, cast to f32; the signals stay f32.
"""

from __future__ import annotations

import warnings
from functools import partial

import torch

from .limiter import limit_batch
from .loudness import integrated_loudness_batch

__all__ = [
    "mix_tracks_peak_preserve",
    "mix_tracks_peak_normalize",
    "mix_tracks_loudness",
    "mix_preserve_loudness",
    "MIX_FUNCTIONS",
    "DEFAULT_MIX_FUNCTION",
    "emit_mix_diagnostics",
]

_EPS = 1e-5


def _batched(fn):
    """Take ``(n, 2)`` or ``(B, n, 2)`` (a tensor, or a numpy array taken to
    the CPU) and mark the function batch-capable (``is_batched_mix``) for
    the pipeline.  ``diag``: a list that collects each batch's diagnostic
    flags (device tensors, not read here: ``emit_mix_diagnostics`` reads
    them once per run, so the mix loop never waits for the card); with
    ``diag=None`` the warnings are emitted at once, as the reference does
    per window."""

    def wrapper(audio, sr=None, diag=None, **kwargs):
        x = torch.as_tensor(audio).float()
        single = x.ndim == 2
        if single:
            x = x[None]
        if x.ndim != 3:
            raise ValueError(f"audio must be (n, ch) or (batch, n, ch), got {tuple(x.shape)}")
        out = fn(x, sr=sr, **kwargs)
        if isinstance(out, tuple):
            out, flags = out
            if diag is not None:
                diag.append(flags)
            else:
                emit_mix_diagnostics([flags])
        return out[0] if single else out

    wrapper.is_batched_mix = True
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def emit_mix_diagnostics(diag) -> None:
    """Read the collected mix flags in one copy to the host and emit the
    reference's warnings (mix_functions.py:270, :293-299): silent channels
    and limited peaks, over all windows of a run."""
    if not diag:
        return
    flags = torch.stack([torch.cat([f[k].flatten().float() for f in diag])
                         for k in ("both_silent", "one_silent", "peak")]).cpu().numpy()
    n_both, n_one = int(flags[0].sum()), int(flags[1].sum())
    peaks = flags[2]
    n_lim = int((peaks > 1.0).sum())
    if n_both:
        warnings.warn(f"Both channels silent ({n_both} of {peaks.size} windows)")
    if n_one:
        warnings.warn(f"One channel silent ({n_one} of {peaks.size} windows)")
    if n_lim:
        warnings.warn(
            f"Reducing gain (peak amp: {peaks.max():.2f}; "
            f"{n_lim} of {peaks.size} windows limited)"
        )


# ----------------------------------------------------------------------
# peak-based mixes
# ----------------------------------------------------------------------
@_batched
def mix_tracks_peak_preserve(audio, sr=None):
    """Mean of the channels, scaled back to the original peak
    (mix_functions.py:209-227); silent inputs pass channel 0 through."""
    del sr
    if audio.shape[2] == 1:
        return audio[:, :, 0]
    vmax_orig = audio.abs().amax(dim=(1, 2))
    mix = audio.mean(dim=2)
    vmax_new = mix.abs().amax(dim=1)
    mixed = mix * (vmax_orig / torch.clamp(vmax_new, min=1e-30))[:, None]
    return torch.where((vmax_orig <= _EPS)[:, None], audio[:, :, 0], mixed)


@_batched
def mix_tracks_peak_normalize(audio, sr=None, stem_db_red=0.0, out_db=0.0):
    """Each channel peak-normalised (the stem then reduced by
    ``stem_db_red``), summed, the mix peak-normalised to ``out_db``
    (mix_functions.py:230-249)."""
    del sr
    out_gain = 10.0 ** (out_db / 20.0)
    stem_gain = 10.0 ** (stem_db_red / 20.0)
    if audio.shape[2] == 1:
        mix = audio[:, :, 0]
    else:
        peaks = audio.abs().amax(dim=1, keepdim=True)  # (B, 1, C)
        peaks[:, :, 1] *= stem_gain
        mix = (audio / torch.clamp(peaks, min=1e-30)).sum(dim=2)
    peak = mix.abs().amax(dim=1, keepdim=True)
    return mix * (out_gain / torch.clamp(peak, min=1e-30))


# ----------------------------------------------------------------------
# loudness-based mixes (the default family)
# ----------------------------------------------------------------------
def _db_gain(delta_db: torch.Tensor) -> torch.Tensor:
    return 10.0 ** (delta_db / 20.0)


def _mix_loudness(audio: torch.Tensor, sr: int, stem_db_red: float, out_db: float):
    """(B, n, 2) f32 -> ((B, n) f32 mixes, flags) (audio_metrics_tpu/ops/
    mix.py:142-190).  The limiter runs on the whole batch and is selected
    per item by ``torch.where``: the JAX package skips it when no item
    peaks (``lax.cond``), which here would wait for the card inside the
    mix loop; the output is the same."""
    s0, s1 = audio[:, :, 0], audio[:, :, 1]
    silent = audio.abs().amax(dim=1) < _EPS  # (B, 2)
    both_silent = silent.all(dim=1)
    one_silent = silent.any(dim=1) & ~both_silent

    # loudness of both channels in one metering pass, float64 (B,) each
    l0, l1 = integrated_loudness_batch(torch.cat([s0, s1]), sr).reshape(2, -1)

    # the stem's loudness set relative to the context's
    l1_trg = l0 + stem_db_red
    gain_ok = torch.isfinite(l1) & torch.isfinite(l1_trg)
    s1_gain = torch.where(gain_ok, _db_gain(l1_trg - l1), 1.0).float()
    mix = s0 + s1 * s1_gain[:, None]

    # exactly one channel silent: the mix is the other one
    nonsilent = torch.where(silent[:, 0:1], s1, s0)
    mix = torch.where(one_silent[:, None], nonsilent, mix)

    # the mix normalised to the output loudness
    l_mix = integrated_loudness_batch(mix, sr)
    norm_gain = torch.where(torch.isfinite(l_mix), _db_gain(out_db - l_mix), 1.0).float()
    mix = mix * norm_gain[:, None]

    # brick-wall limit the items that peak above 1.0
    peak = mix.abs().amax(dim=1)
    mix = torch.where((peak > 1.0)[:, None], limit_batch(mix), mix)

    # both channels silent: channel 0 passes through untouched
    out = torch.where(both_silent[:, None], s0, mix)
    return out, {"both_silent": both_silent, "one_silent": one_silent, "peak": peak}


@_batched
def mix_tracks_loudness(audio, sr=None, stem_db_red=-4.0, out_db=-20.0):
    """BS.1770 loudness of context and stem, the stem set ``stem_db_red``
    dB from the context, summed, the mix normalised to ``out_db`` LUFS and
    brick-wall limited where its peak exceeds 1.0 (mix_functions.py:
    281-332)."""
    if sr is None:
        raise ValueError("mix_tracks_loudness requires sr")
    if audio.shape[2] == 1:
        return audio[:, :, 0]
    return _mix_loudness(audio, int(sr), float(stem_db_red), float(out_db))


def mix_preserve_loudness(audio, sr=None):
    """Loudness-preserving sum (mix_functions.py:252-278; not in the
    registry): the channels summed in float64, the sum brought to the
    louder channel's loudness, limited where it peaks above 1.0 (a warning,
    which reads the peaks on the host)."""
    x = torch.as_tensor(audio).float()
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    s0, s1 = x[:, :, 0].double(), x[:, :, 1].double()
    s2 = s0 + s1
    l_all = integrated_loudness_batch(torch.cat([s0, s1, s2]), int(sr)).reshape(3, -1)
    l_trg = torch.maximum(l_all[0], l_all[1])
    ok = torch.isfinite(l_trg) & torch.isfinite(l_all[2])
    s2 = s2 * torch.where(ok, _db_gain(l_trg - l_all[2]), 1.0)[:, None]
    peak = s2.abs().amax(dim=1)
    peak_max = float(peak.max())
    if peak_max > 1.0:
        warnings.warn(f"Reducing gain (peak amp: {peak_max:.2f})")
    out = s2.float()
    out = torch.where((peak > 1.0)[:, None], limit_batch(out), out)
    return out[0] if squeeze else out


mix_preserve_loudness.is_batched_mix = True


MIX_FUNCTIONS = dict(
    PP=mix_tracks_peak_preserve,
    P0=partial(mix_tracks_peak_normalize, stem_db_red=-0, out_db=-3),
    P1=partial(mix_tracks_peak_normalize, stem_db_red=-3, out_db=-3),
    P2=partial(mix_tracks_peak_normalize, stem_db_red=-6, out_db=-3),
    L0=partial(mix_tracks_loudness, stem_db_red=0, out_db=-20),
    L1=partial(mix_tracks_loudness, stem_db_red=-3, out_db=-20),
    L2=partial(mix_tracks_loudness, stem_db_red=-6, out_db=-20),
)
DEFAULT_MIX_FUNCTION = "L0"

# partial() hides the wrapped function's attributes: mark the entries
for _fn in MIX_FUNCTIONS.values():
    _fn.is_batched_mix = True
