"""The benchmark's frozen yardstick: operations and bytes from shapes, the
bounds they give against a configuration's peaks, kernel-name groups, and
the busy time of a device as the union of its operations' intervals.

The operation and byte counts copy ``chip_smoke.py``'s ``swin_bound`` and
``merge_bound`` (``forward_ops`` counts the frontend as ``log_mel_bound``
and ``frontend_bound`` do, over the bins the filterbank weighs) with one
change: f32 operations are counted once, at the configuration's
``peak_ops_per_s`` (495 TFLOP/s for f32, the TF32 dense rate, the highest
at which the tensor cores take f32-width inputs), and not as three TF32
products.  So no way of computing the same work reads above 100% of its
roofline.  ``short`` copies ``profile_evaluate._short``.  Later changes to
the program do not move any of this.
"""

from __future__ import annotations

import numpy as np

BYTES = {"float32": 4, "bfloat16": 2}

# kernel names kept whole up to this key (template arguments dropped) or
# cut to the key (frozen copy of profile_evaluate._short)
_SHORT_KEYS = ("gemm_sm90_kernel<", "gemm_tf32x3_kernel<", "knn_split_kernel", "knn_merge_kernel",
               "merge_stats_kernel", "stats_split_kernel", "mel_log_kernel", "ln_rows_kernel",
               "ln1_window_kernel", "hop_rows_kernel", "halo_rows_kernel", "log_mel_sm90_kernel",
               "window_attn_kernel", "frame_rows_kernel", "merged_attn_bf16",
               "merged_attn_f32", "merged_dense_bf16", "merged_dense_f32")


def short(name: str) -> str:
    """A kernel's name without its template arguments and namespace."""
    for key in _SHORT_KEYS:
        if key in name:
            i = name.find(key)
            return name[i : name.find(">", i) + 1] if key.endswith("<") else key
    return name[:80]


def bound_s(ops: float, n_bytes: float, cfg: dict) -> float:
    """Least seconds the card could take: the larger of the operations
    over the configuration's peak rate and the bytes over its memory
    rate."""
    return max(ops / cfg["peak_ops_per_s"], n_bytes / cfg["peak_bytes_per_s"])


def _stages(cfg: dict):
    """(channels, tokens a clip, window^2, depth, resolution) of each Swin
    stage."""
    res = cfg["spec_size"] // cfg["patch_stride"]
    for i, depth in enumerate(cfg["depths"]):
        yield cfg["embed_dim"] * 2**i, res * res, min(cfg["window_size"], res) ** 2, depth, res
        res //= 2


def block_ops(c: int, t: int, win2: int) -> float:
    """One Swin block on t tokens: qkv, proj, fc1 and fc2 (24 t C^2) and the
    window attention (4 t win^2 C)."""
    return 24.0 * t * c * c + 4.0 * t * win2 * c


def swin_blocks_bound_s(cfg: dict, b: int) -> float:
    """Sum of the bounds of the Swin blocks of one forward of ``b`` clips;
    bytes: each block's input and output rows and its 12 C^2 weights."""
    size = BYTES[cfg["dtype"]]
    total = 0.0
    for c, t, win2, depth, _ in _stages(cfg):
        ops = block_ops(c, b * t, win2)
        total += depth * bound_s(ops, (2 * b * t * c + 12 * c * c) * size, cfg)
    return total


def merges_bound_s(cfg: dict, b: int) -> float:
    """Sum of the bounds of the patch merges of one forward of ``b`` clips:
    (T/4, 4C) x (4C, 2C) each; bytes: rows in, rows out, weights."""
    size = BYTES[cfg["dtype"]]
    total = 0.0
    for c, t, _, _, res in list(_stages(cfg))[:-1]:
        t_out = b * (res // 2) ** 2
        total += bound_s(2.0 * t_out * 4 * c * 2 * c,
                         (b * t * c + t_out * 2 * c + 8 * c * c) * size, cfg)
    return total


def fb_bins(fb: np.ndarray) -> int:
    """The frequency bins a log-mel needs: up to the last bin with any mel
    weight (CLAP's 50-14000 Hz at 48 kHz, n_fft 1024: 299)."""
    return int(np.nonzero(np.any(fb != 0.0, axis=1))[0][-1]) + 1


def frames_needed(cfg: dict, n: int) -> int:
    """The distinct log-mel frames of an n-sample clip repeat-padded to
    10 s: where whole copies tile 10 s in whole hops, one period of frames
    and the two at each seam (p + 4); else every frame of the 10 s."""
    total, hop = 10 * cfg["sample_rate"], cfg["hop"]
    if n < total and total % n == 0 and n % hop == 0 and n >= cfg["n_fft"]:
        return n // hop + 4
    return total // hop + 1


def forward_ops(cfg: dict, n: int) -> float:
    """The model operations of one clip of n samples, counted once from
    shapes: the DFT and the mel product of the frames it needs, the
    bicubic stretch (4 taps), the patch embedding, the Swin blocks, the
    merges and the projection."""
    from .reference.clap_htsat import slaney_mel_filterbank

    fb = slaney_mel_filterbank(cfg["n_fft"] // 2 + 1, cfg["n_mels"], cfg["fmin"], cfg["fmax"],
                               cfg["sample_rate"])
    frames, bins, mels = frames_needed(cfg, n), fb_bins(fb), cfg["n_mels"]
    ratio = cfg["spec_size"] // mels
    ops = 2.0 * frames * cfg["n_fft"] * 2 * bins + 2.0 * frames * bins * mels
    ops += 8.0 * cfg["spec_size"] * ratio * mels
    grid = cfg["spec_size"] // cfg["patch_stride"]
    ops += 2.0 * grid * grid * cfg["patch_size"] ** 2 * cfg["embed_dim"]
    stages = list(_stages(cfg))
    ops += swin_block_ops(cfg)
    for c, t, _, _, res in stages[:-1]:
        ops += 2.0 * (res // 2) ** 2 * 4 * c * 2 * c
    feat, proj = stages[-1][0], cfg["projection_dim"]
    return ops + 2.0 * (feat * proj + proj * proj)


def swin_block_ops(cfg: dict) -> float:
    """The Swin blocks' operations of one clip (HTSAT-base: 29.83 G)."""
    return sum(depth * block_ops(c, t, win2) for c, t, win2, depth, _ in _stages(cfg))


def union_s(intervals) -> float:
    """Seconds covered by the union of (start_ns, end_ns) intervals: two
    operations that overlap count once."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def gaps(intervals, lo: int, hi: int):
    """The idle (start_ns, end_ns) stretches of [lo, hi] that no interval
    covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]
