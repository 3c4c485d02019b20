"""The live-tile map of the merged one-window attention, on the CPU, with
numpy and torch only.

Under ``AM_TPU_MERGED_ATTN`` stage 2 attends over one 256-token window an
image on a dense (1, heads, 256, 256) table with -1e9 on the pairs of two
8x8 windows (``models.htsat._merged_bias_mask``).  The merged kernel
(kernels/csrc/merged_attn.cuh) skips the key tiles (8 keys) that the map
made from the table's values marks dead for a block of 64 query rows (an
8x8 patch of the rolled image): ``ops.attention.merged_live_tiles``.  Held
here: on the port's stage-2 tables of HTSAT-base, HTSAT-tiny and a small
config, shift 0 and 4, each dead tile holds only entries <= -1e9 and each
live tile one above, per block as the kernel groups its rows; 8 of 32
tiles live a block (16 of 32 for 16 query rows in raster order); a dense
random table all live; a block holding a row masked everywhere, or a row
whose live entries sit within 1e6 of -1e9, all live; and the skip exact: the f32 softmax over the live keys only, scattered
back, equal to the dense softmax, each summed in key order (the kernel
sums each thread's keys in order and leaves out only exact zeros;
``torch.softmax`` groups its terms by position, so a gathered row would
group them otherwise).  The JAX package's own table: tests/
test_torch_merged.py.
"""

import numpy as np
import pytest
import torch

from audio_metrics_tpu_torch.models.htsat import (
    HTSAT_BASE,
    HTSAT_TINY,
    HTSATConfig,
    _bias_mask,
    _merged_bias_mask,
)
from audio_metrics_tpu_torch.ops.attention import MERGED_DEAD, MERGED_MARGIN, merged_live_tiles

SMALL = HTSATConfig(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
CONFIGS = {"base": HTSAT_BASE, "tiny": HTSAT_TINY, "small": SMALL}


def stage2_table(config: str, shift: int) -> torch.Tensor:
    """The merged (1, heads, 256, 256) table of a stage-2 block (R = 16,
    window 8) with a relative-position table at std 0.5."""
    cfg = CONFIGS[config]
    heads = cfg.num_heads[2]
    pre = "audio_encoder.layers.2.blocks.0.attention"
    rng = np.random.default_rng(30 + shift)
    p = {f"{pre}.self.relative_position_bias_table": rng.normal(
        scale=0.5, size=((2 * cfg.window_size - 1) ** 2, heads)).astype(np.float32)}
    return torch.from_numpy(_merged_bias_mask(_bias_mask(p, pre, 16, shift, heads, 8), 16, 8))


def block_rows() -> np.ndarray:
    """(4, 64): the raster tokens of the merged kernel's blocks, patch p =
    (p // 2, p % 2) of 8x8 tokens, its rows in raster order."""
    p, b = np.arange(4)[:, None], np.arange(64)[None]
    return ((p // 2) * 8 + b // 8) * 16 + (p % 2) * 8 + b % 8


def lists(live: torch.Tensor) -> list:
    """The map's lists without their padding, [head][block]."""
    return [[[int(t) for t in row if t >= 0] for row in head] for head in live[0]]


def check_map(bm: torch.Tensor, live: torch.Tensor) -> None:
    """The map against the table, block by block: a tile is listed unless
    every entry of the block's rows there is <= -1e9; all 32 where one of
    the block's rows has no entry above -1e9 + 1e6; lists ascending."""
    table = bm[0].numpy()
    heads = table.shape[0]
    assert live.dtype == torch.int32 and live.shape[:3] == (1, heads, 4)
    got = lists(live)
    for h in range(heads):
        for p, rows in enumerate(block_rows()):
            tiles = table[h][rows].reshape(64, 32, 8)
            dead = (tiles <= MERGED_DEAD).all(axis=(0, 2))
            masked_row = (table[h][rows] <= MERGED_DEAD + MERGED_MARGIN).all(axis=1).any()
            want = list(range(32)) if masked_row else [t for t in range(32) if not dead[t]]
            assert got[h][p] == want, (h, p)
            for t in set(range(32)) - set(want):
                assert (tiles[:, t] <= MERGED_DEAD).all()
            if not masked_row:
                for t in want:
                    assert (tiles[:, t] > MERGED_DEAD).any()


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("config", ["base", "tiny", "small"])
def test_map_lists_the_tiles_above_minus_1e9(config, shift):
    """On the stage-2 tables each block (a window at these tables) lists 8
    of 32 tiles, the dead ones all -1e9, the live ones above it (the shift
    mask's -100 is a live value); 16 query rows in raster order (one image
    row) would keep 16 of 32."""
    bm = stage2_table(config, shift)
    live = merged_live_tiles(bm)
    check_map(bm, live)
    heads = CONFIGS[config].num_heads[2]
    assert live.shape == (1, heads, 4, 8) and int((live >= 0).sum()) == heads * 4 * 8
    raster = bm[0, :, :16].reshape(heads, 16, 32, 8)
    assert ((raster > MERGED_DEAD).any(dim=(1, 3)).sum(dim=-1) == 16).all()


def test_dense_random_table_is_all_live():
    """A table with no block structure keeps every tile of every block:
    the kernel then runs the dense computation."""
    bm = torch.from_numpy(np.random.default_rng(31).normal(size=(1, 3, 256, 256))
                          .astype(np.float32))
    live = merged_live_tiles(bm)
    assert torch.equal(live, torch.arange(32, dtype=torch.int32).expand(1, 3, 4, 32))


@pytest.mark.parametrize("rows", [list(range(136, 144)) + list(range(152, 160)), [170]],
                         ids=["query-group", "one-row"])
def test_masked_rows_make_their_block_all_live(rows):
    """One query group (the 16 rows of warp 0 of patch 3: image rows 8-9,
    columns 8-15) or a single row masked against every key in every head:
    its block lists all 32 tiles, the others keep their 8."""
    bm = stage2_table("base", 4)
    bm[:, :, rows, :] = MERGED_DEAD
    live = merged_live_tiles(bm)
    check_map(bm, live)
    assert live.shape[-1] == 32
    counts = (live >= 0).sum(dim=-1)[0]
    assert (counts[:, 3] == 32).all() and (counts[:, :3] == 8).all()


def test_rows_near_minus_1e9_make_their_block_all_live():
    """A row whose live entries all sit just above -1e9 (-999999000), with
    a large score on a key its other entries mask: the dense softmax gives
    that key mass, so the row's block lists all 32 tiles and the softmax
    over the listed keys is the dense one; a row with one entry far above
    -1e9 keeps its block's 8."""
    bm = stage2_table("base", 0)
    live_keys = bm[0, 0, 0] > MERGED_DEAD
    bm[:, :, 0, live_keys] = -999999000.0
    own = torch.nonzero(bm[0, 0, 9] > MERGED_DEAD).flatten()  # row 9 lies in block 1
    bm[:, :, 9, own] = -999999000.0
    bm[:, :, 9, own[0]] = 0.0
    live = merged_live_tiles(bm)
    check_map(bm, live)
    counts = (live >= 0).sum(dim=-1)[0]
    assert (counts[:, 0] == 32).all() and (counts[:, 1:] == 8).all()
    x = bm[0, 0, 0].clone()
    x[~live_keys] = MERGED_DEAD + 2000.0  # dead keys whose scores outweigh the live ones' offset
    keys = (8 * live[0, 0, 0].long()[:, None] + torch.arange(8)).flatten()
    sparse = torch.zeros(256)
    sparse[keys] = key_order_softmax(x[keys])
    assert key_order_softmax(x)[~live_keys].sum() > 0.5
    assert torch.equal(sparse, key_order_softmax(x))


def key_order_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dimension in f32: the row max, exp(x - max),
    each row summed in key order (``cumsum``'s last value), divided."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.cumsum(dim=-1)[..., -1:]


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("config", ["base", "tiny", "small"])
def test_softmax_over_live_keys_is_the_dense_softmax(config, shift):
    """Scores (std 3) plus the table: the f32 softmax over each block's
    live keys only, scattered back to 256 keys with zeros, equals the dense
    softmax bitwise, whose probabilities on the dead keys are exactly 0."""
    bm = stage2_table(config, shift)
    heads = bm.shape[1]
    x = torch.from_numpy(np.random.default_rng(32 + shift).normal(
        scale=3.0, size=(heads, 256, 256)).astype(np.float32)) + bm[0]
    dense = key_order_softmax(x)
    live = merged_live_tiles(bm)[0].long()  # (heads, 4, T)
    rows = torch.from_numpy(block_rows())
    keys = (8 * live[..., None] + torch.arange(8)).flatten(-2)  # (heads, 4, 8T)
    sparse = torch.zeros_like(dense)
    kept = torch.zeros_like(dense, dtype=torch.bool)
    for h in range(heads):
        for p in range(4):
            xr = x[h][rows[p]][:, keys[h, p]]
            sparse[h, rows[p][:, None], keys[h, p][None]] = key_order_softmax(xr)
            kept[h, rows[p][:, None], keys[h, p][None]] = True
    assert torch.equal(sparse, dense)
    assert int(kept.sum()) == heads * 256 * 64 and not dense[~kept].any()
