"""Tile binning: triangle slots -> per-tile work lists sorted by (tile,
slot) — torch port of arctic_tpu/ops/binning.py.

1. per-slot tile bbox from the clamped screen bbox (optionally intersected
   with the sun-cull rect);
2. expansion to (tile, slot) pairs in slot order: pair ``pos`` belongs to
   the slot whose inclusive pair-count cumsum first exceeds it (one
   ``searchsorted``; the JAX package's two-level decode computes the same);
3. one sort of the packed int64 key ``(tile << bits) | slot``: within a tile
   the list is slot-ascending, so depth ties keep draw order;
4. ``searchsorted`` of the sorted tiles gives each tile's [start, end).

Shapes are static: the pair buffer has ``pair_capacity`` entries and a
sentinel tile id ``num_tiles`` floats unused and overflowing pairs to the
end. When pairs overflow, the first ``pair_capacity`` pairs in slot order
survive, exactly as in the JAX package. All index math is int64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from arctic_tpu_torch.ops.raster import TriSetup


class BinnedPairs(NamedTuple):
    sorted_slot: torch.Tensor  # (pair_cap,) i32 slot id per pair, grouped by tile
    tile_start: torch.Tensor  # (num_tiles + 1,) i32 segment offsets
    total_pairs: torch.Tensor  # () i32 pairs generated (> pair_cap = overflow)


def _tile_footprints(setup: TriSetup, tiles_x, tiles_y, tile_w, tile_h, tile_row0=0,
                     rect=None):
    """Per-slot tile bbox + pair counts: (counts, tx0, ty0, w), int64, in
    the window of tile rows [tile_row0, tile_row0 + tiles_y) (a slab of a
    sharded frame; ty0 is window-local). A slot with no row in the window
    is dropped.

    ``rect`` (rx0, ry0, rx1, ry1) — inclusive GLOBAL tile coords —
    intersects every slot's tile bbox; an empty rect (rx1 < rx0) culls
    everything."""
    x0, y0, x1, y1 = setup.bbox
    valid = setup.valid

    tx0 = torch.clamp((x0 / tile_w).to(torch.int32), 0, tiles_x - 1).long()
    # bbox is exclusive at x1/y1: ending exactly on a tile boundary does not
    # cover the next tile's pixel centres.
    tx1 = torch.clamp(((x1 - 1e-3) / tile_w).to(torch.int32), 0, tiles_x - 1).long()
    ty0 = torch.clamp((y0 / tile_h).to(torch.int32).long() - tile_row0, min=0)
    ty1 = torch.clamp(((y1 - 1e-3) / tile_h).to(torch.int32).long() - tile_row0,
                      max=tiles_y - 1)

    if rect is not None:
        rx0, ry0, rx1, ry1 = rect
        tx0 = torch.maximum(tx0, rx0)
        tx1 = torch.minimum(tx1, rx1)
        ty0 = torch.maximum(ty0, ry0 - tile_row0)
        ty1 = torch.minimum(ty1, ry1 - tile_row0)
        valid = valid & (tx1 >= tx0)
        tx0 = torch.clamp(tx0, max=tiles_x - 1)

    valid = valid & (ty1 >= ty0)
    ty0 = torch.clamp(ty0, 0, tiles_y - 1)
    ty1 = torch.clamp(ty1, 0, tiles_y - 1)

    w = torch.where(valid, tx1 - tx0 + 1, 1)
    h = torch.where(valid, ty1 - ty0 + 1, 1)
    counts = torch.where(valid, w * h, 0)
    return counts, tx0, ty0, w


def count_pairs(setup: TriSetup, tiles_x: int, tiles_y: int, tile_w: int, tile_h: int,
                tile_row0: int = 0, rect=None) -> torch.Tensor:
    """Total (tile, slot) pairs bin_triangles would generate (0-dim i32),
    without the sort: pipeline.autotune_pair_caps sizes the pair buffers
    with it."""
    counts = _tile_footprints(setup, tiles_x, tiles_y, tile_w, tile_h, tile_row0, rect)[0]
    return counts.sum().to(torch.int32)


def bin_triangles(
    setup: TriSetup, tiles_x: int, tiles_y: int, tile_w: int, tile_h: int,
    pair_capacity: int, tile_row0: int = 0, rect=None,
) -> BinnedPairs:
    """Bin the valid slots into the (tiles_y, tiles_x) tile window whose
    first row is global tile row ``tile_row0`` (0: the whole frame); tile
    ids in the output are window-local."""
    num_tiles = tiles_x * tiles_y
    dev = setup.valid.device
    counts, tx0, ty0, w = _tile_footprints(setup, tiles_x, tiles_y, tile_w, tile_h, tile_row0,
                                           rect)
    cum = torch.cumsum(counts, 0)  # inclusive
    total = cum[-1]
    pos = torch.arange(pair_capacity, dtype=torch.int64, device=dev)
    slot = torch.searchsorted(cum, pos, right=True)  # == capacity past total
    ok = slot < setup.capacity
    slot_c = torch.clamp(slot, max=setup.capacity - 1)
    k = pos - (cum[slot_c] - counts[slot_c])  # pair index within its slot
    mw = w[slot_c]
    tile = (ty0[slot_c] + k // mw) * tiles_x + (tx0[slot_c] + k % mw)
    tile = torch.where(ok, tile, num_tiles)

    bits = max(int(setup.capacity - 1).bit_length(), 1)
    key, _ = torch.sort((tile << bits) | slot_c)
    sorted_tile = key >> bits
    sorted_slot = (key & ((1 << bits) - 1)).to(torch.int32)
    tile_start = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, dtype=torch.int64, device=dev)
    ).to(torch.int32)
    return BinnedPairs(sorted_slot, tile_start, total.to(torch.int32))


def raster_row_table(setup: TriSetup) -> torch.Tensor:
    """(P, 16) f32 per-slot raster rows for the depth-only pass:
    [A0 B0 C0  A1 B1 C1  A2 B2 C2  Az Bz Cz  slot 0 0 0] — the JAX package's
    raster_row_comps, row-major (its 8-slots-per-lane-row packing is a TPU
    layout that the raster kernel's row load replaces)."""
    p = setup.capacity
    assert p < (1 << 24), "slot ids must be exactly representable in f32"
    comps = [c for e in setup.edges for c in e] + list(setup.zplane)
    comps.append(torch.arange(p, dtype=torch.float32, device=setup.valid.device))
    z = torch.zeros_like(comps[0])
    return torch.stack(comps + [z, z, z], dim=1)
