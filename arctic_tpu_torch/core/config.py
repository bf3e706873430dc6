"""Render configuration of the port — the fields of arctic_tpu's
core/config.py RenderConfig that the default fused frame reads.

The frame is the JAX package's default configuration: fused shading, the
sun-frustum shadow cull, the f16 HDR round and the exact f32 PCF are always
on, so they are not options here. Pair buffers keep fixed capacities
(``pair_capacity``), so an overflow stays loud through check_stats.
"""

from __future__ import annotations

from dataclasses import dataclass

# Shadow-map tile (square), as the JAX package's default shadow_tile.
SHADOW_TILE = 64


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    shadow_size: int = 4000

    # Screen tile of the camera pass's binned rasterizer.
    tile_h: int = 64
    tile_w: int = 64

    # (tile, triangle) pair capacity per pass: pairs_per_tri * clip slots
    # + pair_reserve, rounded up to 1024.
    pairs_per_tri: int = 2
    pair_reserve: int = 65536

    # Point lights shaded per frame (None = the params' light count).
    static_point_lights: int | None = None

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    def pair_capacity(self, clip_slots: int) -> int:
        return _round_up(self.pairs_per_tri * clip_slots + self.pair_reserve, 1024)
