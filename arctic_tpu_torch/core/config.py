"""Render configuration of the port — the fields of arctic_tpu's
core/config.py RenderConfig that the ported frame paths read.

The frame is the JAX package's fused configuration: fused shading, the
sun-frustum shadow cull and the f16 HDR round are always on, so they are
not options here. The PCF takes the exact f32 runs path unless
``pcf_row_cap`` asks for the u16-quantised window table with penumbra
classification. Pair buffers and the penumbra row buffer keep fixed
capacities (the pair caps from a formula, or tuned to a camera path), so an
overflow stays loud through check_stats.
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

    # Per-pass pair capacities that replace the formula (None = formula):
    # binning's cost scales with the capacity, not with the pairs, and
    # pipeline.autotune_pair_caps sizes them to a scene and a camera path.
    pair_cap_cam: int | None = None
    pair_cap_shadow: int | None = None

    # Point lights shaded per frame (None = the params' light count).
    static_point_lights: int | None = None

    # PCF penumbra classification (the quantised-table path): 128-px rows
    # that the min/max shadow pyramid proves fully lit or fully shadowed
    # emit exact 0/1; only penumbra rows, compacted to this many, run the
    # per-pixel 25-tap kernel. None = off (the exact f32 runs path).
    # Overflow is loud: stats carry pcf_rows vs pcf_row_cap.
    pcf_row_cap: int | None = None

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def pair_capacity(self, clip_slots: int, kind: str = "cam") -> int:
        """Pair buffer entries of the camera (``kind="cam"``) or the shadow
        (``"shadow"``) pass."""
        override = self.pair_cap_cam if kind == "cam" else self.pair_cap_shadow
        if override is not None:
            return _round_up(override, 1024)
        return _round_up(self.pairs_per_tri * clip_slots + self.pair_reserve, 1024)
