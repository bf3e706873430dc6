"""Render configuration of the port — the fields of arctic_tpu's
core/config.py RenderConfig that the ported frame paths read, the one rule
that turns a dict of the JAX package's fields into it
(:func:`config_from_dict`: the CLI's ``--config`` and
``utils/convert.render_config`` both use it), and the one check of the
tiles a frame path bins with (:func:`check_tiles`).

The frame is the JAX package's fused frame by default; ``fused_shade=False``
takes its deferred frame (a per-slot shade table gathered per pixel) and
``force_bruteforce`` its brute-force frame (the deferred frame over the
all-triangles-against-all-pixels raster oracle). The sun-frustum shadow
cull (fused frame only) and the f16 HDR round are on by default, as in the
JAX package. The PCF takes the exact f32 runs path unless
``pcf_row_cap`` asks for the u16-quantised window table with penumbra
classification (fused frame only). Pair buffers and the penumbra row
buffer keep fixed capacities (the pair caps from a formula, or tuned to a
camera path), so an overflow stays loud through check_stats.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from arctic_tpu_torch.utils.errors import RenderError

# The tile grid the JAX package's binning takes: a tile's column and row
# are packed into 9 and 13 bits (arctic_tpu/ops/binning.py:228).
MAX_TILE_COLUMNS = 512
MAX_TILE_ROWS = 8192


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    shadow_size: int = 4000

    # Tile of the shadow pass's binned rasterizer: shadow_tile is the
    # width, shadow_tile_h the height (None = square). Frames are tile-size
    # invariant: every tile gives the same pixels.
    shadow_tile: int = 64
    shadow_tile_h: int | None = None

    # Screen tile of the camera pass's binned rasterizer (frames are
    # tile-size invariant here too).
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

    # The brute-force raster oracle in both passes and the deferred shade:
    # only sane for small frames (no pair buffers, so it cannot overflow).
    force_bruteforce: bool = False

    # The fused frame (K3 shade rows, K4 G-buffer resolve, K6 / K9 taps).
    # False: the deferred frame, which rasterizes the camera pass and the
    # whole (uncull'd) shadow map with K1 and shades from a per-slot table
    # in plain torch. Ignored under force_bruteforce.
    fused_shade: bool = True

    # Opt-in IBL specular: color += F(n.wo, F0) * env(reflect(-wo, n)),
    # the environment read without the skybox's v flip (forward.hlsl:195-206).
    ibl_specular: bool = False

    # Opt-in spotlights: a light's radiance is scaled by clamp((cos_t -
    # outer_cos) * inv_range, 0, 1) about PointLights.spot_dir; point rows
    # (-2, 1) give exactly 1.0.
    spotlights: bool = False

    # Log a warning naming the pass, its pairs and its cap when a pair
    # buffer overflowed (a host read of the counts every frame).
    debug_overflow: bool = False

    # The grouped tile route (tile atlases of several material groups):
    # one row capacity per group plus the fallback's, each a multiple of 32
    # (pipeline.autotune_tex_group_caps sizes them). 128-pixel rows gather
    # from their group's table; rows of more than two groups, or past a
    # group's cap, take the full-table fallback. None = the plain gather.
    # Overflow is loud: stats carry tex_fb_rows vs tex_fb_cap.
    tex_group_caps: tuple | None = None

    # Round the HDR target to f16 before post-processing (the reference's
    # R16G16B16A16_FLOAT render target, renderer.cpp:128-144).
    hdr_half_round: bool = True

    # Sun-frustum shadow culling (fused frame only, ops/cull.py): the shadow
    # pass bins and rasters only the shadow tiles that the camera frustum's
    # intersection with the scene bounds can sample (+ the PCF margin), and
    # the quantised window table builds only their start_y band. The frame
    # is bit-identical either way; off, every tile is rastered.
    sun_frustum_cull: bool = True

    # Ray-traced mode (models/raytrace.py): an any-hit ray toward each point
    # light, bounded at its distance, shadows it (off: the lights are
    # shadowed by the sun's ray alone, as in the raster frame).
    rt_light_shadows: bool = False

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def shadow_th(self) -> int:
        """The shadow tile's height."""
        return self.shadow_tile_h or self.shadow_tile

    @property
    def shadow_tiles_x(self) -> int:
        return -(-self.shadow_size // self.shadow_tile)

    @property
    def shadow_tiles_y(self) -> int:
        return -(-self.shadow_size // self.shadow_th)

    def pair_capacity(self, clip_slots: int, kind: str = "cam") -> int:
        """Pair buffer entries of the camera (``kind="cam"``) or the shadow
        (``"shadow"``) pass."""
        override = self.pair_cap_cam if kind == "cam" else self.pair_cap_shadow
        if override is not None:
            return _round_up(override, 1024)
        return _round_up(self.pairs_per_tri * clip_slots + self.pair_reserve, 1024)


# Fields of the JAX package's RenderConfig that change no pixel: accepted
# and ignored (scheduling knobs of its Pallas kernels, and lut_y_skip,
# which only picks table rows no window reads).
IGNORED_FIELDS = frozenset({"raster_chunk", "select_chunk", "tiles_per_step", "lut_y_skip"})

def config_from_dict(fields: dict) -> RenderConfig:
    """A RenderConfig from the JAX package's RenderConfig fields by name.
    Fields in IGNORED_FIELDS are dropped; a name neither package has raises
    RenderError."""
    kept = {f.name for f in dataclasses.fields(RenderConfig)}
    out = {}
    for name, value in fields.items():
        if name == "tex_group_caps" and value is not None:
            out[name] = tuple(int(c) for c in value)  # a JSON list, or the JAX tuple
        elif name in kept:
            out[name] = value
        elif name not in IGNORED_FIELDS:
            raise RenderError(f"RenderConfig has no field {name!r}")
    return RenderConfig(**out)


def check_tiles(config: RenderConfig, shadow: bool = True, camera: bool = True,
                world: int | None = None) -> None:
    """Raise RenderError, naming the rule, on a tile that the JAX package
    refuses on the path ``config`` takes: the shadow pass's tile
    (``shadow``) and the camera pass's (``camera``), of the single-device
    frame or of the sharded frame of ``world`` ranks. The JAX package's
    asserts, by path:

    - the brute-force frame bins nothing: any tile;
    - every binned pass (raster_tiles.py:925): tile_h * tile_w % 128 == 0;
    - the fused frame's camera pass, and every slab of the sharded frame
      (fused unless brute force), resolves its G-buffer per 128-pixel row
      (raster_tiles.py:814): 128 % tile_w == 0;
    - every binned pass (binning.py:228): at most MAX_TILE_COLUMNS tiles
      across and MAX_TILE_ROWS tile rows in the window it bins (a slab's
      rows on the sharded frame)."""
    if config.force_bruteforce:
        return
    fused = config.fused_shade or world is not None

    def rows(n: int) -> int:  # the tile rows one window bins
        return n if world is None else -(-n // world)

    passes = []
    if shadow:
        passes.append(("shadow", "shadow_tile_h x shadow_tile", config.shadow_th,
                       config.shadow_tile, config.shadow_tiles_x, rows(config.shadow_tiles_y),
                       False))
    if camera:
        passes.append(("camera", "tile_h x tile_w", config.tile_h, config.tile_w,
                       config.tiles_x, rows(config.tiles_y), fused))
    for name, fields, th, tw, across, down, per_row in passes:
        tile = f"RenderConfig {name} tile ({fields}) {th} x {tw}"
        if th < 1 or tw < 1 or th * tw % 128:
            raise RenderError(f"{tile}: a binned pass's tile must fill whole 128-pixel rows "
                              f"(height * width % 128 == 0)")
        if per_row and 128 % tw:
            raise RenderError(f"{tile}: the fused frame's camera tile width must divide a "
                              f"128-pixel row (128 % tile_w == 0)")
        if across > MAX_TILE_COLUMNS or down > MAX_TILE_ROWS:
            raise RenderError(f"{tile}: {across} tiles across and {down} tile rows to bin; "
                              f"binning takes at most {MAX_TILE_COLUMNS} across and "
                              f"{MAX_TILE_ROWS} rows")
