"""Render configuration of the port — the fields of arctic_tpu's
core/config.py RenderConfig that the ported frame paths read, and the one
rule that turns a dict of the JAX package's fields into it
(:func:`config_from_dict`: the CLI's ``--config`` and
``utils/convert.render_config`` both use it).

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

# Fields of the JAX package's RenderConfig whose other paths are not
# ported: (the JAX default, which the port's frame is, and where it stands).
UNPORTED_FIELDS = {
    "shadow_tile": (SHADOW_TILE, "the port's shadow tile is 64 x 64, the only one the "
                                 "JAX package's lut_rows path takes"),
    "shadow_tile_h": (None, "the port's shadow tile is 64 x 64, the only one the "
                            "JAX package's lut_rows path takes"),
}


def config_from_dict(fields: dict) -> RenderConfig:
    """A RenderConfig from the JAX package's RenderConfig fields by name.
    Fields in IGNORED_FIELDS are dropped; a field of UNPORTED_FIELDS at its
    JAX default is dropped, at any other value it raises RenderError
    naming where its path stands, as does a name neither package has."""
    kept = {f.name for f in dataclasses.fields(RenderConfig)}
    out = {}
    for name, value in fields.items():
        if name == "tex_group_caps" and value is not None:
            out[name] = tuple(int(c) for c in value)  # a JSON list, or the JAX tuple
        elif name in kept:
            out[name] = value
        elif name in UNPORTED_FIELDS:
            default, where = UNPORTED_FIELDS[name]
            if value != default:
                raise RenderError(f"RenderConfig.{name}={value!r} takes a path the port does "
                                  f"not have ({where})")
        elif name not in IGNORED_FIELDS:
            raise RenderError(f"RenderConfig has no field {name!r}")
    return RenderConfig(**out)
