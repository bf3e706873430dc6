"""The frame — torch port of arctic_tpu/models/pipeline.py
(render_frame_stats, build_sun_cache, autotune_pair_caps, the grouped tile
route's measurements and autotune; core/config.py).

The fused frame (the default):

shadow pass (sun-cull rect, binning, K1 depth-only raster) -> shade-row
table (K3; for a Geometry without slot_static_rows the full stack in plain
torch and K10's transpose) -> camera binning + K1 raster -> G-buffer
resolve (K4) -> PCF
sun shadow -> texture + sky tap (K6 on the merged quad table; K9 on the
u16 tile atlas of reference-scale texture sets, per material group with
``tex_group_caps``; plain torch taps of the unmerged combined quads or the
per-slot atlas, the sky apart) -> Cook-Torrance PBR with
point lights and ambient -> skybox composite -> f16 HDR round
(``hdr_half_round``), tonemap, gamma, u8. The shadow pass rasters only the
tiles of the sun-cull rect (``sun_frustum_cull``). Each pass can raster a
slab of tile rows (parallel/sharding.py).

The PCF takes the exact f32 runs path (K16) by default. With
``RenderConfig.pcf_row_cap`` it takes the quantised path: K7 builds the u16
window table from K1's row-major depth buffer in place (the JAX package's
lut_rows raster), a min/max pyramid classifies 128-pixel rows of the
tile-major pixel stream, and K8 evaluates the compacted penumbra rows. A
SunCache (build_sun_cache) replaces the shadow pass, table and pyramid
while the sun and the geometry stay put.

The deferred frame (``fused_shade=False``): the whole shadow map and the
camera pass through binning + K1, a per-slot shade table (build_shade_table)
gathered per pixel by slot id, the material tap (material_taps: the
combined quad rows K6 reads, the unmerged combined quads or the per-slot
atlas), the exact f32 runs PCF (K16) at the pixel's light-space
position, the same lights (K15) and composite; the rest in plain torch.
The brute-force frame (``force_bruteforce``) is the deferred frame over the
raster oracle (ops/raster.rasterize_bruteforce) in both passes: no kernel.
The opt-ins (``spotlights``, ``ibl_specular``) act in both frames.

The frame runs eagerly on the device of the scene buffers, but for the
cached frame's front end, which make_cached_renderer_stats replays on the
card as one CUDA graph (CachedFront). Per-frame constants (the camera and
sun matrices, the light count, post-process settings) are evaluated on the
host from the params' host tensors, as the reference's CPU side does, and
enter device math as f32 values (CachedFront's matrices as device f32). Pair
buffers have fixed capacities (RenderConfig.pair_capacity, from its formula
or from autotune_pair_caps) so overflow stays loud through check_stats.
Intermediates are row-major (C, H_pad, W_pad) planes; the values are the
JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import NamedTuple

import numpy as np
import torch

from arctic_tpu_torch.core.config import RenderConfig, check_tiles
from arctic_tpu_torch.core.scene import (
    Geometry,
    SceneBuffers,
    SceneParams,
    Settings,
    SunCache,
)
from arctic_tpu_torch.ops import binning, cull, raster, raster_tiles, shadow, sky, tonemap
from arctic_tpu_torch.ops.pbr import dot_cf, fresnel_schlick, shade_lights, shade_lights_plain
from arctic_tpu_torch.ops.sampling import (
    quad_index,
    sample_atlas_multi,
    sample_quads_flat,
    tap_resolve,
    tile_index,
    tile_row_groups,
    tile_tap_resolve,
    tile_tap_resolve_grouped,
)
from arctic_tpu_torch.utils import kernels
from arctic_tpu_torch.utils.errors import RenderError, check_finite, debug_checks_enabled
from arctic_tpu_torch.utils.profiling import named_scope

log = logging.getLogger(__name__)


def use_full_f32() -> None:
    """Keep float32 matmuls and convolutions in full precision (no TF32):
    the cull's 4x4 algebra once collapsed at reduced precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def world_corners(geom: Geometry):
    """Tri-major world corner components ``wc[c] = (x, y, z)`` of (T,)."""
    trs, cp = geom.tri_trs, geom.tri_corner_pos
    out = []
    for c in range(3):
        px, py, pz = cp[3 * c], cp[3 * c + 1], cp[3 * c + 2]
        out.append(
            tuple(
                trs[4 * i] * px + trs[4 * i + 1] * py + trs[4 * i + 2] * pz
                + trs[4 * i + 3]
                for i in range(3)
            )
        )
    return tuple(out)


def world_triangles(geom: Geometry) -> torch.Tensor:
    """(num_tris, 3, 3) world-space corners of the valid triangles, from
    world_corners (the ray-traced mode's BVH input)."""
    wc = world_corners(geom)
    n = geom.num_tris
    return torch.stack([torch.stack([x[:n] for x in corner], dim=1) for corner in wc], dim=1)


def corners_clip(wc, proj_view: torch.Tensor):
    """World corner components -> clip components ``out[c] = (x, y, z, w)``;
    ``proj_view`` is a host 4x4, whose entries enter as f32 scalars, or a
    4x4 on the corners' device (CachedFront's input), whose entries enter
    as 0-dim tensors: the same f32 products and sums, in the same order."""
    pv = proj_view.tolist() if proj_view.device.type == "cpu" else proj_view
    out = []
    for c in range(3):
        x, y, z = wc[c]
        out.append(
            tuple(pv[i][0] * x + pv[i][1] * y + pv[i][2] * z + pv[i][3] for i in range(4))
        )
    return tuple(out)


def scene_aabb(wc, tri_valid):
    """World AABB ((3,) lo, (3,) hi) of the valid triangles' corners."""
    los, his = [], []
    for i in range(3):
        planes = [wc[c][i] for c in range(3)]
        los.append(torch.min(torch.stack([torch.where(tri_valid, p, torch.inf).min() for p in planes])))
        his.append(torch.max(torch.stack([torch.where(tri_valid, p, -torch.inf).max() for p in planes])))
    return torch.stack(los), torch.stack(his)


def sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config: RenderConfig):
    """Conservative shadow-tile rect for shadow_pass and the (2,) window
    start_y band of the quantised table (ops/cull.py; device tensors, no
    host sync)."""
    lo, hi = scene_aabb(wc, tri_valid)
    return cull.shadow_cull_rect(
        cam_pv.to(lo.device), sun_pv.to(lo.device), lo, hi, config.shadow_size,
        config.shadow_th, config.shadow_tile,
    )


def camera_setup(wc, tri_valid, cam_pv, config: RenderConfig) -> raster.TriSetup:
    """The camera pass's triangle setup (forward_pass.cpp: back faces culled)
    from the world corners: near clip, projection, raster planes."""
    clipped = raster.near_clip_corners(corners_clip(wc, cam_pv), tri_valid)
    return raster.setup_screen_triangles(clipped, config.width, config.height, cull="back")


def fused(config: RenderConfig) -> bool:
    """Whether ``config`` renders the fused frame (JAX pipeline.py:1002)."""
    return config.fused_shade and not config.force_bruteforce


def rasterize(setup: raster.TriSetup, height: int, width: int, config: RenderConfig,
              kind: str = "cam", rect=None):
    """One pass's visibility (JAX pipeline.py:118-141): (zbuf (H, W), ibuf
    (H, W) or None for the depth-only shadow pass, pairs (0-dim device
    tensor), pair cap). The brute-force oracle has no pair buffer: 0 pairs
    of a cap of 1, and no kernel."""
    if config.force_bruteforce:
        zbuf, ibuf = raster.rasterize_bruteforce(setup, height, width)
        pairs = torch.zeros((), dtype=torch.int32, device=setup.valid.device)
        return zbuf, None if kind == "shadow" else ibuf, pairs, 1
    shadow = kind == "shadow"
    zbuf, ibuf, pairs = raster_tiles.rasterize_tiled(
        setup, height, width, config, tile_h=config.shadow_th if shadow else None,
        tile_w=config.shadow_tile if shadow else None, depth_only=shadow, rect=rect,
    )
    return zbuf, ibuf, pairs, config.pair_capacity(setup.capacity, kind)


def shadow_pass(geom: Geometry, sun_clip, config: RenderConfig, cull_rect=None):
    """Depth-only pass from the sun's view (shadow_map_pass.cpp:113-169),
    front faces culled, over the cull rect's tiles (None: all of them);
    returns (shadow map (S, S), pairs, pair cap). On the binned path the map
    is a view of K1's row-major (tile-padded) depth buffer, shadow_th x
    shadow_tile tiles, with its row pitch shadow_tiles_x * shadow_tile: the
    quantised path's table build reads it in place at any tile (the JAX
    package's lut_rows raster, raster_tiles.py:1007, at its 64-pixel tile;
    the untiled map at the others)."""
    tri_valid = torch.arange(geom.capacity, device=geom.tri_trs.device) < geom.num_tris
    clipped = raster.near_clip_corners(sun_clip, tri_valid)
    s = config.shadow_size
    setup = raster.setup_screen_triangles(clipped, s, s, cull="front")
    zbuf, _, pairs, cap = rasterize(setup, s, s, config, "shadow", cull_rect)
    return zbuf, pairs, cap


def shade_row_planes(setup: raster.TriSetup, geom: Geometry, wc, lsp) -> torch.Tensor:
    """The (48, N) per-frame planes K3 consumes (lane map: ops/raster_tiles
    K3). Clip slots are [primary tris; secondary tris], so tri-major planes
    dup into slot order by concatenation."""
    p = setup.capacity
    if p != 2 * geom.capacity:
        raise RenderError("clip slots must be [primary; secondary] tri-major")
    n_total = geom.slot_static_rows.shape[1]
    if n_total != -(-(p + 1) // 512) * 512:
        raise RenderError(f"slot_static_rows has {n_total} columns for {p} slots")
    rows = []
    for c in range(3):
        rows += list(setup.edges[c])  # [0:9) raw A,B,C per corner
    rows += list(setup.zplane)  # [9:12)
    rows += [setup.inv_area2 / setup.w[c] for c in range(3)]  # [12:15)
    for c in range(3):
        rows += [setup.cb[c][k] for k in range(3)]  # [15:24)
    for k in range(3):
        rows += [torch.cat([x, x]) for x in wc[k]]  # [24:33)
    for k in range(3):
        rows += [torch.cat([x, x]) for x in lsp[k]]  # [33:42)
    pf = torch.zeros((48, n_total), dtype=torch.float32, device=rows[0].device)
    pf[:42, :p] = torch.stack(rows)
    return pf


def shade_row_stack(setup: raster.TriSetup, geom: Geometry, wc, lsp) -> torch.Tensor:
    """The (128, N) component-major shade-row stack of the full-stack build
    (JAX pipeline.py:380-435), N = round_up(p + 1, 512), for a Geometry
    without slot_static_rows: the lanes of K3's table (ops/raster_tiles K3),
    computed in plain torch from the tri-major planes with K3's expressions
    in K3's order, so the two tables are equal bit for bit. Slot s of the
    [primary; secondary] clip slots is triangle s % T: tri-major planes are
    broadcast over a (2, T) view of the slots instead of dup'd."""
    p, t = setup.capacity, geom.capacity
    if p != 2 * t:
        raise RenderError("clip slots must be [primary; secondary] tri-major")
    n_total = -(-(p + 1) // 512) * 512
    dev = geom.tri_trs.device
    stack = torch.zeros((128, n_total), dtype=torch.float32, device=dev)
    live = stack[:, :p]

    def slots(rows):  # (k, p) view of the live slots as (k, 2, T)
        return rows.view(rows.shape[0], 2, t)

    edges = torch.stack([c for e in setup.edges for c in e])  # (9, p) A,B,C per corner
    scale = torch.stack([setup.inv_area2 / setup.w[c] for c in range(3)])
    live[0:9] = edges * scale.repeat_interleave(3, dim=0)  # ebw [0:9)
    sid = torch.arange(n_total, device=dev, dtype=torch.float32)
    stack[9] = torch.where(sid < p, sid, -2.0)
    sa = geom.tri_static_attrs
    att = [torch.stack([*wc[k], *sa[11 * k : 11 * k + 11], *lsp[k]])[:, None] for k in range(3)]
    for c in range(3):  # corner-c blends [16 + 24c, 33 + 24c)
        cb = [setup.cb[c][k].reshape(1, 2, t) for k in range(3)]
        lane = 16 + 24 * c
        slots(live[lane : lane + 17])[:] = cb[0] * att[0] + cb[1] * att[1] + cb[2] * att[2]
    slots(live[88:111])[:] = geom.tri_matrow[:, None]  # material row
    live[112:121] = edges  # raw A,B,C x 3
    live[121:124] = torch.stack(list(setup.zplane))
    stack[124] = torch.where(sid < p, sid, 0.0)  # raster slot id
    return stack


def build_shade_rows(setup: raster.TriSetup, geom: Geometry, wc, lsp) -> torch.Tensor:
    """(N, 128) shade rows per clip slot: K3 blends, scales and writes the
    table from the per-frame planes and the build-time static rows; without
    slot_static_rows the full stack is built in plain torch and K10
    transposes it (the JAX package's build for such a Geometry)."""
    if geom.slot_static_rows is None:
        return raster_tiles.transpose_pack_rows(shade_row_stack(setup, geom, wc, lsp))
    pf = shade_row_planes(setup, geom, wc, lsp)
    return raster_tiles.pack_shade_rows(pf, geom.slot_static_rows, setup.capacity)


def pcf_shadow(
    gbuf: torch.Tensor, covered: torch.Tensor, shadow_map: torch.Tensor,
    config: RenderConfig, lut=None, pyramid=None, lut_y_range=None,
):
    """Sun shadow term of every pixel of the (H_pad, W_pad) frame and the
    penumbra row count (0-dim device tensor; 0 on the runs path).

    On the quantised path the rows that are classified and compacted are
    the JAX package's: rows of 128 pixels of the TILE-MAJOR pixel stream
    (row r = pixels 128r .. 128r + 127 of tile r // 32 for 64x64 tiles, two
    64-pixel screen lines), so the light-space planes go through that view
    and the result comes back through its inverse. Only covered pixels are
    consumed (care). Without pcf_row_cap the runs path reads the map alone
    (a SunCache's table and pyramid go unused)."""
    x, y, z = gbuf[14], gbuf[15], gbuf[16]
    if config.pcf_row_cap is None:
        return shadow.pcf_shadow_proj(shadow_map, x, y, z, with_rows=True)
    hp, wp = covered.shape
    rows, pcf_rows = shadow.pcf_shadow_proj(
        shadow_map, *(tile_rows(config, p) for p in (x, y, z)), care=tile_rows(config, covered),
        row_cap=config.pcf_row_cap, with_rows=True, lut=lut, pyramid=pyramid,
        lut_y_range=lut_y_range,
    )
    return untile_rows(config, rows, hp, wp), pcf_rows


def shade_gbuffer(
    buffers: SceneBuffers, params: SceneParams, gbuf: torch.Tensor,
    covered: torch.Tensor, shadow_f: torch.Tensor, config: RenderConfig, y0: int = 0,
):
    """forward.hlsl ps_main over the (64, H_pad, W_pad) G-buffer, channel
    first (lane map: [0:3 wp, 3:6 n, 6:9 t, 9:12 b, 12:14 uv, 14:17 light
    space xyz, 24:36 atlas regions, 36:40 mr const, 40:43 nm const, 43:47
    combined-atlas region or tile block (base, ntx, h, w)]). ``shadow_f``:
    pcf_shadow's sun shadow factor of this G-buffer; ``y0``: the frame's
    pixel row of the planes' first row (a slab of a sharded frame). The
    material tap takes the atlas's route: the
    u16 tile atlas (K9, grouped with tex_group_caps), the merged quad rows
    (K6), the unmerged combined quads or the per-slot atlas (plain torch,
    the sky sampled apart). Returns (HDR (3, H_pad, W_pad), grouped-tile
    fallback rows)."""
    atlas, env = buffers.atlas, buffers.environment
    dev = gbuf.device
    hp, wp_ = covered.shape
    wp, n_v, t_v, b_v = gbuf[0:3], gbuf[3:6], gbuf[6:9], gbuf[9:12]
    # Gather hygiene: uncovered pixels point at constant rows.
    u_uv = torch.where(covered, gbuf[12], 0.0)
    v_uv = torch.where(covered, gbuf[13], 0.0)

    def reg_lane(lane, fallback):
        return torch.where(covered, gbuf[lane], fallback)

    px = (torch.arange(wp_, device=dev, dtype=torch.float32) + 0.5).expand(hp, wp_)
    py = ((torch.arange(hp, device=dev) + y0).to(torch.float32) + 0.5)[:, None].expand(hp, wp_)
    dx, dy, dz = sky.camera_ray_dirs_cf(params.camera, px, py, config.width, config.height)
    dx = torch.where(covered, 1.0, dx)
    dy = torch.where(covered, 0.0, dy)
    dz = torch.where(covered, 0.0, dz)

    tex_fb_rows = torch.zeros((), dtype=torch.int32, device=dev)
    background = None
    nm = mr = None  # None: the material row's constants
    if atlas.tiles is not None or atlas.combined_env_rows is not None:
        u_sky, v_sky = sky.env_uv_cf(dx, dy, dz)
        eq, efx, efy = quad_index(env.block_grid, *env.region, u_sky, v_sky)
    if atlas.tiles is not None:
        # Reference-scale textures: ONE tap of the u16 tile atlas (K9) serves
        # a covered pixel's 8 material channels and an uncovered one's env
        # quad. Normal and metal-roughness always come from the textures.
        trow, ty, tx, tfx, tfy = tile_index(
            reg_lane(43, 0.0), reg_lane(44, 1.0), reg_lane(45, 1.0),
            reg_lane(46, 1.0), u_uv, v_uv,
        )
        if grouped(buffers, config):
            out16, tex_fb_rows = _grouped_tile_tap(
                atlas, config, covered, trow, eq, (ty, tx, eq % 8, tfx, tfy, efx, efy)
            )
        else:
            idx = torch.where(covered, trow, atlas.tiles_ntex + eq // 8)
            tap_args = [a.reshape(-1) for a in (idx, ty, tx, eq % 8, tfx, tfy, efx, efy)]
            out16 = tile_tap_resolve(atlas.tiles, *tap_args).reshape(16, hp, wp_)
        base_color, nm, mr = out16[0:3], out16[3:6], (out16[6], out16[7])
        background = out16[8:11]
    elif atlas.combined_env_rows is not None:
        # ONE tap (K6) serves texture AND sky: a covered pixel reads its
        # material texels, an uncovered one its environment quad, from one
        # table.
        tq, tfx, tfy = quad_index(
            atlas.combined_block_grid, reg_lane(43, 0.0), reg_lane(44, 0.0),
            reg_lane(45, 1.0), reg_lane(46, 1.0), u_uv, v_uv,
        )
        c4 = atlas.quad_width
        per = 128 // c4
        merged = atlas.combined_env_rows
        ntex = merged.shape[0] - env.num_rows
        idx = torch.where(covered, tq // per, ntex + eq // 8)
        tap_args = [a.reshape(-1) for a in (idx, tq % per, eq % 8, tfx, tfy, efx, efy)]
        out16 = tap_resolve(merged, *tap_args, c4=c4).reshape(16, hp, wp_)
        background = out16[c4 // 4 : c4 // 4 + 3]
        base_color, nm, mr = _combined_slots(atlas, out16)
    else:
        # The unmerged combined quads (texels of another type than the env
        # rows) or the per-slot atlas: plain torch taps, the sky apart.
        def region(slot):  # slot None: the combined region
            first = 43 if slot is None else 24 + 4 * slot
            return [reg_lane(first + i, float(i > 1)) for i in range(4)]

        base_color, nm, mr = material_taps(atlas, region, u_uv, v_uv)
    if background is None:
        background = torch.stack(sky.sample_environment_cf(
            env_rows_bf16(buffers), env.block_grid, env.region, dx, dy, dz
        ))
    if nm is None:
        nm = gbuf[40:43]  # nm const
    if mr is None:
        roughness, metalness = gbuf[37:38], gbuf[38:39]  # mr const green, blue
    else:
        roughness, metalness = mr[0][None], mr[1][None]

    # get_normal (forward.hlsl:104-112): green flip, [0,1]->[-1,1], TBN.
    nm = torch.cat([nm[0:1], 1.0 - nm[1:2], nm[2:3]])
    nm = nm * 2.0 - 1.0
    n = t_v * nm[0:1] + b_v * nm[1:2] + n_v * nm[2:3]
    n = n / torch.sqrt(dot_cf(n, n))
    lit = (1.0 - shadow_f)[None]

    hdr = _light_and_composite(
        buffers, params, config, covered, background, wp, n, lit, base_color, metalness,
        roughness,
    )
    return hdr, tex_fb_rows


def _combined_slots(atlas, planes):
    """(base colour, normal or None, (roughness, metalness) or None) from
    the channel planes of a combined-slot tap: slot combined_slots[i] at
    planes [4i, 4i + 4); None where the slot is not combined (constant)."""
    base = {s: 4 * i for i, s in enumerate(atlas.combined_slots)}
    nm = planes[base[1] : base[1] + 3] if 1 in base else None
    mr = (planes[base[2] + 1], planes[base[2] + 2]) if 2 in base else None
    return planes[base[0] : base[0] + 3], nm, mr


def grouped(buffers: SceneBuffers, config: RenderConfig) -> bool:
    """Whether the frame takes the grouped tile route (JAX pipeline.py:714)."""
    groups = buffers.atlas.tile_groups
    return (buffers.atlas.tiles is not None and groups is not None and len(groups) > 1
            and config.tex_group_caps is not None and fused(config))


def tile_rows(config: RenderConfig, plane: torch.Tensor) -> torch.Tensor:
    """(..., H_pad, W_pad) -> (..., R, 128): the 128-pixel rows of the
    tile-major pixel stream (row r = pixels 128r .. 128r + 127 of tile r //
    (th * tw / 128)), the rows the JAX package's fused frame groups."""
    th, tw = config.tile_h, config.tile_w
    lead = plane.shape[:-2]
    ty, tx = plane.shape[-2] // th, plane.shape[-1] // tw
    t = plane.reshape(*lead, ty, th, tx, tw).movedim(-2, -3)
    return t.reshape(*lead, -1, 128)


def untile_rows(config: RenderConfig, rows: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Inverse of tile_rows: (..., R, 128) -> (..., H_pad, W_pad)."""
    th, tw = config.tile_h, config.tile_w
    lead = rows.shape[:-2]
    t = rows.reshape(*lead, hp // th, wp // tw, th, tw).movedim(-3, -2)
    return t.reshape(*lead, hp, wp)


def _grouped_tile_tap(atlas, config, covered, trow, eq, aux):
    """The grouped tile route over the frame's tile-major 128-pixel rows:
    (16, H_pad, W_pad) planes equal to the plain tile tap's, and the
    fallback row count."""
    groups = atlas.tile_groups
    if len(config.tex_group_caps) != len(groups) + 1:
        raise RenderError(f"tex_group_caps {config.tex_group_caps}: the atlas has "
                          f"{len(groups)} groups, so {len(groups) + 1} caps are needed")
    hp, wp = covered.shape
    gid = torch.zeros_like(trow)
    for g in groups[1:]:
        gid = gid + (trow >= g[0]).to(torch.int32)
    rows = [tile_rows(config, p) for p in (covered, trow, eq // 8, gid)]
    g_lo, g_hi, many = tile_row_groups(rows[0], rows[3], len(groups))
    out, fb_rows = tile_tap_resolve_grouped(
        atlas.tiles, groups, config.tex_group_caps, rows[1], rows[0], rows[2], rows[3],
        g_lo, g_hi, many, [tile_rows(config, a) for a in aux],
    )
    return untile_rows(config, out, hp, wp), fb_rows


def env_rows_bf16(buffers: SceneBuffers) -> torch.Tensor:
    """The environment's (n_env, 128) bf16 quad rows, the table the JAX
    package's sky and IBL lookups read: the tail of the merged table, or,
    on the tile route, the tile atlas's f32 copy rounded to bf16 as the
    build rounds it."""
    atlas, env = buffers.atlas, buffers.environment
    if env.rows is not None:
        return env.rows
    if atlas.tiles is None:
        return atlas.combined_env_rows[-env.num_rows :]
    rows = atlas.tiles[atlas.tiles_ntex : atlas.tiles_ntex + env.num_rows]
    return rows.view(torch.float32).to(torch.bfloat16)


def _light_and_composite(
    buffers, params, config, covered, background, wp, n, lit, base_color, metalness, roughness,
):
    """Sun + point lights (spotlight cones with config.spotlights) + ambient
    under the ``pbr_lights`` range, then IBL specular (config.ibl_specular)
    and the skybox composite under ``sky_composite``."""
    with named_scope("pbr_lights"):
        color = _lights(params, config, wp, n, lit, base_color, metalness, roughness)
    with named_scope("sky_composite"):
        return _sky_composite(buffers, params, config, covered, background, color, wp, n,
                              base_color, metalness)


def _lights(params, config, wp, n, lit, base_color, metalness, roughness):
    """The sun term scaled by ``lit``, the first config.static_point_lights
    point lights (the bank's count where None; at most MAX_POINT_LIGHTS),
    each scaled by ``lit`` and by its cone under config.spotlights, and the
    ambient term: K15, whose plain version the brute-force frame takes (it
    launches no kernel)."""
    shade = shade_lights_plain if config.force_bruteforce else shade_lights
    return shade(wp, n, base_color, metalness, roughness, lit, params, config.spotlights,
                 count=config.static_point_lights)


def _sky_composite(buffers, params, config, covered, background, color, wp, n, base_color,
                   metalness):
    """IBL specular (config.ibl_specular) added to the lit colour, then the
    skybox where no surface covers the pixel."""
    if config.ibl_specular:
        eye = params.camera.eye.tolist()
        wo = torch.stack([eye[i] - wp[i] for i in range(3)])
        wo = wo / torch.sqrt(dot_cf(wo, wo))
        # F(n.wo, F0) * env(reflect(-wo, n)) (JAX pipeline.py:920-932).
        ndotwo = dot_cf(n, wo)
        refl = 2.0 * ndotwo * n - wo
        env = buffers.environment
        env_c = torch.stack(sky.sample_environment_ibl_cf(
            env_rows_bf16(buffers), env.block_grid, env.region, refl[0], refl[1], refl[2]
        ))
        f0 = 0.04 + (base_color - 0.04) * metalness
        color = color + fresnel_schlick(torch.clamp(ndotwo, min=0.0), f0) * env_c
    return torch.where(covered[None], color, background)


# Lanes of the deferred frame's shade table (build_shade_table).
SHADE_TABLE_LANES = 74


def build_shade_table(setup: raster.TriSetup, geom: Geometry, wc) -> torch.Tensor:
    """The deferred frame's per-slot shading values (JAX pipeline.py:239-281),
    component-major (SHADE_TABLE_LANES, P) so that a per-pixel gather by
    slot id gives channel-first planes. Row k holds lane k of the JAX
    table: [0:9) the perspective-barycentric planes (edge_c * inv_area2 /
    w_c), [9:51) three 14-value corner blocks (world position, n, t, b, uv)
    blended through the near-clip corner weights, [51:63) the material's
    atlas regions, [63:67) its metal-roughness constant, [67:70) its normal
    constant. Rows [70:74) hold the combined-atlas region the port samples
    (the JAX row holds the unread normal alpha at 70 and zeros after).
    Clip slot s is triangle s % T: the tri-major planes are broadcast over
    a (2, T) view of the slots."""
    p, t = setup.capacity, geom.capacity
    if p != 2 * t:
        raise RenderError("clip slots must be [primary; secondary] tri-major")
    table = torch.empty((SHADE_TABLE_LANES, p), dtype=torch.float32, device=geom.tri_trs.device)

    def slots(rows):  # (k, p) view of the slots as (k, 2, T)
        return rows.view(rows.shape[0], 2, t)

    for c in range(3):
        scale = setup.inv_area2 / setup.w[c]
        table[3 * c : 3 * c + 3] = torch.stack(list(setup.edges[c])) * scale
    sa = geom.tri_static_attrs
    att = [torch.stack([*wc[k], *sa[11 * k : 11 * k + 11]])[:, None] for k in range(3)]
    for c in range(3):
        cb = [setup.cb[c][k].reshape(1, 2, t) for k in range(3)]
        slots(table[9 + 14 * c : 23 + 14 * c])[:] = cb[0] * att[0] + cb[1] * att[1] + cb[2] * att[2]
    slots(table[51:74])[:] = geom.tri_matrow[:, None]
    return table


def material_taps(atlas, region, u, v):
    """The material tap of the deferred frame and of the fused frame's
    unmerged and per-slot routes (the JAX package's sample_atlas_multi /
    sample_quads_flat): (base colour (3, ...), normal (3, ...) or None,
    (roughness, metalness) or None), None where every material's map of
    that slot is constant (the material row's constant stands in).
    ``region(slot)`` gives the 4 region planes (y, x, h, w) of texture slot
    0-2, ``region(None)`` those of the combined atlas. The per-slot atlas
    is tapped per non-constant slot, as the JAX package taps it; the
    combined quads give each combined slot the same texels and fractions
    (one size per material, constants broadcast)."""
    if atlas.tiles is not None:
        raise RenderError(
            "deferred, brute-force and ray-traced shading have no tile-atlas sampler (the "
            "per-slot quad tables are skipped at reference texture scale); render with the "
            "fused path instead"
        )
    if atlas.quads is not None:
        def tap(slot):
            return sample_quads_flat(atlas.quads, atlas.block_grid, *region(slot), u,
                                     v).movedim(-1, 0)

        nm = None if atlas.nm_constant else tap(1)[0:3]
        mr = None if atlas.mr_constant else tuple(tap(2)[1:3])
        return tap(0)[0:3], nm, mr
    if atlas.combined_quads is not None:
        tex = sample_quads_flat(atlas.combined_quads, atlas.combined_block_grid,
                                *region(None), u, v).movedim(-1, 0)
    else:
        tex = sample_atlas_multi(atlas, *region(None), u, v)
    return _combined_slots(atlas, tex)


def shade(
    buffers: SceneBuffers, params: SceneParams, setup: raster.TriSetup, ibuf: torch.Tensor,
    wc, shadow_map: torch.Tensor, config: RenderConfig, y0: int = 0,
) -> torch.Tensor:
    """Deferred forward.hlsl ps_main (ps_main :208-235; JAX pipeline.py:
    438-576) over the (H, W) visibility buffer, whose first row is the
    frame's row ``y0`` (a slab of a sharded frame) -> HDR (3, H, W): one table
    gather per pixel, perspective-correct barycentrics, the material tap
    (sample_atlas_multi), the PCF at the pixel's light-space position, then
    the fused frame's lights and composite. The tile atlas has no sampler
    here, as in the JAX package (its per-slot tables would be GBs)."""
    atlas, env = buffers.atlas, buffers.environment
    if atlas.tiles is not None:
        material_taps(atlas, None, None, None)  # raises: no tile-atlas sampler
    h, w = ibuf.shape
    dev = ibuf.device
    covered = ibuf >= 0
    table = build_shade_table(setup, buffers.geometry, wc)
    r = table[:, torch.clamp(ibuf, min=0).reshape(-1).long()].view(SHADE_TABLE_LANES, h, w)
    px, py = raster.pixel_centers(h, w, dev, y0)

    bw = [r[3 * c] * px + r[3 * c + 1] * py + r[3 * c + 2] for c in range(3)]
    den = bw[0] + bw[1] + bw[2]
    den = torch.where(den == 0, 1.0, den)
    b = [x / den for x in bw]
    a = b[0] * r[9:23] + b[1] * r[23:37] + b[2] * r[37:51]
    wp, n_v, t_v, b_v = a[0:3], a[3:6], a[6:9], a[9:12]

    # Gather hygiene, as in the fused frame: uncovered pixels tap one texel.
    def cov(plane, fallback):
        return torch.where(covered, plane, fallback)

    def region(slot):  # uncovered pixels: the region (0, 0, 1, 1)
        first = 70 if slot is None else 51 + 4 * slot
        return [cov(r[first + i], float(i > 1)) for i in range(4)]

    base_color, nm, mr = material_taps(atlas, region, cov(a[12], 0.0), cov(a[13], 0.0))
    if nm is None:
        nm = r[67:70]  # nm const
    if mr is None:
        roughness, metalness = r[64:65], r[65:66]  # mr const green, blue
    else:
        roughness, metalness = mr[0][None], mr[1][None]

    # get_normal (forward.hlsl:104-112): green flip, [0,1]->[-1,1], TBN.
    nm = torch.cat([nm[0:1], 1.0 - nm[1:2], nm[2:3]])
    nm = nm * 2.0 - 1.0
    n = t_v * nm[0:1] + b_v * nm[1:2] + n_v * nm[2:3]
    n = n / torch.sqrt(dot_cf(n, n))

    with named_scope("pcf_shadow"):
        pv = params.sun.proj_view().tolist()
        lsp = [pv[i][0] * wp[0] + pv[i][1] * wp[1] + pv[i][2] * wp[2] + pv[i][3]
               for i in range(4)]
        # The divide by w, then the runs path (the brute-force frame: no kernel).
        runs = shadow.pcf_runs_plain if config.force_bruteforce else shadow.pcf_runs
        lit = (1.0 - runs(shadow_map, *(c / lsp[3] for c in lsp[:3])))[None]

    dx, dy, dz = sky.camera_ray_dirs_cf(params.camera, px, py, config.width, config.height)
    background = torch.stack(sky.sample_environment_cf(
        env_rows_bf16(buffers), env.block_grid, env.region, dx, dy, dz
    ))
    return _light_and_composite(
        buffers, params, config, covered, background, wp, n, lit, base_color, metalness,
        roughness,
    )


class FrontEnd(NamedTuple):
    """front_end's products: the shadow map (a sun cache's map), its pass's
    pairs and capacity, the world corners, the camera setup, the visibility
    buffer, the camera pass's pairs and capacity and, on the fused frame,
    the G-buffer and pcf_shadow's shadow factor and penumbra rows."""

    shadow_map: torch.Tensor
    shadow_pairs: torch.Tensor
    shadow_cap: int
    wc: tuple
    setup: raster.TriSetup
    ibuf: torch.Tensor
    cam_pairs: torch.Tensor
    cam_cap: int
    gbuf: torch.Tensor | None = None
    shadow_f: torch.Tensor | None = None
    pcf_rows: torch.Tensor | None = None


def front_end(buffers: SceneBuffers, cam_pv: torch.Tensor, sun_pv: torch.Tensor,
              config: RenderConfig, sun_cache: SunCache | None = None) -> FrontEnd:
    """render_frame_stats up to its shading: the shadow pass (none with a
    ``sun_cache``), the camera pass and, on the fused frame, the PCF. It
    takes no per-frame value but the camera's and the sun's 4x4 ``cam_pv``
    / ``sun_pv`` (on the host, or on the scene's device: corners_clip), so
    that CachedFront can capture it."""
    geom = buffers.geometry
    dev = buffers.device
    is_fused = fused(config)
    sun_lut = sun_pyr = lut_y_range = None

    # named_scope ranges name the frame graph's passes in profiler traces
    # (the JAX package's named_scope labels).
    with named_scope("shadow_pass"):
        wc = world_corners(geom)
        sun_clip = corners_clip(wc, sun_pv)
        tri_valid = torch.arange(geom.capacity, device=dev) < geom.num_tris
        if sun_cache is None:
            # The sun-frustum cull applies to the fused frame only (JAX :1026).
            cull_rect = None
            if is_fused and config.sun_frustum_cull:
                cull_rect, lut_y_range = sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config)
            shadow_map, sh_pairs, sh_cap = shadow_pass(geom, sun_clip, config, cull_rect)
        else:
            shadow_map = sun_cache.shadow_map
            sun_lut, sun_pyr = sun_cache.lutq, sun_cache.pyramid
            sh_pairs, sh_cap = torch.zeros((), dtype=torch.int32, device=dev), 1
        check_finite("shadow_pass", shadow_map=shadow_map)

    with named_scope("forward_visibility"):
        setup = camera_setup(wc, tri_valid, cam_pv, config)
        if not is_fused:
            _, ibuf, cam_pairs, cam_cap = rasterize(setup, config.height, config.width, config)
            return FrontEnd(shadow_map, sh_pairs, sh_cap, wc, setup, ibuf, cam_pairs, cam_cap)
        shade_rows = build_shade_rows(setup, geom, wc, tuple(c[:3] for c in sun_clip))
        ibuf, gbuf, cam_pairs = raster_tiles.raster_gbuffer(
            setup, shade_rows, config.height, config.width, config
        )
        cam_cap = config.pair_capacity(setup.capacity, "cam")
        check_gbuffer(gbuf, ibuf)

    with named_scope("pcf_shadow"):
        shadow_f, pcf_rows = pcf_shadow(gbuf, ibuf >= 0, shadow_map, config, sun_lut, sun_pyr,
                                        lut_y_range)
    return FrontEnd(shadow_map, sh_pairs, sh_cap, wc, setup, ibuf, cam_pairs, cam_cap, gbuf,
                    shadow_f, pcf_rows)


def render_frame_stats(
    buffers: SceneBuffers, params: SceneParams, settings: Settings, config: RenderConfig,
    sun_cache: SunCache | None = None,
):
    """Full frame -> ((H, W, 3) uint8, raster health stats).

    stats: cam/shadow pairs, penumbra rows and the grouped tile route's
    fallback rows (0-dim device tensors) and their capacities; more than
    the capacity means a buffer overflowed and the frame is wrong —
    check_stats() raises then (``debug_overflow`` also logs a warning from
    here). pcf_row_cap / tex_fb_cap is 1 when classification / grouping is
    off (the count is then 0); the brute-force frame reports 0 pairs of a
    cap of 1.

    ``sun_cache`` (a build_sun_cache result) replaces the shadow pass, the
    window table and the pyramid while the sun and the geometry are
    unchanged; the frame's pixels are the same. Tiles the JAX package
    refuses on this frame's path raise RenderError (core/config.check_tiles)."""
    return _frame(buffers, params, settings, config, sun_cache, front_end)


def _frame(buffers, params, settings, config, sun_cache, front):
    """render_frame_stats with ``front`` (front_end, or a CachedFront) for
    its front end."""
    use_full_f32()
    check_tiles(config, shadow=sun_cache is None)
    check_frame_inputs(params, settings)
    f = front(buffers, params.camera.proj_view(), params.sun.proj_view(), config, sun_cache)

    with named_scope("forward_shade_skybox"):
        if fused(config):
            hdr, tex_fb_rows = shade_gbuffer(buffers, params, f.gbuf, f.ibuf >= 0, f.shadow_f,
                                             config)
            pcf_rows = f.pcf_rows
        else:
            hdr = shade(buffers, params, f.setup, f.ibuf, f.wc, f.shadow_map, config)
            pcf_rows = tex_fb_rows = torch.zeros((), dtype=torch.int32, device=buffers.device)
        check_finite("forward_shade_skybox", hdr=hdr)

    with named_scope("post_process"):
        img = post_process(hdr, settings, config)[: config.height, : config.width]

    stats = {
        "cam_pairs": f.cam_pairs,
        "cam_pair_cap": f.cam_cap,
        "shadow_pairs": f.shadow_pairs,
        "shadow_pair_cap": f.shadow_cap,
        "pcf_rows": pcf_rows,
        "pcf_row_cap": pcf_row_capacity(config),
        "tex_fb_rows": tex_fb_rows,
        "tex_fb_cap": tex_fb_capacity(buffers, config),
    }
    if config.debug_overflow:
        warn_overflow(stats)
    return img.contiguous(), stats


def post_process(hdr: torch.Tensor, settings: Settings, config: RenderConfig) -> torch.Tensor:
    """HDR (3, H, W) -> u8 (H, W, 3) view: the f16 storage round of the HDR
    target (renderer.cpp:128-144; skipped without config.hdr_half_round),
    tonemap, gamma and the unorm8 store."""
    if config.hdr_half_round:
        hdr = hdr.half().float()
    ldr = tonemap.tonemap(hdr, settings.tm_method, settings.gamma, settings.exposure)
    return tonemap.to_unorm8(ldr).permute(1, 2, 0)


def check_frame_inputs(params: SceneParams, settings: Settings) -> None:
    """The debug checks (utils/errors.enable_debug_checks) on the frame's
    float inputs: camera, sun, point lights, ambient and settings."""
    cam, sun, lights = params.camera, params.sun, params.point_lights
    check_finite(
        "frame inputs", camera_eye=cam.eye, camera_rotation=cam.rotation,
        camera_aspect=cam.aspect, camera_fov_y=cam.fov_y, camera_z_near=cam.z_near,
        camera_z_far=cam.z_far, sun_position=sun.position, sun_rotation=sun.rotation,
        sun_color=sun.color, light_position=lights.position, light_color=lights.color,
        light_spot_dir=lights.spot_dir, light_spot_cos=lights.spot_cos,
        ambient=params.ambient, gamma=settings.gamma, exposure=settings.exposure,
    )


def check_gbuffer(gbuf: torch.Tensor, ibuf: torch.Tensor) -> None:
    """The debug checks on the fused frame's G-buffer lanes of the covered
    pixels (uncovered pixels hold zeros); without the checks, no work (the
    mask gather would sync the card every frame)."""
    if debug_checks_enabled():
        check_finite("forward_visibility", gbuffer=gbuf[:, ibuf >= 0])


def warn_overflow(stats) -> None:
    """Log a warning for each pass whose pair buffer overflowed, and for
    grouped-tile fallback rows past their cap (a host read of the counts:
    the JAX package prints them from the device)."""
    for pass_name in ("cam", "shadow"):
        pairs = int(stats[f"{pass_name}_pairs"])
        cap = int(stats[f"{pass_name}_pair_cap"])
        if pairs > cap:
            log.warning("%s pass: %d tile-triangle pairs > capacity %d (overflowing "
                        "pairs are dropped: the frame misses fragments)", pass_name, pairs, cap)
    rows, cap = int(stats.get("tex_fb_rows", 0)), int(stats.get("tex_fb_cap", 1))
    if rows > cap:
        log.warning("grouped tile route: %d fallback rows > capacity %d (overflowing rows "
                    "read another row's texels)", rows, cap)


def render_frame(buffers, params, settings, config: RenderConfig, sun_cache=None) -> torch.Tensor:
    """Full frame -> (H, W, 3) uint8 (Renderer::render_frame)."""
    img, _ = render_frame_stats(buffers, params, settings, config, sun_cache)
    return img


def pcf_row_capacity(config: RenderConfig) -> int:
    """The penumbra row capacity of this config (1 = classification off,
    as it is outside the fused frame; pcf_rows is then always 0)."""
    if config.pcf_row_cap is None or not fused(config):
        return 1
    pn = config.num_tiles * config.tile_h * config.tile_w
    return shadow.effective_row_cap(pn, config.pcf_row_cap)


def tex_fb_capacity(buffers: SceneBuffers, config: RenderConfig) -> int:
    """The grouped tile route's fallback row capacity (1 = grouping off:
    tex_fb_rows is then always 0)."""
    return int(config.tex_group_caps[-1]) if grouped(buffers, config) else 1


def build_sun_cache(buffers: SceneBuffers, params: SceneParams, config: RenderConfig):
    """Render the sun's full shadow map (no cull rect: the cache must hold
    for any camera) and, when the frame reads them (pcf_row_capacity > 1),
    its quantised window table (K7) and min/max pyramid. Returns
    (SunCache, stats with shadow_pairs / shadow_pair_cap). Build it again
    when the sun or the geometry changes."""
    use_full_f32()
    check_tiles(config, camera=False)
    geom = buffers.geometry
    with named_scope("shadow_pass"):
        sun_clip = corners_clip(world_corners(geom), params.sun.proj_view())
        shadow_map, sh_pairs, sh_cap = shadow_pass(geom, sun_clip, config)
        lutq = pyr = None
        if pcf_row_capacity(config) > 1:
            lutq = shadow.build_window_lut_q(shadow_map)
            pyr, _ = shadow.build_shadow_pyramid(shadow_map)
    stats = {"shadow_pairs": sh_pairs, "shadow_pair_cap": sh_cap}
    return SunCache(shadow_map=shadow_map, lutq=lutq, pyramid=pyr), stats


def check_stats(stats) -> None:
    """Raise if a rendered frame dropped fragments (host-side, post-render)."""
    for pass_name in ("cam", "shadow"):
        pairs = int(stats[f"{pass_name}_pairs"])
        cap = int(stats[f"{pass_name}_pair_cap"])
        if pairs > cap:
            raise RenderError(
                f"{pass_name} pass overflowed the tile-pair buffer "
                f"({pairs} pairs > capacity {cap}): fragments were dropped and "
                f"the frame is incomplete. Raise RenderConfig.pairs_per_tri / "
                f"pair_reserve."
            )
    rows = int(stats.get("pcf_rows", 0))
    cap = int(stats.get("pcf_row_cap", 1))
    if rows > cap:
        raise RenderError(
            f"PCF penumbra rows overflowed the compaction buffer ({rows} rows > "
            f"capacity {cap}): overflowing rows got another row's shadow values. "
            f"Raise RenderConfig.pcf_row_cap."
        )
    rows = int(stats.get("tex_fb_rows", 0))
    cap = int(stats.get("tex_fb_cap", 1))
    if rows > cap:
        raise RenderError(
            f"grouped-tile fallback rows overflowed ({rows} rows > capacity {cap}): "
            f"overflowing rows got another row's texture values. Raise "
            f"RenderConfig.tex_group_caps[-1] (or re-run pipeline.autotune_tex_group_caps "
            f"with a bigger margin)."
        )


def measure_pair_counts(buffers: SceneBuffers, params, config: RenderConfig) -> tuple[int, int]:
    """Actual (camera, shadow) pair counts of a frame, with no sort and no
    raster: the front end and the tile footprints of render_frame_stats
    (the shadow count inside the sun-cull rect of the fused frame with
    sun_frustum_cull, over the whole map otherwise). ``params`` is one
    SceneParams or a list of them (a camera path): a list gives the
    element-wise max."""
    use_full_f32()
    geom = buffers.geometry
    wc = world_corners(geom)
    tri_valid = torch.arange(geom.capacity, device=buffers.device) < geom.num_tris
    s = config.shadow_size
    cam = sh = 0
    for p in params if isinstance(params, (list, tuple)) else [params]:
        cam_pv, sun_pv = p.camera.proj_view(), p.sun.proj_view()
        setup = camera_setup(wc, tri_valid, cam_pv, config)
        c = binning.count_pairs(setup, config.tiles_x, config.tiles_y, config.tile_w,
                                config.tile_h)
        sh_setup = raster.setup_screen_triangles(
            raster.near_clip_corners(corners_clip(wc, sun_pv), tri_valid), s, s, cull="front"
        )
        rect = None
        if fused(config) and config.sun_frustum_cull:
            rect = sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config)[0]
        h = binning.count_pairs(sh_setup, config.shadow_tiles_x, config.shadow_tiles_y,
                                config.shadow_tile, config.shadow_th, rect=rect)
        cam, sh = max(cam, int(c)), max(sh, int(h))
    return cam, sh


def autotune_pair_caps(
    buffers: SceneBuffers, params, config: RenderConfig, margin: float = 2.0,
    bucket: int = 65536,
) -> RenderConfig:
    """``config`` with pair caps sized to the scene: the real pair counts of
    one frame (or the max over a list of params, a camera path), times
    ``margin`` plus 8192, rounded up to a multiple of ``bucket``. Binning's
    sort and gathers scale with the capacity, which the formula oversizes.
    Overflow stays loud: a later frame above a tuned cap fails check_stats."""
    cam, sh = measure_pair_counts(buffers, params, config)

    def cap(n: int) -> int:
        need = int(n * margin) + 8192
        return max(bucket, -(-need // bucket) * bucket)

    return dataclasses.replace(config, pair_cap_cam=cap(cam), pair_cap_shadow=cap(sh))


def _camera_rows(buffers: SceneBuffers, params, config: RenderConfig):
    """The camera pass of a frame through its own front end (camera_setup,
    binning, K1), as the fused frame's tile-major 128-pixel rows: (covered
    (R, 128), material id (R, 128), junk where not covered)."""
    geom = buffers.geometry
    if geom.tri_material is None:
        raise RenderError("the geometry carries no tri_material (build it with build_buffers)")
    wc = world_corners(geom)
    tri_valid = torch.arange(geom.capacity, device=buffers.device) < geom.num_tris
    setup = camera_setup(wc, tri_valid, params.camera.proj_view(), config)
    _, ibuf, _ = raster_tiles.bin_and_rasterize(
        setup, config, config.tiles_x, config.tiles_y, config.tile_h, config.tile_w
    )
    rows = tile_rows(config, ibuf)
    covered = rows >= 0
    slot = torch.where(covered, rows, 0) % geom.capacity  # clip slots are [tri; tri]
    return covered, geom.tri_material[slot.long()]


def measure_tex_group_rows(buffers: SceneBuffers, params, config: RenderConfig):
    """The grouped tile route's row needs of a frame (JAX pipeline.py:
    1278-1330): (G + 1,) ints, the rows each material group claims and the
    fallback rows of more than two groups, max over ``params`` (one
    SceneParams or a list, a camera path). The rows and their claims are
    the frame's own (tile_row_groups over the same tile-major rows), so caps
    sized from these cover the frames of that path."""
    use_full_f32()
    atlas = buffers.atlas
    g_n = len(atlas.tile_groups)
    group_of = torch.tensor(atlas.tile_group_of, dtype=torch.int32, device=buffers.device)
    need = torch.zeros(g_n + 1, dtype=torch.int64)
    for p in params if isinstance(params, (list, tuple)) else [params]:
        covered, mat = _camera_rows(buffers, p, config)
        g_lo, g_hi, many = tile_row_groups(covered, group_of[mat.long()], g_n)
        counts = [(~many & ((g_lo == g) | (g_hi == g))).sum() for g in range(g_n)]
        need = torch.maximum(need, torch.stack(counts + [many.sum()]).cpu())
    return need.numpy()


def measure_tex_row_masks(buffers: SceneBuffers, params, config: RenderConfig):
    """Per-128-pixel-row material bitmasks over a params list: (F, R)
    int64 host array, bit m set where a covered pixel of the row shows
    material m (up to 64 materials; JAX pipeline.py:1333-1382). The input
    of io/texplan.plan_material_groups."""
    use_full_f32()
    out = []
    for p in params if isinstance(params, (list, tuple)) else [params]:
        covered, mat = _camera_rows(buffers, p, config)
        shown = torch.zeros((mat.shape[0], 64), dtype=torch.int64, device=mat.device)
        rows = torch.arange(mat.shape[0], device=mat.device)[:, None].expand_as(mat)
        shown[rows[covered], mat[covered].long()] = 1
        bit = torch.arange(64, device=mat.device)
        out.append((shown << bit).sum(dim=1).cpu().numpy())  # distinct bits: sum == or
    return np.stack(out)


def plan_tex_groups(buffers: SceneBuffers, params, config: RenderConfig):
    """Measure row masks over a camera path and anneal a material grouping
    (io/texplan). Returns the groups for build_buffers(tex_groups=...), or
    None for a scene without a multi-group tile atlas (or over 64
    materials); then size the caps with autotune_tex_group_caps on the
    rebuilt scene. Each group's row budget is the one the scene was built
    with (the JAX package plans with its default budget whatever the build
    used)."""
    atlas = buffers.atlas
    groups = atlas.tile_groups
    if groups is None or len(groups) <= 1 or len(atlas.tile_group_of) > 64:
        return None
    from arctic_tpu_torch.io.texplan import plan_material_groups

    env_rows = groups[0][2] - groups[0][1]
    masks = measure_tex_row_masks(buffers, params, config)
    plan, _ = plan_material_groups(masks, list(atlas.tile_mat_rows), env_rows,
                                   atlas.tile_group_budget // 512)
    return plan


def autotune_tex_group_caps(
    buffers: SceneBuffers, params, config: RenderConfig, margin: float = 1.1
) -> RenderConfig:
    """``config`` with tex_group_caps sized to a scene and camera path: the
    measured rows of each group and of the fallback times ``margin`` plus
    32, rounded up to a multiple of 32. The tap's work scales with the
    caps' sum; a later frame past the fallback cap fails check_stats. No
    change for a scene without a multi-group tile atlas."""
    groups = buffers.atlas.tile_groups
    if buffers.atlas.tiles is None or groups is None or len(groups) <= 1:
        return config
    need = measure_tex_group_rows(buffers, params, config)
    caps = tuple(max(32, -(-int(n * margin + 32) // 32) * 32) for n in need)
    return dataclasses.replace(config, tex_group_caps=caps)


def _check_device(buffers: SceneBuffers, device: torch.device) -> None:
    if buffers.device.type != device.type:
        raise RenderError(f"scene buffers on {buffers.device}, renderer on {device}")


def make_renderer(config: RenderConfig, device: torch.device | str = "cuda"):
    """Frame function ``f(buffers, params, settings) -> img`` (the image of
    make_renderer_stats)."""
    render_stats = make_renderer_stats(config, device)

    def render(buffers, params, settings):
        return render_stats(buffers, params, settings)[0]

    return functools.update_wrapper(render, render_frame)


def make_renderer_stats(config: RenderConfig, device: torch.device | str = "cuda"):
    """Frame function ``f(buffers, params, settings) -> (img, stats)`` for
    scene buffers on ``device`` (the card unless the caller asks for the
    CPU); per-frame params and settings stay on the host."""
    use_full_f32()
    device = torch.device(device)

    def render(buffers, params, settings):
        _check_device(buffers, device)
        return render_frame_stats(buffers, params, settings, config)

    return functools.update_wrapper(render, render_frame_stats)


def make_sun_cache_builder(config: RenderConfig, device: torch.device | str = "cuda"):
    """``f(buffers, params) -> (SunCache, stats)`` for scene buffers on
    ``device`` (build_sun_cache)."""
    use_full_f32()
    device = torch.device(device)

    def build(buffers, params):
        _check_device(buffers, device)
        return build_sun_cache(buffers, params, config)

    return functools.update_wrapper(build, build_sun_cache)


class CachedFront:
    """front_end of the cached fused frame as one CUDA graph: about 1,900
    of the cached 1080p frame's 2,100 launches, and most of the host time
    that paces it.

    On the card, for the fused frame with a sun cache and the debug checks
    off, the first call with a scene, a cache and a config runs front_end
    eagerly (what loads once loads then), the second captures it and
    replays the capture, every later call replays it. Each of these calls
    first copies the camera's and the sun's 4x4 into the graph's input: one
    non-blocking upload from pinned memory. A replay rewrites the graph's
    outputs in place; the frame consumes them on the same stream before
    the next call queues its replay, and the pair and penumbra-row counts
    it hands out as stats are copies. Another scene, cache or config starts
    over; every other call runs front_end as it is.

    A replay calls no kernel wrapper. The wrappers' ``.launches`` count the
    capture's launches once, for the replay that follows the capture;
    ``replays`` counts the replays after that, each of which launches the
    capture's ``captured`` {kernel name: launches}."""

    def __init__(self):
        self.replays = 0
        self.captured: dict[str, int] = {}
        self._for = self._pv = self._graph = self._out = None

    def __call__(self, buffers, cam_pv, sun_pv, config, sun_cache=None) -> FrontEnd:
        if (buffers.device.type != "cuda" or sun_cache is None or not fused(config)
                or debug_checks_enabled()):
            return front_end(buffers, cam_pv, sun_pv, config, sun_cache)
        key = (buffers, sun_cache, config)
        fresh = self._for is None or any(a is not b for a, b in zip(self._for, key))
        if fresh:
            self._for, self._graph, self._out = key, None, None
            self._pv = torch.empty((2, 4, 4), dtype=torch.float32, device=buffers.device)
        self._pv.copy_(torch.stack([cam_pv, sun_pv]).to(torch.float32).pin_memory(),
                       non_blocking=True)
        if fresh:
            return front_end(buffers, self._pv[0], self._pv[1], config, sun_cache)
        if self._graph is None:
            before = kernels.launch_counts()
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                self._out = front_end(buffers, self._pv[0], self._pv[1], config, sun_cache)
            self.captured = {k: n - before[k] for k, n in kernels.launch_counts().items()
                             if n > before[k]}
        else:
            self.replays += 1
        self._graph.replay()
        out = self._out
        return out._replace(shadow_pairs=out.shadow_pairs.clone(),
                            cam_pairs=out.cam_pairs.clone(), pcf_rows=out.pcf_rows.clone())


def make_cached_renderer_stats(config: RenderConfig, device: torch.device | str = "cuda"):
    """Frame function ``f(buffers, params, settings, sun_cache) -> (img,
    stats)``: the camera-motion path of a session with a stationary sun,
    with no shadow raster, table build or pyramid in the frame. On the card
    the fused frame's front end runs as a CUDA graph (CachedFront, the
    function's ``.front``)."""
    use_full_f32()
    device = torch.device(device)
    front = CachedFront()

    def render(buffers, params, settings, sun_cache):
        _check_device(buffers, device)
        return _frame(buffers, params, settings, config, sun_cache, front)

    render = functools.update_wrapper(render, render_frame_stats)
    render.front = front
    return render
