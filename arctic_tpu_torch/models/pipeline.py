"""The default fused frame — torch port of arctic_tpu/models/pipeline.py
(render_frame_stats with the default RenderConfig; core/config.py).

shadow pass (sun-cull rect, binning, K1 depth-only raster) -> shade-row
table (K3) -> camera binning + K1 raster -> G-buffer resolve (K4) -> PCF
sun shadow -> merged texture + sky tap (K6) -> Cook-Torrance PBR with point
lights and ambient -> skybox composite -> f16 HDR round, tonemap, gamma, u8.

The frame runs eagerly on the device of the scene buffers. Per-frame
constants (the camera and sun matrices, the light count, post-process
settings) are evaluated on the host from the params' host tensors, as the
reference's CPU side does, and enter device math as f32 values. Pair
buffers have fixed capacities (RenderConfig.pair_capacity) so overflow
stays loud through check_stats. Intermediates are row-major (C, H_pad,
W_pad) planes; the values are the JAX package's.
"""

from __future__ import annotations

import functools

import torch

from arctic_tpu_torch.core.config import SHADOW_TILE, RenderConfig
from arctic_tpu_torch.core.scene import (
    MAX_POINT_LIGHTS,
    Geometry,
    SceneBuffers,
    SceneParams,
    Settings,
)
from arctic_tpu_torch.ops import cull, raster, raster_tiles, shadow, sky, tonemap
from arctic_tpu_torch.ops.pbr import dot_cf, outgoing_radiance_cf
from arctic_tpu_torch.ops.sampling import quad_index, tap_resolve
from arctic_tpu_torch.utils.errors import RenderError


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


def corners_clip(wc, proj_view: torch.Tensor):
    """World corner components -> clip components ``out[c] = (x, y, z, w)``;
    ``proj_view`` is a host 4x4."""
    pv = proj_view.tolist()
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
    """Conservative shadow-tile rect for shadow_pass (ops/cull.py)."""
    lo, hi = scene_aabb(wc, tri_valid)
    return cull.shadow_cull_rect(
        cam_pv.to(lo.device), sun_pv.to(lo.device), lo, hi, config.shadow_size,
        SHADOW_TILE, SHADOW_TILE,
    )


def shadow_pass(geom: Geometry, sun_clip, config: RenderConfig, cull_rect):
    """Depth-only pass from the sun's view (shadow_map_pass.cpp:113-169),
    front faces culled, over the cull rect's tiles; returns (shadow map
    (S, S), pairs, pair cap)."""
    tri_valid = torch.arange(geom.capacity, device=geom.tri_trs.device) < geom.num_tris
    clipped = raster.near_clip_corners(sun_clip, tri_valid)
    s = config.shadow_size
    setup = raster.setup_screen_triangles(clipped, s, s, cull="front")
    zbuf, _, pairs = raster_tiles.rasterize_tiled(
        setup, s, s, config, tile_h=SHADOW_TILE, tile_w=SHADOW_TILE,
        depth_only=True, rect=cull_rect,
    )
    return zbuf, pairs, config.pair_capacity(setup.capacity)


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


def build_shade_rows(setup: raster.TriSetup, geom: Geometry, wc, lsp) -> torch.Tensor:
    """(N, 128) shade rows per clip slot: K3 blends, scales and writes the
    table from the per-frame planes and the build-time static rows."""
    pf = shade_row_planes(setup, geom, wc, lsp)
    return raster_tiles.pack_shade_rows(pf, geom.slot_static_rows, setup.capacity)


def shade_gbuffer(
    buffers: SceneBuffers, params: SceneParams, gbuf: torch.Tensor,
    covered: torch.Tensor, shadow_map: torch.Tensor, config: RenderConfig,
) -> torch.Tensor:
    """forward.hlsl ps_main over the (64, H_pad, W_pad) G-buffer, channel
    first (lane map: [0:3 wp, 3:6 n, 6:9 t, 9:12 b, 12:14 uv, 14:17 light
    space xyz, 24:36 atlas regions, 36:40 mr const, 40:43 nm const, 43:47
    combined-atlas region]). Returns HDR (3, H_pad, W_pad)."""
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
    py = (torch.arange(hp, device=dev, dtype=torch.float32) + 0.5)[:, None].expand(hp, wp_)
    dx, dy, dz = sky.camera_ray_dirs_cf(params.camera, px, py, config.width, config.height)
    dx = torch.where(covered, 1.0, dx)
    dy = torch.where(covered, 0.0, dy)
    dz = torch.where(covered, 0.0, dz)

    with torch.profiler.record_function("pcf_shadow"):
        shadow_f = shadow.pcf_shadow_proj(shadow_map, gbuf[14], gbuf[15], gbuf[16])

    # ONE tap serves texture AND sky: a covered pixel reads its material
    # quad, an uncovered one its environment quad, from one merged table.
    u_sky, v_sky = sky.env_uv_cf(dx, dy, dz)
    tq, tfx, tfy = quad_index(
        atlas.combined_block_grid, reg_lane(43, 0.0), reg_lane(44, 0.0),
        reg_lane(45, 1.0), reg_lane(46, 1.0), u_uv, v_uv,
    )
    eq, efx, efy = quad_index(env.block_grid, *env.region, u_sky, v_sky)
    c4 = atlas.quad_width
    per = 128 // c4
    merged = atlas.combined_env_rows
    ntex = merged.shape[0] - env.num_rows
    idx = torch.where(covered, tq // per, ntex + eq // 8)
    tap_args = [a.reshape(-1) for a in (idx, tq % per, eq % 8, tfx, tfy, efx, efy)]
    out16 = tap_resolve(merged, *tap_args, c4=c4).reshape(16, hp, wp_)
    nch = c4 // 4
    background = out16[nch : nch + 3]
    slot_base = {s: 4 * i for i, s in enumerate(atlas.combined_slots)}
    base_color = out16[slot_base[0] : slot_base[0] + 3]
    nm = out16[slot_base[1] : slot_base[1] + 3] if 1 in slot_base else gbuf[40:43]
    if 2 in slot_base:
        metalness = out16[slot_base[2] + 2][None]
        roughness = out16[slot_base[2] + 1][None]
    else:
        metalness = gbuf[38:39]  # mr const blue
        roughness = gbuf[37:38]  # mr const green

    # get_normal (forward.hlsl:104-112): green flip, [0,1]->[-1,1], TBN.
    nm = torch.cat([nm[0:1], 1.0 - nm[1:2], nm[2:3]])
    nm = nm * 2.0 - 1.0
    n = t_v * nm[0:1] + b_v * nm[1:2] + n_v * nm[2:3]
    n = n / torch.sqrt(dot_cf(n, n))
    lit = (1.0 - shadow_f)[None]

    eye = params.camera.eye.tolist()
    wo = torch.stack([eye[i] - wp[i] for i in range(3)])
    wo = wo / torch.sqrt(dot_cf(wo, wo))

    with torch.profiler.record_function("pbr_lights"):
        return _light_and_composite(
            params, config, covered, background, wp, n, wo, lit, base_color,
            metalness, roughness,
        )


def _light_and_composite(
    params, config, covered, background, wp, n, wo, lit, base_color, metalness, roughness
):
    """Sun + point lights + ambient, then the skybox composite."""
    dev = wp.device
    sun_dir = params.sun.direction().to(dev)
    lo = lit * outgoing_radiance_cf(
        n, wo, -sun_dir[:, None, None], params.sun.color.to(dev)[:, None, None],
        base_color, metalness, roughness,
    )
    lights = params.point_lights
    if config.static_point_lights is None:
        n_lights = min(lights.count, MAX_POINT_LIGHTS)
    else:
        n_lights = min(config.static_point_lights, MAX_POINT_LIGHTS)
    for i in range(n_lights):
        lpos = lights.position[i].tolist()
        ldir = torch.stack([lpos[k] - wp[k] for k in range(3)])
        dist = torch.clamp(torch.sqrt(dot_cf(ldir, ldir)), min=1e-12)
        wi = ldir / dist
        radiance = lights.color[i].to(dev)[:, None, None] / (dist * dist)
        lo = lo + lit * outgoing_radiance_cf(
            n, wo, wi, radiance, base_color, metalness, roughness
        )
    color = lo + float(params.ambient) * base_color
    return torch.where(covered[None], color, background)


def render_frame_stats(
    buffers: SceneBuffers, params: SceneParams, settings: Settings, config: RenderConfig
):
    """Full frame -> ((H, W, 3) uint8, raster health stats).

    stats: cam/shadow pairs (0-dim device tensors) and their capacities;
    pairs > cap means a pair buffer overflowed and fragments were dropped —
    check_stats() raises then. The pcf_rows / tex_fb_rows stats of the JAX
    package are reported inactive (0 of 1), as its default config does."""
    use_full_f32()
    geom = buffers.geometry
    dev = buffers.device
    sun_pv = params.sun.proj_view()
    cam_pv = params.camera.proj_view()

    # record_function ranges name the frame graph's passes in profiler
    # traces (the JAX package's named_scope labels).
    with torch.profiler.record_function("shadow_pass"):
        wc = world_corners(geom)
        sun_clip = corners_clip(wc, sun_pv)
        tri_valid = torch.arange(geom.capacity, device=dev) < geom.num_tris
        cull_rect = sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config)
        shadow_map, sh_pairs, sh_cap = shadow_pass(geom, sun_clip, config, cull_rect)

    with torch.profiler.record_function("forward_visibility"):
        clipped = raster.near_clip_corners(corners_clip(wc, cam_pv), tri_valid)
        setup = raster.setup_screen_triangles(clipped, config.width, config.height, cull="back")
        shade_rows = build_shade_rows(setup, geom, wc, tuple(c[:3] for c in sun_clip))
        ibuf, gbuf, cam_pairs = raster_tiles.raster_gbuffer(
            setup, shade_rows, config.height, config.width, config
        )
    with torch.profiler.record_function("forward_shade_skybox"):
        hdr = shade_gbuffer(buffers, params, gbuf, ibuf >= 0, shadow_map, config)

    with torch.profiler.record_function("post_process"):
        # R16G16B16A16_FLOAT storage rounding (renderer.cpp:128-144).
        hdr = hdr.half().float()
        ldr = tonemap.tonemap(hdr, settings.tm_method, settings.gamma, settings.exposure)
        img = tonemap.to_unorm8(ldr).permute(1, 2, 0)[: config.height, : config.width]

    stats = {
        "cam_pairs": cam_pairs,
        "cam_pair_cap": config.pair_capacity(setup.capacity),
        "shadow_pairs": sh_pairs,
        "shadow_pair_cap": sh_cap,
        "pcf_rows": 0,
        "pcf_row_cap": 1,
        "tex_fb_rows": 0,
        "tex_fb_cap": 1,
    }
    return img.contiguous(), stats


def render_frame(buffers, params, settings, config: RenderConfig) -> torch.Tensor:
    """Full frame -> (H, W, 3) uint8 (Renderer::render_frame)."""
    img, _ = render_frame_stats(buffers, params, settings, config)
    return img


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


def make_renderer_stats(config: RenderConfig, device: torch.device | str):
    """Frame function ``f(buffers, params, settings) -> (img, stats)`` for
    scene buffers on ``device``; per-frame params and settings stay on the
    host."""
    use_full_f32()
    device = torch.device(device)

    def render(buffers, params, settings):
        if buffers.device.type != device.type:
            raise RenderError(f"scene buffers on {buffers.device}, renderer on {device}")
        return render_frame_stats(buffers, params, settings, config)

    return functools.update_wrapper(render, render_frame_stats)
