"""Ray-traced mode — torch port of arctic_tpu/models/raytrace.py.

Primary rays from a BVH (ops/rt.py; K14 on the card, each warp on an 8 x 4
pixel tile) give visibility with true barycentrics; one any-hit ray per
pixel toward the sun gives a hard shadow that, like the raster frame's PCF
term, also scales the point lights; with ``RenderConfig.rt_light_shadows``
an any-hit ray toward each point light, bounded at its distance, shadows
that light too. Spotlight cones act under ``spotlights``. The lighting (the
sun, the point lights and the ambient term) is one launch of K15
(ops/pbr.shade_lights) on the card. Misses show the skybox; the f16 HDR
round and the tonemap are the raster frame's. Planes are channel first.
"""

from __future__ import annotations

import functools

import torch

from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import MAX_POINT_LIGHTS, SceneBuffers, SceneParams, Settings
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import rt, sky
from arctic_tpu_torch.ops.pbr import dot_cf, point_light_dir, shade_lights
from arctic_tpu_torch.utils.errors import RenderError, check_finite
from arctic_tpu_torch.utils.profiling import named_scope


def build_scene_bvh(buffers: SceneBuffers) -> rt.BVH:
    """Host-side BVH over the world-space triangles (static TRS baked in;
    rebuild after moving objects), on the buffers' device."""
    tris = pipeline.world_triangles(buffers.geometry).cpu().numpy()
    return rt.build_bvh(tris, device=buffers.device)


def primary_rays(camera, height: int, width: int, device):
    """The frame's camera rays: ((R, 3) origins at the eye, (3, H, W)
    direction planes through the pixel centres)."""
    px = (torch.arange(width, device=device, dtype=torch.float32) + 0.5).expand(height, width)
    py = (torch.arange(height, device=device, dtype=torch.float32) + 0.5)[:, None].expand(
        height, width)
    dirs = torch.stack(sky.camera_ray_dirs_cf(camera, px, py, width, height))
    origins = camera.eye.to(device=device, dtype=torch.float32).expand(height * width, 3)
    return origins.contiguous(), dirs


def _rays(planes):
    """(3, ...) planes -> (R, 3) contiguous rays."""
    return planes.reshape(3, -1).T.contiguous()


def light_visibility(bvh: rt.BVH, shadow_org, wp, lights, width: int):
    """(L, H, W) f32, 1 where each point light sees the surface: an any-hit
    ray from the offset origins toward it, bounded at its distance so that
    geometry behind the light cannot block it; None without lights."""
    vis = []
    for i in range(min(lights.count, MAX_POINT_LIGHTS)):
        wi, dist = point_light_dir(wp, lights.position[i])
        locc = rt.trace(bvh, shadow_org, _rays(wi), t_max=dist.reshape(-1) - 2e-3,
                        any_hit=True, width=width)
        vis.append(torch.where((locc.tri >= 0).reshape(wp.shape[1:]), 0.0, 1.0))
    return torch.stack(vis) if vis else None


def render_frame_rt(
    buffers: SceneBuffers, bvh: rt.BVH, params: SceneParams, settings: Settings,
    config: RenderConfig,
) -> torch.Tensor:
    """Full ray-traced frame -> (H, W, 3) uint8 (JAX raytrace.py:40-140).
    The tile atlas has no sampler here, as in the JAX package."""
    atlas, env, geom = buffers.atlas, buffers.environment, buffers.geometry
    h, w = config.height, config.width
    dev = buffers.device

    # Six named_scope ranges, one after another, cover every statement that
    # launches device work or waits for the card, so that a profiler trace
    # charges each device span and idle gap to its pass.
    with named_scope("rt_primary"):
        if atlas.tiles is not None:
            raise RenderError(
                "ray-traced mode has no tile-atlas sampler (reference-scale texture sets skip "
                "the per-slot quad tables); use the raster path"
            )
        pipeline.use_full_f32()
        pipeline.check_frame_inputs(params, settings)
        origins, dirs = primary_rays(params.camera, h, w, dev)
        hits = rt.trace(bvh, origins, _rays(dirs), width=w)
        covered = (hits.tri >= 0).reshape(h, w)
        tri = torch.clamp(hits.tri, min=0).long()
        u, v = hits.u.reshape(h, w), hits.v.reshape(h, w)
        bary = (1.0 - u - v, u, v)

    with named_scope("rt_surface"):
        # Corner attributes of the hit triangle: world position, n, t, b, uv.
        wc = pipeline.world_corners(geom)
        sa = geom.tri_static_attrs
        corners = [torch.stack([*wc[c], *sa[11 * c : 11 * c + 11]])[:, tri].view(14, h, w)
                   for c in range(3)]
        a = bary[0] * corners[0] + bary[1] * corners[1] + bary[2] * corners[2]
        wp, n_v, t_v, b_v = a[0:3], a[3:6], a[6:9], a[9:12]
        matrow = geom.tri_matrow[:, tri].view(-1, h, w)
        base_color, nm, mr = pipeline.material_taps(
            atlas, lambda s: matrow[19:23] if s is None else matrow[4 * s : 4 * s + 4], a[12],
            a[13])
        # A slot whose maps are all constant: the material row's constant in
        # the texel type, the value every tap of it gives.
        dt = atlas.texel_dtype
        if nm is None:
            nm = matrow[16:19].to(dt).float()
        if mr is None:
            mr = (matrow[13].to(dt).float(), matrow[14].to(dt).float())
        nm = torch.cat([nm[0:1], 1.0 - nm[1:2], nm[2:3]]) * 2.0 - 1.0
        n = t_v * nm[0:1] + b_v * nm[1:2] + n_v * nm[2:3]
        n = n / torch.sqrt(dot_cf(n, n))
        roughness, metalness = mr[0][None], mr[1][None]

    with named_scope("rt_sun_shadow"):
        # Hard shadow: one any-hit ray toward the sun per pixel.
        wi_sun = -params.sun.direction().to(dev)
        shadow_org = _rays(wp + n * 1e-3)
        occ = rt.trace(bvh, shadow_org, wi_sun.expand(h * w, 3).contiguous(), any_hit=True,
                       width=w)
        lit = torch.where((occ.tri >= 0).reshape(h, w) & covered, 0.0, 1.0)[None]

    with named_scope("pbr_lights"):
        visibility = None
        if config.rt_light_shadows:
            visibility = light_visibility(bvh, shadow_org, wp, params.point_lights, w)
        color = shade_lights(wp, n, base_color, metalness, roughness, lit, params,
                             config.spotlights, visibility)

    with named_scope("rt_sky"):
        background = torch.stack(sky.sample_environment_cf(
            pipeline.env_rows_bf16(buffers), env.block_grid, env.region, *dirs
        ))
        hdr = torch.where(covered[None], color, background)
        check_finite("ray-traced shade", hdr=hdr)

    with named_scope("post_process"):
        return pipeline.post_process(hdr, settings, config).contiguous()


def make_rt_renderer(config: RenderConfig, bvh: rt.BVH, device: torch.device | str = "cuda"):
    """Frame function ``f(buffers, params, settings) -> img`` of the
    ray-traced mode over ``bvh`` (build_scene_bvh), for scene buffers on
    ``device`` (the card unless the caller asks for the CPU)."""
    pipeline.use_full_f32()
    device = torch.device(device)

    def render(buffers, params, settings):
        pipeline._check_device(buffers, device)
        if bvh.v0.device.type != device.type:
            raise RenderError(f"BVH on {bvh.v0.device}, renderer on {device}")
        return render_frame_rt(buffers, bvh, params, settings, config)

    return functools.update_wrapper(render, render_frame_rt)
