"""Parameter bridge: the JAX package's SceneBuffers / SceneParams /
Settings / SunCache -> this package's dataclasses of tensors on a device,
and its RenderConfig -> this package's.

Leaves are read with ``np.asarray`` (so this module imports no JAX; the
caller's objects carry it). bf16 leaves arrive as ``ml_dtypes.bfloat16``
arrays and move bit for bit through a uint16 -> int16 view and
``.view(torch.bfloat16)``. The tests use the bridge to feed both renderers
one scene; ``scene_leaves`` lists the port's leaves as numpy arrays for
leaf-by-leaf comparisons.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from arctic_tpu_torch.core.config import RenderConfig, config_from_dict
from arctic_tpu_torch.core.scene import (
    Camera,
    DirectionalLight,
    Environment,
    Geometry,
    PointLights,
    SceneBuffers,
    SceneParams,
    Settings,
    SunCache,
    TextureAtlas,
)
from arctic_tpu_torch.io.build import TEX_GROUP_BUDGET_BYTES
from arctic_tpu_torch.ops.shadow import lut_pitch


def tensor(leaf, device="cpu") -> torch.Tensor:
    """One numpy-convertible leaf -> tensor on ``device``, bit for bit."""
    a = np.array(leaf)  # a writable host copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy; bf16 as its uint16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def scene_buffers(jb, device="cpu") -> SceneBuffers:
    """JAX-package SceneBuffers -> SceneBuffers, on the JAX frame's texture
    route: the merged quad rows (combined quads of the environment rows'
    type), the unmerged combined quads, the per-slot atlas or the tile atlas
    (with its groups and, for explicit groups, their tables)."""
    g, a, e = jb.geometry, jb.atlas, jb.environment
    geometry = Geometry(
        num_tris=int(np.asarray(g.num_tris)),
        tri_corner_pos=tensor(g.tri_corner_pos, device),
        tri_trs=tensor(g.tri_trs, device),
        tri_static_attrs=tensor(g.tri_static_attrs, device),
        tri_matrow=tensor(g.tri_matrow, device),
        slot_static_rows=None if g.slot_static_rows is None else tensor(g.slot_static_rows, device),
        tri_material=tensor(g.tri_material, device),
        object_trs=tensor(g.object_trs, device),
        tri_obj=tensor(g.tri_obj, device),
    )
    flags = dict(nm_constant=bool(a.nm_constant), mr_constant=bool(a.mr_constant))
    env_rows = None
    if a.tiles is not None:
        atlas = TextureAtlas(
            tiles=tensor(a.tiles, device),
            tiles_ntex=int(a.tiles_ntex),
            tile_groups=tuple(tuple(int(v) for v in grp) for grp in a.tile_groups),
            tile_group_of=None if a.tile_group_of is None else tuple(a.tile_group_of),
            tile_mat_rows=None if a.tile_mat_rows is None else tuple(a.tile_mat_rows),
            tile_group_budget=TEX_GROUP_BUDGET_BYTES,
            **flags,
        )
    elif a.combined_env_rows is not None and (
            np.asarray(a.combined_quads).dtype == np.asarray(e.atlas.quads_packed).dtype):
        atlas = TextureAtlas(
            combined_slots=tuple(a.combined_slots),
            combined_shape=tuple(a.combined_shape),
            quad_width=int(np.asarray(a.combined_quads).shape[-1]),
            combined_env_rows=tensor(a.combined_env_rows, device),
            **flags,
        )
    else:
        env_rows = tensor(e.atlas.quads_packed, device)
        if a.combined_slots is not None:
            atlas = TextureAtlas(
                combined_slots=tuple(a.combined_slots),
                combined_shape=tuple(a.combined_shape),
                quad_width=int(np.asarray(a.combined_quads).shape[-1]),
                combined_quads=tensor(a.combined_quads, device),
                **flags,
            )
        else:
            atlas = TextureAtlas(quads=tensor(a.quads, device),
                                 data_shape=tuple(np.asarray(a.data).shape[:2]), **flags)
    env = Environment(
        region=tuple(int(v) for v in np.asarray(e.atlas.regions)[0, 0]),
        data_shape=tuple(np.asarray(e.atlas.data).shape[:2]),
        num_rows=int(np.asarray(e.atlas.quads_packed).shape[0]),
        rows=env_rows,
    )
    return SceneBuffers(geometry=geometry, atlas=atlas, environment=env)


def bvh(jbvh, device="cpu"):
    """A JAX-package rt.BVH -> ops/rt.BVH (bit for bit), so both packages
    trace one tree."""
    from arctic_tpu_torch.ops.rt import BVH

    return BVH.pack(**{f: tensor(getattr(jbvh, f), device) for f in BVH.FIELDS})


def scene_params(jp) -> SceneParams:
    """JAX-package SceneParams -> SceneParams (host tensors)."""
    c, s, pl = jp.camera, jp.sun, jp.point_lights
    camera = Camera(*(tensor(getattr(c, f)) for f in ("eye", "rotation", "aspect", "fov_y", "z_near", "z_far")))
    sun = DirectionalLight(tensor(s.position), tensor(s.rotation), tensor(s.color))
    lights = PointLights(
        tensor(pl.position), tensor(pl.color), int(np.asarray(pl.count)),
        spot_dir=None if pl.spot_dir is None else tensor(pl.spot_dir),
        spot_cos=None if pl.spot_cos is None else tensor(pl.spot_cos),
    )
    return SceneParams(camera=camera, ambient=tensor(jp.ambient), sun=sun, point_lights=lights)


def settings(js) -> Settings:
    """JAX-package Settings -> Settings."""
    return Settings(
        tm_method=int(np.asarray(js.tm_method)),
        gamma=tensor(js.gamma),
        exposure=tensor(js.exposure),
    )


def render_config(jc) -> RenderConfig:
    """JAX-package RenderConfig -> RenderConfig, by core/config's
    config_from_dict: every field carries over (the shadow tile's
    shadow_tile / shadow_tile_h among them), but the ones that change no
    pixel, which are dropped."""
    return config_from_dict({f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})


def window_table_q(jlut, s: int) -> np.ndarray:
    """The JAX package's u16-quantised window LUT ((N, 128) i32: 16x8-texel
    blocks at y-stride 12 / x-stride 4, two texels per lane; shadow.py
    build_window_lut_q / window_row_index_q) decoded into this package's
    table: the (s + 4, lut_pitch(s)) u16 padded map, 0 past column s + 4.
    Each padded texel is read from the block of the window that starts at
    it (or at s, for the last 3 rows / columns)."""
    lut = np.asarray(jlut).view(np.uint32)
    xb = -(-(-(-(s + 4 + 3) // 128)) // 8) * 8  # shadow.lut_q_xb
    pos = np.arange(s + 4)
    start = np.minimum(pos, s)
    qy, yoff = start // 12, start % 12
    qx, xoff = start // 4, start % 4
    row = (qy * 16 * xb)[:, None] + (((qx // 2) % 16) * xb + qx // 32)[None, :]
    br = (yoff + pos - start)[:, None]  # texel row within the 16-row block
    bc = (xoff + pos - start)[None, :]  # texel column within the 8-col block
    lane = 64 * (qx % 2)[None, :] + 4 * br + bc // 2
    q = (lut[row, lane] >> (16 * (bc % 2)).astype(np.uint32)) & 0xFFFF
    out = np.zeros((s + 4, lut_pitch(s)), np.uint16)
    out[:, : s + 4] = q
    return out


def sun_cache(jc, device="cpu") -> SunCache:
    """JAX-package SunCache -> SunCache: the map and the pyramid as they
    are (same layouts), the window LUT decoded by window_table_q."""
    smap = tensor(jc.shadow_map, device)
    s = smap.shape[0]
    lutq = None if jc.lutq is None else torch.from_numpy(window_table_q(jc.lutq, s)).to(device)
    pyr = None if jc.pyramid is None else tensor(jc.pyramid, device)
    return SunCache(shadow_map=smap, lutq=lutq, pyramid=pyr)


def _nested(x, device):
    if isinstance(x, (tuple, list)):
        return tuple(_nested(v, device) for v in x)
    return tensor(x, device)


def tri_setup(js, device="cpu"):
    """JAX-package raster.TriSetup -> ops.raster.TriSetup (bit for bit)."""
    from arctic_tpu_torch.ops.raster import TriSetup

    names = ("sx", "sy", "w", "zplane", "edges", "inv_area2", "cb", "valid", "bbox")
    return TriSetup(**{n: _nested(getattr(js, n), device) for n in names})


def scene_leaves(b: SceneBuffers) -> dict:
    """The port's scene leaves as numpy arrays / plain values, by name
    (None for the fields of the texture route the scene does not take)."""
    g, a, e = b.geometry, b.atlas, b.environment

    def arr(t):
        return None if t is None else to_numpy(t)

    return {
        "num_tris": g.num_tris,
        "tri_corner_pos": to_numpy(g.tri_corner_pos),
        "tri_trs": to_numpy(g.tri_trs),
        "tri_static_attrs": to_numpy(g.tri_static_attrs),
        "tri_matrow": to_numpy(g.tri_matrow),
        "slot_static_rows": arr(g.slot_static_rows),
        "combined_slots": a.combined_slots,
        "combined_shape": None if a.combined_shape is None else tuple(a.combined_shape),
        "quad_width": a.quad_width,
        "combined_env_rows": arr(a.combined_env_rows),
        "tiles": arr(a.tiles),
        "tiles_ntex": a.tiles_ntex,
        "tile_groups": a.tile_groups,
        "env_region": e.region,
        "env_data_shape": tuple(e.data_shape),
        "env_num_rows": e.num_rows,
    }
