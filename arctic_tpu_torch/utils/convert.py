"""Parameter bridge: the JAX package's SceneBuffers / SceneParams /
Settings -> this package's dataclasses of tensors on a device, and its
RenderConfig -> this package's.

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

from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import (
    Camera,
    DirectionalLight,
    Environment,
    Geometry,
    PointLights,
    SceneBuffers,
    SceneParams,
    Settings,
    TextureAtlas,
)


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
    """JAX-package SceneBuffers (default build route) -> SceneBuffers."""
    g, a, e = jb.geometry, jb.atlas, jb.environment
    if a.combined_env_rows is None:
        raise ValueError("scene buffers without the merged texture+environment table")
    geometry = Geometry(
        num_tris=int(np.asarray(g.num_tris)),
        tri_corner_pos=tensor(g.tri_corner_pos, device),
        tri_trs=tensor(g.tri_trs, device),
        slot_static_rows=tensor(g.slot_static_rows, device),
    )
    atlas = TextureAtlas(
        combined_slots=tuple(a.combined_slots),
        combined_shape=tuple(a.combined_shape),
        quad_width=int(np.asarray(a.combined_quads).shape[-1]),
        combined_env_rows=tensor(a.combined_env_rows, device),
    )
    env = Environment(
        region=tuple(int(v) for v in np.asarray(e.atlas.regions)[0, 0]),
        data_shape=tuple(np.asarray(e.atlas.data).shape[:2]),
        num_rows=int(np.asarray(e.atlas.quads_packed).shape[0]),
    )
    return SceneBuffers(geometry=geometry, atlas=atlas, environment=env)


def scene_params(jp) -> SceneParams:
    """JAX-package SceneParams -> SceneParams (host tensors)."""
    c, s, pl = jp.camera, jp.sun, jp.point_lights
    camera = Camera(*(tensor(getattr(c, f)) for f in ("eye", "rotation", "aspect", "fov_y", "z_near", "z_far")))
    sun = DirectionalLight(tensor(s.position), tensor(s.rotation), tensor(s.color))
    lights = PointLights(tensor(pl.position), tensor(pl.color), int(np.asarray(pl.count)))
    return SceneParams(camera=camera, ambient=tensor(jp.ambient), sun=sun, point_lights=lights)


def settings(js) -> Settings:
    """JAX-package Settings -> Settings."""
    return Settings(
        tm_method=int(np.asarray(js.tm_method)),
        gamma=tensor(js.gamma),
        exposure=tensor(js.exposure),
    )


def render_config(jc) -> RenderConfig:
    """JAX-package RenderConfig -> RenderConfig. Raises ValueError when a
    field the port does not carry is set away from its default there (a
    path the port does not have)."""
    kept = {f.name for f in dataclasses.fields(RenderConfig)}
    default = type(jc)()
    off = [
        f.name for f in dataclasses.fields(jc)
        if f.name not in kept and getattr(jc, f.name) != getattr(default, f.name)
    ]
    if off:
        raise ValueError(f"RenderConfig options the port does not have: {off}")
    return RenderConfig(**{name: getattr(jc, name) for name in kept})


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
    """The port's scene leaves as numpy arrays / plain values, by name."""
    g, a, e = b.geometry, b.atlas, b.environment
    return {
        "num_tris": g.num_tris,
        "tri_corner_pos": to_numpy(g.tri_corner_pos),
        "tri_trs": to_numpy(g.tri_trs),
        "slot_static_rows": to_numpy(g.slot_static_rows),
        "combined_slots": a.combined_slots,
        "combined_shape": tuple(a.combined_shape),
        "quad_width": a.quad_width,
        "combined_env_rows": to_numpy(a.combined_env_rows),
        "env_region": e.region,
        "env_data_shape": tuple(e.data_shape),
        "env_num_rows": e.num_rows,
    }
