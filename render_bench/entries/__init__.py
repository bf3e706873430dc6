"""Entries of the program: one module a way of rendering a frame.

Each module has ``setup(run) -> frame``: it builds what its frames need
(timing each step into ``run.setup_parts``) and returns ``frame(spec) ->
(u8 image (H, W, 3), stats or None)``.
"""

from __future__ import annotations


def params(spec: dict):
    """(SceneParams, Settings) of the program for a frame spec."""
    import torch

    from arctic_tpu_torch.core.scene import (
        DirectionalLight, PointLights, SceneParams, Settings, make_camera,
    )

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    cam = spec["camera"]
    sun = spec["sun"]
    p = SceneParams(
        camera=make_camera(cam["eye"], cam["rotation"], cam["aspect"], cam["fov_y"],
                           cam["z_near"], cam["z_far"]),
        ambient=f32(spec["ambient"]),
        sun=DirectionalLight(position=f32(sun["position"]), rotation=f32(sun["rotation"]),
                             color=f32(sun["color"])),
        point_lights=PointLights.from_list([(tuple(a), tuple(b)) for a, b in spec["lights"]]),
    )
    st = spec["settings"]
    return p, Settings(tm_method=st["tm_method"], gamma=f32(st["gamma"]),
                       exposure=f32(st["exposure"]))


def render_config(run, **fields):
    """The program's RenderConfig of the run's configuration."""
    from arctic_tpu_torch.core.config import RenderConfig

    w, h = run.cfg["resolution"]
    if "shadow_size" in run.cfg:
        fields["shadow_size"] = run.cfg["shadow_size"]
    return RenderConfig(width=w, height=h, static_point_lights=run.cfg["static_point_lights"],
                        **fields)
