"""Scene / settings persistence — port of arctic_tpu/utils/serialize.py,
with the same JSON schema, so a state file saved by either package loads
in the other to equal values.

The reference keeps all state in RAM (renderer.cpp:216); for reproducible
renders the dynamic scene parameters and post settings go to JSON
(geometry and textures reload from the scene file, their source of truth).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from arctic_tpu_torch.core.scene import (
    MAX_POINT_LIGHTS,
    Camera,
    DirectionalLight,
    PointLights,
    SceneParams,
    Settings,
    point_cone_rows,
)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def params_to_dict(params: SceneParams, settings: Settings) -> dict:
    c = params.camera
    pl = params.point_lights
    return {
        "camera": {
            "eye": c.eye.tolist(),
            "rotation": c.rotation.tolist(),
            "aspect": float(c.aspect),
            "fov_y": float(c.fov_y),
            "z_near": float(c.z_near),
            "z_far": float(c.z_far),
        },
        "ambient": float(params.ambient),
        "sun": {
            "position": params.sun.position.tolist(),
            "rotation": params.sun.rotation.tolist(),
            "color": params.sun.color.tolist(),
        },
        "point_lights": [
            {"position": pl.position[i].tolist(), "color": pl.color[i].tolist(),
             # The raw cone packing, for banks built with cones.
             **({} if pl.spot_dir is None else
                {"spot_dir": pl.spot_dir[i].tolist(), "spot_cos": pl.spot_cos[i].tolist()})}
            for i in range(pl.count)
        ],
        "settings": {
            "tm_method": int(settings.tm_method),
            "gamma": float(settings.gamma),
            "exposure": float(settings.exposure),
        },
    }


def params_from_dict(d: dict) -> tuple[SceneParams, Settings]:
    c = d["camera"]
    camera = Camera(
        eye=_f32(c["eye"]), rotation=_f32(c["rotation"]), aspect=_f32(c["aspect"]),
        fov_y=_f32(c["fov_y"]), z_near=_f32(c["z_near"]), z_far=_f32(c["z_far"]),
    )
    s = d["sun"]
    sun = DirectionalLight(
        position=_f32(s["position"]), rotation=_f32(s["rotation"]), color=_f32(s["color"])
    )
    pls = d.get("point_lights", [])
    lights = PointLights.from_list([(pl["position"], pl["color"]) for pl in pls])
    if any("spot_dir" in pl for pl in pls):
        # The raw cone packing, verbatim (round-trip exact); rows without
        # one are point rows.
        sdir, scos = point_cone_rows()
        for i, pl in enumerate(pls[:MAX_POINT_LIGHTS]):
            if "spot_dir" in pl:
                sdir[i], scos[i] = pl["spot_dir"], pl["spot_cos"]
        lights.spot_dir, lights.spot_cos = torch.as_tensor(sdir), torch.as_tensor(scos)
    params = SceneParams(
        camera=camera,
        ambient=_f32(d.get("ambient", 0.1)),
        sun=sun,
        point_lights=lights,
    )
    st = d.get("settings", {})
    settings = Settings(
        tm_method=int(st.get("tm_method", 0)),
        gamma=_f32(st.get("gamma", 2.2)),
        exposure=_f32(st.get("exposure", 1.0)),
    )
    return params, settings


def save_state(path: str, params: SceneParams, settings: Settings) -> None:
    with open(path, "w") as f:
        json.dump(params_to_dict(params, settings), f, indent=2)


def load_state(path: str) -> tuple[SceneParams, Settings]:
    with open(path) as f:
        return params_from_dict(json.load(f))
