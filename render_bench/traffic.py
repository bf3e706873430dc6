"""The one generator of traffic: a closed loop of frames along a camera path.

A mix (traffic/<mix>.json) gives the path: ``viewpoints`` stops from
``start``, each ``step`` further along the hall and ``yaw_step`` degrees
further round, at ``pitch``; the sun at ``sun_pitch`` and ``sun_azimuth``,
moving ``sun_step`` degrees a stop. The loop walks the stops forward and
back (0, 1, ..., V-1, V-2, ..., 1, 0, ...), so no frame repeats the one
before it and every seed renders the same work. The seed sets where in
that cycle the run starts, and a fraction of a step by which the whole
path (and the sun, where it moves) is shifted.

A frame spec is a dict of plain numbers, read alike by the program's
entries and by the reference: camera (eye, rotation, aspect, fov_y,
z_near, z_far), sun (position, rotation, color), lights, ambient, settings
and the frame's size.
"""

from __future__ import annotations

import numpy as np

TONEMAPS = {"reinhard": 0, "exposure": 1, "aces": 2}
# The reference renderer's default exposure.
EXPOSURE = 1.0


def f32(x: float) -> float:
    """A number as the program's float32 host tensors hold it."""
    return float(np.float32(x))


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one use (0: the path, 1: the frames the
    check keeps, 2: the pixels it reads), for any whole number."""
    return np.random.default_rng([seed % 2**64, stream])


def cycle(mix: dict) -> int:
    v = mix["viewpoints"]
    return 2 * v - 2


def stop_of(k: int, mix: dict) -> int:
    """The path stop of the cycle's k-th frame (forward, then back)."""
    v = mix["viewpoints"]
    j = k % cycle(mix)
    return j if j < v else 2 * v - 2 - j


def path(cfg: dict, mix: dict, seed: int) -> dict:
    """The seed's path: its start in the cycle, its fractional shift, and
    the spec of each stop."""
    r = rng(seed, 0)
    phase = int(r.integers(cycle(mix)))
    frac = float(r.random())
    w, h = cfg["resolution"]
    cam = cfg["camera"]
    stops = []
    for i in range(mix["viewpoints"]):
        s = i + frac
        eye = [mix["start"][k] + s * mix["step"][k] for k in range(3)]
        sun_az = mix["sun_azimuth"] + s * mix["sun_step"]
        stops.append({
            "mode": cfg["mode"],
            "width": w,
            "height": h,
            "shadow_size": cfg.get("shadow_size"),
            "camera": {
                "eye": [f32(x) for x in eye],
                "rotation": [f32(mix["pitch"]), f32(mix["yaw"] + s * mix["yaw_step"])],
                "aspect": f32(w / h),
                "fov_y": f32(cam["fov_y"]),
                "z_near": f32(cam["z_near"]),
                "z_far": f32(cam["z_far"]),
            },
            "sun": {
                "position": [f32(x) for x in cfg["sun_position"]],
                "rotation": [f32(mix["sun_pitch"]), f32(sun_az)],
                "color": [f32(x) for x in cfg["sun_color"]],
            },
            "lights": [([f32(x) for x in p], [f32(x) for x in c])
                       for p, c in cfg["lights"][: cfg["static_point_lights"]]],
            "ambient": f32(cfg["ambient"]),
            "settings": {"tm_method": TONEMAPS[cfg["tonemap"]], "gamma": f32(cfg["gamma"]),
                         "exposure": f32(EXPOSURE)},
            "light_shadows": bool(mix.get("light_shadows", False)),
        })
    return {"phase": phase, "frac": frac, "stops": stops}


def frame(p: dict, mix: dict, k: int) -> dict:
    """The spec of the run's k-th frame (k counts from the first warm-up
    frame)."""
    return p["stops"][stop_of(p["phase"] + k, mix)]
