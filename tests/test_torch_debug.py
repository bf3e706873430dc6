"""The port's debug checks (utils/errors.enable_debug_checks): NaN and Inf
become FloatingPointError at the pass that hands them on.

Cornell at 96x64 with a 96^2 shadow map on each frame of the port: the
fused frame, its quantised PCF, the deferred and brute-force frames, the
frame as 2 slabs (parallel/sharding.py) and the ray-traced frame.
- With the checks on, each frame equals the frame without them.
- A NaN light colour raises naming the frame's inputs, before any pass.
- A NaN in one covered triangle's corner normal (a static attribute row)
  raises naming forward_visibility where the G-buffer holds it (fused and
  slab frames), and the pass whose HDR holds it elsewhere.
- Without the checks the same inputs render.
The flag is turned off after each test.
"""

import dataclasses

import numpy as np
import pytest
import torch

from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import (
    PointLights,
    default_scene_params,
    default_settings,
    make_camera,
)
from arctic_tpu_torch.io import build, procedural
from arctic_tpu_torch.models import pipeline, raytrace
from arctic_tpu_torch.ops import raster_tiles
from arctic_tpu_torch.parallel import sharding
from arctic_tpu_torch.utils.errors import debug_checks_enabled, enable_debug_checks

W, H, SHADOW = 96, 64, 96
FRAMES = ["fused", "quant", "deferred", "bruteforce", "slabs", "raytrace"]
# Where a NaN corner normal of a covered triangle is caught.
NORMAL_CAUGHT = {"fused": "forward_visibility", "quant": "forward_visibility",
                 "slabs": "forward_visibility", "deferred": "forward_shade_skybox",
                 "bruteforce": "forward_shade_skybox", "raytrace": "ray-traced shade"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The suite runs test files in several processes at once; an
    oversubscribed torch thread pool slows these small CPU frames by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def checks_off():
    enable_debug_checks(False)
    yield
    enable_debug_checks(False)


def _scene():
    bufs = build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device="cpu")
    params = default_scene_params(aspect=W / H)
    params.camera = make_camera([0.0, 4.0, 3.0], [-25.0, -90.0], W / H)
    return bufs, params, default_settings()


def _render(kind, bufs, params, settings):
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, **{
        "quant": dict(pcf_row_cap=64), "deferred": dict(fused_shade=False),
        "bruteforce": dict(force_bruteforce=True),
    }.get(kind, {}))
    if kind == "slabs":
        return sharding.render_frame_slabs_stats(bufs, params, settings, config, 2)[0]
    if kind == "raytrace":
        return raytrace.render_frame_rt(bufs, raytrace.build_scene_bvh(bufs), params, settings,
                                        config)
    return pipeline.render_frame_stats(bufs, params, settings, config)[0]


@pytest.mark.parametrize("kind", FRAMES)
def test_checked_frame_equals_unchecked(kind):
    bufs, params, settings = _scene()
    want = _render(kind, bufs, params, settings)
    enable_debug_checks()
    assert debug_checks_enabled()
    got = _render(kind, bufs, params, settings)
    assert want.float().std() > 10
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("kind", FRAMES)
def test_nan_light_colour_raises_at_the_inputs(kind):
    bufs, params, settings = _scene()
    params.point_lights = PointLights.from_list([((0.0, 1.0, 0.0), (10.0, float("nan"), 0.0))])
    _render(kind, bufs, params, settings)  # no checks: the frame renders
    enable_debug_checks()
    with pytest.raises(FloatingPointError, match=r"frame inputs: 1 non-finite value\(s\) in "
                                                 r"light_color"):
        _render(kind, bufs, params, settings)


@pytest.mark.parametrize("kind", FRAMES)
def test_nan_corner_normal_raises_at_its_pass(kind):
    bufs, params, settings = _scene()
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW)
    geom = bufs.geometry
    wc = pipeline.world_corners(geom)
    tri_valid = torch.arange(geom.capacity) < geom.num_tris
    setup = pipeline.camera_setup(wc, tri_valid, params.camera.proj_view(), config)
    _, ibuf, _ = raster_tiles.rasterize_tiled(setup, H, W, config)
    tri = int(ibuf[H // 2, W // 2]) % geom.capacity
    assert int(ibuf[H // 2, W // 2]) >= 0
    rows = geom.slot_static_rows.clone()
    rows[0, [tri, geom.capacity + tri]] = float("nan")  # corner 0's normal x, both clip slots
    bufs = dataclasses.replace(bufs, geometry=dataclasses.replace(
        geom, slot_static_rows=rows, tri_static_attrs=rows[0:33, : geom.capacity]))
    _render(kind, bufs, params, settings)  # no checks: the frame renders
    enable_debug_checks()
    with pytest.raises(FloatingPointError, match=f"^{NORMAL_CAUGHT[kind]}: "):
        _render(kind, bufs, params, settings)
