"""The raster frame's lighting on K15 (ops/pbr.shade_lights), on the CPU
through its plain version: the light count it takes, the cached raster
frame with 16 lights bit-equal to the per-light loop it replaced (kept here
as the oracle), the atrium of io/procedural.sponza_like_scene, and that
scene with 16 seeded lights held against the benchmark's plain reference
(render_bench/reference.py) under its 8-LSB rule, which sees the lights;
the cached frame's front end through pipeline.CachedFront, which on the
card replays it as a CUDA graph, bit-equal to the eager frame.

No JAX frame is rendered. The card's cases (marked ``cuda``) need no JAX
either:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_raster_lights.py -q
"""

import copy
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import (
    MAX_POINT_LIGHTS,
    PointLights,
    default_scene_params,
    default_settings,
    make_camera,
)
from arctic_tpu_torch.io import build, procedural
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import pbr
from arctic_tpu_torch.ops.pbr import dot_cf, outgoing_radiance_cf
from arctic_tpu_torch.utils import kernels, synthetic


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The suite runs test files in several processes at once; an
    oversubscribed torch thread pool slows these small CPU frames by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lights_loop(params, config, wp, n, lit, base_color, metalness, roughness):
    """The raster frame's lighting as plain torch computed it before K15
    (pipeline._light_and_composite): wo from the eye, the sun term scaled
    by ``lit``, then one light at a time (its cone under config.spotlights)
    up to config.static_point_lights (the bank's count where None), then
    the ambient term."""
    dev = wp.device
    eye = params.camera.eye.tolist()
    wo = torch.stack([eye[i] - wp[i] for i in range(3)])
    wo = wo / torch.sqrt(dot_cf(wo, wo))
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
        if config.spotlights and lights.spot_dir is not None:
            outer, inv_range = lights.spot_cos[i].tolist()
            cos_t = -dot_cf(wi, lights.spot_dir[i].to(dev)[:, None, None])
            radiance = radiance * torch.clamp((cos_t - outer) * inv_range, 0.0, 1.0)
        lo = lo + lit * outgoing_radiance_cf(n, wo, wi, radiance, base_color, metalness,
                                             roughness)
    return lo + float(params.ambient) * base_color


def seeded_lights(seed: int, spots: bool):
    """16 point lights over the Cornell boxes from ``seed``; with ``spots``
    every third one a spotlight."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(MAX_POINT_LIGHTS):
        pos = tuple(float(v) for v in rng.uniform((-4.0, 0.5, -6.0), (4.0, 5.0, 2.0)))
        col = tuple(float(v) for v in rng.uniform(0.0, 40.0, 3))
        cone = ((float(rng.uniform(-1, 1)), -1.0, float(rng.uniform(-1, 1))), 20.0, 40.0)
        rows.append((pos, col, cone) if spots and i % 3 == 0 else (pos, col))
    return PointLights.from_list(rows, spots=spots)


# ---------------------------------------------------------------- light count


@pytest.mark.parametrize("count", [2, 4, 16], ids=["below", "equal", "above"])
def test_plain_k15_takes_a_light_count(count):
    """shade_lights_plain with ``count`` against a bank of 4: below, it
    equals the bank cut to ``count`` lights; equal to or above it (the
    bank's zero rows add nothing), the call without a count. The wrapper
    on the CPU takes the plain version and counts the lights it shades."""
    args, kw = synthetic.k15_inputs("cpu", "lights_4")
    params = args[6]
    assert params.point_lights.count == 4
    got = pbr.shade_lights_plain(*args, **kw, count=count)
    if count < 4:
        lights = params.point_lights
        cut = dataclasses.replace(params, point_lights=dataclasses.replace(lights, count=count))
        want = pbr.shade_lights_plain(*args[:6], cut, *args[7:], **kw)
    else:
        want = pbr.shade_lights_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    kernels.reset_launch_counts()
    wrapped = pbr.shade_lights(*args, **kw, count=count)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0, equal_nan=True)
    assert (pbr.shade_lights.lights, pbr.shade_lights.launches) == (count, 0)
    kernels.reset_launch_counts()
    assert pbr.shade_lights.lights == 0


# ------------------------------------------------- cached frame against the loop

CORNELL_W, CORNELL_H, CORNELL_SHADOW = 96, 64, 96
FRAME_CASES = {
    "points": (dict(), False, None),
    "spots": (dict(spotlights=True), True, None),
    "spots_off": (dict(), True, None),
    "static_5_of_16": (dict(spotlights=True), True, 5),
}


def cached_frames(bufs, params, config, device):
    """(frame through K15, frame through lights_loop, the K15 calls, the
    lights K15 counted) of the cached raster frame."""
    cache, _ = pipeline.build_sun_cache(bufs, params, config)
    render = pipeline.make_cached_renderer_stats(config, device)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = render(bufs, params, default_settings(), cache)
    lights = pbr.shade_lights.lights
    pipeline.check_stats(stats)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "_lights", lights_loop)
        want, _ = render(bufs, params, default_settings(), cache)
    return img, want, calls.get("shade_lights", []), lights


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_cached_raster_frame_equals_the_per_light_loop(case):
    """The Cornell cached raster frame with 16 seeded lights: one K15 call
    a frame with the frame's light count (static_point_lights, 16 or 5),
    and the frame bit-equal to the one the per-light loop lights."""
    fields, spots, static = FRAME_CASES[case]
    bufs = build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device="cpu")
    params = default_scene_params(aspect=CORNELL_W / CORNELL_H)
    params.camera = make_camera([0.0, 3.0, 1.0], [-15.0, -90.0], CORNELL_W / CORNELL_H)
    params.point_lights = seeded_lights(20 + len(case), spots)
    config = RenderConfig(width=CORNELL_W, height=CORNELL_H, shadow_size=CORNELL_SHADOW,
                          static_point_lights=static, **fields)
    img, want, calls, lights = cached_frames(bufs, params, config, "cpu")
    assert len(calls) == 1 and calls[0][1]["count"] == static
    assert lights == (16 if static is None else static)
    assert img.float().std() > 10 and torch.equal(img, want)


# ------------------------------------------------------------------- the scene


def scene_digest(scene) -> str:
    """sha256 over every array of a (meshes, objects, materials, env) scene
    (dtype, shape and bytes) and its material and mesh indices."""
    meshes, objects, materials, env = scene
    h = hashlib.sha256()

    def add(a):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())

    for m in meshes:
        for a in (m.positions, m.normals, m.uvs, m.indices, m.tangents, m.bitangents):
            if a is not None:
                add(a)
        h.update(str(m.material).encode())
    for trs, mesh in objects:
        add(trs)
        h.update(str(mesh).encode())
    for mat in materials:
        for a in (mat.diffuse, mat.normal, mat.metal_roughness):
            add(a)
    add(env)
    return h.hexdigest()


def test_sponza_like_scene_keeps_its_closed_hall_by_default():
    """atrium=None gives the arrays of the scene before the atrium existed,
    byte for byte (the ray-traced cell's asset and its 251,500 triangles)."""
    scene = procedural.sponza_like_scene()
    assert scene_digest(scene) == (
        "4908d3e36c0f726f91ca146ce6d44c3dfb8c588662cc07d1418914deb1a3ae26")
    assert sum(len(scene[0][m].indices) for _, m in scene[1]) == 251500


def test_atrium_opens_the_ceiling_over_the_nave():
    """The atrium replaces the ceiling plane by four strips around the
    opening, facing down as it does; the rest of the scene is unchanged."""
    closed = procedural.sponza_like_scene(columns=2)
    meshes, objects, _, _ = procedural.sponza_like_scene(columns=2, atrium=(12.0, 4.5))
    ceiling = [trs for trs, m in objects if m == 5]
    assert len(ceiling) == 4 and len(objects) == len(closed[1]) + 3
    boxes = set()
    for trs in ceiling:
        (sx, sy, sz), (cx, cy, cz) = np.diag(trs)[:3], trs[:3, 3]
        assert sy == -1.0 and cy == 10.0
        boxes.add((cx - sx / 2, cx + sx / 2, cz - sz / 2, cz + sz / 2))
    assert boxes == {(-18.0, -12.0, -7.0, 7.0), (12.0, 18.0, -7.0, 7.0),
                     (-12.0, 12.0, -7.0, -4.5), (-12.0, 12.0, 4.5, 7.0)}
    rest = [(trs.tobytes(), m) for trs, m in objects if m != 5]
    assert rest == [(trs.tobytes(), m) for trs, m in closed[1] if m != 5]
    with pytest.raises(ValueError, match="atrium"):
        procedural.sponza_like_scene(columns=2, atrium=(18.0, 4.5))


# --------------------------------------------- the atrium against the reference

ATRIUM_SEED = 2**40 + 20
ATRIUM_W, ATRIUM_H, ATRIUM_SHADOW = 192, 128, 256
ATRIUM_PIXELS = 1024


@pytest.fixture(scope="module")
def atrium_frames():
    """The benchmark's sponza_1080p configuration cut to 4 columns a row,
    192 x 128 and a 256^2 map, with 16 lights and a viewpoint of its fly
    path drawn from ATRIUM_SEED: the program's cached frames with all 16
    lights and with the first 8 alone, and the reference's admissible
    colours at ATRIUM_PIXELS pixels drawn from the seed."""
    from render_bench import cell, reference, traffic
    from render_bench.entries import params as frame_params

    cfg = copy.deepcopy(cell.config("sponza_1080p"))
    rng = np.random.default_rng(ATRIUM_SEED)
    lights = [[list(rng.uniform((-10.0, 1.0, -4.0), (16.0, 4.0, 4.0))),
               list(rng.uniform(5.0, 40.0, 3))] for _ in range(MAX_POINT_LIGHTS)]
    cfg.update(resolution=[ATRIUM_W, ATRIUM_H], shadow_size=ATRIUM_SHADOW, lights=lights)
    mix = cell.traffic("lights16")
    spec = traffic.frame(traffic.path(cfg, mix, ATRIUM_SEED), mix, 0)
    assert len(spec["lights"]) == MAX_POINT_LIGHTS
    scene = procedural.sponza_like_scene(
        columns=4, **cfg["scene"]["args"])
    bufs = build.build_buffers(*scene, device="cpu")
    params, settings = frame_params(spec)
    config = RenderConfig(width=ATRIUM_W, height=ATRIUM_H, shadow_size=ATRIUM_SHADOW,
                          static_point_lights=16, shadow_tile=16, tile_h=8, tile_w=16)
    cache, _ = pipeline.build_sun_cache(bufs, params, config)
    frames = {}
    for n in (16, 8):
        img, stats = pipeline.render_frame_stats(
            bufs, params, settings, dataclasses.replace(config, static_point_lights=n), cache)
        pipeline.check_stats(stats)
        frames[n] = img
    idx = traffic.rng(ATRIUM_SEED, 2).choice(ATRIUM_W * ATRIUM_H, ATRIUM_PIXELS, replace=False)
    xs, ys = torch.as_tensor(idx % ATRIUM_W), torch.as_tensor(idx // ATRIUM_W)
    ref = reference.Scene(*scene, device="cpu")
    cand, mask = reference.render_pixels(ref, spec, torch.stack([xs, ys], 1))
    return cfg, frames, (xs, ys), (cand, mask)


def far_share(frame, pixels, admitted) -> float:
    """Share of the pixels whose every admitted reference colour lies more
    than check.FAR_LSB from the frame's in some channel."""
    from render_bench import check

    xs, ys = pixels
    err = check.errors(*admitted, frame[ys, xs])
    return float((err > check.FAR_LSB).double().mean())


def test_atrium_frame_with_16_lights_against_the_reference(atrium_frames):
    cfg, frames, pixels, admitted = atrium_frames
    assert frames[16].float().std() > 10
    assert far_share(frames[16], pixels, admitted) <= cfg["far_share_max"]


def test_the_reference_check_sees_lights_9_to_16(atrium_frames):
    """The program's frame without lights 9-16 is far from the reference's
    16-light colours on many times far_share_max of the pixels."""
    cfg, frames, pixels, admitted = atrium_frames
    assert far_share(frames[8], pixels, admitted) > 5 * cfg["far_share_max"]


# -------------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: K15 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spotlights", [False, True], ids=["cones_off", "cones_on"])
def test_raster_k15_equals_the_per_light_loop_on_the_card(cuda, spotlights):
    """The Cornell cached raster frame at 1920 x 1080 with 16 lights (every
    third a spotlight): K15 launched once, bit-equal to the frame the
    per-light loop lights on the card."""
    bufs = build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device=cuda)
    w, h = 1920, 1080
    params = default_scene_params(aspect=w / h)
    params.camera = make_camera([0.0, 3.0, 1.0], [-15.0, -90.0], w / h)
    params.point_lights = seeded_lights(7, True)
    config = RenderConfig(width=w, height=h, shadow_size=1024, static_point_lights=16,
                          spotlights=spotlights)
    img, want, calls, lights = cached_frames(bufs, params, config, cuda)
    torch.cuda.synchronize()
    assert len(calls) == 1 and lights == 16 and pbr.shade_lights.launches == 1
    assert img.float().std() > 10 and torch.equal(img, want)


# ------------------------------------------------- the captured front end


def cornell_cached_case(device, w, h, **fields):
    """The Cornell scene on ``device`` with 16 seeded lights, a config of
    w x h and its sun cache, and the params of five viewpoints."""
    bufs = build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device=device)
    config = RenderConfig(width=w, height=h, shadow_size=256, static_point_lights=16, **fields)
    views = []
    for k in range(5):
        p = default_scene_params(aspect=w / h)
        p.camera = make_camera([0.3 * k, 3.0, 1.0 + 0.2 * k], [-15.0 - k, -90.0 + 3 * k], w / h)
        p.point_lights = seeded_lights(40 + k, False)
        views.append(p)
    cache, _ = pipeline.build_sun_cache(bufs, views[0], config)
    return bufs, config, cache, views


def ints(stats):
    return {k: int(v) for k, v in stats.items()}


def test_cached_front_keeps_the_frame_on_the_cpu():
    """make_cached_renderer_stats on the CPU: its CachedFront runs
    front_end as it is (no graph, no replay), each frame and its stats
    equal render_frame_stats' own cached frame, across a second sun
    cache."""
    bufs, config, cache, views = cornell_cached_case("cpu", 96, 64)
    render = pipeline.make_cached_renderer_stats(config, "cpu")
    cache2, _ = pipeline.build_sun_cache(bufs, views[1], config)
    for p, c in ((views[0], cache), (views[1], cache), (views[2], cache2)):
        got, gst = render(bufs, p, default_settings(), c)
        want, wst = pipeline.render_frame_stats(bufs, p, default_settings(), config, c)
        assert torch.equal(got, want) and ints(gst) == ints(wst)
    assert (render.front.replays, render.front.captured) == (0, {})


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [{}, {"pcf_row_cap": 1536}], ids=["runs_pcf", "quantised"])
def test_captured_front_end_equals_the_eager_frame_on_the_card(cuda, fields):
    """make_cached_renderer_stats on the card (the front end eager on the
    first frame, captured on the second, replayed after) over five
    viewpoints and then a second sun cache: every frame bit-equal to the
    eager cached frame, and each frame's stats its own after later replays
    (copies, not the graph's outputs). A replayed frame calls K15's wrapper
    and no front-end wrapper; its front counts one replay of a capture
    that holds K1 and K4 once."""
    bufs, config, cache, views = cornell_cached_case(cuda, 512, 384, **fields)
    render = pipeline.make_cached_renderer_stats(config, cuda)
    cache2, _ = pipeline.build_sun_cache(bufs, views[3], config)
    runs = [(p, cache) for p in views] + [(p, cache2) for p in views[:3]]
    got = [render(bufs, p, default_settings(), c) for p, c in runs]
    torch.cuda.synchronize()
    for (p, c), (img, st) in zip(runs, got):
        want, wst = pipeline.render_frame_stats(bufs, p, default_settings(), config, c)
        assert torch.equal(img, want) and ints(st) == ints(wst)
    assert len({int(st["cam_pairs"]) for _, st in got}) > 1
    replays = render.front.replays
    kernels.reset_launch_counts()
    render(bufs, views[4], default_settings(), cache2)
    counts = kernels.launch_counts()
    assert counts["shade_lights"] == 1 and counts["raster_tiles"] == counts["select_interp"] == 0
    assert render.front.replays == replays + 1
    assert render.front.captured["raster_tiles"] == render.front.captured["select_interp"] == 1
