"""The per-slot and the unmerged combined texture routes of arctic_tpu_torch
against the JAX package.

Scenes: Cornell with each normal map replaced by one of half its diffuse
map's size (procedural.per_slot_materials: the materials combine into no
shared quad, so both packages build the per-slot atlas), and Cornell built
with atlas_dtype=float32 (its combined quads then differ in type from the
bf16 environment rows: the unmerged combined tap). 96x64, shadow map 96^2,
the entry camera. One JAX frame per route: the brute-force frame rendered
eagerly, which reaches no Pallas kernel. Tolerances:
- the builds are equal leaf by leaf (the same numpy body; bf16 tables
  rounded to nearest-even by both);
- sample_quads_flat is bit-equal to JAX's on the same tables and planes
  (the same texels through the same f32 lerps);
- the port's fused, deferred and brute-force frames are within 1 u8 LSB of
  JAX's on < 1% of the values (test_torch_pipeline's gate);
- the fused frames on these routes launch K1, K3 and K4 and never K6 or K9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.config import RenderConfig as JRenderConfig
from arctic_tpu.core.scene import default_scene_params as j_default_params
from arctic_tpu.core.scene import default_settings as j_default_settings
from arctic_tpu.io import build as jbuild
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu.ops import sampling as jsampling
from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.io import build, procedural
from arctic_tpu_torch.models import golden, pipeline
from arctic_tpu_torch.ops import sampling
from arctic_tpu_torch.utils import convert, kernels

W, H, SHADOW = 96, 64, 96
EYE, ROT = [0.0, 4.0, 3.0], [-25.0, -90.0]
ROUTES = {"per_slot": (jnp.bfloat16, torch.bfloat16), "unmerged": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several test
    processes at once, and an oversubscribed torch thread pool slows these
    small CPU frames by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(route):
    meshes, objects, materials, env = procedural.cornell_like_scene()
    if route == "per_slot":
        materials = procedural.per_slot_materials(materials)
    return meshes, objects, materials, env


def _params():
    p = j_default_params(aspect=W / H)
    return dataclasses.replace(p, camera=dataclasses.replace(
        p.camera, eye=jnp.asarray(EYE), rotation=jnp.asarray(ROT)))


@pytest.fixture(scope="module", params=sorted(ROUTES))
def route(request):
    """(route, JAX buffers, port buffers, JAX brute-force frame)."""
    name = request.param
    jdt, tdt = ROUTES[name]
    scene = _scene(name)
    jb = jbuild.build_buffers(*scene, atlas_dtype=jdt, tri_bucket=256)
    tb = build.build_buffers(*scene, atlas_dtype=tdt, tri_bucket=256, device="cpu")
    config = JRenderConfig(width=W, height=H, shadow_size=SHADOW, force_bruteforce=True)
    with jax.disable_jit():
        frame = np.asarray(jpipe.render_frame(jb, _params(), j_default_settings(), config))
    return name, jb, tb, frame


def _bits(t):
    return convert.to_numpy(t)


def test_build_takes_the_route_and_matches_jax(route):
    name, jb, tb, _ = route
    ja, ta = jb.atlas, tb.atlas
    assert ta.tiles is None and ta.combined_env_rows is None
    assert (ta.nm_constant, ta.mr_constant) == (ja.nm_constant, ja.mr_constant)
    if name == "per_slot":
        assert ja.combined_slots is None and ta.combined_quads is None
        np.testing.assert_array_equal(_bits(ta.quads), np.asarray(ja.quads).view(np.uint16))
        assert ta.block_grid == ja.block_grid
    else:
        assert ta.quads is None and ta.combined_slots == tuple(ja.combined_slots)
        np.testing.assert_array_equal(_bits(ta.combined_quads), np.asarray(ja.combined_quads))
        assert ta.combined_block_grid == ja.combined_block_grid
    np.testing.assert_array_equal(_bits(tb.environment.rows),
                                  np.asarray(jb.environment.atlas.quads_packed).view(np.uint16))
    np.testing.assert_array_equal(_bits(tb.geometry.tri_matrow), np.asarray(jb.geometry.tri_matrow))
    np.testing.assert_array_equal(_bits(tb.geometry.tri_material),
                                  np.asarray(jb.geometry.tri_material))
    carried = convert.scene_buffers(jb)
    for field in ("quads", "combined_quads"):
        a, b = getattr(carried.atlas, field), getattr(ta, field)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), field


def test_sample_quads_flat_matches_jax(route):
    """The tap of every texture slot of every material at seeded uv, from
    the route's table, bit-equal to JAX's sample_quads_flat."""
    name, jb, tb, _ = route
    rng = np.random.default_rng(3)
    n = 2048
    u = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    if name == "per_slot":
        regions = np.asarray(jb.atlas.regions).reshape(-1, 4)
        quads, tquads, grid = jb.atlas.quads, tb.atlas.quads, jb.atlas.block_grid
    else:
        regions = np.asarray(jb.atlas.combined_regions)
        quads, tquads, grid = jb.atlas.combined_quads, tb.atlas.combined_quads, jb.atlas.combined_block_grid
    reg = regions[rng.integers(0, len(regions), n)].astype(np.float32)
    want = np.asarray(jsampling.sample_quads_flat(
        quads, grid, *(jnp.asarray(c) for c in reg.T), jnp.asarray(u), jnp.asarray(v)))
    got = sampling.sample_quads_flat(tquads, grid, *(torch.from_numpy(np.ascontiguousarray(c))
                                                     for c in reg.T),
                                     torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("frame", ["fused", "deferred", "bruteforce"])
def test_frames_within_one_lsb_of_jax(route, frame):
    name, _, tb, want = route
    fields = dict(fused=dict(), deferred=dict(fused_shade=False),
                  bruteforce=dict(force_bruteforce=True))[frame]
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, **fields)
    params, settings = convert.scene_params(_params()), convert.settings(j_default_settings())
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(tb, params, settings, config)
    pipeline.check_stats(stats)
    d = np.abs(img.numpy().astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    assert "tap_resolve" not in calls and "tile_tap_resolve" not in calls
    if frame == "fused":
        assert set(calls) == {"raster_tiles", "pack_shade_rows", "select_interp", "shade_lights",
                              "pcf_runs"}


def test_per_slot_frame_against_the_oracle():
    """The per-slot fused frame >= 40 dB against the f64 oracle, which
    samples the material images themselves."""
    scene = _scene("per_slot")
    tb = build.build_buffers(*scene, tri_bucket=256, device="cpu")
    params = convert.scene_params(_params())
    settings = convert.settings(j_default_settings())
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW)
    img, _ = pipeline.render_frame_stats(tb, params, settings, config)
    meshes, objects, materials, env = scene
    tris, mats = golden.golden_scene(meshes, objects, materials)
    cam = params.camera
    oracle = golden.render(
        tris, mats, env.astype(np.float64),
        dict(eye=cam.eye.tolist(), rotation=cam.rotation.tolist(), aspect=float(cam.aspect),
             fov_y=float(cam.fov_y), z_near=float(cam.z_near), z_far=float(cam.z_far)),
        dict(position=params.sun.position.tolist(), rotation=params.sun.rotation.tolist(),
             color=params.sun.color.tolist()),
        [(params.point_lights.position[0].tolist(), params.point_lights.color[0].tolist())],
        ambient=float(params.ambient),
        settings=dict(tm_method=settings.tm_method, gamma=float(settings.gamma),
                      exposure=float(settings.exposure)),
        width=W, height=H, shadow_size=SHADOW,
    )
    assert golden.psnr(img.numpy(), oracle) >= 40.0


def test_all_constant_maps_take_the_per_slot_atlas():
    """Materials whose normal and metal-roughness maps are all constant
    combine nothing (JAX's build leaves combined_slots None): both packages
    sample the diffuse slot of the per-slot atlas and take the constants."""
    meshes, objects, materials, env = procedural.cornell_like_scene()
    flat = [procedural.MaterialImages(m.diffuse, build.fallback_normal(), m.metal_roughness)
            for m in materials]
    jb = jbuild.build_buffers(meshes, objects, flat, env, tri_bucket=256)
    tb = build.build_buffers(meshes, objects, flat, env, tri_bucket=256, device="cpu")
    assert jb.atlas.combined_slots is None and tb.atlas.quads is not None
    assert tb.atlas.nm_constant and tb.atlas.mr_constant
    params = convert.scene_params(_params())
    settings = convert.settings(j_default_settings())
    fused, _ = pipeline.render_frame_stats(tb, params, settings,
                                           RenderConfig(width=W, height=H, shadow_size=SHADOW))
    deferred, _ = pipeline.render_frame_stats(
        tb, params, settings, RenderConfig(width=W, height=H, shadow_size=SHADOW, fused_shade=False))
    d = np.abs(fused.numpy().astype(np.int32) - deferred.numpy().astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01
