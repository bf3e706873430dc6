"""Shadow and camera tiles of every shape the JAX package renders
(RenderConfig.shadow_tile / shadow_tile_h, tile_h / tile_w) on the port's
CPU frame, at tests/test_cull.py's scene and camera: Cornell at 160x120
with a 256^2 map, eye (1, 0.5, 1), rotation (-30, -120), where the
sun-cull rect bites.

- The shadow pass against the JAX package's shadow_pass at shadow_tile=16
  (test_cull's tile) and at 24 wide x 16 high (no power-of-two 256-pixel
  rectangle tiles it): the sun-cull rect, the pair count and the cap
  equal; the map's coverage equal and its depths within the reference's
  raster tolerance of 2e-6 (tests/test_raster_tiles.py:17-23: JAX's raster
  kernel runs in interpret mode under XLA's CPU jit, which contracts
  (A*px + B*py) + C into FMAs; the port rounds each step). Two JAX calls,
  the only ones here (tiles_per_step=1, a scheduling knob, keeps interpret
  mode fast). The port's whole map (no cull rect) at either tile equals its
  64-tile map bit for bit.
- Frames are tile-invariant: the port's frame at each shadow tile (16 x 16,
  8 high x 16 wide, 16 x 24, 128 x 128) and camera tile (8 x 16, 1 x 128,
  128 x 128) is bit-equal to its 64 x 64 frame, as are the quantised and
  the deferred frame at the 16 x 24 shadow tile; measure_pair_counts gives
  each frame's pairs.
- The config: both fields carry over through config_from_dict and
  convert.render_config; the tiles the JAX package refuses on a path raise
  RenderError naming the rule; the brute-force frame takes any tile, the
  deferred frame a camera tile the fused frame refuses.
- Slabs: sharding.slab_layout gives the JAX package's slab rows
  (arctic_tpu/parallel/sharding.py:78-83) at shadow tiles 16 and 24 x 16,
  and the frame as 3 slabs at shadow_tile=16 equals the single frame and
  its map bit for bit.
Torch on one thread.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.config import RenderConfig as JRenderConfig
from arctic_tpu.core.scene import default_scene_params as j_default_params
from arctic_tpu.io import build as jbuild
from arctic_tpu.io import procedural as jproc
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu_torch.core.config import RenderConfig, check_tiles, config_from_dict
from arctic_tpu_torch.core.scene import default_settings
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.parallel import sharding
from arctic_tpu_torch.utils import convert, kernels
from arctic_tpu_torch.utils.errors import RenderError

W, H, S = 160, 120, 256
EYE, ROT = [1.0, 0.5, 1.0], [-30.0, -120.0]
# The shadow tiles held against the JAX package: (shadow_tile, shadow_tile_h).
JAX_TILES = [(16, None), (24, 16)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The suite runs test files in several processes at once; an
    oversubscribed torch thread pool slows these small CPU frames by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    jb = jbuild.build_buffers(*jproc.cornell_like_scene(), tri_bucket=256)
    p = j_default_params(aspect=W / H)
    jp = dataclasses.replace(p, camera=dataclasses.replace(
        p.camera, eye=jnp.asarray(EYE), rotation=jnp.asarray(ROT)))
    return dict(jax=(jb, jp), port=(convert.scene_buffers(jb), convert.scene_params(jp)))


def _config(**fields):
    return RenderConfig(width=W, height=H, shadow_size=S, **fields)


def _port_shadow_map(bufs, params, config):
    """The fused frame's shadow pass: (map, pairs, cap, sun-cull rect)."""
    geom = bufs.geometry
    wc = pipeline.world_corners(geom)
    tri_valid = torch.arange(geom.capacity) < geom.num_tris
    sun_pv = params.sun.proj_view()
    rect, _ = pipeline.sun_cull_rect(wc, tri_valid, params.camera.proj_view(), sun_pv, config)
    z, pairs, cap = pipeline.shadow_pass(geom, pipeline.corners_clip(wc, sun_pv), config, rect)
    return z, int(pairs), cap, [int(v) for v in rect]


@pytest.mark.parametrize("st, sth", JAX_TILES, ids=["16x16", "16hx24w"])
def test_shadow_pass_matches_jax(scene, st, sth):
    jb, jp = scene["jax"]
    jc = JRenderConfig(width=W, height=H, shadow_size=S, shadow_tile=st, shadow_tile_h=sth,
                       tiles_per_step=1)
    geom = jb.geometry
    wc = jpipe.world_corners(geom)
    tri_valid = jnp.arange(geom.capacity) < geom.num_tris
    sun_pv = jp.sun.proj_view()
    jrect = jpipe.sun_cull_rect(wc, tri_valid, jp.camera.proj_view(), sun_pv, jc)
    jz, jpairs, jcap = jpipe.shadow_pass(geom, sun_pv, jc, sun_clip=jpipe.corners_clip(wc, sun_pv),
                                         cull_rect=jrect)
    jz = np.asarray(jz)

    config = convert.render_config(jc)
    assert (config.shadow_tile, config.shadow_th) == (st, sth or st)
    z, pairs, cap, rect = _port_shadow_map(*scene["port"], config)
    assert rect == [int(v) for v in jrect]
    assert (pairs, cap) == (int(jpairs), jcap) and pairs > 0
    assert z.shape == jz.shape == (S, S)
    np.testing.assert_array_equal(z.numpy() < 1.0, jz < 1.0)
    assert int((jz < 1.0).sum()) > 500
    np.testing.assert_allclose(z.numpy(), jz, rtol=0, atol=2e-6)
    geom = scene["port"][0].geometry
    clip = pipeline.corners_clip(pipeline.world_corners(geom), scene["port"][1].sun.proj_view())
    whole = pipeline.shadow_pass(geom, clip, config)[0]  # no rect: every tile
    assert torch.equal(whole, pipeline.shadow_pass(geom, clip, _config())[0])


# Each case: (the path's config fields, the tile's fields).
PATHS = {"default": {}, "quant": dict(pcf_row_cap=W * H // 128), "deferred": dict(fused_shade=False)}
FRAME_CASES = {
    "shadow_16x16": ("default", dict(shadow_tile=16)),
    "shadow_8hx16w": ("default", dict(shadow_tile=16, shadow_tile_h=8)),
    "shadow_16hx24w": ("default", dict(shadow_tile=24, shadow_tile_h=16)),
    "shadow_128x128": ("default", dict(shadow_tile=128)),
    "camera_8x16": ("default", dict(tile_h=8, tile_w=16)),
    "camera_1x128": ("default", dict(tile_h=1, tile_w=128)),
    "camera_128x128": ("default", dict(tile_h=128, tile_w=128)),
    "quant_shadow_16hx24w": ("quant", dict(shadow_tile=24, shadow_tile_h=16)),
    "deferred_shadow_16hx24w": ("deferred", dict(shadow_tile=24, shadow_tile_h=16)),
}


@pytest.fixture(scope="module")
def base_frames(scene):
    """The 64 x 64 frame of each path."""
    bufs, params = scene["port"]
    return {path: pipeline.render_frame_stats(bufs, params, default_settings(), _config(**f))[0]
            for path, f in PATHS.items()}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frame_is_tile_invariant(scene, base_frames, case):
    path, tile = FRAME_CASES[case]
    bufs, params = scene["port"]
    config = _config(**PATHS[path], **tile)
    img, stats = pipeline.render_frame_stats(bufs, params, default_settings(), config)
    pipeline.check_stats(stats)
    assert img.shape == (H, W, 3) and float(img.float().std()) > 10
    assert torch.equal(img, base_frames[path])
    assert pipeline.measure_pair_counts(bufs, params, config) == (
        int(stats["cam_pairs"]), int(stats["shadow_pairs"]))


def test_config_carries_both_fields():
    fields = dict(shadow_tile=24, shadow_tile_h=16)
    want = RenderConfig(**fields)
    assert config_from_dict(fields) == want
    assert convert.render_config(JRenderConfig(**fields)) == want
    jc = JRenderConfig(shadow_size=S, **fields)
    sth = jc.shadow_tile_h or jc.shadow_tile
    config = convert.render_config(jc)
    assert (config.shadow_th, config.shadow_tiles_x, config.shadow_tiles_y) == (
        sth, -(-S // jc.shadow_tile), -(-S // sth))
    assert RenderConfig().shadow_th == RenderConfig().shadow_tile == JRenderConfig().shadow_tile


# Tiles the JAX package refuses: (config fields, ranks of a sharded frame
# or None, the rule named).
REFUSED = {
    "camera_8x8": (dict(tile_h=8, tile_w=8), None, "128-pixel rows"),
    "camera_64x48_fused": (dict(tile_w=48), None, "divide a 128-pixel row"),
    "camera_64x48_slabs": (dict(tile_w=48, fused_shade=False), 2, "divide a 128-pixel row"),
    "shadow_24x24": (dict(shadow_tile=24), None, "128-pixel rows"),
    "shadow_4hx16w": (dict(shadow_tile=16, shadow_tile_h=4), None, "128-pixel rows"),
    "shadow_deferred_24x24": (dict(shadow_tile=24, fused_shade=False), None, "128-pixel rows"),
    "shadow_1024_across": (dict(shadow_size=1024, shadow_tile=1, shadow_tile_h=128), None,
                           "at most 512 across"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_tiles_the_jax_package_refuses_raise(scene, case):
    """The JAX package's asserts (core/config.check_tiles): a binned
    pass's tile fills whole 128-pixel rows (raster_tiles.py:925), the fused
    and the sharded frame's camera tile divides one (:814), and binning
    takes at most 512 tiles across (binning.py:228). The frame raises
    before any work."""
    fields, world, rule = REFUSED[case]
    config = dataclasses.replace(_config(), **fields)
    bufs, params = scene["port"]
    with kernels.record_calls() as calls, pytest.raises(RenderError, match=rule):
        if world is None:
            pipeline.render_frame_stats(bufs, params, default_settings(), config)
        else:
            sharding.render_frame_slabs_stats(bufs, params, default_settings(), config, world)
    assert calls == {}
    with pytest.raises(RenderError, match=rule):
        check_tiles(config, world=world)


def test_bruteforce_and_deferred_take_other_tiles(scene):
    """The brute-force frame bins nothing and takes any tile; the deferred
    frame takes a camera tile the fused frame refuses (64 x 48, whole
    128-pixel rows): each renders its frame at the 64 x 64 tile."""
    bufs, params = scene["port"]
    s = default_settings()
    odd = dict(tile_h=8, tile_w=8, shadow_tile=24)
    for path, tile in ((dict(force_bruteforce=True), odd),
                       (dict(fused_shade=False), dict(tile_w=48))):
        check_tiles(_config(**path, **tile))
        want, _ = pipeline.render_frame_stats(bufs, params, s, _config(**path))
        got, stats = pipeline.render_frame_stats(bufs, params, s, _config(**path, **tile))
        pipeline.check_stats(stats)
        assert torch.equal(got, want)


@pytest.mark.parametrize("st, sth", JAX_TILES, ids=["16x16", "16hx24w"])
def test_slab_layout_at_shadow_tiles(st, sth):
    jc = JRenderConfig(width=W, height=H, shadow_size=S, shadow_tile=st, shadow_tile_h=sth)
    for world in (2, 3, 8):
        layout = sharding.slab_layout(convert.render_config(jc), world)
        sth_j = jc.shadow_tile_h or jc.shadow_tile  # sharding.py:78-83
        sh_tile_rows = -(-(-(-S // sth_j)) // world) * world
        assert (layout.sh_tile_rows, layout.sh_rows) == (sh_tile_rows, sh_tile_rows // world)
        cam_tile_rows = -(-(-(-H // jc.tile_h)) // world) * world
        assert (layout.cam_tile_rows, layout.cam_rows) == (cam_tile_rows, cam_tile_rows // world)


def test_slabs_at_shadow_tile_16_equal_single_frame(scene):
    bufs, params = scene["port"]
    s = default_settings()
    config = _config(shadow_tile=16)
    single, _ = pipeline.render_frame_stats(bufs, params, s, config)
    with kernels.record_calls() as calls:
        img, stats, smap = sharding.render_frame_slabs_with_map(bufs, params, s, config, 3)
    pipeline.check_stats(stats)
    layout = sharding.slab_layout(config, 3)
    assert [kw["row0"] for _, kw in calls["raster_tiles"][:3]] == [
        r * layout.sh_rows * 16 for r in range(3)]
    assert torch.equal(img, single)
    assert torch.equal(smap, _port_shadow_map(bufs, params, config)[0])
