"""Pair-cap autotuning of arctic_tpu_torch against the JAX package.

The port counts (tile, slot) pairs through the front end its frame runs
(tri-major world corners, clip corners, near clip, the sun-cull rect),
which is the JAX package's fused render path. Run op by op (eager, no FMA
contraction on either side) the two give the same counts. Compiled, XLA
contracts multiply-adds into FMAs, and the JAX package's own
measure_pair_counts counts through its vertex front end
(vertex_world_positions, to_clip, near_clip_triangles) besides: on the
Sponza-class scene at 320x180 either moves a count by one pair at some
viewpoints (bench viewpoint 19 among them). So the port is held to the
eager fused path exactly, to the compiled paths within 1e-4, and its caps
(bucketed) equal JAX's. A frame rendered with
the tuned caps is the frame rendered with the formula's (capacity changes
no pixel while no pass overflows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.config import RenderConfig as JRenderConfig
from arctic_tpu.core.scene import PointLights as JPointLights
from arctic_tpu.core.scene import default_scene_params as j_default_params
from arctic_tpu.io import build as jbuild
from arctic_tpu.io import procedural as jproc
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu.ops import binning as jbinning
from arctic_tpu.ops import raster as jraster
from arctic_tpu.ops.cull import shadow_cull_rect as j_shadow_cull_rect
from arctic_tpu_torch.core.scene import default_scene_params, default_settings, make_camera
from arctic_tpu_torch.io import build, procedural
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import binning
from arctic_tpu_torch.utils import convert

# bench.py's viewpoint and light rig (bench.py:192-246), at a small frame.
CONFIG = JRenderConfig(width=320, height=180, shadow_size=512)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several test
    processes at once, and torch's thread pool, oversubscribed across them,
    slows these small CPU frames and counts by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _bench_params(i):
    p = j_default_params(aspect=CONFIG.width / CONFIG.height)
    return dataclasses.replace(
        p,
        camera=dataclasses.replace(p.camera, eye=jnp.asarray([-14.0 + 0.25 * i, 4.5, 0.0]),
                                   rotation=jnp.asarray([-8.0, 0.3 * i])),
        sun=dataclasses.replace(p.sun, position=jnp.asarray([0.0, 24.0, 0.0]),
                                rotation=jnp.asarray([-65.0, 30.0])),
        point_lights=JPointLights.from_list([((-6.0, 3.0, -4.0), (30.0, 20.0, 8.0))]),
    )


@pytest.fixture(scope="module")
def sponza():
    """The Sponza-class scene (251,500 tris), built by both packages."""
    scene = jproc.sponza_like_scene()
    return jbuild.build_buffers(*scene), build.build_buffers(*scene, device="cpu")


@pytest.mark.parametrize("rect", [None, (3, 1, 9, 6)])
def test_count_pairs_matches_jax(rect):
    """count_pairs on one setup (carried over bit for bit) with and
    without a tile rect."""
    rng = np.random.default_rng(0)
    clip = rng.uniform(-2.0, 2.0, (300, 4)).astype(np.float32)
    clip[:, 3] = rng.uniform(0.2, 3.0, 300)
    idx = rng.integers(0, 300, (256, 3)).astype(np.int32)
    valid = jnp.arange(256) < 200
    js = jraster.setup_screen_triangles(
        jraster.near_clip_triangles(jnp.asarray(clip), jnp.asarray(idx), valid), 640, 448,
        cull="back",
    )
    want = jbinning.count_pairs(js, 10, 7, 64, 64, rect=rect)
    trect = None if rect is None else tuple(torch.tensor(v) for v in rect)
    got = binning.count_pairs(convert.tri_setup(js), 10, 7, 64, 64, rect=trect)
    assert got.dtype == torch.int32 and int(got) == int(want) > 0


def _jax_fused_counts(jb, jp):
    """(camera, shadow) pairs that the JAX package's fused render path
    bins: its world_corners / corners_clip / near_clip_corners front end
    and its sun-cull rect."""
    geom = jb.geometry
    wc = jpipe.world_corners(geom)
    valid = jnp.arange(geom.capacity) < geom.num_tris
    cam_pv, sun_pv = jp.camera.proj_view(), jp.sun.proj_view()
    cam = jraster.setup_screen_triangles(
        jraster.near_clip_corners(jpipe.corners_clip(wc, cam_pv), valid),
        CONFIG.width, CONFIG.height, cull="back",
    )
    s = CONFIG.shadow_size
    sun = jraster.setup_screen_triangles(
        jraster.near_clip_corners(jpipe.corners_clip(wc, sun_pv), valid), s, s, cull="front"
    )
    lo, hi = jpipe.scene_aabb(wc, valid)
    rect = j_shadow_cull_rect(cam_pv, sun_pv, lo, hi, s, 64, 64)
    n = -(-s // 64)
    return (jbinning.count_pairs(cam, CONFIG.tiles_x, CONFIG.tiles_y, 64, 64),
            jbinning.count_pairs(sun, n, n, 64, 64, rect=rect))


def _close(got, want):
    return all(abs(g - w) <= 1e-4 * w for g, w in zip(got, want))


def test_pair_counts_equal_jax_fused_front_end(sponza):
    """One viewpoint: the port's counts are the JAX fused path's, op by op."""
    jb, tb = sponza
    jp = _bench_params(19)
    fused = tuple(int(c) for c in _jax_fused_counts(jb, jp))
    got = pipeline.measure_pair_counts(tb, convert.scene_params(jp), convert.render_config(CONFIG))
    assert got == fused and min(got) > 0


def test_measure_pair_counts_matches_jax(sponza):
    """A camera path (viewpoints 0, 10, 19): the element-wise max, within
    1e-4 of the JAX package's measure_pair_counts and of its compiled fused
    path."""
    jb, tb = sponza
    jp = [_bench_params(i) for i in (0, 10, 19)]
    fused = [[int(c) for c in jax.jit(_jax_fused_counts)(jb, p)] for p in jp]
    fused = (max(c for c, _ in fused), max(h for _, h in fused))
    got = pipeline.measure_pair_counts(tb, [convert.scene_params(p) for p in jp],
                                       convert.render_config(CONFIG))
    assert min(got) > 0 and _close(got, fused)
    assert _close(got, jpipe.measure_pair_counts(jb, jp, CONFIG))


def test_autotune_pair_caps_matches_jax(sponza):
    jb, tb = sponza
    jp = [_bench_params(i) for i in (0, 10, 19)]
    want = jpipe.autotune_pair_caps(jb, jp, CONFIG, margin=1.4)
    got = pipeline.autotune_pair_caps(tb, [convert.scene_params(p) for p in jp],
                                      convert.render_config(CONFIG), margin=1.4)
    assert (got.pair_cap_cam, got.pair_cap_shadow) == (want.pair_cap_cam, want.pair_cap_shadow)
    for kind in ("cam", "shadow"):
        assert got.pair_capacity(1000, kind) == want.pair_capacity(1000, kind)
    assert convert.render_config(want) == got


def test_tuned_caps_give_the_formula_frame():
    """Cornell at 256x192: the frame and the pair counts with tuned caps are
    those with the formula's caps; only the capacities differ."""
    config = convert.render_config(JRenderConfig(width=256, height=192, shadow_size=256))
    bufs = build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device="cpu")
    params = default_scene_params(aspect=256 / 192)
    params.camera = make_camera([0.0, 4.0, 3.0], [-25.0, -90.0], 256 / 192)
    tuned = pipeline.autotune_pair_caps(bufs, params, config, margin=1.4, bucket=1024)
    assert tuned.pair_cap_cam is not None and tuned.pair_cap_shadow is not None
    img, stats = pipeline.render_frame_stats(bufs, params, default_settings(), config)
    timg, tstats = pipeline.render_frame_stats(bufs, params, default_settings(), tuned)
    assert torch.equal(img, timg)
    assert int(tstats["cam_pairs"]) == int(stats["cam_pairs"]) > 0
    assert int(tstats["shadow_pairs"]) == int(stats["shadow_pairs"]) > 0
    assert tstats["cam_pair_cap"] < stats["cam_pair_cap"]
    assert tstats["shadow_pair_cap"] < stats["shadow_pair_cap"]
    pipeline.check_stats(tstats)
