"""The deferred and brute-force frames of arctic_tpu_torch against the JAX
package: the combined-table material sample, the deferred skybox, the
per-slot shade table, the brute-force raster, the brute-force frame, and
the port's three frames against each other.

Cornell at 160x120 with a 200^2 shadow map, the camera and two point
lights of test_fused_shade.py; one JAX frame (brute force, which reaches
no Pallas kernel, jitted: here its FMA contraction moves no pixel beyond
the gate). Tolerances:
- the material sample is bit-equal to JAX's sample_atlas_multi on the
  per-slot atlas (the same bf16 texels through the same f32 lerps);
- the skybox is within 1e-5 relative of JAX's (atan2 / asin of two
  libraries, as test_torch_shading's skybox check);
- the shade table's barycentric planes and attributes are within 1e-5
  relative (ROADMAP's exactness budget: the port's per-corner n / t / b
  were normalised in numpy at build time, JAX's per vertex in the frame),
  its material lanes equal;
- the brute-force ibuf is equal on JAX's own setup (tiled == brute force);
- the brute-force frame is within 1 u8 LSB of JAX's on < 1% of the pixels
  (test_torch_pipeline's gate), the deferred frame equal to it (one
  visibility buffer, one shade), the fused frame within 1 LSB on < 1%
  (test_fused_shade's bound).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.config import RenderConfig as JRenderConfig
from arctic_tpu.core.scene import PointLights as JPointLights
from arctic_tpu.core.scene import default_scene_params as j_default_params
from arctic_tpu.core.scene import default_settings as j_default_settings
from arctic_tpu.io import build as jbuild
from arctic_tpu.io import procedural as jproc
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu.ops import raster as jraster
from arctic_tpu.ops import sampling as jsampling
from arctic_tpu.ops import sky as jsky
from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import raster, sampling, sky
from arctic_tpu_torch.utils import convert, kernels

W, H, SHADOW = 160, 120, 200
EYE, ROT = [0.0, 4.0, 3.0], [-25.0, -90.0]
LIGHTS = [((0.0, 1.0, 0.0), (10.0, 0.0, 0.0)), ((3.0, 2.0, -6.0), (0.0, 6.0, 12.0))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several test
    processes at once, and an oversubscribed torch thread pool slows these
    small CPU frames by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene(scene_fn=jproc.cornell_like_scene, eye=EYE, rot=ROT, lights=LIGHTS):
    jb = jbuild.build_buffers(*scene_fn(), tri_bucket=256)
    p = j_default_params(aspect=W / H)
    p = dataclasses.replace(
        p, camera=dataclasses.replace(p.camera, eye=jnp.asarray(eye), rotation=jnp.asarray(rot)),
        point_lights=JPointLights.from_list(list(lights)),
    )
    return jb, p, j_default_settings()


@pytest.fixture(scope="module")
def scene():
    jb, jp, js = _jax_scene()
    return dict(jax=(jb, jp, js),
                port=(convert.scene_buffers(jb), convert.scene_params(jp), convert.settings(js)))


@pytest.fixture(scope="module")
def frames(scene):
    """The JAX brute-force frame and the port's brute-force, deferred and
    fused frames with their stats, and the kernel-wrapper calls each port
    frame made (``calls``)."""
    jb, jp, js = scene["jax"]
    jc = JRenderConfig(width=W, height=H, shadow_size=SHADOW, force_bruteforce=True)
    jimg, jstats = jax.jit(jpipe.render_frame_stats, static_argnums=3)(jb, jp, js, jc)
    out = {"jax": (np.asarray(jimg), {k: int(v) for k, v in jstats.items()}), "calls": {}}
    tb, tp, ts = scene["port"]
    for name, kw in (("bruteforce", dict(force_bruteforce=True)),
                     ("deferred", dict(fused_shade=False)), ("fused", {})):
        config = RenderConfig(width=W, height=H, shadow_size=SHADOW, **kw)
        with kernels.record_calls() as calls:
            img, stats = pipeline.render_frame_stats(tb, tp, ts, config)
        out[name] = (img.numpy(), {k: int(v) for k, v in stats.items()})
        out["calls"][name] = {k: len(v) for k, v in calls.items()}
    return out


def _lsb_gate(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("scene_name", ["cornell", "helmet"])
def test_combined_sample_equals_jax_sample_atlas_multi(scene_name):
    """Every material's slots sampled from the combined quad rows equal the
    JAX package's per-slot sample_atlas_multi bit for bit, at seeded uv
    inside and outside [0, 1) (wrap)."""
    fn = {"cornell": jproc.cornell_like_scene, "helmet": jproc.helmet_like_scene}[scene_name]
    jb = jbuild.build_buffers(*fn(), tri_bucket=256)
    ja, ta = jb.atlas, convert.scene_buffers(jb).atlas
    slots = list(ta.combined_slots)
    assert slots == [0] + ([] if ja.nm_constant else [1]) + ([] if ja.mr_constant else [2])
    rng = np.random.default_rng(3)
    uv = rng.uniform(-2.5, 3.5, (777, 2)).astype(np.float32)
    uv[:40] = rng.uniform(0.0, 1.0, (40, 2))  # and exact texel-grid corners
    uv[40:48] = [[0, 0], [1, 1], [0.5, 0.25], [-1, 2], [0.999, 0.001], [1e-7, -1e-7], [3, -3], [0.25, 0.75]]
    regions = np.asarray(ja.regions)
    for m, creg in enumerate(np.asarray(ja.combined_regions)):
        want = np.asarray(jsampling.sample_atlas_multi(
            ja, jnp.asarray(np.broadcast_to(regions[m, slots], (len(uv), len(slots), 4))),
            jnp.asarray(uv),
        ))  # (n, slots, 4)
        planes = [torch.full((len(uv),), float(v)) for v in creg]
        got = sampling.sample_atlas_multi(ta, *planes, torch.from_numpy(uv[:, 0]),
                                          torch.from_numpy(uv[:, 1])).numpy()
        np.testing.assert_array_equal(got.T.reshape(len(uv), len(slots), 4), want,
                                      err_msg=f"{scene_name} material {m}")


def test_deferred_skybox_matches_jax(scene):
    """The deferred frame's background (camera rays on the (H, W) pixel
    centres, then the skybox lookup) against JAX's camera_ray_directions +
    sample_environment."""
    jb, jp, _ = scene["jax"]
    tb, tp, _ = scene["port"]
    want = np.asarray(jsky.sample_environment(
        jb.environment, jsky.camera_ray_directions(jp.camera, H, W)))  # (H, W, 3)
    px, py = raster.pixel_centers(H, W)
    e = tb.environment
    got = sky.sample_environment_cf(pipeline.env_rows_bf16(tb), e.block_grid, e.region,
                                    *sky.camera_ray_dirs_cf(tp.camera, px, py, W, H))
    got = torch.stack(got, dim=-1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_shade_table_matches_jax_lanes(scene):
    """build_shade_table on JAX's own camera setup (convert.tri_setup) equals
    JAX's build_shade_table lane by lane over the valid slots: planes and
    attributes to 1e-5 relative, the material lanes [51:70) exactly."""
    jb, jp, _ = scene["jax"]
    tb = scene["port"][0]
    jg = jb.geometry
    world = jpipe.vertex_world_positions(jg)
    clip = jpipe.to_clip(world, jp.camera.proj_view())
    tri_valid = jnp.arange(jg.capacity) < jg.num_tris
    jsetup = jraster.setup_screen_triangles(
        jraster.near_clip_triangles(clip, jg.indices, tri_valid), W, H, cull="back")
    want = np.asarray(jpipe.build_shade_table(jsetup, jg, jb.atlas, world))  # (P, 128)
    got = pipeline.build_shade_table(
        convert.tri_setup(jsetup), tb.geometry, pipeline.world_corners(tb.geometry)
    ).numpy().T  # (P, 74)
    valid = np.asarray(jsetup.valid)
    assert valid.sum() > 100
    for lane in range(51):
        # Relative to the value, or to the lane's scale where a blend cancels.
        w_ = want[valid, lane]
        floor = 1e-3 * np.abs(w_).max()
        np.testing.assert_allclose(got[valid, lane], w_, rtol=1e-5, atol=1e-5 * floor,
                                   err_msg=f"lane {lane}")
    np.testing.assert_array_equal(got[valid, 51:70], want[valid, 51:70])


def test_bruteforce_ibuf_equals_jax_on_its_setup(scene):
    jb, jp, _ = scene["jax"]
    jg = jb.geometry
    wc = jpipe.world_corners(jg)
    tri_valid = jnp.arange(jg.capacity) < jg.num_tris
    jsetup = jraster.setup_screen_triangles(
        jraster.near_clip_corners(jpipe.corners_clip(wc, jp.camera.proj_view()), tri_valid),
        W, H, cull="back")
    jz, jibuf = jax.jit(jraster.rasterize_bruteforce, static_argnums=(1, 2))(jsetup, H, W)
    z, ibuf = raster.rasterize_bruteforce(convert.tri_setup(jsetup), H, W)
    np.testing.assert_array_equal(ibuf.numpy(), np.asarray(jibuf))
    assert (ibuf >= 0).float().mean() > 0.3
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))


def test_bruteforce_frame_within_one_lsb_of_jax(frames):
    img, jimg = frames["bruteforce"][0], frames["jax"][0]
    assert img.shape == jimg.shape == (H, W, 3) and img.dtype == np.uint8
    max_lsb, frac = _lsb_gate(img, jimg)
    assert max_lsb <= 1 and frac < 0.01, (max_lsb, frac)
    assert img.std() > 10


def test_bruteforce_stats_equal_jax(frames):
    """No pair buffer: 0 pairs of a cap of 1 in both passes, no penumbra
    classification."""
    assert frames["bruteforce"][1] == frames["jax"][1]
    assert frames["bruteforce"][1]["cam_pair_cap"] == 1
    pipeline.check_stats(frames["bruteforce"][1])


def test_deferred_frame_equals_bruteforce(frames):
    np.testing.assert_array_equal(frames["deferred"][0], frames["bruteforce"][0])
    stats = frames["deferred"][1]
    pipeline.check_stats(stats)
    assert 0 < stats["cam_pairs"] <= stats["cam_pair_cap"]
    assert stats["pcf_rows"] == 0 and stats["pcf_row_cap"] == 1


def test_frames_call_their_kernel_wrappers(frames):
    """The brute-force frame calls no kernel wrapper (its PCF and lights are
    the plain versions); the deferred frame K1 for its two passes, K16 for
    its PCF and K15 for its lights; the fused frame K16 once."""
    assert frames["calls"]["bruteforce"] == {}
    assert frames["calls"]["deferred"] == {"raster_tiles": 2, "pcf_runs": 1, "shade_lights": 1}
    assert frames["calls"]["fused"]["pcf_runs"] == 1


def test_fused_frame_within_one_lsb_of_bruteforce(frames):
    max_lsb, frac = _lsb_gate(frames["fused"][0], frames["bruteforce"][0])
    assert max_lsb <= 1 and frac < 0.01, (max_lsb, frac)


def test_deferred_shadow_pass_is_uncull(scene):
    """The deferred frame renders the whole shadow map: its pair count is
    measure_pair_counts' under fused_shade=False, and no smaller than the
    fused frame's culled count; pcf_row_capacity is 1 outside the fused
    frame whatever pcf_row_cap says."""
    tb, tp, ts = scene["port"]
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, fused_shade=False,
                          pcf_row_cap=4096)
    _, stats = pipeline.render_frame_stats(tb, tp, ts, config)
    cam, sh = pipeline.measure_pair_counts(tb, tp, config)
    assert (cam, sh) == (int(stats["cam_pairs"]), int(stats["shadow_pairs"]))
    assert sh >= pipeline.measure_pair_counts(tb, tp, dataclasses.replace(config, fused_shade=True))[1]
    assert pipeline.pcf_row_capacity(config) == 1
    assert pipeline.pcf_row_capacity(dataclasses.replace(config, fused_shade=True)) > 1
    assert pipeline.pcf_row_capacity(dataclasses.replace(config, fused_shade=True,
                                                         force_bruteforce=True)) == 1


def test_debug_overflow_logs_the_pass(scene, caplog):
    """debug_overflow: an undersized camera pair buffer is named in a
    warning from render_frame_stats, with its pairs and cap; without the
    flag nothing is logged, and check_stats raises either way."""
    tb, tp, ts = scene["port"]
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, tile_h=1, tile_w=128,
                          pair_cap_cam=1, fused_shade=False)
    with caplog.at_level(logging.WARNING):
        _, stats = pipeline.render_frame_stats(tb, tp, ts, config)
    assert int(stats["cam_pairs"]) > int(stats["cam_pair_cap"]) == 1024
    assert not caplog.records
    with caplog.at_level(logging.WARNING):
        _, stats = pipeline.render_frame_stats(
            tb, tp, ts, dataclasses.replace(config, debug_overflow=True))
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1 and msgs[0].startswith(
        f"cam pass: {int(stats['cam_pairs'])} tile-triangle pairs > capacity 1024"), msgs
    with pytest.raises(pipeline.RenderError, match="cam pass overflowed"):
        pipeline.check_stats(stats)


def test_deferred_refuses_the_tile_atlas(scene):
    """As the JAX package's shade: the deferred frame has no tile-atlas
    sampler."""
    from arctic_tpu_torch.io import build, procedural

    bufs = build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device="cpu",
                               tile_threshold_texels=0)
    _, tp, ts = scene["port"]
    with pytest.raises(pipeline.RenderError, match="tile-atlas"):
        pipeline.render_frame_stats(bufs, tp, ts, RenderConfig(width=64, height=64, shadow_size=64,
                                                               fused_shade=False))
