"""The fused frame on the quantised PCF path (RenderConfig.pcf_row_cap) and
the sun cache, through arctic_tpu_torch against the JAX package.

The frame of tests/test_lut_rows.py (Cornell, 128x128, shadow map 192^2,
eye (0, 4, 3), rotation (-25, -90), pcf_row_cap=4096): the JAX package
takes its lut_rows route (row-major shadow raster -> quantised window LUT ->
penumbra classification -> _pcf_eval_kernel), its Pallas kernels in
interpret mode; the port takes the same path on the CPU through its
kernels' plain versions.

Tolerances: frames within 1 u8 LSB on < 1% of the pixels (as
tests/test_torch_pipeline.py: the JAX kernels contract FMAs in interpret
mode); stats equal, pcf_rows included; the cap does not change a pixel
(test_fused_shade.py:69-93); a cached-sun frame within 1 LSB of the
uncached one (0 is expected: the cached arrays hold the values the frame
reads); the port's cache against JAX's: the shadow map within the
reference's raster tolerance of 2e-6 (test_raster_tiles.py:17-23), the
window table and the pyramid within one quantum (measured: equal).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import default_scene_params, default_settings
from arctic_tpu.io.build import build_buffers
from arctic_tpu.io.procedural import cornell_like_scene
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu_torch.core.scene import DirectionalLight
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.utils import convert

W = H = 128
S = 192


def _lsb(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def _ints(stats):
    return {k: int(v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def scene():
    bufs = build_buffers(*cornell_like_scene(), tri_bucket=256)
    base = default_scene_params(aspect=1.0)
    params = dataclasses.replace(
        base,
        camera=dataclasses.replace(
            base.camera, eye=jnp.asarray([0.0, 4.0, 3.0]), rotation=jnp.asarray([-25.0, -90.0])
        ),
    )
    settings = default_settings()
    config = RenderConfig(width=W, height=H, shadow_size=S, pcf_row_cap=4096)
    return dict(
        jax=(bufs, params, settings, config),
        port=(convert.scene_buffers(bufs), convert.scene_params(params),
              convert.settings(settings), convert.render_config(config)),
    )


@pytest.fixture(scope="module")
def frames(scene):
    jimg, jstats = jpipe.render_frame_stats(*scene["jax"])
    timg, tstats = pipeline.render_frame_stats(*scene["port"])
    return dict(jax=(np.asarray(jimg), _ints(jstats)), port=(timg.numpy(), _ints(tstats)))


def test_quant_frame_within_one_lsb_of_jax(frames):
    jimg, timg = frames["jax"][0], frames["port"][0]
    assert timg.shape == jimg.shape == (H, W, 3)
    max_lsb, frac = _lsb(timg, jimg)
    assert max_lsb <= 1 and frac < 0.01, (max_lsb, frac)
    assert timg.mean() > 20


def test_quant_frame_stats_equal_jax(frames):
    stats = frames["port"][1]
    assert stats == frames["jax"][1]
    pipeline.check_stats(stats)
    assert 0 < stats["pcf_rows"] < stats["pcf_row_cap"] == W * H // 128  # classification fired


def test_cull_rect_and_band_match_jax(scene):
    """The shadow pass's tile rect and the in-frame table's start_y band
    equal the JAX package's shadow_cull_rect on the frame's matrices."""
    from arctic_tpu.ops import cull as jcull

    bufs, params, settings, config = scene["port"]
    geom = bufs.geometry
    wc = pipeline.world_corners(geom)
    tri_valid = torch.arange(geom.capacity) < geom.num_tris
    cam_pv, sun_pv = params.camera.proj_view(), params.sun.proj_view()
    rect, band = pipeline.sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config)
    lo, hi = pipeline.scene_aabb(wc, tri_valid)
    jrect, jband = jcull.shadow_cull_rect(
        *(jnp.asarray(t.numpy()) for t in (cam_pv, sun_pv, lo, hi)), S, config.shadow_th,
        config.shadow_tile, with_y_band=True,
    )
    assert [int(v) for v in rect] == [int(v) for v in jrect]
    assert band.dtype == torch.int32 and band.tolist() == [int(v) for v in jband]
    assert 0 <= band[0] <= band[1] <= S


def test_quant_frame_cap_invariant(scene, frames):
    """A tight but sufficient cap renders the full cap's frame bit for bit."""
    bufs, params, settings, config = scene["port"]
    used = frames["port"][1]["pcf_rows"]
    tight = dataclasses.replace(config, pcf_row_cap=-(-used // 32) * 32)
    img, stats = pipeline.render_frame_stats(bufs, params, settings, tight)
    pipeline.check_stats(stats)
    assert stats["pcf_row_cap"] < frames["port"][1]["pcf_row_cap"]
    np.testing.assert_array_equal(img.numpy(), frames["port"][0])


def test_quant_frame_overflow_raises(scene, frames):
    bufs, params, settings, config = scene["port"]
    assert frames["port"][1]["pcf_rows"] > 32
    _, stats = pipeline.render_frame_stats(
        bufs, params, settings, dataclasses.replace(config, pcf_row_cap=32)
    )
    assert int(stats["pcf_rows"]) > int(stats["pcf_row_cap"]) == 32
    with pytest.raises(pipeline.RenderError, match="penumbra rows overflowed"):
        pipeline.check_stats(stats)


def test_sun_cache_matches_uncached(scene, frames):
    """The cached frame is the uncached one; a moved sun with a rebuilt
    cache changes the frame (no stale plumbing)."""
    bufs, params, settings, config = scene["port"]
    cache, cstats = pipeline.make_sun_cache_builder(config, device="cpu")(bufs, params)
    assert cache.lutq is not None and cache.pyramid is not None
    assert int(cstats["shadow_pairs"]) <= int(cstats["shadow_pair_cap"])
    render = pipeline.make_cached_renderer_stats(config, device="cpu")
    img, stats = render(bufs, params, settings, cache)
    pipeline.check_stats(stats)
    assert _lsb(img.numpy(), frames["port"][0])[0] == 0

    moved = dataclasses.replace(
        params, sun=DirectionalLight(params.sun.position, torch.tensor([-35.0, 80.0]), params.sun.color)
    )
    cache2, _ = pipeline.build_sun_cache(bufs, moved, config)
    img2, _ = render(bufs, moved, settings, cache2)
    assert _lsb(img2.numpy(), img.numpy())[0] > 4


def test_sun_cache_default_config_skips_table_and_pyramid(scene):
    bufs, params, settings, config = scene["port"]
    config = dataclasses.replace(config, pcf_row_cap=None)
    cache, _ = pipeline.build_sun_cache(bufs, params, config)
    assert cache.lutq is None and cache.pyramid is None
    img_u, _ = pipeline.render_frame_stats(bufs, params, settings, config)
    img_c, stats = pipeline.render_frame_stats(bufs, params, settings, config, cache)
    pipeline.check_stats(stats)
    assert _lsb(img_c.numpy(), img_u.numpy())[0] <= 1


def test_sun_cache_matches_jax(scene):
    jcache, jstats = jpipe.build_sun_cache(*(scene["jax"][i] for i in (0, 1, 3)))
    want = convert.sun_cache(jcache)
    got, stats = pipeline.build_sun_cache(*(scene["port"][i] for i in (0, 1, 3)))
    assert _ints(stats) == _ints(jstats)
    assert got.shadow_map.shape == want.shadow_map.shape == (S, S)
    assert float((got.shadow_map - want.shadow_map).abs().max()) <= 2e-6
    assert torch.equal(got.lutq.to(torch.int32), want.lutq.to(torch.int32))
    assert torch.equal(got.pyramid, want.pyramid)
