"""The opt-in lights of arctic_tpu_torch (RenderConfig.spotlights and
ibl_specular), in the fused and the deferred frame, against the JAX
package and the port's f64 oracle; spotlight state files in both packages.

Frames are 160x120 with a 200^2 shadow map: Cornell with the point light
and the spotlight of test_spotlights.py, and the helmet with the camera of
test_fused_shade.py's IBL test, lit by a point row and a spotlight whose
cone edge crosses the helmet and the floor, under spotlights=True and
ibl_specular=True. One JAX frame: the helmet's brute-force frame with both
opt-ins (it reaches no Pallas kernel), rendered eagerly as the JAX tests
render it: under jit XLA contracts its multiply-adds into FMAs, which
moves two pixels of the IBL frame by 3 LSB through their shadow taps.
Tolerances, the JAX tests' own: all-point banks under spotlights=True are
bit-equal to the frame without the flag (the cone factor is exactly 1.0);
fused and deferred within 1 u8 LSB on < 1% of the pixels; the spot frame
>= 40 dB against the f64 oracle (test_golden_psnr's gate); the port's
fused and deferred spot + IBL frames within 1 LSB of JAX's on < 1%
(test_torch_pipeline's gate); the IBL lookup within 1e-5 relative of
JAX's (atan2 / asin of two libraries, as test_torch_shading's skybox
check); state files and the cone packing equal.
"""

import dataclasses
import json

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
from arctic_tpu.ops import sky as jsky
from arctic_tpu.utils import serialize as jserialize
from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import (
    PointLights,
    default_scene_params,
    default_settings,
    make_camera,
)
from arctic_tpu_torch.io import build, procedural
from arctic_tpu_torch.models import golden, pipeline
from arctic_tpu_torch.ops import sky
from arctic_tpu_torch.utils import convert, serialize

W, H, SHADOW = 160, 120, 200
# A bright spot above the Cornell boxes aimed straight down, and the
# parity red point light (tests/test_spotlights.py:29-30).
SPOT = ((0.0, 6.0, -5.0), (120.0, 120.0, 120.0), ((0.0, -1.0, 0.0), 20.0, 35.0))
POINT = ((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))
CORNELL_CAM = ([0.0, 4.0, 3.0], [-25.0, -90.0])
HELMET_CAM = ([0.0, 2.2, 0.5], [-8.0, -90.0])
# Above the helmet (at (0, 1.6, -4)) aimed straight down: the 10-20 degree
# edge of its cone crosses the helmet and the floor around the stand.
HELMET_SPOT = ((0.0, 6.0, -4.0), (60.0, 60.0, 60.0), ((0.0, -1.0, 0.0), 10.0, 20.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several test
    processes at once, and an oversubscribed torch thread pool slows these
    small CPU frames by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cornell():
    return build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device="cpu")


def _params(lights, spots=False, cam=CORNELL_CAM):
    params = default_scene_params(aspect=W / H)
    params.camera = make_camera(*cam, W / H)
    params.point_lights = PointLights.from_list(list(lights), spots=spots)
    return params


def _render(bufs, params, **cfg):
    img, stats = pipeline.render_frame_stats(
        bufs, params, default_settings(), RenderConfig(width=W, height=H, shadow_size=SHADOW, **cfg)
    )
    pipeline.check_stats(stats)
    return img.numpy().astype(np.int32)


def _lsb_gate(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("spots", [False, True])
def test_point_lights_from_list_equals_jax(spots):
    """The cone packing ((outer_cos, 1 / (inner_cos - outer_cos)), point
    rows (-2, 1)) and the bridge's copy of it equal the JAX package's."""
    rows = [POINT, SPOT] if spots else [POINT]
    jl = JPointLights.from_list(rows, spots=spots)
    tl = PointLights.from_list(rows, spots=spots)
    assert (tl.spot_dir is None) == (jl.spot_dir is None) == (not spots)
    for got in (tl, convert.scene_params(dataclasses.replace(
            j_default_params(), point_lights=jl)).point_lights):
        assert got.count == int(jl.count)
        for f in ("position", "color", "spot_dir", "spot_cos"):
            want = getattr(jl, f)
            if want is None:
                assert getattr(got, f) is None
            else:
                np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(want), err_msg=f)


@pytest.mark.parametrize("fused_shade", [True, False], ids=["fused", "deferred"])
def test_point_rows_exact_under_spotlights_flag(cornell, fused_shade):
    off = _render(cornell, _params([POINT]), fused_shade=fused_shade)
    on = _render(cornell, _params([POINT], spots=True), fused_shade=fused_shade, spotlights=True)
    np.testing.assert_array_equal(on, off)


@pytest.fixture(scope="module")
def spot_frames(cornell):
    p = _params([POINT, SPOT], spots=True)
    return dict(
        fused=_render(cornell, p, spotlights=True),
        deferred=_render(cornell, p, fused_shade=False, spotlights=True),
        no_cone=_render(cornell, _params([POINT, SPOT[:2]], spots=True), spotlights=True),
    )


def test_spotlight_fused_and_deferred_agree(spot_frames):
    max_lsb, frac = _lsb_gate(spot_frames["fused"], spot_frames["deferred"])
    assert max_lsb <= 1 and frac < 0.01, (max_lsb, frac)


def test_spotlight_cone_cuts_light(spot_frames):
    """Against the same light without its cone, pixels outside the cone
    darken and none brightens beyond rounding."""
    diff = spot_frames["fused"] - spot_frames["no_cone"]
    assert diff.max() <= 1, "the cone brightened a pixel"
    assert (diff.min(axis=-1) < -2).mean() > 0.01, "the cone cut no light"


def test_spotlight_frame_vs_oracle(spot_frames):
    meshes, objects, materials, env = procedural.cornell_like_scene()
    tris, mats = golden.golden_scene(meshes, objects, materials)
    gold = golden.render(
        tris, mats, env.astype(np.float64),
        dict(eye=CORNELL_CAM[0], rotation=CORNELL_CAM[1], aspect=W / H, fov_y=45.0,
             z_near=0.1, z_far=1000.0),
        dict(position=[-10.0, 32.0, -2.48], rotation=[-70.0, 12.0], color=[8.0, 8.0, 8.0]),
        [POINT, SPOT], ambient=0.1, settings=dict(tm_method=0, gamma=2.2, exposure=1.0),
        width=W, height=H, shadow_size=SHADOW,
    )
    db = golden.psnr(spot_frames["fused"].astype(np.uint8), gold)
    assert db >= 40.0, f"spotlight frame PSNR {db:.2f} dB < 40 dB"


def test_sample_environment_ibl_matches_jax():
    """The IBL lookup (no v flip) against JAX's sample_environment_ibl_cf on
    seeded directions, and it is not the skybox lookup."""
    jb = jbuild.build_buffers(*jproc.helmet_like_scene(), tri_bucket=256)
    tb = convert.scene_buffers(jb)
    rng = np.random.default_rng(7)
    d = [rng.uniform(-1, 1, (24, 40)).astype(np.float32) for _ in range(3)]
    want = jsky.sample_environment_ibl_cf(jb.environment, *(jnp.asarray(a) for a in d))
    e = tb.environment
    args = (pipeline.env_rows_bf16(tb), e.block_grid, e.region, *(torch.from_numpy(a) for a in d))
    got = sky.sample_environment_ibl_cf(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)
    skybox = sky.sample_environment_cf(*args)
    assert not torch.equal(got[0], skybox[0])


@pytest.fixture(scope="module")
def helmet_frames():
    """The helmet lit by POINT and HELMET_SPOT with spotlights=True and
    ibl_specular=True: JAX's brute-force frame, the port's fused and
    deferred frames; and the port's fused frame without IBL and without
    the spotlight's cone."""
    jb = jbuild.build_buffers(*jproc.helmet_like_scene(), tri_bucket=256)
    jp = j_default_params(aspect=W / H)
    jp = dataclasses.replace(
        jp, camera=dataclasses.replace(jp.camera, eye=jnp.asarray(HELMET_CAM[0]),
                                       rotation=jnp.asarray(HELMET_CAM[1])),
        point_lights=JPointLights.from_list([POINT, HELMET_SPOT], spots=True),
    )
    js = j_default_settings()
    jc = JRenderConfig(width=W, height=H, shadow_size=SHADOW, force_bruteforce=True,
                       ibl_specular=True, spotlights=True)
    jimg, _ = jpipe.render_frame_stats(jb, jp, js, jc)
    tb, tp = convert.scene_buffers(jb), convert.scene_params(jp)
    no_cone = dataclasses.replace(
        tp, point_lights=PointLights.from_list([POINT, HELMET_SPOT[:2]], spots=True))
    both = dict(spotlights=True, ibl_specular=True)
    return dict(
        jax=np.asarray(jimg).astype(np.int32),
        fused=_render(tb, tp, **both),
        deferred=_render(tb, tp, fused_shade=False, **both),
        no_ibl=_render(tb, tp, spotlights=True),
        no_cone=_render(tb, no_cone, **both),
    )


def test_ibl_fused_and_deferred_agree(helmet_frames):
    max_lsb, frac = _lsb_gate(helmet_frames["fused"], helmet_frames["deferred"])
    assert max_lsb <= 1 and frac < 0.01, (max_lsb, frac)


def test_ibl_changes_the_frame(helmet_frames):
    assert np.abs(helmet_frames["fused"] - helmet_frames["no_ibl"]).max() > 2


def test_helmet_spot_cone_cuts_light(helmet_frames):
    """The cone of the frame held against JAX's darkens the pixels outside
    it (so that comparison covers the cone factor), and brightens none."""
    diff = helmet_frames["fused"] - helmet_frames["no_cone"]
    assert diff.max() <= 1, "the cone brightened a pixel"
    assert (diff.min(axis=-1) < -2).mean() > 0.01, "the cone cut no light"


@pytest.mark.parametrize("frame", ["fused", "deferred"])
def test_ibl_frame_within_one_lsb_of_jax(helmet_frames, frame):
    """The port's spot + IBL frame against JAX's brute-force frame of the
    same lights and options."""
    max_lsb, frac = _lsb_gate(helmet_frames[frame], helmet_frames["jax"])
    assert max_lsb <= 1 and frac < 0.01, (max_lsb, frac)


def _exact_texel_scene():
    """The helmet's geometry and environment with textures of 0 and 255
    channels only, which both texture routes hold exactly (bf16 and u16),
    so the routes' frames differ only where the tile route's skybox reads
    its f32 environment copy."""
    meshes, objects, _, env = procedural.helmet_like_scene()
    white = (255, 255, 255)
    mats = [
        build.MaterialImages(procedural.checker_texture(64, 6, white, (255, 0, 0)),
                             procedural.checker_texture(64, 4, white, (255, 0, 255)),
                             procedural.mr_texture(1.0, 1.0)),
        build.MaterialImages(procedural.solid_texture((0, 255, 255), 8),
                             procedural.checker_texture(8, 2, white, (0, 255, 255)),
                             procedural.mr_texture(0.0, 1.0)),
        build.MaterialImages(procedural.checker_texture(64, 8, white, (0, 0, 255)),
                             procedural.solid_texture(white, 4), procedural.mr_texture(1.0, 1.0)),
    ]
    return meshes, objects, mats, env


def test_ibl_tile_route_reads_the_bf16_environment():
    """On the tile atlas the IBL lookup reads the environment rounded to
    bf16, the table the JAX package's IBL reads (its quads_packed), not the
    f32 copy the tile route's skybox reads: the quad and tile routes' IBL
    frames are within 1 LSB, on exactly the pixels where their frames
    without IBL differ."""
    scene = _exact_texel_scene()
    quad = build.build_buffers(*scene, tri_bucket=256, device="cpu")
    tile = build.build_buffers(*scene, tri_bucket=256, device="cpu", tile_threshold_texels=0)
    assert tile.atlas.tiles is not None and quad.atlas.tiles is None
    assert torch.equal(pipeline.env_rows_bf16(tile).view(torch.int16),
                       pipeline.env_rows_bf16(quad).view(torch.int16))
    p = _params([], cam=HELMET_CAM)
    f = {(name, ibl): _render(bufs, p, ibl_specular=ibl)
         for name, bufs in (("quad", quad), ("tile", tile)) for ibl in (False, True)}
    assert np.abs(f["quad", True] - f["quad", False]).max() > 2
    assert _lsb_gate(f["tile", True], f["quad", True])[0] <= 1
    np.testing.assert_array_equal(f["tile", True] != f["quad", True],
                                  f["tile", False] != f["quad", False])


def test_spot_state_round_trips_both_packages(tmp_path):
    """A state with spot rows saved by the port loads in the JAX package's
    load_state with the same cone packing, and the JSON each package writes
    is the same."""
    params = _params([POINT, SPOT], spots=True)
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    serialize.save_state(str(ours), params, default_settings())
    d = json.loads(ours.read_text())
    assert "spot_dir" in d["point_lights"][1] and "spot_cos" in d["point_lights"][0]
    jp, js = jserialize.load_state(str(ours))
    np.testing.assert_array_equal(np.asarray(jp.point_lights.spot_dir), params.point_lights.spot_dir)
    np.testing.assert_array_equal(np.asarray(jp.point_lights.spot_cos), params.point_lights.spot_cos)
    jserialize.save_state(str(theirs), jp, js)
    assert json.loads(theirs.read_text()) == d
    tp, _ = serialize.load_state(str(theirs))
    for f in ("position", "color", "spot_dir", "spot_cos"):
        assert torch.equal(getattr(tp.point_lights, f), getattr(params.point_lights, f)), f
    assert tp.point_lights.count == 2
    tp, _ = serialize.load_state(str(ours))
    assert torch.equal(tp.point_lights.spot_cos, params.point_lights.spot_cos)
