"""Tile-row sharding of arctic_tpu_torch (parallel/sharding.py) against the
port's single-device frame and the JAX package's sharded frame.

- The slab layout at the JAX tests' shapes (tests/test_sharding.py) and at
  the real size, with camera and shadow tile rows that the rank count does
  not divide.
- render_frame_slabs_stats (the slab stages rank after rank in one
  process) equals the single-device frame bit for bit, shadow map and
  stats included where the slabs count the same thing: on the port's copy
  of test_sharding's tiny scene (2 ranks), on Cornell at 192x136 with a
  320^2 map and 8 ranks (sun-cull rect and y band; also with pcf_row_cap)
  and on Cornell at 128x96 with a 128^2 map and 8 ranks (brute force).
- launch() over gloo in 2 and 8 processes equals the slab frame bit for
  bit (frame and stats).
- One JAX frame: the JAX package's jitted 8-device brute-force sharded
  frame at 128x96 / 128^2; the port's sharded frame is held to it with
  JAX's own tolerance (<= 1 LSB on < 0.5% of the pixels,
  test_sharding._assert_frames_match).
- A starved camera pair cap makes check_stats raise on the maxed stats; a
  rank that fails, and more CUDA ranks than cards, raise RenderError.
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
from arctic_tpu.io import procedural as jproc
from arctic_tpu.parallel import sharding as jsharding
from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import default_scene_params, default_settings, make_camera
from arctic_tpu_torch.io import build, procedural
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.parallel import sharding
from arctic_tpu_torch.utils import convert, kernels
from arctic_tpu_torch.utils.errors import RenderError


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The suite runs test files in several processes at once; an
    oversubscribed torch thread pool slows these small CPU frames by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_scene():
    """tests/test_sharding._tiny_scene on the port's build: a floor quad
    and two standing triangles."""
    positions = [
        [-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6],
        [-2, 0, -2], [0, 3, -2], [2, 0, -2],
        [1, 0, 1], [2, 2.5, 1], [3, 0, 1],
    ]
    indices = [[0, 2, 1], [0, 3, 2], [4, 5, 6], [7, 8, 9]]
    mesh = build.MeshData(
        positions=np.asarray(positions, np.float32),
        normals=np.tile([0, 1.0, 0], (len(positions), 1)).astype(np.float32),
        uvs=np.zeros((len(positions), 2), np.float32),
        indices=np.asarray(indices, np.int32),
        material=0,
    )
    mats = [build.MaterialImages(build.fallback_diffuse(), build.fallback_normal(),
                                 build.fallback_diffuse())]
    return build.build_buffers([mesh], [(np.eye(4, dtype=np.float32), 0)], mats,
                               procedural.gradient_environment(32, 64), tri_bucket=64,
                               device="cpu")


def _cornell():
    return build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device="cpu")


def _params(w, h, eye, rot):
    p = default_scene_params(aspect=w / h)
    p.camera = make_camera(eye, rot, w / h)
    return p


# name: (scene, width, height, shadow, ranks, eye, rotation, config fields)
CASES = {
    "tiny_2": (_tiny_scene, 128, 64, 64, 2, [0.0, 4.0, 8.0], [-20.0, -90.0], {}),
    "cornell_8": (_cornell, 192, 136, 320, 8, [0.0, 4.0, 3.0], [-25.0, -90.0], {}),
    "cornell_8_quant": (_cornell, 192, 136, 320, 8, [0.0, 4.0, 3.0], [-25.0, -90.0],
                        dict(pcf_row_cap=384)),
    "bruteforce_8": (_cornell, 128, 96, 128, 8, [0.0, 4.0, 3.0], [-25.0, -90.0],
                     dict(force_bruteforce=True)),
}


def _case(name):
    scene, w, h, s, ranks, eye, rot, fields = CASES[name]
    return scene(), _params(w, h, eye, rot), RenderConfig(width=w, height=h, shadow_size=s,
                                                           **fields), ranks


def _single_shadow_map(bufs, p, config):
    """The single-device frame's shadow map (inside its sun-cull rect)."""
    geom = bufs.geometry
    wc = pipeline.world_corners(geom)
    tri_valid = torch.arange(geom.capacity) < geom.num_tris
    sun_pv = p.sun.proj_view()
    rect = None
    if pipeline.fused(config) and config.sun_frustum_cull:
        rect, _ = pipeline.sun_cull_rect(wc, tri_valid, p.camera.proj_view(), sun_pv, config)
    return pipeline.shadow_pass(geom, pipeline.corners_clip(wc, sun_pv), config, rect)[0]


@pytest.mark.parametrize("w, h, s, world, want", [
    # 1 camera tile row and 1 shadow tile row over 2 ranks: rank 1 gets empty windows.
    (128, 64, 64, 2, (2, 1, 2, 1)),
    # 3 camera and 5 shadow tile rows over 8 ranks (test_sharding's bench shape).
    (192, 136, 320, 8, (8, 1, 8, 1)),
    # The real size: 17 camera tile rows -> 20, 63 shadow tile rows -> 64.
    (1920, 1080, 4000, 4, (20, 5, 64, 16)),
])
def test_slab_layout(w, h, s, world, want):
    """Tile rows round up to a multiple of the rank count and split evenly
    (arctic_tpu/parallel/sharding.py:77-81); the trailing windows are
    partial or empty, and the frame and the map are cropped to H and S."""
    config = RenderConfig(width=w, height=h, shadow_size=s)
    jc = JRenderConfig(width=w, height=h, shadow_size=s)
    layout = sharding.slab_layout(config, world)
    assert layout == (world, *want)
    th, st = jc.tile_h, jc.shadow_tile
    assert layout.cam_tile_rows == -(-(-(-h // th)) // world) * world
    assert layout.sh_tile_rows == -(-(-(-s // st)) // world) * world
    for rows, size in ((layout.cam_rows * th, h), (layout.sh_rows * st, s)):
        windows = [max(0, min(size, r * rows + rows) - r * rows) for r in range(world)]
        assert sum(windows) == size and windows[-1] < rows  # the last one partial or empty
    with pytest.raises(RenderError, match="at least one rank"):
        sharding.slab_layout(config, 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_slabs_equal_single_device(name):
    """The slab frame, its gathered shadow map and its stats against the
    single-device frame of the same config, bit for bit: the slabs' counts
    are at most the frame's (the camera pairs are counted per slab, the
    penumbra rows per slab of 128-pixel rows), the caps are one slab's."""
    bufs, p, config, ranks = _case(name)
    s = default_settings()
    single, sst = pipeline.render_frame_stats(bufs, p, s, config)
    with kernels.record_calls() as calls:
        multi, mst, smap = sharding.render_frame_slabs_with_map(bufs, p, s, config, ranks)
    if config.force_bruteforce:
        assert calls == {}
    else:  # each rank: K1 on its shadow and its camera slab, K4 on its camera slab
        layout = sharding.slab_layout(config, ranks)
        assert [kw["row0"] for _, kw in calls["raster_tiles"]] == [
            r * layout.sh_rows * 64 for r in range(ranks)] + [
            r * layout.cam_rows * config.tile_h for r in range(ranks)]
        assert [kw["row0"] for _, kw in calls["select_interp"]] == [
            r * layout.cam_rows * config.tile_h for r in range(ranks)]
    assert multi.shape == single.shape == (config.height, config.width, 3)
    assert (single[..., 0] != single[0, 0, 0]).any(), "scene invisible"
    np.testing.assert_array_equal(multi.numpy(), single.numpy())
    np.testing.assert_array_equal(smap.numpy(), _single_shadow_map(bufs, p, config).numpy())
    sst, mst = ({k: int(v) for k, v in st.items()} for st in (sst, mst))
    pipeline.check_stats(mst)
    for k in ("cam_pair_cap", "shadow_pair_cap", "tex_fb_cap"):
        assert mst[k] == sst[k], k
    for k in ("cam_pairs", "shadow_pairs", "pcf_rows"):
        assert mst[k] <= sst[k], k
    if config.force_bruteforce:
        assert mst == sst  # no pair buffers: 0 pairs of a cap of 1
    else:
        assert mst["cam_pairs"] > 0
        assert (mst["shadow_pairs"] > 0) == (sst["shadow_pairs"] > 0)
    if config.pcf_row_cap is not None:
        layout = sharding.slab_layout(config, ranks)
        assert mst["pcf_row_cap"] == layout.cam_rows * config.tiles_x * 32 <= sst["pcf_row_cap"]
        assert mst["pcf_rows"] > 0


@pytest.mark.parametrize("name", ["tiny_2", "cornell_8"])
def test_gloo_processes_equal_slabs(name):
    """launch() in 2 / 8 processes over gloo (file rendezvous, each rank on
    one torch thread): every rank returns the whole frame and the maxed
    stats, equal to the slab frame's bit for bit."""
    bufs, p, config, ranks = _case(name)
    s = default_settings()
    want, wst = sharding.render_frame_slabs_stats(bufs, p, s, config, ranks)
    out = sharding.launch(ranks, sharding.frame_worker, bufs, p, s, config, device="cpu",
                          timeout=90)
    assert len(out) == ranks
    for img, stats in out:
        np.testing.assert_array_equal(img, want.numpy())
        assert stats == {k: int(v) for k, v in wst.items()}


def test_bruteforce_sharded_frame_vs_jax():
    """The JAX package's jitted brute-force sharded frame on its 8 virtual
    CPU devices (tests/test_sharding.py:126-147) against the port's sharded
    frame of the same scene and params: <= 1 LSB on < 0.5% of the pixels,
    JAX's own sharded-vs-single tolerance."""
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
    w, h = 128, 96
    jc = JRenderConfig(width=w, height=h, shadow_size=128, force_bruteforce=True)
    jb = jbuild.build_buffers(*jproc.cornell_like_scene(), tri_bucket=256)
    jp = j_default_params(aspect=w / h)
    jp = dataclasses.replace(jp, camera=dataclasses.replace(
        jp.camera, eye=jnp.asarray([0.0, 4.0, 3.0]), rotation=jnp.asarray([-25.0, -90.0])))
    js = j_default_settings()
    want = np.asarray(jsharding.make_sharded_renderer(jc, jsharding.make_mesh(8))(jb, jp, js))
    got, stats = sharding.render_frame_slabs_stats(
        convert.scene_buffers(jb), convert.scene_params(jp), convert.settings(js),
        convert.render_config(jc), 8,
    )
    assert got.shape == want.shape
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1, f"sharded frame differs by {diff.max()} > 1 LSB"
    frac = (diff > 0).mean()
    assert frac < 0.005, f"sharded frame rounding differs on {frac:.3%} pixels"
    assert {k: int(v) for k, v in stats.items()} == dict(
        cam_pairs=0, cam_pair_cap=1, shadow_pairs=0, shadow_pair_cap=1, pcf_rows=0,
        pcf_row_cap=1, tex_fb_rows=0, tex_fb_cap=1)


def test_world_of_one_in_process(tmp_path):
    """A world of one gloo rank in this process (init_group with a file
    rendezvous; make_group, the make_mesh counterpart): the sharded frame
    is the single-device frame, and buffers on another device type than
    the group's backend raise instead of switching backends."""
    bufs, p, config, _ = _case("cornell_8")
    s = default_settings()
    want, wst = pipeline.render_frame_stats(bufs, p, s, config)
    assert sharding.init_group("cpu", f"file://{tmp_path / 'rendezvous'}") == torch.device("cpu")
    try:
        group = sharding.make_group()
        img, stats = sharding.make_sharded_renderer_stats(config, group, "cpu")(bufs, p, s)
        np.testing.assert_array_equal(img.numpy(), want.numpy())
        assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in wst.items()}
        np.testing.assert_array_equal(
            sharding.make_sharded_renderer(config, group, "cpu")(bufs, p, s).numpy(), want.numpy())
        with pytest.raises(RenderError, match="a group of 2 ranks from a world of 1"):
            sharding.make_group(2)
        with pytest.raises(RenderError, match="need a nccl process group, this one is gloo"):
            sharding._check_backend(torch.device("cuda"), group)
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(RenderError, match="not initialised"):
        sharding.make_group()


def test_starved_pair_cap_raises():
    """A camera pair cap below one slab's pairs: the maxed stats carry the
    slab's count and check_stats raises, as for the single-device frame."""
    bufs, p, config, ranks = _case("cornell_8")
    config = dataclasses.replace(config, pair_cap_cam=0)
    img, stats = sharding.render_frame_slabs_stats(bufs, p, default_settings(), config, ranks)
    assert int(stats["cam_pair_cap"]) == 0 < int(stats["cam_pairs"])
    with pytest.raises(RenderError, match="cam pass overflowed"):
        pipeline.check_stats(stats)


def test_launch_errors(monkeypatch):
    """More ranks than cards on cuda raise RenderError naming both counts
    before any process starts; a rank that fails raises RenderError with
    its traceback, and launch() stops every rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RenderError, match="2 ranks on cuda need 2 CUDA devices; this machine has 1"):
        sharding.launch(2, sharding.frame_worker, None, None, None, None, device="cuda")
    with pytest.raises(RenderError, match="no collective backend"):
        sharding.launch(2, sharding.frame_worker, device="meta")
    with pytest.raises(RenderError, match=r"(?s)rank \d:.*AttributeError"):
        sharding.launch(2, sharding.frame_worker, None, None, None, RenderConfig(),
                        device="cpu", timeout=60)
