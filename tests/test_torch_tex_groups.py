"""The grouped tile route of arctic_tpu_torch (RenderConfig.tex_group_caps)
against the JAX package's functions, and its frames against the plain
tile route.

The 6-material scene of tests/test_tex_groups.py at 128x128 (one 2x2 grid
of 64^2 tiles, 128 rows of 128 pixels) on the tile atlas, in groups of at
most 220 rows. No JAX frame: the JAX package's measurements raster through
its Pallas kernel (interpret mode here), so the port's measured rows are
held to JAX's tile_row_groups over the JAX brute-force raster's ibuf
(tiled == brute force, tests/test_raster_tiles.py) in the same tile-major
rows. Tolerances: the layouts, metas, group maps, row claims, masks,
counts and plans are equal; the grouped frames are bit-equal to the plain
tile route's frame (the routing permutes rows; every pixel reads the row
and aux values the plain tap reads), the spill case included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.scene import default_scene_params as j_default_params
from arctic_tpu.io import build as jbuild
from arctic_tpu.io import texplan as jtexplan
from arctic_tpu.ops import raster as jraster
from arctic_tpu.ops import sampling as jsampling
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import default_settings
from arctic_tpu_torch.io import build, procedural, texplan
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import sampling
from arctic_tpu_torch.utils import convert, kernels
from arctic_tpu_torch.utils.errors import RenderError

W, H, SHADOW = 128, 128, 128
EYE, ROT = [0.0, 4.0, 7.0], [-25.0, -90.0]
BUDGET = 220 * 512  # about two materials (55 rows each) and the env copy a group
EXPLICIT = [[0, 5], [1, 4], [2, 3]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several test
    processes at once, and an oversubscribed torch thread pool slows these
    small CPU frames by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    """The 6-material scene of tests/test_tex_groups.py."""
    mats = procedural.textured_materials(6, 32)
    meshes = [
        procedural.plane_mesh(8.0, material=0, uv_scale=2.0),
        procedural.box_mesh(2.0, 2.0, 2.0, material=1),
        procedural.uv_sphere(1.0, 8, 12, material=2),
        procedural.box_mesh(1.0, 3.0, 1.0, material=3),
        procedural.uv_sphere(0.8, 8, 12, material=4),
        procedural.box_mesh(3.0, 1.0, 1.0, material=5),
    ]
    objects = [
        (procedural.transform((0, 0, 0)), 0),
        (procedural.transform((-2.0, 1.0, 0.0)), 1),
        (procedural.transform((2.0, 1.0, 0.0)), 2),
        (procedural.transform((0.0, 1.5, -2.0)), 3),
        (procedural.transform((-1.0, 0.8, 2.0)), 4),
        (procedural.transform((1.5, 0.5, 2.5)), 5),
    ]
    return meshes, objects, mats, procedural.gradient_environment(16, 32)


KW = dict(tri_bucket=512, tile_threshold_texels=0, tex_group_budget=BUDGET)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def bufs(scene):
    return build.build_buffers(*scene, device="cpu", **KW)


@pytest.fixture(scope="module")
def explicit_bufs(scene):
    return build.build_buffers(*scene, device="cpu", tex_groups=EXPLICIT, **KW)


def _params(eye=EYE, rot=ROT):
    p = j_default_params(aspect=W / H)
    jp = dataclasses.replace(p, camera=dataclasses.replace(
        p.camera, eye=jnp.asarray(eye), rotation=jnp.asarray(rot)))
    return jp, convert.scene_params(jp)


CONFIG = RenderConfig(width=W, height=H, shadow_size=SHADOW)


@pytest.fixture(scope="module")
def plain_frame(bufs):
    img, stats = pipeline.render_frame_stats(bufs, _params()[1], default_settings(), CONFIG)
    assert int(stats["tex_fb_rows"]) == 0 and stats["tex_fb_cap"] == 1
    return img.numpy()


@pytest.mark.parametrize("explicit", [None, EXPLICIT], ids=["greedy", "explicit"])
def test_group_tile_atlas_matches_jax(scene, explicit):
    """Layout, metas, group map and rows per material, and the scene build
    with them: the table, the groups and (explicit groups only) JAX's
    per-group tables equal the port's slices of its table."""
    rng = np.random.default_rng(0)
    images = [rng.uniform(0, 1, (33 + 4 * i, 17 + 3 * i, 8)).astype(np.float32) for i in range(6)]
    tiles, meta = build.build_tile_atlas(images)
    env_rows = rng.standard_normal((5, 128)).astype(np.float32).view(np.int32)
    got = build.group_tile_atlas(tiles, meta, env_rows, 160 * 512, explicit_groups=explicit)
    want = jbuild.group_tile_atlas(tiles, meta, env_rows, 160 * 512, explicit_groups=explicit)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:] and len(got[2]) >= 3

    tb = build.build_buffers(*scene, device="cpu", tex_groups=explicit, **KW)
    jb = jbuild.build_buffers(*scene, tex_groups=explicit, **KW)
    ta, ja = tb.atlas, jb.atlas
    np.testing.assert_array_equal(ta.tiles.numpy(), np.asarray(ja.tiles))
    assert ta.tile_groups == tuple(tuple(g) for g in ja.tile_groups)
    assert ta.tile_group_of == ja.tile_group_of and ta.tile_mat_rows == ja.tile_mat_rows
    np.testing.assert_array_equal(tb.geometry.tri_matrow.numpy(), np.asarray(jb.geometry.tri_matrow))
    if explicit is None:
        assert ja.tile_group_tables is None
    else:
        # The port's group tables are views of its rows of the atlas.
        assert ta.tile_group_of == (0, 1, 2, 2, 1, 0)
        for (lo, _, hi), jt in zip(ta.tile_groups, ja.tile_group_tables):
            np.testing.assert_array_equal(ta.tiles[lo:hi].numpy(), np.asarray(jt))


def test_explicit_groups_must_partition(scene):
    with pytest.raises(RenderError, match="partition"):
        build.build_buffers(*scene, device="cpu", tex_groups=[[0, 1], [2, 3]], **KW)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_row_groups_matches_jax(seed):
    rng = np.random.default_rng(seed)
    covered = rng.uniform(0, 1, (256, 128)) < [0.0, 0.3, 1.0][seed]
    gid = rng.integers(0, 4, (256, 128)).astype(np.int32)
    gid[::3] = gid[::3, :1]  # rows of one group
    gid[1::3] = np.where(rng.uniform(0, 1, (85, 128)) < 0.5, 1, 3)  # dual-claim rows
    got = sampling.tile_row_groups(torch.from_numpy(covered), torch.from_numpy(gid), 4)
    want = jsampling.tile_row_groups(jnp.asarray(covered), jnp.asarray(gid), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_rows(jb, jp, config):
    """JAX's tile-major 128-pixel rows (covered, material) of the camera
    pass, from its brute-force raster."""
    geom = jb.geometry
    t_cap = geom.capacity
    wc = jpipe.world_corners(geom)
    tri_valid = jnp.arange(t_cap) < geom.num_tris
    clipped = jraster.near_clip_corners(jpipe.corners_clip(wc, jp.camera.proj_view()), tri_valid)
    setup = jraster.setup_screen_triangles(clipped, W, H, cull="back")
    _, ibuf = jraster.rasterize_bruteforce(setup, H, W)
    th, tw = config.tile_h, config.tile_w
    ty, tx = -(-H // th), -(-W // tw)
    full = np.full((ty * th, tx * tw), -1, np.int32)
    full[:H, :W] = np.asarray(ibuf)
    rows = full.reshape(ty, th, tx, tw).transpose(0, 2, 1, 3).reshape(-1, 128)
    covered = rows >= 0
    mat = np.asarray(geom.tri_material)[np.where(covered, rows, 0) % t_cap]
    return covered, mat


VIEWS = [(EYE, ROT), ([2.0, 3.0, 6.0], [-20.0, -110.0]), ([-3.0, 2.5, 5.0], [-15.0, -70.0])]


def test_measured_masks_and_counts_match_jax(scene, bufs):
    """measure_tex_row_masks / measure_tex_group_rows over three views, held
    to JAX's row claims (tile_row_groups) over its brute-force raster."""
    jb = jbuild.build_buffers(*scene, **KW)
    group_of = np.asarray(jb.atlas.tile_group_of, np.int32)
    g_n = len(jb.atlas.tile_groups)
    params = [_params(e, r) for e, r in VIEWS]
    masks = pipeline.measure_tex_row_masks(bufs, [p for _, p in params], CONFIG)
    need = pipeline.measure_tex_group_rows(bufs, [p for _, p in params], CONFIG)
    want_need = np.zeros(g_n + 1, np.int64)
    for f, (jp, _) in enumerate(params):
        covered, mat = _jax_rows(jb, jp, CONFIG)
        want_mask = np.where(covered, np.int64(1) << mat.astype(np.int64), 0)
        np.testing.assert_array_equal(masks[f], np.bitwise_or.reduce(want_mask, axis=1))
        g_lo, g_hi, many = (np.asarray(a) for a in jsampling.tile_row_groups(
            jnp.asarray(covered), jnp.asarray(group_of[mat]), g_n))
        counts = [int((~many & ((g_lo == g) | (g_hi == g))).sum()) for g in range(g_n)]
        want_need = np.maximum(want_need, counts + [int(many.sum())])
    np.testing.assert_array_equal(need, want_need)
    assert masks.shape == (3, 128) and (masks != 0).any()


def test_plan_matches_jax(bufs):
    """plan_material_groups plans JAX's groups from the same masks (the same
    seeded anneal), and plan_tex_groups returns a partition."""
    masks = pipeline.measure_tex_row_masks(bufs, [p for _, p in (_params(e, r) for e, r in VIEWS)],
                                           CONFIG)
    args = (masks, list(bufs.atlas.tile_mat_rows), bufs.environment.num_rows, BUDGET // 512)
    got = texplan.plan_material_groups(*args, iters=3000)
    want = jtexplan.plan_material_groups(*args, iters=3000)
    assert got[0] == want[0] and got[1] == want[1]
    plan = pipeline.plan_tex_groups(bufs, _params()[1], CONFIG)
    assert sorted(m for g in plan for m in g) == list(range(6))


def test_plan_keeps_the_build_budget(scene, bufs):
    """plan_tex_groups plans under the budget the scene was built with (the
    JAX package plans under its default budget whatever the build used):
    no planned group of a 220-row build exceeds 220 rows with its env copy."""
    plan = pipeline.plan_tex_groups(bufs, [p for _, p in (_params(e, r) for e, r in VIEWS)], CONFIG)
    rows = bufs.atlas.tile_mat_rows
    for g in plan:
        assert sum(rows[m] for m in g) + bufs.environment.num_rows <= BUDGET // 512


def _render(bufs, config):
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(bufs, _params()[1], default_settings(), config)
    return img.numpy(), {k: int(v) for k, v in stats.items()}, calls


@pytest.mark.parametrize("which", ["greedy", "explicit"])
def test_grouped_frame_bit_equal_to_plain(bufs, explicit_bufs, plain_frame, which):
    """Caps from autotune_tex_group_caps: the frame equals the plain tile
    route's bit for bit, with K9 launched once per group and once for the
    fallback."""
    b = bufs if which == "greedy" else explicit_bufs
    tuned = pipeline.autotune_tex_group_caps(b, _params()[1], CONFIG)
    assert len(tuned.tex_group_caps) == len(b.atlas.tile_groups) + 1
    assert all(c % 32 == 0 for c in tuned.tex_group_caps)
    img, stats, calls = _render(b, tuned)
    pipeline.check_stats(stats)
    np.testing.assert_array_equal(img, plain_frame)
    assert len(calls["tile_tap_resolve"]) == len(b.atlas.tile_groups) + 1
    assert stats["tex_fb_cap"] == tuned.tex_group_caps[-1]


def test_grouped_spill_bit_equal(bufs, plain_frame):
    """Every group cap starved: rows spill to the full-table fallback, and
    the frame is still the plain route's."""
    rows = CONFIG.num_tiles * 64 * 64 // 128
    caps = tuple([32] * len(bufs.atlas.tile_groups) + [-(-(rows + 32) // 32) * 32])
    img, stats, _ = _render(bufs, dataclasses.replace(CONFIG, tex_group_caps=caps))
    pipeline.check_stats(stats)
    assert stats["tex_fb_rows"] > 0
    np.testing.assert_array_equal(img, plain_frame)


def test_grouped_fallback_overflow_is_loud(bufs, caplog):
    caps = tuple([32] * len(bufs.atlas.tile_groups) + [32])
    config = dataclasses.replace(CONFIG, tex_group_caps=caps, debug_overflow=True)
    _, stats, _ = _render(bufs, config)
    assert stats["tex_fb_rows"] > 32
    assert "fallback rows" in caplog.text
    with pytest.raises(RenderError, match="fallback rows overflowed"):
        pipeline.check_stats(stats)


def test_grouped_caps_must_match_groups(bufs):
    with pytest.raises(RenderError, match="caps"):
        _render(bufs, dataclasses.replace(CONFIG, tex_group_caps=(32, 32)))


def test_single_group_scene_ignores_caps(scene):
    b = build.build_buffers(*scene, device="cpu", tri_bucket=512, tile_threshold_texels=0)
    assert len(b.atlas.tile_groups) == 1
    assert pipeline.autotune_tex_group_caps(b, _params()[1], CONFIG).tex_group_caps is None
    assert pipeline.plan_tex_groups(b, _params()[1], CONFIG) is None
    img, stats, calls = _render(b, dataclasses.replace(CONFIG, tex_group_caps=(32, 32)))
    assert stats["tex_fb_cap"] == 1 and len(calls["tile_tap_resolve"]) == 1
    assert img.shape == (H, W, 3)
