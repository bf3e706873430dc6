"""The textured path of arctic_tpu_torch against the JAX package: the
reference-scale textures, the u16 tile atlas, tile_index, the plain K9 and
the tile-route frame.

The same numpy inputs go to both. Tolerances: the textures, the atlas, the
scene buffers and tile_index are bit-equal (the same numpy body; int32
floor division and modulo). The plain K9 is bit-equal to a numpy f32
evaluation of the same separately rounded operations (which the CUDA
kernel, built with -fmad=false, repeats), and within 1e-6 absolute of
JAX's kernel in interpret mode, which contracts its lerps into FMAs (as
test_torch_shading's K6 case; texels in [0, 1], env values in [0, 4)).
K9 is compared on the channels the frame consumes: the texture channels
of the pixels that read a tile row and the env channels of those that
read an env row (the others are a row's bits seen the other way, and
XLA's CPU flushes subnormals where torch does not). The frame is within 1
u8 LSB of JAX's on < 1% of the pixels with equal stats (test_torch_pipeline's
gate), and >= 45 dB and <= 8 LSB from the port's own quad-route frame (the
JAX package's bound, test_sampling_variants.py:152-156).
"""

import dataclasses
import os

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
from arctic_tpu.ops import sampling as jsampling
from arctic_tpu_torch.io import build, procedural
from arctic_tpu_torch.models import golden, pipeline
from arctic_tpu_torch.ops import sampling
from arctic_tpu_torch.utils import convert

W, H, SHADOW = 128, 96, 128
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "docs", "images")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several test
    processes at once, and torch's thread pool, oversubscribed across them,
    slows these small CPU frames and counts by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _materials_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("diffuse", "normal", "metal_roughness"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("n_in, n_out", [(4, 32), (16, 96), (64, 48), (7, 100), (100, 5)])
def test_resize_matches_pillow(n_in, n_out):
    """The numpy copy of Pillow's 8-bit bilinear resample, up and down,
    square and not."""
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(n_in * 1000 + n_out)
    g = rng.integers(0, 256, (n_in, n_in + 3), dtype=np.uint8)
    want = np.asarray(image.fromarray(g).resize((n_out + 1, n_out), image.BILINEAR))
    np.testing.assert_array_equal(procedural.resize_bilinear_u8(g, n_out, n_out + 1), want)


def test_noisy_textures_match_jax():
    pytest.importorskip("PIL")
    for size in (32, 96):
        got = procedural.noisy_texture(size, np.random.default_rng(size))
        want = jproc.noisy_texture(size, np.random.default_rng(size))
        np.testing.assert_array_equal(got, want)
        got = procedural.noisy_mr_texture(size, np.random.default_rng(size), 0.3, 0.45)
        want = jproc.noisy_mr_texture(size, np.random.default_rng(size), 0.3, 0.45)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [32, 96])
def test_textured_materials_match_jax(size):
    pytest.importorskip("PIL")
    _materials_equal(procedural.textured_materials(3, size), jproc.textured_materials(3, size))


def test_textured_sponza_matches_jax():
    pytest.importorskip("PIL")
    got = procedural.sponza_like_scene(texture_size=32, n_materials=3)
    want = jproc.sponza_like_scene(texture_size=32, n_materials=3)
    (gm, go, gmat, genv), (wm, wo, wmat, wenv) = got, want
    assert len(gm) == len(wm) and len(go) == len(wo)
    for a, b in zip(gm, wm):
        assert a.material == b.material
        for f in ("positions", "normals", "uvs", "indices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for (ta, ma), (tb, mb) in zip(go, wo):
        np.testing.assert_array_equal(ta, tb)
        assert ma == mb
    _materials_equal(gmat, wmat)
    np.testing.assert_array_equal(genv, wenv)


def _tile_images():
    rng = np.random.default_rng(0)
    return [
        rng.uniform(0, 1, (33, 17, 8)).astype(np.float32),
        rng.uniform(0, 1, (20, 40, 8)).astype(np.float32),
    ]


@pytest.mark.parametrize("budget_rows", [None, 70])
def test_tile_atlas_and_groups_match_jax(budget_rows):
    """build_tile_atlas, then group_tile_atlas with one group (the default
    budget) and with two (a budget under two materials and the env)."""
    images = _tile_images()
    tiles, meta = build.build_tile_atlas(images)
    jtiles, jmeta = jbuild.build_tile_atlas(images)
    np.testing.assert_array_equal(tiles, jtiles)
    np.testing.assert_array_equal(meta, jmeta)
    env_rows = np.random.default_rng(1).standard_normal((5, 128)).astype(np.float32).view(np.int32)
    budget = build.TEX_GROUP_BUDGET_BYTES if budget_rows is None else budget_rows * 512
    table, metas, groups, group_of, mat_rows = build.group_tile_atlas(tiles, meta, env_rows, budget)
    jtable, jmetas, jgroups, jgroup_of, jmat_rows = jbuild.group_tile_atlas(
        jtiles, jmeta, env_rows, budget)
    np.testing.assert_array_equal(table, jtable)
    np.testing.assert_array_equal(metas, jmetas)
    assert groups == jgroups and len(groups) == (1 if budget_rows is None else 2)
    assert group_of == jgroup_of and mat_rows == jmat_rows


def _six_material_scene():
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


@pytest.mark.parametrize("scene, budget_rows", [("cornell", None), ("six", None), ("six", 220)])
def test_tile_route_build_matches_jax(scene, budget_rows):
    """build_buffers(tile_threshold_texels=0) against the JAX build carried
    over by convert.scene_buffers, leaf by leaf."""
    parts = procedural.cornell_like_scene() if scene == "cornell" else _six_material_scene()
    budget = None if budget_rows is None else budget_rows * 512
    kw = dict(tri_bucket=256, tile_threshold_texels=0, tex_group_budget=budget)
    tb = build.build_buffers(*parts, device="cpu", **kw)
    jb = jbuild.build_buffers(*parts, **kw)
    assert tb.atlas.tiles is not None and tb.atlas.combined_env_rows is None
    assert len(tb.atlas.tile_groups) >= (2 if budget_rows else 1)
    got, want = convert.scene_leaves(tb), convert.scene_leaves(convert.scene_buffers(jb))
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_materials_that_neither_combine_nor_tile_raise():
    """Sizes that differ inside one material rule out both the combined and
    the tile atlas: such materials now take the per-slot atlas (they raised
    before it was ported), as in the JAX package's build."""
    mat = procedural.MaterialImages(
        procedural.checker_texture(32), procedural.bumpy_normal_texture(16),
        procedural.mr_texture(0.0, 0.5),
    )
    meshes, objects, _, env = procedural.cornell_like_scene()
    tb = build.build_buffers(meshes, objects, [mat] * 3, env, tri_bucket=256, device="cpu",
                             tile_threshold_texels=0)
    jb = jbuild.build_buffers(meshes, objects, [mat] * 3, env, tri_bucket=256,
                              tile_threshold_texels=0)
    assert tb.atlas.tiles is None and tb.atlas.combined_slots is None
    assert jb.atlas.tiles is None and jb.atlas.combined_slots is None
    np.testing.assert_array_equal(convert.to_numpy(tb.atlas.quads),
                                  np.asarray(jb.atlas.quads).view(np.uint16))


def test_tile_index_matches_jax():
    rng = np.random.default_rng(2)
    n = 4096
    u = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    meta = np.array([[0, 3, 33, 17], [18, 6, 20, 40], [97, 1, 1, 1]], np.float32)[rng.integers(0, 3, n)]
    got = sampling.tile_index(*(torch.from_numpy(np.ascontiguousarray(c)) for c in meta.T),
                              torch.from_numpy(u), torch.from_numpy(v))
    want = jsampling.tile_index(*(jnp.asarray(c) for c in meta.T), jnp.asarray(u), jnp.asarray(v))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 or g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _tile_tap_numpy(table, idx, ty, tx, eq, fx, fy, efx, efy):
    """K9's arithmetic in numpy f32, one rounding per operation (the
    channels no one reads may overflow: their warnings are silenced)."""
    dq = np.float32(1.0 / 65535.0)
    row = table[idx].view(np.uint32)  # (n, 128)
    w = ty * 8 + tx

    def lerp(c00, c10, c01, c11, fx, fy):
        top = c00 + (c10 - c00) * fx
        bot = c01 + (c11 - c01) * fx
        return top + (bot - top) * fy

    out = []
    for c2 in range(4):
        taps = [np.take_along_axis(row, (c2 * 32 + w + o)[:, None], 1)[:, 0] for o in (0, 1, 8, 9)]
        for half in (0, 1):
            c = [((t >> 16) if half else (t & 0xFFFF)).astype(np.float32) * dq for t in taps]
            out.append(lerp(*c, fx, fy))
    e = np.take_along_axis(row, 16 * eq[:, None] + np.arange(16), 1).view(np.float32)
    with np.errstate(all="ignore"):
        for i in range(4):
            out.append(lerp(e[:, i], e[:, 4 + i], e[:, 8 + i], e[:, 12 + i], efx, efy))
    return np.stack(out)


def test_tile_tap_resolve_plain_matches_jax():
    """The plain K9 on real tile rows and env rows: against numpy f32 bit
    for bit, against the JAX kernel (interpret mode) to 1e-6, on the
    texture channels where a tile row is read and the env channels where an
    env row is read."""
    rng = np.random.default_rng(3)
    tiles, meta = build.build_tile_atlas(_tile_images())
    env = rng.uniform(0, 4, (4, 128)).astype(np.float32)
    table = np.concatenate([tiles, env.view(np.int32)])
    n = 4096
    is_env = rng.uniform(size=n) < 0.3
    mat = rng.integers(0, 2, n)
    u = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, n).astype(np.float32)
    row, ty, tx, fx, fy = (a.numpy() for a in sampling.tile_index(
        *(torch.from_numpy(meta[mat, k].astype(np.float32)) for k in range(4)),
        torch.from_numpy(u), torch.from_numpy(v)))
    idx = np.where(is_env, len(tiles) + rng.integers(0, 4, n), row).astype(np.int32)
    eq = rng.integers(0, 8, n).astype(np.int32)
    efx, efy = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    args = (idx, ty, tx, eq, fx, fy, efx, efy)
    got = sampling.tile_tap_resolve(torch.from_numpy(table), *map(torch.from_numpy, args)).numpy()
    exact = _tile_tap_numpy(table, *args)
    want = np.asarray(jsampling.tile_tap_resolve(
        jnp.asarray(table)[idx], *(jnp.asarray(a) for a in args[1:]))).reshape(16, n)
    assert got.shape == (16, n)
    for ch, cols in ((slice(0, 8), ~is_env), (slice(8, 12), is_env)):
        np.testing.assert_array_equal(got[ch, cols], exact[ch, cols])
        assert np.abs(got[ch, cols] - want[ch, cols]).max() <= 1e-6
    np.testing.assert_array_equal(got[12:], np.zeros((4, n), np.float32))


def _frame_inputs():
    jp = j_default_params(aspect=W / H)
    jp = dataclasses.replace(
        jp,
        camera=dataclasses.replace(jp.camera, eye=jnp.asarray([0.0, 4.0, 3.0]),
                                   rotation=jnp.asarray([-25.0, -90.0])),
        point_lights=JPointLights.from_list([((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))]),
    )
    return JRenderConfig(width=W, height=H, shadow_size=SHADOW), jp, j_default_settings()


@pytest.fixture(scope="module")
def tile_frames():
    """The Cornell frame on the tile route through JAX (rendered once) and
    the port, and the port's quad-route frame."""
    jc, jp, js = _frame_inputs()
    scene = jproc.cornell_like_scene()
    jb = jbuild.build_buffers(*scene, tri_bucket=256, tile_threshold_texels=0)
    jimg, jstats = jpipe.make_renderer_stats(jc)(jb, jp, js)
    tc, tp, ts = convert.render_config(jc), convert.scene_params(jp), convert.settings(js)
    tile_bufs = build.build_buffers(*scene, tri_bucket=256, tile_threshold_texels=0, device="cpu")
    quad_bufs = build.build_buffers(*scene, tri_bucket=256, device="cpu")
    timg, tstats = pipeline.render_frame_stats(tile_bufs, tp, ts, tc)
    qimg, _ = pipeline.render_frame_stats(quad_bufs, tp, ts, tc)
    return dict(
        jax=(np.asarray(jimg), {k: int(v) for k, v in jstats.items()}),
        port=(timg.numpy(), {k: int(v) for k, v in tstats.items()}),
        quad=qimg.numpy(),
    )


def test_tile_frame_within_one_lsb_of_jax(tile_frames):
    (jimg, jstats), (timg, tstats) = tile_frames["jax"], tile_frames["port"]
    assert timg.shape == jimg.shape == (H, W, 3)
    d = np.abs(timg.astype(np.int32) - jimg.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    assert tstats == jstats
    assert timg.mean() > 20


def test_tile_frame_close_to_quad_frame(tile_frames):
    """u16-linear texels against bf16 texels: texel-quantisation noise only."""
    timg, qimg = tile_frames["port"][0], tile_frames["quad"]
    assert golden.psnr(timg, qimg) >= 45.0
    assert np.abs(timg.astype(np.int32) - qimg.astype(np.int32)).max() <= 8


@pytest.mark.parametrize("name", ["bench_golden.png", "bench_tex1024.png"])
def test_png_reader_matches_pillow(name):
    """chip_smoke.read_golden (the port's io/images: zlib + numpy, for the
    card's machine, which has no Pillow) against Pillow on the goldens it
    reads."""
    image = pytest.importorskip("PIL.Image")
    import chip_smoke

    with image.open(os.path.join(GOLDENS, name)) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(chip_smoke.read_golden(name), want)


def test_png_reader_refuses_other_pngs(tmp_path):
    """A PNG the decoder does not cover (here 16-bit gray) raises
    RenderError naming the file; it is never read as another image."""
    image = pytest.importorskip("PIL.Image")
    from arctic_tpu_torch.io import images
    from arctic_tpu_torch.utils.errors import RenderError

    path = tmp_path / "grey16.png"
    image.fromarray(np.zeros((4, 4), np.uint16)).save(path)
    with pytest.raises(RenderError, match="grey16.png: PNG bit depth 16"):
        images.load_ldr(str(path))
