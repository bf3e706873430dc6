"""arctic_tpu_torch raster front end and the plain versions of K1, K3, K4
held against the JAX package on the same inputs (numpy in, both sides).

Tolerances:
- near clip, triangle setup and binning: exact (pure f32 +-*/ and integer
  math, eager on both sides), up to subnormals: XLA's CPU backend flushes
  them to zero and torch keeps them, so subnormal results compare as 0;
- K1 plain: ibuf exact against JAX's rasterize_bruteforce; zbuf within the
  reference's own 2e-6 (tests/test_raster_tiles.py:17-23 — the brute force
  evaluates planes as a matmul that rounds differently), and exact against
  the same planes evaluated as (A*px + B*py) + C in numpy;
- K3 plain vs JAX build_shade_rows: raster lanes 0:16 / 112:128 and the
  material lanes exact on valid slots and padding rows (invalid slots are
  never binned; a subnormal intermediate there flushes to 0 under XLA);
  blended lanes within 1e-5 relative on valid slots, the reference's own
  bound (test_shade_rows_pack.py:73-83: the JAX kernel contracts FMAs);
- K4 plain vs the untiled JAX raster_gbuffer: material lanes exact on
  covered pixels, uncovered pixels all zero. Interpolated lanes: the
  perspective divide amplifies rounding at ill-conditioned pixels, where
  both versions sit up to ~3e-5 from the float64 interpolation of the same
  rows (values up to ~10) — so the port is held within 5e-5 absolute of
  JAX and no further from the float64 truth than JAX itself (x1.25). A
  relative bound of 2e-6 does not hold: measured on this frame, the two
  differ on 15% of 459,504 covered values, by at most 3.23e-5 absolute (on
  a value of 1.93), by up to 1.7e-5 relative on values >= 1 and 2.8e-3
  relative on near-zero attributes (4e-8 absolute on 1.4e-5); 2,279
  values exceed 2e-6 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.config import RenderConfig
from arctic_tpu.core.scene import default_scene_params
from arctic_tpu.io.build import build_buffers
from arctic_tpu.io.procedural import cornell_like_scene
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu.ops import binning as jbinning
from arctic_tpu.ops import raster as jraster
from arctic_tpu.ops import raster_tiles as jrt
from arctic_tpu_torch.core.config import RenderConfig as TorchRenderConfig
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import binning, raster, raster_tiles
from arctic_tpu_torch.utils import convert

W, H = 160, 96


def _np_tree(x):
    if isinstance(x, (tuple, list)):
        return [_np_tree(v) for v in x]
    return np.asarray(x)


def _ftz(a):
    """Subnormal floats -> 0 (XLA's CPU flush-to-zero)."""
    a = np.asarray(a)
    if a.dtype.kind != "f":
        return a
    return np.where(np.abs(a) < np.finfo(a.dtype).tiny, np.zeros_like(a), a)


def _assert_tree_equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        np.testing.assert_array_equal(_ftz(got), _ftz(want))


@pytest.fixture(scope="module")
def scene():
    """The Cornell scene through the JAX fused path's front end."""
    bufs = build_buffers(*cornell_like_scene(), tri_bucket=256)
    params = default_scene_params(aspect=W / H)
    cam = dataclasses.replace(
        params.camera, eye=jnp.asarray([0.0, 4.0, 3.0]), rotation=jnp.asarray([-25.0, -90.0])
    )
    geom = bufs.geometry
    wc = jpipe.world_corners(geom)
    tri_valid = jnp.arange(geom.capacity) < geom.num_tris
    cam_clip = jpipe.corners_clip(wc, cam.proj_view())
    sun_pv = params.sun.proj_view()
    sun_clip = jpipe.corners_clip(wc, sun_pv)
    setup = jraster.setup_screen_triangles(
        jraster.near_clip_corners(cam_clip, tri_valid), W, H, cull="back"
    )
    shadow = jraster.setup_screen_triangles(
        jraster.near_clip_corners(sun_clip, tri_valid), 128, 128, cull="front"
    )
    return dict(
        bufs=bufs, geom=geom, wc=wc, tri_valid=tri_valid, cam_clip=cam_clip,
        sun_clip=sun_clip, sun_pv=sun_pv, cam_pv=cam.proj_view(), setup=setup,
        shadow=shadow,
    )


def _torch_tree(x):
    if isinstance(x, (tuple, list)):
        return tuple(_torch_tree(v) for v in x)
    return convert.tensor(x)


def _random_corners(seed, n=300):
    """Tri-major clip corners with a mix of all-in, one-in, two-in and
    all-out triangles against the near plane."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3.0, 3.0, (3, 4, n)).astype(np.float32)
    c[:, 3] = rng.uniform(0.2, 4.0, (3, n))
    c[:, 2] = rng.uniform(-1.0, 2.0, (3, n))
    valid = rng.uniform(size=n) < 0.9
    return c, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_near_clip_and_setup_exact(seed):
    c, valid = _random_corners(seed)
    jc = tuple(tuple(jnp.asarray(c[k, i]) for i in range(4)) for k in range(3))
    tc = tuple(tuple(torch.from_numpy(c[k, i]) for i in range(4)) for k in range(3))
    jclip = jraster.near_clip_corners(jc, jnp.asarray(valid))
    tclip = raster.near_clip_corners(tc, torch.from_numpy(valid))
    for f in ("cx", "cy", "cz", "cw", "cb", "valid"):
        _assert_tree_equal(getattr(tclip, f), _np_tree(getattr(jclip, f)))
    for cull in ("back", "front"):
        js = jraster.setup_screen_triangles(jclip, 96, 64, cull=cull)
        ts = raster.setup_screen_triangles(tclip, 96, 64, cull=cull)
        for f in ("sx", "sy", "w", "zplane", "edges", "inv_area2", "cb", "valid", "bbox"):
            _assert_tree_equal(getattr(ts, f), _np_tree(getattr(js, f)))


def test_scene_front_end_exact(scene):
    """world_corners / corners_clip / setup on the real scene buffers."""
    tb = convert.scene_buffers(scene["bufs"])
    wc = pipeline.world_corners(tb.geometry)
    _assert_tree_equal(wc, _np_tree(scene["wc"]))
    cam_pv = convert.tensor(scene["cam_pv"])
    clip = pipeline.corners_clip(wc, cam_pv)
    _assert_tree_equal(clip, _np_tree(scene["cam_clip"]))
    tri_valid = convert.tensor(scene["tri_valid"])
    setup = raster.setup_screen_triangles(raster.near_clip_corners(clip, tri_valid), W, H)
    _assert_tree_equal(setup.edges, _np_tree(scene["setup"].edges))
    _assert_tree_equal(setup.zplane, _np_tree(scene["setup"].zplane))


def _assert_binning_equal(jpairs, tpairs):
    ts = np.asarray(jpairs.tile_start)
    np.testing.assert_array_equal(tpairs.tile_start.numpy(), ts)
    assert int(tpairs.total_pairs) == int(jpairs.total_pairs)
    n = ts[-1]  # pairs past the last tile are the sentinel's: never read
    np.testing.assert_array_equal(tpairs.sorted_slot.numpy()[:n], np.asarray(jpairs.sorted_slot)[:n])


@pytest.mark.parametrize(
    "case", ["camera", "shadow_rect", "shadow_empty_rect", "overflow"]
)
def test_bin_triangles_exact(scene, case):
    if case == "camera":
        js, tiles_x, tiles_y, t, cap, rect = scene["setup"], 3, 2, 64, 67584, None
    else:
        js, tiles_x, tiles_y, t, cap = scene["shadow"], 8, 8, 16, 67584
        rect = {"shadow_rect": (1, 2, 6, 5), "shadow_empty_rect": (4, 0, 3, 7)}.get(case)
        if case == "overflow":  # far fewer slots than pairs: the tail drops
            cap = 128
    jpairs = jbinning.bin_triangles(
        js, tiles_x, tiles_y, t, t, cap,
        rect=None if rect is None else tuple(jnp.int32(v) for v in rect),
    )
    tpairs = binning.bin_triangles(
        convert.tri_setup(js), tiles_x, tiles_y, t, t, cap,
        rect=None if rect is None else tuple(torch.tensor(v) for v in rect),
    )
    if case == "overflow":
        assert int(jpairs.total_pairs) > cap
    _assert_binning_equal(jpairs, tpairs)


def test_k1_plain_matches_bruteforce(scene):
    js = scene["setup"]
    zb, ib = jraster.rasterize_bruteforce(js, H, W)
    ts = convert.tri_setup(js)
    config = TorchRenderConfig(width=W, height=H)
    z, i, pairs = raster_tiles.rasterize_tiled(ts, H, W, config)
    assert int(pairs) > 0
    np.testing.assert_array_equal(i.numpy(), np.asarray(ib))
    assert (i.numpy() >= 0).mean() > 0.3
    np.testing.assert_allclose(z.numpy(), np.asarray(zb), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(z.numpy(), _planes_z(js, i.numpy(), np.asarray(zb)))


def _planes_z(js, ibuf, zb):
    """The winning slot's z plane evaluated as (Az*px + Bz*py) + Cz in f32."""
    h, w = ibuf.shape
    py, px = np.mgrid[0:h, 0:w].astype(np.float32) + np.float32(0.5)
    s = np.maximum(ibuf, 0)
    az, bz, cz = (np.asarray(c)[s] for c in js.zplane)
    return np.where(ibuf >= 0, (az * px + bz * py) + cz, zb)


def test_k1_plain_depth_only_matches_bruteforce(scene):
    js = scene["shadow"]
    zb, _ = jraster.rasterize_bruteforce(js, 128, 128)
    config = TorchRenderConfig(width=W, height=H, shadow_size=128)
    z, i, _ = raster_tiles.rasterize_tiled(
        convert.tri_setup(js), 128, 128, config, depth_only=True
    )
    assert i is None
    assert (z.numpy() < 1.0).sum() > 100  # back faces of the boxes and sphere
    np.testing.assert_allclose(z.numpy(), np.asarray(zb), rtol=0, atol=2e-6)


def test_k1_plain_overflow_matches_jax_kernel():
    """pairs_per_tri=1, pair_reserve=0 (test_raster_tiles.py:75) with 16 px
    tiles: the pair buffer overflows, the first pairs in slot order survive
    and the ibuf equals the JAX tiled kernel's (interpret mode)."""
    rng = np.random.default_rng(0)
    n = 400
    c = rng.uniform(-1.0, 1.0, (3, 4, n)).astype(np.float32)
    c[:, 2], c[:, 3] = rng.uniform(0.1, 0.9, (3, n)), 1.0
    jc = tuple(tuple(jnp.asarray(c[k, i]) for i in range(4)) for k in range(3))
    js = jraster.setup_screen_triangles(
        jraster.near_clip_corners(jc, jnp.ones(n, bool)), 64, 64, cull="none"
    )
    small = dict(width=64, height=64, tile_h=16, tile_w=16, pairs_per_tri=1, pair_reserve=0)
    config = TorchRenderConfig(**small)
    z, i, pairs = raster_tiles.rasterize_tiled(convert.tri_setup(js), 64, 64, config)
    assert int(pairs) > config.pair_capacity(js.capacity)
    _, jib, jpairs = jrt.rasterize_tiled(js, 64, 64, RenderConfig(**small), with_pairs=True)
    assert int(jpairs) == int(pairs)
    np.testing.assert_array_equal(i.numpy(), np.asarray(jib))
    assert torch.isfinite(z).all() and (i >= 0).any()


def _jax_shade_rows(scene):
    lsp = tuple(c[:3] for c in scene["sun_clip"])
    return jpipe.build_shade_rows(scene["setup"], scene["geom"], scene["sun_pv"], wc=scene["wc"], lsp=lsp)


def test_k3_plain_matches_build_shade_rows(scene):
    want = np.asarray(_jax_shade_rows(scene))
    tb = convert.scene_buffers(scene["bufs"])
    wc = _torch_tree(scene["wc"])
    lsp = tuple(c[:3] for c in _torch_tree(scene["sun_clip"]))
    got = pipeline.build_shade_rows(convert.tri_setup(scene["setup"]), tb.geometry, wc, lsp).numpy()
    assert got.shape == want.shape
    p = scene["setup"].capacity
    valid = np.zeros(got.shape[0], bool)
    valid[:p] = np.asarray(scene["setup"].valid)
    assert valid.sum() > 50
    kept = valid.copy()
    kept[p:] = True  # padding rows: sid -2 / 0 and zero planes
    for lanes in (slice(0, 16), slice(88, 112), slice(112, 128)):
        np.testing.assert_array_equal(got[kept, lanes], want[kept, lanes])
    d = np.abs(got[valid] - want[valid])
    assert (d / np.maximum(np.abs(want[valid]), 1e-6)).max() < 1e-5


def test_k4_plain_matches_raster_gbuffer(scene):
    config = RenderConfig(width=W, height=H)
    rows = _jax_shade_rows(scene)
    ibuf_t, gbuf_t, _ = jrt.raster_gbuffer(scene["setup"], rows, H, W, config)
    tx, ty = config.tiles_x, config.tiles_y
    ibuf = np.asarray(jrt._untile(ibuf_t, ty, tx, 64, 64))
    want = np.stack(
        [np.asarray(jrt._untile(gbuf_t[k], ty, tx, 64, 64)) for k in range(64)]
    )
    got = raster_tiles.select_interp(convert.tensor(rows), convert.tensor(ibuf)).numpy()
    assert got.shape == want.shape
    cov = ibuf >= 0
    assert cov.mean() > 0.3
    np.testing.assert_array_equal(got[24:48][:, cov], want[24:48][:, cov])
    np.testing.assert_array_equal(got[:, ~cov], 0.0)
    np.testing.assert_array_equal(got[48:], want[48:])
    d = np.abs(got[:24][:, cov] - want[:24][:, cov])
    assert d.max() <= 5e-5, d.max()  # measured 3.23e-5; see the module docstring
    # float64 interpolation of the same rows at the same pixel centres
    r = np.asarray(rows).astype(np.float64)[np.maximum(ibuf, 0)]
    py, px = np.mgrid[0 : ibuf.shape[0], 0 : ibuf.shape[1]] + 0.5
    bw = [r[..., 3 * c] * px + r[..., 3 * c + 1] * py + r[..., 3 * c + 2] for c in range(3)]
    den = bw[0] + bw[1] + bw[2]
    den = np.where(den == 0, 1.0, den)
    truth = np.stack(
        [(bw[0] * r[..., 16 + j] + bw[1] * r[..., 40 + j] + bw[2] * r[..., 64 + j]) / den for j in range(24)]
    )[:, cov]
    err_port = np.abs(got[:24][:, cov] - truth).max()
    err_jax = np.abs(want[:24][:, cov] - truth).max()
    assert err_port <= 1.25 * err_jax, (err_port, err_jax)
