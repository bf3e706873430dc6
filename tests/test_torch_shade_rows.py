"""The full-stack shade-row build of arctic_tpu_torch (a Geometry without
slot_static_rows: models/pipeline.shade_row_stack and K10
transpose_pack_rows) and K11 pack_shade_rows_tm, held against the JAX
package's on the same seeded inputs, and the port's full-stack frame.

JAX's Pallas kernels run in interpret mode, as its own tests run them
(tests/test_shade_rows_pack.py); the port runs its kernels' plain versions.
Tolerances:
- K10 plain: exact (a transpose);
- full stack and K11 plain against JAX: lanes [0:16), [88:112) and
  [112:128) exact on valid slots and padding rows (invalid slots are never
  binned; a subnormal intermediate there flushes to 0 under XLA's CPU),
  blended lanes within 1e-5 relative on valid slots — the reference's own
  bound (test_shade_rows_pack.py:76-83: its kernels contract FMAs);
- the port's full stack against the port's K3 table, and K11 against K3 on
  the dup'd planes (the frame's and utils/synthetic.K11_CASES): every lane
  bit-equal, NaN positions included (invalid slots may hold 0/0 planes,
  the same in both);
- the full-stack frame at 96x64: every pixel within 1 LSB of the port's
  default frame, with equal stats (the reference's gate,
  test_shade_rows_pack.py:98-101), uncached and with a sun cache. The
  default frame is held to JAX's by test_torch_pipeline, and the full
  stack's table to JAX's above; a JAX full-stack frame would add ~90 s of
  interpret-mode lowering to the suite and test nothing more.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.config import RenderConfig as JRenderConfig
from arctic_tpu.core.scene import default_scene_params, default_settings
from arctic_tpu.io.build import build_buffers
from arctic_tpu.io.procedural import cornell_like_scene
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu.ops import raster as jraster
from arctic_tpu.ops import raster_tiles as jrt
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import raster_tiles
from arctic_tpu_torch.utils import convert, synthetic

W, H, SHADOW = 96, 64, 64
EYE, ROT = [0.0, 3.0, 1.0], [-15.0, -90.0]  # test_shade_rows_pack.py's camera
EXACT_LANES = (slice(0, 16), slice(88, 112), slice(112, 128))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module (the suite runs several test
    processes at once; an oversubscribed pool slows small CPU ops badly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    params = default_scene_params(aspect=W / H)
    return dataclasses.replace(
        params,
        camera=dataclasses.replace(params.camera, eye=jnp.asarray(EYE), rotation=jnp.asarray(ROT)),
    )


def _tree(x):
    if isinstance(x, (tuple, list)):
        return tuple(_tree(v) for v in x)
    return convert.tensor(x)


@pytest.fixture(scope="module", params=[384, 512])
def scene(request):
    """Cornell through the JAX fused front end at tri_bucket 384 (capacity
    not a multiple of 512) and 512 (a multiple: JAX's _tm branch would need
    p == 2 * cap + 1), with the port's copies of the same inputs."""
    bufs = build_buffers(*cornell_like_scene(), tri_bucket=request.param)
    params = _params()
    geom = bufs.geometry
    sun_pv = params.sun.proj_view()
    wc = jpipe.world_corners(geom)
    sun_clip = jpipe.corners_clip(wc, sun_pv)
    tri_valid = jnp.arange(geom.capacity) < geom.num_tris
    setup = jraster.setup_screen_triangles(
        jraster.near_clip_corners(jpipe.corners_clip(wc, params.camera.proj_view()), tri_valid),
        W, H, cull="back",
    )
    lsp = tuple(c[:3] for c in sun_clip)
    p = setup.capacity
    valid = np.zeros(-(-(p + 1) // 512) * 512, bool)
    valid[:p] = np.asarray(setup.valid)
    assert valid.sum() > 50  # the aimed camera sees the scene
    kept = valid.copy()
    kept[p:] = True  # padding rows: sid -2 / 0 and zero planes
    tgeom = convert.scene_buffers(bufs).geometry
    return dict(
        geom=geom, setup=setup, sun_pv=sun_pv, wc=wc, lsp=lsp, valid=valid, kept=kept,
        tgeom=tgeom, tsetup=convert.tri_setup(setup), twc=_tree(wc), tlsp=_tree(lsp),
    )


def _held_to_jax(got, want, valid, kept):
    assert got.shape == want.shape and got.shape[1] == 128
    for lanes in EXACT_LANES:
        np.testing.assert_array_equal(got[kept, lanes], want[kept, lanes])
    d = np.abs(got[valid] - want[valid])
    assert (d / np.maximum(np.abs(want[valid]), 1e-6)).max() < 1e-5


def _same(a, b):
    """Bit-equal up to NaN positions, which must agree."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(a[~nan_a], b[~nan_b])


def test_k10_plain_matches_jax():
    stacked = np.random.default_rng(0).standard_normal((128, 1024)).astype(np.float32)
    want = np.asarray(jrt.transpose_pack_rows(jnp.asarray(stacked)))
    got = raster_tiles.transpose_pack_rows(torch.from_numpy(stacked))
    assert got.is_contiguous() and got.shape == (1024, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_stack_matches_jax(scene):
    geom = dataclasses.replace(scene["geom"], slot_static_rows=None)
    want = np.asarray(jpipe.build_shade_rows(
        scene["setup"], geom, scene["sun_pv"], wc=scene["wc"], lsp=scene["lsp"]
    ))
    tgeom = dataclasses.replace(scene["tgeom"], slot_static_rows=None)
    got = pipeline.build_shade_rows(scene["tsetup"], tgeom, scene["twc"], scene["tlsp"]).numpy()
    _held_to_jax(got, want, scene["valid"], scene["kept"])


def test_full_stack_equals_k3_table(scene):
    args = scene["tsetup"], scene["tgeom"], scene["twc"], scene["tlsp"]
    k3 = pipeline.build_shade_rows(*args)
    full = pipeline.build_shade_rows(
        args[0], dataclasses.replace(args[1], slot_static_rows=None), *args[2:]
    )
    assert full.shape == k3.shape
    assert _same(full, k3)


def _tm_inputs(scene):
    """K3's planes of this frame split as K11 reads them: (24, N)
    slot-major, (18, cap) tri-major (the first copy of the dup'd wc / lsp
    rows) and the static rows."""
    pf = pipeline.shade_row_planes(scene["tsetup"], scene["tgeom"], scene["twc"], scene["tlsp"])
    cap = scene["tgeom"].capacity
    return pf, pf[:24].contiguous(), pf[24:42, :cap].contiguous(), scene["tgeom"].slot_static_rows


def test_k11_plain_equals_k3_on_dup_planes(scene):
    pf, pf24, tri, st = _tm_inputs(scene)
    p = scene["tsetup"].capacity
    assert p == 2 * tri.shape[1]
    got = raster_tiles.pack_shade_rows_tm(pf24, tri, st, p)
    assert _same(got, raster_tiles.pack_shade_rows(pf, st, p))


@pytest.mark.parametrize("scene", [512], indirect=True)
def test_k11_plain_matches_jax_at_its_slot_count(scene):
    """JAX's pack_shade_rows_tm takes only p == 2 * cap + 1 and a capacity
    that is a multiple of 512; K11 takes that p too. Slot 2 * cap is then a
    live slot id over zero planes."""
    _, pf24, tri, st = _tm_inputs(scene)
    cap = tri.shape[1]
    assert cap % 512 == 0
    p = 2 * cap + 1
    want = np.asarray(jrt.pack_shade_rows_tm(*(jnp.asarray(a.numpy()) for a in (pf24, tri, st)), p))
    got = raster_tiles.pack_shade_rows_tm(pf24, tri, st, p).numpy()
    _held_to_jax(got, want, scene["valid"], scene["kept"])
    assert got[2 * cap, 9] == want[2 * cap, 9] == float(2 * cap)


@pytest.mark.parametrize("case", list(synthetic.K11_CASES))
def test_k11_plain_equals_k3_plain_on_synthetic_cases(case):
    """K11's plain version on each utils/synthetic.K11_CASES input (the wrap
    at slot cap inside a 32-slot block, a zero tail, N < 2 * cap, N < cap,
    N < 32 at cap = 1, cap a multiple of 32; p at 0, N, 2 * cap and
    2 * cap + 1; 0.1% NaN / +-inf) equals K3's plain version on the dup'd
    48-row stack, built here with numpy: every lane bit-equal, NaN positions
    included."""
    pf, tri, st, p = synthetic.k11_inputs("cpu", case)
    n, cap = pf.shape[1], tri.shape[1]
    dup = np.zeros((18, n), np.float32)
    both = np.concatenate([tri.numpy(), tri.numpy()], axis=1)[:, :n]
    dup[:, : both.shape[1]] = both
    full = torch.from_numpy(np.concatenate([pf.numpy(), dup, np.zeros((6, n), np.float32)]))
    got = raster_tiles.pack_shade_rows_tm(pf, tri, st, p)
    assert got.shape == (n, 128) and p <= n
    assert _same(got, raster_tiles.pack_shade_rows(full, st, p))


@pytest.fixture(scope="module")
def frames():
    """The port's full-stack and default frames at 96x64, uncached and with
    a sun cache, as (image, stats)."""
    bufs = build_buffers(*cornell_like_scene(), tri_bucket=256)
    tb, tp, ts = convert.scene_buffers(bufs), convert.scene_params(_params()), convert.settings(default_settings())
    tconfig = convert.render_config(JRenderConfig(width=W, height=H, shadow_size=SHADOW))
    tfull = dataclasses.replace(tb, geometry=dataclasses.replace(tb.geometry, slot_static_rows=None))
    out = {}
    for name, b in (("full", tfull), ("default", tb)):
        for cached in (False, True):
            cache = pipeline.build_sun_cache(b, tp, tconfig)[0] if cached else None
            img, stats = pipeline.render_frame_stats(b, tp, ts, tconfig, sun_cache=cache)
            out[name, cached] = img.numpy(), {k: int(v) for k, v in stats.items()}
    return out


def _within_one_lsb_of_default(frames, cached):
    (img, stats), (default, dstats) = frames["full", cached], frames["default", cached]
    assert img.shape == default.shape == (H, W, 3)
    d = np.abs(img.astype(np.int32) - default.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert stats == dstats
    assert img.mean() > 20  # a lit scene


def test_full_stack_frame_within_one_lsb_of_default(frames):
    _within_one_lsb_of_default(frames, cached=False)


def test_full_stack_cached_frame_within_one_lsb_of_default(frames):
    """The sun-cache entry points take the route unchanged."""
    _within_one_lsb_of_default(frames, cached=True)
