"""arctic_tpu_torch shading ops held against the JAX package on seeded
inputs: the f32 runs-path PCF (K16's wrapper and plain version on CPU
tensors too), the plain version of K6 (tap_resolve), the
sky and the channel-first PBR.

Tolerances:
- PCF (runs path, use_lut=False): exact — window fetch and the 25 bilinear
  taps are the same f32 +-* chain, eager on both sides;
- quad_index: exact (integer math and one f32 multiply-subtract);
- K6 plain vs JAX tap_resolve in interpret mode: <= 1e-6 absolute on O(1)
  texels (the interpreted kernel contracts its lerps into FMAs, measured
  up to 4.8e-7);
- sky rays and equirect uv: <= 1e-6 relative to each plane's magnitude
  (atan2 / asin / tan come from different libms);
- the env tap: <= 1e-5 relative (u and v are scaled by the region size
  before the bilinear fraction, so a 1-ulp atan2 difference moves the
  weights by ~size ulps; measured 1.6e-6);
- PBR: jnp.sum runs compiled with FMAs, and GGX at low roughness cancels
  (1 - n.h^2), which turns 1-ulp dot differences into ~1e-4 relative ones.
  So the port is held to the float64 evaluation of the same formulas: no
  further from it than JAX is (x1.25), and within 1e-6 relative of JAX on
  99% of the values.
"""

import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from arctic_tpu.ops import pbr as jpbr
from arctic_tpu.ops import sampling as jsampling
from arctic_tpu.ops import shadow as jshadow
from arctic_tpu.ops import sky as jsky
from arctic_tpu_torch.core.scene import make_camera
from arctic_tpu_torch.ops import pbr, sampling, shadow, sky
from arctic_tpu_torch.utils import convert


def _close(got, want, rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("size", [48, 61, 2])
def test_pcf_runs_path_exact(size):
    rng = np.random.default_rng(size)
    smap = rng.uniform(0.2, 1.0, (size, size)).astype(np.float32)
    smap[rng.uniform(size=(size, size)) < 0.3] = 1.0  # cleared texels
    n = (40, 50)
    x = rng.uniform(-1.1, 1.1, n).astype(np.float32)
    y = rng.uniform(-1.1, 1.1, n).astype(np.float32)
    z = rng.uniform(0.1, 1.05, n).astype(np.float32)
    x[0, :4] = [-1.0, 1.0, -0.999, 0.999]  # windows that wrap across edges
    y[0, :4] = [1.0, -1.0, 0.999, -0.999]
    want = np.asarray(
        jshadow.pcf_shadow_proj(jnp.asarray(smap), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), use_lut=False)
    )
    args = [torch.from_numpy(a) for a in (smap, x, y, z)]
    got = shadow.pcf_shadow_proj(*args).numpy()
    assert 0.05 < (want > 0).mean() < 0.95
    np.testing.assert_array_equal(got, want)
    # K16's wrapper takes its plain version for CPU tensors: the same path.
    shadow.pcf_runs.launches = 0
    for fn in (shadow.pcf_runs, shadow.pcf_runs_plain):
        np.testing.assert_array_equal(fn(*args).numpy(), want)
    assert shadow.pcf_runs.launches == 0


def _regions(rng, n):
    ry = rng.integers(0, 60, n).astype(np.float32)
    rx = rng.integers(0, 60, n).astype(np.float32)
    rh = rng.integers(1, 40, n).astype(np.float32)
    rw = rng.integers(1, 40, n).astype(np.float32)
    u = rng.uniform(-2, 3, n).astype(np.float32)
    v = rng.uniform(-2, 3, n).astype(np.float32)
    return ry, rx, rh, rw, u, v


def test_quad_index_exact():
    rng = np.random.default_rng(0)
    args = _regions(rng, 5000)
    jq = jsampling.quad_index((51, 77), *(jnp.asarray(a) for a in args))
    tq = sampling.quad_index((51, 77), *(torch.from_numpy(a) for a in args))
    for g, w in zip(tq, jq):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("c4", [48, 32, 16])
def test_k6_plain_matches_tap_resolve(c4):
    rng = np.random.default_rng(c4)
    p = 4096
    per = 128 // c4
    rows = rng.uniform(0, 4, (p, 128)).astype(np.float32).astype(ml_dtypes.bfloat16)
    tq = rng.integers(0, per, p).astype(np.int32)
    eq = rng.integers(0, 8, p).astype(np.int32)
    fr = [rng.uniform(0, 1, p).astype(np.float32) for _ in range(4)]
    want = np.asarray(
        jsampling.tap_resolve(jnp.asarray(rows), jnp.asarray(tq), jnp.asarray(eq), *(jnp.asarray(f) for f in fr), c4=c4)
    ).reshape(16, p)
    # The port gathers its row inside K6: identity indices into the table.
    idx = torch.arange(p, dtype=torch.int32)
    got = sampling.tap_resolve(
        convert.tensor(rows), idx, torch.from_numpy(tq), torch.from_numpy(eq),
        *(torch.from_numpy(f) for f in fr), c4=c4,
    ).numpy()
    np.testing.assert_array_equal(got[c4 // 4 + 4 :], 0.0)
    assert np.abs(got - want).max() <= 1e-6


def _camera_np(seed):
    rng = np.random.default_rng(seed)
    eye = rng.uniform(-5, 5, 3).astype(np.float32)
    rot = np.asarray([rng.uniform(-60, 60), rng.uniform(-180, 180)], np.float32)
    return eye, rot


@pytest.mark.parametrize("seed", [0, 1])
def test_sky_matches_jax(seed):
    eye, rot = _camera_np(seed)
    w, h = 96, 64
    jcam = types.SimpleNamespace(
        eye=jnp.asarray(eye), rotation=jnp.asarray(rot), aspect=jnp.float32(w / h),
        fov_y=jnp.float32(45.0),
    )
    tcam = make_camera(eye, rot, w / h)
    py, px = np.mgrid[0:h, 0:w].astype(np.float32) + np.float32(0.5)
    jd = jsky.camera_ray_dirs_cf(jcam, jnp.asarray(px), jnp.asarray(py), w, h)
    td = sky.camera_ray_dirs_cf(tcam, torch.from_numpy(px), torch.from_numpy(py), w, h)
    for g, want in zip(td, jd):
        _close(g.numpy(), want)
    ju, jv = jsky.env_uv_cf(*jd)
    tu, tv = sky.env_uv_cf(*(convert.tensor(d) for d in jd))
    _close(tu.numpy(), ju)
    _close(tv.numpy(), jv)


def test_sample_environment_matches_jax():
    rng = np.random.default_rng(5)
    env = rng.uniform(0, 3, (16, 32, 3)).astype(np.float32)
    from arctic_tpu.io.build import build_buffers as jbuild
    from arctic_tpu.io.procedural import cornell_like_scene

    meshes, objects, materials, _ = cornell_like_scene()
    jb = jbuild(meshes, objects, materials, env, tri_bucket=256)
    tb = convert.scene_buffers(jb)
    d = [rng.uniform(-1, 1, (24, 40)).astype(np.float32) for _ in range(3)]
    want = jsky.sample_environment_cf(jb.environment, *(jnp.asarray(a) for a in d))
    e = tb.environment
    env_rows = tb.atlas.combined_env_rows[-e.num_rows :]
    got = sky.sample_environment_cf(env_rows, e.block_grid, e.region, *(torch.from_numpy(a) for a in d))
    for g, w in zip(got, want):
        _close(g.numpy(), w, rel=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_pbr_matches_jax(seed):
    rng = np.random.default_rng(seed)
    shape = (32, 48)

    def unit(n):
        v = rng.standard_normal((3,) + shape).astype(np.float32)
        return v / np.sqrt((v * v).sum(0, keepdims=True))

    n_, wo, wi = unit(3), unit(3), unit(3)
    rad = rng.uniform(0, 10, (3,) + shape).astype(np.float32)
    base = rng.uniform(0, 1, (3,) + shape).astype(np.float32)
    metal = rng.uniform(0, 1, (1,) + shape).astype(np.float32)
    rough = rng.uniform(0.05, 1, (1,) + shape).astype(np.float32)
    args = (n_, wo, wi, rad, base, metal, rough)
    want = np.asarray(jpbr.outgoing_radiance_cf(*(jnp.asarray(a) for a in args)))
    got = pbr.outgoing_radiance_cf(*(torch.from_numpy(a) for a in args)).numpy()
    truth = pbr.outgoing_radiance_cf(*(torch.from_numpy(a).double() for a in args)).numpy()
    assert np.abs(got - truth).max() <= 1.25 * np.abs(want - truth).max()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert np.quantile(rel, 0.99) <= 1e-6
