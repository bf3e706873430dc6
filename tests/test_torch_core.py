"""arctic_tpu_torch core: maths and tonemap held against the JAX package on
seeded inputs, plus two guards — the port imports no JAX, and its kernel
loader raises (never falls back) when nvcc is missing.

Tolerances: jnp.cross / jnp.linalg.norm / jnp.dot run as compiled XLA
computations that contract into FMAs, and at steep pitch cross(f, up)
cancels, which scales those roundings up: the view, sun and proj_view
matrices are held to 16 ulp of each row's largest entry (measured: <= 10).
Tonemapped values lie in [0, 1] and go through exp/pow of two libms: 4 ulp
of 1.0 (measured: <= 3.1). Elementwise +-*/ chains and the u8 store are
exact on identical inputs.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core import maths as jmaths
from arctic_tpu.ops import tonemap as jtonemap
from arctic_tpu_torch.core import maths
from arctic_tpu_torch.ops import tonemap
from arctic_tpu_torch.utils import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_ulp(got, want, ulps=2, scale=None):
    """|got - want| <= ulps * ulp(scale), scale defaulting to |want| (or
    the given per-array magnitude, for entries that cancel towards 0)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ref = np.abs(want) if scale is None else np.float32(scale)
    tol = ulps * np.spacing(np.maximum(ref, np.finfo(np.float32).tiny))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err <= tol), (err.max(), (err / tol).max())


def _rng_cameras(seed, n=6):
    rng = np.random.default_rng(seed)
    eyes = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    rots = np.stack([rng.uniform(-80, 80, n), rng.uniform(-180, 180, n)], 1).astype(np.float32)
    return eyes, rots


@pytest.mark.parametrize("seed", [0, 1])
def test_dir_from_rot_matches_jax(seed):
    _, rots = _rng_cameras(seed)
    got = maths.dir_from_rot(torch.from_numpy(rots)).numpy()
    want = np.asarray(jmaths.dir_from_rot(jnp.asarray(rots)))
    assert_ulp(got, want, scale=1.0)


def _assert_rows_ulp(got, want, ulps):
    for r in range(4):
        assert_ulp(got[r], want[r], ulps, scale=np.abs(want[r]).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_proj_view_matches_jax(seed):
    eyes, rots = _rng_cameras(seed)
    for eye, rot in zip(eyes, rots):
        e, r = torch.from_numpy(eye), torch.from_numpy(rot)
        je, jr = jnp.asarray(eye), jnp.asarray(rot)
        _assert_rows_ulp(
            maths.camera_view_matrix(e, r).numpy(),
            np.asarray(jmaths.camera_view_matrix(je, jr)), 16,
        )
        args = (1.5, 45.0, 0.1, 1000.0)
        _assert_rows_ulp(
            maths.camera_proj_view(e, r, *args).numpy(),
            np.asarray(jmaths.camera_proj_view(je, jr, *args)), 16,
        )


@pytest.mark.parametrize("seed", [0, 1])
def test_sun_proj_view_matches_jax(seed):
    eyes, rots = _rng_cameras(seed)
    for pos, rot in zip(eyes, rots):
        got = maths.sun_proj_view(torch.from_numpy(pos), torch.from_numpy(rot)).numpy()
        want = np.asarray(jmaths.sun_proj_view(jnp.asarray(pos), jnp.asarray(rot)))
        _assert_rows_ulp(got, want, 16)


def test_projection_matrices_match_jax():
    got = maths.perspective_rh_zo(0.8, 1.25, 0.1, 500.0).numpy()
    want = np.asarray(jmaths.perspective_rh_zo(0.8, 1.25, 0.1, 500.0))
    assert_ulp(got, want)
    got = maths.ortho_rh_zo(*maths.SUN_ORTHO).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmaths.ortho_rh_zo(*jmaths.SUN_ORTHO)))
    q = np.asarray([0.9, 0.1, -0.3, 0.3], np.float32)
    q /= np.linalg.norm(q)
    got = maths.trs_compose([1.0, -2.0, 3.0], q, [2.0, 0.5, 1.0]).numpy()
    want = np.asarray(jmaths.trs_compose(jnp.asarray([1.0, -2.0, 3.0]), jnp.asarray(q), jnp.asarray([2.0, 0.5, 1.0])))
    assert_ulp(got, want, scale=2.0)


def _hdr(seed):
    rng = np.random.default_rng(seed)
    c = rng.gamma(0.8, 1.5, (3, 24, 40)).astype(np.float32)
    c[:, 0, :4] = [[0.0], [1e-6], [30.0]]  # dark, tiny and hot texels
    return c


@pytest.mark.parametrize("gamma", [1.0, 2.2])
@pytest.mark.parametrize("tm_method", [0, 1, 2])
def test_tonemap_matches_jax(tm_method, gamma):
    c = _hdr(tm_method)
    exposure = np.float32(1.4)
    got = tonemap.tonemap(torch.from_numpy(c), tm_method, torch.tensor(gamma), torch.tensor(exposure)).numpy()
    want = np.asarray(
        jtonemap.tonemap(jnp.asarray(c), jnp.int32(tm_method), jnp.float32(gamma), jnp.float32(exposure), channel_axis=0)
    )
    assert_ulp(got, want, 4, scale=1.0)


def test_to_unorm8_matches_jax():
    rng = np.random.default_rng(3)
    c = rng.uniform(-0.2, 1.2, (3, 32, 32)).astype(np.float32)
    c[0, 0, :3] = [0.5 / 255, 1.5 / 255, 2.5 / 255]  # round-half-even points
    got = tonemap.to_unorm8(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtonemap.to_unorm8(jnp.asarray(c))))


def test_port_imports_no_jax():
    """Every arctic_tpu_torch module imports without pulling in JAX or any
    module of the JAX package (the card's machine has no JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import arctic_tpu_torch\n"
        "for m in pkgutil.walk_packages(arctic_tpu_torch.__path__, 'arctic_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'arctic_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('arctic_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda *_: None)
    monkeypatch.setattr(kernels, "NVCC_FALLBACKS", ())
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build_library(tmp_path)
    assert not list(tmp_path.iterdir())  # nothing half-built is left behind
