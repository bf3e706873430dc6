"""arctic_tpu_torch core: maths and tonemap held against the JAX package on
seeded inputs, plus three guards — the port imports no JAX, its kernel
loader raises (never falls back) when nvcc is missing, and every kernel it
registers and binds is in the sources it builds.

Tolerances: jnp.cross / jnp.linalg.norm / jnp.dot run as compiled XLA
computations that contract into FMAs, and at steep pitch cross(f, up)
cancels, which scales those roundings up: the view, sun and proj_view
matrices are held to 16 ulp of each row's largest entry (measured: <= 10).
Tonemap operators and the gamma curve, each on the same inputs, lie in
[0, 1] and go through exp/pow of two libms: 4 ulp of 1.0 (measured: <= 0.5
and <= 0.125 of the bound); the whole chain is held at its u8 store, within
1 LSB. Elementwise +-*/ chains and the u8 store are exact on identical
inputs.
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
    """Each stage of the chain on its own inputs, then the stored u8.

    The whole chain is not held to an ulp bound: at the planted texel
    c = 1e-6 torch's exp and XLA's exp may differ by 1 ulp near 1.0, so
    1 - exp(-1.4e-6) cancels to 1.4305e-6 in one and 1.3709e-6 in the
    other, and pow(x, 1/2.2) spreads that to 0.0022050 vs 0.0021627 (both
    store as u8 1). Which exp a host's vector unit takes decides it."""
    c = _hdr(tm_method)
    exposure = np.float32(1.4)
    tc, jc = torch.from_numpy(c), jnp.asarray(c)
    ops = [
        (tonemap.tm_reinhard, jtonemap.tm_reinhard),
        (lambda x: tonemap.tm_exposure(x, torch.tensor(exposure)),
         lambda x: jtonemap.tm_exposure(x, jnp.float32(exposure))),
        (tonemap.tm_aces, lambda x: jtonemap.tm_aces(x, channel_axis=0)),
    ]
    op, jop = ops[tm_method]
    mapped = np.asarray(jop(jc))
    assert_ulp(op(tc).numpy(), mapped, 4, scale=1.0)
    assert_ulp(
        tonemap.correct_gamma(torch.from_numpy(mapped.copy()), torch.tensor(gamma)).numpy(),
        np.asarray(jtonemap.correct_gamma(jnp.asarray(mapped), jnp.float32(gamma))),
        4, scale=1.0,
    )
    got = tonemap.to_unorm8(
        tonemap.tonemap(tc, tm_method, torch.tensor(gamma), torch.tensor(exposure))
    ).numpy()
    want = np.asarray(jtonemap.to_unorm8(jtonemap.tonemap(
        jc, jnp.int32(tm_method), jnp.float32(gamma), jnp.float32(exposure), channel_axis=0
    )))
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_to_unorm8_matches_jax():
    rng = np.random.default_rng(3)
    c = rng.uniform(-0.2, 1.2, (3, 32, 32)).astype(np.float32)
    c[0, 0, :3] = [0.5 / 255, 1.5 / 255, 2.5 / 255]  # round-half-even points
    got = tonemap.to_unorm8(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtonemap.to_unorm8(jnp.asarray(c))))


def test_port_imports_no_jax():
    """Every arctic_tpu_torch module imports without pulling in JAX, any
    module of the JAX package or Pillow (the card's machine has neither)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import arctic_tpu_torch\n"
        "for m in pkgutil.walk_packages(arctic_tpu_torch.__path__, 'arctic_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'arctic_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('arctic_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40  # io/native, io/texplan, ops/rt, models/raytrace among them


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda *_: None)
    monkeypatch.setattr(kernels, "NVCC_FALLBACKS", ())
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build_library(tmp_path)
    assert not list(tmp_path.iterdir())  # nothing half-built is left behind


def test_kernel_registry_matches_the_sources():
    """Every registered kernel names a source file that exists and is built,
    and every launcher and query the loader binds is defined, with C
    linkage, in one of the sources it compiles (K3 and K11 share a file)."""
    from arctic_tpu_torch.models import pipeline, raytrace  # noqa: F401 (registers every kernel)

    sources = {src.relative_to(REPO).as_posix() for src in kernels.sources()}
    assert len(kernels.KERNELS) == 14
    for fn in kernels.KERNELS:
        assert fn.source in sources, (fn.kernel_name, fn.source)
    text = "".join(open(os.path.join(REPO, src)).read() for src in sources)
    for name in {**kernels._SIGNATURES, **kernels._QUERIES}:
        assert f'extern "C" int {name}(' in text, name
