"""The port's bindings of the optional C++ host library (io/native.py):
native/arctic_native.cpp built with the C++ compiler into a temporary
directory, then io/build.compute_tangents and io/images.load_hdr through it
against their numpy paths.

Tolerances: the HDR decode is bit-equal (integer RGBE arithmetic and one
ldexp a texel); the tangent frames within 2e-5 absolute (the C++ loop
accumulates face tangents in another order than numpy's np.add.at, as
tests/test_native.py allows for the JAX package's bindings). Without a
C++ compiler the module skips; without the built library both functions
take the numpy paths.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from arctic_tpu_torch.io import build, images, native, procedural

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib_path(tmp_path_factory):
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler found to build native/arctic_native.cpp")
    out = tmp_path_factory.mktemp("native") / "libarctic_native.so"
    subprocess.run([cxx, "-O3", "-fPIC", "-shared", "-std=c++17", "-o", str(out),
                    os.path.join(REPO, "native", "arctic_native.cpp")], check=True)
    return out


@pytest.fixture
def with_native(lib_path, monkeypatch):
    """io/native.py pointed at the freshly built library."""
    monkeypatch.setattr(native, "LIB_PATH", lib_path)
    native.library.cache_clear()
    yield native.library()
    native.library.cache_clear()


def test_library_is_optional(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "missing.so")
    native.library.cache_clear()
    try:
        assert not native.available()
        m = procedural.uv_sphere(1.0, 8, 12)
        t, b = build.compute_tangents(m.positions, m.normals, m.uvs, m.indices)
        tn, bn = build.compute_tangents_np(m.positions, m.normals, m.uvs, m.indices)
        np.testing.assert_array_equal(t, tn)
        np.testing.assert_array_equal(b, bn)
    finally:
        native.library.cache_clear()


@pytest.mark.parametrize("mesh", ["sphere", "box", "plane"])
def test_native_tangents_match_numpy(with_native, mesh):
    m = {"sphere": procedural.uv_sphere(1.0, 8, 12), "box": procedural.box_mesh(2.0, 1.0, 3.0),
         "plane": procedural.plane_mesh(4.0, uv_scale=2.0)}[mesh]
    assert native.available()
    t, b = build.compute_tangents(m.positions, m.normals, m.uvs, m.indices)  # the library
    tn, bn = build.compute_tangents_np(m.positions, m.normals, m.uvs, m.indices)
    assert t.dtype == tn.dtype == np.float32 and t.shape == tn.shape
    np.testing.assert_allclose(t, tn, atol=2e-5)
    np.testing.assert_allclose(b, bn, atol=2e-5)


@pytest.mark.parametrize("shape", [(8, 16), (5, 7), (33, 64)])
def test_native_hdr_matches_numpy(with_native, tmp_path, shape):
    rng = np.random.default_rng(shape[0])
    img = (rng.uniform(0, 20, shape + (3,)) ** 2).astype(np.float32)
    img[0, 0] = 0.0
    path = str(tmp_path / "n.hdr")
    images.save_hdr(path, img)
    got = images.load_hdr(path)  # the library
    want = images.load_hdr_np(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.load_hdr(path), want)


def test_native_hdr_error_falls_back_to_numpy_message(with_native, tmp_path):
    """A file the library cannot read goes on to the numpy decoder, which
    names what is wrong with it."""
    path = tmp_path / "bad.hdr"
    path.write_bytes(b"not an hdr\n")
    with pytest.raises((ValueError, IOError)):
        images.load_hdr(str(path))
