"""ctypes bindings for the optional C++ host-path library — the port's own
copy of arctic_tpu/io/native.py.

The library is built from the repo's ``native/arctic_native.cpp`` (``make
-C native``) into ``native/libarctic_native.so``; nothing builds it at
import. Where it is present, io/build.compute_tangents and io/images.load_hdr
take it (RGBE decode, per-vertex tangent frames); without it they take their
numpy paths, which give the same arrays.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libarctic_native.so"

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


@functools.cache
def library() -> ctypes.CDLL | None:
    """The library loaded from LIB_PATH, or None where no file is there."""
    if not LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.arctic_load_hdr.restype = ctypes.c_int
    lib.arctic_load_hdr.argtypes = [
        ctypes.c_char_p, _IP, _IP, ctypes.POINTER(_FP),
    ]
    lib.arctic_free.argtypes = [ctypes.c_void_p]
    lib.arctic_compute_tangents.restype = ctypes.c_int
    lib.arctic_compute_tangents.argtypes = [
        _FP, _FP, _FP, ctypes.c_int,  # positions, normals, uvs, n verts
        _IP, ctypes.c_int,  # indices, n tris
        _FP, _FP,  # out tangents, out bitangents
    ]
    return lib


def available() -> bool:
    return library() is not None


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr -> (H, W, 3) f32 through the library."""
    lib = library()
    w, h = ctypes.c_int(), ctypes.c_int()
    ptr = _FP()
    rc = lib.arctic_load_hdr(str(path).encode(), ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(ptr))
    if rc != 0:
        raise IOError(f"arctic_load_hdr failed ({rc}) for {path}")
    try:
        n = w.value * h.value * 3
        return np.ctypeslib.as_array(ptr, shape=(n,)).reshape(h.value, w.value, 3).copy()
    finally:
        lib.arctic_free(ptr)


def compute_tangents(positions, normals, uvs, indices):
    """Per-vertex (tangents, bitangents), each (V, 3) f32, through the library."""
    lib = library()
    positions = np.ascontiguousarray(positions, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    uvs = np.ascontiguousarray(uvs, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    n = len(positions)
    tan = np.zeros((n, 3), np.float32)
    btn = np.zeros((n, 3), np.float32)
    rc = lib.arctic_compute_tangents(
        positions.ctypes.data_as(_FP), normals.ctypes.data_as(_FP), uvs.ctypes.data_as(_FP), n,
        indices.ctypes.data_as(_IP), len(indices),
        tan.ctypes.data_as(_FP), btn.ctypes.data_as(_FP),
    )
    if rc != 0:
        raise RuntimeError("arctic_compute_tangents failed")
    return tan, btn
