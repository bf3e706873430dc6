"""The port's asset path (arctic_tpu_torch/io: images, gltf, obj, load,
gltf_export) against the JAX package's and Pillow, on the CPU.

PNGs are decoded by the port with zlib and numpy and must equal Pillow's
``convert("RGBA")`` on every supported colour type (crafted here with
every row filter and IDAT split over several chunks); the HDR codec must be
bit-equal to the JAX package's; the loaders must give the JAX loaders'
meshes, objects (in the same order), materials and environment exactly.
Pillow is needed only where Pillow itself is compared with.
"""

import base64
import io
import json
import logging
import os
import struct
import sys
import zlib

import numpy as np
import pytest

from arctic_tpu.io import gltf as jgltf
from arctic_tpu.io import gltf_export as jexport
from arctic_tpu.io import images as jimages
from arctic_tpu.io import load as jload
from arctic_tpu.io import obj as jobj
from arctic_tpu.io import procedural as jproc
from arctic_tpu_torch.io import gltf, gltf_export, images, load, obj, procedural
from arctic_tpu_torch.utils.errors import RenderError
from glb_fixture import build_fixture_glb
from test_io import _make_test_gltf, _rewrite_gltf

# ----------------------------- PNG -----------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(px: np.ndarray, filters) -> bytes:
    """(h, w, bpp) u8 samples -> filtered rows, row y with filter
    filters[y % len(filters)]: the PNG spec's per-byte loop."""
    h, w, bpp = px.shape
    out = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = px[y].reshape(-1).astype(np.int64)
        out.append(f)
        for i in range(w * bpp):
            a = cur[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
            out.append((cur[i] - pred) & 255)
        prev = cur
    return bytes(out)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png(px, ctype, filters=(0, 1, 2, 3, 4), plte=None, trns=None, depth=8, interlace=0,
         idat_chunks=3) -> bytes:
    """A PNG of (h, w, c) u8 samples, rows filtered per ``filters``, its
    IDAT split into ``idat_chunks`` chunks."""
    h, w, _ = px.shape
    data = zlib.compress(_filter_rows(px, filters))
    out = images.PNG_SIGNATURE + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    step = -(-len(data) // idat_chunks)
    for i in range(0, len(data), step):
        out += _chunk(b"IDAT", data[i : i + step])
    return out + _chunk(b"IEND", b"")


def _pillow_rgba(data: bytes) -> np.ndarray:
    Image = pytest.importorskip("PIL.Image")
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


SHAPES = [(5, 7), (9, 1), (1, 9), (16, 13)]  # (h, w): odd, width 1, height 1
COLOUR_CASES = {
    "gray": (0, 1, {}),
    "gray_trns": (0, 1, {"trns": struct.pack(">H", 77)}),
    "rgb": (2, 3, {}),
    "rgb_trns": (2, 3, {"trns": struct.pack(">HHH", 10, 20, 30)}),
    "palette": (3, 1, {}),
    "palette_trns": (3, 1, {"trns": bytes([0, 128, 255, 7, 0])}),
    "palette_one_clear": (3, 1, {"trns": bytes([255, 255, 0])}),
    "gray_alpha": (4, 2, {}),
    "rgba": (6, 4, {}),
}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(COLOUR_CASES))
def test_png_decode_equals_pillow(case, shape):
    """Every 8-bit colour type, with and without tRNS, every filter in
    turn (the row filters rotate over the rows; each shape also runs with
    one filter throughout), IDAT in three chunks."""
    ctype, c, extra = COLOUR_CASES[case]
    rng = np.random.default_rng(zlib.crc32(f"{case} {shape}".encode()))
    h, w = shape
    plte = None
    if ctype == 3:
        plte = rng.integers(0, 256, 3 * 11, dtype=np.uint8).tobytes()
        px = rng.integers(0, 11, (h, w, 1), dtype=np.uint8)
    else:
        px = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        if "trns" in extra:  # make some pixels hit the transparent colour
            key = np.frombuffer(extra["trns"], ">u2").astype(np.uint8)
            px[::2, ::3] = key
    for filters in ((0, 1, 2, 3, 4), (4,), (3,), (1,)):
        data = _png(px, ctype, filters, plte=plte, **extra)
        got = images.decode_png(data)
        assert got.dtype == np.uint8 and got.shape == (h, w, 4)
        np.testing.assert_array_equal(got, _pillow_rgba(data), err_msg=f"filters {filters}")


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_png_encode_round_trips_and_pillow_reads_it(channels):
    rng = np.random.default_rng(channels or 0)
    shape = (23, 17) if channels is None else (23, 17, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = images.encode_png(img)
    rgba = images.decode_png(data)
    gray = img.reshape(23, 17, -1)
    want = np.concatenate([np.repeat(gray, 3, 2), np.full((23, 17, 1), 255, np.uint8)], 2) \
        if gray.shape[2] == 1 else gray if gray.shape[2] == 4 else \
        np.concatenate([gray, np.full((23, 17, 1), 255, np.uint8)], 2)
    np.testing.assert_array_equal(rgba, want)
    Image = pytest.importorskip("PIL.Image")
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im).reshape(gray.shape), gray)


@pytest.mark.parametrize("case", ["interlaced", "16-bit", "4-bit palette", "bad crc",
                                  "palette index past PLTE", "not an image"])
def test_unsupported_png_raises(case):
    px = np.zeros((4, 4, 3), np.uint8)
    if case == "interlaced":
        data = _png(px, 2, interlace=1)
    elif case == "16-bit":
        data = _png(np.zeros((4, 4, 6), np.uint8), 2, depth=16)
    elif case == "4-bit palette":
        data = _png(np.zeros((4, 2, 1), np.uint8), 3, depth=4, plte=bytes(48))
    elif case == "bad crc":
        data = bytearray(_png(px, 2))
        data[30] ^= 1  # inside the IHDR body
        data = bytes(data)
    elif case == "palette index past PLTE":
        data = _png(np.full((4, 4, 1), 5, np.uint8), 3, plte=bytes(12))
    else:
        data = b"GIF89a" + bytes(32)
    with pytest.raises(RenderError):
        images.decode_ldr(data, "case.png")


def test_jpeg_needs_pillow(monkeypatch, tmp_path):
    """A JPEG decodes through Pillow where it imports and raises RenderError
    where it does not (the card's machine has no Pillow)."""
    path = tmp_path / "t.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RenderError, match="Pillow"):
        images.load_ldr(str(path))
    monkeypatch.undo()
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(3).integers(0, 256, (12, 10, 3), dtype=np.uint8)
    Image.fromarray(img).save(path, format="JPEG")
    np.testing.assert_array_equal(images.load_ldr(str(path)), _pillow_rgba(path.read_bytes()))


# ----------------------------- HDR -----------------------------------------


def _hdr_image(rng, h, w):
    rgb = rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)
    rgb[0, :3] = [0.0, 1e-40, 5e4]  # zero, below the RGBE floor, large
    rgb[1, 0] = [1e-3, 2.0, 0.5]
    return rgb


def test_rgbe_codec_equals_jax():
    rgb = _hdr_image(np.random.default_rng(0), 7, 9)
    rgbe = images._float_to_rgbe(rgb)
    np.testing.assert_array_equal(rgbe, jimages._float_to_rgbe(rgb))
    got, want = images._rgbe_to_float(rgbe), jimages._rgbe_to_float(rgbe)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _rle_hdr(rgbe: np.ndarray) -> bytes:
    """A new-style RLE Radiance file: each channel of each scanline as runs
    (where 3+ bytes repeat) and literals."""
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            v, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and v[x + run] == v[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, v[x]])
                    x += run
                else:
                    n = min(128, w - x)
                    out += bytes([n]) + v[x : x + n].tobytes()
                    x += n
    return bytes(out)


def test_hdr_load_save_equal_jax(tmp_path):
    """save_hdr writes the JAX package's bytes; load_hdr reads flat and RLE
    files to the JAX package's floats, bit for bit."""
    rgb = _hdr_image(np.random.default_rng(1), 6, 40)
    rgb[2:4, 5:30] = 1.5  # runs
    ours, theirs = tmp_path / "ours.hdr", tmp_path / "theirs.hdr"
    images.save_hdr(str(ours), rgb)
    jimages.save_hdr(str(theirs), rgb)
    assert ours.read_bytes() == theirs.read_bytes()
    rle = tmp_path / "rle.hdr"
    rle.write_bytes(_rle_hdr(images._float_to_rgbe(rgb)))
    for path in (ours, rle):
        got, want = images.load_hdr(str(path)), jimages.load_hdr(str(path))
        assert got.dtype == np.float32 and got.shape == (6, 40, 3)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(images.load_hdr(str(rle)), images.load_hdr(str(ours)))


# ----------------------------- scenes ----------------------------------------


def _meshes_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("positions", "normals", "uvs", "indices", "tangents", "bitangents"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
        assert a.material == b.material


def _objects_equal(got, want):
    """Same objects in the same order (no sorting)."""
    assert len(got) == len(want)
    for (ta, ma), (tb, mb) in zip(got, want):
        assert ma == mb
        assert ta.dtype == tb.dtype
        np.testing.assert_array_equal(ta, tb)


def _materials_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("diffuse", "normal", "metal_roughness"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _scenes_equal(got, want):
    _meshes_equal(got[0], want[0])
    _objects_equal(got[1], want[1])
    _materials_equal(got[2], want[2])
    if len(got) > 3:
        assert got[3].dtype == want[3].dtype == np.float32
        np.testing.assert_array_equal(got[3], want[3])


def test_gltf_fixture_equals_jax(tmp_path):
    """tests/glb_fixture.py: multi-primitive meshes, nested matrix and TRS
    nodes, shared meshes, interleaved (byteStride) buffers, normalized u16
    texcoords, u16 and u32 indices, a bufferView and a data-URI PNG,
    TANGENT on one primitive."""
    pytest.importorskip("PIL")  # the fixture's PNGs are Pillow's
    glb, _ = build_fixture_glb()
    path = tmp_path / "fixture.glb"
    path.write_bytes(glb)
    got, want = gltf.load_gltf(str(path)), jgltf.load_gltf(str(path))
    _scenes_equal(got, want)
    assert any(m.tangents is not None for m in got[0])
    assert any(m.tangents is None for m in got[0])


def _sparse_docs():
    base = np.arange(15, dtype=np.float32).reshape(5, 3)
    sidx = np.array([1, 4], np.uint16)
    svals = np.array([[100, 101, 102], [200, 201, 202]], np.float32)
    dense = (
        [base.tobytes() + sidx.tobytes() + svals.tobytes()],
        [{"buffer": 0, "byteOffset": 0, "byteLength": 60},
         {"buffer": 0, "byteOffset": 60, "byteLength": 4},
         {"buffer": 0, "byteOffset": 64, "byteLength": 24}],
        {"bufferView": 0, "componentType": 5126, "count": 5, "type": "VEC3",
         "sparse": {"count": 2, "indices": {"bufferView": 1, "componentType": 5123},
                    "values": {"bufferView": 2}}},
    )
    sidx = np.array([2], np.uint32)
    svals = np.array([[65535, 32768]], np.uint16)
    zero_base = (
        [sidx.tobytes() + svals.tobytes()],
        [{"buffer": 0, "byteOffset": 0, "byteLength": 4},
         {"buffer": 0, "byteOffset": 4, "byteLength": 4}],
        {"componentType": 5123, "count": 4, "type": "VEC2", "normalized": True,
         "sparse": {"count": 1, "indices": {"bufferView": 0, "componentType": 5125},
                    "values": {"bufferView": 1}}},
    )
    return {"dense_base": dense, "zero_base_normalized": zero_base}


@pytest.mark.parametrize("case", list(_sparse_docs()))
def test_gltf_sparse_accessor_equals_jax(case):
    """The cases of tests/test_gltf_sparse.py: a sparse accessor over a
    dense base view, and over no view (zeros) with normalized u16."""
    bufs, views, acc = _sparse_docs()[case]
    doc = {"bufferViews": views, "accessors": [acc]}
    got = gltf._accessor(gltf._Gltf(doc=doc, buffers=bufs, base_dir="."), 0)
    want = jgltf._accessor(jgltf._Gltf(doc=doc, buffers=bufs, base_dir="."), 0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_glb", [False, True], ids=["gltf_file_texture", "glb"])
def test_gltf_small_equals_jax(tmp_path, use_glb):
    pytest.importorskip("PIL")  # test_io's fixture writes its PNG with Pillow
    path = _make_test_gltf(tmp_path, use_glb=use_glb)
    _scenes_equal(gltf.load_gltf(str(path)), jgltf.load_gltf(str(path)))


def test_gltf_extensions_required_raises(tmp_path):
    pytest.importorskip("PIL")
    path = _make_test_gltf(tmp_path)
    _rewrite_gltf(path, lambda d: d.update(extensionsRequired=["KHR_draco_mesh_compression"],
                                           extensionsUsed=["KHR_draco_mesh_compression"]))
    with pytest.raises(gltf.GltfUnsupportedError, match="KHR_draco_mesh_compression"):
        gltf.load_gltf(str(path))
    assert gltf.SUPPORTED_EXTENSIONS == jgltf.SUPPORTED_EXTENSIONS


@pytest.mark.parametrize("case", ["optional_extension", "lines_primitive"])
def test_gltf_warns_and_equals_jax(tmp_path, caplog, case):
    """An optional extension and a non-triangle primitive warn (the LINES
    primitive is skipped) and load as the JAX loader loads them."""
    pytest.importorskip("PIL")
    path = _make_test_gltf(tmp_path)
    if case == "optional_extension":
        _rewrite_gltf(path, lambda d: d.update(extensionsUsed=["KHR_materials_ior"]))
        word = "KHR_materials_ior"
    else:
        _rewrite_gltf(path, lambda d: d["meshes"][0]["primitives"].append(
            {"attributes": {"POSITION": 0}, "indices": 3, "mode": 1}))
        word = "LINES"
    with caplog.at_level(logging.WARNING, logger="arctic.gltf"):
        got = gltf.load_gltf(str(path))
    assert len(got[0]) == 1
    assert any(word in r.message for r in caplog.records)
    _scenes_equal(got, jgltf.load_gltf(str(path)))


def _json_chunk(glb: bytes) -> dict:
    n = struct.unpack_from("<I", glb, 12)[0]
    doc = json.loads(glb[20 : 20 + n])
    for v in doc["bufferViews"]:  # the PNG bytes may differ, so may the offsets
        v.pop("byteOffset")
        v.pop("byteLength")
    doc["buffers"][0].pop("byteLength")
    return doc


def test_export_both_directions(tmp_path):
    """The port's GLB of Cornell loads in the JAX loader to the scene the
    JAX writer's GLB gives; the JAX writer's GLB loads in the port's loader
    to what the JAX loader gives; the JSON is the JAX writer's but for the
    buffer view offsets and lengths of the PNGs."""
    pytest.importorskip("PIL")  # the JAX package encodes and decodes with Pillow
    scene = procedural.cornell_like_scene()
    ours, theirs = tmp_path / "ours.glb", tmp_path / "theirs.glb"
    gltf_export.save_glb(str(ours), *scene[:3])
    jexport.save_glb(str(theirs), *jproc.cornell_like_scene()[:3])
    assert _json_chunk(ours.read_bytes()) == _json_chunk(theirs.read_bytes())
    want = jgltf.load_gltf(str(theirs))
    _scenes_equal(jgltf.load_gltf(str(ours)), want)
    _scenes_equal(gltf.load_gltf(str(theirs)), want)
    _scenes_equal(gltf.load_gltf(str(ours)), want)
    # Objects come back in reverse (the stack walk), materials losslessly.
    assert [m for _, m in want[1]] == [m for _, m in scene[1]][::-1]
    _materials_equal(want[2], scene[2])


def _write_obj(tmp_path):
    images.save_png(str(tmp_path / "red.png"),
                    np.tile(np.array([255, 0, 0, 255], np.uint8), (2, 3, 1)))
    images.save_png(str(tmp_path / "bump.png"),
                    np.tile(np.array([128, 128, 255], np.uint8), (3, 2, 1)))
    (tmp_path / "scene.mtl").write_text(
        "# materials\nnewmtl red\nKd 1 0 0\nmap_Kd red.png\nmap_Bump -bm 1.0 bump.png\n"
        "newmtl plain\nKd 0.5 0.5 0.5\n"
    )
    (tmp_path / "scene.obj").write_text(
        "mtllib scene.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0\nv 2 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvt 0.25\n"
        "vn 0 0 1\nvn 0 1 0\n"
        "f 6 1 2\n"  # before any usemtl: the default bucket
        "usemtl red\n"
        "f 1/1/1 2/2/1 3/3/1 5/5/1 4/4/1\n"  # a pentagon: fan triangulation
        "f -6/-5/-2 -5/-4/-2 -4/-3/-2\n"  # negative indices, repeated corners
        "usemtl plain\n"
        "f 1//2 2//2 6//2\n"
        "usemtl red\n"
        "f 2/2 6/3 3/4\n"
    )
    return tmp_path / "scene.obj"


def test_obj_with_mtl_equals_jax(tmp_path):
    pytest.importorskip("PIL")  # the JAX loader decodes its textures with Pillow
    path = _write_obj(tmp_path)
    got = obj.load_obj(str(path))
    _scenes_equal(got, jobj.load_obj(str(path)))
    assert [len(m.indices) for m in got[0]] == [1, 5, 1]
    assert obj._parse_mtl(str(tmp_path / "scene.mtl")) == jobj._parse_mtl(str(tmp_path / "scene.mtl"))


def test_load_scene_file_equals_jax(tmp_path):
    """load_scene_file: the first .hdr in sorted order next to the scene,
    an explicit env_path, and the procedural-sky fallback."""
    pytest.importorskip("PIL")
    path = str(_write_obj(tmp_path))
    _scenes_equal(load.load_scene_file(path), jload.load_scene_file(path))  # no .hdr: the sky
    np.testing.assert_array_equal(load.load_scene_file(path)[3],
                                  procedural.gradient_environment(256, 512))
    rng = np.random.default_rng(5)
    for name in ("b.HDR", "a.hdr"):
        images.save_hdr(str(tmp_path / name), _hdr_image(rng, 4, 8))
    got = load.load_scene_file(path)
    _scenes_equal(got, jload.load_scene_file(path))
    np.testing.assert_array_equal(got[3], images.load_hdr(str(tmp_path / "a.hdr")))
    env = str(tmp_path / "b.HDR")
    _scenes_equal(load.load_scene_file(path, env_path=env), jload.load_scene_file(path, env))
    glb = tmp_path / "scene.glb"
    gltf_export.save_glb(str(glb), *procedural.cornell_like_scene()[:3])
    _scenes_equal(load.load_scene_file(str(glb)), jload.load_scene_file(str(glb)))
    with pytest.raises(ValueError, match="unsupported scene format"):
        load.load_scene_file(str(tmp_path / "scene.fbx"))


def test_gltf_file_buffer_and_data_uri_texture(tmp_path):
    """A .gltf whose buffer is a file (its URI percent-encoded) and whose
    texture is a data URI."""
    pytest.importorskip("PIL")
    path = _make_test_gltf(tmp_path)
    png = (tmp_path / "base.png").read_bytes()

    def swap(doc):
        b = doc["buffers"][0]
        (tmp_path / "mesh data.bin").write_bytes(base64.b64decode(b["uri"].split(",", 1)[1]))
        b["uri"] = "mesh%20data.bin"
        doc["images"][0] = {"uri": "data:image/png;base64," + base64.b64encode(png).decode()}

    _rewrite_gltf(path, swap)
    os.remove(tmp_path / "base.png")
    got = gltf.load_gltf(str(path))
    _scenes_equal(got, jgltf.load_gltf(str(path)))
    assert got[2][0].diffuse[0, 0, 0] == 200
