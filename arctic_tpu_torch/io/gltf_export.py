"""glTF 2.0 GLB writer for (meshes, objects, materials) scenes — port of
arctic_tpu/io/gltf_export.py, with PNGs from io/images (no Pillow).

The reference only imports scenes; the writer lets the asset path (glTF
loader -> tangent generation -> atlas -> frame) run on procedural scenes
of any size without shipped binary fixtures. Its conventions mirror the
loader (io/gltf.py): v-flipped UVs (MeshData stores v FlipUVs-style), one
node with a ``matrix`` per object, pbrMetallicRoughness with baseColor /
normal / metal-roughness textures as embedded PNGs. Tangents are not
written: the loader's consumer regenerates them (io/build.compute_tangents),
the route real assets without TANGENT take. The JSON is the JAX writer's;
only the PNG bytes (and so the buffer view offsets) may differ, and the
pixels are lossless either way.
"""

from __future__ import annotations

import json
import struct
from typing import Sequence

import numpy as np

from arctic_tpu_torch.io.build import MaterialImages, MeshData
from arctic_tpu_torch.io.images import encode_png


def scene_to_glb(
    meshes: Sequence[MeshData],
    objects: Sequence[tuple[np.ndarray, int]],
    materials: Sequence[MaterialImages],
) -> bytes:
    """Serialize a scene to a standalone GLB (binary glTF 2.0)."""
    blob = bytearray()
    views = []

    def add_view(data: bytes, target: int | None = None) -> int:
        while len(blob) % 4:
            blob.append(0)
        v = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
        if target is not None:
            v["target"] = target
        blob.extend(data)
        views.append(v)
        return len(views) - 1

    accessors = []

    def add_accessor(view, comp_type, count, type_, vmin=None, vmax=None) -> int:
        a = {"bufferView": view, "componentType": comp_type, "count": int(count), "type": type_}
        if vmin is not None:
            a["min"] = [float(x) for x in vmin]
            a["max"] = [float(x) for x in vmax]
        accessors.append(a)
        return len(accessors) - 1

    images, textures = [], []

    def add_texture(img: np.ndarray) -> int:
        view = add_view(encode_png(np.ascontiguousarray(img)))
        images.append({"bufferView": view, "mimeType": "image/png"})
        textures.append({"source": len(images) - 1, "sampler": 0})
        return len(textures) - 1

    mats_json = []
    for m in materials:
        mats_json.append(
            {
                "pbrMetallicRoughness": {
                    "baseColorTexture": {"index": add_texture(m.diffuse)},
                    "metallicRoughnessTexture": {"index": add_texture(m.metal_roughness)},
                },
                "normalTexture": {"index": add_texture(m.normal)},
            }
        )

    meshes_json = []
    for m in meshes:
        pos = np.asarray(m.positions, np.float32)
        nrm = np.asarray(m.normals, np.float32)
        uv = np.asarray(m.uvs, np.float32).copy()
        uv[:, 1] = 1.0 - uv[:, 1]  # MeshData v is FlipUVs'd; glTF is v-down
        idx = np.asarray(m.indices, np.uint32).reshape(-1)
        attrs = {
            "POSITION": add_accessor(
                add_view(pos.tobytes(), 34962), 5126, len(pos), "VEC3", pos.min(0), pos.max(0),
            ),
            "NORMAL": add_accessor(add_view(nrm.tobytes(), 34962), 5126, len(nrm), "VEC3"),
            "TEXCOORD_0": add_accessor(add_view(uv.tobytes(), 34962), 5126, len(uv), "VEC2"),
        }
        meshes_json.append(
            {
                "primitives": [
                    {
                        "attributes": attrs,
                        "indices": add_accessor(
                            add_view(idx.tobytes(), 34963), 5125, len(idx), "SCALAR"
                        ),
                        "material": int(m.material),
                    }
                ]
            }
        )

    # glTF matrices are column-major arrays; numpy TRS is row-major.
    nodes = [
        {"mesh": int(mesh_idx),
         "matrix": [float(x) for x in np.asarray(trs, np.float32).T.reshape(-1)]}
        for trs, mesh_idx in objects
    ]

    gltf = {
        "asset": {"version": "2.0", "generator": "arctic_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes_json,
        "materials": mats_json,
        "images": images,
        "textures": textures,
        "samplers": [{"wrapS": 10497, "wrapT": 10497}],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }

    json_bytes = json.dumps(gltf, separators=(",", ":")).encode()
    while len(json_bytes) % 4:
        json_bytes += b" "
    while len(blob) % 4:
        blob.append(0)
    total = 12 + 8 + len(json_bytes) + 8 + len(blob)
    out = bytearray()
    out += struct.pack("<III", 0x46546C67, 2, total)  # 'glTF'
    out += struct.pack("<II", len(json_bytes), 0x4E4F534A) + json_bytes  # JSON
    out += struct.pack("<II", len(blob), 0x004E4942) + bytes(blob)  # BIN
    return bytes(out)


def save_glb(path: str, meshes, objects, materials) -> None:
    with open(path, "wb") as f:
        f.write(scene_to_glb(meshes, objects, materials))
