"""Wavefront OBJ + MTL loader — port of arctic_tpu/io/obj.py (the
reference's "or similar" path, README.md:12; Assimp's OBJ importer).

Semantics of the reference's import flags (app.cpp:177-181): triangulation
by fan, FlipUVs, vertices deduplicated per (v, vt, vn) triple
(JoinIdenticalVertices), tangent space computed downstream. Materials:
map_Kd -> diffuse, map_Bump / bump / norm -> normal; OBJ has no
metal-roughness map, so the white fallback applies (metal = 1, rough = 1,
app.cpp:244's white.png).
"""

from __future__ import annotations

import os

import numpy as np

from arctic_tpu_torch.io.build import MaterialImages, MeshData, fallback_diffuse, fallback_normal
from arctic_tpu_torch.io.images import load_ldr


def _parse_mtl(path: str) -> dict[str, dict]:
    mats: dict[str, dict] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = mats.setdefault(parts[1], {})
            elif cur is not None and key == "map_kd":
                cur["diffuse"] = parts[-1]
            elif cur is not None and key in ("map_bump", "bump", "norm", "map_norm"):
                cur["normal"] = parts[-1]
    return mats


def load_obj(path: str):
    """-> (meshes, objects, materials) in io/build.py terms: one mesh (and
    one identity-TRS object) per material in first-use order."""
    base = os.path.dirname(os.path.abspath(path))
    vs: list = []
    vts: list = []
    vns: list = []
    mtl_defs: dict[str, dict] = {}
    mat_order: list[str] = []

    # One mesh per active material; faces accumulate into the current one.
    buckets: dict[str, dict] = {}
    current = "__default__"

    def bucket(name):
        return buckets.setdefault(name, {"dedup": {}, "pos": [], "uv": [], "nrm": [], "idx": []})

    def index(s: str, n: int) -> int:
        i = int(s)
        return i - 1 if i > 0 else n + i

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                vts.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif tag == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif tag == "mtllib":
                mtl_defs.update(_parse_mtl(os.path.join(base, parts[1])))
            elif tag == "usemtl":
                current = parts[1]
                if current not in mat_order:
                    mat_order.append(current)
            elif tag == "f":
                b = bucket(current)
                corners = []
                for vert in parts[1:]:
                    if vert not in b["dedup"]:
                        comp = (vert.split("/") + ["", ""])[:3]
                        b["pos"].append(vs[index(comp[0], len(vs))])
                        if comp[1]:
                            u, v = vts[index(comp[1], len(vts))]
                            b["uv"].append([u, 1.0 - v])  # FlipUVs
                        else:
                            b["uv"].append([0.0, 0.0])
                        if comp[2]:
                            b["nrm"].append(vns[index(comp[2], len(vns))])
                        else:
                            b["nrm"].append([0.0, 1.0, 0.0])
                        b["dedup"][vert] = len(b["pos"]) - 1
                    corners.append(b["dedup"][vert])
                for k in range(1, len(corners) - 1):  # triangle fan
                    b["idx"].append([corners[0], corners[k], corners[k + 1]])

    if "__default__" in buckets and buckets["__default__"]["idx"]:
        mat_order.insert(0, "__default__")

    materials = []
    meshes = []
    objects = []
    for name in mat_order:
        b = buckets.get(name)
        if b is None or not b["idx"]:
            continue
        spec = mtl_defs.get(name, {})
        diffuse = (
            load_ldr(os.path.join(base, spec["diffuse"])) if "diffuse" in spec
            else fallback_diffuse()
        )
        normal = (
            load_ldr(os.path.join(base, spec["normal"])) if "normal" in spec
            else fallback_normal()
        )
        materials.append(
            MaterialImages(diffuse=diffuse, normal=normal, metal_roughness=fallback_diffuse())
        )
        meshes.append(
            MeshData(
                positions=np.asarray(b["pos"], np.float32),
                normals=np.asarray(b["nrm"], np.float32),
                uvs=np.asarray(b["uv"], np.float32),
                indices=np.asarray(b["idx"], np.int32),
                material=len(materials) - 1,
            )
        )
        objects.append((np.eye(4, dtype=np.float32), len(meshes) - 1))
    return meshes, objects, materials
