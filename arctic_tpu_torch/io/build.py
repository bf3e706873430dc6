"""Host-side scene assembly: meshes + materials + env -> SceneBuffers of
tensors on a device. Port of arctic_tpu/io/build.py on its default route
(quad atlases with the combined-slot material atlas; no tile atlas, no
texture groups).

The numpy body is the JAX package's, unchanged, so both builds produce the
same arrays; only the last step differs (``torch.as_tensor(..., device=)``
instead of ``jnp.asarray``). bf16 tables round to nearest-even, as
``jnp.asarray(x, jnp.bfloat16)`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from arctic_tpu_torch.core.scene import (
    Environment,
    Geometry,
    SceneBuffers,
    TextureAtlas,
)
from arctic_tpu_torch.utils.errors import RenderError


@dataclass
class MaterialImages:
    """The three textures of a material (scene.hpp:62-69), as u8 RGBA.

    ``diffuse`` is sRGB-encoded (decoded at pack time like the _SRGB SRV,
    renderer.cpp:486); normal and metal-roughness are linear.
    """

    diffuse: np.ndarray
    normal: np.ndarray
    metal_roughness: np.ndarray


@dataclass
class MeshData:
    """One mesh in object space (app.cpp:299-356 extraction equivalent)."""

    positions: np.ndarray  # (N, 3) f32
    normals: np.ndarray  # (N, 3) f32
    uvs: np.ndarray  # (N, 2) f32, v already flipped (FlipUVs)
    indices: np.ndarray  # (M, 3) i32
    material: int
    tangents: np.ndarray | None = None
    bitangents: np.ndarray | None = None


def compute_tangents(
    positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, indices: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex tangent frame from UV derivatives (aiProcess_CalcTangentSpace
    analogue, app.cpp:180): accumulate per-face tangents, then Gram-Schmidt
    against the vertex normal. The numpy route of the JAX package's build
    (which uses the optional native/ helper instead when it is compiled)."""
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    e1 = positions[i1] - positions[i0]
    e2 = positions[i2] - positions[i0]
    d1 = uvs[i1] - uvs[i0]
    d2 = uvs[i2] - uvs[i0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1.0, det))
    t_face = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    b_face = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r[:, None]

    tan = np.zeros_like(positions)
    btn = np.zeros_like(positions)
    for tri_idx in (i0, i1, i2):
        np.add.at(tan, tri_idx, t_face)
        np.add.at(btn, tri_idx, b_face)

    n = normals
    tan = tan - n * np.sum(n * tan, axis=1, keepdims=True)
    ln = np.linalg.norm(tan, axis=1, keepdims=True)
    # Degenerate UVs: fall back to any vector orthogonal to n.
    alt = np.cross(n, np.where(np.abs(n[:, 0:1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]]))
    tan = np.where(ln > 1e-8, tan / np.maximum(ln, 1e-20), alt / np.linalg.norm(alt, axis=1, keepdims=True))
    handed = np.where(np.sum(np.cross(n, tan) * btn, axis=1, keepdims=True) < 0, -1.0, 1.0)
    btn = np.cross(n, tan) * handed
    return tan.astype(np.float32), btn.astype(np.float32)


def srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def pack_atlas(images: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Shelf-pack images into one (AH, AW, 4) f32 array; returns (atlas, locs).

    locs rows are (y, x, h, w): (y, x) is the origin of the *padded* block
    and (h, w) the logical image size. Every image is stored with a 1-texel
    wrapped border so a bilinear footprint is a contiguous (2, 2) window.
    """
    padded = [np.pad(im, ((1, 1), (1, 1), (0, 0)), mode="wrap") for im in images]
    order = sorted(range(len(padded)), key=lambda i: -padded[i].shape[0])
    max_w = max(im.shape[1] for im in padded)
    atlas_w = 1
    area = sum(im.shape[0] * im.shape[1] for im in padded)
    while atlas_w < max_w or atlas_w * atlas_w < area:
        atlas_w *= 2
    shelves: list[list[int]] = []  # [y, height, x_cursor]
    locs = np.zeros((len(images), 4), np.int32)
    y_cursor = 0
    for idx in order:
        ph, pw = padded[idx].shape[:2]
        placed = False
        for shelf in shelves:
            if shelf[2] + pw <= atlas_w and ph <= shelf[1]:
                locs[idx] = (shelf[0], shelf[2], ph - 2, pw - 2)
                shelf[2] += pw
                placed = True
                break
        if not placed:
            shelves.append([y_cursor, ph, pw])
            locs[idx] = (y_cursor, 0, ph - 2, pw - 2)
            y_cursor += ph
    atlas_h = max((y_cursor + 1) // 2 * 2, 2)
    channels = images[0].shape[-1]
    atlas = np.zeros((atlas_h, atlas_w, channels), np.float32)
    for idx, im in enumerate(padded):
        y, x = locs[idx][:2]
        atlas[y : y + im.shape[0], x : x + im.shape[1]] = im
    return atlas, locs


def pack_atlas_quads(atlas: np.ndarray) -> np.ndarray:
    """Four parity-shifted 2x2-texel-quad copies of the atlas, flattened to
    (4*BH*BW, 4*C): any bilinear footprint is ONE row."""
    ah, aw, c = atlas.shape
    assert ah % 2 == 0 and aw % 2 == 0
    p = np.pad(atlas, ((0, 3), (0, 3), (0, 0)))
    bh, bw = ah // 2 + 1, aw // 2 + 1
    copies = []
    for sy in range(2):
        for sx in range(2):
            sub = p[sy : sy + bh * 2, sx : sx + bw * 2]
            q = (
                sub.reshape(bh, 2, bw, 2, c)
                .transpose(0, 2, 1, 3, 4)
                .reshape(bh, bw, 4 * c)
            )
            copies.append(q)
    return np.stack(copies).reshape(4 * bh * bw, 4 * c)


def _round_up(x: int, m: int) -> int:
    return max((x + m - 1) // m * m, m)


# Above this many combined texels the JAX package switches to its u16 tile
# atlas, which this port does not have yet.
TILE_ATLAS_THRESHOLD_TEXELS = 1_000_000


def _pack_rows_128(rows: np.ndarray) -> np.ndarray:
    """(Q, L) -> (ceil(Q*L/128), 128) dense row packing (128 % L == 0)."""
    q, l = rows.shape
    per = 128 // l
    qp = _round_up(q, per)
    return np.pad(rows, ((0, qp - q), (0, 0))).reshape(qp // per, 128)


def pack_tex_rows(combined_quads: np.ndarray) -> np.ndarray:
    """(Nq, C4) combined-slot quad table -> (ceil(Nq/per), 128) gather rows,
    per = 128 // C4 quads per row (zero-padded lanes when C4 does not divide
    128) — ops/sampling.pack_tex_rows of the JAX package."""
    c4 = combined_quads.shape[-1]
    per = 128 // c4
    nq_pad = -(-combined_quads.shape[0] // per) * per
    rows = np.pad(
        combined_quads, ((0, nq_pad - combined_quads.shape[0]), (0, 0))
    ).reshape(nq_pad // per, per * c4)
    if per * c4 < 128:
        rows = np.pad(rows, ((0, 0), (0, 128 - per * c4)))
    return rows


def _bf16(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).to(device)


def build_buffers(
    meshes: Sequence[MeshData],
    objects: Sequence[tuple[np.ndarray, int]],  # (trs 4x4, mesh index)
    materials: Sequence[MaterialImages],
    environment: np.ndarray,  # (H, W, 3) f32 linear radiance
    tri_bucket: int = 1024,
    device: torch.device | str = "cuda",
) -> SceneBuffers:
    """Flatten a scene into tensors on ``device`` (the card unless the
    caller asks for the CPU)."""
    pos_l, nrm_l, tan_l, btn_l, uv_l, vobj_l = [], [], [], [], [], []
    idx_l, mat_l = [], []
    vbase = 0
    trs_list = []
    for obj_id, (trs, mesh_idx) in enumerate(objects):
        m = meshes[mesh_idx]
        tan, btn = m.tangents, m.bitangents
        if tan is None or btn is None:
            tan, btn = compute_tangents(m.positions, m.normals, m.uvs, m.indices)
        nv = len(m.positions)
        pos_l.append(np.asarray(m.positions, np.float32))
        nrm_l.append(np.asarray(m.normals, np.float32))
        tan_l.append(np.asarray(tan, np.float32))
        btn_l.append(np.asarray(btn, np.float32))
        uv_l.append(np.asarray(m.uvs, np.float32))
        vobj_l.append(np.full(nv, obj_id, np.int32))
        idx_l.append(np.asarray(m.indices, np.int32) + vbase)
        mat_l.append(np.full(len(m.indices), m.material, np.int32))
        trs_list.append(np.asarray(trs, np.float32))
        vbase += nv

    positions = np.concatenate(pos_l)
    indices = np.concatenate(idx_l)
    tri_mat = np.concatenate(mat_l)
    num_tris = len(indices)
    cap = _round_up(num_tris, tri_bucket)
    indices = np.pad(indices, ((0, cap - num_tris), (0, 0)))
    tri_mat = np.pad(tri_mat, (0, cap - num_tris))

    # Tri-major static shading attributes: per-corner normalized n/t/b + uv,
    # object-space corner positions, the triangle's object id.
    normals = np.concatenate(nrm_l)
    tangents = np.concatenate(tan_l)
    bitangents = np.concatenate(btn_l)
    uvs = np.concatenate(uv_l)
    vobj = np.concatenate(vobj_l)

    def _norm_f32(v):
        v = v.astype(np.float32)
        n = np.sqrt(np.sum(v * v, axis=-1, keepdims=True, dtype=np.float32))
        with np.errstate(divide="ignore", invalid="ignore"):
            return (v / n).astype(np.float32)

    vattr_static = np.concatenate(
        [_norm_f32(normals), _norm_f32(tangents), _norm_f32(bitangents),
         uvs.astype(np.float32)], axis=1,
    )  # (V, 11)
    vattr_static = np.nan_to_num(vattr_static)  # zero-length n/t/b of pad verts
    tri_corner_pos = positions[indices].astype(np.float32)  # (cap, 3, 3)
    tri_static_attrs = vattr_static[indices]  # (cap, 3, 11)
    tri_obj = vobj[indices[:, 0]].astype(np.int32)  # (cap,)
    tri_trs = np.stack(trs_list)[tri_obj].astype(np.float32).reshape(-1, 16).T

    # Atlas: 3 slots per material; diffuse sRGB-decoded, rest linear.
    images = []
    nm_consts = np.zeros((len(materials), 4), np.float32)
    mr_consts = np.zeros((len(materials), 4), np.float32)
    nm_constant = True
    mr_constant = True

    def _const(img):
        f = img.astype(np.float32) / 255.0
        return f[0, 0] if (img == img.reshape(-1, img.shape[-1])[0]).all() else None

    for mi, mat in enumerate(materials):
        d = mat.diffuse.astype(np.float32) / 255.0
        d[..., :3] = srgb_to_linear_np(d[..., :3])
        images.append(d)
        images.append(mat.normal.astype(np.float32) / 255.0)
        images.append(mat.metal_roughness.astype(np.float32) / 255.0)
        c = _const(mat.normal)
        if c is None:
            nm_constant = False
        else:
            nm_consts[mi] = c
        c = _const(mat.metal_roughness)
        if c is None:
            mr_constant = False
        else:
            mr_consts[mi] = c
    per_mat_hw = []
    tile_ok = True
    for mi in range(len(materials)):
        group = [images[3 * mi + s] for s in range(3)]
        konst = [(im == im.reshape(-1, im.shape[-1])[0]).all() for im in group]
        dims = {im.shape[:2] for im, k in zip(group, konst) if not k}
        if len(dims) > 1:
            tile_ok = False
            break
        per_mat_hw.append(dims.pop() if dims else (1, 1))
    total_texels = sum(h * w for h, w in per_mat_hw) if tile_ok else 0
    if tile_ok and total_texels > TILE_ATLAS_THRESHOLD_TEXELS:
        raise RenderError(
            f"{total_texels} material texels take the JAX package's u16 tile "
            f"atlas route, which this port does not have yet"
        )
    atlas_np, locs = pack_atlas(images)
    regions = locs.reshape(len(materials), 3, 4)

    # Combined-slot atlas: interleave each material's non-elided textures
    # into one multi-channel image so a pixel's material taps are ONE row.
    slots = [0] + ([] if nm_constant else [1]) + ([] if mr_constant else [2])
    combined = None
    if len(slots) > 1:
        combined_imgs = []
        total_texels = 0
        for mi in range(len(materials)):
            group = [images[3 * mi + s] for s in slots]
            konst = [(im == im.reshape(-1, im.shape[-1])[0]).all() for im in group]
            dims = {im.shape[:2] for im, k in zip(group, konst) if not k}
            if len(dims) > 1:
                combined = False  # incompatible sizes: keep separate taps
                break
            hw = dims.pop() if dims else max(im.shape[:2] for im in group)
            group = [
                im if im.shape[:2] == hw else np.broadcast_to(im[0:1, 0:1], hw + (4,))
                for im in group
            ]
            combined_imgs.append(np.concatenate(group, axis=-1))
            total_texels += hw[0] * hw[1]
        if combined is None and total_texels <= 32 * 1024 * 1024:
            combined = True
    if not combined:
        raise RenderError(
            "the scene's materials do not combine into one quad atlas; the "
            "per-slot texture taps are not ported yet"
        )
    c_np, c_locs = pack_atlas(combined_imgs)
    combined_quads = pack_atlas_quads(c_np)

    env_np = np.asarray(environment, np.float32)
    env_rgba = np.concatenate(
        [env_np, np.ones((*env_np.shape[:2], 1), np.float32)], axis=-1
    )
    env_data, env_locs = pack_atlas([env_rgba])
    env_rows = _pack_rows_128(pack_atlas_quads(env_data))

    # Per-triangle material row: [atlas regions (3 slots x (y,x,h,w)) |
    # mr_consts | nm_consts[:3] | combined-atlas region].
    matrow_by_mat = np.concatenate(
        [regions.reshape(len(materials), 12).astype(np.float32),
         mr_consts, nm_consts[:, :3], c_locs.astype(np.float32)], axis=1,
    )  # (M, 23)
    # Static half of the shade-row table, in clip-slot order [tri; tri].
    matrow_tri = matrow_by_mat[tri_mat].T  # (23, cap)
    n_total = _round_up(2 * cap + 1, 512)
    slot_static = np.zeros((56, n_total), np.float32)
    slot_static[0:33, 0:cap] = tri_static_attrs.reshape(-1, 33).T
    slot_static[0:33, cap : 2 * cap] = slot_static[0:33, 0:cap]
    slot_static[33:56, 0:cap] = matrow_tri
    slot_static[33:56, cap : 2 * cap] = matrow_tri

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    geometry = Geometry(
        num_tris=num_tris,
        tri_corner_pos=f32(tri_corner_pos.reshape(-1, 9).T),
        tri_trs=f32(tri_trs),
        slot_static_rows=f32(slot_static),
    )
    atlas = TextureAtlas(
        combined_slots=tuple(slots),
        combined_shape=c_np.shape[:2],
        quad_width=combined_quads.shape[1],
        combined_env_rows=torch.cat(
            [_bf16(pack_tex_rows(combined_quads), device), _bf16(env_rows, device)]
        ),
    )
    environment_ = Environment(
        region=tuple(int(v) for v in env_locs[0]),
        data_shape=env_data.shape[:2],
        num_rows=env_rows.shape[0],
    )
    return SceneBuffers(geometry=geometry, atlas=atlas, environment=environment_)
