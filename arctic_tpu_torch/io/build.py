"""Host-side scene assembly: meshes + materials + env -> SceneBuffers of
tensors on a device. Port of arctic_tpu/io/build.py on all its texture
routes: the combined-slot quad atlas of small texture sets (merged with the
environment's bf16 rows, or apart from them for another ``atlas_dtype``),
the per-slot atlas where a material's maps differ in size, and, above
TILE_ATLAS_THRESHOLD_TEXELS, the u16 tile atlas in material groups (greedy,
or explicit ``tex_groups`` with per-group tables for the grouped tile
route).

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
from arctic_tpu_torch.ops.sampling import TILE_H, TILE_SX, TILE_SY, TILE_W
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


def fallback_diffuse() -> np.ndarray:
    """assets/white.png equivalent (app.cpp:214)."""
    return np.full((1, 1, 4), 255, np.uint8)


def fallback_normal() -> np.ndarray:
    """assets/normal.png equivalent (app.cpp:229): flat +Z tangent normal."""
    t = np.zeros((1, 1, 4), np.uint8)
    t[..., 0], t[..., 1], t[..., 2], t[..., 3] = 128, 128, 255, 255
    return t


def compute_tangents(
    positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, indices: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-vertex tangent frame from UV derivatives (aiProcess_CalcTangentSpace
    analogue, app.cpp:180): through the optional native library where it is
    built (io/native.py), else compute_tangents_np."""
    from arctic_tpu_torch.io import native

    if native.available():
        return native.compute_tangents(positions, normals, uvs, indices)
    return compute_tangents_np(positions, normals, uvs, indices)


def compute_tangents_np(
    positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, indices: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The numpy tangent frame: accumulate per-face tangents, then
    Gram-Schmidt against the vertex normal."""
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


# Above this many material texels the bf16 quad tables (~96 B/texel with
# their four parity copies) give way to the u16 tile atlas (~24 B/texel).
TILE_ATLAS_THRESHOLD_TEXELS = 1_000_000


def build_tile_atlas(images: Sequence[np.ndarray]):
    """Per-material 8-channel images -> (tiles (N, 128) i32, meta (M, 4) i32).

    images: one (h, w, 8) f32 array per material, channels [diffuse RGB
    linear, normal XYZ, mr G, mr B]. Each image gets a 1-texel wrapped
    border, is quantised to u16 (round to nearest), and is cut into 4x8-texel
    tiles on a (3, 7) grid so any bilinear 2x2 window lives in ONE tile.
    Tile row lanes: ch2 * 32 + y * 8 + x holds channels 2*ch2 | 2*ch2+1<<16.
    meta rows are (row base, tiles per row, h, w).
    """
    metas = np.zeros((len(images), 4), np.int32)
    parts = []
    base = 0
    for mi, img in enumerate(images):
        h, w = img.shape[:2]
        q = np.floor(np.clip(img.astype(np.float32) * 65535.0 + 0.5, 0, 65535))
        q = q.astype(np.uint32)
        p = np.pad(q, ((1, 1), (1, 1), (0, 0)), mode="wrap")
        nty, ntx = h // TILE_SY + 1, w // TILE_SX + 1
        hp = TILE_SY * (nty - 1) + TILE_H
        wp = TILE_SX * (ntx - 1) + TILE_W
        p = np.pad(p, ((0, hp - p.shape[0]), (0, wp - p.shape[1]), (0, 0)))
        sv = np.lib.stride_tricks.as_strided(
            p,
            shape=(nty, ntx, TILE_H, TILE_W, 8),
            strides=(
                p.strides[0] * TILE_SY, p.strides[1] * TILE_SX,
                p.strides[0], p.strides[1], p.strides[2],
            ),
        )
        t = np.ascontiguousarray(sv).reshape(nty * ntx, TILE_H, TILE_W, 8)
        packed = t[..., 0::2] | (t[..., 1::2] << 16)  # (N, 4, 8, 4) u32
        rows = packed.transpose(0, 3, 1, 2).reshape(-1, 128)
        parts.append(rows.view(np.int32))
        metas[mi] = (base, ntx, h, w)
        base += nty * ntx
    return np.concatenate(parts), metas


# Row budget of one material group's [tiles + env copy] slice (the JAX
# package sized it to a TPU gather-cost tier; the grouping, and so the
# table, is kept as the JAX package lays it out).
TEX_GROUP_BUDGET_BYTES = 104 * 1024 * 1024


def group_tile_atlas(tiles_np, metas, env_rows, budget_bytes: int = TEX_GROUP_BUDGET_BYTES,
                     explicit_groups=None):
    """Partition the tile atlas into material groups, each followed by its
    own env copy: packed greedily in material order under ``budget_bytes``,
    or as ``explicit_groups`` (lists of material ids that partition them,
    e.g. io/texplan.plan_material_groups' plan; the table lays the
    materials out in that order).

    Returns (table (N', 128) i32, metas', groups, group_of, mat_rows): the
    layout [g0 tiles | env | g1 tiles | env | ...], the metas with their
    bases rebased into it, per group (mstart, env_base, end), the material
    -> group map and the tile rows of each material. A group's slice
    [mstart:end] holds every row its pixels read. A material that alone
    exceeds the budget still gets a group."""
    m = len(metas)
    total = tiles_np.shape[0]
    counts = [
        (int(metas[i + 1][0]) if i + 1 < m else total) - int(metas[i][0])
        for i in range(m)
    ]
    e = int(env_rows.shape[0])
    budget_rows = budget_bytes // (tiles_np.shape[1] * 4)
    if explicit_groups is not None:
        groups_mats = [list(g) for g in explicit_groups if len(g)]
        if sorted(mi for g in groups_mats for mi in g) != list(range(m)):
            raise RenderError("explicit_groups must partition the materials")
    else:
        groups_mats = []
        cur: list[int] = []
        cur_rows = 0
        for i in range(m):
            if cur and cur_rows + counts[i] + e > budget_rows:
                groups_mats.append(cur)
                cur, cur_rows = [], 0
            cur.append(i)
            cur_rows += counts[i]
        if cur:
            groups_mats.append(cur)

    parts = []
    groups = []
    group_of = [0] * m
    new_metas = metas.copy()
    base = 0
    for gi, mats in enumerate(groups_mats):
        mstart = base
        for i in mats:
            orig = int(metas[i][0])
            parts.append(tiles_np[orig : orig + counts[i]])
            new_metas[i][0] = base
            group_of[i] = gi
            base += counts[i]
        parts.append(env_rows)
        env_base = base
        base = env_base + e
        groups.append((mstart, env_base, base))
    assert base < (1 << 24), "tile row bases must stay f32-exact"
    return np.concatenate(parts), new_metas, tuple(groups), tuple(group_of), tuple(counts)


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


def _table(x: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """An f32 host table on ``device`` in ``dtype`` (bf16 rounds to
    nearest-even, as ``jnp.asarray(x, jnp.bfloat16)`` does)."""
    return torch.as_tensor(np.ascontiguousarray(x, np.float32)).to(dtype).to(device)


def _bf16(x: np.ndarray, device) -> torch.Tensor:
    return _table(x, torch.bfloat16, device)


def build_buffers(
    meshes: Sequence[MeshData],
    objects: Sequence[tuple[np.ndarray, int]],  # (trs 4x4, mesh index)
    materials: Sequence[MaterialImages],
    environment: np.ndarray,  # (H, W, 3) f32 linear radiance
    atlas_dtype: torch.dtype = torch.bfloat16,
    tri_bucket: int = 1024,
    device: torch.device | str = "cuda",
    tile_threshold_texels: int | None = None,
    tex_group_budget: int | None = None,
    tex_groups=None,
) -> SceneBuffers:
    """Flatten a scene into tensors on ``device`` (the card unless the
    caller asks for the CPU). Material sets of more than
    ``tile_threshold_texels`` (default TILE_ATLAS_THRESHOLD_TEXELS) texels
    whose maps share each material's size take the tile atlas, grouped
    under ``tex_group_budget`` bytes (default TEX_GROUP_BUDGET_BYTES) or as
    ``tex_groups`` (lists of material ids; their per-group tables are built
    too, for the grouped tile route). Smaller sets take the combined quad
    atlas: merged with the environment's bf16 rows when ``atlas_dtype`` is
    bf16, apart from them otherwise; where a material's non-constant maps
    differ in size, the per-slot atlas (in ``atlas_dtype``)."""
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
    threshold = (
        TILE_ATLAS_THRESHOLD_TEXELS if tile_threshold_texels is None else tile_threshold_texels
    )
    use_tiles = tile_ok and total_texels > threshold

    if use_tiles:
        images8 = []
        for mi, (h, w) in enumerate(per_mat_hw):
            group = [
                im if im.shape[:2] == (h, w) else np.broadcast_to(im[0:1, 0:1], (h, w, 4))
                for im in images[3 * mi : 3 * mi + 3]
            ]
            images8.append(np.concatenate(
                [group[0][..., :3], group[1][..., :3], group[2][..., 1:3]], axis=-1
            ))
        tiles_np, tile_meta = build_tile_atlas(images8)
        regions = np.zeros((len(materials), 3, 4), np.int32)  # no per-slot atlas
        combined = False
    else:
        atlas_np, locs = pack_atlas(images)
        regions = locs.reshape(len(materials), 3, 4)

        # Combined-slot atlas: interleave each material's non-elided
        # textures into one multi-channel image so a pixel's material taps
        # are ONE row.
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
        if combined:
            c_np, c_locs = pack_atlas(combined_imgs)
            combined_quads = pack_atlas_quads(c_np)

    env_np = np.asarray(environment, np.float32)
    env_rgba = np.concatenate(
        [env_np, np.ones((*env_np.shape[:2], 1), np.float32)], axis=-1
    )
    env_data, env_locs = pack_atlas([env_rgba])
    env_rows = _pack_rows_128(pack_atlas_quads(env_data))
    budget = TEX_GROUP_BUDGET_BYTES if tex_group_budget is None else tex_group_budget
    if use_tiles:
        # Each material group carries its own env copy, as f32 bits.
        tiles_np, tile_meta, tile_groups, tile_group_of, tile_mat_rows = group_tile_atlas(
            tiles_np, tile_meta, env_rows.view(np.int32), budget, explicit_groups=tex_groups,
        )
        c_reg = tile_meta  # lanes 43:47 carry the tile block (base, ntx, h, w)
    elif combined:
        c_reg = c_locs
    else:
        c_reg = np.zeros((len(materials), 4), np.float32)

    # Per-triangle material row: [atlas regions (3 slots x (y,x,h,w)) |
    # mr_consts | nm_consts[:3] | combined-atlas region or tile block].
    matrow_by_mat = np.concatenate(
        [regions.reshape(len(materials), 12).astype(np.float32),
         mr_consts, nm_consts[:, :3], c_reg.astype(np.float32)], axis=1,
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

    static_rows = f32(slot_static)
    geometry = Geometry(
        num_tris=num_tris,
        tri_corner_pos=f32(tri_corner_pos.reshape(-1, 9).T),
        tri_trs=f32(tri_trs),
        # The tri-major planes are the primary slots of the static rows.
        tri_static_attrs=static_rows[0:33, :cap],
        tri_matrow=static_rows[33:56, :cap],
        slot_static_rows=static_rows,
        tri_material=torch.as_tensor(tri_mat.astype(np.int32), device=device),
        object_trs=f32(np.stack(trs_list)),
        tri_obj=torch.as_tensor(tri_obj, device=device),
    )
    env_rows_t = None
    flags = dict(nm_constant=nm_constant, mr_constant=mr_constant)
    if use_tiles:
        atlas = TextureAtlas(
            tiles=torch.as_tensor(tiles_np, device=device),
            tiles_ntex=int(tile_groups[0][1]),
            tile_groups=tile_groups,
            tile_group_of=tile_group_of,
            tile_mat_rows=tile_mat_rows,
            tile_group_budget=budget,
            **flags,
        )
    elif combined and atlas_dtype == torch.bfloat16:
        atlas = TextureAtlas(
            combined_slots=tuple(slots),
            combined_shape=c_np.shape[:2],
            quad_width=combined_quads.shape[1],
            combined_env_rows=torch.cat(
                [_bf16(pack_tex_rows(combined_quads), device), _bf16(env_rows, device)]
            ),
            **flags,
        )
    elif combined:
        # Texels and environment rows of different types: two tables.
        atlas = TextureAtlas(
            combined_slots=tuple(slots),
            combined_shape=c_np.shape[:2],
            quad_width=combined_quads.shape[1],
            combined_quads=_table(combined_quads, atlas_dtype, device),
            **flags,
        )
        env_rows_t = _bf16(env_rows, device)
    else:
        atlas = TextureAtlas(
            quads=_table(pack_atlas_quads(atlas_np), atlas_dtype, device),
            data_shape=atlas_np.shape[:2],
            **flags,
        )
        env_rows_t = _bf16(env_rows, device)
    environment_ = Environment(
        region=tuple(int(v) for v in env_locs[0]),
        data_shape=env_data.shape[:2],
        num_rows=env_rows.shape[0],
        rows=env_rows_t,
    )
    return SceneBuffers(geometry=geometry, atlas=atlas, environment=environment_)
