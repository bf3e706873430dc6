"""Texture sampling with D3D linear-wrap semantics — torch port of the
parts of arctic_tpu/ops/sampling.py the frames use: around two CUDA
kernels, K6 ``tap_resolve`` (csrc/tap_resolve.cu) for _tap_resolve_kernel,
the merged bf16 quad table of small texture sets, and K9
``tile_tap_resolve`` (csrc/tile_tap_resolve.cu) for _tile_tap_resolve_kernel,
the u16 tile atlas of reference-scale texture sets (the fused frame), also
per material group (``tile_tap_resolve_grouped``); and in plain torch
``sample_atlas_multi`` (the deferred frame) and ``sample_quads_flat`` (the
per-slot and unmerged taps).

Bilinear filtering is ``t = uv * size - 0.5``, texel pair floor(t) and
floor(t) + 1, fractional lerp, with WRAP applied per texel in region-local
texel space. Quad tables hold the four parity-shifted copies of every 2x2
texel block, so one bilinear footprint is one row. The scene build's
host-side pieces of the JAX module (sRGB decode, pack_tex_rows) are numpy
in io/build.py.
"""

from __future__ import annotations

import torch

from arctic_tpu_torch.ops.shadow import DQ
from arctic_tpu_torch.utils import kernels

# Tile-atlas geometry (io/build.py build_tile_atlas): 4x8-texel tiles on a
# (3, 7)-stride grid, so every bilinear 2x2 window lies in the tile at
# (ys // 3, xs // 7): ys % 3 <= 2 and xs % 7 <= 6.
TILE_H, TILE_W = 4, 8
TILE_SY, TILE_SX = 3, 7


def _i32(v):
    return v.to(torch.int32) if isinstance(v, torch.Tensor) else int(v)


def quad_index(block_grid, ry, rx, rh, rw, u, v):
    """Quad-table row index and bilinear fractions -> (q, fx, fy).

    Region fields are f32 planes (truncated to int, as the JAX package's
    astype does) or Python ints; u, v are f32 planes. Integer math is int32
    with floor division / modulo, like jnp."""
    ry, rx, rh, rw = (_i32(a) for a in (ry, rx, rh, rw))
    t_x = u * rw - 0.5
    t_y = v * rh - 0.5
    ix0 = torch.floor(t_x).to(torch.int32)
    iy0 = torch.floor(t_y).to(torch.int32)
    fx = t_x - ix0
    fy = t_y - iy0
    ys = ry + iy0 % rh + 1  # +1: skip the top/left border row
    xs = rx + ix0 % rw + 1
    bh, bw = block_grid
    copy = (ys % 2) * 2 + xs % 2
    q = (copy * bh + ys // 2) * bw + xs // 2
    return q, fx, fy


def sample_atlas_multi(atlas, ry, rx, rh, rw, u, v):
    """All of a material's texture slots at (u, v) in one quad gather: the
    JAX package's sample_atlas_multi, read from the combined quad rows the
    fused frame's K6 reads (TextureAtlas.combined_env_rows) instead of a
    per-slot atlas. The build combines a material's non-constant slots
    only where they share one size, and broadcasts a constant slot to it,
    so the combined region gives each slot's texel indices and fractions
    (a constant slot samples to its constant at any size): the same bf16
    texels, lerped by the same f32 operations.

    Region fields are the combined region's (y, x, h, w) planes, u and v f32
    planes of the same shape. Returns (4 * len(combined_slots), ...) f32
    planes: slot combined_slots[i]'s RGBA at [4i, 4i + 4)."""
    q, fx, fy = quad_index(atlas.combined_block_grid, ry, rx, rh, rw, u, v)
    c4 = atlas.quad_width
    per = 128 // c4
    rows = atlas.combined_env_rows
    quads = rows[:, : per * c4].unflatten(1, (per, c4))  # (R, per, c4) view
    win = quads[(q // per).long(), (q % per).long()].to(torch.float32)  # (..., c4)
    c = c4 // 4
    fx, fy = fx[..., None], fy[..., None]
    top = win[..., 0:c] + (win[..., c : 2 * c] - win[..., 0:c]) * fx
    bot = win[..., 2 * c : 3 * c] + (win[..., 3 * c :] - win[..., 2 * c : 3 * c]) * fx
    return (top + (bot - top) * fy).movedim(-1, 0)


# The quad widths K6 takes (one kernel instantiation each): a multiple of 4
# with c4/4 texture channels and 4 env channels in the 16 output planes.
C4_WIDTHS = tuple(range(4, 49, 4))


def tap_resolve_plain(table, idx, tq, eq, tfx, tfy, efx, efy, c4: int):
    """Plain torch K6: gather row ``table[idx]``, widen to f32, take the
    texture quad at lanes [c4*tq, +c4) and the env quad at [16*eq, +16),
    bilerp both (sampling.py:275-286). Returns (16, n) f32 planes."""
    n = idx.shape[0]
    c = c4 // 4
    row = table[idx.long()].to(torch.float32)  # (n, 128)

    def take(base, width):
        lanes = base.long()[:, None] * width + torch.arange(width, device=row.device)
        return torch.gather(row, 1, lanes)

    def lerp(win, k, fx, fy):
        top = win[:, 0:k] + (win[:, k : 2 * k] - win[:, 0:k]) * fx[:, None]
        bot = win[:, 2 * k : 3 * k] + (win[:, 3 * k : 4 * k] - win[:, 2 * k : 3 * k]) * fx[:, None]
        return top + (bot - top) * fy[:, None]

    tex = lerp(take(tq, c4), c, tfx, tfy)
    env = lerp(take(eq, 16), 4, efx, efy)
    pad = torch.zeros((n, 16 - c - 4), dtype=torch.float32, device=row.device)
    return torch.cat([tex, env, pad], dim=1).T.contiguous()


@kernels.kernel(
    "tap_resolve", "arctic_tpu_torch/csrc/tap_resolve.cu",
    "arctic_tpu/ops/sampling.py:251 (_tap_resolve_kernel)",
    tap_resolve_plain,
)
def tap_resolve(table, idx, tq, eq, tfx, tfy, efx, efy, c4: int):
    """K6: merged texture + environment tap of n pixels.

    table: (R, 128) bf16 [packed material quads; env quads]; idx: (n,) i32
    table rows; tq: (n,) i32 quad within the row (q % per); eq: (n,) i32 env
    quad within the row (q % 8); tfx/tfy/efx/efy: (n,) f32 bilinear
    fractions; c4 in {4, 8, ..., 48}. Returns (16, n) f32: [0, c4/4)
    texture channels, [c4/4, c4/4 + 4) env RGBA, zero after. On the card
    the table must be contiguous and 16-byte aligned (the kernel reads its
    rows with 16-byte loads)."""
    if not table.is_cuda:
        return tap_resolve_plain(table, idx, tq, eq, tfx, tfy, efx, efy, c4)
    n = idx.shape[0]
    kernels.check_cuda(table, "table", torch.bfloat16, (table.shape[0], 128))
    if table.data_ptr() % 16:
        raise ValueError("table: expected a 16-byte aligned tensor")
    for name, t in (("idx", idx), ("tq", tq), ("eq", eq)):
        kernels.check_cuda(t, name, torch.int32, (n,))
    for name, t in (("tfx", tfx), ("tfy", tfy), ("efx", efx), ("efy", efy)):
        kernels.check_cuda(t, name, torch.float32, (n,))
    if c4 not in C4_WIDTHS:
        raise ValueError(f"c4={c4}: need a multiple of 4 with 4 <= c4 and c4/4 + 4 <= 16")
    out = torch.empty((16, n), dtype=torch.float32, device=table.device)
    kernels.launch("arctic_tap_resolve", table, idx, tq, eq, tfx, tfy, efx, efy, n, c4, out)
    tap_resolve.launches += 1
    return out


def tile_index(base, ntx, th, tw, u, v):
    """-> (row, ty, tx, fx, fy): tile-table row and in-tile window origin of
    the u16 tile atlas. The ``t = uv * size - 0.5`` prologue and per-texel
    WRAP of quad_index; (base, ntx) address the material's tile block.
    Integer math is int32 with floor division / modulo, like jnp."""
    base, ntx, th, tw = (_i32(a) for a in (base, ntx, th, tw))
    t_x = u * tw - 0.5
    t_y = v * th - 0.5
    ix0 = torch.floor(t_x).to(torch.int32)
    iy0 = torch.floor(t_y).to(torch.int32)
    fx = t_x - ix0
    fy = t_y - iy0
    ys = iy0 % th + 1  # +1: the wrapped border row
    xs = ix0 % tw + 1
    row = base + (ys // TILE_SY) * ntx + xs // TILE_SX
    return row, ys % TILE_SY, xs % TILE_SX, fx, fy


def _lerp(c00, c10, c01, c11, fx, fy):
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def tile_tap_resolve_plain(table, idx, ty, tx, eq, tfx, tfy, efx, efy):
    """Plain torch K9 (sampling.py:387-432): for each pixel, the 2x2 tile
    window at (ty, tx) of row ``table[idx]`` — 8 u16 channels dequantised as
    q * DQ and bilerped — and the env quad at lanes [16*eq, +16) of the same
    row bitcast to f32 and bilerped. Reads only the lanes it needs (never
    the (n, 128) rows). Returns (16, n) f32: [0:8) texture, [8:12) env,
    zeros after."""
    n = idx.shape[0]
    dev = table.device
    row = idx.long()[:, None]
    win = (ty * 8 + tx).long()[:, None] + torch.tensor([0, 1, 8, 9], device=dev)
    tex = []
    for c2 in range(4):  # lane block c2 holds channels 2*c2 (low u16), 2*c2+1 (high)
        v = table[row, c2 * 32 + win]  # (n, 4) i32: c00, c10, c01, c11
        for q in (v & 0xFFFF, (v >> 16) & 0xFFFF):
            c = q.to(torch.float32) * DQ
            tex.append(_lerp(c[:, 0], c[:, 1], c[:, 2], c[:, 3], tfx, tfy))
    e = table[row, 16 * eq.long()[:, None] + torch.arange(16, device=dev)].view(torch.float32)
    env = _lerp(e[:, 0:4], e[:, 4:8], e[:, 8:12], e[:, 12:16], efx[:, None], efy[:, None])
    zeros = torch.zeros((4, n), dtype=torch.float32, device=dev)
    return torch.cat([torch.stack(tex), env.T, zeros]).contiguous()


@kernels.kernel(
    "tile_tap_resolve", "arctic_tpu_torch/csrc/tile_tap_resolve.cu",
    "arctic_tpu/ops/sampling.py:373 (_tile_tap_resolve_kernel)",
    tile_tap_resolve_plain,
)
def tile_tap_resolve(table, idx, ty, tx, eq, tfx, tfy, efx, efy):
    """K9: tile-atlas texture + environment tap of n pixels.

    table: (N, 128) i32 tile atlas with env copies (TextureAtlas.tiles);
    idx: (n,) i32 table rows; ty: (n,) i32 in [0, 3); tx: (n,) i32 in
    [0, 7); eq: (n,) i32 env quad within the row, [0, 8); tfx/tfy/efx/efy:
    (n,) f32 bilinear fractions. Returns (16, n) f32: [0:8) the texture
    channels (diffuse RGB, normal XYZ, mr G, mr B), [8:12) env RGBA, zeros
    after."""
    if not table.is_cuda:
        return tile_tap_resolve_plain(table, idx, ty, tx, eq, tfx, tfy, efx, efy)
    n = idx.shape[0]
    kernels.check_cuda(table, "table", torch.int32, (table.shape[0], 128))
    for name, t in (("idx", idx), ("ty", ty), ("tx", tx), ("eq", eq)):
        kernels.check_cuda(t, name, torch.int32, (n,))
    for name, t in (("tfx", tfx), ("tfy", tfy), ("efx", efx), ("efy", efy)):
        kernels.check_cuda(t, name, torch.float32, (n,))
    out = torch.empty((16, n), dtype=torch.float32, device=table.device)
    kernels.launch("arctic_tile_tap_resolve", table, idx, ty, tx, eq, tfx, tfy, efx, efy, n, out)
    tile_tap_resolve.launches += 1
    return out


def sample_quads_flat(quads, block_grid, ry, rx, rh, rw, u, v):
    """Bilinear tap from a quad table (rows [c00 | c10 | c01 | c11] of C
    channels each; JAX sampling.py:130): the per-slot and the unmerged
    combined taps. Region fields are planes (or ints) of u's shape;
    returns (..., C) f32, the quads' texels widened from the table's type
    and lerped in f32."""
    q, fx, fy = quad_index(block_grid, ry, rx, rh, rw, u, v)
    win = quads[q.long()].to(torch.float32)  # (..., 4C)
    c = win.shape[-1] // 4
    fx, fy = fx[..., None], fy[..., None]
    top = win[..., :c] + (win[..., c : 2 * c] - win[..., :c]) * fx
    bot = win[..., 2 * c : 3 * c] + (win[..., 3 * c :] - win[..., 2 * c : 3 * c]) * fx
    return top + (bot - top) * fy


def tile_row_groups(covered, gid_pix, n_groups: int):
    """Material-group claims of 128-pixel rows (JAX sampling.py:461):
    covered / gid_pix are (R, 128), gid_pix each covered pixel's group.
    Returns (g_lo, g_hi, many): the lowest and highest group the row's
    covered pixels touch (0 and 0 for a row with none: its env reads live
    in every group's slice) and whether more than two groups are touched."""
    gmin = torch.where(covered, gid_pix, n_groups).amin(dim=1)
    gmax = torch.where(covered, gid_pix, -1).amax(dim=1)
    has_cov = gmax >= 0
    g_lo = torch.where(has_cov, gmin, 0)
    g_hi = torch.where(has_cov, gmax, 0)
    mid = covered & (gid_pix != g_lo[:, None]) & (gid_pix != g_hi[:, None])
    return g_lo, g_hi, mid.any(dim=1)


def _first_rows(mask, cap: int):
    """The indices of the first ``cap`` rows, those with ``mask`` set in
    row order, then the others in row order (a stable compaction)."""
    return torch.argsort((~mask).to(torch.int8), stable=True)[:cap]


def tile_tap_resolve_grouped(tiles, groups, caps, trow, covered, eqd, gid_pix, g_lo, g_hi,
                             many, aux):
    """The grouped tile route's tap (JAX sampling.py:486-597) over R rows of
    128 pixels. A row claims every group its covered pixels touch (at most
    two); the rows of group g are compacted (stable, in row order) and
    K9 resolves the first caps[g] of them from the group's table, its
    per-pixel rows given as indices into that table. Rows of more than two
    groups, or past a claimed group's cap, take the full-table fallback,
    the first caps[-1] of them. Every pixel reads the row and the aux values
    the plain full-table tap reads, so the planes are the same bit for bit;
    a row past the fallback's cap reads another row's values, and the
    returned count (a 0-dim tensor) > caps[-1] says so (check_stats raises).

    tiles: (N, 128) i32 tile atlas; groups: TextureAtlas.tile_groups;
    caps: len(groups) + 1 row capacities; trow / covered / eqd / gid_pix:
    (R, 128) absolute tile row, coverage, env quad row offset (eq // 8)
    and group of each pixel; g_lo / g_hi / many: tile_row_groups; aux: the
    7 (R, 128) planes K9 takes after its row (ty, tx, eq % 8, tfx, tfy,
    efx, efy). Each group's table is a view of its rows of ``tiles``, no
    copy. Returns ((16, R, 128) f32, fallback rows). Launches K9
    len(groups) + 1 times. Unlike the JAX package's, the rows are not
    padded to a multiple of 32, so no padding row takes a group's room."""
    g_n = len(groups)
    if len(caps) != g_n + 1 or any(c <= 0 for c in caps):
        raise ValueError(f"caps {caps}: need {g_n + 1} positive capacities")
    r = trow.shape[0]
    caps = tuple(min(int(c), r) for c in caps)  # a cap never needs more than all rows
    ranks, kepts = [], []
    for g in range(g_n):
        member = ~many & ((g_lo == g) | (g_hi == g))
        rank = torch.cumsum(member.to(torch.int32), 0) - 1
        kepts.append(member & (rank < caps[g]))
        ranks.append(rank)
    # A dual row that spills either claimed cap takes the fallback whole.
    ok_lo = torch.zeros_like(many)
    ok_hi = torch.zeros_like(many)
    for g in range(g_n):
        ok_lo = ok_lo | ((g_lo == g) & kepts[g])
        ok_hi = ok_hi | ((g_hi == g) & kepts[g])
    fb = many | ~(ok_lo & ok_hi)
    fb_rank = torch.cumsum(fb.to(torch.int32), 0) - 1
    fb_rows = fb.sum(dtype=torch.int32)

    outs = []
    for g in range(g_n):
        lo, env_base, hi = groups[g][:3]
        order = _first_rows(kepts[g], caps[g])
        # A covered pixel reads its tile row, an uncovered one this group's
        # env copy; the other group's pixels of a dual row read junk inside
        # the slice, which the reassembly below never picks.
        idx = torch.clamp(torch.where(covered, trow - lo, (env_base - lo) + eqd), 0, hi - lo - 1)
        outs.append(tile_tap_resolve(tiles[lo:hi], idx[order].reshape(-1),
                                     *(a[order].reshape(-1) for a in aux)))
    order = _first_rows(fb, caps[g_n])
    idx = torch.clamp(torch.where(covered, trow, groups[0][1] + eqd), 0, tiles.shape[0] - 1)
    outs.append(tile_tap_resolve(tiles, idx[order].reshape(-1),
                                 *(a[order].reshape(-1) for a in aux)))

    stream = torch.cat(outs, dim=1).view(16, -1, 128)  # (16, sum(caps), 128)
    offs = [0]
    for c in caps:
        offs.append(offs[-1] + c)
    srow_lo = torch.zeros_like(fb_rank)
    srow_hi = torch.zeros_like(fb_rank)
    for g in range(g_n):
        at = offs[g] + torch.clamp(ranks[g], 0, caps[g] - 1)
        srow_lo = torch.where(~fb & (g_lo == g), at, srow_lo)
        srow_hi = torch.where(~fb & (g_hi == g), at, srow_hi)
    fb_at = offs[g_n] + torch.clamp(fb_rank, 0, caps[g_n] - 1)
    srow_lo = torch.where(fb, fb_at, srow_lo).long()
    srow_hi = torch.where(fb, fb_at, srow_hi).long()
    # A covered pixel of the row's high group reads the hi stream, every
    # other pixel the lo stream (the same row on single-group and fallback
    # rows).
    pick_hi = covered & (gid_pix == g_hi[:, None])
    return torch.where(pick_hi[None], stream[:, srow_hi], stream[:, srow_lo]), fb_rows
