"""Tiled rasterizer, shade-row build and G-buffer resolve — torch port of
arctic_tpu/ops/raster_tiles.py around five CUDA kernels:

- K1 ``raster_tiles``    (csrc/raster_tiles.cu) for _raster_kernel, with
  _pack16_kernel + _phase_resolve_kernel folded into its row load;
- K3 ``pack_shade_rows`` (csrc/pack_shade_rows.cu) for _pack_shade_rows_kernel;
- K11 ``pack_shade_rows_tm`` (csrc/pack_shade_rows.cu, the other
  instantiation of K3's kernel template) for _pack_shade_rows_tm_kernel: K3
  with tri-major corner planes (no frame calls it, as in the JAX package);
- K10 ``transpose_pack_rows`` (csrc/transpose_pack_rows.cu) for
  _transpose_pack_kernel: the full-stack shade-row build's transpose;
- K4 ``select_interp``   (csrc/select_interp.cu) for _select_kernel.

Each wrapper takes its plain torch version for CPU tensors and launches its
kernel for CUDA tensors (or raises). Buffers are row-major (H_pad, W_pad)
images and (C, H_pad, W_pad) planes — the natural layout on a GPU — in
place of the TPU's tile-major pixel blocks; the values are the same.
"""

from __future__ import annotations

import torch

from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.ops import binning
from arctic_tpu_torch.ops.raster import TriSetup
from arctic_tpu_torch.utils import kernels

GBUF_LANES = 64  # interp attrs [0:17), material row [24:47) — see pack_shade_rows

# Shade-row lanes holding the raw raster planes (A,B,C x 3 edges, z plane).
SHADE_ROW_RASTER_LANE = 112

# Pairs the plain K1 evaluates per step (bounds its (pairs, tile pixels) temporaries).
PLAIN_CHUNK = 1024


# --------------------------------------------------------------------------
# K1: tiled depth raster
# --------------------------------------------------------------------------


def _pair_chunks(rows, lane0, sorted_slot, tile_start, tiles_x, tile_h, tile_w, row0=0):
    """Every pair of the lists against every pixel of its tile, PLAIN_CHUNK
    pairs at a time: yields (list positions (n,), z (n, tile px), inside
    (n, tile px): all three edges >= 0, pixel index (n, tile px) in the
    (tiles_y * tile_h, tiles_x * tile_w) buffer), each plane evaluated as
    (A*px + B*py) + C at the pixel centre, as K1 does; the buffer's first
    row is the frame's pixel row ``row0``."""
    dev = rows.device
    n_pairs = int(tile_start[-1])
    loc = torch.arange(tile_h * tile_w, device=dev)
    lx, ly = loc % tile_w, loc // tile_w
    tile_start = tile_start.long()
    for k0 in range(0, n_pairs, PLAIN_CHUNK):
        ks = torch.arange(k0, min(k0 + PLAIN_CHUNK, n_pairs), device=dev)
        t = torch.searchsorted(tile_start, ks, right=True) - 1
        r = rows[sorted_slot[ks].long(), lane0 : lane0 + 12]
        gx = (t % tiles_x)[:, None] * tile_w + lx[None]
        gy = (t // tiles_x)[:, None] * tile_h + ly[None]
        px = gx.to(torch.float32) + 0.5
        py = (gy + row0).to(torch.float32) + 0.5

        def plane(j):
            return r[:, j : j + 1] * px + r[:, j + 1 : j + 2] * py + r[:, j + 2 : j + 3]

        inside = (plane(0) >= 0.0) & (plane(3) >= 0.0) & (plane(6) >= 0.0)
        yield ks, plane(9), inside, gy * (tiles_x * tile_w) + gx


def raster_tiles_plain(
    rows, lane0, sorted_slot, tile_start, tiles_x, tiles_y, tile_h, tile_w,
    depth_only=False, row0=0,
):
    """Plain torch K1: brute force within the tile lists. Every pair is
    tested against every pixel of its tile; a pixel keeps the smallest
    accepted z < 1 and, on a tie, the pair first in list order — what the
    kernel's sequential strict ``z < zbuf`` loop keeps."""
    dev = rows.device
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    n_pairs = int(tile_start[-1])
    zbuf = torch.full((hp * wp,), torch.inf, dtype=torch.float32, device=dev)
    kbuf = torch.full((hp * wp,), n_pairs, dtype=torch.int64, device=dev)

    def evaluate():
        for ks, z, inside, pix in _pair_chunks(
            rows, lane0, sorted_slot, tile_start, tiles_x, tile_h, tile_w, row0
        ):
            ok = inside & (z >= 0.0) & (z < 1.0)
            yield ks, torch.where(ok, z, torch.inf), pix

    for _, zacc, pix in evaluate():
        zbuf.scatter_reduce_(0, pix.reshape(-1), zacc.reshape(-1), "amin")
    ibuf = None
    if not depth_only:
        for ks, zacc, pix in evaluate():
            win = (zacc == zbuf[pix]) & torch.isfinite(zacc)
            cand = torch.where(win, ks[:, None], n_pairs)
            kbuf.scatter_reduce_(0, pix.reshape(-1), cand.reshape(-1), "amin")
        ibuf = torch.full((hp * wp,), -1, dtype=torch.int32, device=dev)
        if n_pairs:
            slot = sorted_slot[torch.clamp(kbuf, max=n_pairs - 1)]
            ibuf = torch.where(kbuf < n_pairs, slot, ibuf)
        ibuf = ibuf.reshape(hp, wp)
    zbuf = torch.where(torch.isinf(zbuf), 1.0, zbuf).reshape(hp, wp)
    return zbuf, ibuf


def block_rejects(rows12, x_lo, x_hi, y_lo, y_hi):
    """K1's per-block cull (csrc/raster_tiles.cu) for (K, 12) f32 raster
    rows and a rectangle of pixel centres [x_lo, x_hi] x [y_lo, y_hi]: (K,)
    bool, True where the pair is rejected for every pixel of it — an edge
    below 0 at its largest corner, z below 0 at its largest or >= 1 at its
    smallest. Same f32 operations in the same order as the kernel; the
    kernel's header note says why no pixel of the rectangle then accepts."""

    def at(a, b, c, x_if_pos, x_else, y_if_pos, y_else):
        x = torch.where(a > 0.0, x_if_pos, x_else)
        y = torch.where(b > 0.0, y_if_pos, y_else)
        return a * x + b * y + c

    x_lo, x_hi, y_lo, y_hi = (
        torch.tensor(v, dtype=torch.float32, device=rows12.device) for v in (x_lo, x_hi, y_lo, y_hi)
    )
    r = [rows12[:, j] for j in range(12)]
    rejected = at(*r[9:12], x_lo, x_hi, y_lo, y_hi) >= 1.0
    for j in (0, 3, 6, 9):
        rejected |= at(*r[j : j + 3], x_hi, x_lo, y_hi, y_lo) < 0.0
    return rejected


def block_layout(tile_h: int, tile_w: int) -> tuple[int, int, int, int]:
    """K1's sub-tile of 256 pixels and its warp rectangles of 32 for a
    tile_h x tile_w tile: (bh, bw, rh, rw), each side a power of two. The
    sub-tile is the one of which the fewest cover the tile (ceil(tile_h /
    bh) * ceil(tile_w / bw)), the squarest of those, the wider of two
    equally square; the rectangles are chosen the same way in the sub-tile
    (they tile it). Where no sub-tile tiles the tile exactly, the edge
    sub-tiles hang over it and K1 clips them (csrc/raster_tiles.cu)."""

    def best(height, width, log2):
        def blocks(c):
            return -(-height // (1 << (log2 - c))) * -(-width // (1 << c))

        return min(range(log2 + 1), key=lambda c: (blocks(c), abs(2 * c - log2), -c))

    bw_log2 = best(tile_h, tile_w, 8)
    bh, bw = 256 >> bw_log2, 1 << bw_log2
    rw_log2 = best(bh, bw, 5)
    return bh, bw, 32 >> rw_log2, 1 << rw_log2


def covered_pair_pixels(
    rows, lane0, sorted_slot, tile_start, tiles_x, tiles_y, tile_h, tile_w,
    depth_only=False, row0=0,
) -> int:
    """The (pair, pixel of its tile) combinations of one K1 call whose three
    edge tests pass: the depth tests that any exact raster of these lists
    makes (K1's operations bound; takes K1's arguments)."""
    return sum(
        int(inside.sum())
        for _, _, inside, _ in _pair_chunks(
            rows, lane0, sorted_slot, tile_start, tiles_x, tile_h, tile_w, row0
        )
    )


@kernels.kernel(
    "raster_tiles", "arctic_tpu_torch/csrc/raster_tiles.cu",
    "arctic_tpu/ops/raster_tiles.py:367 (_raster_kernel; + :94 _pack16_kernel, "
    ":67 _phase_resolve_kernel)",
    raster_tiles_plain,
)
def raster_tiles(
    rows, lane0, sorted_slot, tile_start, tiles_x, tiles_y, tile_h, tile_w,
    depth_only=False, row0=0,
):
    """K1: per-tile depth raster over the binned pair lists.

    rows: (P, stride) f32 row table whose lanes [lane0, lane0 + 12) hold a
    slot's 3 edge planes and z plane; sorted_slot / tile_start: the binning
    of tile_h x tile_w tiles, any shape of whole 128-pixel rows.
    ``row0``: the frame's pixel row of the buffers' first row (a slab of a
    sharded frame; 0 = the whole frame). Returns (zbuf (H_pad, W_pad) f32
    cleared to 1.0, ibuf (H_pad, W_pad) i32 cleared to -1, or None when
    ``depth_only``)."""
    if not rows.is_cuda:
        return raster_tiles_plain(
            rows, lane0, sorted_slot, tile_start, tiles_x, tiles_y, tile_h,
            tile_w, depth_only, row0,
        )
    num_tiles = tiles_x * tiles_y
    kernels.check_cuda(rows, "rows", torch.float32)
    if rows.dim() != 2 or lane0 + 12 > rows.shape[1]:
        raise ValueError(f"rows: need 12 lanes from {lane0}, got {tuple(rows.shape)}")
    kernels.check_cuda(sorted_slot, "sorted_slot", torch.int32)
    kernels.check_cuda(tile_start, "tile_start", torch.int32, (num_tiles + 1,))
    if tile_h < 1 or tile_w < 1 or tile_h * tile_w % 128:
        raise ValueError(f"tile {tile_h}x{tile_w}: its pixels must fill whole 128-pixel rows")
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    if not 0 <= row0 < (1 << 23) - hp or wp >= 1 << 23:
        raise ValueError(f"row0 = {row0}, {hp} x {wp} buffer: pixel rows and columns must "
                         f"stay below 2^23")
    _, bw, _, rw = block_layout(tile_h, tile_w)
    zbuf = torch.empty((hp, wp), dtype=torch.float32, device=rows.device)
    ibuf = None if depth_only else torch.empty((hp, wp), dtype=torch.int32, device=rows.device)
    kernels.launch(
        "arctic_raster_tiles", rows, rows.shape[1], lane0, sorted_slot, tile_start,
        num_tiles, tiles_x, tile_h, tile_w, bw.bit_length() - 1, rw.bit_length() - 1, wp, row0,
        zbuf, ibuf,
    )
    raster_tiles.launches += 1
    return zbuf, ibuf


# --------------------------------------------------------------------------
# K3: shade-row table
# --------------------------------------------------------------------------


def pack_shade_rows_plain(pf: torch.Tensor, st: torch.Tensor, p: int) -> torch.Tensor:
    """Plain torch K3: the 128-component stack of pipeline.py:380-435,
    assembled from the per-frame planes ``pf`` (48, N) and the static rows
    ``st`` (56, N) with the kernel's expressions, transposed to (N, 128)."""
    n = pf.shape[1]
    gid = torch.arange(n, device=pf.device)
    valid = gid < p
    gidf = gid.to(torch.float32)
    z = torch.zeros(n, dtype=torch.float32, device=pf.device)
    comps = [pf[lane] * pf[12 + lane // 3] for lane in range(9)]  # ebw [0:9)
    comps.append(torch.where(valid, gidf, -2.0))  # sid [9]
    comps += [z] * 6
    for c in range(3):
        cb0, cb1, cb2 = pf[15 + 3 * c], pf[16 + 3 * c], pf[17 + 3 * c]
        comps += [cb0 * pf[24 + i] + cb1 * pf[27 + i] + cb2 * pf[30 + i] for i in range(3)]
        comps += [cb0 * st[a] + cb1 * st[11 + a] + cb2 * st[22 + a] for a in range(11)]
        comps += [cb0 * pf[33 + i] + cb1 * pf[36 + i] + cb2 * pf[39 + i] for i in range(3)]
        comps += [z] * 7
    comps += [st[33 + j] for j in range(23)] + [z]  # material row [88:111)
    comps += [pf[j] for j in range(12)]  # raw planes [112:124)
    comps.append(torch.where(valid, gidf, 0.0))  # raster slot id [124]
    comps += [z] * 3
    return torch.stack(comps, dim=1)


@kernels.kernel(
    "pack_shade_rows", "arctic_tpu_torch/csrc/pack_shade_rows.cu",
    "arctic_tpu/ops/raster_tiles.py:189 (_pack_shade_rows_kernel)",
    pack_shade_rows_plain,
)
def pack_shade_rows(pf: torch.Tensor, st: torch.Tensor, p: int) -> torch.Tensor:
    """K3: (48, N) per-frame planes + (56, N) static rows -> (N, 128) table."""
    if not pf.is_cuda:
        return pack_shade_rows_plain(pf, st, p)
    n = pf.shape[1]
    kernels.check_cuda(pf, "pf", torch.float32, (48, n))
    kernels.check_cuda(st, "st", torch.float32, (56, n))
    out = torch.empty((n, 128), dtype=torch.float32, device=pf.device)
    kernels.launch("arctic_pack_shade_rows", pf, st, n, p, out)
    pack_shade_rows.launches += 1
    return out


def pack_shade_rows_tm_plain(pf: torch.Tensor, tri: torch.Tensor, st: torch.Tensor, p: int):
    """Plain torch K11: K3 with the 18 wc / lsp planes read tri-major —
    slot s takes triangle s % cap for s < 2 * cap and zeros beyond — then
    K3's plain version on the (48, N) stack that gives."""
    n, cap = pf.shape[1], tri.shape[1]
    full = torch.zeros((48, n), dtype=torch.float32, device=pf.device)
    full[:24] = pf
    m = min(n, 2 * cap)
    full[24:42, :m] = tri[:, torch.arange(m, device=pf.device) % cap]
    return pack_shade_rows_plain(full, st, p)


@kernels.kernel(
    "pack_shade_rows_tm", "arctic_tpu_torch/csrc/pack_shade_rows.cu",
    "arctic_tpu/ops/raster_tiles.py:275 (_pack_shade_rows_tm_kernel)",
    pack_shade_rows_tm_plain,
)
def pack_shade_rows_tm(pf: torch.Tensor, tri: torch.Tensor, st: torch.Tensor, p: int):
    """K11: (24, N) slot-major planes (pf[0:24) of K3) + (18, cap) tri-major
    world / light-space corner planes (wc[k][i] at 3k+i, lsp at 9+3k+i) +
    (56, N) static rows -> (N, 128) table, equal to K3's on the dup'd stack.
    Any p <= N is taken (the JAX package asserted p == 2 * cap + 1 while its
    clip slots number 2 * cap, so its frame never reached this kernel)."""
    if not pf.is_cuda:
        return pack_shade_rows_tm_plain(pf, tri, st, p)
    n = pf.shape[1]
    kernels.check_cuda(pf, "pf", torch.float32, (24, n))
    kernels.check_cuda(tri, "tri", torch.float32, (18, tri.shape[1]))
    kernels.check_cuda(st, "st", torch.float32, (56, n))
    if not 0 <= p <= n or tri.shape[1] < 1:
        raise ValueError(f"p = {p} slots need 0 <= p <= N = {n} and a triangle plane")
    out = torch.empty((n, 128), dtype=torch.float32, device=pf.device)
    kernels.launch("arctic_pack_shade_rows_tm", pf, tri, st, n, tri.shape[1], p, out)
    pack_shade_rows_tm.launches += 1
    return out


# --------------------------------------------------------------------------
# K10: (128, N) component stack -> (N, 128) rows
# --------------------------------------------------------------------------


def transpose_pack_rows_plain(stacked: torch.Tensor) -> torch.Tensor:
    """Plain torch K10 (also the one library call that computes it)."""
    return stacked.t().contiguous()


@kernels.kernel(
    "transpose_pack_rows", "arctic_tpu_torch/csrc/transpose_pack_rows.cu",
    "arctic_tpu/ops/raster_tiles.py:162 (_transpose_pack_kernel)",
    transpose_pack_rows_plain,
)
def transpose_pack_rows(stacked: torch.Tensor) -> torch.Tensor:
    """K10: (128, N) component-major stack -> (N, 128) row table."""
    if not stacked.is_cuda:
        return transpose_pack_rows_plain(stacked)
    n = stacked.shape[1] if stacked.dim() == 2 else 0
    kernels.check_cuda(stacked, "stacked", torch.float32, (128, n))
    out = torch.empty((n, 128), dtype=torch.float32, device=stacked.device)
    kernels.launch("arctic_transpose_pack_rows", stacked, n, out)
    transpose_pack_rows.launches += 1
    return out


# --------------------------------------------------------------------------
# K4: G-buffer resolve
# --------------------------------------------------------------------------


def select_interp_plain(rows: torch.Tensor, ibuf: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Plain torch K4: read each covered pixel's shade row by slot id,
    perspective-correct barycentrics at the frame's pixel centre (ibuf's
    first row is the frame's row ``row0``), interpolate / copy into 64
    lanes."""
    h, w = ibuf.shape
    cov = (ibuf >= 0).reshape(-1, 1)
    r = torch.where(cov, rows[torch.clamp(ibuf, min=0).reshape(-1).long()], 0.0)
    py, px = torch.meshgrid(
        torch.arange(h, device=rows.device), torch.arange(w, device=rows.device),
        indexing="ij",
    )
    px = px.reshape(-1).to(torch.float32) + 0.5
    py = (py.reshape(-1) + row0).to(torch.float32) + 0.5
    bw = [r[:, 3 * c] * px + r[:, 3 * c + 1] * py + r[:, 3 * c + 2] for c in range(3)]
    den = bw[0] + bw[1] + bw[2]
    den = torch.where(den == 0.0, 1.0, den)
    b = [(x / den)[:, None] for x in bw]
    attr = b[0] * r[:, 16:40] + b[1] * r[:, 40:64] + b[2] * r[:, 64:88]
    zeros = torch.zeros((h * w, GBUF_LANES - 48), dtype=torch.float32, device=rows.device)
    out = torch.cat([attr, r[:, 88:112], zeros], dim=1)
    return out.T.reshape(GBUF_LANES, h, w)


@kernels.kernel(
    "select_interp", "arctic_tpu_torch/csrc/select_interp.cu",
    "arctic_tpu/ops/raster_tiles.py:594 (_select_kernel)",
    select_interp_plain,
)
def select_interp(rows: torch.Tensor, ibuf: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """K4: (N, 128) shade rows + (H, W) i32 ibuf -> (64, H, W) G-buffer;
    ``row0``: the frame's pixel row of ibuf's first row (a slab)."""
    if not rows.is_cuda:
        return select_interp_plain(rows, ibuf, row0)
    kernels.check_cuda(rows, "rows", torch.float32, (rows.shape[0], 128))
    kernels.check_cuda(ibuf, "ibuf", torch.int32)
    h, w = ibuf.shape
    if not 0 <= row0 < (1 << 23) - h:
        raise ValueError(f"row0 = {row0}: pixel rows must stay below 2^23")
    out = torch.empty((GBUF_LANES, h, w), dtype=torch.float32, device=rows.device)
    kernels.launch("arctic_select_interp", rows, ibuf, h, w, row0, out)
    select_interp.launches += 1
    return out


# --------------------------------------------------------------------------
# Binning + raster entry points
# --------------------------------------------------------------------------


def bin_and_rasterize(
    setup: TriSetup, config: RenderConfig, tiles_x: int, tile_rows: int,
    th: int, tw: int, depth_only: bool = False,
    shade_rows: torch.Tensor | None = None, rect=None, tile_row0: int = 0,
):
    """Bin + tile-raster the window of tile rows [tile_row0, tile_row0 +
    tile_rows) (a slab of a sharded frame; 0 and every row: the whole
    frame); returns (zbuf, ibuf or None, BinnedPairs) with (tile_rows * th,
    tiles_x * tw) buffers.

    With ``shade_rows`` the kernel streams the 128-lane shade-row table
    itself (raster planes at lanes 112:124); otherwise the 16-float raster
    row table (the shadow pass). A depth-only pass is the shadow pass and
    takes its pair capacity. ``rect`` is in global tile coordinates."""
    pair_cap = config.pair_capacity(setup.capacity, "shadow" if depth_only else "cam")
    pairs = binning.bin_triangles(setup, tiles_x, tile_rows, tw, th, pair_cap, tile_row0, rect)
    if shade_rows is not None:
        rows, lane0 = shade_rows, SHADE_ROW_RASTER_LANE
    else:
        rows, lane0 = binning.raster_row_table(setup), 0
    zbuf, ibuf = raster_tiles(
        rows, lane0, pairs.sorted_slot, pairs.tile_start, tiles_x, tile_rows,
        th, tw, depth_only=depth_only, row0=tile_row0 * th,
    )
    return zbuf, ibuf, pairs


def rasterize_tiled(
    setup: TriSetup, height: int, width: int, config: RenderConfig,
    tile_h: int | None = None, tile_w: int | None = None,
    depth_only: bool = False, rect=None, tile_row0: int = 0,
    tile_rows: int | None = None, crop: bool = True,
):
    """Binned tiled rasterization of the (height, width) viewport: (zbuf,
    ibuf or None, total_pairs). A sharded caller rasters only tile rows
    [tile_row0, tile_row0 + tile_rows) and takes the padded (tile_rows * th,
    tiles_x * tw) buffers with ``crop=False``; otherwise they are cropped to
    (H, W)."""
    th = tile_h or config.tile_h
    tw = tile_w or config.tile_w
    tiles_x = -(-width // tw)
    if tile_rows is None:
        tile_rows = -(-height // th)
    zbuf, ibuf, pairs = bin_and_rasterize(
        setup, config, tiles_x, tile_rows, th, tw, depth_only, rect=rect, tile_row0=tile_row0
    )
    if crop:
        zbuf = zbuf[:height, :width]
        ibuf = None if ibuf is None else ibuf[:height, :width]
    return zbuf, ibuf, pairs.total_pairs


def raster_gbuffer(
    setup: TriSetup, shade_rows: torch.Tensor, height: int, width: int,
    config: RenderConfig, tile_row0: int = 0, tile_rows: int | None = None,
):
    """Fused visibility + shading-input resolve of the camera pass over
    tile rows [tile_row0, tile_row0 + tile_rows) (default: the whole
    frame): (ibuf (tile_rows * th, W_pad) i32, gbuf (64, tile_rows * th,
    W_pad) f32, total_pairs)."""
    th, tw = config.tile_h, config.tile_w
    tiles_x = -(-width // tw)
    if tile_rows is None:
        tile_rows = -(-height // th)
    _, ibuf, pairs = bin_and_rasterize(
        setup, config, tiles_x, tile_rows, th, tw, shade_rows=shade_rows, tile_row0=tile_row0
    )
    return ibuf, select_interp(shade_rows, ibuf, row0=tile_row0 * th), pairs.total_pairs
