"""Tiled rasterizer, shade-row build and G-buffer resolve — torch port of
arctic_tpu/ops/raster_tiles.py around three CUDA kernels:

- K1 ``raster_tiles``    (csrc/raster_tiles.cu) for _raster_kernel, with
  _pack16_kernel + _phase_resolve_kernel folded into its row load;
- K3 ``pack_shade_rows`` (csrc/pack_shade_rows.cu) for _pack_shade_rows_kernel;
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


def raster_tiles_plain(
    rows, lane0, sorted_slot, tile_start, tiles_x, tiles_y, tile_h, tile_w,
    depth_only=False,
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
    loc = torch.arange(tile_h * tile_w, device=dev)
    lx, ly = loc % tile_w, loc // tile_w
    tile_start = tile_start.long()

    def evaluate(k0, k1):
        ks = torch.arange(k0, k1, device=dev)
        t = torch.searchsorted(tile_start, ks, right=True) - 1
        r = rows[sorted_slot[k0:k1].long(), lane0 : lane0 + 12]
        gx = (t % tiles_x)[:, None] * tile_w + lx[None]
        gy = (t // tiles_x)[:, None] * tile_h + ly[None]
        px = gx.to(torch.float32) + 0.5
        py = gy.to(torch.float32) + 0.5

        def plane(j):
            return r[:, j : j + 1] * px + r[:, j + 1 : j + 2] * py + r[:, j + 2 : j + 3]

        z = plane(9)
        ok = (plane(0) >= 0.0) & (plane(3) >= 0.0) & (plane(6) >= 0.0)
        ok = ok & (z >= 0.0) & (z < 1.0)
        return ks, torch.where(ok, z, torch.inf), gy * wp + gx

    for k0 in range(0, n_pairs, PLAIN_CHUNK):
        _, zacc, pix = evaluate(k0, min(k0 + PLAIN_CHUNK, n_pairs))
        zbuf.scatter_reduce_(0, pix.reshape(-1), zacc.reshape(-1), "amin")
    ibuf = None
    if not depth_only:
        for k0 in range(0, n_pairs, PLAIN_CHUNK):
            ks, zacc, pix = evaluate(k0, min(k0 + PLAIN_CHUNK, n_pairs))
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


@kernels.kernel(
    "raster_tiles", "arctic_tpu_torch/csrc/raster_tiles.cu",
    "arctic_tpu/ops/raster_tiles.py:367 (_raster_kernel; + :94 _pack16_kernel, "
    ":67 _phase_resolve_kernel)",
    raster_tiles_plain,
)
def raster_tiles(
    rows, lane0, sorted_slot, tile_start, tiles_x, tiles_y, tile_h, tile_w,
    depth_only=False,
):
    """K1: per-tile depth raster over the binned pair lists.

    rows: (P, stride) f32 row table whose lanes [lane0, lane0 + 12) hold a
    slot's 3 edge planes and z plane; sorted_slot / tile_start: the binning.
    Returns (zbuf (H_pad, W_pad) f32 cleared to 1.0, ibuf (H_pad, W_pad) i32
    cleared to -1, or None when ``depth_only``)."""
    if not rows.is_cuda:
        return raster_tiles_plain(
            rows, lane0, sorted_slot, tile_start, tiles_x, tiles_y, tile_h,
            tile_w, depth_only,
        )
    num_tiles = tiles_x * tiles_y
    kernels.check_cuda(rows, "rows", torch.float32)
    if rows.dim() != 2 or lane0 + 12 > rows.shape[1]:
        raise ValueError(f"rows: need 12 lanes from {lane0}, got {tuple(rows.shape)}")
    kernels.check_cuda(sorted_slot, "sorted_slot", torch.int32)
    kernels.check_cuda(tile_start, "tile_start", torch.int32, (num_tiles + 1,))
    npix = tile_h * tile_w
    if npix % 256 or npix > 4096:
        raise ValueError(f"tile {tile_h}x{tile_w}: pixels must be a multiple of 256, <= 4096")
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    zbuf = torch.empty((hp, wp), dtype=torch.float32, device=rows.device)
    ibuf = None if depth_only else torch.empty((hp, wp), dtype=torch.int32, device=rows.device)
    kernels.launch(
        "arctic_raster_tiles", rows, rows.shape[1], lane0, sorted_slot, tile_start,
        num_tiles, tiles_x, tile_h, tile_w, wp, zbuf, ibuf,
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


# --------------------------------------------------------------------------
# K4: G-buffer resolve
# --------------------------------------------------------------------------


def select_interp_plain(rows: torch.Tensor, ibuf: torch.Tensor) -> torch.Tensor:
    """Plain torch K4: read each covered pixel's shade row by slot id,
    perspective-correct barycentrics, interpolate / copy into 64 lanes."""
    h, w = ibuf.shape
    cov = (ibuf >= 0).reshape(-1, 1)
    r = torch.where(cov, rows[torch.clamp(ibuf, min=0).reshape(-1).long()], 0.0)
    py, px = torch.meshgrid(
        torch.arange(h, device=rows.device), torch.arange(w, device=rows.device),
        indexing="ij",
    )
    px = px.reshape(-1).to(torch.float32) + 0.5
    py = py.reshape(-1).to(torch.float32) + 0.5
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
def select_interp(rows: torch.Tensor, ibuf: torch.Tensor) -> torch.Tensor:
    """K4: (N, 128) shade rows + (H, W) i32 ibuf -> (64, H, W) G-buffer."""
    if not rows.is_cuda:
        return select_interp_plain(rows, ibuf)
    kernels.check_cuda(rows, "rows", torch.float32, (rows.shape[0], 128))
    kernels.check_cuda(ibuf, "ibuf", torch.int32)
    h, w = ibuf.shape
    out = torch.empty((GBUF_LANES, h, w), dtype=torch.float32, device=rows.device)
    kernels.launch("arctic_select_interp", rows, ibuf, h, w, out)
    select_interp.launches += 1
    return out


# --------------------------------------------------------------------------
# Binning + raster entry points
# --------------------------------------------------------------------------


def bin_and_rasterize(
    setup: TriSetup, config: RenderConfig, tiles_x: int, tile_rows: int,
    th: int, tw: int, depth_only: bool = False,
    shade_rows: torch.Tensor | None = None, rect=None,
):
    """Bin + tile-raster; returns (zbuf, ibuf or None, BinnedPairs) with
    (tile_rows * th, tiles_x * tw) buffers.

    With ``shade_rows`` the kernel streams the 128-lane shade-row table
    itself (raster planes at lanes 112:124); otherwise the 16-float raster
    row table (the shadow pass)."""
    pair_cap = config.pair_capacity(setup.capacity)
    pairs = binning.bin_triangles(setup, tiles_x, tile_rows, tw, th, pair_cap, rect=rect)
    if shade_rows is not None:
        rows, lane0 = shade_rows, SHADE_ROW_RASTER_LANE
    else:
        rows, lane0 = binning.raster_row_table(setup), 0
    zbuf, ibuf = raster_tiles(
        rows, lane0, pairs.sorted_slot, pairs.tile_start, tiles_x, tile_rows,
        th, tw, depth_only=depth_only,
    )
    return zbuf, ibuf, pairs


def rasterize_tiled(
    setup: TriSetup, height: int, width: int, config: RenderConfig,
    tile_h: int | None = None, tile_w: int | None = None,
    depth_only: bool = False, rect=None,
):
    """Binned tiled rasterization: (zbuf (H, W), ibuf (H, W) or None,
    total_pairs)."""
    th = tile_h or config.tile_h
    tw = tile_w or config.tile_w
    tiles_x = -(-width // tw)
    tile_rows = -(-height // th)
    zbuf, ibuf, pairs = bin_and_rasterize(
        setup, config, tiles_x, tile_rows, th, tw, depth_only, rect=rect
    )
    zbuf = zbuf[:height, :width]
    ibuf = None if ibuf is None else ibuf[:height, :width]
    return zbuf, ibuf, pairs.total_pairs


def raster_gbuffer(
    setup: TriSetup, shade_rows: torch.Tensor, height: int, width: int,
    config: RenderConfig,
):
    """Fused visibility + shading-input resolve of the camera pass:
    (ibuf (H_pad, W_pad) i32, gbuf (64, H_pad, W_pad) f32, total_pairs)."""
    th, tw = config.tile_h, config.tile_w
    tiles_x = -(-width // tw)
    tile_rows = -(-height // th)
    _, ibuf, pairs = bin_and_rasterize(
        setup, config, tiles_x, tile_rows, th, tw, shade_rows=shade_rows
    )
    return ibuf, select_interp(shade_rows, ibuf), pairs.total_pairs
