"""Synthetic kernel inputs, made from a seed with numpy, that hold K1 and K3
to their plain versions beyond what a frame gives them: the CPU tests, the
card's tests and chip_smoke.py share them.

K1: one 64 x 64 tile with a list far denser than any frame's (20,480 pairs
by default), and the same planes among sparse and empty tiles on a
4000 x 4000 depth-only grid. The triangles are pixel-space triangles, mostly
a few pixels wide, with every case the per-block cull must get right:
slivers with vertex angles down to 1e-6 rad, edge coefficients up to 1e6,
edges through pixel centres (e = 0 exactly), constant-depth groups nearer
than everything else (equal-z ties, decided by list order), z = +0.0 and
-0.0 planes, NaN and +-inf coefficients, and exact duplicate rows inside one
of the kernel's chunks (128 pairs) and across chunk boundaries. And a few
tiles of every kind of shape the wrapper takes (K1_TILES: 16 x 16 to 64 x
64, non-square, sides that are not powers of two; K1_NEW_TILES: 128-pixel
tiles, 1 pixel high or wide, tiles no 256-pixel sub-tile tiles exactly,
and tiles of more than 4096 pixels), whose sub-tile layout K1 derives from
the tile's sides.

K3: random planes (NaN and +-inf included) over a slot count that is not a
multiple of the kernel's 32-slot block.

K11: the same random planes split as K11 reads them (24 slot-major rows,
18 tri-major rows over cap triangles), at slot counts and capacities where
the wrap at slot cap falls inside a 32-slot block, where N > 2 * cap (a
zero tail), N < 2 * cap and N < cap, N < 32 with cap = 1, and cap a multiple
of 32; p at 0, N, 2 * cap and 2 * cap + 1.

K6: at every quad width the wrapper takes (c4 = 4, 8, ..., 48), every
texture quad (tq in [0, 128 // c4)) and env quad (eq in [0, 8)), over bf16
rows that hold NaN, +-Inf, +-0 and subnormal patterns, for a pixel count
that is not a multiple of any block size.

K8: a 60 x 60 map, whose table pitch is s + 4 = 64 (an aligned word past
x0 + 3 would leave the last row), window origins at every x0 % 4 and at
x0 = s and y0 = s, tap centres inside [1, 2) (the kernel's fast selects)
and outside it (the general ones, every branch of the 3-way selects), a
row list with repeated and out-of-order rows
whose length is odd (not a multiple of the rows a block takes side by
side), and rows_used at 0, below the list's length and equal to it. Given
the stride of the kernel's grid (``shadow.pcf_eval_stride`` on the card),
``k8_strided`` lists enough rows for several passes of the whole grid, with
rows_used just below and just above a multiple of the stride.

K14: rays against a small scene (a box, a sphere, a floor quad and two
copies of one triangle under different ids) in every case a stackless
walk must get right: axis-parallel directions and components below the
1e-20 clamp, rays through the boxes' shared edges and corners and along
their faces, origins inside node boxes and on surfaces, the coplanar
duplicates (the first in leaf order wins), per-ray t_max of 0, inf, 2
and 5 (some hits nearer, some farther), an empty scene, a camera's
primary rays as a row-major IMAGE_W x IMAGE_H image (``width`` passed:
K14's 8 x 4 warp tiles, ragged in both directions, and a ray count that is
no multiple of 32), rays with NaN and infinite components among finite
ones, and a scene with an infinite vertex (boxes that are not finite: K14
keeps its NaN tests there).

K16: light-space planes over a map with a block of one depth: points
outside the light frustum past every side and beyond z = 1, windows that
wrap at all four map edges and corners, receivers whose depth equals the
block's filtered depth exactly (no tap counts) or lies one ulp above it
(every tap counts), and NaN, +-inf, +-0 and |x| up to 1e38 in x, y and z
(floors the int32 cast saturates). ``frame`` is the lights16 cell's
1920 x 1088 planes as lanes 14-16 of a (64, H, W + 64) G-buffer, cropped
to W (a row pitch that is not W), over a 4000^2 map cropped from K1's
4032-pitch depth buffer; ``s2`` a 2 x 2 map under a 23 x 37 frame; ``odd``
a 61^2 map under a 37 x 23 frame.
"""

from __future__ import annotations

import numpy as np
import torch

from arctic_tpu_torch.ops import sampling, shadow

TILE = 64
GRID_SIZE = 4000
DENSE_PAIRS = 20480
# Tiles of the grid that carry a dense list: the corner tiles (pixel
# coordinates up to 4031.5) and one inside.
DENSE_TILES = ((0, 0), (31, 40), (62, 62))
# List positions whose rows repeat an earlier one: inside one of the
# kernel's 128-pair chunks and across chunk boundaries.
DUPLICATES = ((1, 0), (40, 3), (256, 255), (512, 511), (513, 255), (1024, 1), (1290, 700))


def edge_and_z_rows(x, y, z):
    """(n, 12) f64 raster rows of pixel-space triangles with vertices
    (x, y) (n, 3) and vertex depths z (n, 3): three edge planes, positive
    inside, then the z plane."""
    area2 = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    sign = np.where(area2 < 0, -1.0, 1.0)
    rows = np.zeros((x.shape[0], 12))
    for e in range(3):
        a, b = e, (e + 1) % 3
        rows[:, 3 * e] = sign * (y[:, a] - y[:, b])
        rows[:, 3 * e + 1] = sign * (x[:, b] - x[:, a])
        rows[:, 3 * e + 2] = sign * (x[:, a] * y[:, b] - x[:, b] * y[:, a])
    safe = np.where(area2 == 0, 1.0, area2)
    dz1, dz2 = z[:, 1] - z[:, 0], z[:, 2] - z[:, 0]
    az = (dz1 * (y[:, 2] - y[:, 0]) - dz2 * (y[:, 1] - y[:, 0])) / safe
    bz = ((x[:, 1] - x[:, 0]) * dz2 - (x[:, 2] - x[:, 0]) * dz1) / safe
    rows[:, 9], rows[:, 10] = az, bz
    rows[:, 11] = z[:, 0] - az * x[:, 0] - bz * y[:, 0]
    return rows


def raster_rows(rng: np.random.Generator, cx, cy) -> np.ndarray:
    """(n, 12) f32 raster rows of triangles around the pixel positions
    (cx, cy): 82% a few pixels wide (the equal-z, z = +-0 and NaN / inf
    groups among them), the rest up to 160 px, with the special cases of the
    module docstring mixed in."""
    n = cx.shape[0]
    kind = rng.integers(0, 100, n)
    small = (kind < 70) | ((kind >= 75) & (kind < 87))
    size = np.where(small, rng.uniform(0.5, 8.0, n), rng.uniform(8.0, 160.0, n))
    ang = rng.uniform(0.0, 2.0 * np.pi, (n, 3))
    rad = size[:, None] * rng.uniform(0.3, 1.0, (n, 3))
    x = cx[:, None] + rad * np.cos(ang)
    y = cy[:, None] + rad * np.sin(ang)
    z = rng.uniform(0.02, 0.98, (n, 3))

    sliver = (kind >= 70) & (kind < 75)  # vertex angle 1e-6 .. 1e-2 rad
    length = rng.uniform(4.0, 200.0, n)
    theta = rng.uniform(0.0, 2.0 * np.pi, n)
    lean = length / 2 * np.tan(10.0 ** rng.uniform(-6.0, -2.0, n))
    sx = np.stack([cx, cx + length * np.cos(theta),
                   cx + length / 2 * np.cos(theta) - lean * np.sin(theta)], 1)
    sy = np.stack([cy, cy + length * np.sin(theta),
                   cy + length / 2 * np.sin(theta) + lean * np.cos(theta)], 1)
    x, y = np.where(sliver[:, None], sx, x), np.where(sliver[:, None], sy, y)

    centred = (kind >= 90) & (kind < 95)  # right triangles on pixel centres
    ox, oy = np.floor(cx) + 0.5, np.floor(cy) + 0.5
    w = rng.integers(1, 12, n) * rng.choice([-1, 1], n)
    h = rng.integers(1, 12, n) * rng.choice([-1, 1], n)
    x = np.where(centred[:, None], np.stack([ox, ox + w, ox], 1), x)
    y = np.where(centred[:, None], np.stack([oy, oy, oy + h], 1), y)

    flat = sliver | ((kind >= 75) & (kind < 80))  # constant depth
    z = np.where(flat[:, None], np.where(sliver, z[:, 0], 0.01)[:, None], z)
    rows = edge_and_z_rows(x, y, z)

    huge = (kind >= 87) & (kind < 90)  # edge coefficients up to 1e6
    scale = 1e6 / np.maximum(np.abs(rows[:, [0, 1, 3, 4, 6, 7]]).max(1), 1e-30)
    rows[huge, :9] *= scale[huge, None]
    rows = rows.astype(np.float32)

    zero = (kind >= 80) & (kind < 83)  # z = +0.0 / -0.0 planes
    rows[zero, 9:11] = 0.0
    rows[zero, 11] = np.where(rng.uniform(size=n) < 0.5, np.float32(0.0), np.float32(-0.0))[zero]
    special = (kind >= 83) & (kind < 87)  # one NaN / +inf / -inf coefficient
    lanes = rng.integers(0, 12, n)
    values = np.array([np.nan, np.inf, -np.inf], np.float32)[rng.integers(0, 3, n)]
    rows[special, lanes[special]] = values[special]
    return rows


def _tile_rows(rng, tx, ty, n, th=TILE, tw=TILE):
    margin = 12.0
    cx = tx * tw + rng.uniform(-margin, tw + margin, n)
    cy = ty * th + rng.uniform(-margin, th + margin, n)
    rows = raster_rows(rng, cx, cy)
    for dst, src in DUPLICATES:
        if dst < n:
            rows[dst] = rows[src]
    return rows


def _k1_args(device, tiles, tiles_x, tiles_y, lanes, lane0, rng, th=TILE, tw=TILE):
    """K1 arguments from per-tile row lists (tile index -> (k, 12) f32):
    every pair its own slot, slots in list order, and one unused slot of
    NaNs between tiles (never listed)."""
    counts = np.zeros(tiles_x * tiles_y, np.int64)
    parts, slots, nxt = [], [], 0
    for t in sorted(tiles):
        r = tiles[t]
        counts[t] = r.shape[0]
        parts.append(np.full((1, 12), np.nan, np.float32))
        parts.append(r)
        slots.append(np.arange(nxt + 1, nxt + 1 + r.shape[0], dtype=np.int32))
        nxt += 1 + r.shape[0]
    comps = np.concatenate(parts) if parts else np.zeros((0, 12), np.float32)
    table = rng.standard_normal((comps.shape[0], lanes)).astype(np.float32)
    table[:, lane0 : lane0 + 12] = comps
    tile_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    sorted_slot = np.concatenate(slots) if slots else np.zeros(0, np.int32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return (dev(table), lane0, dev(sorted_slot), dev(tile_start), tiles_x, tiles_y, th, tw)


def k1_dense_tile(device, seed: int = 0, n_pairs: int = DENSE_PAIRS, lanes: int = 128,
                  lane0: int = 112):
    """K1's (args, kwargs) for one 64 x 64 tile with ``n_pairs`` pairs, the
    camera pass's way (ibuf written). The row table's width and the lanes of
    the raster comps are the caller's: the 128-lane shade-row table at lane
    112 by default; a lane0 that is not a multiple of 4 takes the kernel's
    scalar row load."""
    rng = np.random.default_rng(seed)
    rows = _tile_rows(rng, 0, 0, n_pairs)
    return _k1_args(device, {0: rows}, 1, 1, lanes, lane0, rng), {}


def k1_grid(device, seed: int = 0, n_pairs: int = DENSE_PAIRS):
    """K1's (args, kwargs) for a depth-only 4000 x 4000 map (63 x 63 tiles of
    64, the 16-float raster-row table): tile (0, 0) holds the planes of
    ``k1_dense_tile(seed)``, the other DENSE_TILES dense lists of their own,
    and the rest 0-40 pairs each, a third of them none."""
    rng = np.random.default_rng(seed)
    n = -(-GRID_SIZE // TILE)
    tiles = {0: _tile_rows(rng, 0, 0, n_pairs)}
    for tx, ty in DENSE_TILES[1:]:
        tiles[ty * n + tx] = _tile_rows(np.random.default_rng(seed + 1 + tx), tx, ty, n_pairs)
    sparse = np.random.default_rng(seed + 100)
    for t in range(n * n):
        if t not in tiles and sparse.uniform() >= 1 / 3:
            tiles[t] = _tile_rows(sparse, t % n, t // n, int(sparse.integers(1, 41)))
    return _k1_args(device, tiles, n, n, 16, 0, rng), {"depth_only": True}


# K1's tile shapes (tile_h, tile_w): tiles its 256-pixel sub-tiles tile
# exactly, up to 4096 pixels (16 x 16 sub-tiles of square, wide and tall
# tiles, a side of 48; 64 x 4 sub-tiles of 12 x 64; one 32 x 8 sub-tile of
# 8 x 32; 128 x 2 sub-tiles of 16 x 2 rectangles) ...
K1_TILES = ((16, 16), (32, 32), (16, 64), (48, 16), (12, 64), (8, 32), (2, 128), (64, 64))
# ... and every other kind of tile of whole 128-pixel rows: 128-pixel tiles
# (half a sub-tile), 1 pixel high and 1 pixel wide, 16 x 24 (no power-of-two
# 256-pixel rectangle tiles it), and 8,192 to 65,536 pixels.
K1_NEW_TILES = ((8, 16), (16, 8), (1, 128), (64, 128), (128, 128), (128, 1), (16, 24), (256, 256))


def k1_tiles(device, tile_h: int, tile_w: int, depth_only: bool = False, seed: int = 0):
    """K1's (args, kwargs) for a 3 x 2 grid of tile_h x tile_w tiles: one
    with 2,000 pairs, one empty, the rest 1-300 pairs; the camera pass's
    128-lane rows (ibuf written), or with ``depth_only`` the shadow pass's
    16-float rows."""
    rng = np.random.default_rng(seed)
    tiles_x, tiles_y = 3, 2
    counts = [2000, 0, *rng.integers(1, 301, tiles_x * tiles_y - 2)]
    tiles = {t: _tile_rows(rng, t % tiles_x, t // tiles_x, int(n), tile_h, tile_w)
             for t, n in enumerate(counts) if n}
    lanes, lane0 = (16, 0) if depth_only else (128, 112)
    args = _k1_args(device, tiles, tiles_x, tiles_y, lanes, lane0, rng, tile_h, tile_w)
    return args, {"depth_only": depth_only}


def _odd_planes(rng, shape) -> np.ndarray:
    """Standard normal f32 planes with 0.1% of the values NaN or +-inf."""
    planes = rng.standard_normal(shape).astype(np.float32)
    odd = rng.uniform(size=planes.shape) < 1e-3
    planes[odd] = np.array([np.nan, np.inf, -np.inf], np.float32)[rng.integers(0, 3, int(odd.sum()))]
    return planes


def k3_ragged(device, seed: int = 0, n: int | None = None):
    """K3's (pf (48, N), st (56, N), p) with N not a multiple of 32 (random
    in [1000, 100000) unless given) and p < N; 0.1% of the values NaN or
    +-inf."""
    rng = np.random.default_rng(seed)
    if n is None:
        n = int(rng.integers(1000, 100000))
        n += 0 if n % 32 else 13
    planes = _odd_planes(rng, (104, n))
    p = int(rng.integers(n // 2, n))
    t = torch.from_numpy(planes).to(device)
    return t[:48].contiguous(), t[48:].contiguous(), p


# K11: case -> (N slots, cap triangles, p clip slots).
K11_CASES = {
    "wrap": (2 * 1013, 1013, 2 * 1013),  # cap % 32 = 21: slot cap inside a block; the frame's p
    "tail": (2 * 777 + 101, 777, 2 * 777 + 1),  # N > 2 * cap: zero tail; the JAX package's p
    "short": (1300, 900, 1300),  # cap < N < 2 * cap, p = N
    "under_cap": (333, 500, 0),  # N < cap: no slot reads a second copy; p = 0
    "tiny": (19, 1, 3),  # N < 32 and cap = 1: one ragged block, slots 0 and 1 dup'd
    "aligned": (2 * 1024 + 45, 1024, 2 * 1024),  # cap % 32 = 0, a zero tail
}


def k11_inputs(device, case: str, seed: int = 0):
    """K11's (pf (24, N), tri (18, cap), st (56, N), p) for one of
    K11_CASES; 0.1% of the values NaN or +-inf."""
    n, cap, p = K11_CASES[case]
    rng = np.random.default_rng(seed)
    pf, tri, st = (torch.from_numpy(_odd_planes(rng, shape)).to(device)
                   for shape in ((24, n), (18, cap), (56, n)))
    return pf, tri, st, p


# K6: table rows, pixels, and the bf16 bit patterns planted in the rows:
# quiet and signalling NaNs, +-Inf, +-0, subnormals, the largest finite.
K6_ROWS = 48
K6_PIXELS = 3001
K6_SPECIALS = (0x7FC0, 0xFFC1, 0x7F81, 0x7F80, 0xFF80, 0x0000, 0x8000, 0x0001, 0x807F,
               0x0040, 0x7F7F, 0xFF7F)
K6_WIDTHS = sampling.C4_WIDTHS  # every quad width the wrapper takes


def k6_inputs(device, c4: int, seed: int = 0):
    """K6's (args, kwargs) at quad width c4: a (K6_ROWS, 128) bf16 table of
    values in [-4, 4) with the K6_SPECIALS planted in every row (several
    lanes each), and K6_PIXELS pixels that take every (row, tq, eq) in turn
    before random ones; fractions include 0 and 1."""
    rng = np.random.default_rng(seed + c4)
    vals = rng.uniform(-4.0, 4.0, (K6_ROWS, 128)).astype(np.float32)
    bits = (vals.view(np.uint32) >> 16).astype(np.uint16)
    for r in range(K6_ROWS):
        lanes = rng.choice(128, 3 * len(K6_SPECIALS), replace=False)
        bits[r, lanes] = np.tile(np.array(K6_SPECIALS, np.uint16), 3)
    per = 128 // c4
    n = K6_PIXELS
    k = np.arange(n)
    sweep = k < K6_ROWS * max(per, 8)  # every row with every tq and every eq
    idx = np.where(sweep, k % K6_ROWS, rng.integers(0, K6_ROWS, n)).astype(np.int32)
    tq = np.where(sweep, (k // K6_ROWS) % per, rng.integers(0, per, n)).astype(np.int32)
    eq = np.where(sweep, (k // K6_ROWS) % 8, rng.integers(0, 8, n)).astype(np.int32)
    fr = rng.uniform(0.0, 1.0, (4, n)).astype(np.float32)
    fr[:, :8] = np.array([0.0, 1.0] * 4, np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    table = dev(bits.view(np.int16)).view(torch.bfloat16)
    return (table, dev(idx), dev(tq), dev(eq), *(dev(f) for f in fr)), {"c4": c4}


# K8: the map side (pitch = s + 4), the (R, 128) planes' row count, the
# listed rows (odd: no multiple of a power-of-two rows-per-block) and the
# rows_used values held.
K8_SIDE = 60
K8_PLANE_ROWS = 40
K8_ORDER_LEN = 37
K8_ROWS_USED = (0, 20, K8_ORDER_LEN)
# The strided cases: passes of the grid the list covers, and the
# (pass, +-1) rows_used points around a multiple of the stride.
K8_PASSES = 8
K8_STRIDED = ("minus", "plus", "all")


def k8_strided(device, stride: int, case: str, seed: int = 0):
    """K8's (args, kwargs) for a grid that takes ``stride`` rows a pass: a
    list of K8_PASSES * stride + 5 rows (repeats, out of order) with
    rows_used at 3 * stride - 1 ("minus"), 6 * stride + 1 ("plus") or the
    list's length ("all"), on k8_inputs' map and planes."""
    n = K8_PASSES * stride + 5
    used = {"minus": 3 * stride - 1, "plus": 6 * stride + 1, "all": n}[case]
    return k8_inputs(device, used, seed, order_len=n)


def k8_inputs(device, rows_used: int, seed: int = 0, order_len: int = K8_ORDER_LEN):
    """K8's (args, kwargs) on a K8_SIDE^2 map: the (s + 4, 64) u16 table of
    a smooth depth map with noise (0 and 65535 included), window origins
    with every x0 % 4 and the last column and row (x0 = s, y0 = s), z near
    the window's depth so that counts spread over 0..25, lx / ly in [1, 2)
    with some within a tap offset of 1 or 2, and some outside [1, 2) (every
    3-way select branch), an ``order_len`` row list with repeats, out of
    order (K8_ORDER_LEN rows: a permutation with three rows repeated; any
    other length: uniform draws), and ``rows_used``."""
    s = K8_SIDE
    pitch = shadow.lut_pitch(s)
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(s + 4), np.arange(pitch), indexing="ij")
    depth = 0.5 + 0.3 * np.sin(yy / 7.0) * np.cos(xx / 5.0) + rng.normal(0, 0.02, yy.shape)
    lut = np.floor(np.clip(depth * 65535 + 0.5, 0, 65535)).astype(np.uint16)
    lut[0, :3] = (0, 65535, 0)
    r = K8_PLANE_ROWS
    y0 = rng.integers(0, s + 1, (r, 128))
    x0 = rng.integers(0, s + 1, (r, 128))
    x0[:, :4] = s - np.arange(4)  # x0 = s, and every x0 % 4
    y0[:, :2] = s
    x0[:, 4] = s
    lx = rng.uniform(1.0, 2.0, (r, 128))
    ly = rng.uniform(1.0, 2.0, (r, 128))
    edge = float(np.float32(2 * 0.0001 * s))  # the outer tap offset, in texels
    near = rng.uniform(0.0, edge, (2, r, 128))
    lx[:, 8:40:2] = 1.0 + near[0][:, 8:40:2]
    lx[:, 9:40:2] = 2.0 - near[0][:, 9:40:2]
    ly[:, 40:72:2] = 1.0 + near[1][:, 40:72:2]
    ly[:, 41:72:2] = 2.0 - near[1][:, 41:72:2]
    lx[:, 5], ly[:, 5] = 1.0, 1.0
    lx = np.minimum(lx, np.nextafter(np.float32(2.0), np.float32(0.0))).astype(np.float32)
    ly = np.minimum(ly, np.nextafter(np.float32(2.0), np.float32(0.0))).astype(np.float32)
    # Tap centres outside [1, 2), whose taps leave texels 0..2 (the selects'
    # other branches): every fifth row throughout, and one pixel of one warp
    # (32 pixels) in every fifth row after it.
    lx[4::5] = rng.uniform(-0.5, 3.5, lx[4::5].shape)
    ly[4::5] = rng.uniform(-0.5, 3.5, ly[4::5].shape)
    ly[0::5, 100] = 2.5
    win = lut[y0 + 1, x0 + 1].astype(np.float32) / 65535.0
    z = (win + rng.normal(0, 0.01, win.shape)).astype(np.float32)
    if order_len == K8_ORDER_LEN:
        order = rng.permutation(r)[:order_len].astype(np.int32)
        order[[3, 10, 30]] = order[[2, 0, 29]]  # repeated rows
    else:
        order = rng.integers(0, r, order_len).astype(np.int32)
    offsets = shadow.tap_offsets(s)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = (dev(lut.view(np.int16)).view(torch.uint16), dev(order),
            dev(np.array([rows_used], np.int32)), dev(y0.astype(np.int32)),
            dev(x0.astype(np.int32)), dev(z), dev(lx), dev(ly), offsets)
    return args, {}


K14_CASES = ("axis", "grazing", "inside", "coplanar", "t_max", "empty", "image",
             "nonfinite_rays", "nonfinite_scene")
# The "image" case: 851 pixels, no multiple of a warp or of its 8 x 4 tile.
IMAGE_W, IMAGE_H = 37, 23


def k14_scene() -> np.ndarray:
    """(T, 3, 3) f32 world triangles: a unit box at the origin, a sphere at
    (3, 0, 0), a floor quad at y = -1 and one triangle twice (ids T-2 and
    T-1, the same corners)."""
    from arctic_tpu_torch.io.procedural import box_mesh, plane_mesh, uv_sphere

    parts = []
    for mesh, offset in ((box_mesh(2.0, 2.0, 2.0), (0.0, 0.0, 0.0)),
                         (uv_sphere(1.0, 8, 12), (3.0, 0.0, 0.0)),
                         (plane_mesh(12.0), (0.0, -1.0, 0.0))):
        parts.append(mesh.positions[mesh.indices] + np.asarray(offset, np.float32))
    dup = np.asarray([[[-2.0, 2.0, -3.0], [2.0, 2.0, -3.0], [0.0, 4.0, -3.0]]], np.float32)
    return np.concatenate(parts + [dup, dup]).astype(np.float32)


def _unit(d):
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def k14_rays(case: str, seed: int = 0, n: int = 1000):
    """(tris, origin (R, 3), direction (R, 3), t_max float or (R,)) of one
    K14 case, as numpy f32."""
    rng = np.random.default_rng(seed)
    tris = k14_scene()
    t_max = 3.0e38
    if case == "axis":
        o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        d = np.zeros((n, 3), np.float32)
        d[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
        tiny = rng.uniform(0, 1, (n, 3)) < 0.3
        d = np.where(tiny & (d == 0), rng.choice([1e-25, -1e-25, 1e-21, 0.0], (n, 3)), d)
        d = d.astype(np.float32)
    elif case == "grazing":
        # Aim at box corners, edge midpoints and face centres, and along
        # the faces' planes (origins on the planes y = +-1, x = +-1).
        pts = np.stack(np.meshgrid([-1.0, 0.0, 1.0], [-1.0, 0.0, 1.0], [-1.0, 0.0, 1.0]),
                       -1).reshape(-1, 3)
        target = pts[rng.integers(0, len(pts), n)].astype(np.float32)
        o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        d = _unit(target - o)
        k = n // 4
        o[:k, 1] = rng.choice([-1.0, 1.0], k)
        d[:k, 1] = 0.0
        o[k : 2 * k, 0] = rng.choice([-1.0, 1.0], k)
        d[k : 2 * k, 0] = 0.0
    elif case == "inside":
        o = rng.uniform(-0.99, 0.99, (n, 3)).astype(np.float32)  # inside the box
        o[: n // 3] += np.asarray([3.0, 0.0, 0.0], np.float32)  # inside the sphere's box
        o[n // 3 : n // 2, 1] = -1.0  # on the floor
        d = _unit(rng.normal(0, 1, (n, 3)))
    elif case == "coplanar":
        o = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(2.1, 3.5, n),
                      rng.uniform(-8, -4, n)], 1).astype(np.float32)
        o[n // 2 :, 2] = rng.uniform(-1.5, 6, n - n // 2)
        d = np.zeros((n, 3), np.float32)
        d[:, 2] = np.where(o[:, 2] < -3.0, 1.0, -1.0)
    elif case == "t_max":
        o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        d = _unit(rng.uniform(-1, 1, (n, 3)) * 0.3 - o * 0.2)
        t_max = rng.choice(np.asarray([0.0, np.inf, 2.0, 5.0], np.float32), n).astype(np.float32)
    elif case == "empty":
        tris = np.zeros((0, 3, 3), np.float32)
        o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        d = _unit(rng.normal(0, 1, (n, 3)))
    elif case in ("nonfinite_rays", "nonfinite_scene"):
        o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        d = _unit(rng.normal(0, 1, (n, 3)))
        if case == "nonfinite_scene":  # a triangle with a vertex at +inf in y
            far = np.asarray([[[-1.0, 0.5, -2.0], [1.0, 0.5, -2.0], [0.0, np.inf, -2.0]]],
                             np.float32)
            tris = np.concatenate([tris, far])
        else:
            k = n // 8
            o[:k, 0] = np.nan
            d[k : 2 * k, 1] = np.inf
            d[2 * k : 3 * k, 2] = -np.inf
            d[3 * k : 4 * k, 0] = np.nan
            o[4 * k : 5 * k, 2] = -np.inf
    elif case == "image":  # a pinhole at (1, 1.5, 8) looking down -z, rows top to bottom
        x = ((np.arange(IMAGE_W) + 0.5) / IMAGE_W * 2.0 - 1.0) * 0.6 * IMAGE_W / IMAGE_H
        y = ((np.arange(IMAGE_H) + 0.5) / IMAGE_H * 2.0 - 1.0) * -0.6 - 0.15
        px, py = np.meshgrid(x, y)
        d = _unit(np.stack([px, py, -np.ones_like(px)], -1).reshape(-1, 3))
        o = np.broadcast_to(np.asarray([1.0, 1.5, 8.0], np.float32), d.shape).copy()
    else:
        raise KeyError(case)
    return tris, o, d, t_max


def k14_inputs(device, case: str, any_hit: bool, seed: int = 0):
    """One K14 call's (args, kwargs) for ``case`` on ``device``: (bvh,
    origin, direction, t_max, any_hit), and the image's ``width`` for the
    "image" case."""
    import torch

    from arctic_tpu_torch.ops.rt import build_bvh

    tris, o, d, t_max = k14_rays(case, seed)
    if not np.isscalar(t_max):
        t_max = torch.from_numpy(t_max).to(device)
    return ((build_bvh(tris, device=device), torch.from_numpy(o).to(device),
             torch.from_numpy(d).to(device), t_max, any_hit),
            {"width": IMAGE_W} if case == "image" else {})



K15_CASES = ("lights_0", "lights_4", "lights_16", "spot", "spot_off", "visibility", "strided",
             "nonfinite")
# Pixels of a K15 case: neither side a multiple of a warp, and no multiple
# of K15's 256-thread block.
K15_H, K15_W = 37, 53


def k15_inputs(device, case: str, seed: int = 0):
    """One K15 call's (args, kwargs) for ``case`` on ``device``: (wp, n,
    base_color, metalness, roughness, lit, params, spotlights, visibility)
    over K15_H x K15_W pixels. Surface points around the lights, random unit
    normals (about half of them facing away from any given light), base
    colours in [0, 1], metalness and roughness with an eighth each at 0 and
    at 1, lit 0 or 1; one pixel at the eye (wo = 0 / 0) and one at light 0
    (the 1e-12 distance clamp). Cases: 0, 4 and 16 lights; 4 lights with
    cones, read (``spot``) or not (``spot_off``); a visibility stack;
    ``strided``: base colour, metalness and roughness as channels of one
    interleaved (H, W, 8) tap (the frame's layout) and wp as rows of a
    (14, H, W) stack; ``nonfinite``: NaN, +-inf and subnormal values among
    the planes."""
    from arctic_tpu_torch.core.scene import PointLights, default_scene_params, make_camera

    rng = np.random.default_rng(seed)
    hw = (K15_H, K15_W)
    n_lights = {"lights_0": 0, "lights_16": 16}.get(case, 4)
    cones = case in ("spot", "spot_off", "visibility")
    rows = [(tuple(rng.uniform(-4, 4, 3)), tuple(rng.uniform(0, 60, 3)),
             (tuple(rng.normal(0, 1, 3)), 10.0 + 3 * i, 25.0 + 3 * i) if cones and i % 4 else None)
            for i in range(n_lights)]
    params = default_scene_params(aspect=K15_W / K15_H)
    params.camera = make_camera([0.5, 3.0, 6.0], [-20.0, -95.0], K15_W / K15_H)
    params.point_lights = PointLights.from_list(rows, spots=cones)

    def f32(a):
        return np.asarray(a, np.float32)

    wp = f32(rng.uniform(-4, 4, (3, *hw)))
    wp[:, 0, 0] = params.camera.eye.numpy()
    if n_lights:
        wp[:, 0, 1] = params.point_lights.position[0].numpy()
    n = rng.normal(0, 1, (3, *hw))
    n = f32(n / np.linalg.norm(n, axis=0))
    base = f32(rng.uniform(0, 1, (3, *hw)))
    mr = f32(rng.uniform(0, 1, (2, *hw)))
    pick = rng.integers(0, 8, (2, *hw))
    mr[pick == 0] = 0.0
    mr[pick == 1] = 1.0
    lit = f32(rng.integers(0, 2, (1, *hw)))
    if case == "nonfinite":
        for plane in (wp, n, base, mr):
            flat = plane.reshape(-1)
            at = rng.choice(flat.size, 12, replace=False)
            flat[at] = f32([np.nan, np.inf, -np.inf, 1e-40, -1e-40, 0.0, -0.0, 3e38, -3e38,
                            np.nan, 1e-45, 1e30])
    dev = [torch.from_numpy(a).to(device) for a in (wp, n, base, mr, lit)]
    wp, n, base, mr, lit = dev
    if case == "strided":
        tap = torch.zeros((*hw, 8), dtype=torch.float32, device=device)
        tap[..., 0:3] = base.movedim(0, -1)
        tap[..., 5:7] = mr.movedim(0, -1)
        tap = tap.movedim(-1, 0)  # (8, H, W), pixel stride 8
        base, mr = tap[0:3], tap[5:7]
        stack = torch.zeros((14, *hw), dtype=torch.float32, device=device)
        stack[2:5] = wp
        wp = stack[2:5]
    visibility = None
    if case == "visibility":
        visibility = torch.from_numpy(f32(rng.integers(0, 2, (n_lights, *hw)))).to(device)
    return (wp, n, base, mr[1][None], mr[0][None], lit, params, case in ("spot", "visibility"),
            visibility), {}


K16_CASES = {"frame": (4000, 1088, 1920), "s2": (2, 23, 37), "odd": (61, 37, 23)}
# x, y and z values a cast or a compare must take as torch does.
K16_SPECIALS = (np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.9999999, -0.9999999, 1e-40,
                1.1e6, -1.1e6, 2.0**31, -(2.0**31), 3e9, -3e9, 1e38, -1e38)


def k16_inputs(device, case: str, seed: int = 0):
    """One K16 call's (args, kwargs) for ``case`` on ``device``:
    (shadow_map, x, y, z) as K16_CASES gives (S, H, W); see the module
    docstring for what the planes hold."""
    s, h, w = K16_CASES[case]
    rng = np.random.default_rng(seed)
    smap = rng.uniform(0.2, 1.0, (s, s)).astype(np.float32)
    smap[rng.uniform(size=(s, s)) < 0.3] = 1.0  # cleared texels
    b0, b1 = s // 2 - max(1, s // 16), s // 2 + max(1, s // 16)
    depth = np.float32(0.5)
    smap[b0:b1, b0:b1] = depth
    x = rng.uniform(-1.05, 1.05, (h, w)).astype(np.float32)
    y = rng.uniform(-1.05, 1.05, (h, w)).astype(np.float32)
    z = rng.uniform(0.0, 1.02, (h, w)).astype(np.float32)
    flat = [a.reshape(-1) for a in (x, y, z)]
    at = rng.choice(h * w, h * w, replace=False)
    k = 0

    def put(xv, yv, zv):
        nonlocal k
        for a, v in zip(flat, (xv, yv, zv)):
            a[at[k]] = v
        k += 1

    # Windows at every edge and corner: u and v at and next to 0 and 1.
    edges = (-1.0, -0.9999, -0.9995, 0.9995, 0.9999, 1.0)
    for xv in edges:
        for yv in edges:
            put(xv, yv, rng.uniform(0.2, 1.0))
    # Receivers on the block's depth (centre texel coordinates of the block,
    # jittered by less than a quarter texel): equal, and one ulp above.
    centre = (b0 + b1) / 2 / s
    for j in range(8):
        u, v = centre + rng.uniform(-0.25, 0.25, 2) / s
        for zv in (depth, np.nextafter(depth, np.float32(2))):
            put(2 * u - 1, 1 - 2 * v, zv)
    for v in K16_SPECIALS:
        put(v, rng.uniform(-1, 1), rng.uniform(0, 1))
        put(rng.uniform(-1, 1), v, rng.uniform(0, 1))
        put(rng.uniform(-1, 1), rng.uniform(-1, 1), v)
        put(v, v, v)
    smap_t = torch.from_numpy(smap).to(device)
    planes = [torch.from_numpy(a).to(device) for a in (x, y, z)]
    if case == "frame":  # K1's tile-padded depth buffer; G-buffer lanes 14-16
        pad = -(-s // TILE) * TILE
        buf = torch.ones((pad, pad), dtype=torch.float32, device=device)
        buf[:s, :s] = smap_t
        smap_t = buf[:s, :s]
        gbuf = torch.zeros((64, h, w + 64), dtype=torch.float32, device=device)
        for lane, plane in zip((14, 15, 16), planes):
            gbuf[lane, :, :w] = plane
        planes = [gbuf[lane, :, :w] for lane in (14, 15, 16)]
    return (smap_t, *planes), {}
