"""Shadow-map PCF — torch port of arctic_tpu/ops/shadow.py:pcf_shadow_proj,
an exact reproduction of calculate_shadow (forward.hlsl:68-96), around five
CUDA kernels:

- K12 ``window_lut``  (csrc/window_lut.cu) for _lut_kernel: the wrap-padded
  f32 shadow map;
- K7 ``window_lut_q`` (csrc/window_lut_q.cu) for _lut_kernel_q / _lut_step_q:
  the wrap-padded, u16-quantised shadow map;
- K8 ``pcf_eval``     (csrc/pcf_eval.cu) for _pcf_eval_kernel: the 4x4
  window of each pixel of the listed rows, dequantised, and its 25 taps;
- K13 ``pcf_resolve`` (csrc/pcf_resolve.cu) for _pcf_resolve_kernel: the
  16 dequantised window texels of each pixel (K8 superseded it; no frame
  calls it, as in the JAX package).
- K16 ``pcf_runs``    (csrc/pcf_runs.cu) for no TPU kernel: the whole exact
  f32 runs path (the JAX package's jnp arithmetic, shadow.py:1012-1074,
  which XLA fuses) in one launch.

Quirks kept: bias 0; 25 taps at fixed +-2 * 0.0001 UV offsets, each a
bilinear fetch of the depth map through the linear-WRAP sampler (depth is
filtered before the compare); points outside the light frustum are lit.
All 25 taps read one 4x4 texel window per pixel, and every tap is evaluated
with exact 3-way selects (``_tap_count``, shared by every route).

Routes, as in the JAX package (``pcf_shadow_proj(use_lut=, quant=)``):

- the exact f32 **runs** path (the frame's default): the window is fetched
  straight from the map with wrapped indices;
- the **f32 window table** (``use_lut=True, quant=False``): the map
  wrap-padded by 2 texels (K12), each window read at its padded origin;
  bit-identical to the runs path;
- the **quantised** table (the frame's route when ``row_cap`` is set, and
  only then): the padded map quantised to u16
  (``floor(clip(x * 65535 + 0.5, 0, 65535))``, dequantised as ``q * DQ``).
  A min/max pyramid of the same quantised map classifies each 128-pixel
  row: rows provably fully lit or fully shadowed emit exact 0 / 1, and
  only penumbra rows, compacted, run K8. The JAX package documents the
  classification as bit-identical to evaluating every row, for every
  consumed pixel (its uncompacted route; a test holds the two equal).

The JAX package stored its tables as 8x8 (f32) or 16x8-texel (u16) blocks,
two per 128-lane row, built by one-hot matmuls, because a TPU gather costs
by table size and row count (shadow.py:36-43). On the card a pixel reads its
16 texels from the padded map directly, so each table here is that map:
(S + 4) rows of ``window_pitch(S)`` f32 or ``lut_pitch(S)`` u16. The values
a window reads are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from arctic_tpu_torch.utils import kernels

PCF_UV_STEP = 0.0001  # forward.hlsl:88

# The f32 the JAX package dequantises with: jnp.float32(1.0 / 65535.0).
DQ = float(np.float32(1.0 / 65535.0))

# Pixels per classified / compacted row, and lane groups classified per row.
ROW = 128
CLASS_SUB = 4


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def lut_pitch(s: int) -> int:
    """Row pitch, in u16 texels, of the quantised window table of an (s, s)
    map: the s + 4 padded columns rounded up to 64 (128-byte rows)."""
    return _round_up(s + 4, 64)


def window_pitch(s: int) -> int:
    """Row pitch, in f32 texels, of the f32 window table of an (s, s) map:
    the s + 4 padded columns rounded up to 32 (128-byte rows)."""
    return _round_up(s + 4, 32)


def _wrap_index(n: int, s: int, device) -> torch.Tensor:
    """Source index of each of the n padded coordinates (2-texel wrap pad)."""
    return (torch.arange(n, device=device) - 2) % s


def _wrap_padded(src: torch.Tensor, s: int) -> torch.Tensor:
    """The (s, s) top left of ``src``, wrap-padded by 2 texels a side."""
    idx = _wrap_index(s + 4, s, src.device)
    return src[:s, :s][idx][:, idx]


def _quantise(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(x * 65535.0 + 0.5, 0.0, 65535.0)).to(torch.int32)


def _dequantise(v: torch.Tensor) -> torch.Tensor:
    """Texels of the u16 table, read as int16, to f32 (q * DQ)."""
    return (v.to(torch.int32) & 0xFFFF).to(torch.float32) * DQ


def _read_window(table: torch.Tensor, start_y, start_x, decode=None):
    """The 4x4 window of each pixel in a padded window table (K12's f32
    table, or K7's u16 table seen as int16 with ``decode=_dequantise``):
    rows start_y .. start_y + 3, columns start_x .. start_x + 3, as 4
    tuples of 4 texel planes of start_y's shape."""
    pitch = table.shape[1]
    flat = table.reshape(-1)
    base = start_y.long() * pitch + start_x.long()

    def texel(r, c):
        v = flat[base + (r * pitch + c)]
        return v if decode is None else decode(v)

    return [tuple(texel(r, c) for c in range(4)) for r in range(4)]


# --------------------------------------------------------------------------
# K12: the f32 window table
# --------------------------------------------------------------------------


def window_lut_plain(src: torch.Tensor, s: int) -> torch.Tensor:
    """Plain torch K12: the (s, s) map at the top left of ``src`` (any 2-D
    f32 tensor, e.g. K1's padded depth buffer), wrap-padded by 2 texels, as
    an (s + 4, window_pitch(s)) f32 table; columns past s + 4 hold 0."""
    out = torch.zeros((s + 4, window_pitch(s)), dtype=torch.float32, device=src.device)
    out[:, : s + 4] = _wrap_padded(src, s)
    return out


@kernels.kernel(
    "window_lut", "arctic_tpu_torch/csrc/window_lut.cu",
    "arctic_tpu/ops/shadow.py:74 (_lut_kernel)",
    window_lut_plain,
)
def window_lut(src: torch.Tensor, s: int) -> torch.Tensor:
    """K12: the wrap-padded f32 map of the (s, s) top left of ``src``, which
    may be strided (its row pitch is passed to the kernel)."""
    if not src.is_cuda:
        return window_lut_plain(src, s)
    if src.dim() != 2 or src.dtype != torch.float32 or src.stride(1) != 1:
        raise ValueError("src: expected a 2-D f32 CUDA tensor with unit column stride")
    if src.shape[0] < s or src.shape[1] < s or s < 2:
        raise ValueError(f"src {tuple(src.shape)} does not hold an ({s}, {s}) map")
    pitch = window_pitch(s)
    out = torch.empty((s + 4, pitch), dtype=torch.float32, device=src.device)
    kernels.launch("arctic_window_lut", src, src.stride(0), s, pitch, out)
    window_lut.launches += 1
    return out


# --------------------------------------------------------------------------
# K7: the quantised window table
# --------------------------------------------------------------------------


def window_lut_q_plain(src: torch.Tensor, s: int, y_range: torch.Tensor) -> torch.Tensor:
    """Plain torch K7: the (s, s) map at the top left of ``src`` (any 2-D
    f32 tensor, e.g. K1's padded depth buffer), wrap-padded by 2 texels and
    quantised, as an (s + 4, lut_pitch(s)) u16 table. Rows outside
    [y_range[0], y_range[1] + 3] and columns past s + 4 hold 0."""
    dev = src.device
    sp = s + 4
    q = _quantise(_wrap_padded(src, s))
    rows = torch.arange(sp, device=dev)[:, None]
    keep = (rows >= y_range[0]) & (rows <= y_range[1] + 3)
    out = torch.zeros((sp, lut_pitch(s)), dtype=torch.int32, device=dev)
    out[:, :sp] = torch.where(keep, q, 0)
    return out.to(torch.uint16)


@kernels.kernel(
    "window_lut_q", "arctic_tpu_torch/csrc/window_lut_q.cu",
    "arctic_tpu/ops/shadow.py:249 (_lut_kernel_q; + :298 _lut_step_q)",
    window_lut_q_plain,
)
def window_lut_q(src: torch.Tensor, s: int, y_range: torch.Tensor) -> torch.Tensor:
    """K7: the wrap-padded u16 map of the (s, s) top left of ``src``.

    ``src`` may be strided (its row pitch is passed to the kernel); y_range:
    (2,) i32 device tensor, the inclusive band of window start_y whose rows
    are written (the rest are 0)."""
    if not src.is_cuda:
        return window_lut_q_plain(src, s, y_range)
    if src.dim() != 2 or src.dtype != torch.float32 or src.stride(1) != 1:
        raise ValueError("src: expected a 2-D f32 CUDA tensor with unit column stride")
    if src.shape[0] < s or src.shape[1] < s or s < 2:
        raise ValueError(f"src {tuple(src.shape)} does not hold an ({s}, {s}) map")
    kernels.check_cuda(y_range, "y_range", torch.int32, (2,))
    pitch = lut_pitch(s)
    out = torch.empty((s + 4, pitch), dtype=torch.uint16, device=src.device)
    kernels.launch("arctic_window_lut_q", src, src.stride(0), s, y_range, pitch, out)
    window_lut_q.launches += 1
    return out


def build_window_lut_q(shadow_map: torch.Tensor, y_range: torch.Tensor | None = None):
    """The quantised window table of an (S, S) map (a strided view, such as
    K1's row-major depth buffer cropped to S, is read in place).

    ``y_range`` ((2,) i32 device tensor, inclusive): the band of window
    start_y that consumed pixels can have (pipeline: the sun-frustum cull
    rect's y band); rows no such window reads are written as 0. None writes
    every row."""
    s = shadow_map.shape[0]
    if y_range is None:
        y_range = torch.tensor([0, s], dtype=torch.int32, device=shadow_map.device)
    return window_lut_q(shadow_map, s, y_range)


# --------------------------------------------------------------------------
# Penumbra classification: min/max pyramid (plain torch, no kernel in JAX)
# --------------------------------------------------------------------------


def pyramid_meta(s: int):
    """Static (level, offset, width) triples of build_shadow_pyramid(s)."""
    n = -(-(s + 4) // 4)
    meta = []
    off = 0
    level = 2
    while True:
        meta.append((level, off, n))
        off += n * n
        if n == 1:
            return tuple(meta)
        n = -(-n // 2)
        level += 1


def build_shadow_pyramid(shadow_map: torch.Tensor):
    """Dilated min/max pyramid of the wrap-padded map, u16-quantised and
    packed ``min | max << 16`` into one flat i32 table (shadow.py:477-532).

    Level l = 2..top has cells of 2^l padded texels; each stored cell holds
    the min/max over its 2x2 cell neighbourhood (edge-clamped), so a texel
    bbox spanning <= 2 cells per axis at level l is bounded by the cell
    (y0 >> l, x0 >> l). Quantisation is the window table's and monotone, so
    the bounds hold for the quantised texels every tap filters. A max of
    32768 or more makes the i32 negative: decode with ``(v >> 16) & 0xFFFF``.
    Returns (table (N,) i32, meta)."""
    s = shadow_map.shape[0]
    padded = _wrap_padded(shadow_map, s)

    def pool(a, k, op, fill):
        m = _round_up(a.shape[0], k)
        if m != a.shape[0]:
            a = torch.nn.functional.pad(a, (0, m - a.shape[0], 0, m - a.shape[0]), value=fill)
        return op(a.reshape(m // k, k, m // k, k), dim=(1, 3))

    def dilate(a, op2):
        a = op2(a, torch.cat([a[1:], a[-1:]], dim=0))
        return op2(a, torch.cat([a[:, 1:], a[:, -1:]], dim=1))

    mins = [pool(padded, 4, torch.amin, 2.0)]
    maxs = [pool(padded, 4, torch.amax, -1.0)]
    while mins[-1].shape[0] > 1:
        mins.append(pool(mins[-1], 2, torch.amin, 2.0))
        maxs.append(pool(maxs[-1], 2, torch.amax, -1.0))

    meta = pyramid_meta(s)
    parts = []
    for (_, _, n), mn, mx in zip(meta, mins, maxs):
        assert mn.shape[0] == n
        packed = _quantise(dilate(mn, torch.minimum)) | (
            _quantise(dilate(mx, torch.maximum)) << 16
        )
        parts.append(packed.reshape(-1))
    return torch.cat(parts), meta


def classify_pcf_rows(table, meta, start_y, start_x, z, care, sub=CLASS_SUB, corners=2):
    """Conservative PCF verdict per 128/sub-pixel lane group
    (shadow.py:535-607).

    start_y / start_x: (R, 128) padded window origins; z: (R, 128) receiver
    depths; care: (R, 128) consumed pixels. Returns (lit, shd), (R, sub)
    bools: a lit group has every care pixel's 25 taps pass (raw 0), a shd
    group every tap fail (raw 25), both provable from the pyramid with a
    half-quantum margin. Groups without care pixels classify lit."""
    r = start_y.shape[0]
    n = r * sub
    g = ROW // sub

    def rs(a):
        return a.reshape(n, g)

    care, sy, sx, z = rs(care), rs(start_y), rs(start_x), rs(z)
    big = 1 << 30
    y0 = torch.amin(torch.where(care, sy, big), dim=1)
    y1 = torch.amax(torch.where(care, sy, -1), dim=1) + 3
    x0 = torch.amin(torch.where(care, sx, big), dim=1)
    x1 = torch.amax(torch.where(care, sx, -1), dim=1) + 3
    z_hi = torch.amax(torch.where(care, z, -torch.inf), dim=1)
    z_lo = torch.amin(torch.where(care, z, torch.inf), dim=1)

    # Finest level whose corners x corners dilated cells cover the bbox.
    span = 2 * corners - 1
    idxs = [None] * (corners * corners)
    have = None
    for level, off, width in meta:
        fits = ((y1 >> level) - (y0 >> level) <= span) & ((x1 >> level) - (x0 >> level) <= span)
        cy0, cx0 = y0 >> level, x0 >> level
        for i in range(corners):
            for j in range(corners):
                cy = torch.clamp(cy0 + 2 * i, max=width - 1)
                cx = torch.clamp(cx0 + 2 * j, max=width - 1)
                idx_l = off + cy * width + cx
                k = i * corners + j
                idxs[k] = idx_l if have is None else torch.where(have, idxs[k], idx_l)
        have = fits if have is None else have | fits

    qmin = torch.full((n,), 65536.0, dtype=torch.float32, device=z.device)
    qmax = torch.full((n,), -1.0, dtype=torch.float32, device=z.device)
    for idx in idxs:
        v = table[torch.clamp(idx, 0, table.shape[0] - 1).long()]
        qmin = torch.minimum(qmin, (v & 0xFFFF).to(torch.float32))
        qmax = torch.maximum(qmax, ((v >> 16) & 0xFFFF).to(torch.float32))
    lit = z_hi < (qmin - 0.5) * DQ
    shd = z_lo > (qmax + 0.5) * DQ
    return lit.reshape(r, sub), (shd & ~lit).reshape(r, sub)


def effective_row_cap(pn: int, row_cap: int) -> int:
    """The penumbra row capacity used for ``pn`` pixels: the JAX package's
    (its Pallas block multiple of 32 rows, clamped to the row count)."""
    rows = (pn + (-pn % 4096)) // ROW
    return min(rows, -(-row_cap // 32) * 32)


# --------------------------------------------------------------------------
# The 25-tap loop (both paths) and K8
# --------------------------------------------------------------------------


def tap_offsets(s: int) -> list[float]:
    """The five tap offsets in texels, each the f32 of the double j * step
    (JAX adds the Python float ``j * step`` to an f32 plane)."""
    step = PCF_UV_STEP * s
    return [float(np.float32(j * step)) for j in range(-2, 3)]


def _tap_count(rows, lx, ly, z, offsets):
    """Number of the 25 bilinear taps whose filtered depth is below z.

    rows: 4 tuples of 4 texel planes (the window); lx, ly: local tap centre
    in the window, in [1, 2); offsets: tap_offsets(). Window rows / columns
    are taken with exact 3-way selects (a tap reads texels 0..2 while
    |offset| <= 0.8 texels), in the JAX package's expression order."""

    def sel3(i, a, b, c):
        return tuple(
            torch.where(i == 0, pa, torch.where(i == 1, pb, pc)) for pa, pb, pc in zip(a, b, c)
        )

    def col(row4, i, off):
        return torch.where(i == 0, row4[0 + off], torch.where(i == 1, row4[1 + off], row4[2 + off]))

    count = torch.zeros_like(lx)
    for oy in offsets:  # y offset
        sy = ly + oy
        iy = torch.floor(sy).to(torch.int32)
        fy = sy - iy
        row0 = sel3(iy, rows[0], rows[1], rows[2])
        row1 = sel3(iy, rows[1], rows[2], rows[3])
        for ox in offsets:  # x offset
            sx = lx + ox
            ix = torch.floor(sx).to(torch.int32)
            fx = sx - ix
            c00 = col(row0, ix, 0)
            c10 = col(row0, ix, 1)
            c01 = col(row1, ix, 0)
            c11 = col(row1, ix, 1)
            top = c00 + (c10 - c00) * fx
            bot = c01 + (c11 - c01) * fx
            closest = top + (bot - top) * fy
            count = count + torch.where(z > closest, 1.0, 0.0)
    return count


def pcf_eval_plain(lut, order, rows_used, start_y, start_x, z, lx, ly, offsets):
    """Plain torch K8: for each listed row ``order[i]`` of the (R, 128)
    pixel planes, the 25-tap count of every pixel over its 4x4 window of
    the quantised table. Rows i >= rows_used[0] are 0. Returns
    (len(order), 128) f32."""
    dev = lut.device
    pix = order.long()[:, None] * ROW + torch.arange(ROW, device=dev)
    sy, sx, zz, lxx, lyy = (a.reshape(-1)[pix] for a in (start_y, start_x, z, lx, ly))
    rows = _read_window(lut.view(torch.int16), sy, sx, _dequantise)
    count = _tap_count(rows, lxx, lyy, zz, offsets)
    live = torch.arange(order.shape[0], device=dev)[:, None] < rows_used
    return torch.where(live, count, 0.0)


@kernels.kernel(
    "pcf_eval", "arctic_tpu_torch/csrc/pcf_eval.cu",
    "arctic_tpu/ops/shadow.py:660 (_pcf_eval_kernel)",
    pcf_eval_plain,
)
def pcf_eval(lut, order, rows_used, start_y, start_x, z, lx, ly, offsets):
    """K8: the raw 25-tap count of every pixel of the listed rows.

    lut: (S + 4, pitch) u16 window table (on the card: 8-byte aligned, the
    pitch a multiple of 4, as ``lut_pitch`` makes it); order: (n,) i32 rows
    of the (R, 128) planes start_y / start_x (i32, padded window origin in
    [0, S]), z, lx, ly (f32); rows_used: (1,) i32 device tensor, rows of
    ``order`` past it are written as 0; offsets: tap_offsets(S). Returns
    (n, 128) f32 counts (the /25 happens outside, as in the JAX package)."""
    if not lut.is_cuda:
        return pcf_eval_plain(lut, order, rows_used, start_y, start_x, z, lx, ly, offsets)
    kernels.check_cuda(lut, "lut", torch.uint16)
    if lut.dim() != 2 or lut.shape[1] < lut.shape[0]:
        raise ValueError(f"lut: expected an (S + 4, pitch) table, got {tuple(lut.shape)}")
    if lut.shape[1] % 4:  # the kernel reads a window row as 8-byte words
        raise ValueError(f"lut: expected a pitch that is a multiple of 4, got {lut.shape[1]}")
    if lut.data_ptr() % 8:
        raise ValueError("lut: expected an 8-byte aligned table")
    if lut.numel() >= 2**31 or start_y.numel() >= 2**31:
        raise ValueError("pcf_eval: the kernel indexes the table and the planes with 32-bit ints")
    n = order.shape[0]
    kernels.check_cuda(order, "order", torch.int32, (n,))
    kernels.check_cuda(rows_used, "rows_used", torch.int32, (1,))
    r = start_y.shape[0]
    for name, t, dt in (("start_y", start_y, torch.int32), ("start_x", start_x, torch.int32),
                        ("z", z, torch.float32), ("lx", lx, torch.float32),
                        ("ly", ly, torch.float32)):
        kernels.check_cuda(t, name, dt, (r, ROW))
    if len(offsets) != 5:
        raise ValueError("offsets: expected the 5 tap offsets")
    out = torch.empty((n, ROW), dtype=torch.float32, device=lut.device)
    kernels.launch(
        "arctic_pcf_eval", lut, lut.shape[1], order, rows_used, n, start_y, start_x,
        z, lx, ly, *offsets, out,
    )
    pcf_eval.launches += 1
    return out


def pcf_eval_stride(device) -> int:
    """How far apart in ``order`` the rows one thread of K8 takes lie on
    ``device``'s card (the rows its full grid takes in one pass; a shorter
    list gets fewer blocks): tests and chip_smoke put rows_used around its
    multiples."""
    return kernels.query_int("arctic_pcf_eval_stride", device)


# --------------------------------------------------------------------------
# K13: the window resolve (no frame calls it: K8 superseded it, as in JAX)
# --------------------------------------------------------------------------


def pcf_resolve_plain(lut: torch.Tensor, start_y: torch.Tensor, start_x: torch.Tensor):
    """Plain torch K13: the 16 dequantised texels of each pixel's 4x4 window
    of the quantised table, as (16, P) f32 planes (plane 4r + c = window
    row r, column c)."""
    rows = _read_window(lut.view(torch.int16), start_y, start_x, _dequantise)
    return torch.stack([texel for row in rows for texel in row])


@kernels.kernel(
    "pcf_resolve", "arctic_tpu_torch/csrc/pcf_resolve.cu",
    "arctic_tpu/ops/shadow.py:617 (_pcf_resolve_kernel)",
    pcf_resolve_plain,
)
def pcf_resolve(lut: torch.Tensor, start_y: torch.Tensor, start_x: torch.Tensor):
    """K13: lut (S + 4, pitch) u16 window table (K7); start_y / start_x (P,)
    i32 padded window origins, which the caller keeps in [0, S] (as
    pcf_shadow_proj's clamp does; they are not checked, which would cost a
    sync, and one outside reads past the table). Returns (16, P) f32
    planes."""
    if not lut.is_cuda:
        return pcf_resolve_plain(lut, start_y, start_x)
    kernels.check_cuda(lut, "lut", torch.uint16)
    if lut.dim() != 2 or lut.shape[1] < lut.shape[0]:
        raise ValueError(f"lut: expected an (S + 4, pitch) table, got {tuple(lut.shape)}")
    n = start_y.shape[0] if start_y.dim() == 1 else -1
    kernels.check_cuda(start_y, "start_y", torch.int32, (n,))
    kernels.check_cuda(start_x, "start_x", torch.int32, (n,))
    out = torch.empty((16, n), dtype=torch.float32, device=lut.device)
    kernels.launch("arctic_pcf_resolve", lut, lut.shape[1], start_y, start_x, n, out)
    pcf_resolve.launches += 1
    return out


# --------------------------------------------------------------------------
# K16: the runs path
# --------------------------------------------------------------------------


def _window_coords(x, y, z, s: int):
    """The light-space NDC planes (x, y, z) on an (s, s) map: the mask of
    points outside the light frustum, the 4x4 window around each centre tap
    as its origin in the map padded by 2 wrapped texels a side (start_y,
    start_x, i32 in [0, s]) and the tap centre in the window (lx, ly, in
    [1, 2] for points inside)."""
    u = x * 0.5 + 0.5
    v = 1.0 - (y * 0.5 + 0.5)
    outside = (z > 1.0) | (u < 0.0) | (v < 0.0) | (u > 1.0) | (v > 1.0)

    # Texel-space centre tap (D3D: t = uv * size - 0.5).
    tx = u * s - 0.5
    ty = v * s - 0.5

    # 4x4 window containing all 25 bilinear taps, in the coordinates of the
    # map padded by 2 wrapped texels per side.
    wx = torch.floor(tx).to(torch.int32) - 1
    wy = torch.floor(ty).to(torch.int32) - 1
    start_y = torch.clamp(wy + 2, 0, s)
    start_x = torch.clamp(wx + 2, 0, s)
    lx = tx - wx.to(torch.float32)  # local coords in the window, in [1, 2)
    ly = ty - wy.to(torch.float32)
    return outside, start_y, start_x, lx, ly


def pcf_runs_plain(shadow_map: torch.Tensor, x, y, z) -> torch.Tensor:
    """Plain torch K16: pcf_shadow_proj's exact f32 runs path, the window
    straight from the (S, S) map, wrapped by index. Returns the occluded
    share of the 25 taps, 0 outside the light frustum."""
    s = shadow_map.shape[0]
    outside, start_y, start_x, lx, ly = _window_coords(x, y, z, s)
    flat = shadow_map.reshape(-1)
    sy, sx = start_y.long(), start_x.long()
    rows = []
    for r in range(4):
        ry = ((sy + (r - 2)) % s) * s
        rows.append(tuple(flat[ry + (sx + (c - 2)) % s] for c in range(4)))
    shadow = _tap_count(rows, lx, ly, z, tap_offsets(s)) / 25.0
    return torch.where(outside, 0.0, shadow)


def _check_plane(t: torch.Tensor, name: str, shape) -> None:
    """Raise unless ``t`` is a 2-D f32 CUDA plane of ``shape`` with unit
    column stride whose rows a 32-bit int offsets."""
    if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name}: expected a 2-D f32 CUDA tensor with unit column stride, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}, strides {t.stride()}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if (t.shape[0] - 1) * t.stride(0) + t.shape[1] >= 2**31:
        raise ValueError(f"{name}: the kernel offsets its rows with 32-bit ints")


@kernels.kernel(
    "pcf_runs", "arctic_tpu_torch/csrc/pcf_runs.cu",
    "none (the exact f32 runs path, arctic_tpu/ops/shadow.py:1012-1074, jnp arithmetic that "
    "XLA fuses under jax.jit)",
    pcf_runs_plain,
)
def pcf_runs(shadow_map: torch.Tensor, x, y, z) -> torch.Tensor:
    """K16: ``pcf_runs_plain`` in one launch for CUDA tensors (the plain
    version for CPU ones). shadow_map: (S, S) f32, S >= 2; x, y, z: (H, W)
    f32 planes. Each may be a strided view with unit column stride (a
    G-buffer lane, K1's tile-padded depth buffer): the kernel reads it in
    place. Returns the (H, W) f32 shadow fraction."""
    if not shadow_map.is_cuda:
        return pcf_runs_plain(shadow_map, x, y, z)
    s = shadow_map.shape[0]
    if s < 2:
        raise ValueError(f"shadow_map: expected S >= 2, got {tuple(shadow_map.shape)}")
    _check_plane(shadow_map, "shadow_map", (s, s))
    if x.dim() != 2:
        raise ValueError(f"x: expected an (H, W) plane, got {tuple(x.shape)}")
    h, w = x.shape
    if h * w >= 2**31:
        raise ValueError("pcf_runs: the kernel indexes the pixels with 32-bit ints")
    for name, t in (("x", x), ("y", y), ("z", z)):
        _check_plane(t, name, (h, w))
    out = torch.empty((h, w), dtype=torch.float32, device=shadow_map.device)
    kernels.launch("arctic_pcf_runs", shadow_map, shadow_map.stride(0), s, x, y, z,
                   x.stride(0), y.stride(0), z.stride(0), h, w, *tap_offsets(s), out)
    pcf_runs.launches += 1
    return out


# --------------------------------------------------------------------------
# pcf_shadow_proj
# --------------------------------------------------------------------------


def pcf_shadow_proj(
    shadow_map: torch.Tensor, x, y, z, care=None, row_cap: int | None = None,
    with_rows: bool = False, lut=None, pyramid=None, lut_y_range=None,
    use_lut: bool | None = None, quant: bool = True,
):
    """Fraction of occluded PCF taps in [0, 1] at light-space NDC planes
    (x, y, z) (the sun is orthographic: no divide). shadow_map: (S, S) f32
    depth cleared to 1.0 (a strided view is read in place by the kernels).

    Routes, by the JAX package's arguments: ``use_lut`` (default: ``row_cap
    is not None``) reads each window from a padded window table, ``quant``
    makes that table the u16 one (K7). Without a table the window comes
    straight from the map (the runs path, K16); with the f32 table (K12) its 16
    texels are read with no wrap arithmetic, giving the runs path's values
    bit for bit. The u16 table runs exactly when ``row_cap`` is set (either
    without the other raises): x, y, z (and ``care``) are viewed as rows of
    128 pixels in memory order, classified, and the penumbra rows compacted
    to effective_row_cap rows; ``care`` marks consumed pixels (None = all),
    others get unspecified finite values. ``with_rows`` also returns the
    penumbra row count as a 0-dim i32 device tensor (0 on the f32 routes;
    more than the cap means some rows got another row's values: check_stats
    raises). ``lut`` / ``pyramid`` inject a SunCache's products
    for this exact map (only with ``row_cap``); ``lut_y_range`` is the
    u16 table's start_y band."""
    if use_lut is None:
        use_lut = row_cap is not None
    if (row_cap is not None) != (use_lut and quant):
        raise ValueError("the quantised window table (use_lut=True, quant=True) runs exactly when row_cap is set")
    if row_cap is None and (lut is not None or pyramid is not None):
        raise ValueError("an injected window table or pyramid needs row_cap")
    s = shadow_map.shape[0]
    assert shadow_map.shape == (s, s)
    if row_cap is None and not use_lut:
        shadow = pcf_runs(shadow_map, x, y, z)
        zero = torch.zeros((), dtype=torch.int32, device=shadow.device)
        return (shadow, zero) if with_rows else shadow
    outside, start_y, start_x, lx, ly = _window_coords(x, y, z, s)
    offsets = tap_offsets(s)

    if row_cap is None:
        # f32 window table (K12): the window at its padded origin.
        rows = _read_window(window_lut(shadow_map, s), start_y, start_x)
        shadow = _tap_count(rows, lx, ly, z, offsets) / 25.0
        shadow = torch.where(outside, 0.0, shadow)
        zero = torch.zeros((), dtype=torch.int32, device=shadow.device)
        return (shadow, zero) if with_rows else shadow

    if lut is None:
        lut = build_window_lut_q(shadow_map, lut_y_range)
    shape = x.shape
    pn = x.numel()
    pad = -pn % 4096  # the JAX package's block multiple: same row count
    n_rows = (pn + pad) // ROW

    def f2(a, fill=0):
        flat = a.reshape(-1)
        if pad:
            flat = torch.cat([flat, flat.new_full((pad,), fill)])
        return flat.reshape(n_rows, ROW)

    planes = [f2(a) for a in (start_y, start_x, z, lx, ly)]
    rowcap = effective_row_cap(pn, row_cap)
    if pyramid is None:
        pyramid, meta = build_shadow_pyramid(shadow_map)
    else:
        meta = pyramid_meta(s)
    care2 = ~outside if care is None else (care & ~outside)
    lit, shd = classify_pcf_rows(pyramid, meta, planes[0], planes[1], planes[2], f2(care2, False))
    pen = ~torch.all(lit | shd, dim=1)  # a row compacts whole
    pen_i = pen.to(torch.int32)
    rows_used = pen_i.sum(dtype=torch.int32).reshape(1)
    # Penumbra rows first, in their order (stable).
    order = torch.argsort(1 - pen_i, stable=True)[:rowcap].to(torch.int32)
    raw_c = pcf_eval(lut, order, rows_used, *planes, offsets)
    # Each penumbra row's rank in the compacted stream; ranks past the cap
    # mean overflow (wrong values, made loud by check_stats).
    rank = torch.clamp(torch.cumsum(pen_i, 0) - 1, 0, rowcap - 1)
    class_lanes = torch.where(lit, 0.0, 25.0).repeat_interleave(ROW // lit.shape[1], dim=1)
    raw = torch.where(pen[:, None], raw_c[rank], class_lanes)
    shadow = raw.reshape(-1)[:pn].reshape(shape) / 25.0
    shadow = torch.where(outside, 0.0, shadow)
    return (shadow, rows_used[0]) if with_rows else shadow
