"""Near clip, triangle setup and the brute-force raster oracle — torch port
of arctic_tpu/ops/raster.py.

D3D conventions reproduced: viewport transform with y flip and 1/16-px
snapping, pixel centres at +0.5, FrontCounterClockwise back-face culling,
the top-left fill rule, depth LESS in [0, 1], front-face culling for the
depth-only shadow pass. Every per-slot quantity is a dense (P,) tensor in
nested tuples, and every expression keeps the JAX package's operation order
so the planes agree bit for bit (no operation here fuses a multiply-add).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# Vertex snap grid (1/16 pixel) keeps edge coefficients exactly representable.
SNAP = 16.0
# Exclusion bias for non-top-left edges (approximate top-left rule in f32).
EDGE_EPS = 1.0 / 4096.0
# Edge "C" coefficient for dead slots: fails every inside test.
DEAD_C = -1.0e30

# For each 3-bit inside code (bit i = vertex i has clip z >= 0), a cyclic
# rotation bringing the pattern to (in, out, out) or (in, in, out).
_CLIP_ROT = (0, 0, 1, 0, 2, 2, 1, 0)
_CLIP_NOUT = (0, 1, 1, 2, 1, 2, 2, 1)


@dataclass
class ClippedTris:
    """Near-plane clipping output: 2 static slots per input triangle,
    [primary outputs; secondary outputs]. ``cb[c][k]`` is the weight of
    clipped corner c over original vertex k."""

    cx: tuple  # 3 x (P,) clip x per corner
    cy: tuple
    cz: tuple
    cw: tuple
    cb: tuple  # 3 x 3 x (P,)
    valid: torch.Tensor  # (P,) bool


@dataclass
class TriSetup:
    """Per-slot screen-space triangle data consumed by raster + shading."""

    sx: tuple  # 3 x (P,) snapped screen x per corner
    sy: tuple  # 3 x (P,) snapped screen y (y down)
    w: tuple  # 3 x (P,) clip w per corner
    zplane: tuple  # (Az, Bz, Cz): z(p) = Az x + Bz y + Cz
    edges: tuple  # 3 x (A, B, C) oriented edge coeffs, fill-rule biased
    inv_area2: torch.Tensor  # (P,) 1 / |2 * signed area|
    cb: tuple  # 3 x 3 x (P,)
    valid: torch.Tensor  # (P,) bool
    bbox: tuple  # (x0, y0, x1, y1) of (P,), clamped to the viewport

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


def near_clip_corners(corners, tri_valid: torch.Tensor) -> ClippedTris:
    """Clip tri-major corner components ``corners[c] = (x, y, z, w)`` of
    (T,) tensors against the near plane (clip z = 0); each triangle owns two
    output slots (a clipped triangle fans into at most two)."""
    dev = tri_valid.device
    inside = [corners[c][2] >= 0.0 for c in range(3)]
    code = (
        inside[0].to(torch.int64)
        + 2 * inside[1].to(torch.int64)
        + 4 * inside[2].to(torch.int64)
    )
    rot = torch.tensor(_CLIP_ROT, dtype=torch.int64, device=dev)[code]
    nout = torch.where(
        tri_valid, torch.tensor(_CLIP_NOUT, dtype=torch.int64, device=dev)[code], 0
    )

    # Rotate vertices so inside ones come first (cyclic: winding preserved).
    def pick(cidx):
        i = (cidx + rot) % 3
        m0 = i == 0
        m1 = i == 1
        vert = tuple(
            torch.where(m0, corners[0][j], torch.where(m1, corners[1][j], corners[2][j]))
            for j in range(4)
        )
        bary = tuple((i == k).to(torch.float32) for k in range(3))
        return vert, bary

    (a, ba), (b, bb), (c, bc) = pick(0), pick(1), pick(2)
    za, zb, zc = a[2], b[2], c[2]

    def lerp(p, q, t):
        return tuple(pp + t * (qq - pp) for pp, qq in zip(p, q))

    def safe(n, d):
        return n / torch.where(torch.abs(d) < 1e-30, 1e-30, d)

    # One in (a in; b, c out): triangle (a, ab, ac).
    t_ab = safe(za, za - zb)
    t_ac = safe(za, za - zc)
    one_tri = (a, lerp(a, b, t_ab), lerp(a, c, t_ac))
    one_bary = (ba, lerp(ba, bb, t_ab), lerp(ba, bc, t_ac))

    # Two in (a, b in; c out): fan (a, b, bc) + (a, bc, ac).
    t_bc = safe(zb, zb - zc)
    t_ca = safe(za, za - zc)
    p_bc, bb_bc = lerp(b, c, t_bc), lerp(bb, bc, t_bc)
    p_ac, bb_ac = lerp(a, c, t_ca), lerp(ba, bc, t_ca)
    two0 = ((a, b, p_bc), (ba, bb, bb_bc))
    two1 = ((a, p_bc, p_ac), (ba, bb_bc, bb_ac))

    is_all_in = code == 7
    is_one_in = (code == 1) | (code == 2) | (code == 4)
    orig = ((a, b, c), (ba, bb, bc))

    def sel(orig_v, one_v, two_v):
        return torch.where(is_all_in, orig_v, torch.where(is_one_in, one_v, two_v))

    coords = []
    for j in range(4):  # x, y, z, w
        coords.append(
            tuple(
                torch.cat([sel(orig[0][cc][j], one_tri[cc][j], two0[0][cc][j]), two1[0][cc][j]])
                for cc in range(3)
            )
        )
    cb_out = tuple(
        tuple(
            torch.cat([sel(orig[1][cc][k], one_bary[cc][k], two0[1][cc][k]), two1[1][cc][k]])
            for k in range(3)
        )
        for cc in range(3)
    )
    return ClippedTris(
        cx=coords[0], cy=coords[1], cz=coords[2], cw=coords[3], cb=cb_out,
        valid=torch.cat([nout >= 1, nout >= 2]),
    )


def _canonical_edge(ax, ay, bx, by):
    """Edge coefficients with canonical endpoint order (watertightness):
    (A, B, C, flip), flip = -1 where (a, b) was swapped."""
    swap = (ay > by) | ((ay == by) & (ax > bx))
    x0 = torch.where(swap, bx, ax)
    y0 = torch.where(swap, by, ay)
    x1 = torch.where(swap, ax, bx)
    y1 = torch.where(swap, ay, by)
    dx = x1 - x0
    dy = y1 - y0
    A = -dy
    B = dx
    C = dy * x0 - dx * y0
    flip = torch.where(swap, -1.0, 1.0)
    return A, B, C, flip


def setup_screen_triangles(
    tris: ClippedTris, width: int, height: int, cull: str = "back"
) -> TriSetup:
    """Project clipped triangles to the viewport and build raster planes.

    cull: "back" keeps visually-CCW front faces (forward pass), "front" the
    opposite set (shadow pass), "none" both."""
    w = tris.cw
    sx = tuple(
        torch.round((tris.cx[c] / w[c] + 1.0) * (0.5 * width) * SNAP) / SNAP
        for c in range(3)
    )
    sy = tuple(
        torch.round((1.0 - tris.cy[c] / w[c]) * (0.5 * height) * SNAP) / SNAP
        for c in range(3)
    )
    z = tuple(tris.cz[c] / w[c] for c in range(3))

    x0, x1, x2 = sx
    y0, y1, y2 = sy
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)

    # Front faces (visually CCW, y-down coords) have area2 < 0.
    if cull == "back":
        keep = area2 < 0
    elif cull == "front":
        keep = area2 > 0
    elif cull == "none":
        keep = area2 != 0
    else:
        raise ValueError(f"bad cull mode {cull!r}")
    s = torch.where(area2 < 0, -1.0, 1.0)  # orient edges inside-positive

    # Edge i is opposite vertex i: from vertex i+1 to vertex i+2.
    corners = [(x0, y0), (x1, y1), (x2, y2)]
    edges = []
    for i in range(3):
        ax, ay = corners[(i + 1) % 3]
        bx, by = corners[(i + 2) % 3]
        A, B, C, flip = _canonical_edge(ax, ay, bx, by)
        o = s * flip
        edges.append((o * A, o * B, o * C))

    inv_area2 = 1.0 / torch.where(area2 == 0, 1.0, torch.abs(area2))

    # Depth plane: z(p) = sum_i e_i(p) z_i / |area2| (Python sum: 0 + ...).
    Az = sum(edges[i][0] * z[i] for i in range(3)) * inv_area2
    Bz = sum(edges[i][1] * z[i] for i in range(3)) * inv_area2
    Cz = sum(edges[i][2] * z[i] for i in range(3)) * inv_area2

    valid = tris.valid & keep & torch.isfinite(area2)

    # Fill rule: boundary only on top (A==0, B>0) and left (A>0) edges.
    biased = []
    for A, B, C in edges:
        top_left = ((A == 0) & (B > 0)) | (A > 0)
        Cb = C + torch.where(top_left, 0.0, -EDGE_EPS)
        biased.append((A, B, torch.where(valid, Cb, DEAD_C)))

    bx0 = torch.clamp(torch.minimum(torch.minimum(x0, x1), x2), 0.0, float(width))
    bx1 = torch.clamp(torch.maximum(torch.maximum(x0, x1), x2), 0.0, float(width))
    by0 = torch.clamp(torch.minimum(torch.minimum(y0, y1), y2), 0.0, float(height))
    by1 = torch.clamp(torch.maximum(torch.maximum(y0, y1), y2), 0.0, float(height))
    valid = valid & (bx1 > bx0) & (by1 > by0)

    return TriSetup(
        sx=sx, sy=sy, w=w, zplane=(Az, Bz, Cz), edges=tuple(biased),
        inv_area2=inv_area2, cb=tris.cb, valid=valid, bbox=(bx0, by0, bx1, by1),
    )


def pixel_centers(height: int, width: int, device=None, y_offset: int = 0):
    """(px, py) pixel-centre grids, each (H, W) f32; ``y_offset`` shifts the
    rows (a slab of a sharded frame whose first row is the frame's row
    y_offset)."""
    ys = (torch.arange(height, device=device) + y_offset).to(torch.float32) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px, py


def rasterize_bruteforce(setup: TriSetup, height: int, width: int, chunk: int = 256,
                         y_offset: int = 0):
    """Depth-test every triangle against every pixel (the raster oracle) of
    an (H, W) window whose first row is the frame's row ``y_offset``.

    Depth LESS with draw-order ties: a pixel keeps the first slot that
    reaches its minimum accepted depth. Returns (zbuf f32 (H, W) cleared to
    1.0, ibuf i32 (H, W) cleared to -1)."""
    dev = setup.valid.device
    px, py = pixel_centers(height, width, dev, y_offset)
    px, py = px.reshape(-1, 1), py.reshape(-1, 1)
    zbuf = torch.ones(height * width, dtype=torch.float32, device=dev)
    ibuf = torch.full((height * width,), -1, dtype=torch.int32, device=dev)
    for k0 in range(0, setup.capacity, chunk):
        sl = slice(k0, k0 + chunk)
        inside = None
        for A, B, C in setup.edges:
            e = A[sl] * px + B[sl] * py + C[sl]
            inside = (e >= 0.0) if inside is None else inside & (e >= 0.0)
        az, bz, cz = (c[sl] for c in setup.zplane)
        zv = az * px + bz * py + cz
        zv = torch.where(inside & (zv >= 0.0) & (zv <= 1.0), zv, torch.inf)
        zmin, k = torch.min(zv, dim=1)  # first index of the minimum
        upd = zmin < zbuf
        zbuf = torch.where(upd, zmin, zbuf)
        ibuf = torch.where(upd, (k0 + k).to(torch.int32), ibuf)
    return zbuf.reshape(height, width), ibuf.reshape(height, width)
