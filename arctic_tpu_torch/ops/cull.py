"""Sun-frustum shadow culling — torch port of arctic_tpu/ops/cull.py.

A conservative light-space tile rect of (camera frustum) ∩ (scene AABB):
every texel a shaded pixel's PCF window can read lies inside it, so the
shadow pass skips the other tiles and the frame is unchanged. The bound must
contain the intersection; inside tests carry epsilon slack (looser only
grows the rect). The 4x4 algebra runs in full f32 (TF32 off).
"""

from __future__ import annotations

import torch

# Cube corners in "unit index" order: bit 0 -> x, bit 1 -> y, bit 2 -> z.
_CORNER_BITS = [[float((i >> a) & 1) for a in range(3)] for i in range(8)]
# The 12 cube edges as corner-index pairs (differ in exactly one bit).
_CUBE_EDGES = tuple(
    (i, i | (1 << a)) for i in range(8) for a in range(3) if not (i >> a) & 1
)


def aabb_corners(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(3,) lo / hi -> (8, 3) corner points."""
    bits = torch.tensor(_CORNER_BITS, dtype=torch.float32, device=lo.device)
    return lo + bits * (hi - lo)


def _inv4(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 4x4 inverse (cofactors of 2x2 subdeterminants)."""
    a = [[m[i, j] for j in range(4)] for i in range(4)]

    def d2(r0, r1, c0, c1):
        return a[r0][c0] * a[r1][c1] - a[r0][c1] * a[r1][c0]

    s0, s1, s2 = d2(0, 1, 0, 1), d2(0, 1, 0, 2), d2(0, 1, 0, 3)
    s3, s4, s5 = d2(0, 1, 1, 2), d2(0, 1, 1, 3), d2(0, 1, 2, 3)
    c0, c1, c2 = d2(2, 3, 0, 1), d2(2, 3, 0, 2), d2(2, 3, 0, 3)
    c3, c4, c5 = d2(2, 3, 1, 2), d2(2, 3, 1, 3), d2(2, 3, 2, 3)
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_det = 1.0 / det
    b = [
        [
            a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3,
            -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3,
            a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3,
            -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3,
        ],
        [
            -a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1,
            a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1,
            -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1,
            a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1,
        ],
        [
            a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0,
            -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0,
            a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0,
            -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0,
        ],
        [
            -a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0,
            a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0,
            -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0,
            a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0,
        ],
    ]
    return torch.stack([torch.stack(r) for r in b]) * inv_det


def _hom(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=1)


def frustum_corners_world(cam_pv: torch.Tensor) -> torch.Tensor:
    """(8, 3) world-space corners of the camera frustum (RH_ZO clip cube)."""
    dev = cam_pv.device
    ndc = aabb_corners(
        torch.tensor([-1.0, -1.0, 0.0], device=dev),
        torch.tensor([1.0, 1.0, 1.0], device=dev),
    )
    h = _hom(ndc) @ _inv4(cam_pv.float()).T  # (8, 4)
    return h[:, :3] / h[:, 3:4]


def frustum_planes(cam_pv: torch.Tensor) -> torch.Tensor:
    """(6, 4) half-space functionals: planes[i] . [p, 1] >= 0 inside."""
    m = cam_pv.float()
    return torch.stack(
        [m[3] - m[0], m[3] + m[0], m[3] - m[1], m[3] + m[1], m[2], m[3] - m[2]]
    )


def _clip_segments(pa, pb, planes, eps):
    """Clip segments pa->pb ((E, 3) each) against the intersection of
    half-spaces ((K, 4)). Returns (points (2E, 3), valid (2E,))."""
    fa = _hom(pa) @ planes.T  # (E, K)
    fb = _hom(pb) @ planes.T
    d = fb - fa
    t_at = (-eps - fa) / torch.where(d == 0, 1.0, d)
    lo = torch.where(d > 0, t_at, 0.0)
    hi = torch.where(d < 0, t_at, 1.0)
    dead = torch.any((d == 0) & (fa < -eps), dim=1)
    # Validity on the UNCLIPPED interval.
    t0u = torch.max(lo, dim=1).values
    t1u = torch.min(hi, dim=1).values
    ok = (t0u <= t1u) & (t0u <= 1.0) & (t1u >= 0.0) & ~dead
    t0 = torch.clamp(t0u, 0.0, 1.0)
    t1 = torch.clamp(t1u, 0.0, 1.0)
    p0 = pa + t0[:, None] * (pb - pa)
    p1 = pa + t1[:, None] * (pb - pa)
    return torch.cat([p0, p1]), torch.cat([ok, ok])


def intersection_points(cam_pv, aabb_lo, aabb_hi):
    """Candidate vertices of frustum ∩ AABB: ((N, 3) points, (N,) valid)."""
    fr = frustum_corners_world(cam_pv)
    bx = aabb_corners(aabb_lo, aabb_hi)
    planes = frustum_planes(cam_pv)
    scale = torch.maximum(torch.max(torch.abs(fr)), torch.max(torch.abs(bx)))
    eps = 1e-4 * (1.0 + scale)

    in_box = torch.all((fr >= aabb_lo - eps) & (fr <= aabb_hi + eps), dim=1)
    hb = _hom(bx)
    fvals = hb @ planes.T  # (8, 6)
    in_fr = torch.all(fvals >= -eps * (1.0 + torch.abs(hb[:, 3:4])), dim=1)

    eye = torch.eye(3, dtype=torch.float32, device=cam_pv.device)
    box_planes = torch.cat(
        [
            torch.cat([eye, -aabb_lo[:, None]], dim=1),  # p - lo >= 0
            torch.cat([-eye, aabb_hi[:, None]], dim=1),  # hi - p >= 0
        ]
    )
    ea = [a for a, _ in _CUBE_EDGES]
    eb = [b for _, b in _CUBE_EDGES]
    fe_pts, fe_ok = _clip_segments(fr[ea], fr[eb], box_planes, eps)
    be_pts, be_ok = _clip_segments(bx[ea], bx[eb], planes, eps)
    pts = torch.cat([fr, bx, fe_pts, be_pts])  # (64, 3)
    ok = torch.cat([in_box, in_fr, fe_ok, be_ok])
    return pts, ok


def shadow_cull_rect(
    cam_pv, sun_pv, aabb_lo, aabb_hi, shadow_size: int, tile_h: int, tile_w: int,
    margin_texels: float | None = None,
):
    """Conservative inclusive shadow-map TILE rect (tx0, ty0, tx1, ty1) of
    0-dim int64 tensors covering every texel any shaded pixel's PCF window
    can read; an empty intersection gives tx1 < tx0 (all tiles culled)."""
    if margin_texels is None:
        margin_texels = 0.0002 * shadow_size + 8.0
    pts, ok = intersection_points(cam_pv, aabb_lo, aabb_hi)
    lc = _hom(pts) @ sun_pv.float().T
    # Sun is orthographic (w == 1); the raster/PCF pixel transform.
    s = float(shadow_size)
    px = (lc[:, 0] * 0.5 + 0.5) * s
    py = (1.0 - (lc[:, 1] * 0.5 + 0.5)) * s
    big = float(4 * shadow_size + 4096)
    px_lo = torch.min(torch.where(ok, px, big)) - margin_texels
    px_hi = torch.max(torch.where(ok, px, -big)) + margin_texels
    py_lo = torch.min(torch.where(ok, py, big)) - margin_texels
    py_hi = torch.max(torch.where(ok, py, -big)) + margin_texels
    tiles_x = -(-shadow_size // tile_w)
    tiles_y = -(-shadow_size // tile_h)

    def tile_of(v, t, lo, hi):
        return torch.clamp(torch.floor(v / t).to(torch.int64), lo, hi)

    tx0 = tile_of(px_lo, tile_w, 0, tiles_x - 1)
    tx1 = tile_of(px_hi, tile_w, -1, tiles_x - 1)
    ty0 = tile_of(py_lo, tile_h, 0, tiles_y - 1)
    ty1 = tile_of(py_hi, tile_h, -1, tiles_y - 1)
    # WRAP addressing: a window crossing a map edge reads the opposite edge.
    zero = torch.zeros_like(tx0)
    ty0 = torch.where(py_hi >= s - 2.0, zero, ty0)
    ty1 = torch.where(py_lo <= 2.0, zero + (tiles_y - 1), ty1)
    tx0 = torch.where(px_hi >= s - 2.0, zero, tx0)
    tx1 = torch.where(px_lo <= 2.0, zero + (tiles_x - 1), tx1)
    any_ok = torch.any(ok)
    tx1 = torch.where(any_ok & (px_hi >= px_lo), tx1, zero - 1)
    ty1 = torch.where(any_ok & (py_hi >= py_lo), ty1, zero - 1)
    return tx0, ty0, tx1, ty1

