"""Shadow-map PCF — torch port of the exact f32 "runs" path of
arctic_tpu/ops/shadow.py:pcf_shadow_proj (shadow.py:808-879, 1012-1074),
an exact reproduction of calculate_shadow (forward.hlsl:68-96).

Quirks kept: bias 0; 25 taps at fixed +-2 * 0.0001 UV offsets, each a
bilinear fetch of the depth map through the linear-WRAP sampler (depth is
filtered before the compare); points outside the light frustum are lit.

All 25 taps read one 4x4 texel window per pixel. The window is fetched
straight from the map with wrapped indices — the JAX package's 2-texel
wrap pad followed by a run-table gather, as index arithmetic — and every
tap is evaluated with exact 3-way selects, so the values equal the JAX
runs path. This port uses that f32 path on every device; the JAX package's
u16-quantised window LUT (a TPU gather-cost workaround) is not ported yet.
"""

from __future__ import annotations

import torch

PCF_UV_STEP = 0.0001  # forward.hlsl:88


def pcf_shadow_proj(shadow_map: torch.Tensor, x, y, z) -> torch.Tensor:
    """Fraction of occluded PCF taps in [0, 1] at light-space NDC planes
    (x, y, z) (the sun is orthographic: no divide). shadow_map: (S, S) f32
    depth cleared to 1.0."""
    s = shadow_map.shape[0]
    assert shadow_map.shape == (s, s)
    u = x * 0.5 + 0.5
    v = 1.0 - (y * 0.5 + 0.5)
    outside = (z > 1.0) | (u < 0.0) | (v < 0.0) | (u > 1.0) | (v > 1.0)

    # Texel-space centre tap (D3D: t = uv * size - 0.5).
    tx = u * s - 0.5
    ty = v * s - 0.5
    step = PCF_UV_STEP * s  # texels between adjacent taps

    # 4x4 window containing all 25 bilinear taps, in the coordinates of the
    # map padded by 2 wrapped texels per side.
    wx = torch.floor(tx).to(torch.int32) - 1
    wy = torch.floor(ty).to(torch.int32) - 1
    start_y = torch.clamp(wy + 2, 0, s).long()
    start_x = torch.clamp(wx + 2, 0, s).long()
    flat = shadow_map.reshape(-1)
    rows = []
    for r in range(4):
        ry = ((start_y + (r - 2)) % s) * s
        rows.append(tuple(flat[ry + (start_x + (c - 2)) % s] for c in range(4)))

    lx = tx - wx.to(torch.float32)  # local coords in the window, in [1, 2)
    ly = ty - wy.to(torch.float32)

    def sel3(i, a, b, c):
        return tuple(
            torch.where(i == 0, pa, torch.where(i == 1, pb, pc))
            for pa, pb, pc in zip(a, b, c)
        )

    def col(row4, i, off):
        return torch.where(
            i == 0, row4[0 + off], torch.where(i == 1, row4[1 + off], row4[2 + off])
        )

    shadow = torch.zeros_like(tx)
    for j in range(-2, 3):  # y offset
        sy = ly + j * step
        iy = torch.floor(sy).to(torch.int32)
        fy = sy - iy
        row0 = sel3(iy, rows[0], rows[1], rows[2])
        row1 = sel3(iy, rows[1], rows[2], rows[3])
        for i in range(-2, 3):  # x offset
            sx = lx + i * step
            ix = torch.floor(sx).to(torch.int32)
            fx = sx - ix
            c00 = col(row0, ix, 0)
            c10 = col(row0, ix, 1)
            c01 = col(row1, ix, 0)
            c11 = col(row1, ix, 1)
            top = c00 + (c10 - c00) * fx
            bot = c01 + (c11 - c01) * fx
            closest = top + (bot - top) * fy
            shadow = shadow + torch.where(z > closest, 1.0, 0.0)
    shadow = shadow / 25.0
    return torch.where(outside, 0.0, shadow)
