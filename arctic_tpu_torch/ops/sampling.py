"""Texture sampling with D3D linear-wrap semantics — torch port of the
parts of arctic_tpu/ops/sampling.py the fused frame uses, around one CUDA
kernel: K6 ``tap_resolve`` (csrc/tap_resolve.cu) for _tap_resolve_kernel.

Bilinear filtering is ``t = uv * size - 0.5``, texel pair floor(t) and
floor(t) + 1, fractional lerp, with WRAP applied per texel in region-local
texel space. Quad tables hold the four parity-shifted copies of every 2x2
texel block, so one bilinear footprint is one row. The scene build's
host-side pieces of the JAX module (sRGB decode, pack_tex_rows) are numpy
in io/build.py.
"""

from __future__ import annotations

import torch

from arctic_tpu_torch.utils import kernels


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
    fractions. Returns (16, n) f32: [0, c4/4) texture channels,
    [c4/4, c4/4 + 4) env RGBA, zero after."""
    if not table.is_cuda:
        return tap_resolve_plain(table, idx, tq, eq, tfx, tfy, efx, efy, c4)
    n = idx.shape[0]
    kernels.check_cuda(table, "table", torch.bfloat16, (table.shape[0], 128))
    for name, t in (("idx", idx), ("tq", tq), ("eq", eq)):
        kernels.check_cuda(t, name, torch.int32, (n,))
    for name, t in (("tfx", tfx), ("tfy", tfy), ("efx", efx), ("efy", efy)):
        kernels.check_cuda(t, name, torch.float32, (n,))
    if c4 % 4 or c4 // 4 + 4 > 16:
        raise ValueError(f"c4={c4}: need a multiple of 4 with c4/4 + 4 <= 16")
    out = torch.empty((16, n), dtype=torch.float32, device=table.device)
    kernels.launch("arctic_tap_resolve", table, idx, tq, eq, tfx, tfy, efx, efy, n, c4, out)
    tap_resolve.launches += 1
    return out
