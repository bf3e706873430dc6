"""Equirectangular sky — torch port of the channel-first helpers of
arctic_tpu/ops/sky.py (shaders/skybox.hlsl as dataflow, including the
``uv.y = -uv.y`` quirk that relies on WRAP addressing).
"""

from __future__ import annotations

import torch

from arctic_tpu_torch.core.maths import radians

INV_ATAN = (0.1591, 0.3183)  # skybox.hlsl:45, kept verbatim


def camera_ray_dirs_cf(camera, px, py, width: int, height: int):
    """World-space view rays at pixel-centre planes -> (dx, dy, dz).

    The camera's rotation, aspect and tan(fov/2) are f32 host constants
    (the camera's tensors live on the host); the rays are computed on the
    device of ``px``."""
    t = float(torch.tan(radians(camera.fov_y) * 0.5))
    aspect = float(camera.aspect)
    rot = camera.view()[:3, :3].tolist()  # rows: right, up, -forward
    x_ndc = px / width * 2.0 - 1.0
    y_ndc = 1.0 - py / height * 2.0
    dvx = x_ndc * aspect * t
    dvy = y_ndc * t
    return tuple(rot[0][i] * dvx + rot[1][i] * dvy - rot[2][i] for i in range(3))


def env_uv_cf(dx, dy, dz):
    """Equirect (u, v) of channel-first ray components (skybox.hlsl:74-85)."""
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    nx, ny, nz = dx / norm, dy / norm, dz / norm
    u = torch.atan2(nz, nx) * INV_ATAN[0] + 0.5
    v = torch.asin(torch.clamp(ny, -1.0, 1.0)) * INV_ATAN[1] + 0.5
    return u, -v  # skybox.hlsl:83


def sample_environment_cf(env_rows, env_block_grid, region, dx, dy, dz):
    """Channel-first sky sample (r, g, b) from the env quad rows
    ((n_env, 128) bf16, 8 quads of 16 lanes per row)."""
    from arctic_tpu_torch.ops.sampling import quad_index

    u, v = env_uv_cf(dx, dy, dz)
    q, fx, fy = quad_index(env_block_grid, *region, u, v)
    row = env_rows[(q // 8).long()].to(torch.float32)
    lanes = (q % 8).long()[..., None] * 16 + torch.arange(16, device=row.device)
    win = torch.gather(row, -1, lanes)
    top = win[..., 0:4] + (win[..., 4:8] - win[..., 0:4]) * fx[..., None]
    bot = win[..., 8:12] + (win[..., 12:16] - win[..., 8:12]) * fx[..., None]
    out = top + (bot - top) * fy[..., None]
    return out[..., 0], out[..., 1], out[..., 2]
