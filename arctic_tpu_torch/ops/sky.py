"""Equirectangular sky — torch port of the channel-first helpers of
arctic_tpu/ops/sky.py (shaders/skybox.hlsl as dataflow, including the
``uv.y = -uv.y`` quirk that relies on WRAP addressing), and the opt-in IBL
lookup, which is the same lookup without that flip (forward.hlsl:195-206).
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


def env_uv_cf(dx, dy, dz, flip_v: bool = True):
    """Equirect (u, v) of channel-first ray components (skybox.hlsl:74-85);
    ``flip_v=False`` drops the skybox's v negation (the IBL lookup)."""
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    nx, ny, nz = dx / norm, dy / norm, dz / norm
    u = torch.atan2(nz, nx) * INV_ATAN[0] + 0.5
    v = torch.asin(torch.clamp(ny, -1.0, 1.0)) * INV_ATAN[1] + 0.5
    return u, (-v if flip_v else v)  # skybox.hlsl:83


def _sample(env_rows, env_block_grid, region, u, v):
    """Bilinear RGB at (u, v) from the env quad rows ((n_env, 128) bf16, 8
    quads of 16 lanes per row), gathering each pixel's 16 lanes only.
    quad_index wraps any texel index into the
    region, so NaN directions (pixels whose values are discarded) read a
    real row."""
    from arctic_tpu_torch.ops.sampling import quad_index

    q, fx, fy = quad_index(env_block_grid, *region, u, v)
    win = env_rows.reshape(-1, 16)[q.long()].to(torch.float32)  # quad q: row q // 8, lanes 16 (q % 8)
    top = win[..., 0:4] + (win[..., 4:8] - win[..., 0:4]) * fx[..., None]
    bot = win[..., 8:12] + (win[..., 12:16] - win[..., 8:12]) * fx[..., None]
    out = top + (bot - top) * fy[..., None]
    return out[..., 0], out[..., 1], out[..., 2]


def sample_environment_cf(env_rows, env_block_grid, region, dx, dy, dz):
    """Channel-first sky sample (r, g, b) along rays (dx, dy, dz)."""
    return _sample(env_rows, env_block_grid, region, *env_uv_cf(dx, dy, dz))


def sample_environment_ibl_cf(env_rows, env_block_grid, region, dx, dy, dz):
    """Channel-first IBL sample (r, g, b): sample_environment_cf without the
    skybox's v flip (the JAX package's sample_environment_ibl_cf)."""
    return _sample(env_rows, env_block_grid, region, *env_uv_cf(dx, dy, dz, flip_v=False))
