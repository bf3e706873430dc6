"""Camera / light matrix math (GLM conventions) — torch port of
arctic_tpu/core/maths.py.

Right-handed view space, clip depth in [0, 1] (GLM_FORCE_DEPTH_ZERO_TO_ONE).
Matrices act on column vectors: ``clip = P @ V @ M @ [x y z 1]^T``. All
math is float32 on the inputs' device; the renderer evaluates these 4x4s on
the host (like the reference's GLM) and uploads the results.
"""

from __future__ import annotations

import math

import torch

WORLD_UP = (0.0, 1.0, 0.0)  # Camera::up(), scene.hpp:30-33

# DirectionalLight::proj_view_matrix ortho bounds (scene.cpp:68).
SUN_ORTHO = (-16.0, 16.0, -16.0, 16.0, 0.1, 50.0)

_DEG = math.pi / 180.0


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def radians(deg: torch.Tensor) -> torch.Tensor:
    """jnp.radians: one f32 multiply by f32(pi / 180)."""
    return deg * _DEG


def mat4_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """4x4 product in full f32 (TF32 is off wherever the renderer runs)."""
    return torch.matmul(a, b)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Unit-length vector along the last axis (GLM normalize: no eps guard)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def dir_from_rot(rotation_deg) -> torch.Tensor:
    """(pitch, yaw) degrees -> unit direction (scene.cpp:9-19)."""
    r = _f32(rotation_deg)
    x = radians(r[..., 0])
    y = radians(r[..., 1])
    return torch.stack(
        [torch.cos(x) * torch.cos(y), torch.sin(x), torch.cos(x) * torch.sin(y)],
        dim=-1,
    )


def look_at_rh(eye, center, up) -> torch.Tensor:
    """glm::lookAtRH — right-handed view matrix (camera looks down -Z)."""
    eye = _f32(eye)
    f = normalize(_f32(center, eye) - eye)
    s = normalize(torch.linalg.cross(f, _f32(up, eye)))
    u = torch.linalg.cross(s, f)
    m = torch.zeros((4, 4), dtype=torch.float32, device=eye.device)
    m[:3, :3] = torch.stack([s, u, -f], dim=0)  # rows: right, up, -forward
    m[:3, 3] = torch.stack([-_dot3(s, eye), -_dot3(u, eye), _dot3(f, eye)])
    m[3, 3] = 1.0
    return m


def perspective_rh_zo(fov_y_rad, aspect, z_near, z_far) -> torch.Tensor:
    """glm::perspectiveRH_ZO — RH perspective, clip z in [0, 1]."""
    fov_y_rad = _f32(fov_y_rad)
    aspect, z_near, z_far = (_f32(a, fov_y_rad) for a in (aspect, z_near, z_far))
    t = torch.tan(fov_y_rad * 0.5)
    m = torch.zeros((4, 4), dtype=torch.float32, device=fov_y_rad.device)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = z_far / (z_near - z_far)
    m[2, 3] = -(z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def ortho_rh_zo(left, right, bottom, top, z_near, z_far) -> torch.Tensor:
    """glm::orthoRH_ZO — RH orthographic, clip z in [0, 1]."""
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (z_far - z_near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -z_near / (z_far - z_near)
    m[3, 3] = 1.0
    return m


def camera_view_matrix(eye, rotation_deg) -> torch.Tensor:
    eye = _f32(eye)
    return look_at_rh(eye, eye + dir_from_rot(rotation_deg).to(eye.device), WORLD_UP)


def camera_proj_view(eye, rotation_deg, aspect, fov_y_deg, z_near, z_far) -> torch.Tensor:
    """Camera::proj_view_matrix (scene.cpp:41-54)."""
    view = camera_view_matrix(eye, rotation_deg)
    proj = perspective_rh_zo(radians(_f32(fov_y_deg)), aspect, z_near, z_far)
    return mat4_mul(proj, view)


def sun_proj_view(position, rotation_deg) -> torch.Tensor:
    """DirectionalLight::proj_view_matrix (scene.cpp:61-70)."""
    position = _f32(position)
    fwd = dir_from_rot(rotation_deg).to(position.device)
    view = look_at_rh(position, position + fwd, WORLD_UP)
    return mat4_mul(ortho_rh_zo(*SUN_ORTHO).to(position.device), view)


def trs_compose(translation, rotation_quat_wxyz, scale) -> torch.Tensor:
    """Column-major TRS = T * R * S from glTF node transform components."""
    w, x, y, z = _f32(rotation_quat_wxyz).unbind(0)
    r = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
        ]
    )
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[:3, :3] = r * _f32(scale)[None, :]
    m[:3, 3] = _f32(translation)
    m[3, 3] = 1.0
    return m
