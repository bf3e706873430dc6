"""Scene / settings data model as dataclasses of tensors — torch port of
arctic_tpu/core/scene.py (only the fields the default fused frame reads).

Per-frame state (camera, sun, point lights, settings) holds small float32
tensors that stay on the host: the renderer derives the 4x4 matrices and the
light count there, as the reference's CPU side does, and uploads the results.
Scene buffers (geometry, atlases) live on the device they were built for.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from arctic_tpu_torch.core import maths

# Renderer::MAX_NUM_POINT_LIGHTS (renderer.hpp:22).
MAX_POINT_LIGHTS = 16

# Tonemap method ids (post_process.hlsl:1-3).
TM_REINHARD = 0
TM_EXPOSURE = 1
TM_ACES = 2


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


@dataclass
class Camera:
    """Camera (scene.hpp:20-38). Rotation is (pitch, yaw) Euler degrees."""

    eye: torch.Tensor  # (3,) f32
    rotation: torch.Tensor  # (2,) f32 degrees
    aspect: torch.Tensor  # () f32
    fov_y: torch.Tensor  # () f32 degrees
    z_near: torch.Tensor  # () f32
    z_far: torch.Tensor  # () f32

    def proj_view(self) -> torch.Tensor:
        return maths.camera_proj_view(
            self.eye, self.rotation, self.aspect, self.fov_y, self.z_near, self.z_far
        )

    def view(self) -> torch.Tensor:
        return maths.camera_view_matrix(self.eye, self.rotation)


@dataclass
class DirectionalLight:
    """DirectionalLight (scene.hpp:77-86)."""

    position: torch.Tensor  # (3,) f32
    rotation: torch.Tensor  # (2,) f32 degrees
    color: torch.Tensor  # (3,) f32 HDR

    def direction(self) -> torch.Tensor:
        return maths.dir_from_rot(self.rotation)

    def proj_view(self) -> torch.Tensor:
        return maths.sun_proj_view(self.position, self.rotation)


@dataclass
class PointLights:
    """Fixed-capacity SoA point-light bank (scene.hpp:88-94, max 16)."""

    position: torch.Tensor  # (16, 3) f32
    color: torch.Tensor  # (16, 3) f32
    count: int

    @staticmethod
    def from_list(lights) -> "PointLights":
        """lights: a list of (position, color) rows."""
        n = min(len(lights), MAX_POINT_LIGHTS)
        pos = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
        col = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
        for i in range(n):
            pos[i], col[i] = lights[i][0], lights[i][1]
        return PointLights(torch.as_tensor(pos), torch.as_tensor(col), n)


@dataclass
class SceneParams:
    """Per-frame dynamic scene state (Scene aggregate, scene.hpp:96-103)."""

    camera: Camera
    ambient: torch.Tensor  # () f32
    sun: DirectionalLight
    point_lights: PointLights


@dataclass
class Settings:
    """Post-process settings (scene.hpp:105-110)."""

    tm_method: int  # 0 reinhard / 1 exposure / 2 aces
    gamma: torch.Tensor  # () f32
    exposure: torch.Tensor  # () f32


@dataclass
class Geometry:
    """The geometry the fused frame reads, as component planes (K, T) with
    the triangle dim minor (see arctic_tpu.core.scene.Geometry)."""

    num_tris: int
    tri_corner_pos: torch.Tensor  # (9, T) f32 object-space corners, row c*3+i
    tri_trs: torch.Tensor  # (16, T) f32 world TRS per triangle, row i*4+j
    # Slot-major static half of the shade-row table: rows [0:33) corner
    # n/t/b/uv, [33:56) material row, dup'd to [primary; secondary] clip
    # slots and zero-padded to the 512-aligned table height.
    slot_static_rows: torch.Tensor  # (56, NT) f32

    @property
    def capacity(self) -> int:
        return self.tri_corner_pos.shape[1]


@dataclass
class TextureAtlas:
    """The combined-slot material atlas of the merged texture+environment
    tap (see arctic_tpu.core.scene.TextureAtlas)."""

    combined_slots: tuple  # texture slots interleaved per quad, e.g. (0, 1)
    combined_shape: tuple  # (AH, AW) of the combined atlas
    quad_width: int  # C4: channels per combined quad (16 per slot)
    # [packed material quad rows; environment quad rows] — the one table the
    # merged tap gathers from.
    combined_env_rows: torch.Tensor  # (ntex + n_env, 128) bf16

    @property
    def combined_block_grid(self):
        ah, aw = self.combined_shape
        return ah // 2 + 1, aw // 2 + 1


@dataclass
class Environment:
    """Equirect environment: its quad table rows sit at the tail of
    TextureAtlas.combined_env_rows."""

    region: tuple  # (y, x, h, w) of the single padded region
    data_shape: tuple  # (EH, EW) of the padded environment atlas
    num_rows: int  # quad rows of the environment in combined_env_rows

    @property
    def block_grid(self):
        ah, aw = self.data_shape
        return ah // 2 + 1, aw // 2 + 1


@dataclass
class SceneBuffers:
    """Everything static the frame function needs on the device."""

    geometry: Geometry
    atlas: TextureAtlas
    environment: Environment

    @property
    def device(self) -> torch.device:
        return self.geometry.tri_corner_pos.device


def make_camera(eye, rotation, aspect, fov_y=45.0, z_near=0.1, z_far=1000.0) -> Camera:
    return Camera(
        eye=_f32(eye), rotation=_f32(rotation), aspect=_f32(aspect),
        fov_y=_f32(fov_y), z_near=_f32(z_near), z_far=_f32(z_far),
    )


def default_scene_params(aspect: float = 1280.0 / 720.0) -> SceneParams:
    """The reference's startup scene state (app.hpp:42-63)."""
    sun = DirectionalLight(
        position=_f32([-10.0, 32.0, -2.48]),
        rotation=_f32([-70.0, 12.0]),
        color=_f32([8.0, 8.0, 8.0]),
    )
    lights = PointLights.from_list([((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))])
    return SceneParams(
        camera=make_camera([0.0, 5.0, 0.0], [0.0, 0.0], aspect),
        ambient=_f32(0.1),
        sun=sun,
        point_lights=lights,
    )


def default_settings() -> Settings:
    """Settings defaults (scene.hpp:105-110)."""
    return Settings(tm_method=TM_REINHARD, gamma=_f32(2.2), exposure=_f32(1.0))
