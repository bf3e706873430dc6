"""Scene / settings data model as dataclasses of tensors — torch port of
arctic_tpu/core/scene.py (the fields the ported frame paths read).

Per-frame state (camera, sun, point lights, settings) holds small float32
tensors that stay on the host: the renderer derives the 4x4 matrices and the
light count there, as the reference's CPU side does, and uploads the results.
Scene buffers (geometry, atlases) live on the device they were built for.
"""

from __future__ import annotations

import dataclasses
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


def point_cone_rows() -> tuple[np.ndarray, np.ndarray]:
    """The (spot_dir, spot_cos) arrays of a bank of point rows: axis -y and
    (outer_cos, 1 / (inner_cos - outer_cos)) = (-2, 1), whose cone factor
    clamps to exactly 1.0 (the JAX package's packing)."""
    sdir = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
    sdir[:, 1] = -1.0
    scos = np.tile(np.asarray([-2.0, 1.0], np.float32), (MAX_POINT_LIGHTS, 1))
    return sdir, scos


@dataclass
class PointLights:
    """Fixed-capacity SoA point-light bank (scene.hpp:88-94, max 16).

    Rows may carry a spotlight cone (read under RenderConfig.spotlights):
    ``spot_dir`` is the unit axis and ``spot_cos`` packs (outer_cos,
    1 / (inner_cos - outer_cos)); point rows store (-2, 1), whose factor
    clamps to exactly 1.0. Both are None for a bank built without cones."""

    position: torch.Tensor  # (16, 3) f32
    color: torch.Tensor  # (16, 3) f32
    count: int
    spot_dir: torch.Tensor | None = None  # (16, 3) f32
    spot_cos: torch.Tensor | None = None  # (16, 2) f32

    @staticmethod
    def from_list(lights, spots: bool = False) -> "PointLights":
        """lights: (position, color) point rows or (position, color, (axis,
        inner_deg, outer_deg)) spotlight rows; ``spots`` gives an all-point
        bank the cone fields too (the JAX package's packing, in numpy f32
        and f64 as it computes it)."""
        n = min(len(lights), MAX_POINT_LIGHTS)
        pos = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
        col = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
        sdir, scos = point_cone_rows()
        any_spot = spots
        for i in range(n):
            pos[i], col[i] = lights[i][0], lights[i][1]
            if len(lights[i]) > 2 and lights[i][2] is not None:
                axis, inner_deg, outer_deg = lights[i][2]
                axis = np.asarray(axis, np.float32)
                sdir[i] = axis / max(np.linalg.norm(axis), 1e-12)
                inner_c = np.cos(np.radians(inner_deg))
                outer_c = np.cos(np.radians(outer_deg))
                scos[i] = (outer_c, 1.0 / max(inner_c - outer_c, 1e-4))
                any_spot = True
        return PointLights(
            torch.as_tensor(pos), torch.as_tensor(col), n,
            spot_dir=torch.as_tensor(sdir) if any_spot else None,
            spot_cos=torch.as_tensor(scos) if any_spot else None,
        )


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
    tri_static_attrs: torch.Tensor  # (33, T) f32 corner n/t/b/uv, row c*11+k
    # (23, T) f32: atlas regions 12, mr consts 4, nm consts 3, combined
    # region or tile block 4.
    tri_matrow: torch.Tensor
    # Slot-major static half of the shade-row table: rows [0:33) corner
    # n/t/b/uv, [33:56) material row, dup'd to [primary; secondary] clip
    # slots and zero-padded to the 512-aligned table height. None selects
    # the full-stack shade-row build (K10), which reads the two tri-major
    # planes above every frame instead.
    slot_static_rows: torch.Tensor | None  # (56, NT) f32
    # Material id of each triangle: the grouped tile route's row
    # measurements read it (pipeline.measure_tex_row_masks).
    tri_material: torch.Tensor | None = None  # (T,) i32
    # Each object's world TRS and each triangle's object id: tri_trs is
    # object_trs[tri_obj] (with_object_trs edits both; the viewer's object
    # editor).
    object_trs: torch.Tensor | None = None  # (O, 4, 4) f32
    tri_obj: torch.Tensor | None = None  # (T,) i32

    def __post_init__(self):
        # build_buffers makes the tri-major planes views of the static rows:
        # without the rows, copy them out so the rows' storage can go.
        if self.slot_static_rows is None:
            self.tri_static_attrs = self.tri_static_attrs.contiguous()
            self.tri_matrow = self.tri_matrow.contiguous()

    @property
    def capacity(self) -> int:
        return self.tri_corner_pos.shape[1]


@dataclass
class TextureAtlas:
    """The material textures, on one of four routes (see
    arctic_tpu.core.scene.TextureAtlas):

    - the merged texture+environment tap (K6): the combined-slot quad rows
      in bf16 followed by the environment's rows, ``combined_env_rows``;
    - the unmerged combined tap (an ``atlas_dtype`` other than bf16): the
      combined-slot quads ``combined_quads`` in that type, sampled apart
      from the environment (Environment.rows);
    - the per-slot taps, where a material's maps do not share one size:
      the plain atlas's quads ``quads`` (one tap per non-constant slot);
    - the u16 tile atlas of reference-scale texture sets (K9): ``tiles``,
      ``tiles_ntex``, ``tile_groups`` and the grouping's fields.
    Fields of the other routes are None.
    """

    combined_slots: tuple | None = None  # texture slots interleaved per quad, e.g. (0, 1)
    combined_shape: tuple | None = None  # (AH, AW) of the combined atlas
    quad_width: int | None = None  # C4: channels per combined quad (16 per slot)
    # [packed material quad rows; environment quad rows] — the one table the
    # merged tap gathers from.
    combined_env_rows: torch.Tensor | None = None  # (ntex + n_env, 128) bf16
    combined_quads: torch.Tensor | None = None  # (4*BH*BW, C4) in atlas_dtype (unmerged)
    # The plain per-slot atlas: four parity-shifted 2x2-quad copies of the
    # (AH, AW) atlas of every (material, slot) image, 16 channels a quad.
    quads: torch.Tensor | None = None  # (4*BH*BW, 16) in atlas_dtype
    data_shape: tuple | None = None  # (AH, AW) of the per-slot atlas
    # Every material's normal (metal-roughness) map is one constant: its
    # tap is elided and the constant rides the material row.
    nm_constant: bool = False
    mr_constant: bool = False
    # [g0 tiles | env | g1 tiles | env | ...]: 4x8-texel u16 tiles (lane
    # c2*32 + y*8 + x holds channels 2*c2 | 2*c2+1 << 16) of each material
    # group, each group followed by its own copy of the environment's quad
    # rows as f32 bits (io/build.py group_tile_atlas).
    tiles: torch.Tensor | None = None  # (N, 128) i32
    tiles_ntex: int | None = None  # first env row of group 0 (any copy serves)
    tile_groups: tuple | None = None  # per group (mstart, env_base, end) rows
    tile_group_of: tuple | None = None  # material id -> group
    tile_mat_rows: tuple | None = None  # tile rows per material
    tile_group_budget: int | None = None  # bytes of one group's slice the build packed to

    @property
    def combined_block_grid(self):
        ah, aw = self.combined_shape
        return ah // 2 + 1, aw // 2 + 1

    @property
    def block_grid(self):
        ah, aw = self.data_shape
        return ah // 2 + 1, aw // 2 + 1

    @property
    def texel_dtype(self) -> torch.dtype:
        """The type the material texels are stored in on the quad routes."""
        for t in (self.combined_env_rows, self.combined_quads, self.quads):
            if t is not None:
                return t.dtype
        raise ValueError("the tile atlas stores u16 texels")


@dataclass
class Environment:
    """Equirect environment: its bf16 quad rows sit at the tail of
    TextureAtlas.combined_env_rows, after each group of TextureAtlas.tiles
    (as f32 bits), or, on the unmerged and per-slot routes, in ``rows``."""

    region: tuple  # (y, x, h, w) of the single padded region
    data_shape: tuple  # (EH, EW) of the padded environment atlas
    num_rows: int  # quad rows of one copy of the environment
    rows: torch.Tensor | None = None  # (num_rows, 128) bf16

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

    def to(self, device) -> "SceneBuffers":
        """The buffers on ``device`` (a copy unless they are there already;
        views of the static rows become tensors of their own)."""
        return SceneBuffers(_to(self.geometry, device), _to(self.atlas, device),
                            _to(self.environment, device))


def _to(obj, device):
    """A dataclass of tensors with each tensor field moved to ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    })


@dataclass
class SunCache:
    """Shadow products that depend only on (geometry, sun), kept across
    frames while the camera moves (pipeline.build_sun_cache). The map is
    rendered in full, with no cull rect, so the cache stays valid for any
    camera; rendering with it gives the pixels of rendering without it.

    ``lutq`` and ``pyramid`` are built only when the frame reads them (a
    config with pcf_row_cap); otherwise they are None and the frame takes
    the exact f32 runs path on ``shadow_map``. The JAX package builds its
    table always, though only its TPU reads it without a row cap."""

    shadow_map: torch.Tensor  # (S, S) f32 depth
    lutq: torch.Tensor | None  # (S + 4, pitch) u16 window table (K7)
    pyramid: torch.Tensor | None  # (M,) i32 packed min / max pyramid


def with_object_trs(geom: Geometry, obj_id: int, trs) -> Geometry:
    """Geometry with object ``obj_id``'s world TRS replaced (the viewer's
    object editor; arctic_tpu/core/scene.py:381-402): object_trs[obj_id]
    and the tri-major tri_trs (16, T) = object_trs[tri_obj].reshape(T,
    16).T, as io/build.py gathers it. The corner positions and the static
    attribute rows stay as they are (n / t / b are object-space,
    forward.hlsl:54-61), so an edit is this two-array update."""
    object_trs = geom.object_trs.clone()
    object_trs[obj_id] = torch.as_tensor(np.asarray(trs, np.float32), device=object_trs.device)
    tri_trs = object_trs[geom.tri_obj.long()].reshape(geom.capacity, 16).T.contiguous()
    return dataclasses.replace(geom, object_trs=object_trs, tri_trs=tri_trs)


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
