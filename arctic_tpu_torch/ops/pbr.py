"""Cook-Torrance GGX BRDF, channel-first — torch port of the ``_cf`` half
of arctic_tpu/ops/pbr.py (shaders/forward.hlsl:126-193). Vectors are
(3, ...) with the channel axis leading, scalars (1, ...).

``shade_lights`` (K15, csrc/shade_lights.cu) lights the ray-traced frame:
the sun, the point lights and the ambient term in one launch on the card;
``shade_lights_plain`` is the same chain in plain torch, each operation
rounded as the kernel rounds it.
"""

from __future__ import annotations

import ctypes

import torch

from arctic_tpu_torch.core.scene import MAX_POINT_LIGHTS
from arctic_tpu_torch.utils import kernels

PI = 3.14159265  # forward.hlsl:1 — the shader's 9-digit PI, kept verbatim


def dot_cf(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the leading 3-channel axis, in channel order -> (1, ...)."""
    return (a[0:1] * b[0:1] + a[1:2] * b[1:2]) + a[2:3] * b[2:3]


def fresnel_schlick(cos_theta, f0):
    return f0 + (1.0 - f0) * torch.clamp(1.0 - cos_theta, 0.0, 1.0) ** 5.0


def distribution_ggx_cf(n, h, roughness):
    a = roughness * roughness
    a2 = a * a
    n_dot_h = torch.clamp(dot_cf(n, h), min=0.0)
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(n_dot_wo, roughness):
    r = roughness + 1.0
    k = (r * r) / 8.0
    return n_dot_wo / (n_dot_wo * (1.0 - k) + k)


def geometry_smith_cf(n, wo, wi, roughness):
    n_dot_wo = torch.clamp(dot_cf(n, wo), min=0.0)
    n_dot_wi = torch.clamp(dot_cf(n, wi), min=0.0)
    return geometry_schlick_ggx(n_dot_wo, roughness) * geometry_schlick_ggx(
        n_dot_wi, roughness
    )


def outgoing_radiance_cf(n, wo, wi, ingoing_radiance, base_color, metalness, roughness):
    """calculate_outgoing_radiance (forward.hlsl:177-193): vectors (3, ...),
    metalness / roughness (1, ...); returns (3, ...)."""
    h = wo + wi
    h = h / torch.sqrt(dot_cf(h, h))
    f0 = torch.full_like(base_color, 0.04)
    f0 = f0 + (base_color - f0) * metalness
    fresnel = fresnel_schlick(torch.clamp(dot_cf(h, wo), min=0.0), f0)
    ndf = distribution_ggx_cf(n, h, roughness)
    geo = geometry_smith_cf(n, wo, wi, roughness)
    num = ndf * geo * fresnel
    denom = (
        4.0 * torch.clamp(dot_cf(n, wo), min=0.0) * torch.clamp(dot_cf(n, wi), min=0.0)
        + 1e-4
    )
    specular = num / denom
    k_d = (1.0 - fresnel) * (1.0 - metalness)
    n_dot_wi = torch.clamp(dot_cf(n, wi), min=0.0)
    return (k_d * base_color / PI + specular) * ingoing_radiance * n_dot_wi


# K15 shade_lights: the ray-traced frame's sun, point lights and ambient
# term in one launch (csrc/shade_lights.cu).
# The frame parameters K15 takes by value, as floats in this order (LIGHT_*
# are offsets): eye, the sun's incoming direction wi = -direction, the sun's
# colour, ambient, the light count (at most MAX_POINT_LIGHTS), the spot
# flag, then per light (MAX_POINT_LIGHTS rows each, zero beyond the count)
# its position, colour, spot axis and cone (outer_cos, inv_range); the axes
# and cones are zero unless the spot flag is set.
LIGHT_EYE, LIGHT_SUN_WI, LIGHT_SUN_COLOR = 0, 3, 6
LIGHT_AMBIENT, LIGHT_COUNT, LIGHT_SPOT, LIGHT_POS = 9, 10, 11, 12
LIGHT_COLOR = LIGHT_POS + 3 * MAX_POINT_LIGHTS
LIGHT_AXIS = LIGHT_COLOR + 3 * MAX_POINT_LIGHTS
LIGHT_CONE = LIGHT_AXIS + 3 * MAX_POINT_LIGHTS
LIGHT_FLOATS = LIGHT_CONE + 2 * MAX_POINT_LIGHTS
# Bytes K15 must move a pixel: wp, n, base colour (3 f32 each), metalness,
# roughness and lit in, the (3,) colour out; plus 4 a light with a
# visibility stack.
SHADE_BYTES = 4 * (3 + 3 + 3 + 1 + 1 + 1) + 4 * 3


def point_light_dir(wp: torch.Tensor, position: torch.Tensor):
    """(wi (3, ...), dist (1, ...)) from the points ``wp`` toward a point
    light at ``position`` (a (3,) host tensor)."""
    lpos = position.tolist()
    ldir = torch.stack([lpos[k] - wp[k] for k in range(3)])
    dist = torch.clamp(torch.sqrt(dot_cf(ldir, ldir)), min=1e-12)
    return ldir / dist, dist


def pack_lights(params, spotlights: bool) -> list[float]:
    """The frame parameters of ``shade_lights`` (SceneParams on the host)
    as K15 takes them: LIGHT_FLOATS floats, read with .tolist() (no device
    copy, no sync for host tensors)."""
    lights = params.point_lights
    count = min(lights.count, MAX_POINT_LIGHTS)
    spot = spotlights and lights.spot_dir is not None
    out = [0.0] * LIGHT_FLOATS
    out[LIGHT_EYE : LIGHT_EYE + 3] = params.camera.eye.tolist()
    out[LIGHT_SUN_WI : LIGHT_SUN_WI + 3] = (-params.sun.direction()).tolist()
    out[LIGHT_SUN_COLOR : LIGHT_SUN_COLOR + 3] = params.sun.color.tolist()
    out[LIGHT_AMBIENT] = float(params.ambient)
    out[LIGHT_COUNT] = float(count)
    out[LIGHT_SPOT] = float(spot)
    for off, rows, width in ((LIGHT_POS, lights.position, 3), (LIGHT_COLOR, lights.color, 3),
                             (LIGHT_AXIS, lights.spot_dir if spot else None, 3),
                             (LIGHT_CONE, lights.spot_cos if spot else None, 2)):
        if rows is not None and count:
            out[off : off + width * count] = rows[:count].reshape(-1).tolist()
    return out


def shade_lights_plain(wp, n, base_color, metalness, roughness, lit, params, spotlights=False,
                       visibility=None):
    """Plain torch K15: the ray-traced frame's lighting (JAX raytrace.py's
    shading) over channel-first planes: the sun term scaled by ``lit``
    (1, H, W), each point light's term (its cone under ``spotlights``)
    scaled by ``lit`` and, where ``visibility`` (L, H, W) is given, by the
    light's row, and the ambient term -> (3, H, W) colour."""
    dev = wp.device
    wi_sun = -params.sun.direction().to(dev)
    eye = params.camera.eye.tolist()
    wo = torch.stack([eye[i] - wp[i] for i in range(3)])
    wo = wo / torch.sqrt(dot_cf(wo, wo))
    lo = lit * outgoing_radiance_cf(
        n, wo, wi_sun[:, None, None], params.sun.color.to(dev)[:, None, None],
        base_color, metalness, roughness,
    )
    lights = params.point_lights
    for i in range(min(lights.count, MAX_POINT_LIGHTS)):
        wi, dist = point_light_dir(wp, lights.position[i])
        radiance = lights.color[i].to(dev)[:, None, None] / (dist * dist)
        if spotlights and lights.spot_dir is not None:
            outer, inv_range = lights.spot_cos[i].tolist()
            cos_t = -dot_cf(wi, lights.spot_dir[i].to(dev)[:, None, None])
            radiance = radiance * torch.clamp((cos_t - outer) * inv_range, 0.0, 1.0)
        vis = lit if visibility is None else visibility[i : i + 1] * lit
        lo = lo + vis * outgoing_radiance_cf(n, wo, wi, radiance, base_color, metalness,
                                             roughness)
    return lo + float(params.ambient) * base_color


def _pixel_strides(t: torch.Tensor, name: str, channels: int, hw: tuple) -> tuple[int, int]:
    """(channel stride, pixel stride) of a (channels, H, W) f32 plane set
    whose pixels lie evenly spaced in row-major order (any channel stride);
    raise on anything else."""
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape) != (channels, *hw):
        raise ValueError(f"{name}: expected shape {(channels, *hw)}, got {tuple(t.shape)}")
    h, w = hw
    if h > 1 and w > 1 and t.stride(1) != w * t.stride(2):
        raise ValueError(f"{name}: K15 needs evenly spaced pixels (stride over H = W x stride "
                         f"over W), got strides {t.stride()}")
    return t.stride(0), t.stride(2) if w > 1 else t.stride(1)


@kernels.kernel(
    "shade_lights", "arctic_tpu_torch/csrc/shade_lights.cu",
    "none (arctic_tpu/models/raytrace.py's shading chain, which XLA fuses under jax.jit)",
    shade_lights_plain,
)
def shade_lights(wp, n, base_color, metalness, roughness, lit, params, spotlights=False,
                 visibility=None):
    """K15: ``shade_lights_plain`` in one launch for CUDA planes (the plain
    version for CPU ones). Planes are f32, channel first, with evenly
    spaced pixels (views such as a tap's ``movedim`` are read in place);
    ``params`` stays on the host and goes to the kernel by value."""
    if not wp.is_cuda:
        return shade_lights_plain(wp, n, base_color, metalness, roughness, lit, params,
                                  spotlights, visibility)
    hw = tuple(wp.shape[1:])
    count = min(params.point_lights.count, MAX_POINT_LIGHTS)
    planes = [(wp, "wp", 3), (n, "n", 3), (base_color, "base_color", 3),
              (metalness, "metalness", 1), (roughness, "roughness", 1), (lit, "lit", 1)]
    strides = [s for t, name, c in planes for s in _pixel_strides(t, name, c, hw)]
    strides += [0, 0] if visibility is None else _pixel_strides(visibility, "visibility", count, hw)
    out = torch.empty((3, *hw), dtype=torch.float32, device=wp.device)
    kernels.launch("arctic_shade_lights", wp, n, base_color, metalness, roughness, lit,
                   visibility, (ctypes.c_longlong * len(strides))(*strides), hw[0], hw[1],
                   (ctypes.c_float * LIGHT_FLOATS)(*pack_lights(params, spotlights)), out)
    shade_lights.launches += 1
    return out
