"""Cook-Torrance GGX BRDF, channel-first — torch port of the ``_cf`` half
of arctic_tpu/ops/pbr.py (shaders/forward.hlsl:126-193). Vectors are
(3, ...) with the channel axis leading, scalars (1, ...).
"""

from __future__ import annotations

import torch

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
