"""Tonemapping + gamma — torch port of arctic_tpu/ops/tonemap.py
(shaders/post_process.hlsl). Elementwise torch ops, no kernel.

- tm_reinhard      post_process.hlsl:39-42   c / (c + 1)
- tm_exposure      post_process.hlsl:44-47   1 - exp(-c * e)
- tm_aces          post_process.hlsl:15-32,50-57 (Hill/self_shadow fit)
- correct_gamma    post_process.hlsl:34-37   pow(abs(c), 1/gamma)
"""

from __future__ import annotations

import torch

# post_process.hlsl:15-19 (row-major; applied as out = M @ c).
ACES_INPUT_MAT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.837),
)
# post_process.hlsl:21-25
ACES_OUTPUT_MAT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07),
)


def tm_reinhard(color: torch.Tensor) -> torch.Tensor:
    return color / (color + 1.0)


def tm_exposure(color: torch.Tensor, exposure) -> torch.Tensor:
    return 1.0 - torch.exp(-color * exposure)


def _rrt_and_odt_fit(color: torch.Tensor) -> torch.Tensor:
    a = color * (color + 0.0245786) - 0.000090537
    b = color * (0.983729 * color + 0.4329510) + 0.238081
    return a / b


def _mat3_cf(m, c: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j m[i][j] * c[j] on the leading channel axis, in f32.
    The constants are taken as f32, like the JAX package's f32 matrices."""
    mf = torch.tensor(m, dtype=torch.float32).tolist()
    return torch.stack(
        [mf[i][0] * c[0] + mf[i][1] * c[1] + mf[i][2] * c[2] for i in range(3)]
    )


def tm_aces(color: torch.Tensor) -> torch.Tensor:
    """ACES fit on a channel-leading (3, ...) color."""
    c = _mat3_cf(ACES_INPUT_MAT, color)
    c = _rrt_and_odt_fit(c)
    c = _mat3_cf(ACES_OUTPUT_MAT, c)
    return torch.clamp(c, 0.0, 1.0)  # saturate


def correct_gamma(color: torch.Tensor, gamma) -> torch.Tensor:
    return torch.abs(color) ** (1.0 / gamma)


def tonemap(color: torch.Tensor, tm_method: int, gamma, exposure) -> torch.Tensor:
    """Post-process chain (post_process.hlsl:74-92) on a channel-leading
    (3, ...) HDR color. ``tm_method`` is a host int: only the chosen operator
    runs; its values equal the JAX package's per-pixel select of it."""
    m = min(max(int(tm_method), 0), 2)
    if m == 0:
        mapped = tm_reinhard(color)
    elif m == 1:
        mapped = tm_exposure(color, exposure)
    else:
        mapped = tm_aces(color)
    return correct_gamma(mapped, gamma)


def to_unorm8(color: torch.Tensor) -> torch.Tensor:
    """Store to R8G8B8A8_UNORM: clamp, then round half to even."""
    return torch.round(torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)
