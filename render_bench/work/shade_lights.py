"""K15 shade_lights: the bytes one frame's lighting must move.

Counted from the configuration's sizes (frozen from ops/pbr.py's
SHADE_BYTES, commit 59ea3559): each pixel's world position, normal and base
colour (3 f32 each), metalness, roughness and sun visibility (1 f32 each)
read once and its colour (3 f32) written once, 60 B; with the light shadow
rays of the ray-traced frame, each point light's visibility (1 f32) a pixel
more.
"""

PIXEL_BYTES = 4 * (3 + 3 + 3 + 1 + 1 + 1) + 4 * 3
VISIBILITY_BYTES = 4


def frame_bytes(cfg: dict, mix: dict) -> int:
    w, h = cfg["resolution"]
    lights = cfg["static_point_lights"] if mix.get("light_shadows") else 0
    return w * h * (PIXEL_BYTES + lights * VISIBILITY_BYTES)
