"""K14 bvh_trace: the bytes one ray-traced frame's traces must move.

Counted from the configuration's sizes (frozen from ops/rt.py's byte
counts, commit b3e24800): each ray's origin, direction and bound (28 B)
read once and its hit (t, triangle, u, v: 16 B) written once, for W x H
rays a trace; each triangle's record (48 B) read once a frame.
"""

RAY_BYTES = 28 + 16
TRI_BYTES = 48


def traces(cfg: dict, mix: dict) -> int:
    """Traces a frame: the primary and sun rays, and with light shadows
    one a point light."""
    return 2 + (cfg["static_point_lights"] if mix.get("light_shadows") else 0)


def frame_bytes(cfg: dict, mix: dict) -> int:
    w, h = cfg["resolution"]
    return traces(cfg, mix) * w * h * RAY_BYTES + cfg["scene"]["triangles"] * TRI_BYTES
