"""K1 raster_tiles: the bytes one frame's raster passes must move.

Counted from the configuration's sizes (frozen from chip_smoke.work's K1
row, commit b3e24800, cut to the sizes alone): each pass writes its depth
(4 B) per pixel once, the camera pass also the triangle id (4 B), and
each pass reads each triangle's setup row (12 f32, 48 B) once.
"""

DEPTH_BYTES = 4
ID_BYTES = 4
SETUP_ROW_BYTES = 48


def pass_bytes(kind: str, cfg: dict) -> int:
    tris = cfg["scene"]["triangles"]
    if kind == "shadow":
        s = cfg["shadow_size"]
        return s * s * DEPTH_BYTES + tris * SETUP_ROW_BYTES
    if kind == "camera":
        w, h = cfg["resolution"]
        return w * h * (DEPTH_BYTES + ID_BYTES) + tris * SETUP_ROW_BYTES
    raise KeyError(kind)


def frame_bytes(passes, cfg: dict) -> int:
    """Bytes of one frame whose raster passes are ``passes``."""
    return sum(pass_bytes(p, cfg) for p in passes)
