"""Device span of the raster frame's pbr_lights range (K15 alone: the sun
term, each point light and the ambient term), per traced frame. The range
has the ray-traced frame's name, whose metric is pbr_lights_device_ms."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("pbr_lights")
    return per_frame(run, s) * 1e3 if s else None
