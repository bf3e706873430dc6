"""Device span of the raster frame's sky_composite range (IBL specular
where the configuration asks for it, and the skybox composite), per traced
frame."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("sky_composite")
    return per_frame(run, s) * 1e3 if s else None
