"""Device span of the program's forward_shade_skybox range, per traced
frame."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("forward_shade_skybox")
    return per_frame(run, s) * 1e3 if s else None
