"""Device span of the program's rt_surface range (the ray-traced frame's
corner-attribute gathers, material taps and normal mapping), per traced
frame."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("rt_surface")
    return per_frame(run, s) * 1e3 if s else None
