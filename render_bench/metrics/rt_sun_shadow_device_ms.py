"""Device span of the program's rt_sun_shadow range (the ray-traced
frame's K14 any-hit trace toward the sun), per traced frame."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("rt_sun_shadow")
    return per_frame(run, s) * 1e3 if s else None
