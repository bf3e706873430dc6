"""Device span of the program's rt_sky range (the ray-traced frame's
environment lookup of misses and composite), per traced frame."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("rt_sky")
    return per_frame(run, s) * 1e3 if s else None
