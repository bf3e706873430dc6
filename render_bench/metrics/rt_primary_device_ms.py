"""Device span of the program's rt_primary range (the ray-traced frame's
primary rays and K14 closest-hit trace), per traced frame."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("rt_primary")
    return per_frame(run, s) * 1e3 if s else None
