"""Device span of the program's pbr_lights range (the sun term, each point
light and the ambient term; on the ray-traced frame each light's shadow
rays too), per traced frame."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("pbr_lights")
    return per_frame(run, s) * 1e3 if s else None
