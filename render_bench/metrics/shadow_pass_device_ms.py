"""Device span of the program's shadow_pass range, per traced frame."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("shadow_pass")
    return per_frame(run, s) * 1e3 if s else None
