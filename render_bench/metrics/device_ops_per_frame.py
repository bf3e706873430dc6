"""Device operations (kernels, copies, fills) per traced frame."""

from render_bench.metrics import per_frame


def read(run):
    return per_frame(run, run.trace["device_ops"])
