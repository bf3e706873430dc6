"""K15 shade_lights against its bytes bound: the bytes the frame's lighting
must move (work/shade_lights.py) over the HBM rate, as a share of the
profiler's device time of shade_lights_kernel, per traced frame."""

from render_bench.metrics import kernel_seconds, per_frame
from render_bench.work import HBM_BYTES_PER_S, shade_lights

KERNEL = "shade_lights_kernel"


def read(run):
    s = kernel_seconds(run, KERNEL)
    if not s:
        return None
    bound = shade_lights.frame_bytes(run.cfg, run.mix) / HBM_BYTES_PER_S
    return 100.0 * bound / per_frame(run, s)
