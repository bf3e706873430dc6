"""K14 bvh_trace against its bytes bound: the bytes the frame's traces
must move (work/bvh_trace.py) over the HBM rate, as a share of the
profiler's device time of bvh_trace_kernel, per traced frame."""

from render_bench.metrics import kernel_seconds, per_frame
from render_bench.work import HBM_BYTES_PER_S, bvh_trace

KERNEL = "bvh_trace_kernel"


def read(run):
    s = kernel_seconds(run, KERNEL)
    if not s:
        return None
    bound = bvh_trace.frame_bytes(run.cfg, run.mix) / HBM_BYTES_PER_S
    return 100.0 * bound / per_frame(run, s)
