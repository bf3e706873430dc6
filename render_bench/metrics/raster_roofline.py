"""K1 raster_tiles against its bytes bound: the bytes the frame's raster
passes must move (work/raster_tiles.py) over the HBM rate, as a share of
the profiler's device time of raster_tiles_kernel, per traced frame."""

from render_bench import cell
from render_bench.metrics import kernel_seconds, per_frame
from render_bench.work import HBM_BYTES_PER_S, raster_tiles

KERNEL = "raster_tiles_kernel"


def read(run):
    s = kernel_seconds(run, KERNEL)
    passes = getattr(cell.entry(run.mix["entry"]), "RASTER_PASSES", ())
    if not s or not passes:
        return None
    bound = raster_tiles.frame_bytes(passes, run.cfg) / HBM_BYTES_PER_S
    return 100.0 * bound / per_frame(run, s)
