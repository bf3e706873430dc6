"""Stream and device synchronisations the host made inside the frame
calls of the traced burst, per frame (a blocking copy or .tolist() of a
device tensor makes one)."""

from render_bench.metrics import per_frame


def read(run):
    return per_frame(run, run.trace["host_syncs"])
