"""Device span of the program's post_process range (the f16 round of
the HDR target, tonemap and the u8 image), per traced frame."""

from render_bench.metrics import per_frame


def read(run):
    s = run.trace["range_device_s"].get("post_process")
    return per_frame(run, s) * 1e3 if s else None
