"""The fused raster frame with the shadow pass in every frame
(pipeline.make_renderer_stats), pair caps tuned over the seed's path."""

from __future__ import annotations

from render_bench.entries import params, render_config

MODE = "raster"
# K1's passes a frame (the roofline's work).
RASTER_PASSES = ("shadow", "camera")
# Headroom of the pair caps over the most pairs the seed's path needs.
PAIR_CAP_MARGIN = 1.4


def tune(run, config):
    """``config`` with pair caps from pipeline.autotune_pair_caps over the
    seed's whole path (its ``caps_tune_s``)."""
    from arctic_tpu_torch.models import pipeline

    with run.timed("caps_tune_s"):
        return pipeline.autotune_pair_caps(
            run.bufs, [params(s)[0] for s in run.path["stops"]], config,
            margin=PAIR_CAP_MARGIN)


def setup(run):
    from arctic_tpu_torch.models import pipeline

    render = pipeline.make_renderer_stats(tune(run, render_config(run)), run.device)

    def frame(spec):
        return render(run.bufs, *params(spec))

    return frame
