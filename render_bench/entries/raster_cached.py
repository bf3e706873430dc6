"""The fused raster frame of a still sun: the sun cache built once in
set-up (pipeline.make_sun_cache_builder), every frame through
pipeline.make_cached_renderer_stats with no shadow pass."""

from __future__ import annotations

import dataclasses

from render_bench.entries import params, render_config
from render_bench.entries.raster import tune

MODE = "raster"
# K1's passes a frame (the roofline's work).
RASTER_PASSES = ("camera",)


def setup(run):
    from arctic_tpu_torch.models import pipeline

    suns = {tuple(s["sun"]["rotation"]) for s in run.path["stops"]}
    if len(suns) != 1:
        raise ValueError(f"the sun cache needs a still sun; the path has {len(suns)}")
    # The cache renders the whole map, so its cap is tuned without the
    # sun-cull rect; the frames themselves render no shadow pass.
    config = tune(run, render_config(run, sun_frustum_cull=False))
    config = dataclasses.replace(config, sun_frustum_cull=True)
    with run.timed("sun_cache_s"):
        cache, stats = pipeline.make_sun_cache_builder(config, run.device)(
            run.bufs, params(run.path["stops"][0])[0])
    pipeline.check_stats({"cam_pairs": 0, "cam_pair_cap": 1, **stats})
    render = pipeline.make_cached_renderer_stats(config, run.device)

    def frame(spec):
        return render(run.bufs, *params(spec), cache)

    return frame
