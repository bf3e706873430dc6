"""The ray-traced mode (raytrace.make_rt_renderer over build_scene_bvh):
K14 traces the primary and sun rays, and with the mix's ``light_shadows``
one ray toward each point light."""

from __future__ import annotations

from render_bench.entries import params, render_config

MODE = "rt"


def setup(run):
    from arctic_tpu_torch.models import raytrace

    with run.timed("bvh_build_s"):
        bvh = raytrace.build_scene_bvh(run.bufs)
    config = render_config(run, rt_light_shadows=bool(run.mix.get("light_shadows", False)))
    render = raytrace.make_rt_renderer(config, bvh, run.device)

    def frame(spec):
        return render(run.bufs, *params(spec)), None

    return frame
