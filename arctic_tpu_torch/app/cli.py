"""CLI renderer — `arctic <scene>` (main.cpp:18-22) on one GPU; port of
arctic_tpu/app/cli.py with the same ``render`` flags and defaults, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
torch versions).

Examples:
    python -m arctic_tpu_torch.app.cli render scene.glb --out frame.png
    python -m arctic_tpu_torch.app.cli render --procedural sponza --width 1920 \
        --height 1080 --tm aces --frames 60 --orbit --cache-sun
    python -m arctic_tpu_torch.app.cli render scene.obj --camera 0,5,0,0,0
    python -m arctic_tpu_torch.app.cli render scene.glb --ibl \
        --spot 0,8,0,200,200,200,0,-1,0,20,35

--bruteforce renders with the brute-force raster oracle and the deferred
shade (small frames only; no pair-cap tuning, --cache-sun ignored), --ibl
adds the opt-in IBL specular term, and each --spot appends a spotlight to
the loaded or default lights. --raytrace renders the ray-traced mode (a
BVH built on the host, K14 on the card; no pair-cap tuning, no stats, the
tile atlas refused). --devices N renders each frame as N slabs of tile
rows on N processes (parallel/sharding.py: NCCL with rank r on cuda:r, or
gloo with --device cpu; --cache-sun ignored): this process loads the scene
on the CPU and starts the ranks, each rank tunes the pair caps on its own
device and the slabs share the largest, rank 0 writes the PNGs and prints
--stats, and the stats are maxed over the ranks. On cuda, N > 1 has not yet
run on a machine with several cards (one card runs N = 1). --debug-checks
turns NaN and Inf in the frame's inputs and passes into FloatingPointError
(utils/errors.py). --config takes the JAX package's RenderConfig fields by
name, the camera tile (tile_h / tile_w) and the shadow tile (shadow_tile /
shadow_tile_h) among them: frames are the same at every tile, and a tile
the JAX package refuses on the frame's path raises RenderError before the
scene loads (core/config.check_tiles).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time

log = logging.getLogger("arctic")

TM_NAMES = {"reinhard": 0, "exposure": 1, "aces": 2}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="arctic_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render one frame or an orbit sequence")
    r.add_argument("scene", nargs="?", help="glTF/GLB/OBJ scene path")
    r.add_argument("--procedural", choices=["cornell", "sponza"], help="use a built-in scene")
    r.add_argument("--out", default="frame.png")
    r.add_argument("--width", type=int, default=1280)  # app.hpp:20
    r.add_argument("--height", type=int, default=720)  # app.hpp:21
    r.add_argument("--shadow-size", type=int, default=4000)  # shadow_map_pass.hpp:23
    # Settings flags default to None so --load-state can tell "explicitly
    # passed" from "defaulted": saved tm / gamma / exposure survive a reload
    # unless the command line overrides them.
    r.add_argument("--tm", choices=list(TM_NAMES), default=None,
                   help="tonemap method (default reinhard, or the --load-state value)")
    r.add_argument("--gamma", type=float, default=None,
                   help="gamma (default 2.2, or the --load-state value)")
    r.add_argument("--exposure", type=float, default=None,
                   help="exposure (default 1.0, or the --load-state value)")
    r.add_argument("--camera",
                   help="x,y,z,pitch,yaw (default 0,5,0,0,0); use --camera=-14,4,0,-8,0 "
                   "for values starting with a minus sign")
    r.add_argument("--env", help="equirect .hdr environment path")
    r.add_argument("--frames", type=int, default=1, help="number of frames to render")
    r.add_argument("--orbit", action="store_true", help="sweep yaw over the frames")
    r.add_argument("--stats", action="store_true", help="print frame-time stats")
    r.add_argument("--cache-sun", action="store_true",
                   help="render the shadow map once and reuse it across frames "
                   "(exact while sun and geometry are static, e.g. --orbit)")
    r.add_argument("--load-state", help="load camera/lights/settings JSON")
    r.add_argument("--save-state", help="write camera/lights/settings JSON after rendering")
    r.add_argument("--config",
                   help="JSON file of RenderConfig fields (the JAX package's names: "
                   "tile_h / tile_w, shadow_tile / shadow_tile_h, pair capacity, "
                   "pcf_row_cap, ...); frames are the same at every tile the JAX package "
                   "takes: h * w % 128 == 0, and 128 % tile_w == 0 on the fused frame")
    r.add_argument("--device", default="cuda",
                   help="torch device of the scene buffers and the frame (default cuda)")
    r.add_argument("--bruteforce", action="store_true",
                   help="brute-force raster and deferred shade (small frames only)")
    r.add_argument("--ibl", action="store_true", help="opt-in IBL specular term")
    r.add_argument("--spot", action="append", default=[], metavar="X,Y,Z,R,G,B,AX,AY,AZ,IN,OUT",
                   help="add a spotlight: position, color, axis, inner / outer cone "
                   "degrees (opt-in). Repeatable.")
    r.add_argument("--raytrace", action="store_true",
                   help="ray-traced mode (BVH traversal instead of the rasterizer)")
    r.add_argument("--devices", type=int, default=0,
                   help="shard each frame's tile rows over N processes (one per card on cuda; "
                   "N > 1 on cuda is not yet verified on several cards)")
    r.add_argument("--debug-checks", action="store_true",
                   help="raise on NaN / Inf in the frame's inputs and passes (slow)")
    return p


def cmd_render(args) -> int:
    import torch

    from arctic_tpu_torch.core.config import check_tiles, config_from_dict
    from arctic_tpu_torch.core.scene import PointLights, default_scene_params, default_settings
    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.io.images import load_hdr
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils.errors import RenderError, enable_debug_checks

    if args.debug_checks:
        enable_debug_checks()
    device = torch.device(args.device)
    if args.devices:
        from arctic_tpu_torch.parallel import sharding

        sharding.check_world(args.devices, device)  # before anything is loaded
    spots = [[float(x) for x in spec.split(",")] for spec in args.spot]
    if any(len(v) != 11 for v in spots):
        raise RenderError("--spot wants X,Y,Z,R,G,B,AX,AY,AZ,IN,OUT")
    fields = dict(width=args.width, height=args.height, shadow_size=args.shadow_size)
    if args.config:
        import json

        with open(args.config) as f:
            fields.update(json.load(f))
    if args.bruteforce:
        fields["force_bruteforce"] = True
    if args.ibl:
        fields["ibl_specular"] = True
    config = config_from_dict(fields)
    sharded = bool(args.devices) and not args.raytrace
    if not args.raytrace:  # the ray-traced mode bins nothing
        check_tiles(config, world=args.devices if sharded else None)

    if args.procedural:
        from arctic_tpu_torch.io import procedural

        if args.procedural == "cornell":
            meshes, objects, materials, env = procedural.cornell_like_scene()
        else:
            meshes, objects, materials, env = procedural.sponza_like_scene()
        if args.env:
            env = load_hdr(args.env)
    elif args.scene:
        from arctic_tpu_torch.io.load import load_scene_file

        meshes, objects, materials, env = load_scene_file(args.scene, env_path=args.env)
    else:
        log.error("render: need a scene path or --procedural")
        return 2

    # Sharded, this process holds the scene on the CPU only: each rank moves
    # it to its own device, and no rank shares a card with this process.
    buffers = build_buffers(meshes, objects, materials, env,
                            device="cpu" if sharded else device)
    log.info("scene: %d tris, %d objects, device=%s", buffers.geometry.num_tris,
             len(objects), buffers.device)

    params = default_scene_params(aspect=args.width / args.height)
    settings = default_settings()
    if args.load_state:
        from arctic_tpu_torch.utils.serialize import load_state

        params, settings = load_state(args.load_state)
        params.camera = dataclasses.replace(
            params.camera, aspect=torch.tensor(args.width / args.height, dtype=torch.float32)
        )
    if args.camera:
        vals = [float(v) for v in args.camera.split(",")]
        params.camera = dataclasses.replace(
            params.camera,
            eye=torch.tensor(vals[:3], dtype=torch.float32),
            rotation=torch.tensor(vals[3:5], dtype=torch.float32),
        )
    if spots:
        # Spotlights join the loaded (or default) lights as cone rows.
        pl = params.point_lights
        rows = [(pl.position[i].tolist(), pl.color[i].tolist()) for i in range(pl.count)]
        rows += [(v[0:3], v[3:6], (v[6:9], v[9], v[10])) for v in spots]
        params.point_lights = PointLights.from_list(rows, spots=True)
        config = dataclasses.replace(config, spotlights=True)
    # Explicitly passed flags override the loaded (or default) settings.
    if args.tm is not None:
        settings = dataclasses.replace(settings, tm_method=TM_NAMES[args.tm])
    if args.gamma is not None:
        settings = dataclasses.replace(settings, gamma=torch.tensor(args.gamma, dtype=torch.float32))
    if args.exposure is not None:
        settings = dataclasses.replace(
            settings, exposure=torch.tensor(args.exposure, dtype=torch.float32)
        )

    tune = not (args.raytrace or config.force_bruteforce)
    if tune:
        # Shade the known light count.
        config = dataclasses.replace(config, static_point_lights=params.point_lights.count)
    if sharded:
        sharding.launch(args.devices, render_rank, args, buffers, params, settings, config, tune,
                        device=device)
        return 0
    if tune:
        config = tune_pair_caps(buffers, params, config)

    render_stats = None
    if args.raytrace:
        from arctic_tpu_torch.models import raytrace

        rt_render = raytrace.make_rt_renderer(config, raytrace.build_scene_bvh(buffers), device)

        def render(b, p, s):
            return rt_render(b, p, s), None

        log.info("ray-traced mode: BVH built on the host")
    elif args.cache_sun and not config.force_bruteforce:
        sun_cache, cache_stats = pipeline.make_sun_cache_builder(config, device)(buffers, params)
        pipeline.check_stats({**cache_stats, "cam_pairs": 0, "cam_pair_cap": 1})
        cached = pipeline.make_cached_renderer_stats(config, device)

        def render_stats(b, p, s):
            return cached(b, p, s, sun_cache)

        log.info("sun cache built (shadow map reused per frame)")
    else:
        render_stats = pipeline.make_renderer_stats(config, device)
    if render_stats is not None:
        render = render_stats
    render_frames(args, render, render_stats, buffers, params, settings, config, device)
    return 0


def tune_pair_caps(buffers, params, config):
    """``config`` with its pair buffers sized to the scene: binning's cost
    scales with the capacity, not the pairs."""
    from arctic_tpu_torch.models import pipeline

    config = pipeline.autotune_pair_caps(buffers, params, config)
    log.info("pair caps: cam=%d shadow=%d", config.pair_cap_cam, config.pair_cap_shadow)
    return config


def render_rank(rank: int, world: int, device, args, buffers, params, settings, config,
                tune: bool) -> None:
    """One rank of ``--devices``: the sharded frames of the host scene
    buffers moved to this rank's device (with ``tune``, the pair caps tuned
    there and maxed over the ranks, so the slabs share them); rank 0 writes
    the PNGs, the state and the --stats line."""
    import torch
    import torch.distributed as dist

    from arctic_tpu_torch.parallel import sharding
    from arctic_tpu_torch.utils.errors import enable_debug_checks

    if rank == 0:
        logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    if args.debug_checks:
        enable_debug_checks()  # a process-wide flag: each rank sets its own
    log.info("rank %d of %d on %s", rank, world, device)
    buffers = buffers.to(device)
    if tune:
        config = tune_pair_caps(buffers, params, config)
        caps = torch.tensor([config.pair_cap_cam, config.pair_cap_shadow], device=device)
        dist.all_reduce(caps, op=dist.ReduceOp.MAX)
        config = dataclasses.replace(config, pair_cap_cam=int(caps[0]),
                                     pair_cap_shadow=int(caps[1]))
    render_stats = sharding.make_sharded_renderer_stats(config, device=device)
    render_frames(args, render_stats, render_stats, buffers, params, settings, config, device,
                  write=rank == 0)


def render_frames(args, render, render_stats, buffers, params, settings, config, device,
                  write: bool = True) -> None:
    """The CLI's frames: the first frame's overflow check, the timed frames,
    and (``write``) the PNGs, the state file and the --stats line."""
    import torch

    from arctic_tpu_torch.io.images import save_png
    from arctic_tpu_torch.utils.errors import render_guard
    from arctic_tpu_torch.utils.profiling import FrameStats

    scene_desc = args.scene or f"procedural:{args.procedural}"
    guard_desc = (f"scene={scene_desc} {config.width}x{config.height} "
                  f"shadow={config.shadow_size} tris={buffers.geometry.num_tris} device={device}")

    # The first frame's stats: did a pair, penumbra row or fallback row
    # buffer overflow (dropped fragments)? The ray-traced mode has none.
    if render_stats is not None:
        with render_guard(guard_desc):
            _, rstats = render_stats(buffers, params, settings)
            rstats = {k: int(v) for k, v in rstats.items()}
        for name, count, cap in (("cam pass", "cam_pairs", "cam_pair_cap"),
                                 ("shadow pass", "shadow_pairs", "shadow_pair_cap"),
                                 ("PCF", "pcf_rows", "pcf_row_cap"),
                                 ("grouped tile route", "tex_fb_rows", "tex_fb_cap")):
            if rstats[count] > rstats[cap]:
                log.warning("%s overflowed its buffer (%d > %d): the frame is wrong — raise "
                            "pairs_per_tri / pair_reserve / pcf_row_cap / tex_group_caps via "
                            "--config", name, rstats[count], rstats[cap])

    stats = FrameStats()
    img = None
    for i in range(args.frames):
        p = params
        if args.orbit and args.frames > 1:
            rot = params.camera.rotation + torch.tensor([0.0, 360.0 * i / args.frames])
            p = dataclasses.replace(params, camera=dataclasses.replace(params.camera, rotation=rot))
        # Time only the render and the device sync: PNG encoding is not
        # frame time.
        t0 = time.perf_counter()
        with render_guard(guard_desc):
            img, _ = render(buffers, p, settings)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        stats.add(time.perf_counter() - t0)
        if write and args.frames > 1:
            save_png(args.out.replace(".png", f"_{i:04d}.png"), img.cpu().numpy())
    if not write:
        return
    if args.frames == 1:
        save_png(args.out, img.cpu().numpy())
    log.info("wrote %s", args.out)
    if args.save_state:
        from arctic_tpu_torch.utils.serialize import save_state

        save_state(args.save_state, params, settings)
        log.info("saved state to %s", args.save_state)
    if args.stats:
        print(stats.summary())


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
