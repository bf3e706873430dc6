"""Multi-GPU rendering: screen-tile-row slabs with one shadow-map
all-gather — torch port of arctic_tpu/parallel/sharding.py over a
torch.distributed process group (NCCL on CUDA, gloo on the CPU).

- Scene buffers and per-frame params are replicated; every rank builds the
  tri-major corners, the triangle setup, the sun-cull rect and the
  shade-row table whole (the per-triangle work; replicating it avoids
  sharding the pair sort).
- The shadow map and the frame are cut into horizontal slabs of whole tile
  rows: ``cam_tile_rows = round_up(ceil(H / tile_h), world)`` and
  ``sh_tile_rows = round_up(ceil(S / sth), world)`` (sth = the shadow
  tile's height, RenderConfig.shadow_th), split evenly, so
  trailing ranks may get partial or empty windows; the frame and the map
  are cropped to H and S.
- Each rank bins and rasters its shadow slab (depth only, front faces
  culled, inside the sun-cull rect), then ONE all-gather assembles the map
  on every rank, because the PCF reads all of it. Each rank then bins and
  rasters its camera slab (K1 with the slab's first row ``row0``), resolves
  its G-buffer (K4, the same row0), shades it (PCF, texture tap, lights,
  sky) and post-processes it; the u8 slabs are all-gathered, so every rank
  returns the whole (H, W, 3) frame.
- Stats (pairs, penumbra rows, fallback rows) are all-reduced with MAX, so
  pipeline.check_stats stays loud when any slab overflows.

The slab frame equals the single-device frame bit for bit: binning drops
the slots with no row in a slab's window and keeps the others' lists in
slot order, and K1 / K4 / the shade see the frame's pixel rows.
``force_bruteforce`` runs the brute-force raster per slab and the deferred
shade; ``fused_shade=False`` alone still takes the fused slabs (as in the
JAX package). render_frame_slabs_stats runs the same slab stages rank after
rank in one process (the all-gather a concatenation, the all-reduce a max):
the counterpart of the JAX package's virtual CPU mesh, which lets one card
or the CPU check the slab composition.
"""

from __future__ import annotations

import functools
import os
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from arctic_tpu_torch.core.config import RenderConfig, check_tiles
from arctic_tpu_torch.core.scene import SceneBuffers, SceneParams, Settings
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import raster, raster_tiles, shadow
from arctic_tpu_torch.utils import kernels
from arctic_tpu_torch.utils.errors import RenderError, check_finite
from arctic_tpu_torch.utils.profiling import named_scope

# Seconds a rank waits in a collective (and launch() for every rank's
# result) before the run fails instead of hanging.
TIMEOUT_S = 120.0

# The count stats a slab reports, all-reduced with MAX.
COUNTS = ("cam_pairs", "shadow_pairs", "pcf_rows", "tex_fb_rows")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class SlabLayout(NamedTuple):
    world: int
    cam_tile_rows: int  # camera tile rows, rounded up to a multiple of world
    cam_rows: int  # camera tile rows a rank rasters
    sh_tile_rows: int  # shadow tile rows, rounded up likewise
    sh_rows: int  # shadow tile rows a rank rasters


def slab_layout(config: RenderConfig, world: int) -> SlabLayout:
    """The tile rows of each rank's camera and shadow slab
    (arctic_tpu/parallel/sharding.py:77-83); raises RenderError on tiles
    the sharded frame does not take (core/config.check_tiles)."""
    if world < 1:
        raise RenderError(f"a sharded frame needs at least one rank, got {world}")
    check_tiles(config, world=world)
    cam = _round_up(config.tiles_y, world)
    sh = _round_up(config.shadow_tiles_y, world)
    return SlabLayout(world, cam, cam // world, sh, sh // world)


class ReplicatedInputs(NamedTuple):
    """The replicated per-frame inputs of every slab."""

    wc: tuple
    sun_clip: tuple
    tri_valid: torch.Tensor
    cam_pv: torch.Tensor
    cull_rect: tuple | None  # sun-cull rect (global tile coords), fused frame only
    lut_y_range: torch.Tensor | None  # its window start_y band


def replicated_inputs(buffers: SceneBuffers, params: SceneParams,
                      config: RenderConfig) -> ReplicatedInputs:
    """What every rank computes whole: the tri-major world and sun-clip
    corners, the valid triangles, the camera matrix and the sun-cull rect."""
    geom = buffers.geometry
    sun_pv, cam_pv = params.sun.proj_view(), params.camera.proj_view()
    wc = pipeline.world_corners(geom)
    tri_valid = torch.arange(geom.capacity, device=buffers.device) < geom.num_tris
    rect = y_band = None
    if not config.force_bruteforce and config.sun_frustum_cull:
        # From replicated inputs, so every slab bins against the same rect.
        rect, y_band = pipeline.sun_cull_rect(wc, tri_valid, cam_pv, sun_pv, config)
    return ReplicatedInputs(wc, pipeline.corners_clip(wc, sun_pv), tri_valid, cam_pv, rect, y_band)


def shadow_slab(buffers: SceneBuffers, config: RenderConfig, layout: SlabLayout, rank: int,
                front: ReplicatedInputs):
    """Rank ``rank``'s shadow slab: (depth (sh_rows * sth, W) f32, pairs
    0-dim i32), sth x st the shadow tile (RenderConfig.shadow_th x
    shadow_tile). Binned slabs are tile-padded (W = st * ceil(S / st)) and
    rastered by K1 inside the sun-cull rect; brute-force slabs are S wide."""
    s = config.shadow_size
    clipped = raster.near_clip_corners(front.sun_clip, front.tri_valid)
    setup = raster.setup_screen_triangles(clipped, s, s, cull="front")
    rows = layout.sh_rows * config.shadow_th
    if config.force_bruteforce:
        zbuf, _ = raster.rasterize_bruteforce(setup, rows, s, y_offset=rank * rows)
        return zbuf, torch.zeros((), dtype=torch.int32, device=zbuf.device)
    zbuf, _, pairs = raster_tiles.rasterize_tiled(
        setup, s, s, config, config.shadow_th, config.shadow_tile, depth_only=True,
        rect=front.cull_rect, tile_row0=rank * layout.sh_rows, tile_rows=layout.sh_rows,
        crop=False,
    )
    return zbuf, pairs


def camera_slab(buffers: SceneBuffers, params: SceneParams, settings: Settings,
                config: RenderConfig, layout: SlabLayout, rank: int, shadow_map: torch.Tensor,
                front: ReplicatedInputs):
    """Rank ``rank``'s camera slab over the whole shadow map: (u8 (cam_rows *
    tile_h, W, 3), {cam_pairs, pcf_rows, tex_fb_rows} 0-dim i32)."""
    geom = buffers.geometry
    tile_row0 = rank * layout.cam_rows
    y0 = tile_row0 * config.tile_h
    zero = torch.zeros((), dtype=torch.int32, device=buffers.device)
    with named_scope("forward_visibility"):
        setup = pipeline.camera_setup(front.wc, front.tri_valid, front.cam_pv, config)
        if config.force_bruteforce:
            _, ibuf = raster.rasterize_bruteforce(
                setup, layout.cam_rows * config.tile_h, config.width, y_offset=y0
            )
            cam_pairs = zero
        else:
            shade_rows = pipeline.build_shade_rows(
                setup, geom, front.wc, tuple(c[:3] for c in front.sun_clip)
            )
            ibuf, gbuf, cam_pairs = raster_tiles.raster_gbuffer(
                setup, shade_rows, config.height, config.width, config, tile_row0,
                layout.cam_rows,
            )
            pipeline.check_gbuffer(gbuf, ibuf)
    with named_scope("forward_shade_skybox"):
        if config.force_bruteforce:
            hdr = pipeline.shade(buffers, params, setup, ibuf, front.wc, shadow_map, config, y0)
            pcf_rows = tex_fb_rows = zero
        else:
            hdr, pcf_rows, tex_fb_rows = pipeline.shade_gbuffer(
                buffers, params, gbuf, ibuf >= 0, shadow_map, config,
                lut_y_range=front.lut_y_range, y0=y0,
            )
        check_finite("forward_shade_skybox", hdr=hdr)
    with named_scope("post_process"):
        img = pipeline.post_process(hdr, settings, config)[:, : config.width].contiguous()
    return img, dict(cam_pairs=cam_pairs, pcf_rows=pcf_rows, tex_fb_rows=tex_fb_rows)


def _stats(buffers: SceneBuffers, config: RenderConfig, layout: SlabLayout, counts: dict):
    """The frame's stats: the counts (max over ranks) beside the caps of one
    slab (arctic_tpu/parallel/sharding.py:207-238)."""
    bf = config.force_bruteforce
    slots = 2 * buffers.geometry.capacity
    pcf_cap = 1
    if not bf and config.pcf_row_cap is not None:
        # A slab's pixel count sets its penumbra compaction capacity.
        slab_px = layout.cam_rows * config.tiles_x * config.tile_h * config.tile_w
        pcf_cap = shadow.effective_row_cap(slab_px, config.pcf_row_cap)
    stats = {
        "cam_pairs": counts["cam_pairs"],
        "cam_pair_cap": 1 if bf else config.pair_capacity(slots, "cam"),
        "shadow_pairs": counts["shadow_pairs"],
        "shadow_pair_cap": 1 if bf else config.pair_capacity(slots, "shadow"),
        "pcf_rows": counts["pcf_rows"],
        "pcf_row_cap": pcf_cap,
        "tex_fb_rows": counts["tex_fb_rows"],
        "tex_fb_cap": pipeline.tex_fb_capacity(buffers, config),
    }
    if config.debug_overflow:
        pipeline.warn_overflow(stats)
    return stats


def slab_shadow_map(buffers: SceneBuffers, params: SceneParams, config: RenderConfig,
                    world: int, front: ReplicatedInputs | None = None):
    """The shadow map of ``world`` slabs, rastered rank after rank in this
    process and concatenated (the all-gather): ((S, S) f32, the max of the
    slabs' pairs)."""
    layout = slab_layout(config, world)
    front = front or replicated_inputs(buffers, params, config)
    with named_scope("shadow_pass"):
        slabs = [shadow_slab(buffers, config, layout, r, front) for r in range(world)]
    s = config.shadow_size
    shadow_map = torch.cat([z for z, _ in slabs])[:s, :s]
    return shadow_map, torch.stack([p for _, p in slabs]).max()


def render_frame_slabs_with_map(buffers: SceneBuffers, params: SceneParams, settings: Settings,
                                config: RenderConfig, world: int):
    """The sharded frame of ``world`` ranks, its slab stages run rank after
    rank in this process: ((H, W, 3) u8, stats, the gathered (S, S) shadow
    map the camera slabs read). The all-gathers become concatenations and
    the all-reduce a max; the frame and the stats equal
    render_frame_sharded_stats' on ``world`` ranks."""
    pipeline.use_full_f32()
    pipeline.check_frame_inputs(params, settings)
    layout = slab_layout(config, world)
    front = replicated_inputs(buffers, params, config)
    shadow_map, sh_pairs = slab_shadow_map(buffers, params, config, world, front)
    check_finite("shadow_pass", shadow_map=shadow_map)
    slabs = [camera_slab(buffers, params, settings, config, layout, r, shadow_map, front)
             for r in range(world)]
    img = torch.cat([im for im, _ in slabs])[: config.height]
    counts = {k: torch.stack([c[k] for _, c in slabs]).max() for k in COUNTS if k != "shadow_pairs"}
    counts["shadow_pairs"] = sh_pairs
    return img, _stats(buffers, config, layout, counts), shadow_map


def render_frame_slabs_stats(buffers: SceneBuffers, params: SceneParams, settings: Settings,
                             config: RenderConfig, world: int):
    """render_frame_slabs_with_map's frame and stats: ((H, W, 3) u8, stats)."""
    return render_frame_slabs_with_map(buffers, params, settings, config, world)[:2]


def backend_for(device: torch.device | str) -> str:
    """The collective backend of a device type: NCCL for CUDA, gloo for the
    CPU. Nothing else is taken, and neither stands in for the other."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise RenderError(f"no collective backend for device type {kind!r}")


def check_world(world: int, device: torch.device | str) -> None:
    """Raise RenderError unless ``world`` ranks can run on ``device``: a
    collective backend for its type, and on ``cuda`` one card a rank."""
    device = torch.device(device)
    backend_for(device)
    if world < 1:
        raise RenderError(f"a sharded frame needs at least one rank, got {world}")
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise RenderError(f"{world} ranks on cuda need {world} CUDA devices; this machine has "
                          f"{torch.cuda.device_count()}")


def _check_backend(device: torch.device, group) -> None:
    got, want = dist.get_backend(group), backend_for(device)
    if got != want:
        raise RenderError(f"scene buffers on {device} need a {want} process group, "
                          f"this one is {got}")


def render_frame_sharded_stats(buffers: SceneBuffers, params: SceneParams, settings: Settings,
                               config: RenderConfig, group=None):
    """The frame over every rank of ``group`` (default: the whole world),
    each rank rendering its slab: ((H, W, 3) u8, the whole frame on every
    rank, and stats: counts max over ranks, caps of one slab)."""
    pipeline.use_full_f32()
    pipeline.check_frame_inputs(params, settings)
    _check_backend(buffers.device, group)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    layout = slab_layout(config, world)
    front = replicated_inputs(buffers, params, config)
    with named_scope("shadow_pass"):
        slab, sh_pairs = shadow_slab(buffers, config, layout, rank, front)
        gathered = [torch.empty_like(slab) for _ in range(world)]
        dist.all_gather(gathered, slab, group=group)
    s = config.shadow_size
    shadow_map = torch.cat(gathered)[:s, :s]
    check_finite("shadow_pass", shadow_map=shadow_map)
    img, counts = camera_slab(buffers, params, settings, config, layout, rank, shadow_map, front)
    imgs = [torch.empty_like(img) for _ in range(world)]
    dist.all_gather(imgs, img, group=group)
    counts["shadow_pairs"] = sh_pairs
    maxed = torch.stack([counts[k].to(torch.int64) for k in COUNTS])
    dist.all_reduce(maxed, op=dist.ReduceOp.MAX, group=group)
    counts = {k: maxed[i].to(torch.int32) for i, k in enumerate(COUNTS)}
    img = torch.cat(imgs)[: config.height]
    return img, _stats(buffers, config, layout, counts)


def render_frame_sharded(buffers, params, settings, config: RenderConfig, group=None):
    """The sharded frame's (H, W, 3) u8 image."""
    return render_frame_sharded_stats(buffers, params, settings, config, group)[0]


def make_sharded_renderer_stats(config: RenderConfig, group=None,
                                device: torch.device | str = "cuda"):
    """Frame function ``f(buffers, params, settings) -> (img, stats)`` over
    ``group``'s ranks, for scene buffers on this rank's ``device``."""
    pipeline.use_full_f32()
    device = torch.device(device)

    def render(buffers, params, settings):
        pipeline._check_device(buffers, device)
        return render_frame_sharded_stats(buffers, params, settings, config, group)

    return functools.update_wrapper(render, render_frame_sharded_stats)


def make_sharded_renderer(config: RenderConfig, group=None, device: torch.device | str = "cuda"):
    """Frame function ``f(buffers, params, settings) -> img`` over
    ``group``'s ranks."""
    render_stats = make_sharded_renderer_stats(config, group, device)

    def render(buffers, params, settings):
        return render_stats(buffers, params, settings)[0]

    return functools.update_wrapper(render, render_frame_sharded)


def init_group(device: torch.device | str, init_method: str, world: int = 1, rank: int = 0,
               timeout: float = TIMEOUT_S) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` over the
    device's backend (NCCL on ``cuda``, rank r on ``cuda:r``; gloo on the
    CPU), through ``init_method`` (e.g. ``file:///tmp/x/rendezvous``; no
    cluster tells the program its address). Returns this rank's device."""
    device = torch.device(device)
    check_world(world, device)
    kw = {}
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend_for(device), init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout), **kw)
    return device


def make_group(ranks: int | None = None):
    """The process group of the first ``ranks`` ranks of the default group
    (all of them by default): the counterpart of the JAX package's
    make_mesh. Every rank of the default group must call it."""
    if not dist.is_initialized():
        raise RenderError("torch.distributed is not initialised: start the ranks with "
                          "launch() or join them with init_group()")
    world = dist.get_world_size()
    if ranks is None or ranks == world:
        return dist.group.WORLD
    if not 1 <= ranks <= world:
        raise RenderError(f"a group of {ranks} ranks from a world of {world}")
    return dist.new_group(list(range(ranks)))


def _host(x):
    """Tensors in a result -> numpy arrays (pickled by value, so the result
    outlives the rank's process)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _rank_main(rank, world, device, init_method, timeout, results, fn, args):
    try:
        if torch.device(device).type == "cpu":
            # The ranks share the host's cores.
            torch.set_num_threads(1)
        dev = init_group(device, init_method, world, rank, timeout)
        try:
            out = _host(fn(rank, world, dev, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))


def launch(world: int, fn, *args, device: torch.device | str = "cuda",
           timeout: float = TIMEOUT_S) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned processes
    joined in one process group (NCCL on ``cuda``, rank r on ``cuda:r``;
    gloo on the CPU, each rank on one torch thread), rendezvous through a
    file in a temporary directory. ``fn`` must be importable (a module-level
    function) and ``args`` picklable (CPU tensors); tensors in its result
    come back as numpy arrays. Returns the results in rank order; raises
    RenderError if a rank fails or any result is missing after ``timeout``
    seconds (the collectives time out after as long), and stops every
    process it started."""
    device = torch.device(device)
    check_world(world, device)
    if device.type == "cuda":
        kernels.build_library()  # once, before the ranks load it
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, device.type, init_method, timeout, results, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, failures = {}, []
        deadline = time.monotonic() + timeout
        try:
            # Drain the queue before joining: a rank blocks until its result is read.
            while len(out) < world and not failures:
                try:
                    rank, err, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        failures.append(f"ranks {dead} (rank, exit code) died without a result")
                    elif time.monotonic() > deadline:
                        raise RenderError(f"launch: {world - len(out)} of {world} ranks gave "
                                          f"no result within {timeout:.0f} s") from None
                    continue
                if err is not None:
                    failures.append(f"rank {rank}:\n{err}")
                else:
                    out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()) if not failures else 1.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
    if failures:
        raise RenderError("launch: a rank failed\n" + "\n".join(failures))
    return [out[r] for r in range(world)]


def frame_worker(rank: int, world: int, device: torch.device, buffers: SceneBuffers,
                 params: SceneParams, settings: Settings, config: RenderConfig):
    """A rank of launch(): the sharded frame of host scene buffers moved to
    this rank's device -> (img (H, W, 3) u8, stats as ints)."""
    buffers = buffers.to(device)
    img, stats = make_sharded_renderer_stats(config, device=device)(buffers, params, settings)
    return img, {k: int(v) for k, v in stats.items()}
