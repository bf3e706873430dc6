#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (arctic_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--parent DIR]
    python3 chip_smoke.py --split-in DIR

(``--parent DIR``: phase 7f also measures the checkout at DIR, such as a
``git archive`` of the parent commit; ``--split-in DIR`` runs 7f's
measurement alone for the checkout at DIR.)

The real-size default scene comes through bench.py's GLB + HDR round trip
(phase 4), and the CLI renders a GLB (phase 4g). The per-slot, unmerged
and grouped texture routes and the ray-traced mode (K14 bvh_trace, K15
shade_lights) run
after the others (3i-3l, 4j-4l); then the sharded frame, the viewer and
the debug checks (6a-6f), and RenderConfig's shadow and camera tiles last
(7a-7d). Four frame paths are driven first: the default one (kernels K1
raster_tiles, K3 pack_shade_rows, K4 select_interp, K6 tap_resolve, K15
shade_lights and, for the exact f32 PCF, K16 pcf_runs), the
quantised PCF path of RenderConfig.pcf_row_cap (the same but K16, plus K7
window_lut_q and K8 pcf_eval), with and without a sun cache, the textured
path of reference-scale texture sets (the u16 tile atlas: K1, K3, K4 and K9
tile_tap_resolve in place of K6), and the full-stack shade-row route of a
Geometry without slot_static_rows (K10 transpose_pack_rows in place of K3).
The f32 window-table PCF (shadow.pcf_shadow_proj(use_lut=True,
quant=False), K12 window_lut) is driven on a real-size frame's planes. K11
pack_shade_rows_tm and K13 pcf_resolve have no caller in the frame (as in
the JAX package) and are held against K3 and K8. The deferred frame
(fused_shade=False: K1, K16, K15 and plain torch), the brute-force frame
(force_bruteforce: no kernel) and the opt-in lights (spotlights,
ibl_specular) run after the CLI phase (3f-3h, 4h, 4i). Phases, each of
which raises on failure (exit code != 0):

1. device check: refuses to run without CUDA (no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them;
2. kernel build: compiles csrc/*.cu with nvcc (sm_90a, -fmad=false), one
   process per source;
3. entry frames: Cornell at 256x192 with a 256^2 shadow map through the
   port's renderer on the card, on the default path, on the quantised
   path with pcf_row_cap=384 (every row), (3c) on the textured path
   (the same scene forced onto the tile atlas, tile_threshold_texels=0)
   and (3d) on the full-stack route (slot_static_rows=None; its frame must
   also be within 1 LSB of the default entry frame on every pixel). Each
   path must launch each of its kernels (the textured path K9 and never
   K6, the others K6 and never K9; the full-stack route K10 and never K3,
   the others K3 and never K10); each frame must be within 1 u8
   LSB of the port's CPU frame (plain torch versions) on < 1% of the
   pixels, with equal pair stats, and >= 40 dB PSNR against the f64 golden
   oracle (which samples the material images, not an atlas); check_stats
   must pass;
4. real size: the Sponza-class scene (251,500 tris) through bench.py's
   asset path (written with the port's save_glb and save_hdr into
   build/chip_smoke/, loaded back with load_scene_file(glb, env_path=hdr),
   its triangle count equal to the direct scene's; write and load seconds
   and the GLB bytes printed) at 1920x1080 with a 4000^2 shadow map, ACES,
   4 static point lights, the bench viewpoint and light rig, pair caps
   from autotune_pair_caps(margin=1.4) over bench.py's 20 fly-through
   viewpoints; 5 fly-through frames on the default path, each passing
   check_stats and not black; frame 19 gated against
   docs/images/bench_golden.png, which bench.py made through the same
   round trip: >= 99% of its pixels within 8 LSB and >= 40 dB over them
   (the whole-frame PSNR and the depth-tie share are printed, as for 4d).
   Phases 4b, 4c, 4e and 4f run on the same loaded scene. Launch
   counts are zeroed right before each path's frames and read right after;
4b. the quantised path at real size: frame 0 with every row in the cap
   gives pcf_rows; the cap becomes 32 * ceil(1.4 * pcf_rows / 32), frame 0
   at that cap must be bit-identical, then the 5-frame fly-through;
4c. the cached sun at real size: build_sun_cache, then the 5 frames with
   the cache, each within 1 LSB of the uncached frame of 4b (the front end
   eager on the first frame, captured as a CUDA graph on the second and
   replayed after: a kernel's launches are its wrapper's count plus the
   graph's replays times its launches at the capture, logged apart);
4d. the textured path at real size: sponza_like_scene(texture_size=1024,
   n_materials=24) on the tile atlas, built directly (bench.py skips the
   round trip for it too), its own tuned pair caps, the 5-frame
   fly-through (K9 once a frame, K6 never), and frame 19 gated against
   docs/images/bench_tex1024.png: >= 99% of its pixels within 8 LSB and
   >= 40 dB (bench.py's min_db) over them (the whole-frame PSNR is printed:
   near-tied depths, which the TPU rounded its own way, flip whole surface
   patches at the column capitals);
4e. the full-stack route at real size: the default scene and tuned caps
   with the geometry's slot_static_rows set to None, the 5-frame
   fly-through (K10 once a frame, K3 never), each frame within 1 LSB of the
   default path's frame at the same viewpoint;
4f. the f32 window-table PCF on the default real-size frame 0's shadow map
   (K1's strided buffer) and light-space planes, as a render of that frame
   handed them to its PCF: K12 launched, the result bit-equal to the
   runs-path result that frame computed (4e and 4f run after 4d, so the
   earlier paths see the same retained inputs as before them);
4g. the CLI on the card: Cornell exported with the port's save_glb (its
   environment as an .hdr beside it), then ``cli.main(["render", glb,
   ...])`` at the entry size and camera with --frames 2 --stats on the
   default device: K1, K3, K4 and K6 must launch, both PNGs (decoded by
   io/images) must equal the in-process frame of the loaded scene bit for
   bit and be >= 40 dB against that scene's f64 oracle;
3f. the entry frame with force_bruteforce: no kernel launches, within 1
   LSB of the port's CPU brute-force frame and of the default entry frame
   on < 1% of the values, >= 40 dB against the oracle;
3g. the entry frame with fused_shade=False: K1 twice, K16 and K15 once
   and no other kernel,
   its ibuf equal to the brute-force raster's on the same setup, its frame
   within 1 LSB of 3f's;
3h. Cornell with the point light and a spotlight (spotlights=True), fused
   and deferred, then with ibl_specular=True as well: each pair within 1
   LSB on < 1% of the values wherever their PCF shadow factors agree
   (a pixel where one of the 25 taps compares the other way may move up
   to 3 LSB under the bright spot, on at most 0.01% of the pixels), the
   fused spot frame >= 40 dB against the
   oracle with the cone, IBL moving the frame by > 2 LSB somewhere; then
   the CLI with --bruteforce (no kernel) and with --ibl --spot on the
   GLB of 4g, each PNG bit-equal to the in-process frame of its config;
4h. the deferred frame at real size: the default scene and config with
   fused_shade=False, pair caps tuned for it (the shadow pass uncull'd),
   the fly-through (K1 twice, K16 and K15 once a frame, nothing else), each frame within 1
   LSB of the default path's frame at its viewpoint on >= 99% of the
   pixels, frame 19 gated against bench_golden.png by the default path's
   rule;
4i. the opt-ins at real size on the default path (ibl_specular,
   spotlights, the bench rig plus a spotlight above the nave): the
   fly-through (K1, K3, K4, K6, K15, K16), frame 0 within 1 LSB of the deferred frame
   with the same options on >= 99% of the pixels;
3i. (after 4i, as are 3j-3l and 4j-4l, so that every earlier path keeps
   its allocator history) the per-slot route: Cornell with each normal
   map half its diffuse map's size (procedural.per_slot_materials), on
   the per-slot atlas: K1, K3, K4, K15 and K16 and no other kernel (no K6, no K9),
   within 1 LSB of the port's CPU frame on < 1% of the values, >= 40 dB
   against the f64 oracle of those materials;
3j. the unmerged combined route: Cornell with atlas_dtype=torch.float32
   (f32 combined quads, bf16 env rows apart), the same gates;
3k. the grouped tile route: tests/test_tex_groups.py's six materials at
   128 x 128 with explicit groups and caps from autotune_tex_group_caps:
   the frame bit-equal to the same buffers' ungrouped tile frame, K9
   launched once a group and once for the fallback (G + 1), a starved
   fallback cap making check_stats raise;
3l. the ray-traced entry frame with the point light and a spotlight:
   primary and sun rays, then rt_light_shadows, then the cone too: K14 2
   (+ 1 a light with rt_light_shadows) times, K15 once and no other
   kernel, each within 1 LSB of the port's CPU ray-traced frame on < 1% of the values;
4j. the grouped tile route at real size on 4d's textured scene:
   plan_tex_groups over bench.py's 20 viewpoints, the scene rebuilt with
   the plan, autotune_tex_group_caps(margin=1.1), the fly-through (K9 G + 1
   times a frame, each group's on a view of its rows of the atlas), each
   frame bit-equal to 4d's at its viewpoint; G, the caps, tex_fb_rows, the
   peak memory and the build and plan seconds printed;
4k. the ray-traced mode on phase 4's loaded scene: the BVH's build
   seconds, nodes and bytes, the fly-through (K14 twice a frame, K15 once,
   no other kernel), one frame with rt_light_shadows and the 4 lights (K14
   six times, K15 once with the visibility stack); on frame 0 the primary
   hit's triangle equals the raster ibuf's (modulo the clip-slot
   duplication) on >= 99% of the pixels both cover whose hit faces the
   camera, and on >= 99.9% of those off the edges of the raster's
   triangles (the coverage mismatch share printed);
4l. the per-slot atlas at real size: the bench geometry with 24 materials
   of 192^2 diffuse and 96^2 normal maps, its own tuned caps, the
   fly-through (K1, K3, K4, K15, K16), frame 0 within 1 LSB of its deferred frame on
   >= 99% of the pixels; median and peak printed;
6a. (after 4l, as are 6b-6f) tile-row sharding (parallel/sharding.py) over
   a world of one NCCL rank on the card: the entry frame on the default,
   quantised (pcf_row_cap=384), textured and brute-force paths bit-equal to
   the single-card frame of the same config, with equal stats, each path's
   kernels launched and no other; and the CLI's --devices 1 on cuda (a
   spawned rank over NCCL) on 4g's GLB, its PNG bit-equal to 4g's in-process
   frame;
6b. render_frame_slabs_with_map (the slab stages rank after rank in one
   process) at 128x96 / 128^2 and 192x136 / 320^2 as 2, 3 and 8 slabs:
   frames and gathered shadow maps bit-equal to the single-card ones, every
   rank launching K1 twice and K4 once, with row0 != 0 on every rank but the
   first (the launch counts and row offsets printed);
6c. phase 4's default config and tuned caps at frame 0's viewpoint, over a
   world of one NCCL rank and as 4 slabs (17 camera tile rows rounded to
   20, 63 shadow tile rows to 64, so the last camera window is partial):
   each bit-equal to phase 4's frame 0; per-rank pairs, slab ms (CUDA
   events) and peak memory beside the whole frame's printed;
6d. with two or more cards, launch() over NCCL with up to 4 processes
   (rank r on cuda:r) at the entry size, every rank's frame bit-equal to
   the single-card frame, and the CLI's --devices with as many ranks; with
   one card it prints "6d skipped: 1 card";
6e. the viewer (app/viewer.py) served on 127.0.0.1:0 in a thread at the
   entry size on the fused path: /, then /frame with the entry camera, a
   camera move, a tonemap change, a light edit, a sun edit and an object
   edit, then /state; each PNG, decoded by io/images, bit-equal to the
   in-process frame of the viewer's state; K1 once a frame where the sun
   and geometry stay (the cached sun; counted as in 4c), twice where the
   cache is rebuilt (the first frame, the sun and the object edit);
6f. enable_debug_checks: the entry frame and real-size frame 0 bit-equal
   to the unchecked ones of phases 3 and 4; a NaN light colour raises
   FloatingPointError at the frame's inputs, a NaN corner normal of a
   covered triangle at forward_visibility;
7a. (after 6f, as are 7b-7d) RenderConfig's shadow and camera tiles on the
   entry scene: shadow tiles 16 x 16, 8 high x 16 wide, 16 x 24 and 128 x
   128, camera tiles 8 x 16, 1 x 128 and 128 x 128 on the default path,
   and the 16 x 24 shadow tile on the quantised and the deferred path:
   K1 twice a frame, each frame bit-equal to its path's frame at 64 x 64
   tiles and within 1 LSB of the port's CPU frame at that tile (pair stats
   equal); K1 bit-equal to its plain version on those frames' calls and,
   in one launch, on utils/synthetic.k1_tiles at each of K1_NEW_TILES
   (128-pixel tiles, 1 x 128, 128 x 1, 16 x 24, up to 256 x 256), with and
   without the ibuf;
7b. real-size frame 0 at shadow tiles 16, 32 and 128 and camera tiles 8 x
   16 and 128 x 128, pair caps from autotune_pair_caps(margin=1.4) over
   bench.py's 20 viewpoints at each tile: each frame bit-equal to phase
   4's frame 0; K1 bit-equal to its plain version, its CUDA-event ms,
   plain ms and bound per pass and the pairs per pass printed; the
   quantised frame 0 at shadow tile 32 (4b's row cap) bit-equal to 4b's;
7c. real-size frame 0 at shadow tile 32 as 4 slabs, bit-equal to phase
   4's frame 0 (K1's shadow slabs from row rank * sh_rows * 32);
7d. the CLI with --config {"shadow_tile": 16} on 4g's GLB: its PNG
   bit-equal to 4g's in-process frame;
7e. the benchmark's lights16 configuration (render_bench/configs/
   sponza_1080p.json: the hall with its open atrium, 16 point lights, the
   runs PCF against the cached 4000^2 map, 1920 x 1080) through
   make_cached_renderer_stats over the first 10 viewpoints of its path,
   the front end eager, captured and replayed as in 4c: every frame and
   its stats equal to render_frame_stats' eager cached frame, K1, K3, K4,
   K6, K15 and K16 each launched (counted as in 4c); K15's call bit-exact
   against its plain version, its CUDA-event ms, device ms and byte floor;
   K16's call (the K16 gate) bit-exact against its plain version, its
   CUDA-event ms, device ms, its bytes and f32-operations floors, the
   plain version's ms, and its registers, spill bytes and blocks a SM;
7f. the eager lights16 frame's split: 7e's configuration rendered by
   render_frame_stats (no graph) over 6 traced frames after 2 warm-up
   ones, in a process of its own, for this checkout and (--parent DIR)
   for the checkout at DIR: each range's device busy time, device span
   and ops a frame (pcf_shadow, shadow_pass, forward_visibility,
   forward_shade_skybox, pbr_lights, sky_composite, post_process);
5. kernels against their plain torch versions on the card, on the exact
   inputs the entry and real-size frames gave them (recorded; K14 on every
   ray of the real-size calls, frame 0's and the light-shadow frame's; K15
   on both frames' calls, its CUDA-event ms, the plain version's and its
   0.037 ms byte floor at 1920 x 1080 (the K15 gate); K1
   and K4 also on every slab call of 6b and 6c, row0 != 0 included): bit-exact
   equality, CUDA-event times of kernel and plain version at the real-size
   shapes (K1 also per call: camera, shadow), and each kernel's bound on
   these inputs (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s,
   whichever is larger; K1's operations are those of the (pair, pixel)
   combinations inside all three edges); K10 and K12 also against the one
   library call that computes their function. K11 runs on the default
   frame's own K3 planes (split slot-major / tri-major) and must equal K3's
   table; K13 on the quantised frame 0's K7 table and listed penumbra rows,
   and _tap_count over its planes must equal K8's counts. K1, K3, K6, K8
   and K11 (and K16, synthetic.K16_CASES) also run on utils/synthetic.py's inputs (a 20,480-pair tile with
   ties, duplicates, slivers, z = +-0 and NaN planes; the same planes on a
   depth-only 4000^2 grid; a slot count that is not a multiple of K3's
   block; K11 where slot cap falls inside a block, with a zero tail past
   2 * cap, with N < 2 * cap, N < cap, N < 32 at cap = 1 and cap a multiple
   of 32, p at 0, N, 2 * cap and 2 * cap + 1; K6 at every quad width it
   takes over NaN / Inf / +-0 / subnormal bf16 lanes; K8 on a map whose
   table pitch is s + 4, windows at the last column and row, rows_used at
   0, below and at the list's length, and a
   list of several passes of K8's grid with rows_used just below and just
   above a multiple of its stride; K14 on axis-parallel and sub-clamp
   directions, grazing edges and faces, origins inside boxes, coplanar
   duplicates, per-ray t_max of 0 and inf, an empty scene, a 37 x 23
   camera image on K14's 8 x 4 warp tiles, NaN / inf ray components and a
   scene with an infinite vertex; K15 on utils/synthetic.K15_CASES: 0, 4
   and 16 lights, cones read or not, a visibility stack, interleaved tap
   planes, NaN / inf / subnormal values), bit-exact against their plain
   versions.
   K14's bound counts the node visits and triangle tests the plain version
   reports on every 64th ray, scaled to all rays; on the real-size primary
   and sun calls K14 is also timed and held bit-exact in linear order
   (width 0), and the plain run's per-ray visits give the warps' lockstep
   efficiency under both mappings. The registers, spill bytes, block size
   and blocks a SM of K3, K11 (the two instantiations of one kernel
   template), K14, K15 and K16 are printed and join their kernels-line entries, and
   after the build every kernel function's registers, local bytes and SASS
   instructions (cuobjdump) are printed. The real-size quad
   width and K8's live / listed rows are printed, and the share of the
   quantised frame 0's warps that take K8's fast selects, with K8's time on
   the same inputs when no warp takes them.

The wall seconds of the whole run are printed before the last two lines.
The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Frames are saved under build/chip_smoke/ as
.npy. The goldens and the CLI's PNGs are decoded by the port's io/images
(zlib and numpy: the card's machine has no Pillow). ``--profile`` adds a
torch.profiler pass over two real-size frames of each path (busy share,
per-pass device time, top kernels; these lines, the profiler's table and
a trace in build/chip_smoke/, one file per path).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ENTRY = dict(width=256, height=192, shadow=256, eye=[0.0, 4.0, 3.0], rot=[-25.0, -90.0])
REAL = dict(width=1920, height=1080, shadow=4000)
# bench.py:192-222 — the bench viewpoint and light rig, written out here.
REAL_EYE, REAL_ROT = [-14.0, 4.5, 0.0], [-8.0, 0.0]
REAL_SUN = dict(position=[0.0, 24.0, 0.0], rotation=[-65.0, 30.0])
REAL_LIGHTS = [
    ((-6.0, 3.0, -4.0), (30.0, 20.0, 8.0)),
    ((0.0, 3.0, 4.0), (30.0, 20.0, 8.0)),
    ((6.0, 3.0, -4.0), (8.0, 20.0, 30.0)),
    ((12.0, 3.0, 4.0), (30.0, 8.0, 8.0)),
]
FLY_FRAMES = 5
# bench.py's fly-through: 20 viewpoints; its goldens are the last one's frame.
BENCH_FRAMES = 20
# Pair-cap headroom over the camera path's counts (bench.py:448-453).
PAIR_MARGIN = 1.4
# The real-size golden gate. The TPU that made bench.py's goldens decided
# near-tied depths with its own f32 rounding, so pixels where two surfaces
# nearly coincide (the column capitals' spheres against the shaft tops) may
# show the other surface here. The gate: at least GOLDEN_NEAR_SHARE of the
# pixels within GOLDEN_NEAR_LSB of the golden (the JAX package's tile-vs-quad
# bound, test_sampling_variants.py:156), and bench.py's min_db over them.
GOLDEN_MIN_DB = 40.0
GOLDEN_NEAR_LSB = 8
GOLDEN_NEAR_SHARE = 0.99
# Every 128-pixel row of the entry frame: 4 x 3 tiles of 64^2 = 32 rows each.
ENTRY_ROWS = 384
# Penumbra row cap headroom over frame 0's count at real size.
CAP_MARGIN = 1.4
# Every raster frame but the brute-force one lights its pixels with K15
# and, off the quantised path, takes its PCF through K16.
RASTER_PATH = ("raster_tiles", "pack_shade_rows", "select_interp", "tap_resolve", "shade_lights")
DEFAULT_PATH = RASTER_PATH + ("pcf_runs",)
QUANT_PATH = RASTER_PATH + ("window_lut_q", "pcf_eval")
TEX_PATH = ("raster_tiles", "pack_shade_rows", "select_interp", "tile_tap_resolve", "shade_lights",
            "pcf_runs")
FULL_PATH = ("raster_tiles", "transpose_pack_rows", "select_interp", "tap_resolve", "shade_lights",
             "pcf_runs")
# Kernels with no caller in any frame, as in the JAX package.
NO_FRAME = ("pack_shade_rows_tm", "pcf_resolve")
# The deferred frame's kernels; the brute-force frame launches none.
DEFERRED_PATH = ("raster_tiles", "pcf_runs", "shade_lights")
# The opt-in rig of the entry phases: the parity red point light and a
# spotlight over the Cornell boxes aimed down (tests/test_spotlights.py:29-30);
# the spotlight added to the real-size rig.
POINT = ((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))
SPOT = ((0.0, 6.0, -5.0), (120.0, 120.0, 120.0), ((0.0, -1.0, 0.0), 20.0, 35.0))
REAL_SPOT = ((0.0, 8.0, 0.0), (200.0, 200.0, 200.0), ((0.0, -1.0, 0.0), 20.0, 35.0))
# The deferred real-size frames' share of pixels within 1 LSB of the
# default path's frame at the same viewpoint.
DEFERRED_NEAR_SHARE = 0.99
# The per-slot and unmerged routes' kernels (no K6, no K9); the ray-traced
# frame's kernels (K14 traces, K15 lights).
PER_SLOT_PATH = ("raster_tiles", "pack_shade_rows", "select_interp", "shade_lights", "pcf_runs")
RT_PATH = ("bvh_trace", "shade_lights")
# 3k: tests/test_tex_groups.py's six materials at 128 x 128 in groups of
# at most 220 tile rows, laid out as three explicit groups.
GROUPED_SIZE = 128
GROUPED_BUDGET = 220 * 512
GROUPED_EXPLICIT = [[0, 5], [1, 4], [2, 3]]
# 4j: the grouped caps' headroom over the measured rows (bench.py's).
TEX_GROUP_MARGIN = 1.1
# 4k: the lockstep plain version's work on every K14_SAMPLE-th real-size
# ray, scaled by K14_SAMPLE, gives K14's bound.
K14_SAMPLE = 64
# K15's f32 operations a pixel (ops/pbr.shade_lights_plain's, each division
# and square root one): wo and the ambient term, a GGX term, each point
# light's direction, falloff and accumulation, and its cone.
K15_PIXEL_OPS = 12 + 6 + 3
K15_TERM_OPS = 110
K15_LIGHT_OPS = 24
K15_CONE_OPS = 12
RT_AGREE_SHARE = 0.99
RT_CORE_AGREE_SHARE = 0.999
# 4l: 24 materials with 192^2 diffuse and metal-roughness maps and 96^2
# normal maps (24 x 192^2 = 884,736 texels, under the 1M tile threshold).
PER_SLOT_TEXTURE = 192
# 6b: render_frame_slabs_stats at tests/test_sharding.py's shapes (width,
# height, shadow size), each as this many slabs.
SLAB_SHAPES = ((128, 96, 128), (192, 136, 320))
SLAB_RANKS = (2, 3, 8)
# 6c: the real-size frame as this many slabs (17 camera tile rows -> 20,
# 63 shadow tile rows -> 64: the last rank's camera window is partial).
REAL_SLABS = 4
# 6d: at most this many cards, one NCCL rank each.
MULTI_CARD_RANKS = 4
# 6e: the viewer's pair-cap headroom over its first viewpoint (viewer.main's).
VIEWER_MARGIN = 4.0
# 7e: viewpoints of the lights16 cell's path, and the path's seed.
LIGHTS16_FRAMES = 10
LIGHTS16_SEED = 3_000_000_019
# K16's f32 operations a pixel, ops/shadow.pcf_runs_plain's counted once
# each (selects not counted): the set-up (u 2, v 3, the 5 outside
# compares, tx and ty 4, 2 floors, 2 subs to wx / wy, 2 to lx / ly), then
# _tap_count's 5 y offsets (add, floor, sub) and 25 taps of (add, floor,
# sub) for x and 3 lerps of 3, the compare and the count's add, then the
# division. A pixel outside the light frustum needs the set-up alone.
K16_SETUP_OPS = 20
K16_PIXEL_OPS = K16_SETUP_OPS + 5 * 3 + 25 * (3 + 9 + 2) + 1
# 7f: the eager traced lights16 frames: warm-up frames, profiled frames,
# and the ranges whose device time is read.
SPLIT_WARM = 2
SPLIT_FRAMES = 6
SPLIT_RANGES = ("shadow_pass", "forward_visibility", "pcf_shadow", "forward_shade_skybox",
                "pbr_lights", "sky_composite", "post_process")
# 7a: the entry scene at tests/test_torch_tiles.py's tiles (label: path,
# tile fields); each frame bit-equal to the path's 64 x 64 entry frame.
TILE_CASES = {
    "shadow 16x16": ("default", dict(shadow_tile=16)),
    "shadow 8h x 16w": ("default", dict(shadow_tile=16, shadow_tile_h=8)),
    "shadow 16h x 24w": ("default", dict(shadow_tile=24, shadow_tile_h=16)),
    "shadow 128x128": ("default", dict(shadow_tile=128)),
    "camera 8x16": ("default", dict(tile_h=8, tile_w=16)),
    "camera 1x128": ("default", dict(tile_h=1, tile_w=128)),
    "camera 128x128": ("default", dict(tile_h=128, tile_w=128)),
    "quantised, shadow 16h x 24w": ("quantised", dict(shadow_tile=24, shadow_tile_h=16)),
    "deferred, shadow 16h x 24w": ("deferred", dict(shadow_tile=24, shadow_tile_h=16)),
}
TILE_PATHS = {"default": ({}, DEFAULT_PATH), "quantised": (dict(pcf_row_cap=ENTRY_ROWS), QUANT_PATH),
              "deferred": (dict(fused_shade=False), DEFERRED_PATH)}
# 7b: real-size frame 0 at these tiles, each with its own tuned pair caps.
REAL_TILES = {"shadow 16x16": dict(shadow_tile=16), "shadow 32x32": dict(shadow_tile=32),
              "shadow 128x128": dict(shadow_tile=128), "camera 8x16": dict(tile_h=8, tile_w=16),
              "camera 128x128": dict(tile_h=128, tile_w=128)}
# 7c: the real-size frame 0 as this many slabs at 7b's shadow tile 32.
TILE_SLABS = 4
# 7d: the CLI's --config.
CLI_TILE_CONFIG = {"shadow_tile": 16}
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")


def log(msg: str) -> None:
    print(msg, flush=True)


def entry_scene(device, pcf_row_cap=None, textured=False, full_stack=False):
    """The entry configuration; ``textured`` forces the scene onto the tile
    atlas (tile_threshold_texels=0), ``full_stack`` drops the geometry's
    slot_static_rows (the full-stack shade-row route)."""
    from arctic_tpu_torch.core.config import RenderConfig
    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.io.procedural import cornell_like_scene

    w, h, s = ENTRY["width"], ENTRY["height"], ENTRY["shadow"]
    config = RenderConfig(width=w, height=h, shadow_size=s, pcf_row_cap=pcf_row_cap)
    scene = cornell_like_scene()
    bufs = build_buffers(*scene, tri_bucket=256, device=device,
                         tile_threshold_texels=0 if textured else None)
    if full_stack:
        bufs = full_stack_buffers(bufs)
    return (config, scene, bufs, *entry_params())


def full_stack_buffers(bufs):
    """The same scene buffers with a Geometry without slot_static_rows."""
    import dataclasses

    geom = dataclasses.replace(bufs.geometry, slot_static_rows=None)
    return dataclasses.replace(bufs, geometry=geom)


def golden_frame(scene, params, settings, config, lights=None):
    """The f64 oracle's frame; ``lights``: light rows with their cones (the
    params' point rows by default)."""
    import numpy as np

    from arctic_tpu_torch.models import golden

    meshes, objects, materials, env = scene
    cam = params.camera
    tris, mats = golden.golden_scene(meshes, objects, materials)
    if lights is None:
        lights = [
            (params.point_lights.position[i].tolist(), params.point_lights.color[i].tolist())
            for i in range(params.point_lights.count)
        ]
    return golden.render(
        tris, mats, env.astype(np.float64),
        dict(eye=cam.eye.tolist(), rotation=cam.rotation.tolist(), aspect=float(cam.aspect),
             fov_y=float(cam.fov_y), z_near=float(cam.z_near), z_far=float(cam.z_far)),
        dict(position=params.sun.position.tolist(), rotation=params.sun.rotation.tolist(),
             color=params.sun.color.tolist()),
        lights, ambient=float(params.ambient),
        settings=dict(tm_method=settings.tm_method, gamma=float(settings.gamma),
                      exposure=float(settings.exposure)),
        width=config.width, height=config.height, shadow_size=config.shadow_size,
    )


def check_launches(counts, path, label, absent=()):
    """Fail unless every kernel of ``path`` launched in the run just read,
    and none of ``absent`` did."""
    missing = [k for k in path if counts[k] < 1]
    if missing:
        raise RuntimeError(f"{label}: kernels of the path never launched: {missing} ({counts})")
    stray = [k for k in absent if counts[k] != 0]
    if stray:
        raise RuntimeError(f"{label}: kernels of another path launched: {stray} ({counts})")


def run_entry(device, oracle, pcf_row_cap=None, textured=False, default_img=None):
    """Entry frame on ``device`` (the quantised path with ``pcf_row_cap``,
    the tile atlas with ``textured``, the full-stack route with the default
    path's frame ``default_img`` to hold it to), held against the CPU frame
    and the f64 ``oracle`` frame; returns (img, recorded kernel calls)."""
    import numpy as np
    import torch

    from arctic_tpu_torch.models import golden, pipeline
    from arctic_tpu_torch.utils import kernels

    full = default_img is not None
    label = ("textured entry" if textured else "full-stack entry" if full
             else "entry" if pcf_row_cap is None else "quant entry")
    config, scene, bufs, params, settings = entry_scene(device, pcf_row_cap, textured, full)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(bufs, params, settings, config)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"{label} frame launches: {counts}")
    if textured:
        check_launches(counts, TEX_PATH, label, absent=("tap_resolve", "transpose_pack_rows"))
    elif full:
        check_launches(counts, FULL_PATH, label, absent=("pack_shade_rows", "tile_tap_resolve"))
    else:
        check_launches(counts, DEFAULT_PATH if pcf_row_cap is None else QUANT_PATH, label,
                       absent=("tile_tap_resolve", "transpose_pack_rows"))
    pipeline.check_stats(stats)
    img = img.cpu().numpy()

    cpu_bufs = entry_scene("cpu", pcf_row_cap, textured, full)[2]
    img_cpu, stats_cpu = pipeline.render_frame_stats(cpu_bufs, params, settings, config)
    img_cpu = img_cpu.numpy()
    diff = np.abs(img.astype(np.int32) - img_cpu.astype(np.int32))
    frac = float((diff > 0).mean())
    log(f"{label} frame vs port CPU frame: max {diff.max()} LSB on {frac:.4%} of pixels")
    if diff.max() > 1 or frac >= 0.01:
        raise RuntimeError(f"{label} frame differs from the CPU frame beyond 1 LSB / 1%")
    s_dev = {k: int(v) for k, v in stats.items()}
    s_cpu = {k: int(v) for k, v in stats_cpu.items()}
    log(f"{label} stats: {s_dev}; pcf_rows {s_dev['pcf_rows']} on the card, "
        f"{s_cpu['pcf_rows']} on the CPU")
    pairs = [k for k in s_dev if "pair" in k]
    if any(s_dev[k] != s_cpu[k] for k in pairs):
        raise RuntimeError(f"{label} pair stats differ from the CPU run: {s_cpu}")
    db = golden.psnr(img, oracle)
    log(f"{label} frame PSNR vs f64 golden oracle: {db:.2f} dB")
    if db < 40.0:
        raise RuntimeError(f"{label} frame PSNR {db:.2f} dB < 40 dB")
    if full:
        d = np.abs(img.astype(np.int32) - default_img.astype(np.int32))
        log(f"{label} frame vs the default entry frame: max {d.max()} LSB, "
            f"{int((d.max(axis=2) > 0).sum())} pixels differ")
        if d.max() > 1:
            raise RuntimeError(f"{label} frame differs from the default entry frame by > 1 LSB")
    os.makedirs(OUT_DIR, exist_ok=True)
    name = ("entry_tex" if textured else "entry_full" if full
            else "entry" if pcf_row_cap is None else "entry_quant")
    np.save(os.path.join(OUT_DIR, f"chip_smoke_{name}.npy"), img)
    return img, calls


def run_cli():
    """The CLI on the card: the Cornell entry scene exported to a GLB (its
    environment as an .hdr beside it, which load_scene_file finds), then
    ``cli.main(["render", glb, ...])`` at the entry size and camera with
    --frames 2 --stats on the default device. K1, K3, K4 and K6 must launch;
    both PNGs, decoded by io/images, must equal the port's in-process frame
    of the same loaded scene and config bit for bit, and be >= 40 dB
    against the f64 oracle of that scene."""
    import dataclasses

    import numpy as np
    import torch

    from arctic_tpu_torch.app import cli
    from arctic_tpu_torch.core.config import RenderConfig
    from arctic_tpu_torch.core.scene import default_scene_params, default_settings, make_camera
    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.io.gltf_export import save_glb
    from arctic_tpu_torch.io.images import load_ldr, save_hdr
    from arctic_tpu_torch.io.load import load_scene_file
    from arctic_tpu_torch.io.procedural import cornell_like_scene
    from arctic_tpu_torch.models import golden, pipeline
    from arctic_tpu_torch.utils import kernels

    w, h, s = ENTRY["width"], ENTRY["height"], ENTRY["shadow"]
    folder = os.path.join(OUT_DIR, "cli")
    os.makedirs(folder, exist_ok=True)
    meshes, objects, materials, env = cornell_like_scene()
    glb, out = os.path.join(folder, "cornell.glb"), os.path.join(folder, "frame.png")
    save_glb(glb, meshes, objects, materials)
    save_hdr(os.path.join(folder, "env.hdr"), env)
    cam = ",".join(str(v) for v in ENTRY["eye"] + ENTRY["rot"])
    kernels.reset_launch_counts()
    t = time.perf_counter()
    rc = cli.main(["render", glb, "--width", str(w), "--height", str(h), "--shadow-size",
                   str(s), f"--camera={cam}", "--frames", "2", "--stats", "--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    log(f"cli render (rc {rc}, {wall:.2f} s with the scene load and build) launches: {counts}")
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    check_launches(counts, DEFAULT_PATH, "cli", absent=("tile_tap_resolve", "transpose_pack_rows"))

    scene = load_scene_file(glb)
    bufs = build_buffers(*scene, device="cuda")
    params = default_scene_params(aspect=w / h)
    params.camera = make_camera(ENTRY["eye"], ENTRY["rot"], w / h)
    settings = default_settings()
    config = pipeline.autotune_pair_caps(bufs, params, RenderConfig(width=w, height=h, shadow_size=s))
    config = dataclasses.replace(config, static_point_lights=params.point_lights.count)
    img, stats = pipeline.make_renderer_stats(config)(bufs, params, settings)
    pipeline.check_stats(stats)
    img = img.cpu().numpy()
    for i in range(2):
        png = load_ldr(out.replace(".png", f"_{i:04d}.png"))[..., :3]
        if not np.array_equal(png, img):
            d = np.abs(png.astype(np.int32) - img.astype(np.int32))
            raise RuntimeError(f"the CLI's frame {i} differs from the in-process frame: max "
                               f"{d.max()} LSB on {int((d.max(axis=2) > 0).sum())} pixels")
    t = time.perf_counter()
    db = golden.psnr(img, golden_frame(scene, params, settings, config))
    log(f"cli frames: both PNGs bit-equal to the in-process frame of the loaded GLB; "
        f"{db:.2f} dB vs its f64 oracle ({time.perf_counter() - t:.1f} s)")
    if db < 40.0:
        raise RuntimeError(f"the CLI's frame PSNR {db:.2f} dB < 40 dB")
    return glb, img


def run_cli_devices(glb, want, world: int) -> None:
    """6a / 6d: the CLI's ``--devices N`` on cuda at the entry size and
    camera on run_cli's GLB: N spawned ranks over NCCL (rank r on cuda:r),
    each tuning the pair caps on its card; rank 0's PNG, decoded by
    io/images, bit-equal to run_cli's in-process frame (``want``)."""
    from arctic_tpu_torch.app import cli
    from arctic_tpu_torch.io.images import load_ldr

    w, h, s = ENTRY["width"], ENTRY["height"], ENTRY["shadow"]
    out = os.path.join(OUT_DIR, "cli", f"devices{world}.png")
    cam = ",".join(str(v) for v in ENTRY["eye"] + ENTRY["rot"])
    label = f"CLI --devices {world} on cuda"
    t = time.perf_counter()
    rc = cli.main(["render", glb, "--width", str(w), "--height", str(h), "--shadow-size",
                   str(s), f"--camera={cam}", "--devices", str(world), "--out", out])
    if rc != 0:
        raise RuntimeError(f"{label}: the CLI returned {rc}")
    same_frame(load_ldr(out)[..., :3], want, label, "the in-process frame of the loaded GLB")
    log(f"{label}: rank 0's PNG bit-equal to the in-process frame of the loaded GLB "
        f"({time.perf_counter() - t:.1f} s with the processes' start)")


def lsb_gate(img, ref, label: str, what: str) -> None:
    """Fail unless ``img`` is within 1 u8 LSB of ``ref`` on < 1% of its
    channel values (the JAX package's fused-vs-brute-force bound)."""
    import numpy as np

    d = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    frac = float((d > 0).mean())
    log(f"{label} frame vs {what}: max {d.max()} LSB on {frac:.4%} of values")
    if d.max() > 1 or frac >= 0.01:
        raise RuntimeError(f"{label} frame differs from {what} beyond 1 LSB / 1%")


def entry_frame(config, params=None, label="", path=None, absent=None):
    """The entry scene on the card with ``config`` (and ``params``), launch
    counts zeroed right before and read right after: every kernel of
    ``path`` must launch and none of ``absent`` (default: every other
    kernel). Returns (img on the host, stats, counts, scene, bufs, params,
    settings)."""
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    _, scene, bufs, entry_params, settings = entry_scene("cuda")
    params = params or entry_params
    kernels.reset_launch_counts()
    img, stats = pipeline.render_frame_stats(bufs, params, settings, config)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"{label} frame launches: {counts}")
    if absent is None:
        absent = tuple(k for k in counts if k not in path)
    check_launches(counts, path, label, absent)
    pipeline.check_stats(stats)
    return img.cpu().numpy(), stats, counts, scene, bufs, params, settings


def run_entry_bruteforce(oracle, default_img):
    """3f: the entry frame with force_bruteforce on the card: no kernel
    launches; within 1 LSB of the port's CPU brute-force frame and of the
    default entry frame on < 1%, >= 40 dB against the f64 oracle. Returns
    the frame."""
    import dataclasses

    import numpy as np

    from arctic_tpu_torch.models import golden, pipeline

    label = "brute-force entry"
    config = dataclasses.replace(entry_scene("cpu")[0], force_bruteforce=True)
    img, stats, _, _, _, params, settings = entry_frame(config, label=label, path=())
    s = {k: int(v) for k, v in stats.items()}
    if s["cam_pair_cap"] != 1 or s["cam_pairs"] != 0:
        raise RuntimeError(f"{label} stats report a pair buffer: {s}")
    img_cpu, _ = pipeline.render_frame_stats(entry_scene("cpu")[2], params, settings, config)
    lsb_gate(img, img_cpu.numpy(), label, "the port's CPU frame")
    db = golden.psnr(img, oracle)
    log(f"{label} frame PSNR vs f64 golden oracle: {db:.2f} dB")
    if db < 40.0:
        raise RuntimeError(f"{label} frame PSNR {db:.2f} dB < 40 dB")
    lsb_gate(img, default_img, label, "the default entry frame")
    np.save(os.path.join(OUT_DIR, "chip_smoke_entry_bruteforce.npy"), img)
    return img


def run_entry_deferred(bf_img):
    """3g: the entry frame with fused_shade=False: K1 twice (shadow and
    camera pass), K15 once (its lights) and no other kernel; its visibility buffer equal to the
    brute-force one on the same setup (tiled == brute force), its frame
    within 1 LSB of the brute-force frame."""
    import dataclasses

    import numpy as np
    import torch

    from arctic_tpu_torch.models import pipeline

    label = "deferred entry"
    config = dataclasses.replace(entry_scene("cpu")[0], fused_shade=False)
    img, _, counts, _, bufs, params, _ = entry_frame(config, label=label, path=DEFERRED_PATH)
    if counts["raster_tiles"] != 2:
        raise RuntimeError(f"{label}: K1 launched {counts['raster_tiles']} times, not 2")
    lsb_gate(img, bf_img, label, "the brute-force entry frame")
    geom = bufs.geometry
    tri_valid = torch.arange(geom.capacity, device=bufs.device) < geom.num_tris
    setup = pipeline.camera_setup(pipeline.world_corners(geom), tri_valid,
                                  params.camera.proj_view(), config)
    h, w = config.height, config.width
    tiled = pipeline.rasterize(setup, h, w, config)[1]
    brute = pipeline.rasterize(setup, h, w, dataclasses.replace(config, force_bruteforce=True))[1]
    covered = float((brute >= 0).float().mean())
    log(f"{label} ibuf: K1's equal to the brute-force raster's: {torch.equal(tiled, brute)} "
        f"({covered:.2%} of pixels covered)")
    if not torch.equal(tiled, brute):
        raise RuntimeError(f"{label}: K1's ibuf differs from the brute-force raster's")
    np.save(os.path.join(OUT_DIR, "chip_smoke_entry_deferred.npy"), img)


def with_shadow_factors(fn):
    """Call ``fn()`` with the kernel wrappers' calls recorded; returns (its
    result, the sun shadow factors of the one frame it rendered, on the
    host, cropped by the caller): K16 pcf_runs (the runs PCF of the fused
    and the deferred frame) again on the frame's recorded inputs."""
    from arctic_tpu_torch.ops import shadow
    from arctic_tpu_torch.utils import kernels

    with kernels.record_calls() as calls:
        result = fn()
    (args, kw), = calls["pcf_runs"]
    return result, shadow.pcf_runs(*args, **kw).cpu().numpy()


# A pixel where the fused and deferred PCF factors differ by one tap may
# differ by up to this many LSB, on at most TAP_FLIP_SHARE of the pixels.
TAP_FLIP_LSB = 3
TAP_FLIP_SHARE = 1e-4


def tap_flip_gate(fused, deferred, label: str) -> None:
    """The fused and deferred frames, each (img, shadow factors): within 1
    LSB on < 1% of their values, except at pixels where the two PCF shadow
    factors differ by one tap of 25, which may differ by up to TAP_FLIP_LSB
    on at most TAP_FLIP_SHARE of the pixels. The fused frame interpolates
    the light-space position per corner, the deferred frame projects the
    interpolated world position, so a window texel at a depth edge can
    compare the other way; under the spotlight's 120-unit radiance one tap
    (1/25 of lit) moves a pixel by more than 1 LSB."""
    import numpy as np

    (img_f, sf_f), (img_d, sf_d) = fused, deferred
    h, w = img_f.shape[:2]
    taps = np.abs(sf_f[:h, :w] - sf_d[:h, :w]) * 25.0
    one_tap = (taps > 0.0) & (taps < 1.0 + 1e-4)
    d = np.abs(img_f.astype(np.int32) - img_d.astype(np.int32))
    over = d.max(axis=2) > 1
    frac = float((d > 0).mean())
    over_share = float(over.mean())
    log(f"{label} frame vs the deferred frame: max {d.max()} LSB on {frac:.4%} of values; "
        f"{int(over.sum())} pixels over 1 LSB ({over_share:.4%}), {int((over & one_tap).sum())} "
        f"of them where the two PCF factors differ by one tap ({int(one_tap.sum())} such pixels)")
    if frac >= 0.01 or (over & ~one_tap).any():
        raise RuntimeError(f"{label} frame differs from the deferred frame beyond 1 LSB / 1% "
                           f"where their shadow factors agree")
    if d.max() > TAP_FLIP_LSB or over_share > TAP_FLIP_SHARE:
        raise RuntimeError(f"{label} frame differs from the deferred frame by more than "
                           f"{TAP_FLIP_LSB} LSB, or by more than 1 LSB on more than "
                           f"{TAP_FLIP_SHARE:.4%} of its pixels, where one PCF tap flips")


def run_entry_optins():
    """3h: Cornell with the point light and the spotlight, spotlights=True,
    fused and deferred, then the same with ibl_specular=True: each pair
    within 1 LSB on < 1% of its values where their PCF factors agree, at
    most TAP_FLIP_LSB on at most TAP_FLIP_SHARE of the pixels where one tap
    flips (tap_flip_gate); the fused spot frame >= 40 dB against the f64 oracle
    with the cone; the IBL frame > 2 LSB from the frame without it
    somewhere."""
    import dataclasses

    import numpy as np

    from arctic_tpu_torch.core.scene import PointLights
    from arctic_tpu_torch.models import golden

    base, scene, _, params, settings = entry_scene("cpu")
    params.point_lights = PointLights.from_list([POINT, SPOT], spots=True)
    frames = {}
    for ibl in (False, True):
        name = f"spot{' + IBL' if ibl else ''} entry"
        for fused in (True, False):
            config = dataclasses.replace(base, spotlights=True, ibl_specular=ibl,
                                         fused_shade=fused)
            path = DEFAULT_PATH if fused else DEFERRED_PATH
            absent = ("tile_tap_resolve", "transpose_pack_rows") if fused else None
            out, factors = with_shadow_factors(lambda: entry_frame(
                config, params, f"{'fused' if fused else 'deferred'} {name}", path, absent))
            frames[fused, ibl] = out[0], factors
        tap_flip_gate(frames[True, ibl], frames[False, ibl], f"fused {name}")
    spot = frames[True, False][0]
    db = golden.psnr(spot, golden_frame(scene, params, settings, base, lights=[POINT, SPOT]))
    log(f"fused spot entry frame PSNR vs the f64 oracle with the cone: {db:.2f} dB")
    if db < 40.0:
        raise RuntimeError(f"the spot entry frame PSNR {db:.2f} dB < 40 dB")
    d = np.abs(frames[True, True][0].astype(np.int32) - spot.astype(np.int32))
    log(f"IBL moves the fused spot entry frame by up to {d.max()} LSB "
        f"({int((d.max(axis=2) > 0).sum())} pixels)")
    if d.max() <= 2:
        raise RuntimeError("ibl_specular=True did not change the entry frame")


def run_cli_flags():
    """The CLI's --bruteforce, and its --ibl with a --spot, on the card at the
    entry size on the GLB run_cli wrote: each PNG bit-equal to the
    in-process frame of the config the flags ask for; the brute-force run
    launches no kernel, the other K1, K3, K4 and K6."""
    import dataclasses

    import numpy as np
    import torch

    from arctic_tpu_torch.app import cli
    from arctic_tpu_torch.core.config import RenderConfig
    from arctic_tpu_torch.core.scene import (
        PointLights, default_scene_params, default_settings, make_camera,
    )
    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.io.images import load_ldr
    from arctic_tpu_torch.io.load import load_scene_file
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    w, h, s = ENTRY["width"], ENTRY["height"], ENTRY["shadow"]
    folder = os.path.join(OUT_DIR, "cli")
    glb = os.path.join(folder, "cornell.glb")
    cam = ",".join(str(v) for v in ENTRY["eye"] + ENTRY["rot"])
    (pos, col, (axis, inner, outer)) = SPOT
    spot = ",".join(str(v) for v in (*pos, *col, *axis, inner, outer))
    bufs = build_buffers(*load_scene_file(glb), device="cuda")
    for name, flags in (("bruteforce", ["--bruteforce"]), ("ibl_spot", ["--ibl", "--spot", spot])):
        out = os.path.join(folder, f"{name}.png")
        kernels.reset_launch_counts()
        rc = cli.main(["render", glb, "--width", str(w), "--height", str(h), "--shadow-size",
                       str(s), f"--camera={cam}", "--out", out] + flags)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        log(f"cli render {' '.join(flags)} (rc {rc}) launches: {counts}")
        if rc != 0:
            raise RuntimeError(f"the CLI returned {rc}")
        params = default_scene_params(aspect=w / h)
        params.camera = make_camera(ENTRY["eye"], ENTRY["rot"], w / h)
        config = RenderConfig(width=w, height=h, shadow_size=s)
        if name == "bruteforce":
            check_launches(counts, (), f"cli {name}", absent=tuple(counts))
            config = dataclasses.replace(config, force_bruteforce=True)
        else:
            check_launches(counts, DEFAULT_PATH, f"cli {name}",
                           absent=("tile_tap_resolve", "transpose_pack_rows"))
            pl = params.point_lights
            rows = [(pl.position[i].tolist(), pl.color[i].tolist()) for i in range(pl.count)]
            params.point_lights = PointLights.from_list(rows + [SPOT], spots=True)
            config = pipeline.autotune_pair_caps(
                bufs, params, dataclasses.replace(config, ibl_specular=True))
            config = dataclasses.replace(config, spotlights=True,
                                         static_point_lights=params.point_lights.count)
        img, stats = pipeline.render_frame_stats(bufs, params, default_settings(), config)
        pipeline.check_stats(stats)
        img = img.cpu().numpy()
        png = load_ldr(out)[..., :3]
        if not np.array_equal(png, img):
            d = np.abs(png.astype(np.int32) - img.astype(np.int32))
            raise RuntimeError(f"the CLI's {name} frame differs from the in-process frame: "
                               f"max {d.max()} LSB on {int((d.max(axis=2) > 0).sum())} pixels")
        log(f"cli {name} frame: the PNG is bit-equal to the in-process frame")


def real_params(i: int):
    import torch

    from arctic_tpu_torch.core.scene import (
        TM_ACES, PointLights, Settings, default_scene_params, make_camera,
    )

    def _f32(x):
        return torch.tensor(x, dtype=torch.float32)

    w, h = REAL["width"], REAL["height"]
    params = default_scene_params(aspect=w / h)
    params.camera = make_camera(
        [REAL_EYE[0] + 0.25 * i, REAL_EYE[1], REAL_EYE[2]], [REAL_ROT[0], 0.3 * i], w / h
    )  # bench.py:225-241 fly-through step i
    params.sun.position = _f32(REAL_SUN["position"])
    params.sun.rotation = _f32(REAL_SUN["rotation"])
    params.point_lights = PointLights.from_list(REAL_LIGHTS)
    return params, Settings(tm_method=TM_ACES, gamma=_f32(2.2), exposure=_f32(1.0))


def real_config():
    """The real-size config with the pair caps of the RenderConfig formula."""
    from arctic_tpu_torch.core.config import RenderConfig

    return RenderConfig(
        width=REAL["width"], height=REAL["height"], shadow_size=REAL["shadow"],
        static_point_lights=4,
    )


def tune_caps(bufs, label: str, **fields):
    """real_config() (with ``fields`` replaced) with the pair caps
    autotune_pair_caps gives over bench.py's 20 viewpoints
    (bench.py:448-453); prints them beside the formula's."""
    import dataclasses

    import torch

    from arctic_tpu_torch.models import pipeline

    formula = dataclasses.replace(real_config(), **fields)
    path = [real_params(i)[0] for i in range(BENCH_FRAMES)]
    t = time.perf_counter()
    tuned = pipeline.autotune_pair_caps(bufs, path, formula, margin=PAIR_MARGIN)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    cam, sh = pipeline.measure_pair_counts(bufs, path, formula)
    slots = 2 * bufs.geometry.capacity
    log(f"{label} pair caps over {BENCH_FRAMES} viewpoints (autotune {ms:.1f} ms): "
        f"max pairs cam {cam}, shadow {sh}; caps cam {formula.pair_capacity(slots, 'cam')} "
        f"(formula) -> {tuned.pair_capacity(slots, 'cam')}, shadow "
        f"{formula.pair_capacity(slots, 'shadow')} -> {tuned.pair_capacity(slots, 'shadow')}")
    return tuned


def real_buffers(device, textured=False):
    """The Sponza-class scene on ``device``. The default one takes bench.py's
    asset path (bench.py:309-325): written with the port's save_glb and
    save_hdr into build/chip_smoke/ and loaded back with load_scene_file,
    its triangle count held to the direct scene's. ``textured``: with 24
    materials of three 1024^2 maps (bench.py's textured_scene), on the tile
    atlas, built directly, as bench.py builds it."""
    import torch

    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.io.procedural import sponza_like_scene

    t0 = time.perf_counter()
    scene = sponza_like_scene(texture_size=1024, n_materials=24) if textured else sponza_like_scene()
    t1 = time.perf_counter()
    if not textured:
        scene = asset_round_trip(scene)
        t1 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    bufs = build_buffers(*scene, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    label = "textured real-size" if textured else "real-size"
    g = bufs.geometry
    log(f"{label} scene: {g.num_tris} tris, capacity {g.capacity}; "
        f"generated{'' if textured else ' and round-tripped'} in {t1 - t0:.1f} s, built in "
        f"{t2 - t1:.1f} s; {torch.cuda.memory_allocated() - before} B on the card, "
        f"slot_static_rows {g.slot_static_rows.numel() * 4} B of it (tri_static_attrs and "
        f"tri_matrow are views of it)")
    if textured:
        tiles = bufs.atlas.tiles
        if tiles is None:
            raise RuntimeError("the textured scene did not take the tile atlas")
        log(f"{label} tile atlas: {tiles.shape[0]} rows, {tiles.numel() * 4} B, "
            f"{len(bufs.atlas.tile_groups)} groups, env copy {bufs.environment.num_rows} rows")
    return bufs


def asset_round_trip(scene):
    """bench.py's asset path: the scene written as a GLB and its
    environment as a Radiance .hdr into build/chip_smoke/, and loaded back
    with load_scene_file(glb, env_path=hdr). The loaded scene must hold as
    many triangles as the direct one (bench.py:320-324); the loader's stack
    walk reverses the object order, and the environment comes back
    RGBE-quantised."""
    from arctic_tpu_torch.io.gltf_export import save_glb
    from arctic_tpu_torch.io.images import save_hdr
    from arctic_tpu_torch.io.load import load_scene_file

    meshes, objects, materials, env = scene
    os.makedirs(OUT_DIR, exist_ok=True)
    glb, hdr = os.path.join(OUT_DIR, "sponza_class.glb"), os.path.join(OUT_DIR, "env.hdr")
    t0 = time.perf_counter()
    save_glb(glb, meshes, objects, materials)
    save_hdr(hdr, env)
    t1 = time.perf_counter()
    loaded = load_scene_file(glb, env_path=hdr)
    t2 = time.perf_counter()
    n_direct = sum(len(m.indices) for m in meshes)
    n_loaded = sum(len(m.indices) for m in loaded[0])
    log(f"asset path: wrote {os.path.getsize(glb)} B of GLB and {os.path.getsize(hdr)} B of "
        f"HDR in {t1 - t0:.3f} s, loaded in {t2 - t1:.3f} s: {n_loaded} mesh tris "
        f"({n_direct} direct), {len(loaded[1])} objects ({len(objects)} direct)")
    if n_loaded != n_direct or len(loaded[1]) != len(objects):
        raise RuntimeError(f"the GLB round trip changed the scene: {n_loaded} tris / "
                           f"{len(loaded[1])} objects, {n_direct} / {len(objects)} direct")
    return loaded


def read_golden(name: str):
    """(H, W, 3) u8 of docs/images/<name>, decoded by the port's io/images
    (zlib and numpy: the card's machine has no Pillow)."""
    from arctic_tpu_torch.io.images import load_ldr

    return load_ldr(os.path.join(REPO, "docs", "images", name))[..., :3]


def golden_compare(img, name: str) -> dict:
    """A u8 frame against docs/images/<name>: the whole-frame PSNR
    (bench.py's check_golden), the share of pixels whose channels all lie
    within GOLDEN_NEAR_LSB of the golden, and the PSNR over those pixels."""
    import numpy as np

    from arctic_tpu_torch.models import golden

    gold = read_golden(name)
    if gold.shape != img.shape:
        raise RuntimeError(f"frame shape {img.shape} != golden {name} {gold.shape}")
    near = np.abs(img.astype(np.int32) - gold.astype(np.int32)).max(axis=2) <= GOLDEN_NEAR_LSB
    return dict(db=golden.psnr(img, gold), near=float(near.mean()),
                near_db=golden.psnr(img[near], gold[near]))


def depth_probe(render, bufs, last, name: str, eps: float = 1e-4) -> float:
    """Share of the pixels more than GOLDEN_NEAR_LSB from docs/images/<name>
    that lie within one pixel of a pixel that changes when frame 19 is
    rendered again with z_near moved by -+eps (relative): a change of the
    depths alone (x, y and w of the clip coordinates do not depend on
    z_near), so the pixels that change are those whose surface is decided by
    a near tie of depths."""
    import numpy as np
    import torch

    gold = read_golden(name)
    far = np.abs(last.astype(np.int32) - gold.astype(np.int32)).max(axis=2) > GOLDEN_NEAR_LSB
    flips = np.zeros(far.shape, bool)
    for sign in (-1.0, 1.0):
        params, settings = real_params(BENCH_FRAMES - 1)
        params.camera.z_near = torch.tensor(float(params.camera.z_near) * (1.0 + sign * eps),
                                            dtype=torch.float32)
        img, _ = render(bufs, params, settings)
        flips |= (img.cpu().numpy() != last).any(axis=2)
    near_flip = flips.copy()
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        near_flip |= np.roll(flips, (dy, dx), axis=(0, 1))
    return float(near_flip[far].mean()) if far.any() else 1.0


def last_bench_frame(render, bufs, *extra):
    """bench.py's golden frame: fly-through viewpoint 19, on the host."""
    import torch

    from arctic_tpu_torch.models import pipeline

    img, stats = render(bufs, *real_params(BENCH_FRAMES - 1), *extra)
    torch.cuda.synchronize()
    pipeline.check_stats(stats)
    return img.cpu().numpy()


def fly_through(render, bufs, frames, path, label, *extra, absent=()):
    """Time ``render`` over the frames with the launch counts zeroed right
    before and read right after (every kernel of ``path`` must launch, none
    of ``absent``); returns (ms list, stats list, frames on the host, launch
    counts, (peak bytes, bytes already allocated before the frames: the
    script's own retained tensors, not the path's))."""
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    front = getattr(render, "front", None)
    replays = front.replays if front is not None else 0
    kernels.reset_launch_counts()
    times, all_stats, imgs = [], [], []
    for params, settings in frames:
        t = time.perf_counter()
        img, stats = render(bufs, params, settings, *extra)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        all_stats.append(stats)
        imgs.append(img)
    counts = with_replays(kernels.launch_counts(), front, replays, label)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} launches over {len(frames)} frames: {counts}")
    check_launches(counts, path, label, absent)
    for st in all_stats:
        if st is not None:  # the ray-traced frame has no capacities to check
            pipeline.check_stats(st)
    return times, all_stats, [im.cpu().numpy() for im in imgs], counts, (peak, resident)


def with_replays(counts, front, replays_before: int, label: str) -> dict:
    """Launch counts of a run: the wrappers' ``counts`` plus, where the
    frames went through a CachedFront (``front``), its graph's replays
    since ``replays_before`` times the launches its capture recorded (a
    replay calls no wrapper; the capture's own replay is counted by the
    wrappers), both logged."""
    if front is None or front.replays == replays_before:
        return counts
    n = front.replays - replays_before
    log(f"{label}: wrapper launches {counts}; {n} graph replays x captured {front.captured}")
    return {k: c + n * front.captured.get(k, 0) for k, c in counts.items()}


def _mem(mem) -> str:
    peak, resident = mem
    return (f"peak memory {peak} B ({resident} B allocated before the frames, "
            f"{peak - resident} B above that)")


def run_real(device, bufs, config, profile: bool = False):
    """Real-size fly-through on the default path, then frame 19 gated
    against bench_golden.png; returns (summary dict, recorded
    kernel calls, launch counts of the timed frames, the frames on the
    host)."""
    import numpy as np
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    render = pipeline.make_renderer_stats(config, device)

    params, settings = real_params(0)
    with kernels.record_calls() as calls:  # warm-up frame; its inputs feed phase 5
        img, stats = render(bufs, params, settings)
        torch.cuda.synchronize()
    pipeline.check_stats(stats)

    frames = [real_params(i) for i in range(FLY_FRAMES)]
    times, all_stats, imgs, counts, mem = fly_through(
        render, bufs, frames, DEFAULT_PATH, "real-size",
        absent=("tile_tap_resolve", "transpose_pack_rows"),
    )
    s = {k: int(v) for k, v in all_stats[-1].items()}
    if profile:
        profile_frames(render, bufs, frames[:2], "default")
    frame = imgs[-1]
    if frame.shape != (REAL["height"], REAL["width"], 3) or frame.mean() < 5.0:
        raise RuntimeError(f"real-size frame is wrong: shape {frame.shape}, mean {frame.mean():.2f}")
    np.save(os.path.join(OUT_DIR, "chip_smoke_real.npy"), frame)
    summary = dict(
        ms_per_frame_median=statistics.median(times), ms_per_frame=times,
        max_memory_allocated=mem[0], stats=s, frame_mean=float(frame.mean()),
    )
    log(f"real-size frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), {_mem(mem)}, stats {s}")
    last = last_bench_frame(render, bufs)
    np.save(os.path.join(OUT_DIR, "chip_smoke_real_19.npy"), last)
    g = summary["golden"] = golden_compare(last, "bench_golden.png")
    g["depth_tied"] = depth_probe(render, bufs, last, "bench_golden.png")
    log(f"real-size frame 19 (the GLB round trip's scene, as bench.py made the golden) vs "
        f"bench_golden.png: {g['db']:.2f} dB whole frame; {g['near']:.4%} of pixels within "
        f"{GOLDEN_NEAR_LSB} LSB, {g['near_db']:.2f} dB over them (gate: >= "
        f"{GOLDEN_NEAR_SHARE:.0%} and >= {GOLDEN_MIN_DB} dB); of the pixels further off, "
        f"{g['depth_tied']:.2%} lie within 1 px of a pixel that a 1e-4 relative move of "
        f"z_near changes")
    if g["near"] < GOLDEN_NEAR_SHARE or g["near_db"] < GOLDEN_MIN_DB:
        raise RuntimeError(f"default frame 19 fails its golden gate: {g}")
    return summary, calls, counts, imgs


def run_full_stack(device, bufs, config, default_imgs, profile: bool = False):
    """The full-stack shade-row route at real size: the default scene and
    config with the geometry's slot_static_rows dropped, the fly-through
    (K10 once a frame, K3 never), each frame within 1 LSB of the default
    path's frame at the same viewpoint. Returns (summary, recorded calls of
    the warm-up frame, launch counts of the fly-through)."""
    import numpy as np
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    before = torch.cuda.memory_allocated()
    full = full_stack_buffers(bufs)
    log(f"full-stack geometry: tri-major planes copied out of slot_static_rows, "
        f"{torch.cuda.memory_allocated() - before} B on the card")
    render = pipeline.make_renderer_stats(config, device)
    params, settings = real_params(0)
    with kernels.record_calls() as calls:  # warm-up frame; its inputs feed phase 5
        img, stats = render(full, params, settings)
        torch.cuda.synchronize()
    pipeline.check_stats(stats)

    frames = [real_params(i) for i in range(FLY_FRAMES)]
    times, all_stats, imgs, counts, mem = fly_through(
        render, full, frames, FULL_PATH, "full-stack real-size",
        absent=("pack_shade_rows", "tile_tap_resolve"),
    )
    if counts["transpose_pack_rows"] != len(frames):
        raise RuntimeError(f"K10 launched {counts['transpose_pack_rows']} times in "
                           f"{len(frames)} frames")
    if profile:
        profile_frames(render, full, frames[:2], "full_stack")
    diffs = []
    for im, ref in zip(imgs, default_imgs):
        d = np.abs(im.astype(np.int32) - ref.astype(np.int32))
        diffs.append((int(d.max()), int((d.max(axis=2) > 0).sum())))
    log(f"full-stack vs default real-size frames: (max LSB, pixels that differ) {diffs}")
    if max(m for m, _ in diffs) > 1:
        raise RuntimeError("a full-stack frame differs from the default path's by more than 1 LSB")
    summary = dict(ms_per_frame_median=statistics.median(times), ms_per_frame=times,
                   max_memory_allocated=mem[0], diffs=diffs,
                   stats={k: int(v) for k, v in all_stats[-1].items()})
    log(f"full-stack real-size frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), {_mem(mem)}, stats {summary['stats']}")
    return summary, calls, counts


def run_real_deferred(device, bufs, default_imgs, profile: bool = False):
    """4h: the deferred frame at real size: the default config with
    fused_shade=False and pair caps tuned for it (the shadow pass uncull'd),
    the fly-through (K1 twice and K15 once a frame, no other kernel), each frame not
    black and within 1 LSB of the default path's frame at the same
    viewpoint on >= DEFERRED_NEAR_SHARE of its pixels, frame 19 gated
    against bench_golden.png by the default path's rule. Returns (summary,
    config)."""
    import numpy as np
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    label = "deferred real-size"
    config = tune_caps(bufs, label, fused_shade=False)
    render = pipeline.make_renderer_stats(config, device)
    img, stats = render(bufs, *real_params(0))  # warm-up
    torch.cuda.synchronize()
    pipeline.check_stats(stats)
    frames = [real_params(i) for i in range(FLY_FRAMES)]
    absent = tuple(k for k in kernels.launch_counts() if k not in DEFERRED_PATH)
    times, all_stats, imgs, counts, mem = fly_through(
        render, bufs, frames, DEFERRED_PATH, label, absent=absent)
    if counts["raster_tiles"] != 2 * len(frames):
        raise RuntimeError(f"K1 launched {counts['raster_tiles']} times in {len(frames)} frames")
    if profile:
        profile_frames(render, bufs, frames[:2], "deferred")
    shares = []
    for im, ref in zip(imgs, default_imgs):
        if im.shape != (REAL["height"], REAL["width"], 3) or im.mean() < 5.0:
            raise RuntimeError(f"{label} frame is wrong: shape {im.shape}, mean {im.mean():.2f}")
        d = np.abs(im.astype(np.int32) - ref.astype(np.int32)).max(axis=2)
        shares.append((float((d <= 1).mean()), int(d.max())))
    log(f"{label} vs default frames: (share of pixels within 1 LSB, max LSB) {shares}")
    if min(sh for sh, _ in shares) < DEFERRED_NEAR_SHARE:
        raise RuntimeError(f"a {label} frame is within 1 LSB of the default frame on < "
                           f"{DEFERRED_NEAR_SHARE:.0%} of its pixels")
    np.save(os.path.join(OUT_DIR, "chip_smoke_real_deferred.npy"), imgs[-1])
    summary = dict(ms_per_frame_median=statistics.median(times), ms_per_frame=times,
                   max_memory_allocated=mem[0], shares=shares,
                   stats={k: int(v) for k, v in all_stats[-1].items()})
    log(f"{label} frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), {_mem(mem)}, stats {summary['stats']}")
    last = last_bench_frame(render, bufs)
    g = golden_compare(last, "bench_golden.png")
    log(f"{label} frame 19 vs bench_golden.png: {g['db']:.2f} dB whole frame; {g['near']:.4%} "
        f"of pixels within {GOLDEN_NEAR_LSB} LSB, {g['near_db']:.2f} dB over them")
    if g["near"] < GOLDEN_NEAR_SHARE or g["near_db"] < GOLDEN_MIN_DB:
        raise RuntimeError(f"deferred frame 19 fails its golden gate: {g}")
    return summary, config


def optin_params(i: int):
    """Fly-through step i with the bench rig plus REAL_SPOT as cone rows."""
    from arctic_tpu_torch.core.scene import PointLights

    params, settings = real_params(i)
    params.point_lights = PointLights.from_list(REAL_LIGHTS + [REAL_SPOT], spots=True)
    return params, settings


def run_real_optins(device, bufs, config, deferred_config, profile: bool = False):
    """4i: the opt-ins at real size on the default (fused) path:
    ibl_specular and spotlights, the bench rig plus REAL_SPOT, the
    fly-through (K1, K3, K4 and K6 launched); frame 0 within 1 LSB of the
    deferred frame with the same options on >= DEFERRED_NEAR_SHARE of its
    pixels. Returns the summary."""
    import dataclasses

    import numpy as np
    import torch

    from arctic_tpu_torch.models import pipeline

    label = "opt-ins real-size"
    opts = dict(ibl_specular=True, spotlights=True, static_point_lights=len(REAL_LIGHTS) + 1)
    log(f"{label} rig: {REAL_LIGHTS + [REAL_SPOT]} (position, color[, (axis, inner, outer "
        f"degrees)]), {opts}")
    render = pipeline.make_renderer_stats(dataclasses.replace(config, **opts), device)
    img, stats = render(bufs, *optin_params(0))  # warm-up
    torch.cuda.synchronize()
    pipeline.check_stats(stats)
    frames = [optin_params(i) for i in range(FLY_FRAMES)]
    times, all_stats, imgs, counts, mem = fly_through(
        render, bufs, frames, DEFAULT_PATH, label,
        absent=("tile_tap_resolve", "transpose_pack_rows"))
    if profile:
        profile_frames(render, bufs, frames[:2], "optins")
    deferred = pipeline.make_renderer_stats(dataclasses.replace(deferred_config, **opts), device)
    ref, stats = deferred(bufs, *frames[0])
    pipeline.check_stats(stats)
    d = np.abs(imgs[0].astype(np.int32) - ref.cpu().numpy().astype(np.int32)).max(axis=2)
    share = float((d <= 1).mean())
    log(f"{label} frame 0 vs the deferred frame with the same options: {share:.4%} of pixels "
        f"within 1 LSB, max {d.max()} LSB")
    if share < DEFERRED_NEAR_SHARE:
        raise RuntimeError(f"{label} frame 0 is within 1 LSB of the deferred frame on < "
                           f"{DEFERRED_NEAR_SHARE:.0%} of its pixels")
    if any(im.mean() < 5.0 for im in imgs):
        raise RuntimeError(f"a {label} frame is black")
    np.save(os.path.join(OUT_DIR, "chip_smoke_real_optins.npy"), imgs[-1])
    summary = dict(ms_per_frame_median=statistics.median(times), ms_per_frame=times,
                   max_memory_allocated=mem[0], share=share,
                   stats={k: int(v) for k, v in all_stats[-1].items()})
    log(f"{label} frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), {_mem(mem)}, stats {summary['stats']}")
    return summary


def run_f32_table_pcf(device, bufs, config):
    """The f32 window-table PCF (shadow.pcf_shadow_proj(use_lut=True,
    quant=False), K12) on the default real-size frame 0's shadow map (K1's
    depth-only output, a strided view of the row-major buffer) and
    light-space planes, as that frame's PCF got them. The result must equal
    the runs-path result the frame computed, bit for bit. Returns (K12's
    recorded calls, launch counts of the call)."""
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.ops import shadow
    from arctic_tpu_torch.utils import kernels

    pcf = {}
    frame_pcf = pipeline.pcf_shadow

    def keep_pcf(gbuf, covered, shadow_map, *rest):
        out = frame_pcf(gbuf, covered, shadow_map, *rest)
        pcf.update(xyz=gbuf[14:17].clone(), shadow_map=shadow_map, shadow=out[0])
        return out

    pipeline.pcf_shadow = keep_pcf
    try:
        _, stats = pipeline.make_renderer_stats(config, device)(bufs, *real_params(0))
    finally:
        pipeline.pcf_shadow = frame_pcf
    pipeline.check_stats(stats)
    smap, (x, y, z) = pcf["shadow_map"], pcf["xyz"]
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        got = shadow.pcf_shadow_proj(smap, x, y, z, use_lut=True, quant=False)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"f32 window-table PCF launches: {counts}")
    check_launches(counts, ("window_lut",), "f32 window-table PCF",
                   absent=("window_lut_q", "pcf_eval"))
    if not torch.equal(got, pcf["shadow"]):
        raise RuntimeError("the f32 window-table PCF differs from the frame's runs path at real size")
    log(f"f32 window-table PCF at real size (map {smap.shape[0]}^2 read from K1's buffer, row "
        f"pitch {smap.stride(0)}): bit-equal to the frame's runs-path result over {got.numel()} "
        f"pixels, mean shadow {float(got.mean()):.6f}")
    return calls, counts


def run_real_quant(device, bufs, config, profile: bool = False):
    """The quantised PCF path at real size (``config``'s pair caps): frame 0
    with every row in the cap, then at the tight cap (bit-identical), then
    the fly-through. Returns (summary, recorded calls of the tight-cap frame
    0, launch counts of the fly-through, its frames on the host, its
    config)."""
    import dataclasses
    import math

    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    every = config.num_tiles * config.tile_h * config.tile_w // 128
    config = dataclasses.replace(config, pcf_row_cap=every)
    params, settings = real_params(0)
    img_full, stats = pipeline.render_frame_stats(bufs, params, settings, config)
    torch.cuda.synchronize()
    pipeline.check_stats(stats)
    used = int(stats["pcf_rows"])
    cap = 32 * math.ceil(CAP_MARGIN * used / 32)
    log(f"quant real-size frame 0: pcf_rows {used} of {every} rows; cap -> {cap}")
    config = dataclasses.replace(config, pcf_row_cap=cap)
    render = pipeline.make_renderer_stats(config, device)
    with kernels.record_calls() as calls:  # its inputs feed phase 5
        img, stats = render(bufs, params, settings)
        torch.cuda.synchronize()
    pipeline.check_stats(stats)
    if not torch.equal(img, img_full):
        raise RuntimeError("quant frame 0 differs between the full and the tight row cap")
    log(f"quant real-size frame 0 at cap {cap}: bit-identical to the full-cap frame")

    frames = [real_params(i) for i in range(FLY_FRAMES)]
    times, all_stats, imgs, counts, mem = fly_through(
        render, bufs, frames, QUANT_PATH, "quant real-size",
        absent=("tile_tap_resolve", "transpose_pack_rows"),
    )
    if profile:
        profile_frames(render, bufs, frames[:2], "quant")
    rows = [int(st["pcf_rows"]) for st in all_stats]
    if imgs[-1].mean() < 5.0:
        raise RuntimeError(f"quant real-size frame is wrong: mean {imgs[-1].mean():.2f}")
    summary = dict(ms_per_frame_median=statistics.median(times), ms_per_frame=times,
                   pcf_rows=rows, pcf_row_cap=int(all_stats[0]["pcf_row_cap"]),
                   max_memory_allocated=mem[0])
    log(f"quant real-size frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), pcf_rows {rows} of cap "
        f"{summary['pcf_row_cap']}, {_mem(mem)}")
    return summary, calls, counts, imgs, config


def run_cached(device, bufs, config, uncached, profile: bool = False):
    """The cached sun at real size: the cache build, then the fly-through
    with the cache; each frame within 1 LSB of the uncached one."""
    import numpy as np
    import torch

    from arctic_tpu_torch.models import pipeline

    build = pipeline.make_sun_cache_builder(config, device)
    render = pipeline.make_cached_renderer_stats(config, device)
    frames = [real_params(i) for i in range(FLY_FRAMES)]
    t = time.perf_counter()
    cache, cstats = build(bufs, frames[0][0])
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t) * 1e3
    pairs, cap = int(cstats["shadow_pairs"]), int(cstats["shadow_pair_cap"])
    log(f"sun cache build: {build_ms:.3f} ms, shadow pairs {pairs} of {cap}")
    if pairs > cap:
        raise RuntimeError("the sun cache's shadow pass overflowed its pair buffer")
    times, all_stats, imgs, _, mem = fly_through(
        render, bufs, frames, RASTER_PATH + ("pcf_eval",), "cached real-size", cache,
        absent=("tile_tap_resolve", "window_lut_q", "transpose_pack_rows"),
    )
    if profile:
        profile_frames(render, bufs, frames[:2], "cached", cache)
    diffs = []
    for img, ref in zip(imgs, uncached):
        d = np.abs(img.astype(np.int32) - ref.astype(np.int32))
        diffs.append((int(d.max()), int((d.max(axis=2) > 0).sum())))
    log(f"cached vs uncached frames: (max LSB, pixels that differ) {diffs}")
    if max(m for m, _ in diffs) > 1:
        raise RuntimeError("a cached-sun frame differs from its uncached frame by more than 1 LSB")
    summary = dict(build_ms=build_ms, ms_per_frame_median=statistics.median(times),
                   ms_per_frame=times, diffs=diffs,
                   pcf_rows=[int(st["pcf_rows"]) for st in all_stats])
    log(f"cached real-size frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), pcf_rows {summary['pcf_rows']}, {_mem(mem)}")
    return summary


def run_textured(device, profile: bool = False):
    """The textured path at real size: the reference-scale texture set on
    the tile atlas with its own tuned pair caps, the fly-through (K9 once a
    frame, K6 never) and frame 19 gated against bench_tex1024.png. Returns
    (summary, recorded calls of the warm-up frame, launch counts of the
    fly-through)."""
    import numpy as np
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    bufs = real_buffers(device, textured=True)
    config = tune_caps(bufs, "textured real-size")
    render = pipeline.make_renderer_stats(config, device)
    params, settings = real_params(0)
    with kernels.record_calls() as calls:  # warm-up frame; its inputs feed phase 5
        img, stats = render(bufs, params, settings)
        torch.cuda.synchronize()
    pipeline.check_stats(stats)

    frames = [real_params(i) for i in range(FLY_FRAMES)]
    times, all_stats, imgs, counts, mem = fly_through(
        render, bufs, frames, TEX_PATH, "textured real-size",
        absent=("tap_resolve", "transpose_pack_rows"),
    )
    if counts["tile_tap_resolve"] != len(frames):
        raise RuntimeError(f"K9 launched {counts['tile_tap_resolve']} times in {len(frames)} frames")
    if profile:
        profile_frames(render, bufs, frames[:2], "textured")
    if imgs[-1].mean() < 5.0:
        raise RuntimeError(f"textured real-size frame is wrong: mean {imgs[-1].mean():.2f}")
    last = last_bench_frame(render, bufs)
    np.save(os.path.join(OUT_DIR, "chip_smoke_real_tex_19.npy"), last)
    g = golden_compare(last, "bench_tex1024.png")
    g["depth_tied"] = depth_probe(render, bufs, last, "bench_tex1024.png")
    summary = dict(ms_per_frame_median=statistics.median(times), ms_per_frame=times,
                   max_memory_allocated=mem[0], golden=g,
                   stats={k: int(v) for k, v in all_stats[-1].items()})
    log(f"textured real-size frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), {_mem(mem)}, stats {summary['stats']}")
    log(f"textured real-size frame 19 vs bench_tex1024.png: {g['db']:.2f} dB whole frame; "
        f"{g['near']:.4%} of pixels within {GOLDEN_NEAR_LSB} LSB, {g['near_db']:.2f} dB over "
        f"them (gate: >= {GOLDEN_NEAR_SHARE:.0%} and >= {GOLDEN_MIN_DB} dB); of the pixels "
        f"further off, {g['depth_tied']:.2%} lie within 1 px of a pixel that a 1e-4 relative "
        f"move of z_near changes")
    if g["near"] < GOLDEN_NEAR_SHARE or g["near_db"] < GOLDEN_MIN_DB:
        raise RuntimeError(f"textured frame 19 fails its golden gate: {g}")
    return summary, calls, counts, config, imgs


def entry_params(lights=None):
    """The entry camera (and ``lights``' rows as a cone-carrying bank)."""
    from arctic_tpu_torch.core.scene import (
        PointLights, default_scene_params, default_settings, make_camera,
    )

    w, h = ENTRY["width"], ENTRY["height"]
    params = default_scene_params(aspect=w / h)
    params.camera = make_camera(ENTRY["eye"], ENTRY["rot"], w / h)
    if lights is not None:
        params.point_lights = PointLights.from_list(lights, spots=True)
    return params, default_settings()


def run_entry_route(label: str, name: str, scene, **build_kw):
    """3i / 3j: the entry scene ``scene`` built with ``build_kw`` on the card
    and on the CPU: its fused frame launches K1, K3 and K4 and no other
    kernel (no K6, no K9), is within 1 LSB of the port's CPU frame on < 1%
    of the values and >= 40 dB against the f64 oracle of the scene's
    material images. Returns the recorded kernel calls."""
    import numpy as np
    import torch

    from arctic_tpu_torch.core.config import RenderConfig
    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.models import golden, pipeline
    from arctic_tpu_torch.utils import kernels

    config = RenderConfig(width=ENTRY["width"], height=ENTRY["height"], shadow_size=ENTRY["shadow"])
    params, settings = entry_params()
    bufs = build_buffers(*scene, tri_bucket=256, device="cuda", **build_kw)
    a = bufs.atlas
    route = ("per-slot atlas" if a.quads is not None else "unmerged combined quads"
             if a.combined_quads is not None else "other")
    log(f"{label} scene: the {route} ({', '.join(str(t.dtype) for t in (a.quads, a.combined_quads) if t is not None)}), "
        f"nm_constant {a.nm_constant}, mr_constant {a.mr_constant}")
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(bufs, params, settings, config)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"{label} frame launches: {counts}")
    check_launches(counts, PER_SLOT_PATH, label,
                   absent=tuple(k for k in counts if k not in PER_SLOT_PATH))
    pipeline.check_stats(stats)
    img = img.cpu().numpy()
    cpu_bufs = build_buffers(*scene, tri_bucket=256, device="cpu", **build_kw)
    img_cpu, _ = pipeline.render_frame_stats(cpu_bufs, params, settings, config)
    lsb_gate(img, img_cpu.numpy(), label, "the port's CPU frame")
    db = golden.psnr(img, golden_frame(scene, params, settings, config))
    log(f"{label} frame PSNR vs f64 golden oracle: {db:.2f} dB")
    if db < 40.0:
        raise RuntimeError(f"{label} frame PSNR {db:.2f} dB < 40 dB")
    np.save(os.path.join(OUT_DIR, f"chip_smoke_entry_{name}.npy"), img)
    return calls


def grouped_scene():
    """tests/test_tex_groups.py's six materials, each on its own object."""
    from arctic_tpu_torch.io import procedural as pr

    meshes = [pr.plane_mesh(8.0, material=0, uv_scale=2.0), pr.box_mesh(2.0, 2.0, 2.0, material=1),
              pr.uv_sphere(1.0, 8, 12, material=2), pr.box_mesh(1.0, 3.0, 1.0, material=3),
              pr.uv_sphere(0.8, 8, 12, material=4), pr.box_mesh(3.0, 1.0, 1.0, material=5)]
    offsets = [(0, 0, 0), (-2.0, 1.0, 0.0), (2.0, 1.0, 0.0), (0.0, 1.5, -2.0), (-1.0, 0.8, 2.0),
               (1.5, 0.5, 2.5)]
    objects = [(pr.transform(t), i) for i, t in enumerate(offsets)]
    return meshes, objects, pr.textured_materials(6, 32), pr.gradient_environment(16, 32)


def run_entry_grouped():
    """3k: the grouped tile route on the six-material scene at 128 x 128 with
    explicit groups and caps from autotune_tex_group_caps: the frame is
    bit-equal to the same buffers' ungrouped tile frame, K9 launches once a
    group and once for the fallback, and a starved fallback cap makes
    check_stats raise. Returns the grouped frame's recorded calls."""
    import dataclasses

    import torch

    from arctic_tpu_torch.core.config import RenderConfig
    from arctic_tpu_torch.core.scene import default_scene_params, default_settings, make_camera
    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels
    from arctic_tpu_torch.utils.errors import RenderError

    label = "grouped entry"
    n = GROUPED_SIZE
    bufs = build_buffers(*grouped_scene(), tri_bucket=512, device="cuda", tile_threshold_texels=0,
                         tex_group_budget=GROUPED_BUDGET, tex_groups=GROUPED_EXPLICIT)
    groups = bufs.atlas.tile_groups
    params = default_scene_params(aspect=1.0)
    params.camera = make_camera([0.0, 4.0, 7.0], [-25.0, -90.0], 1.0)
    settings = default_settings()
    config = RenderConfig(width=n, height=n, shadow_size=n)
    plain, _ = pipeline.render_frame_stats(bufs, params, settings, config)
    tuned = pipeline.autotune_tex_group_caps(bufs, params, config, margin=TEX_GROUP_MARGIN)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(bufs, params, settings, tuned)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    pipeline.check_stats(stats)
    log(f"{label}: {len(groups)} groups {bufs.atlas.tile_group_of} (material -> group), caps "
        f"{tuned.tex_group_caps}, tex_fb_rows {int(stats['tex_fb_rows'])}, launches {counts}")
    if counts["tile_tap_resolve"] != len(groups) + 1:
        raise RuntimeError(f"{label}: K9 launched {counts['tile_tap_resolve']} times for "
                           f"{len(groups)} groups")
    if not torch.equal(img, plain):
        raise RuntimeError(f"{label} frame differs from the ungrouped tile frame")
    starved = dataclasses.replace(config, tex_group_caps=tuple([32] * (len(groups) + 1)))
    _, sstats = pipeline.render_frame_stats(bufs, params, settings, starved)
    try:
        pipeline.check_stats(sstats)
    except RenderError as e:
        log(f"{label}: a starved fallback cap raises: {e}")
    else:
        raise RuntimeError(f"{label}: tex_fb_rows {int(sstats['tex_fb_rows'])} over cap 32 "
                           f"passed check_stats")
    log(f"{label} frame: bit-equal to the ungrouped tile frame")
    return calls


RT_ENTRY_CASES = (("primary and sun rays", dict()),
                  ("light shadows", dict(rt_light_shadows=True)),
                  ("light shadows and the spotlight", dict(rt_light_shadows=True, spotlights=True)))


def run_entry_rt():
    """3l: the ray-traced entry frame with the point light and the
    spotlight (POINT, SPOT): primary and sun rays, then with
    rt_light_shadows, then with the spotlight's cone too. Each launches K14
    two times plus once a light under rt_light_shadows, K15 once, and no
    other kernel, and is within 1 LSB of the port's CPU ray-traced frame on
    < 1% of the values. Returns the recorded K14 and K15 calls."""
    import dataclasses

    import numpy as np
    import torch

    from arctic_tpu_torch.models import raytrace
    from arctic_tpu_torch.utils import kernels

    config, _, bufs, _, _ = entry_scene("cuda")
    cpu_bufs = entry_scene("cpu")[2]
    params, settings = entry_params([POINT, SPOT])
    t = time.perf_counter()
    bvh = raytrace.build_scene_bvh(bufs)
    log(f"ray-traced entry BVH: {bvh.num_nodes} nodes, {bvh.nbytes} B, built in "
        f"{time.perf_counter() - t:.3f} s")
    cpu_bvh = raytrace.build_scene_bvh(cpu_bufs)
    all_calls = {}
    for name, fields in RT_ENTRY_CASES:
        label = f"ray-traced entry ({name})"
        cfg = dataclasses.replace(config, **fields)
        kernels.reset_launch_counts()
        with kernels.record_calls() as calls:
            img = raytrace.make_rt_renderer(cfg, bvh, "cuda")(bufs, params, settings)
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = 2 + (params.point_lights.count if cfg.rt_light_shadows else 0)
        log(f"{label} launches: {counts}")
        check_launches(counts, RT_PATH, label, absent=tuple(k for k in counts if k not in RT_PATH))
        if counts["bvh_trace"] != want or counts["shade_lights"] != 1:
            raise RuntimeError(f"{label}: K14 launched {counts['bvh_trace']} times, not {want}, "
                               f"K15 {counts['shade_lights']}, not 1")
        img = img.cpu().numpy()
        ref = raytrace.make_rt_renderer(cfg, cpu_bvh, "cpu")(cpu_bufs, params, settings)
        lsb_gate(img, ref.numpy(), label, "the port's CPU ray-traced frame")
        if img.mean() < 5.0:
            raise RuntimeError(f"{label} frame is black")
        np.save(os.path.join(OUT_DIR, f"chip_smoke_entry_rt_{len(all_calls.get('bvh_trace', []))}.npy"),
                img)
        for name in RT_PATH:
            all_calls.setdefault(name, []).extend(calls[name])
    return all_calls


def run_real_grouped(device, tex_config, tex_imgs, tex_median, profile: bool = False):
    """4j: the grouped tile route on 4d's textured scene: plan_tex_groups over
    bench.py's 20 viewpoints, the scene rebuilt with the plan, caps from
    autotune_tex_group_caps(margin=TEX_GROUP_MARGIN), the fly-through (K9
    once a group and once for the fallback each frame), each frame
    bit-equal to 4d's at the same viewpoint. Returns (summary, recorded
    calls of the warm-up frame)."""
    import numpy as np
    import torch

    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.io.procedural import sponza_like_scene
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    label = "grouped real-size"
    scene = sponza_like_scene(texture_size=1024, n_materials=24)
    bufs = build_buffers(*scene, device=device)
    path = [real_params(i)[0] for i in range(BENCH_FRAMES)]
    t = time.perf_counter()
    plan = pipeline.plan_tex_groups(bufs, path, tex_config)
    plan_s = time.perf_counter() - t
    log(f"{label}: the build's {len(bufs.atlas.tile_groups)} greedy groups; plan over "
        f"{BENCH_FRAMES} viewpoints in {plan_s:.2f} s: {plan}")
    del bufs
    t = time.perf_counter()
    gbufs = build_buffers(*scene, device=device, tex_groups=plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    groups = gbufs.atlas.tile_groups
    t = time.perf_counter()
    config = pipeline.autotune_tex_group_caps(gbufs, path, tex_config, margin=TEX_GROUP_MARGIN)
    tune_ms = (time.perf_counter() - t) * 1e3
    log(f"{label}: G = {len(groups)} groups, rebuilt in {build_s:.2f} s, group tables "
        f"views of the tile atlas ({gbufs.atlas.tiles.numel() * 4} B), caps "
        f"{config.tex_group_caps} (autotune {tune_ms:.1f} ms; sum {sum(config.tex_group_caps)} "
        f"of {config.num_tiles * 32} rows)")
    render = pipeline.make_renderer_stats(config, device)
    with kernels.record_calls() as calls:  # warm-up frame; its K9 calls feed phase 5
        img, stats = render(gbufs, *real_params(0))
        torch.cuda.synchronize()
    pipeline.check_stats(stats)
    frames = [real_params(i) for i in range(FLY_FRAMES)]
    times, all_stats, imgs, counts, mem = fly_through(
        render, gbufs, frames, TEX_PATH, label, absent=("tap_resolve", "transpose_pack_rows"))
    if counts["tile_tap_resolve"] != (len(groups) + 1) * len(frames):
        raise RuntimeError(f"{label}: K9 launched {counts['tile_tap_resolve']} times in "
                           f"{len(frames)} frames of {len(groups)} groups")
    if profile:
        profile_frames(render, gbufs, frames[:2], "grouped")
    fb = [int(st["tex_fb_rows"]) for st in all_stats]
    for i, (im, ref) in enumerate(zip(imgs, tex_imgs)):
        if not np.array_equal(im, ref):
            raise RuntimeError(f"{label} frame {i} differs from the textured frame at its viewpoint")
    summary = dict(ms_per_frame_median=statistics.median(times), ms_per_frame=times,
                   groups=len(groups), caps=config.tex_group_caps, tex_fb_rows=fb,
                   build_s=build_s, plan_s=plan_s,
                   max_memory_allocated=mem[0])
    log(f"{label} frames: bit-equal to the textured frames; median "
        f"{summary['ms_per_frame_median']:.3f} ms/frame (all {['%.3f' % t for t in times]}; the "
        f"textured path's {tex_median:.3f}), tex_fb_rows {fb} of cap {config.tex_group_caps[-1]}, "
        f"{_mem(mem)}")
    return summary, calls


def run_real_rt(device, bufs, config, profile: bool = False):
    """4k: the ray-traced mode on phase 4's loaded scene: the BVH's build
    seconds, nodes and bytes, the fly-through (K14 twice a frame, K15 once,
    no other kernel), one frame with rt_light_shadows and the 4 lights (K14
    six times, K15 once); on frame 0 the primary hit's triangle equals the
    raster ibuf's (the camera pass with ``config``'s caps, slots taken modulo the
    triangle capacity) on >= RT_AGREE_SHARE of the pixels both cover
    whose hit faces the camera, and on >= RT_CORE_AGREE_SHARE of those off
    the raster's triangle edges.
    Returns (summary, recorded K14 and K15 calls of frame 0 and of the
    light-shadow frame, K14's work counted by the plain version on every
    K14_SAMPLE-th ray of frame 0's calls)."""
    import dataclasses

    import numpy as np
    import torch

    from arctic_tpu_torch.models import raytrace
    from arctic_tpu_torch.ops import rt
    from arctic_tpu_torch.utils import kernels

    label = "ray-traced real-size"
    t = time.perf_counter()
    bvh = raytrace.build_scene_bvh(bufs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    log(f"{label} BVH: {bufs.geometry.num_tris} triangles, {bvh.num_nodes} nodes, {bvh.nbytes} B, "
        f"built in {build_s:.2f} s on the host")
    rt_render = raytrace.make_rt_renderer(config, bvh, device)

    def render(b, p, s):
        return rt_render(b, p, s), None

    with kernels.record_calls() as calls:  # warm-up frame 0; its calls feed phase 5
        img0 = rt_render(bufs, *real_params(0))
        torch.cuda.synchronize()
    frames = [real_params(i) for i in range(FLY_FRAMES)]
    absent = tuple(k for k in kernels.launch_counts() if k not in RT_PATH)
    times, _, imgs, counts, mem = fly_through(render, bufs, frames, RT_PATH, label, absent=absent)
    if counts["bvh_trace"] != 2 * len(frames) or counts["shade_lights"] != len(frames):
        raise RuntimeError(f"K14 launched {counts['bvh_trace']} times, K15 "
                           f"{counts['shade_lights']} times in {len(frames)} frames")
    if any(im.mean() < 5.0 for im in imgs):
        raise RuntimeError(f"a {label} frame is black")
    if profile:
        profile_frames(rt_render, bufs, frames[:2], "raytraced")
    np.save(os.path.join(OUT_DIR, "chip_smoke_real_rt.npy"), imgs[0])

    agree, agree_core, mismatch = rt_visibility(label, bufs, bvh, config, frames[0][0],
                                                REAL["height"], REAL["width"], device)

    lconfig = dataclasses.replace(config, rt_light_shadows=True)
    kernels.reset_launch_counts()
    t = time.perf_counter()
    with kernels.record_calls() as lcalls:
        limg = raytrace.make_rt_renderer(lconfig, bvh, device)(bufs, *real_params(0))
        torch.cuda.synchronize()
    light_ms = (time.perf_counter() - t) * 1e3
    lcount = kernels.launch_counts()["bvh_trace"]
    want = 2 + len(REAL_LIGHTS)
    log(f"{label} frame 0 with rt_light_shadows ({len(REAL_LIGHTS)} lights): {light_ms:.3f} ms, "
        f"K14 launched {lcount} times")
    if lcount != want or kernels.launch_counts()["shade_lights"] != 1:
        raise RuntimeError(f"{label}: K14 launched {lcount} times with light shadows, not {want}, "
                           f"or K15 not once")
    d = (img0.to(torch.int32) - limg.to(torch.int32)).amax(dim=2)
    log(f"{label}: the light shadows darken {float((d > 0).double().mean()):.4%} of frame 0's "
        f"pixels, by up to {int(d.max())} LSB; {int((d < 0).sum())} pixels brighten")

    # K14's work on frame 0's calls, counted by the plain version on every
    # K14_SAMPLE-th ray.
    work_stats = []
    for args, kw in calls["bvh_trace"]:
        st = {}
        rt.trace_plain(*sample_rays(args, kw)[0], stats=st)
        work_stats.append((args[1].shape[0], st))
    log(f"{label}: plain version's work on every {K14_SAMPLE}th ray of frame 0's K14 calls: "
        f"{[st for _, st in work_stats]}")
    summary = dict(ms_per_frame_median=statistics.median(times), ms_per_frame=times,
                   bvh_build_s=build_s, bvh_nodes=bvh.num_nodes, bvh_bytes=bvh.nbytes,
                   agree=agree, agree_off_edges=agree_core, coverage_mismatch=mismatch,
                   light_shadow_ms=light_ms,
                   max_memory_allocated=mem[0])
    log(f"{label} frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), {_mem(mem)}")
    summary["launches"] = counts["bvh_trace"]
    summary["k15_launches"] = counts["shade_lights"]
    return summary, calls, lcalls, work_stats


def rt_visibility(label, bufs, bvh, config, params, h, w, device):
    """One frame's primary hits against the raster's visibility: the
    camera pass with ``config``'s caps, its slots taken modulo the triangle
    capacity. The raster culls back faces (forward_pass.cpp) and the rays
    do not, so the gates count the pixels both cover whose first hit faces
    the camera: they agree on >= RT_AGREE_SHARE of them. The raster snaps
    vertices to 1/16 px, which moves a triangle's edge by up to 1/32 px: a
    pixel on an edge of the raster's triangles (a 4-neighbour's ibuf
    triangle differs) may see the triangle across it, a pixel off every
    edge must agree on >= RT_CORE_AGREE_SHARE of them. Returns (agreement,
    agreement off the edges, coverage mismatch share)."""
    import torch

    from arctic_tpu_torch.models import pipeline, raytrace
    from arctic_tpu_torch.ops import raster_tiles, rt

    origins, dirs = raytrace.primary_rays(params.camera, h, w, device)
    rays = dirs.reshape(3, -1).T.contiguous()
    hits = rt.trace(bvh, origins, rays, width=w)
    tri = hits.tri
    geom = bufs.geometry
    world = pipeline.world_triangles(geom)

    def facing(t):  # (normal of triangle t) . ray
        c = world[torch.clamp(t, min=0).long()]
        return c, (torch.linalg.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]) * rays).sum(dim=1)

    back = (facing(tri)[1] > 0) & (tri >= 0)
    tri_valid = torch.arange(geom.capacity, device=device) < geom.num_tris
    setup = pipeline.camera_setup(pipeline.world_corners(geom), tri_valid,
                                  params.camera.proj_view(), config)
    _, ibuf, _ = raster_tiles.bin_and_rasterize(setup, config, config.tiles_x, config.tiles_y,
                                                config.tile_h, config.tile_w)
    ibuf = ibuf[:h, :w].reshape(-1)
    ibuf = torch.where(ibuf >= 0, ibuf % geom.capacity, -1)

    def edges(t):  # pixels whose triangle differs from a 4-neighbour's
        t = t.view(h, w)
        e = torch.zeros_like(t, dtype=torch.bool)
        dx, dy = t[:, 1:] != t[:, :-1], t[1:] != t[:-1]
        e[:, 1:] |= dx
        e[:, :-1] |= dx
        e[1:] |= dy
        e[:-1] |= dy
        return e.reshape(-1)

    both = (tri >= 0) & (ibuf >= 0)
    same = tri == ibuf
    front = both & ~back
    edge = edges(ibuf)
    core = front & ~edge
    wrong = front & ~same
    agree = float((same & front).sum() / front.sum())
    agree_core = float((same & core).sum() / core.sum())
    agree_all = float((same & both).sum() / both.sum())
    mismatch = ((tri >= 0) != (ibuf >= 0))
    log(f"{label} frame 0: the primary hit's triangle is the raster ibuf's on {agree:.4%} of the "
        f"{int(front.sum())} pixels both cover where the hit faces the camera (gate >= "
        f"{RT_AGREE_SHARE:.0%}); {float((wrong & edge).sum() / wrong.sum().clamp(min=1)):.4%} "
        f"of the {int(wrong.sum())} that differ are on an edge of the raster's triangles; off "
        f"every edge ({int(core.sum())} pixels) they agree on {agree_core:.4%} (gate >= "
        f"{RT_CORE_AGREE_SHARE:.1%}); on {agree_all:.4%} of all {int(both.sum())} pixels both "
        f"cover, {float((back & both).double().mean()):.4%} of the pixels showing a back face to "
        f"the rays; coverage differs on {float(mismatch.double().mean()):.4%} of the pixels, "
        f"{float((mismatch & back).sum() / mismatch.sum().clamp(min=1)):.4%} of them back-face hits")
    odd = wrong & core
    if bool(odd.any()):
        # Off-edge disagreements: how far the raster triangle's plane lies
        # from the ray's hit along the ray, whether the ray's own triangles
        # change there, and whether the raster's triangle faces the ray.
        c, fr = facing(ibuf)
        t_r = (torch.linalg.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0])
               * (c[:, 0] - origins)).sum(dim=1) / fr
        gap = ((t_r - hits.t).abs() / hits.t)[odd]
        log(f"{label} frame 0: the {int(odd.sum())} off-edge disagreements: relative depth gap "
            f"to the raster triangle's plane < 1e-4 on {float((gap < 1e-4).double().mean()):.4%}, "
            f"< 1e-3 on {float((gap < 1e-3).double().mean()):.4%}, < 1e-2 on "
            f"{float((gap < 1e-2).double().mean()):.4%} (median {float(gap.median()):.3e}); "
            f"on an edge of the rays' triangles {float(edges(tri)[odd].double().mean()):.4%}; "
            f"the raster's triangle faces away from the ray on "
            f"{float((fr[odd] > 0).double().mean()):.4%}")
    if agree < RT_AGREE_SHARE or agree_core < RT_CORE_AGREE_SHARE:
        raise RuntimeError(f"{label}: primary hits agree with the raster on {agree:.4%} < "
                           f"{RT_AGREE_SHARE:.0%} or, off the raster's edges, on "
                           f"{agree_core:.4%} < {RT_CORE_AGREE_SHARE:.1%}")
    return agree, agree_core, float(mismatch.double().mean())


def sample_rays(args, kw):
    """One K14 call's (args, kwargs) on every K14_SAMPLE-th ray, as
    positional (bvh, origin, direction, t_max, any_hit)."""
    import torch

    full = dict(zip(("bvh", "origin", "direction", "t_max", "any_hit"), args), **kw)
    t_max = full.get("t_max", 3.0e38)
    if isinstance(t_max, torch.Tensor) and t_max.dim() > 0:
        t_max = t_max[::K14_SAMPLE].contiguous()
    return (full["bvh"], full["origin"][::K14_SAMPLE].contiguous(),
            full["direction"][::K14_SAMPLE].contiguous(), t_max, full.get("any_hit", False)), {}


def run_real_per_slot(device, profile: bool = False):
    """4l: the per-slot atlas at real size: the bench geometry with 24
    materials whose normal maps are half their diffuse maps' size, its own
    tuned caps, the fly-through (K1, K3 and K4; no K6, no K9), frame 0
    within 1 LSB of the deferred frame on >= DEFERRED_NEAR_SHARE of the
    pixels. Returns the summary."""
    import numpy as np
    import torch

    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.io.procedural import per_slot_materials, sponza_like_scene
    from arctic_tpu_torch.models import pipeline

    label = "per-slot real-size"
    t0 = time.perf_counter()
    meshes, objects, materials, env = sponza_like_scene(texture_size=PER_SLOT_TEXTURE,
                                                        n_materials=24)
    materials = per_slot_materials(materials)
    t1 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    bufs = build_buffers(meshes, objects, materials, env, device=device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    a = bufs.atlas
    if a.quads is None:
        raise RuntimeError(f"{label}: the scene did not take the per-slot atlas")
    log(f"{label} scene: {len(materials)} materials ({PER_SLOT_TEXTURE}^2 diffuse, "
        f"{materials[0].normal.shape[0]}^2 normal maps), generated in {t1 - t0:.1f} s, built in "
        f"{t2 - t1:.1f} s; per-slot quads {tuple(a.quads.shape)} {a.quads.dtype}, "
        f"{a.quads.numel() * a.quads.element_size()} B; {torch.cuda.memory_allocated() - before} "
        f"B on the card")
    config = tune_caps(bufs, label)
    render = pipeline.make_renderer_stats(config, device)
    img, stats = render(bufs, *real_params(0))  # warm-up
    torch.cuda.synchronize()
    pipeline.check_stats(stats)
    frames = [real_params(i) for i in range(FLY_FRAMES)]
    times, all_stats, imgs, counts, mem = fly_through(
        render, bufs, frames, PER_SLOT_PATH, label,
        absent=("tap_resolve", "tile_tap_resolve", "transpose_pack_rows", "bvh_trace"))
    if profile:
        profile_frames(render, bufs, frames[:2], "per_slot")
    deferred = pipeline.make_renderer_stats(tune_caps(bufs, f"{label} deferred",
                                                      fused_shade=False), device)
    ref, dstats = deferred(bufs, *frames[0])
    pipeline.check_stats(dstats)
    d = np.abs(imgs[0].astype(np.int32) - ref.cpu().numpy().astype(np.int32)).max(axis=2)
    share = float((d <= 1).mean())
    log(f"{label} frame 0 vs its deferred frame: {share:.4%} of pixels within 1 LSB, max "
        f"{d.max()} LSB")
    if share < DEFERRED_NEAR_SHARE:
        raise RuntimeError(f"{label} frame 0 is within 1 LSB of its deferred frame on < "
                           f"{DEFERRED_NEAR_SHARE:.0%} of the pixels")
    if any(im.mean() < 5.0 for im in imgs):
        raise RuntimeError(f"a {label} frame is black")
    np.save(os.path.join(OUT_DIR, "chip_smoke_real_per_slot.npy"), imgs[-1])
    summary = dict(ms_per_frame_median=statistics.median(times), ms_per_frame=times,
                   max_memory_allocated=mem[0], share=share,
                   stats={k: int(v) for k, v in all_stats[-1].items()})
    log(f"{label} frames: median {summary['ms_per_frame_median']:.3f} ms/frame "
        f"(all {['%.3f' % t for t in times]}), {_mem(mem)}, stats {summary['stats']}")
    return summary


def shard_scene(width, height, shadow, **fields):
    """Cornell at (width, height, shadow) with the entry camera, on the card."""
    import dataclasses

    from arctic_tpu_torch.core.config import RenderConfig
    from arctic_tpu_torch.core.scene import make_camera

    _, _, bufs, params, settings = entry_scene("cuda")
    params.camera = make_camera(ENTRY["eye"], ENTRY["rot"], width / height)
    config = dataclasses.replace(RenderConfig(width=width, height=height, shadow_size=shadow),
                                 **fields)
    return config, bufs, params, settings


def single_shadow_map(bufs, params, config):
    """The single-device frame's shadow map (inside its sun-cull rect)."""
    import torch

    from arctic_tpu_torch.models import pipeline

    geom = bufs.geometry
    wc = pipeline.world_corners(geom)
    tri_valid = torch.arange(geom.capacity, device=bufs.device) < geom.num_tris
    sun_pv = params.sun.proj_view()
    rect = None
    if pipeline.fused(config) and config.sun_frustum_cull:
        rect, _ = pipeline.sun_cull_rect(wc, tri_valid, params.camera.proj_view(), sun_pv, config)
    return pipeline.shadow_pass(geom, pipeline.corners_clip(wc, sun_pv), config, rect)[0]


def same_frame(got, want, label: str, what: str) -> None:
    """Fail unless the two u8 frames (tensors or arrays) are bit-equal."""
    import numpy as np
    import torch

    got, want = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                 for x in (got, want))
    if got.shape != want.shape or not np.array_equal(got, want):
        d = (np.abs(got.astype(np.int32) - want.astype(np.int32)) if got.shape == want.shape
             else None)
        raise RuntimeError(f"{label}: differs from {what}" + (
            "" if d is None else f" (max {d.max()} LSB on {int((d > 0).sum())} values)"))


def int_stats(stats) -> dict:
    return {k: int(v) for k, v in stats.items()}


def run_sharded_world1():
    """6a: the sharded frame over a world of one NCCL rank (bench.py:158-185's
    check) on the entry scene's default, quantised, textured and
    brute-force paths: bit-equal to the single-card frame of the same
    config, with equal stats, each path's kernels launched and no other."""
    import dataclasses

    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.parallel import sharding
    from arctic_tpu_torch.utils import kernels

    cases = (("default", {}, False, DEFAULT_PATH), ("quantised", dict(pcf_row_cap=ENTRY_ROWS),
                                                    False, QUANT_PATH),
             ("textured", {}, True, TEX_PATH), ("brute-force", dict(force_bruteforce=True),
                                                False, ()))
    for name, fields, textured, path in cases:
        label = f"6a world-1 NCCL {name} entry"
        config, _, bufs, params, settings = entry_scene("cuda", textured=textured)
        config = dataclasses.replace(config, **fields)
        want, wst = pipeline.render_frame_stats(bufs, params, settings, config)
        kernels.reset_launch_counts()
        img, st = sharding.make_sharded_renderer_stats(config)(bufs, params, settings)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        log(f"{label} launches: {counts}")
        check_launches(counts, path, label, absent=tuple(k for k in counts if k not in path))
        pipeline.check_stats(st)
        same_frame(img, want, label, "the single-card frame")
        if int_stats(st) != int_stats(wst):
            raise RuntimeError(f"{label}: stats {int_stats(st)} != single-card {int_stats(wst)}")
        log(f"{label}: bit-equal to the single-card frame, stats equal {int_stats(st)}")


def run_slabs_entry():
    """6b: render_frame_slabs_with_map on the card, as SLAB_RANKS slabs at each
    of SLAB_SHAPES: frame and the gathered shadow map it read bit-equal to
    the single-card ones; every rank launches K1 twice (its shadow and camera slab) and K4
    once, with row0 != 0 on every rank but the first. Returns the recorded
    K1 / K4 calls (phase 5)."""
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.parallel import sharding
    from arctic_tpu_torch.utils import kernels

    recorded = {"raster_tiles": [], "select_interp": []}
    for w, h, s in SLAB_SHAPES:
        config, bufs, params, settings = shard_scene(w, h, s)
        single, _ = pipeline.render_frame_stats(bufs, params, settings, config)
        single_map = single_shadow_map(bufs, params, config)
        for world in SLAB_RANKS:
            label = f"6b {w}x{h}/{s}^2 as {world} slabs"
            layout = sharding.slab_layout(config, world)
            kernels.reset_launch_counts()
            with kernels.record_calls() as calls:
                img, st, smap = sharding.render_frame_slabs_with_map(bufs, params, settings, config,
                                                                     world)
                torch.cuda.synchronize()
            counts = kernels.launch_counts()
            pipeline.check_stats(st)
            want = {"raster_tiles": 2 * world, "select_interp": world,
                    "pack_shade_rows": world, "tap_resolve": world}
            if any(counts[k] != n for k, n in want.items()):
                raise RuntimeError(f"{label}: launches {counts}, want {want}")
            k1_rows = [kw["row0"] for _, kw in calls["raster_tiles"]]
            k4_rows = [kw["row0"] for _, kw in calls["select_interp"]]
            cam = [r * layout.cam_rows * config.tile_h for r in range(world)]
            if k1_rows != [r * layout.sh_rows * 64 for r in range(world)] + cam or k4_rows != cam:
                raise RuntimeError(f"{label}: K1 row0 {k1_rows}, K4 row0 {k4_rows}")
            same_frame(img, single, label, "the single-card frame")
            if not torch.equal(smap, single_map):
                raise RuntimeError(f"{label}: the gathered shadow map differs from the "
                                   f"single-card map")
            for k in recorded:
                recorded[k] += calls[k]
            log(f"{label}: frame and shadow map bit-equal to the single-card ones; launches "
                f"{counts}; K1 row0 {k1_rows}, K4 row0 {k4_rows}; stats {int_stats(st)}")
    return recorded


def run_real_sharded(bufs, config, frame0):
    """6c: phase 4's default config and tuned caps at frame 0's viewpoint,
    over a world of one NCCL rank and as REAL_SLABS slabs: each bit-equal to
    phase 4's frame 0 (``frame0``); per-rank pairs, slab ms (CUDA events,
    the rank's shadow and camera slab) and peak memory above the resident
    bytes, beside the whole frame's. Returns the slabs' recorded K1 / K4
    calls (phase 5)."""
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.parallel import sharding
    from arctic_tpu_torch.utils import kernels

    params, settings = real_params(0)
    label = "6c real-size world-1 NCCL"
    kernels.reset_launch_counts()
    img, st = sharding.make_sharded_renderer_stats(config)(bufs, params, settings)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check_launches(counts, DEFAULT_PATH, label, absent=tuple(k for k in counts
                                                              if k not in DEFAULT_PATH))
    pipeline.check_stats(st)
    same_frame(img, frame0, label, "phase 4's frame 0")
    log(f"{label}: bit-equal to phase 4's frame 0; launches {counts}; stats {int_stats(st)}")

    label = f"6c real-size as {REAL_SLABS} slabs"
    layout = sharding.slab_layout(config, REAL_SLABS)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, st, shadow_map = sharding.render_frame_slabs_with_map(bufs, params, settings, config,
                                                                   REAL_SLABS)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts["raster_tiles"] != 2 * REAL_SLABS or counts["select_interp"] != REAL_SLABS:
        raise RuntimeError(f"{label}: launches {counts}")
    pipeline.check_stats(st)
    same_frame(img, frame0, label, "phase 4's frame 0")
    log(f"{label} ({layout.cam_tile_rows} camera tile rows, {layout.cam_rows} a rank; "
        f"{layout.sh_tile_rows} shadow tile rows, {layout.sh_rows} a rank): bit-equal to phase "
        f"4's frame 0; launches {counts}; stats {int_stats(st)}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    pipeline.render_frame_stats(bufs, params, settings, config)
    torch.cuda.synchronize()
    whole = torch.cuda.max_memory_allocated() - resident
    front = sharding.replicated_inputs(bufs, params, config)
    rows = []
    for r in range(REAL_SLABS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, sh_pairs = sharding.shadow_slab(bufs, config, layout, r, front)
        _, c = sharding.camera_slab(bufs, params, settings, config, layout, r, shadow_map, front)
        end.record()
        end.synchronize()
        rows.append(dict(rank=r, cam_pairs=int(c["cam_pairs"]), shadow_pairs=int(sh_pairs),
                         ms=start.elapsed_time(end),
                         peak=torch.cuda.max_memory_allocated() - resident))
    log(f"6c per-rank slabs (shadow + camera slab; replicated inputs and the gathered map "
        f"resident): {rows}; the whole frame's peak above its resident bytes {whole} B")
    return {k: calls[k] for k in ("raster_tiles", "select_interp")}


def run_multi_card(glb, cli_img):
    """6d: with two or more cards, launch() over NCCL with min(count,
    MULTI_CARD_RANKS) processes (rank r on cuda:r) at the entry size: every
    rank's frame bit-equal to the single-card frame, its stats equal to the
    slab frame's of as many ranks; then the CLI's --devices with as many
    ranks (run_cli_devices)."""
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.parallel import sharding

    n = torch.cuda.device_count()
    if n < 2:
        log("6d skipped: 1 card")
        return
    world = min(n, MULTI_CARD_RANKS)
    config, _, bufs, params, settings = entry_scene("cuda")
    want, _ = pipeline.render_frame_stats(bufs, params, settings, config)
    _, wst = sharding.render_frame_slabs_stats(bufs, params, settings, config, world)
    t = time.perf_counter()
    out = sharding.launch(world, sharding.frame_worker, bufs.to("cpu"), params, settings, config,
                          device="cuda")
    for rank, (img, st) in enumerate(out):
        same_frame(img, want, f"6d NCCL rank {rank} of {world}", "the single-card frame")
        if st != int_stats(wst):
            raise RuntimeError(f"6d NCCL rank {rank}: stats {st} != the slabs' {int_stats(wst)}")
    log(f"6d NCCL over {world} cards ({time.perf_counter() - t:.1f} s with the processes' "
        f"start): every rank's frame bit-equal to the single-card frame, stats {out[0][1]}")
    run_cli_devices(glb, cli_img, world)


def run_viewer():
    """6e: the viewer served on 127.0.0.1:0 in a thread at the entry size on
    the fused default path: / then /frame with the entry camera, a camera
    move, a tonemap change, a light edit, a sun edit and an object edit,
    then /state. Each PNG, decoded by io/images, is bit-equal to the
    in-process frame of the viewer's state after it; a frame with the sun
    and geometry unchanged launches K1 once (the cached sun), the first
    frame and the sun and object edits rebuild the cache (K1 twice)."""
    import http.client
    import json
    import threading
    from http.server import ThreadingHTTPServer
    from urllib.parse import urlencode

    import torch

    from arctic_tpu_torch.app import viewer
    from arctic_tpu_torch.io.images import decode_png
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    config, _, bufs, params, settings = entry_scene("cuda")
    config = pipeline.autotune_pair_caps(bufs, params, config, margin=VIEWER_MARGIN)
    state = viewer.ViewerState(bufs, params, settings, config,
                               pipeline.make_renderer_stats(config), "cuda")
    server = ThreadingHTTPServer(("127.0.0.1", 0), viewer.make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    cam = ",".join(str(v) for v in ENTRY["eye"]), ",".join(str(v) for v in ENTRY["rot"])
    lights = [{"pos": [0, 1, 0], "color": [10, 0, 0]}, {"pos": [2, 3, -1], "color": [0, 5, 20]}]
    requests = (
        ("entry camera", dict(cam_pos=cam[0], cam_rot=cam[1]), True),
        ("camera move", dict(f=1, dx=12, dy=-4), False),
        ("tonemap change", dict(tm=2, exposure=1.5, gamma=2.0), False),
        ("light edit", dict(lights=json.dumps(lights)), False),
        ("sun edit", dict(sun_rot="-50,30", sun_color="6,6,5"), True),
        ("object edit", dict(obj_edit=json.dumps({"id": 1, "dt": [0.4, 0.2, -0.2],
                                                  "rot": [25, -10], "scale": 1.2})), True),
    )
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        conn.request("GET", "/")
        page = conn.getresponse()
        if page.status != 200 or b"arctic_tpu viewer" not in page.read():
            raise RuntimeError("6e viewer: / did not serve the page")
        def front():  # the viewer's cached renderer's CachedFront, once made
            return getattr(state._cached_render, "front", None)

        for name, query, rebuilds in requests:
            cache = state.sun_cache
            before = front()
            replays = before.replays if before is not None else 0
            kernels.reset_launch_counts()
            conn.request("GET", "/frame?" + urlencode(query))
            r = conn.getresponse()
            png = r.read()
            torch.cuda.synchronize()
            after = front()
            counts = with_replays(kernels.launch_counts(), after,
                                  replays if after is before else 0, f"6e viewer {name}")
            if r.status != 200:
                raise RuntimeError(f"6e viewer {name}: status {r.status}")
            stats = json.loads(r.getheader("X-Stats"))
            k1 = 2 if rebuilds else 1
            if counts["raster_tiles"] != k1 or (state.sun_cache is not cache) != rebuilds:
                raise RuntimeError(f"6e viewer {name}: K1 launched {counts['raster_tiles']} "
                                   f"times (want {k1}), sun cache rebuilt: "
                                   f"{state.sun_cache is not cache} (want {rebuilds})")
            want, wst = pipeline.render_frame_stats(state.buffers, state.params, state.settings,
                                                    state.config)
            pipeline.check_stats(wst)
            same_frame(decode_png(png)[..., :3], want, f"6e viewer {name}",
                       "the in-process frame of its state")
            log(f"6e viewer {name}: PNG ({len(png)} B) bit-equal to the in-process frame; "
                f"K1 x{counts['raster_tiles']} (sun cache {'rebuilt' if rebuilds else 'reused'}); "
                f"{stats['ms']} ms render + download")
        conn.request("GET", "/state")
        st = conn.getresponse()
        body = json.loads(st.read())
        if st.status != 200 or body["camera"]["eye"] != state.params.camera.eye.tolist():
            raise RuntimeError(f"6e viewer /state: status {st.status}, {body}")
        log(f"6e viewer /state: {body['camera']}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10.0)


def run_debug_checks(entry_img, bufs, config, frame0):
    """6f: enable_debug_checks on the card: the entry frame and real-size
    frame 0 bit-equal to those without the checks (phase 3's and phase 4's);
    a NaN light colour raises FloatingPointError at the frame's inputs, a NaN
    corner normal of a covered triangle at forward_visibility."""
    import dataclasses

    import torch

    from arctic_tpu_torch.core.scene import PointLights
    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.ops import raster_tiles
    from arctic_tpu_torch.utils.errors import enable_debug_checks

    def frame_ms(*args):
        t = time.perf_counter()
        img, _ = pipeline.render_frame_stats(*args)
        torch.cuda.synchronize()
        return img, (time.perf_counter() - t) * 1e3

    econfig, _, ebufs, eparams, esettings = entry_scene("cuda")
    unchecked = [frame_ms(ebufs, eparams, esettings, econfig)[1],
                 frame_ms(bufs, *real_params(0), config)[1]]
    enable_debug_checks()
    try:
        img, entry_ms = frame_ms(ebufs, eparams, esettings, econfig)
        same_frame(img, entry_img, "6f checked entry frame", "phase 3's entry frame")
        img, real_ms = frame_ms(bufs, *real_params(0), config)
        same_frame(img, frame0, "6f checked real-size frame 0", "phase 4's frame 0")
        log(f"6f debug checks: the entry frame ({entry_ms:.3f} ms; unchecked just before "
            f"{unchecked[0]:.3f} ms) and real-size frame 0 ({real_ms:.3f} ms; unchecked "
            f"{unchecked[1]:.3f} ms) bit-equal to the unchecked ones")

        nan_params = dataclasses.replace(eparams, point_lights=PointLights.from_list(
            [((0.0, 1.0, 0.0), (10.0, float("nan"), 0.0))]))
        geom = ebufs.geometry
        wc = pipeline.world_corners(geom)
        tri_valid = torch.arange(geom.capacity, device=ebufs.device) < geom.num_tris
        setup = pipeline.camera_setup(wc, tri_valid, eparams.camera.proj_view(), econfig)
        _, ibuf, _ = raster_tiles.rasterize_tiled(setup, econfig.height, econfig.width, econfig)
        slot = int(ibuf[econfig.height // 2, econfig.width // 2])
        tri = slot % geom.capacity
        rows = geom.slot_static_rows.clone()
        rows[0, [tri, geom.capacity + tri]] = float("nan")  # corner 0's normal x
        nan_bufs = dataclasses.replace(ebufs, geometry=dataclasses.replace(
            geom, slot_static_rows=rows, tri_static_attrs=rows[0:33, : geom.capacity]))
        for name, b, p, where in (("NaN light colour", ebufs, nan_params, "frame inputs"),
                                  (f"NaN corner normal of triangle {tri}", nan_bufs, eparams,
                                   "forward_visibility")):
            try:
                pipeline.render_frame_stats(b, p, esettings, econfig)
            except FloatingPointError as e:
                if not str(e).startswith(where):
                    raise RuntimeError(f"6f {name}: raised at the wrong place: {e}") from e
                log(f"6f {name}: FloatingPointError: {e}")
            else:
                raise RuntimeError(f"6f {name}: the checked frame did not raise")
    finally:
        enable_debug_checks(False)

def run_entry_tiles(entry_img):
    """7a: the entry scene on the card at each tile of TILE_CASES: K1 twice
    (the shadow and the camera pass) and each kernel of the path, none of
    another's; each frame bit-equal to the path's entry frame at the 64 x
    64 tiles (``entry_img`` on the default path) and within 1 LSB of the
    port's CPU frame at that tile; K1 on the frames' calls and on
    utils/synthetic.k1_tiles at each of K1_NEW_TILES, with and without the
    ibuf, bit-equal to its plain version, each in one launch."""
    import dataclasses

    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.ops import raster_tiles
    from arctic_tpu_torch.utils import kernels, synthetic

    base = entry_scene("cpu")[0]
    cpu_bufs = entry_scene("cpu")[2]
    want = {"default": entry_img}
    for name, (fields, path) in TILE_PATHS.items():
        if name not in want:
            want[name] = entry_frame(dataclasses.replace(base, **fields), label=f"7a {name} 64x64",
                                     path=path)[0]
    recorded = []
    for label, (name, tile) in TILE_CASES.items():
        fields, path = TILE_PATHS[name]
        config = dataclasses.replace(base, **fields, **tile)
        label = f"7a entry, {label}"
        with kernels.record_calls() as calls:
            img, stats, counts, _, _, params, settings = entry_frame(config, label=label,
                                                                     path=path)
        if counts["raster_tiles"] != 2:
            raise RuntimeError(f"{label}: K1 launched {counts['raster_tiles']} times, not 2")
        same_frame(img, want[name], label, f"the {name} entry frame at 64 x 64 tiles")
        img_cpu, stats_cpu = pipeline.render_frame_stats(cpu_bufs, params, settings, config)
        lsb_gate(img, img_cpu.numpy(), label, "the port's CPU frame at that tile")
        pairs = [k for k in int_stats(stats) if "pair" in k]
        if any(int(stats[k]) != int(stats_cpu[k]) for k in pairs):
            raise RuntimeError(f"{label}: pair stats {int_stats(stats)} != CPU "
                               f"{int_stats(stats_cpu)}")
        recorded += calls["raster_tiles"]
        log(f"{label}: bit-equal to the {name} entry frame at 64 x 64 tiles; stats "
            f"{int_stats(stats)}")
    compare_kernels({"raster_tiles": recorded}, "7a entry tiles", ("raster_tiles",))
    for th, tw in synthetic.K1_NEW_TILES:
        for depth_only in (False, True):
            args, kw = synthetic.k1_tiles(torch.device("cuda"), th, tw, depth_only)
            kernels.reset_launch_counts()
            got = _tensors(raster_tiles.raster_tiles(*args, **kw))
            torch.cuda.synchronize()
            launches = raster_tiles.raster_tiles.launches
            want_t = _tensors(raster_tiles.raster_tiles_plain(*args, **kw))
            errs = [max_abs_diff(a, b) for a, b in zip(got, want_t)]
            bh, bw, rh, rw = raster_tiles.block_layout(th, tw)
            what = f"7a K1 on synthetic.k1_tiles {th}x{tw} {'depth only' if depth_only else 'ibuf'}"
            if launches != 1 or len(got) != len(want_t) or any(errs):
                raise RuntimeError(f"{what}: {launches} launches, max errors {errs}")
            log(f"{what}: one launch, bit-equal to plain ({bh}x{bw} sub-tiles of {rh}x{rw} "
                f"rectangles, {int(args[3][-1])} pairs)")


def run_real_tiles(bufs, frame0, qframe0, qconfig):
    """7b: real-size frame 0 at each tile of REAL_TILES, pair caps from
    autotune_pair_caps(margin=1.4) over bench.py's 20 viewpoints at that
    tile: K1 twice, each frame bit-equal to phase 4's frame 0
    (``frame0``); K1 bit-equal to its plain version on the frame's calls,
    its CUDA-event ms, plain ms and bound per pass and the pairs per pass
    printed; then the quantised frame 0 at shadow tile 32 (4b's row cap,
    ``qconfig``) bit-equal to 4b's (``qframe0``). Returns the shadow-32
    config (7c)."""
    import dataclasses

    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.utils import kernels

    params, settings = real_params(0)
    configs, rows = {}, []
    for label, tile in REAL_TILES.items():
        config = configs[label] = tune_caps(bufs, f"7b {label}", **tile)
        render = pipeline.make_renderer_stats(config)
        kernels.reset_launch_counts()
        with kernels.record_calls() as calls:
            img, stats = render(bufs, params, settings)
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check_launches(counts, DEFAULT_PATH, f"7b {label}",
                       absent=("tile_tap_resolve", "transpose_pack_rows"))
        if counts["raster_tiles"] != 2:
            raise RuntimeError(f"7b {label}: K1 launched {counts['raster_tiles']} times, not 2")
        pipeline.check_stats(stats)
        same_frame(img, frame0, f"7b real-size frame 0, {label}", "phase 4's frame 0")
        t = compare_kernels(calls, f"7b {label}", ("raster_tiles",), timed=("raster_tiles",))
        st = int_stats(stats)
        rows.append(dict(tile=label, ms=round(t["raster_tiles"]["ms"], 4),
                         bound_ms=round(t["raster_tiles"]["bound_ms"], 4),
                         shadow_pairs=st["shadow_pairs"], cam_pairs=st["cam_pairs"]))
        log(f"7b real-size frame 0, {label}: bit-equal to phase 4's frame 0; pairs shadow "
            f"{st['shadow_pairs']}, camera {st['cam_pairs']}; caps shadow "
            f"{st['shadow_pair_cap']}, camera {st['cam_pair_cap']}")
    log(f"7b K1 a frame at each tile (both passes; per pass above): {rows}")
    config = dataclasses.replace(configs["shadow 32x32"], pcf_row_cap=qconfig.pcf_row_cap)
    kernels.reset_launch_counts()
    img, stats = pipeline.make_renderer_stats(config)(bufs, params, settings)
    torch.cuda.synchronize()
    check_launches(kernels.launch_counts(), QUANT_PATH, "7b quantised, shadow 32x32")
    pipeline.check_stats(stats)
    same_frame(img, qframe0, "7b quantised real-size frame 0, shadow 32x32", "4b's frame 0")
    log(f"7b quantised real-size frame 0, shadow 32x32 (row cap {config.pcf_row_cap}): "
        f"bit-equal to 4b's frame 0; pcf_rows {int(stats['pcf_rows'])}")
    return configs["shadow 32x32"]


def run_real_tile_slabs(bufs, config, frame0):
    """7c: real-size frame 0 at 7b's shadow tile 32 (``config``) as
    TILE_SLABS slabs: bit-equal to phase 4's frame 0, each rank's K1 on its
    shadow slab from pixel row rank * sh_rows * 32."""
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.parallel import sharding
    from arctic_tpu_torch.utils import kernels

    params, settings = real_params(0)
    label = f"7c real-size frame 0, shadow 32x32, as {TILE_SLABS} slabs"
    layout = sharding.slab_layout(config, TILE_SLABS)
    with kernels.record_calls() as calls:
        img, st, _ = sharding.render_frame_slabs_with_map(bufs, params, settings, config,
                                                          TILE_SLABS)
        torch.cuda.synchronize()
    pipeline.check_stats(st)
    k1_rows = [kw["row0"] for _, kw in calls["raster_tiles"][:TILE_SLABS]]
    if k1_rows != [r * layout.sh_rows * config.shadow_th for r in range(TILE_SLABS)]:
        raise RuntimeError(f"{label}: K1's shadow slabs start at rows {k1_rows}")
    same_frame(img, frame0, label, "phase 4's frame 0")
    log(f"{label} ({layout.sh_tile_rows} shadow tile rows, {layout.sh_rows} a rank; K1 shadow "
        f"row0 {k1_rows}): bit-equal to phase 4's frame 0; stats {int_stats(st)}")


def run_cli_tiles(glb, want):
    """7d: the CLI with a --config of CLI_TILE_CONFIG on run_cli's GLB at
    the entry size and camera: K1 launched, its PNG bit-equal to run_cli's
    in-process frame (``want``, the default tiles')."""
    import torch

    from arctic_tpu_torch.app import cli
    from arctic_tpu_torch.io.images import load_ldr
    from arctic_tpu_torch.utils import kernels

    w, h, s = ENTRY["width"], ENTRY["height"], ENTRY["shadow"]
    folder = os.path.join(OUT_DIR, "cli")
    cfg, out = os.path.join(folder, "tiles.json"), os.path.join(folder, "tiles.png")
    with open(cfg, "w") as f:
        json.dump(CLI_TILE_CONFIG, f)
    cam = ",".join(str(v) for v in ENTRY["eye"] + ENTRY["rot"])
    label = f"7d CLI --config {json.dumps(CLI_TILE_CONFIG)}"
    kernels.reset_launch_counts()
    rc = cli.main(["render", glb, "--width", str(w), "--height", str(h), "--shadow-size", str(s),
                   f"--camera={cam}", "--config", cfg, "--out", out])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if rc != 0:
        raise RuntimeError(f"{label}: the CLI returned {rc}")
    check_launches(counts, DEFAULT_PATH, label, absent=("tile_tap_resolve", "transpose_pack_rows"))
    same_frame(load_ldr(out)[..., :3], want, label, "the default tiles' in-process frame")
    log(f"{label}: PNG bit-equal to the default tiles' in-process frame of the GLB; launches "
        f"{counts}")


def lights16_setup(device, n_frames: int):
    """The benchmark's lights16 configuration as its entry (raster_cached)
    builds it, on ``device``: (cfg, buffers, the (params, settings) of the
    first ``n_frames`` viewpoints of its path, the tuned config, the sun
    cache). Uses only what the parent commit's program has too."""
    import dataclasses
    from types import SimpleNamespace

    from arctic_tpu_torch.io.build import build_buffers
    from arctic_tpu_torch.models import pipeline
    from render_bench import cell, scene, traffic
    from render_bench.entries import params as frame_params
    from render_bench.entries import render_config
    from render_bench.entries.raster import PAIR_CAP_MARGIN

    w = cell.workload(cell.benchmark(), "sponza_1080p.lights16")
    cfg, mix = cell.config(w["config"]), cell.traffic(w["traffic"])
    bufs = build_buffers(*scene.generate(cfg), device=device)
    path = traffic.path(cfg, mix, LIGHTS16_SEED)
    frames = [frame_params(traffic.frame(path, mix, k)) for k in range(n_frames)]
    config = pipeline.autotune_pair_caps(
        bufs, [p for p, _ in frames],
        render_config(SimpleNamespace(cfg=cfg), sun_frustum_cull=False), margin=PAIR_CAP_MARGIN)
    config = dataclasses.replace(config, sun_frustum_cull=True)
    cache, cstats = pipeline.make_sun_cache_builder(config, device)(bufs, frames[0][0])
    pipeline.check_stats({"cam_pairs": 0, "cam_pair_cap": 1, **cstats})
    return cfg, bufs, frames, config, cache


def run_lights16(device):
    """7e: the benchmark's lights16 configuration through
    make_cached_renderer_stats over the first LIGHTS16_FRAMES viewpoints of
    its path (pair caps and sun cache as its entry, raster_cached, makes
    them; the scene from its generator): every frame and its stats equal to
    the eager cached frame's, K1, K3, K4, K6, K15 and K16 launched (the
    graph's replays counted); K15's call of the first frame bit-exact
    against its plain version, its CUDA-event ms, device ms and byte floor.
    Returns K16's recorded call of the first frame."""
    import torch

    from arctic_tpu_torch.models import pipeline
    from arctic_tpu_torch.ops import pbr
    from arctic_tpu_torch.utils import kernels

    label = "7e lights16"
    cfg, bufs, frames, config, cache = lights16_setup(device, LIGHTS16_FRAMES)
    render = pipeline.make_cached_renderer_stats(config, device)
    with kernels.record_calls() as calls:  # the first frame: the front end eager
        render(bufs, *frames[0], cache)
        torch.cuda.synchronize()
    times, all_stats, imgs, _, mem = fly_through(
        render, bufs, frames, DEFAULT_PATH, label, cache,
        absent=("tile_tap_resolve", "window_lut_q", "pcf_eval", "transpose_pack_rows"),
    )
    if render.front.replays < LIGHTS16_FRAMES - 1:
        raise RuntimeError(f"{label}: {render.front.replays} graph replays over "
                           f"{LIGHTS16_FRAMES} frames")
    for k, ((params, settings), img, st) in enumerate(zip(frames, imgs, all_stats)):
        want, wst = pipeline.render_frame_stats(bufs, params, settings, config, cache)
        same_frame(img, want, f"{label} frame {k}", "the eager cached frame")
        if int_stats(st) != int_stats(wst):
            raise RuntimeError(f"{label} frame {k}: stats {int_stats(st)}, eager {int_stats(wst)}")
    (args, kw), = calls["shade_lights"]
    if pbr.light_count(args[6], kw.get("count")) != cfg["static_point_lights"]:
        raise RuntimeError(f"{label}: K15 shaded {pbr.light_count(args[6], kw.get('count'))} lights")
    k15 = compare_kernels({"shade_lights": calls["shade_lights"]}, label, ("shade_lights",),
                          timed=("shade_lights",))["shade_lights"]
    dev_ms = device_ms(lambda: pbr.shade_lights(*args, **kw), 50)
    log(f"{label}: {LIGHTS16_FRAMES} frames ({render.front.replays} graph replays) bit-equal to "
        f"the eager cached frames, stats equal; median {statistics.median(times):.3f} ms/frame, "
        f"{_mem(mem)}; K15 at {args[0].shape[2]} x {args[0].shape[1]} with "
        f"{cfg['static_point_lights']} lights: bit-exact vs plain, kernel {k15['ms']:.4f} ms "
        f"(device {dev_ms:.4f} ms), plain {k15['plain_ms']:.4f} ms, floor "
        f"{k15['bound_ms']:.4f} ms ({k15['bound_by']}), share {k15['bound_ms'] / dev_ms:.2%} "
        f"of the device time")
    return calls["pcf_runs"]


def k16_gate(calls, label: str) -> dict:
    """K16 pcf_runs on a frame's recorded call: bit-exact against its plain
    version, its CUDA-event ms and device ms, the plain version's ms, its
    bytes and operations floors apart, and its registers, spill bytes,
    block and blocks a SM from the card's runtime."""
    import torch

    from arctic_tpu_torch.ops import shadow
    from arctic_tpu_torch.utils import kernels

    out = compare_kernels({"pcf_runs": calls}, label, ("pcf_runs",),
                          timed=("pcf_runs",))["pcf_runs"]
    (args, kw), = calls
    dev_ms = device_ms(lambda: shadow.pcf_runs(*args, **kw), 50)
    bytes_ms, ops_ms = bound_ms("pcf_runs", args, kw)
    attrs = kernels.attributes("arctic_pcf_runs_attributes", torch.device("cuda"))
    out["extra"] = dict(**attrs, device_ms=dev_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)
    x = args[1]
    log(f"K16 gate ({label}) at {x.shape[1]} x {x.shape[0]} over a {args[0].shape[0]}^2 map "
        f"(row pitches {args[0].stride(0)} / {x.stride(0)}): bit-exact vs plain; kernel "
        f"{out['ms']:.4f} ms (device {dev_ms:.4f} ms), plain {out['plain_ms']:.4f} ms, floors: "
        f"bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms; share "
        f"{out['bound_ms'] / dev_ms:.2%} of the device time; {attrs['registers']} registers and "
        f"{attrs['spill_bytes']} spill bytes a thread, {attrs['block']}-thread blocks, "
        f"{attrs['blocks_per_sm']} a SM")
    return {"pcf_runs": out}


def lights16_split() -> dict:
    """The eager traced lights16 frames of 7f, for the program on sys.path:
    the configuration as lights16_setup builds it, SPLIT_WARM frames, then
    SPLIT_FRAMES frames through render_frame_stats (no graph) under
    torch.profiler. For each of SPLIT_RANGES: its device span (first to
    last device op launched in it, as render_bench's range readers take
    it), the device's busy time inside that span and the device ops in it,
    per frame; and the frames' busy time and ops. The eager frame is paced
    by the host, so a span holds idle time; its busy time is the pass's
    device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arctic_tpu_torch.models import pipeline
    from render_bench.work.trace import _union

    device = torch.device("cuda")
    _, bufs, frames, config, cache = lights16_setup(device, SPLIT_WARM + SPLIT_FRAMES)
    for params, settings in frames[:SPLIT_WARM]:
        pipeline.render_frame_stats(bufs, params, settings, config, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for params, settings in frames[SPLIT_WARM:]:
            pipeline.render_frame_stats(bufs, params, settings, config, cache)
        torch.cuda.synchronize()
    events = prof.events()
    ranges = set(SPLIT_RANGES) | {e.name for e in events if e.device_type != DeviceType.CUDA
                                  and getattr(e, "is_user_annotation", False)}
    spans, ops = {}, []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            iv = (e.time_range.start, e.time_range.end)
            (spans.setdefault(e.name, []) if e.name in ranges else ops).append(iv)
    ops = np.asarray(ops, np.float64).reshape(-1, 2)
    busy = _union(ops)
    n = SPLIT_FRAMES
    out = {"device": torch.cuda.get_device_name(0), "frames": n,
           "busy_ms": float((busy[:, 1] - busy[:, 0]).sum()) / 1e3 / n, "ops": len(ops) / n,
           "ranges": {}}
    for name in SPLIT_RANGES:
        span = busy_in = count = 0.0
        for lo, hi in spans.get(name, []):
            span += hi - lo
            busy_in += float(np.clip(np.minimum(busy[:, 1], hi) - np.maximum(busy[:, 0], lo),
                                     0, None).sum())
            count += int(((ops[:, 0] >= lo) & (ops[:, 0] < hi)).sum())
        out["ranges"][name] = {"span_ms": span / 1e3 / n, "busy_ms": busy_in / 1e3 / n,
                               "ops": count / n}
    return out


def split_main(root: str) -> int:
    """``--split-in DIR``: lights16_split for the program of the checkout at
    DIR (this commit's or another's); prints {"split": ...}."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    from arctic_tpu_torch.models import pipeline

    pipeline.use_full_f32()
    print(json.dumps({"split": lights16_split()}), flush=True)
    return 0


def run_pcf_split(parent: str | None) -> None:
    """7f: lights16_split for this checkout and, with ``--parent DIR``, for
    the checkout at DIR (a parent commit's archive), each in a process of
    its own, one after the other: the eager lights16 frame's device time
    by range, printed."""
    for name, root in (("this tree", REPO), ("parent", parent)):
        if root is None:
            continue
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--split-in", root],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"7f split of {name} ({root}): exit {proc.returncode}\n"
                               f"{proc.stderr[-4000:]}")
        split = json.loads(proc.stdout.strip().splitlines()[-1])["split"]
        log(f"7f eager lights16 frames of {name}: {split['frames']} traced, device busy "
            f"{split['busy_ms']:.4f} ms and {split['ops']:.1f} ops a frame")
        for rng, r in split["ranges"].items():
            log(f"7f {name} range {rng}: device busy {r['busy_ms']:.4f} ms, span "
                f"{r['span_ms']:.4f} ms, {r['ops']:.1f} ops a frame")


def once_ms(fn) -> float:
    """CUDA-event ms of one call of ``fn`` (no warm-up: for the lockstep plain
    K14, whose runs take seconds)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def k14_timing(real_calls, work_stats) -> dict:
    """K14's row: CUDA-event ms per ray-traced frame (frame 0's calls: the
    primary and the sun rays), the plain version's on the same calls (one
    run each), and the bound of the work the plain version counted on every
    K14_SAMPLE-th ray, scaled to all rays: the larger of (each ray's 44 B of
    inputs and outputs plus the distinct nodes and triangles the sample
    read: a lower bound of what all rays read) over the HBM rate and the
    f32 operations of the node visits and triangle tests over the f32
    rate. The timed plain run's hits hold K14's on every ray of each call
    bit-exact, on the image's 8 x 4 warp tiles the frame passes (``width``)
    and in linear order (width 0, also timed); its per-ray node visits give
    the warps' lockstep efficiency under both mappings
    (rt.lockstep_efficiency). K14's registers, spill bytes and block size
    come from the card's runtime."""
    import torch

    from arctic_tpu_torch.ops import rt
    from arctic_tpu_torch.utils import kernels

    ms = linear_ms = plain_ms = t_bytes = t_ops = 0.0
    lockstep = {"linear": [], "tiles": []}
    for (args, kw), (n_rays, st) in zip(real_calls["bvh_trace"], work_stats):
        linear = {**kw, "width": 0}
        ms += cuda_ms(lambda: rt.trace(*args, **kw), 10)
        linear_ms += cuda_ms(lambda: rt.trace(*args, **linear), 10)
        plain, full = [], {}
        plain_ms += once_ms(lambda: plain.append(rt.trace_plain(*args, **kw, stats=full)))
        for got in (rt.trace(*args, **kw), rt.trace(*args, **linear)):
            for a, b in zip(_tensors(got), _tensors(plain[0])):
                if max_abs_diff(a, b) != 0.0:
                    raise RuntimeError(f"real size: bvh_trace differs from its plain version on "
                                       f"{n_rays} rays (max {max_abs_diff(a, b)})")
        lockstep["linear"].append(rt.lockstep_efficiency(full["visits"]))
        lockstep["tiles"].append(rt.lockstep_efficiency(full["visits"], kw["width"]))
        nbytes = rt.RAY_BYTES * n_rays + rt.NODE_BYTES * st["nodes"] + rt.TRI_BYTES * st["tris"]
        ops = K14_SAMPLE * (rt.NODE_OPS * st["node_visits"] + rt.TRI_OPS * st["tri_tests"])
        t_bytes += nbytes / HBM_BYTES_PER_S * 1e3
        t_ops += ops / F32_OPS_PER_S * 1e3
        log(f"K14 real-size call of {n_rays} rays (width {kw['width']}, any_hit "
            f"{kw.get('any_hit', False)}): {full['node_visits']} node visits, {full['tri_tests']} "
            f"triangle tests on all rays (longest ray {int(full['visits'].max())} visits); "
            f"lockstep efficiency linear {lockstep['linear'][-1]:.4f}, 8 x 4 tiles "
            f"{lockstep['tiles'][-1]:.4f}")
    attrs = kernels.attributes("arctic_bvh_trace_attributes", torch.device("cuda"))
    out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               extra=dict(**attrs, mapping=rt.MAPPING, linear_ms=linear_ms,
                          lockstep_linear=lockstep["linear"], lockstep_kept=lockstep["tiles"]))
    log(f"K14 per ray-traced frame (primary + sun rays, real size): bit-exact vs plain on every "
        f"ray in both mappings; kernel {ms:.4f} ms ({rt.MAPPING}), linear order "
        f"{linear_ms:.4f} ms, plain {plain_ms:.4f} ms (counting each ray's work), bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}; bytes {t_bytes:.4f} ms, operations "
        f"{t_ops:.4f} ms, counted on every {K14_SAMPLE}th ray and scaled), share "
        f"{out['bound_ms'] / ms:.2%}; {attrs['registers']} registers and {attrs['spill_bytes']} "
        f"spill bytes a thread, {attrs['block']}-thread blocks, {attrs['blocks_per_sm']} a SM")
    return out


def k14_synthetic_calls(device) -> dict:
    """K14 on utils/synthetic.py's rays, closest and any hit, and K15 on its
    planes."""
    from arctic_tpu_torch.utils import synthetic

    calls = [synthetic.k14_inputs(device, case, any_hit)
             for case in synthetic.K14_CASES for any_hit in (False, True)]
    log(f"synthetic inputs: K14 cases {', '.join(synthetic.K14_CASES)} (closest and any hit); "
        f"K15 cases {', '.join(synthetic.K15_CASES)}")
    return {"bvh_trace": calls,
            "shade_lights": [synthetic.k15_inputs(device, case) for case in synthetic.K15_CASES]}


def k15_gate(real_calls) -> dict:
    """The K15 gate: K15 shade_lights on the real-size (1920 x 1080, 4
    lights) ray-traced frame 0's inputs: bit-exact against its plain
    version, its CUDA-event ms and device ms, the plain version's ms and
    the byte floor (60 B a pixel over the HBM rate); K15's registers, spill
    bytes, block and blocks a SM from the card's runtime."""
    import torch

    from arctic_tpu_torch.ops import pbr
    from arctic_tpu_torch.utils import kernels

    out = compare_kernels({"shade_lights": real_calls["shade_lights"]}, "ray-traced real-size",
                          ("shade_lights",), timed=("shade_lights",))["shade_lights"]
    (args, kw), = real_calls["shade_lights"]
    dev_ms = device_ms(lambda: pbr.shade_lights(*args, **kw), 50)
    attrs = kernels.attributes("arctic_shade_lights_attributes", torch.device("cuda"))
    out["extra"] = dict(**attrs, device_ms=dev_ms)
    log(f"K15 gate at {args[0].shape[2]} x {args[0].shape[1]}: bit-exact vs plain; kernel "
        f"{out['ms']:.4f} ms (device {dev_ms:.4f} ms), plain {out['plain_ms']:.4f} ms, floor "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}), share "
        f"{out['bound_ms'] / dev_ms:.2%} of the device time; {attrs['registers']} registers and "
        f"{attrs['spill_bytes']} spill bytes a thread, {attrs['block']}-thread blocks, "
        f"{attrs['blocks_per_sm']} a SM")
    return {"shade_lights": out}


RANGES = ("shadow_pass", "forward_visibility", "forward_shade_skybox", "pcf_shadow",
          "pbr_lights", "post_process")


def profile_frames(render, bufs, frames, path: str, *extra) -> None:
    """torch.profiler over real-size frames of one path: device kernel time
    and busy share, host time and device span of each frame-graph pass
    (record_function ranges) and the top kernels; the table and a chrome
    trace go to build/chip_smoke/ under the path's name."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for params, settings in frames:
            render(bufs, params, settings, *extra)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    n = len(frames)
    kernels_us = collections.Counter()
    count = collections.Counter()
    host_us = collections.Counter()
    span_us = collections.Counter()
    for e in prof.events():
        dur = e.time_range.elapsed_us()
        if e.name in RANGES:
            (span_us if e.device_type == DeviceType.CUDA else host_us)[e.name] += dur
        elif e.device_type == DeviceType.CUDA:
            kernels_us[e.name] += dur
            count[e.name] += 1
    busy_ms = sum(kernels_us.values()) / 1e3
    lines = [
        f"profile {path}: {n} frames, wall {wall_ms / n:.3f} ms/frame with the profiler on, "
        f"device kernel time {busy_ms / n:.3f} ms/frame, busy share {busy_ms / wall_ms:.4f}, "
        f"{sum(count.values()) // n} device ops/frame"
    ]
    for rng in RANGES:
        lines.append(f"profile {path} range {rng}: host {host_us[rng] / 1e3 / n:.3f} ms/frame, "
                     f"device span {span_us[rng] / 1e3 / n:.3f} ms/frame")
    for name, us in kernels_us.most_common(15):
        lines.append(f"profile {path} kernel {us / 1e3 / n:8.3f} ms/frame x{count[name] // n:5d}  {name[:100]}")
    for line in lines:
        log(line)
    with open(os.path.join(OUT_DIR, f"chip_smoke_profile_{path}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"chip_smoke_trace_{path}.json"))


def _tensors(out):
    import dataclasses

    if dataclasses.is_dataclass(out):  # K14's Hits
        out = tuple(getattr(out, f.name) for f in dataclasses.fields(out))
    return [t for t in (out if isinstance(out, tuple) else (out,)) if t is not None]


def max_abs_diff(a, b) -> float:
    """Max |a - b| where both are numbers; inf if the shapes, dtypes or NaN
    positions differ (NaNs sit in never-binned dead slots of the shade-row
    table and in the channels no one reads of K9's output — a tile row's
    bits seen as f32 — the same in both versions). Where neither side is
    NaN, equal bit patterns count as equal (so do two equal infinities)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if a.dtype == torch.uint16:
        a, b = a.to(torch.int32), b.to(torch.int32)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    a, b = a[~nan_a], b[~nan_b]
    differ = a != b
    if not bool(differ.any()):
        return 0.0
    return (a[differ].double() - b[differ].double()).abs().max().item()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` launches, CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` launches: the device first
    spins (about 50 ms) while the host queues every launch, so the CUDA
    events time the device's work alone and not a wrapper's host time
    (which cuda_ms includes where it is the longer). Raises if the host had
    not queued them when the spin ended."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise RuntimeError("device_ms: the device reached the launches before the host queued them")
    end.synchronize()
    return start.elapsed_time(end) / reps


def _distinct(idx, size: int) -> int:
    """How many distinct values in [0, size) the index tensor holds."""
    import torch

    seen = torch.zeros(size, dtype=torch.bool, device=idx.device)
    seen[idx.reshape(-1).long()] = True
    return int(seen.sum())


def work(name, args, kw):
    """(bytes, f32 operations) that one call's function needs on these
    inputs: each input byte it must read once (distinct table rows and
    texels only), each output byte written once, and the arithmetic its
    data needs (pairs actually binned, pixels actually covered, penumbra
    rows actually listed)."""
    import torch

    from arctic_tpu_torch.ops import raster_tiles, shadow

    if name == "raster_tiles":
        rows, _, sorted_slot, tile_start, tiles_x, tiles_y, th, tw = args[:8]
        n = int(tile_start[-1])
        px = tiles_x * tiles_y * th * tw
        outputs = 1 if kw.get("depth_only") else 2
        nbytes = 4 * (n + tile_start.numel() + 12 * _distinct(sorted_slot[:n], rows.shape[0])
                      + outputs * px)
        # per (pair, pixel) inside its three edges — the depth tests any exact
        # raster of these lists makes: 4 planes x (2 mul + 2 add), 6 compares
        return nbytes, 22 * raster_tiles.covered_pair_pixels(*args, **kw)
    if name == "pack_shade_rows":
        pf, st, p = args
        return 4 * pf.shape[1] * (48 + 56 + 128), 264 * p
    if name == "select_interp":
        rows, ibuf = args
        cov = ibuf >= 0
        hw = ibuf.numel()
        nbytes = 4 * hw + 512 * _distinct(ibuf[cov], rows.shape[0]) + 4 * 64 * hw
        return nbytes, 137 * int(cov.sum())
    if name == "tap_resolve":
        table, idx, tq, eq = args[:4]
        n = idx.numel()
        c4 = kw["c4"]
        # 7 per-pixel inputs, each 2-byte lane of the table that a pixel's
        # texture quad (c4 lanes) or env quad (16 lanes) covers, once, and
        # 16 f32 planes out
        per = 128 // c4
        lanes = torch.zeros(table.numel(), dtype=torch.bool, device=idx.device)
        for key, k, width in ((idx.long() * per + tq, per, c4), (idx.long() * 8 + eq, 8, 16)):
            key = torch.unique(key)
            first = key // k * 128 + key % k * width
            lanes[first[:, None] + torch.arange(width, device=key.device)] = True
        return 4 * 7 * n + 2 * int(lanes.sum()) + 4 * 16 * n, 9 * (c4 // 4 + 4) * n
    if name == "tile_tap_resolve":
        table, idx = args[:2]
        n = idx.numel()
        # 8 per-pixel inputs, the distinct 512 B rows, 16 f32 planes out;
        # 8 channels x (4 dequantise + 9 lerp) + 4 env channels x 9 lerp
        return 4 * 8 * n + 512 * _distinct(idx, table.shape[0]) + 4 * 16 * n, 140 * n
    if name == "window_lut_q":
        src, s, y_range = args
        lo, hi = y_range.tolist()
        band = max(0, min(hi + 3, s + 3) - max(lo, 0) + 1)
        return 4 * min(s, band) * s + 2 * (s + 4) * shadow.lut_pitch(s), 5 * band * (s + 4)
    if name == "pcf_eval":
        lut, order, rows_used, start_y, start_x = args[:5]
        n = order.numel()
        live = order[: min(int(rows_used[0]), n)].long()
        pix = (live[:, None] * 128 + torch.arange(128, device=live.device)).reshape(-1)
        base = start_y.reshape(-1)[pix].long() * lut.shape[1] + start_x.reshape(-1)[pix].long()
        win = torch.tensor([r * lut.shape[1] + c for r in range(4) for c in range(4)],
                           device=base.device)
        texels = _distinct(base[:, None] + win, lut.numel())
        # dequantise 16, 5 x (add, floor, sub), 25 x (3 + 9 lerp + 2)
        return 4 * (n + 1) + 20 * pix.numel() + 2 * texels + 4 * 128 * n, 381 * pix.numel()
    if name == "transpose_pack_rows":
        (stacked,) = args
        return 2 * 4 * stacked.numel(), 0
    if name == "pack_shade_rows_tm":
        pf, tri, st, p = args
        return 4 * (pf.shape[1] * (24 + 56 + 128) + tri.numel()), 264 * p
    if name == "window_lut":
        src, s = args
        return 4 * s * s + 4 * (s + 4) * shadow.window_pitch(s), 0
    if name == "shade_lights":
        import inspect

        from arctic_tpu_torch.ops import pbr

        call = inspect.signature(pbr.shade_lights_plain).bind(*args, **kw)
        call.apply_defaults()
        wp, params = call.arguments["wp"], call.arguments["params"]
        spotlights, visibility = call.arguments["spotlights"], call.arguments["visibility"]
        px = wp.shape[1] * wp.shape[2]
        lights = pbr.light_count(params, call.arguments["count"])
        cones = spotlights and params.point_lights.spot_dir is not None
        rows = 0 if visibility is None else lights
        per_light = K15_TERM_OPS + K15_LIGHT_OPS + (K15_CONE_OPS if cones else 0) + bool(rows)
        ops = K15_PIXEL_OPS + K15_TERM_OPS + lights * per_light
        return (pbr.SHADE_BYTES + 4 * rows) * px, ops * px
    if name == "pcf_runs":
        smap, x, y, z = args
        s = smap.shape[0]
        outside, start_y, start_x = shadow._window_coords(x, y, z, s)[:3]
        inside = ~outside
        n_in = int(inside.sum())
        ry = [(start_y[inside].long() + (r - 2)) % s for r in range(4)]
        cx = [(start_x[inside].long() + (c - 2)) % s for c in range(4)]
        texels = _distinct(torch.stack([a * s + b for a in ry for b in cx]), s * s)
        # x, y, z in and the fraction out; the inside pixels' window texels
        return 16 * x.numel() + 4 * texels, (K16_PIXEL_OPS * n_in
                                             + K16_SETUP_OPS * (x.numel() - n_in))
    if name == "pcf_resolve":
        lut, start_y, start_x = args
        n = start_y.numel()
        base = start_y.long() * lut.shape[1] + start_x.long()
        win = torch.tensor([r * lut.shape[1] + c for r in range(4) for c in range(4)],
                           device=base.device)
        texels = _distinct(base[:, None] + win, lut.numel())
        # 8 B of origins in, 16 f32 planes out; one dequantising multiply a texel
        return 8 * n + 2 * texels + 4 * 16 * n, 16 * n
    raise KeyError(name)


def bound_ms(name, args, kw):
    """(bytes ms, operations ms) of one call: the bytes it must move over
    the HBM rate and the f32 operations its data needs over the f32 rate;
    its bound is the larger."""
    nbytes, ops = work(name, args, kw)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def compare_kernels(calls, label: str, names, timed=()):
    """Each recorded call of the named kernels: kernel vs plain version on
    the same inputs. Returns {kernel: {"max_abs_err", "ms", "plain_ms",
    "bound_ms", "bound_by"}} for the ``timed`` kernels (times and bounds
    summed over the kernel's calls in one frame; K1's two calls are also
    printed apart), {"max_abs_err"} for the others."""
    import torch

    from arctic_tpu_torch.utils import kernels

    result = {}
    for fn in kernels.KERNELS:
        name = fn.kernel_name
        if name not in names:
            continue
        if name not in calls:
            raise RuntimeError(f"{label}: kernel {name} was not called")
        err, per_call = 0.0, []
        for args, kw in calls[name]:
            got = _tensors(fn(*args, **kw))
            want = _tensors(fn.plain(*args, **kw))
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                d = max_abs_diff(a, b)
                if d != 0.0:
                    raise RuntimeError(f"{label}: {name} differs from its plain version (max {d})")
                err = max(err, d)
            if name in timed:
                per_call.append((cuda_ms(lambda: fn(*args, **kw), 20),
                                 cuda_ms(lambda: fn.plain(*args, **kw), 2),
                                 *bound_ms(name, args, kw)))
        result[name] = dict(max_abs_err=err)
        if name in timed:
            ms, plain_ms, t_bytes, t_ops = (sum(c[i] for c in per_call) for i in range(4))
            b_ms = sum(max(c[2], c[3]) for c in per_call)
            b_by = "bytes" if t_bytes >= t_ops else "operations"
            result[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"{label}: {name} x{len(calls[name])} bit-exact vs plain"
            + (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
               f"({b_by}) per frame" if name in timed else ""))
        if name == "raster_tiles":  # K1's calls apart: the shadow pass, the camera pass
            for (args, kw), (c_ms, c_plain, c_bytes, c_ops) in zip(calls[name], per_call):
                call = "shadow" if kw.get("depth_only") else "camera"
                log(f"{label}: {name} {call} call: kernel {c_ms:.4f} ms, plain "
                    f"{c_plain:.4f} ms, bound {max(c_bytes, c_ops):.4f} ms (bytes "
                    f"{c_bytes:.4f} ms, operations {c_ops:.4f} ms), share "
                    f"{max(c_bytes, c_ops) / c_ms:.1%}")
    return result


def synthetic_calls(device) -> dict:
    """K1 on utils/synthetic.py's 20,480-pair tile (camera layout, ibuf) and
    on the depth-only 4000^2 grid of the same planes, K3 on a slot count
    that is not a multiple of its 32-slot block, K11 on synthetic.K11_CASES,
    K16 on synthetic.K16_CASES, K6 at every quad width,
    K8 on the pitch = s + 4 map at three rows_used and on lists of several
    passes of its grid (rows_used just below and above a multiple of its
    stride, and the whole list): the calls phase 5 holds bit-exact against
    the plain versions."""
    from arctic_tpu_torch.ops import shadow
    from arctic_tpu_torch.utils import synthetic

    tile, grid = synthetic.k1_dense_tile(device), synthetic.k1_grid(device)
    pf, st, p = synthetic.k3_ragged(device)
    starts = grid[0][3]
    log(f"synthetic inputs: K1 one tile of {int(tile[0][3][-1])} pairs; K1 {grid[0][4]}^2 tiles "
        f"of 64, depth only, {int(starts[-1])} pairs, {int((starts[1:] == starts[:-1]).sum())} "
        f"empty tiles; K3 N = {pf.shape[1]} slots (N % 32 = {pf.shape[1] % 32}), p = {p}")
    k11 = [(synthetic.k11_inputs(device, case), {}) for case in synthetic.K11_CASES]
    log("synthetic inputs: K11 (N, cap, p) " + ", ".join(
        f"{case} {synthetic.K11_CASES[case]}" for case in synthetic.K11_CASES))
    k6 = [synthetic.k6_inputs(device, c4) for c4 in synthetic.K6_WIDTHS]
    k8 = [synthetic.k8_inputs(device, used) for used in synthetic.K8_ROWS_USED]
    stride = shadow.pcf_eval_stride(device)
    strided = [synthetic.k8_strided(device, stride, case) for case in synthetic.K8_STRIDED]
    lut = k8[0][0][0]
    log(f"synthetic inputs: K6 c4 = {', '.join(str(c4) for c4 in synthetic.K6_WIDTHS)} over "
        f"{synthetic.K6_PIXELS} pixels of a {synthetic.K6_ROWS}-row table; K8 s = "
        f"{synthetic.K8_SIDE}, table {tuple(lut.shape)}, {synthetic.K8_ORDER_LEN} listed rows, "
        f"rows_used {', '.join(str(u) for u in synthetic.K8_ROWS_USED)}; K8 grid stride "
        f"{stride} rows, {strided[0][0][1].shape[0]} listed rows, rows_used "
        f"{', '.join(str(int(args[2][0])) for args, _ in strided)}")
    k8 += strided
    k16 = [synthetic.k16_inputs(device, case) for case in sorted(synthetic.K16_CASES)]
    log("synthetic inputs: K16 (S, H, W) " + ", ".join(
        f"{case} {synthetic.K16_CASES[case]}" for case in sorted(synthetic.K16_CASES)))
    return {"raster_tiles": [tile, grid], "pack_shade_rows": [((pf, st, p), {})],
            "pack_shade_rows_tm": k11, "tap_resolve": k6, "pcf_eval": k8, "pcf_runs": k16}


def k8_vote(qreal_calls) -> None:
    """K8's warp vote on the quantised frame 0's own inputs: the share of
    live warps (32 pixels of a listed row) whose taps all lie where its fast
    selects take them, and K8's time (cuda_ms, and device_ms: the vote saves
    device time, which the wrapper's host time can hide) on these inputs and
    on the same inputs with lanes 0, 32, 64 and 96 of every plane row moved
    to lx = -1, so that no warp takes them (held bit-exact against the plain
    version as well)."""
    import torch

    from arctic_tpu_torch.ops import shadow

    ((args, kw),) = qreal_calls["pcf_eval"]
    order, rows_used, lx, ly, offsets = args[1], args[2], args[6], args[7], args[8]
    live = order[: int(rows_used[0])].long()
    off = torch.tensor(offsets, dtype=torch.float32, device=lx.device)
    ascending = all(a <= b for a, b in zip(offsets, offsets[1:]))
    fast = torch.full((live.numel(), 128), ascending, dtype=torch.bool, device=lx.device)
    for plane in (lx, ly):
        f = torch.floor(plane[live][..., None] + off)  # the f32 add and floor of the taps
        fast &= (f[..., 0] >= 0) & (f[..., 2] == 1) & (f[..., 4] <= 2)
    share = fast.view(-1, 32).all(1).double().mean().item()
    lx_off = lx.clone()
    lx_off[:, ::32] = -1.0
    general = (*args[:6], lx_off, *args[7:])
    if not torch.equal(shadow.pcf_eval(*general, **kw), shadow.pcf_eval.plain(*general, **kw)):
        raise RuntimeError("K8 with no warp on the fast selects differs from its plain version")
    times = {
        inputs: (cuda_ms(lambda: shadow.pcf_eval(*a, **kw), 20),
                 device_ms(lambda: shadow.pcf_eval(*a, **kw), 20))
        for inputs, a in (("voted", args), ("general", general))
    }
    log(f"K8 vote, quant real-size frame 0: {share:.4%} of {fast.numel() // 32} live warps take the "
        f"fast selects; K8 {times['voted'][0]:.4f} ms (device {times['voted'][1]:.4f}), with no "
        f"warp on them {times['general'][0]:.4f} ms (device {times['general'][1]:.4f}; bit-exact "
        f"vs plain)")


def k11_calls(real_calls):
    """K11 on the default real-size frame 0's own K3 inputs: K3's planes
    0:24 as the slot-major rows, its rows 24:42 over the first cap slots as
    the tri-major wc / lsp planes, the static rows, and p = 2 * cap (the
    port's clip-slot count). K11's table must equal K3's from the same
    call. Returns K11's calls for phase 5."""
    import torch

    from arctic_tpu_torch.ops import raster_tiles

    (pf, st, p), kw = real_calls["pack_shade_rows"][0]
    cap = p // 2
    args = (pf[:24].contiguous(), pf[24:42, :cap].contiguous(), st, p)
    got = raster_tiles.pack_shade_rows_tm(*args)
    want = raster_tiles.pack_shade_rows(pf, st, p, **kw)
    torch.cuda.synchronize()
    d = max_abs_diff(got, want)
    log(f"K11 on the default real-size frame 0's K3 planes (p = 2 * cap = {p}, N = "
        f"{pf.shape[1]}): table vs K3's table, max abs diff {d}")
    if d != 0.0:
        raise RuntimeError(f"K11's table differs from K3's on the same frame (max {d})")
    return {"pack_shade_rows_tm": [(args, {})]}


def kernel_resources(library_path) -> dict:
    """Each kernel function's registers, local (spill) bytes a thread,
    shared bytes and SASS instructions in a built kernel library, as
    ``cuobjdump`` (beside nvcc) reads them from its sm_90a code: {mangled
    name: (registers, local bytes, shared bytes, instructions)}, printed.
    Runs on any library this loader built, the parent commit's too."""
    import re

    from arctic_tpu_torch.utils import kernels

    tool = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, str(library_path)], capture_output=True, text=True,
                              check=True).stdout

    usage = {m[1]: (int(m[2]), int(m[4]), int(m[3])) for m in re.finditer(
        r"Function (\S+):\s+REG:(\d+) STACK:\d+ SHARED:(\d+) LOCAL:(\d+)", dump("-res-usage"))}
    code = {}
    for part in dump("-sass").split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        code[name.strip()] = len(re.findall(r"^\s+/\*[0-9a-f]+\*/\s", body, re.M))
    if not usage:
        raise RuntimeError(f"cuobjdump -res-usage listed no kernel function in {library_path}")
    found = {name: (*usage[name], code.get(name)) for name in usage}
    for name, (regs, local, shared, ins) in sorted(found.items()):
        log(f"resources of {name} in {os.path.basename(library_path)}: {regs} registers, "
            f"{local} local bytes, {shared} shared bytes, {ins} instructions")
    return found


def shade_rows_attributes(timing) -> None:
    """K3's and K11's registers, spill bytes, block size and blocks a SM
    (the two instantiations of csrc/pack_shade_rows.cu's kernel template),
    printed with each one's share of its bound, and added to their entries
    of ``timing``."""
    import torch

    from arctic_tpu_torch.utils import kernels

    for name in ("pack_shade_rows", "pack_shade_rows_tm"):
        attrs = kernels.attributes(f"arctic_{name}_attributes", torch.device("cuda"))
        t = timing[name]
        t["extra"] = attrs
        log(f"{name}: {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), share "
            f"{t['bound_ms'] / t['ms']:.2%}; {attrs['registers']} registers and "
            f"{attrs['spill_bytes']} spill bytes a thread, {attrs['block']}-thread blocks, "
            f"{attrs['blocks_per_sm']} a SM")


def k13_calls(qreal_calls):
    """K13 on the quantised real-size frame 0's K7 table and the pixels of
    its listed penumbra rows (K8's inputs): _tap_count over K13's 16 planes
    must equal K8's counts for those rows. Returns K13's calls for phase 5."""
    import torch

    from arctic_tpu_torch.ops import shadow

    (args, kw), = qreal_calls["pcf_eval"]
    lut, order, rows_used, start_y, start_x, z, lx, ly, offsets = args
    n_used = min(int(rows_used[0]), order.shape[0])
    live = order[:n_used].long()
    pix = (live[:, None] * shadow.ROW + torch.arange(shadow.ROW, device=live.device)).reshape(-1)
    sy, sx, zz, lxx, lyy = (a.reshape(-1)[pix].contiguous() for a in (start_y, start_x, z, lx, ly))
    planes = shadow.pcf_resolve(lut, sy, sx)
    rows = [tuple(planes[4 * r + c] for c in range(4)) for r in range(4)]
    count = shadow._tap_count(rows, lxx, lyy, zz, offsets)
    k8 = shadow.pcf_eval(*args, **kw)[:n_used].reshape(-1)
    torch.cuda.synchronize()
    d = max_abs_diff(count, k8)
    log(f"K13 on the quant real-size frame 0's {n_used} penumbra rows ({pix.numel()} pixels): "
        f"_tap_count over its planes vs K8's counts, max abs diff {d}")
    if d != 0.0:
        raise RuntimeError(f"_tap_count over K13's planes differs from K8's counts (max {d})")
    return {"pcf_resolve": [((lut, sy, sx), {})]}


def library_times(full_calls, lut_calls) -> dict:
    """CUDA-event ms of the one PyTorch call that computes each of K10's and
    K12's functions on the same inputs (timed here, used nowhere in the
    port): ``.t().contiguous()`` and the circular ``F.pad``; the padded map
    must equal K12's table without its pitch."""
    import torch
    import torch.nn.functional as F

    from arctic_tpu_torch.ops import shadow

    (stacked,), _ = full_calls["transpose_pack_rows"][0]
    (src, s), _ = lut_calls["window_lut"][0]

    def pad():
        return F.pad(src[None, None], (2, 2, 2, 2), mode="circular")[0, 0]

    if not torch.equal(pad(), shadow.window_lut(src, s)[:, : s + 4]):
        raise RuntimeError("the circular F.pad differs from K12's table")
    out = {
        "transpose_pack_rows": cuda_ms(lambda: stacked.t().contiguous(), 20),
        "window_lut": cuda_ms(pad, 20),
    }
    log(f"library calls: .t().contiguous() {out['transpose_pack_rows']:.4f} ms, circular "
        f"F.pad {out['window_lut']:.4f} ms")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; the port needs a CUDA device")
    # Imported after the device check: outside the repo these imports fail.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from arctic_tpu_torch.models import pipeline, raytrace  # noqa: F401 (registers K14)
    from arctic_tpu_torch.utils import kernels

    t_start = time.perf_counter()
    pipeline.use_full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    lib = kernels.build_library()
    kernels.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> {os.path.basename(lib)}")
    kernel_resources(lib)

    dev = torch.device("cuda")
    config, scene, _, params, settings = entry_scene("cpu")
    t0 = time.perf_counter()
    oracle = golden_frame(scene, params, settings, config)
    log(f"entry f64 golden oracle frame: {time.perf_counter() - t0:.1f} s")
    entry_img, entry_calls = run_entry(dev, oracle)
    _, qentry_calls = run_entry(dev, oracle, pcf_row_cap=ENTRY_ROWS)
    _, tentry_calls = run_entry(dev, oracle, textured=True)
    _, fentry_calls = run_entry(dev, oracle, default_img=entry_img)
    bufs = real_buffers(dev)
    base = tune_caps(bufs, "real-size")
    profile = "--profile" in sys.argv[1:]
    # The paths of earlier slices first, in their order, so that each sees
    # the same retained inputs as before; then the full-stack route and 4f.
    summary, real_calls, counts, real_imgs = run_real(dev, bufs, base, profile)
    qsummary, qreal_calls, qcounts, uncached, qconfig = run_real_quant(dev, bufs, base, profile)
    qreal0 = uncached[0]
    csummary = run_cached(dev, bufs, qconfig, uncached, profile)
    tsummary, treal_calls, tcounts, tconfig, tex_imgs = run_textured(dev, profile)
    fsummary, freal_calls, fcounts = run_full_stack(dev, bufs, base, real_imgs, profile)
    lut_calls, lcounts = run_f32_table_pcf(dev, bufs, base)
    # After the real-size paths, so that each of them sees the caching
    # allocator's history of the parent's script (bytes and peaks compare).
    cli_glb, cli_img = run_cli()
    # The deferred and brute-force frames and the opt-ins, after every
    # earlier phase for the same reason.
    bf_img = run_entry_bruteforce(oracle, entry_img)
    run_entry_deferred(bf_img)
    run_entry_optins()
    run_cli_flags()
    dsummary, dconfig = run_real_deferred(dev, bufs, real_imgs, profile)
    real0 = real_imgs[0]
    del real_imgs
    osummary = run_real_optins(dev, bufs, base, dconfig, profile)
    # This slice's phases after every earlier one, so that each earlier
    # path keeps its allocator history: the per-slot, unmerged, grouped
    # and ray-traced entry frames (3i-3l), then 4j-4l.
    from arctic_tpu_torch.io.procedural import cornell_like_scene, per_slot_materials

    meshes, objects, materials, env = cornell_like_scene()
    slot_calls = run_entry_route("per-slot entry", "per_slot",
                                 (meshes, objects, per_slot_materials(materials), env))
    unmerged_calls = run_entry_route("unmerged entry", "unmerged", cornell_like_scene(),
                                     atlas_dtype=torch.float32)
    grouped_calls = run_entry_grouped()
    rt_entry_calls = run_entry_rt()
    gsummary, greal_calls = run_real_grouped(dev, tconfig, tex_imgs, tsummary["ms_per_frame_median"],
                                             profile)
    del tex_imgs
    rsummary, rreal_calls, rlight_calls, rwork = run_real_rt(dev, bufs, base, profile)
    psummary = run_real_per_slot(dev, profile)
    log(f"real-size ms/frame medians (one call, one card): default "
        f"{summary['ms_per_frame_median']:.3f}, full-stack {fsummary['ms_per_frame_median']:.3f}, "
        f"quant {qsummary['ms_per_frame_median']:.3f}, "
        f"cached sun {csummary['ms_per_frame_median']:.3f}, "
        f"textured {tsummary['ms_per_frame_median']:.3f}, "
        f"deferred {dsummary['ms_per_frame_median']:.3f}, "
        f"opt-ins {osummary['ms_per_frame_median']:.3f}, "
        f"grouped {gsummary['ms_per_frame_median']:.3f}, "
        f"ray-traced {rsummary['ms_per_frame_median']:.3f}, "
        f"per-slot {psummary['ms_per_frame_median']:.3f}")
    # Sharding, the viewer and the debug checks after every earlier phase,
    # so that each earlier path keeps its allocator history (6a-6f).
    import tempfile

    import torch.distributed as dist

    from arctic_tpu_torch.parallel import sharding

    with tempfile.TemporaryDirectory() as tmp:
        sharding.init_group("cuda", "file://" + os.path.join(tmp, "rendezvous"))
        try:
            run_sharded_world1()
            slab_calls = run_slabs_entry()
            real_slab_calls = run_real_sharded(bufs, base, real0)
        finally:
            dist.destroy_process_group()
    run_cli_devices(cli_glb, cli_img, 1)
    run_multi_card(cli_glb, cli_img)
    run_viewer()
    run_debug_checks(entry_img, bufs, base, real0)
    # The shadow and camera tiles after every earlier phase, for the same
    # reason (7a-7d).
    run_entry_tiles(entry_img)
    run_real_tile_slabs(bufs, run_real_tiles(bufs, real0, qreal0, qconfig), real0)
    run_cli_tiles(cli_glb, cli_img)
    k16_calls = run_lights16(dev)
    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    run_pcf_split(parent)
    own = ("window_lut_q", "pcf_eval")
    entry_cmps = [
        compare_kernels(entry_calls, "entry", DEFAULT_PATH),
        compare_kernels(qentry_calls, "quant entry", QUANT_PATH),
        compare_kernels(tentry_calls, "textured entry", TEX_PATH),
        compare_kernels(fentry_calls, "full-stack entry", FULL_PATH),
        compare_kernels(slot_calls, "per-slot entry", PER_SLOT_PATH),
        compare_kernels(unmerged_calls, "unmerged entry", PER_SLOT_PATH),
        compare_kernels(grouped_calls, "grouped entry", TEX_PATH),
        compare_kernels(rt_entry_calls, "ray-traced entry", RT_PATH),
        compare_kernels(greal_calls, "grouped real-size", ("tile_tap_resolve",)),
        compare_kernels({"bvh_trace": rlight_calls["bvh_trace"][2:]},
                        "ray-traced real-size light rays (every ray)", ("bvh_trace",)),
        compare_kernels({"shade_lights": rlight_calls["shade_lights"]},
                        "ray-traced real-size with the light shadows' visibility",
                        ("shade_lights",)),
        compare_kernels(slab_calls, "6b slabs (row0 != 0 but on rank 0)",
                        ("raster_tiles", "select_interp")),
        compare_kernels(real_slab_calls, "6c real-size slabs (row0 != 0 but on rank 0)",
                        ("raster_tiles", "select_interp")),
    ]
    quant = compare_kernels(qreal_calls, "quant real-size", QUANT_PATH, timed=own)
    tex = compare_kernels(treal_calls, "textured real-size", TEX_PATH, timed=("tile_tap_resolve",))
    full = compare_kernels(freal_calls, "full-stack real-size", FULL_PATH,
                           timed=("transpose_pack_rows",))
    # Each kernel's numbers come from the path that owns it: K7 / K8 from
    # the quantised fly-through, K9 from the textured one, K10 from the
    # full-stack one, K12 from the f32 window-table PCF, K11 and K13 from
    # their checks against K3 and K8; the others from the default path.
    timing = {
        **compare_kernels(real_calls, "real-size", DEFAULT_PATH, timed=DEFAULT_PATH),
        **{k: quant[k] for k in own},
        "tile_tap_resolve": tex["tile_tap_resolve"],
        "transpose_pack_rows": full["transpose_pack_rows"],
        **compare_kernels(lut_calls, "f32 window-table PCF", ("window_lut",), timed=("window_lut",)),
        **compare_kernels(k11_calls(real_calls), "K11 on K3's frame planes",
                          ("pack_shade_rows_tm",), timed=("pack_shade_rows_tm",)),
        **compare_kernels(k13_calls(qreal_calls), "K13 on K8's penumbra rows", ("pcf_resolve",),
                          timed=("pcf_resolve",)),
        "bvh_trace": k14_timing(rreal_calls, rwork),
        **k15_gate(rreal_calls),
        **k16_gate(k16_calls, "7e lights16"),
    }
    synth = compare_kernels(synthetic_calls(dev), "synthetic",
                            ("raster_tiles", "pack_shade_rows", "pack_shade_rows_tm",
                             "tap_resolve", "pcf_eval", "pcf_runs"))
    shade_rows_attributes(timing)
    synth.update(compare_kernels(k14_synthetic_calls(dev), "synthetic", RT_PATH))
    (_, k6_kw), = real_calls["tap_resolve"]
    (k8_args, _), = qreal_calls["pcf_eval"]
    log(f"real size: K6 quad width c4 = {k6_kw['c4']}; K8 {int(k8_args[2][0])} live of "
        f"{k8_args[1].shape[0]} listed rows")
    k8_vote(qreal_calls)
    cmps = entry_cmps + [quant, tex, full, timing, synth]
    library = library_times(freal_calls, lut_calls)
    launches = {**counts, **{k: qcounts[k] for k in own},
                "tile_tap_resolve": tcounts["tile_tap_resolve"],
                "transpose_pack_rows": fcounts["transpose_pack_rows"],
                "window_lut": lcounts["window_lut"], "bvh_trace": rsummary["launches"],
                "shade_lights": rsummary["k15_launches"],
                **{k: 0 for k in NO_FRAME}}
    log(f"K11 pack_shade_rows_tm and K13 pcf_resolve: 0 frame launches (no frame calls them, "
        f"as in the JAX package); their rows in the kernels line come from their checks")

    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "arctic_tpu", "PIL"))
    if foreign:
        raise RuntimeError(f"the port imported JAX, the JAX package or Pillow: {foreign}")

    rows = []
    for fn in kernels.KERNELS:
        name = fn.kernel_name
        t = timing[name]
        rows.append(dict(
            name=name, route=fn.route, source=fn.source, replaces=fn.replaces,
            launches=launches[name],
            max_abs_err=max(c[name]["max_abs_err"] for c in cmps
                            if name in c and "max_abs_err" in c[name]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=library.get(name), **t.get("extra", {}),
        ))
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--split-in" in sys.argv:
        sys.exit(split_main(sys.argv[sys.argv.index("--split-in") + 1]))
    sys.exit(main())
