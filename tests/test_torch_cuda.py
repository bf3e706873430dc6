"""arctic_tpu_torch on the card: the thirteen CUDA kernels against their
plain torch versions (K1, K3, K6, K8, K11, K14 and K15 also on the synthetic
inputs of utils/synthetic.py), the ray-traced entry frame (its lighting
through K15 and through the plain version, bit-equal) and the grouped tile
route (K9 once a group and once for the fallback), the entry frame as 2, 3
and 8 slabs of tile rows (parallel/sharding.py: K1 and K4 with row0 != 0),
and the entry frame, on the default path, on the
quantised PCF path (pcf_row_cap), on the textured path (the tile atlas,
forced with tile_threshold_texels=0) and on the full-stack shade-row route
(a Geometry without slot_static_rows: K10 in place of K3), against the CPU
frame; and the brute-force and deferred entry frames, which launch no
kernel, and K1 and K15 alone.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets JAX up.) Tolerances: the kernels
are built with -fmad=false and must equal their plain versions exactly
(NaN positions included: dead clip slots hold 0/0 planes, and K9's env
channels of a covered pixel are a tile row's bits seen as f32); the frame must
be within 1 u8 LSB of the CPU frame on < 1% of the pixels (different libm
for sin/atan2/pow between the CPU and the card); the full-stack frame is
within 1 LSB of the default frame on every pixel (its table equals K3's).
"""

import dataclasses

import numpy as np
import pytest
import torch

from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import (
    PointLights,
    default_scene_params,
    default_settings,
    make_camera,
)
from arctic_tpu_torch.io.build import build_buffers
from arctic_tpu_torch.io.procedural import cornell_like_scene
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import raster_tiles, sampling, shadow
from arctic_tpu_torch.utils import kernels, synthetic

pytestmark = pytest.mark.cuda

W, H, SHADOW = 256, 192, 256
DEFAULT_PATH = ("raster_tiles", "pack_shade_rows", "select_interp", "tap_resolve", "shade_lights")
QUANT_PATH = DEFAULT_PATH + ("window_lut_q", "pcf_eval")
TEX_PATH = ("raster_tiles", "pack_shade_rows", "select_interp", "tile_tap_resolve",
            "shade_lights")
FULL_PATH = ("raster_tiles", "transpose_pack_rows", "select_interp", "tap_resolve",
             "shade_lights")
ROWS = (W // 64) * (H // 64) * 32  # every 128-pixel row of the frame


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _entry(device, pcf_row_cap=None, textured=False, full_stack=False):
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, pcf_row_cap=pcf_row_cap)
    bufs = build_buffers(*cornell_like_scene(), tri_bucket=256, device=device,
                         tile_threshold_texels=0 if textured else None)
    if full_stack:
        geom = dataclasses.replace(bufs.geometry, slot_static_rows=None)
        bufs = dataclasses.replace(bufs, geometry=geom)
    params = default_scene_params(aspect=W / H)
    params.camera = make_camera([0.0, 4.0, 3.0], [-25.0, -90.0], W / H)
    return config, bufs, params, default_settings()


def _same(a, b):
    if a.dtype == torch.uint16:
        a, b = a.to(torch.int32), b.to(torch.int32)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(a[~nan_a], b[~nan_b])


def _run(device, pcf_row_cap=None, textured=False, full_stack=False):
    config, bufs, params, settings = _entry(device, pcf_row_cap, textured, full_stack)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(bufs, params, settings, config)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cpu_img, cpu_stats = pipeline.render_frame_stats(
        *_entry("cpu", pcf_row_cap, textured, full_stack)[1:], config
    )
    return dict(img=img, stats=stats, counts=counts, calls=calls, cpu=(cpu_img, cpu_stats))


@pytest.fixture(scope="module")
def entry_run(cuda):
    return _run(cuda)


@pytest.fixture(scope="module")
def quant_run(cuda):
    return _run(cuda, pcf_row_cap=ROWS)


@pytest.fixture(scope="module")
def tex_run(cuda):
    return _run(cuda, textured=True)


@pytest.fixture(scope="module")
def full_run(cuda):
    return _run(cuda, full_stack=True)


def test_every_kernel_launches(entry_run, quant_run, tex_run, full_run):
    """Each path launches each of its kernels; the default path none of the
    quantised path's own; K6 and K9 never on the same path; K10 only on the
    full-stack route, in place of K3; no frame launches K11, K12 or K13."""
    runs = ((entry_run, DEFAULT_PATH), (quant_run, QUANT_PATH), (tex_run, TEX_PATH),
            (full_run, FULL_PATH))
    for run, path in runs:
        assert min(run["counts"][k] for k in path) >= 1, run["counts"]
        for name in ("pack_shade_rows_tm", "window_lut", "pcf_resolve"):
            assert run["counts"][name] == 0, run["counts"]
    assert entry_run["counts"]["window_lut_q"] == entry_run["counts"]["pcf_eval"] == 0
    assert entry_run["counts"]["tile_tap_resolve"] == quant_run["counts"]["tile_tap_resolve"] == 0
    assert tex_run["counts"]["tap_resolve"] == 0 and tex_run["counts"]["tile_tap_resolve"] == 1
    assert full_run["counts"]["transpose_pack_rows"] == 1 and full_run["counts"]["pack_shade_rows"] == 0
    for run in (entry_run, quant_run, tex_run):
        assert run["counts"]["transpose_pack_rows"] == 0


@pytest.mark.parametrize("path", ["default", "quant", "textured", "full_stack"])
def test_entry_frame_matches_cpu(entry_run, quant_run, tex_run, full_run, path):
    run = {"default": entry_run, "quant": quant_run, "textured": tex_run,
           "full_stack": full_run}[path]
    cpu_img, cpu_stats = run["cpu"]
    d = (run["img"].cpu().to(torch.int32) - cpu_img.to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
    assert {k: int(v) for k, v in run["stats"].items()} == {
        k: int(v) for k, v in cpu_stats.items()
    }


def test_full_stack_frame_matches_default_frame(entry_run, full_run):
    d = (full_run["img"].to(torch.int32) - entry_run["img"].to(torch.int32)).abs()
    assert int(d.max()) <= 1


@pytest.mark.parametrize("field,value", [("force_bruteforce", True), ("fused_shade", False)])
def test_bruteforce_and_deferred_frames_match_cpu(cuda, field, value):
    """The brute-force frame launches no kernel, the deferred frame K1 (shadow
    and camera pass) and K15 (its lights) alone; each is within 1 LSB of its
    CPU frame on < 1% of the values, with equal stats."""
    config, bufs, params, settings = _entry(cuda)
    config = dataclasses.replace(config, **{field: value})
    kernels.reset_launch_counts()
    img, stats = pipeline.render_frame_stats(bufs, params, settings, config)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    deferred = {"raster_tiles": 2, "shade_lights": 1} if field == "fused_shade" else {}
    assert counts == {k: deferred.get(k, 0) for k in counts}
    cpu_img, cpu_stats = pipeline.render_frame_stats(*_entry("cpu")[1:], config)
    d = (img.cpu().to(torch.int32) - cpu_img.to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
    assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in cpu_stats.items()}


@pytest.mark.parametrize("world,pcf_row_cap", [(2, None), (3, None), (8, ROWS)])
def test_slab_frame_equals_single_card_frame(cuda, world, pcf_row_cap):
    """parallel/sharding.render_frame_slabs_stats on the card: the frame is
    the single-card frame bit for bit; every rank launches K1 twice (its
    shadow and camera slab) and K4 once, with row0 != 0 on every rank but
    the first, and each of those calls equals the plain version."""
    from arctic_tpu_torch.parallel import sharding

    config, bufs, params, settings = _entry(cuda, pcf_row_cap)
    single, _ = pipeline.render_frame_stats(bufs, params, settings, config)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        multi, stats = sharding.render_frame_slabs_stats(bufs, params, settings, config, world)
        torch.cuda.synchronize()
    pipeline.check_stats(stats)
    assert torch.equal(multi, single)
    counts = kernels.launch_counts()
    assert counts["raster_tiles"] == 2 * world and counts["select_interp"] == world
    layout = sharding.slab_layout(config, world)
    assert [kw["row0"] for _, kw in calls["select_interp"]] == [
        r * layout.cam_rows * config.tile_h for r in range(world)]
    assert sum(kw["row0"] > 0 for _, kw in calls["raster_tiles"]) == 2 * (world - 1)
    for name in ("raster_tiles", "select_interp"):
        fn = next(k for k in kernels.KERNELS if k.kernel_name == name)
        for args, kw in calls[name]:
            got, want = fn(*args, **kw), fn.plain(*args, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                assert a is None or (a.shape == b.shape and _same(a, b))


@pytest.mark.parametrize("name", QUANT_PATH + ("tile_tap_resolve", "transpose_pack_rows"))
def test_kernel_equals_plain_on_frame_inputs(entry_run, quant_run, tex_run, full_run, name):
    run = (entry_run if name in DEFAULT_PATH else tex_run if name in TEX_PATH
           else full_run if name in FULL_PATH else quant_run)
    fn = next(k for k in kernels.KERNELS if k.kernel_name == name)
    for args, kw in run["calls"][name]:
        got, want = fn(*args, **kw), fn.plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape and _same(a, b)


def _tile_inputs(device, n=5000, rows=64, seed=0):
    """K9 inputs from numpy: a table of random bits (NaN and Inf patterns
    included, as a tile row seen as f32 has) and in-range window origins."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-(2**31), 2**31, (rows, 128), dtype=np.int64).astype(np.int32)
    ints[0, :16] = np.array([0x7F800000, 0xFF800000, 0x7FC00001, 1] * 4, np.uint32).view(np.int32)
    args = [
        ints,
        rng.integers(0, rows, n).astype(np.int32),
        rng.integers(0, 3, n).astype(np.int32),
        rng.integers(0, 7, n).astype(np.int32),
        rng.integers(0, 8, n).astype(np.int32),
    ] + [rng.uniform(0, 1, n).astype(np.float32) for _ in range(4)]
    args[1][:8] = 0  # some pixels read the row with the planted patterns
    return [torch.from_numpy(a).to(device) for a in args]


def test_tile_tap_resolve_equals_plain_on_random_inputs(cuda):
    """K9 against its plain version on the card and on the CPU, bit for bit
    (NaN positions included), and its launch counter."""
    args = _tile_inputs(cuda)
    kernels.reset_launch_counts()
    got = sampling.tile_tap_resolve(*args)
    torch.cuda.synchronize()
    assert sampling.tile_tap_resolve.launches == 1
    want = sampling.tile_tap_resolve_plain(*args)
    cpu = sampling.tile_tap_resolve(*(a.cpu() for a in args))
    assert sampling.tile_tap_resolve.launches == 1  # the plain versions launch nothing
    assert got.shape == (16, args[1].shape[0]) and got.dtype == torch.float32
    assert _same(got, want) and _same(got.cpu(), cpu)


def test_wrappers_raise_on_bad_cuda_input(cuda):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    rows = torch.zeros((64, 128), dtype=torch.float64, device=cuda)
    ibuf = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        raster_tiles.select_interp(rows, ibuf)
    idx = torch.zeros(16, dtype=torch.int64, device=cuda)
    f = torch.zeros(16, device=cuda)
    table = torch.zeros((4, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        sampling.tap_resolve(table, idx, idx, idx, f, f, f, f, c4=32)
    band = torch.tensor([0, 64], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        shadow.window_lut_q(rows, 64, band)
    lut = shadow.window_lut_q(rows.float(), 64, band)
    planes = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        shadow.pcf_eval(lut, planes[0, :1], planes[0, :1], planes, planes, planes, planes,
                        planes, shadow.tap_offsets(64))
    args = _tile_inputs(cuda, n=256)
    bad_dtype = list(args)
    bad_dtype[1] = args[1].long()
    with pytest.raises(ValueError, match="int32"):
        sampling.tile_tap_resolve(*bad_dtype)
    bad_device = list(args)
    bad_device[5] = args[5].cpu()
    with pytest.raises(ValueError, match="CUDA"):
        sampling.tile_tap_resolve(*bad_device)
    bad_shape = list(args)
    bad_shape[2] = args[2][:128]
    with pytest.raises(ValueError, match="shape"):
        sampling.tile_tap_resolve(*bad_shape)
    bad_table = list(args)
    bad_table[0] = args[0][:, :64].contiguous()
    with pytest.raises(ValueError, match="shape"):
        sampling.tile_tap_resolve(*bad_table)


def _random_case(name, device):
    """Inputs from numpy for one of K10-K13 (ragged sizes: N not a multiple
    of the tiles, a strided map)."""
    rng = np.random.default_rng(11)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    s = 61
    if name == "transpose_pack_rows":
        return raster_tiles.transpose_pack_rows, (f32(128, 1000),)
    if name == "pack_shade_rows_tm":
        return raster_tiles.pack_shade_rows_tm, (f32(24, 1100), f32(18, 500), f32(56, 1100), 1001)
    big = torch.from_numpy(rng.uniform(0.0, 1.0, (s + 7, s + 40)).astype(np.float32)).to(device)
    if name == "window_lut":
        return shadow.window_lut, (big[:s, :s], s)
    lut = shadow.window_lut_q_plain(big.cpu(), s, torch.tensor([0, s], dtype=torch.int32)).to(device)
    origin = [torch.from_numpy(rng.integers(0, s + 1, 3000).astype(np.int32)).to(device) for _ in range(2)]
    return shadow.pcf_resolve, (lut, *origin)


@pytest.mark.parametrize("name", ["transpose_pack_rows", "pack_shade_rows_tm", "window_lut",
                                  "pcf_resolve"])
def test_new_kernels_equal_plain_on_random_inputs(cuda, name):
    """K10-K13 against their plain versions on the card and on the CPU, bit
    for bit, and their launch counters."""
    fn, args = _random_case(name, cuda)
    kernels.reset_launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == 1
    want = fn.plain(*args)
    cpu = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    assert fn.launches == 1  # the plain versions launch nothing
    assert _same(got, want) and _same(got.cpu(), cpu)


def _synthetic_case(name, device):
    """K1's, K3's and K11's synthetic inputs (utils/synthetic.py), as
    chip_smoke's phase 5 makes them."""
    if name == "k1_dense_tile":
        return raster_tiles.raster_tiles, *synthetic.k1_dense_tile(device)
    if name == "k1_dense_tile_scalar_rows":  # lane0 % 4 != 0: the scalar row load
        return raster_tiles.raster_tiles, *synthetic.k1_dense_tile(device, lanes=16, lane0=3)
    if name == "k1_grid":
        return raster_tiles.raster_tiles, *synthetic.k1_grid(device)
    if name.startswith("k11_"):
        return raster_tiles.pack_shade_rows_tm, synthetic.k11_inputs(device, name[4:]), {}
    return raster_tiles.pack_shade_rows, synthetic.k3_ragged(device), {}


@pytest.mark.parametrize("name", ["k1_dense_tile", "k1_dense_tile_scalar_rows", "k1_grid",
                                  "k3_ragged"] + [f"k11_{case}" for case in synthetic.K11_CASES])
def test_redesigned_kernels_equal_plain_on_synthetic_inputs(cuda, name):
    """K1 on a 20,480-pair tile (duplicates and equal-z ties inside a
    chunk and across chunk boundaries, slivers, z = +-0, NaN and inf
    planes) and on a
    depth-only 4000^2 grid of the same planes; K3 on a slot count that is
    not a multiple of its 32-slot block; K11 where slot cap falls inside a
    block, past 2 * cap (a zero tail), with N < 2 * cap, N < cap, N < 32 at
    cap = 1 and cap a multiple of 32: bit-equal to the plain versions, one
    launch each."""
    fn, args, kw = _synthetic_case(name, cuda)
    kernels.reset_launch_counts()
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == 1
    want = fn.plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape and _same(a, b)


@pytest.mark.parametrize("name", ["pack_shade_rows", "pack_shade_rows_tm"])
def test_shade_row_kernel_attributes(cuda, name):
    """K3's and K11's attribute queries (the two instantiations of one
    kernel template): 256-thread blocks that an SM holds, registers within
    the card's limit and no spill bytes."""
    attrs = kernels.attributes(f"arctic_{name}_attributes", cuda)
    assert attrs["block"] == 256 and attrs["blocks_per_sm"] >= 1
    assert 0 < attrs["registers"] <= 255 and attrs["spill_bytes"] == 0


# (tile_h, tile_w, depth_only): the sub-tile and its warp rectangles K1
# derives from the tile's sides (raster_tiles.block_layout) — one 16x16
# block, 16x16 sub-tiles of square, wide and tall tiles (a side of 48), 64x4
# sub-tiles of a 12x64 tile, one 32x8 block of 8x4 rectangles, 128x2
# sub-tiles of 16x2 rectangles; then sub-tiles that hang over the tile (a
# 128-pixel tile in half a 16x16 block, a 1-pixel row in a 128x2 block, a
# 1-pixel column in a 2x128 one, 16x24 in two 16x16 blocks) and tiles of
# 8,192 to 65,536 pixels.
TILE_SHAPES = [(16, 16, False), (32, 32, False), (16, 64, False), (48, 16, False),
               (12, 64, False), (8, 32, True), (2, 128, True), (64, 64, True),
               (8, 16, False), (16, 8, False), (1, 128, False), (64, 128, False),
               (128, 128, False), (128, 1, True), (16, 24, True), (256, 256, True)]


@pytest.mark.parametrize("tile_h,tile_w,depth_only", TILE_SHAPES)
def test_k1_equals_plain_at_every_tile_shape(cuda, tile_h, tile_w, depth_only):
    """K1 on a 3 x 2 grid of tile_h x tile_w tiles (utils/synthetic.k1_tiles:
    a 2,000-pair tile, an empty one, sparse ones) is bit-equal to its plain
    version, in one launch: every pixel written once, at its own place."""
    args, kw = synthetic.k1_tiles(cuda, tile_h, tile_w, depth_only)
    kernels.reset_launch_counts()
    got = raster_tiles.raster_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert raster_tiles.raster_tiles.launches == 1
    want = raster_tiles.raster_tiles_plain(*args, **kw)
    assert got[0].shape == (2 * tile_h, 3 * tile_w) and _same(got[0], want[0])
    assert (got[1] is None) == depth_only
    if not depth_only:
        assert torch.equal(got[1], want[1])


K6_K8_CASES = ([f"k6_c4_{c4}" for c4 in synthetic.K6_WIDTHS]
               + [f"k8_rows_used_{u}" for u in synthetic.K8_ROWS_USED]
               + [f"k8_strided_{case}" for case in synthetic.K8_STRIDED])


@pytest.mark.parametrize("case", K6_K8_CASES)
def test_k6_k8_equal_plain_on_synthetic_inputs(cuda, case):
    """K6 at every quad width it takes (every tq and eq, NaN / Inf / +-0 /
    subnormal bf16 lanes, a ragged pixel count) and K8 on the s = 60 map
    (pitch s + 4, windows at the last column and row and at every x0 % 4,
    repeated and out-of-order rows, rows_used at 0, below and at the list's
    length, and a list of several passes of K8's grid with rows_used just
    below and just above a multiple of its stride): bit-equal to the plain
    versions, NaN positions included, in one launch; on the CPU the
    wrappers take the plain versions."""
    kind, value = case.split("_")[0], case.rsplit("_", 1)[1]
    if kind == "k6":
        fn, (args, kw) = sampling.tap_resolve, synthetic.k6_inputs(cuda, int(value))
    elif case.startswith("k8_strided"):
        stride = shadow.pcf_eval_stride(cuda)
        fn, (args, kw) = shadow.pcf_eval, synthetic.k8_strided(cuda, stride, value)
        assert args[1].shape[0] > synthetic.K8_PASSES * stride
    else:
        fn, (args, kw) = shadow.pcf_eval, synthetic.k8_inputs(cuda, int(value))
    kernels.reset_launch_counts()
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == 1
    want = fn.plain(*args, **kw)
    cpu = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args), **kw)
    assert fn.launches == 1  # the plain versions launch nothing
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _same(got, want) and _same(got.cpu(), cpu)


def test_kernels_launch_on_the_current_stream(cuda):
    """A wrapper launches on PyTorch's current stream: on a side stream, K6
    and K8 read an input that the same stream fills only after a device
    spin, and still equal their plain versions on the filled input (on
    another stream they would read the zeros before it)."""
    side = torch.cuda.Stream(cuda)
    for fn, (args, kw), at in ((sampling.tap_resolve, synthetic.k6_inputs(cuda, 32), 4),
                               (shadow.pcf_eval, synthetic.k8_inputs(cuda, synthetic.K8_ORDER_LEN), 6)):
        want = fn.plain(*args, **kw)
        late = torch.zeros_like(args[at])
        torch.cuda.synchronize()
        with torch.cuda.stream(side):
            torch.cuda._sleep(10_000_000)
            late.copy_(args[at])
            got = fn(*args[:at], late, *args[at + 1:], **kw)
        side.synchronize()
        assert _same(got, want)
        assert not _same(fn.plain(*args[:at], torch.zeros_like(late), *args[at + 1:], **kw), want)


def test_k6_k8_wrappers_raise_on_layouts_their_loads_do_not_take(cuda):
    """K6 reads its rows with 16-byte loads, K8 its windows with 8-byte
    words: a misaligned or non-contiguous table raises, nothing falls back."""
    args, kw = synthetic.k6_inputs(cuda, 16)
    table = args[0]
    flat = torch.zeros(table.numel() + 4, dtype=torch.bfloat16, device=cuda)
    flat[4:] = table.reshape(-1)
    shifted = flat[4:].view(table.shape)  # contiguous, 8 bytes off a 16-byte boundary
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        sampling.tap_resolve(shifted, *args[1:], **kw)
    wide = torch.zeros((table.shape[0], 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sampling.tap_resolve(wide[:, :128], *args[1:], **kw)
    with pytest.raises(ValueError, match="c4=0"):
        sampling.tap_resolve(table, *args[1:], c4=0)
    args, _ = synthetic.k8_inputs(cuda, synthetic.K8_ORDER_LEN)
    lut = args[0]
    odd = torch.zeros((lut.shape[0], lut.shape[1] + 2), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        shadow.pcf_eval(odd.view(torch.uint16), *args[1:])
    flat = torch.zeros(lut.numel() + 2, dtype=torch.int16, device=cuda).view(torch.uint16)
    with pytest.raises(ValueError, match="8-byte aligned"):
        shadow.pcf_eval(flat[2:].view(lut.shape), *args[1:])


def test_new_wrappers_raise_on_bad_cuda_input(cuda):
    """K10-K13 refuse a dtype, a device or a shape their kernel does not
    take; nothing falls back."""
    stacked = _random_case("transpose_pack_rows", cuda)[1][0]
    with pytest.raises(ValueError, match="float32"):
        raster_tiles.transpose_pack_rows(stacked.double())
    with pytest.raises(ValueError, match="shape"):
        raster_tiles.transpose_pack_rows(stacked[:64].contiguous())
    pf, tri, st, p = _random_case("pack_shade_rows_tm", cuda)[1]
    with pytest.raises(ValueError, match="CUDA"):
        raster_tiles.pack_shade_rows_tm(pf, tri.cpu(), st, p)
    with pytest.raises(ValueError, match="float32"):
        raster_tiles.pack_shade_rows_tm(pf, tri, st.half(), p)
    with pytest.raises(ValueError, match="shape"):
        raster_tiles.pack_shade_rows_tm(pf[:20].contiguous(), tri, st, p)
    with pytest.raises(ValueError, match="p = "):
        raster_tiles.pack_shade_rows_tm(pf, tri, st, pf.shape[1] + 1)
    src, s = _random_case("window_lut", cuda)[1]
    with pytest.raises(ValueError, match="f32"):
        shadow.window_lut(src.double(), s)
    with pytest.raises(ValueError, match="does not hold"):
        shadow.window_lut(src, s + 1)
    lut, sy, sx = _random_case("pcf_resolve", cuda)[1]
    with pytest.raises(ValueError, match="CUDA"):
        shadow.pcf_resolve(lut, sy, sx.cpu())
    with pytest.raises(ValueError, match="int32"):
        shadow.pcf_resolve(lut, sy.long(), sx)
    with pytest.raises(ValueError, match="uint16"):
        shadow.pcf_resolve(lut.to(torch.int32), sy, sx)
    with pytest.raises(ValueError, match="shape"):
        shadow.pcf_resolve(lut, sy, sx[:100])


def _hits_same(a, b):
    return all(_same(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", synthetic.K14_CASES)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_k14_equals_plain_on_synthetic_inputs(cuda, case, any_hit):
    """K14 bvh_trace on utils/synthetic.py's rays, bit-exact against the
    lockstep plain version on the card and on the CPU."""
    from arctic_tpu_torch.ops import rt

    (bvh, o, d, t_max, _), kw = synthetic.k14_inputs(cuda, case, any_hit)
    kernels.reset_launch_counts()
    got = rt.trace(bvh, o, d, t_max, any_hit, **kw)
    torch.cuda.synchronize()
    assert rt.trace.launches == 1
    assert _hits_same(got, rt.trace_plain(bvh, o, d, t_max, any_hit))
    (cbvh, co, cd, ct, _), _ = synthetic.k14_inputs("cpu", case, any_hit)
    assert _hits_same([x.cpu() for x in got], rt.trace_plain(cbvh, co, cd, ct, any_hit))


@pytest.mark.parametrize("per_ray_t_max", [False, True], ids=["t_max", "per_ray_t_max"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_k14_equals_plain_on_image_rays(cuda, any_hit, per_ray_t_max):
    """K14 on utils/synthetic.py's 37 x 23 camera image (neither side a
    multiple of the 8 x 4 warp tile, 851 rays: no multiple of 32), with a
    float or a per-ray t_max: bit-exact against the plain version on the
    image's tiles and in linear order, three launches in a row on one
    stream (each persistent grid's work counter starts again at 0)."""
    from arctic_tpu_torch.ops import rt

    (bvh, o, d, t_max, _), kw = synthetic.k14_inputs(cuda, "image", any_hit)
    assert kw == {"width": synthetic.IMAGE_W} and o.shape[0] % rt.WARP
    if per_ray_t_max:
        rng = np.random.default_rng(5)
        t_max = torch.from_numpy(rng.choice(np.asarray([0.0, 4.0, 8.0, 9.5, np.inf], np.float32),
                                            o.shape[0])).to(cuda)
    want = rt.trace_plain(bvh, o, d, t_max, any_hit)
    assert bool((want.tri >= 0).any()) and bool((want.tri < 0).any())
    kernels.reset_launch_counts()
    runs = [rt.trace(bvh, o, d, t_max, any_hit, width=w) for w in (synthetic.IMAGE_W, 0,
                                                                   synthetic.IMAGE_W)]
    torch.cuda.synchronize()
    assert rt.trace.launches == 3
    assert all(_hits_same(got, want) for got in runs)
    with pytest.raises(ValueError, match="image"):
        rt.trace(bvh, o, d, t_max, any_hit, width=synthetic.IMAGE_W + 1)


def test_rt_entry_frame_matches_cpu(cuda):
    """The ray-traced entry frame with rt_light_shadows: K14 twice plus once
    a light, K15 once, no other kernel, within 1 LSB of the CPU frame on <
    1%."""
    from arctic_tpu_torch.models import raytrace

    config, bufs, params, settings = _entry(cuda)
    config = dataclasses.replace(config, rt_light_shadows=True)
    kernels.reset_launch_counts()
    img = raytrace.make_rt_renderer(config, raytrace.build_scene_bvh(bufs), cuda)(
        bufs, params, settings)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["bvh_trace"] == 2 + params.point_lights.count
    assert counts["shade_lights"] == 1
    assert sum(counts.values()) == counts["bvh_trace"] + 1
    _, cbufs, _, _ = _entry("cpu")
    want = raytrace.make_rt_renderer(config, raytrace.build_scene_bvh(cbufs), "cpu")(
        cbufs, params, settings)
    d = (img.cpu().to(torch.int32) - want.to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d > 0).double().mean()) < 0.01


@pytest.mark.parametrize("case", synthetic.K15_CASES)
def test_k15_equals_plain_on_synthetic_inputs(cuda, case):
    """K15 shade_lights on utils/synthetic.py's planes (metalness and
    roughness at 0 and 1, normals facing away, lit 0 and 1, the eye's and a
    light's own pixel; 0, 4 and 16 lights, cones read or not, a visibility
    stack, interleaved tap planes read in place, NaN / inf / subnormal
    values): one launch, bit-exact against the plain version on the card
    (NaN positions included)."""
    from arctic_tpu_torch.ops import pbr

    args, kw = synthetic.k15_inputs(cuda, case)
    kernels.reset_launch_counts()
    got = pbr.shade_lights(*args, **kw)
    torch.cuda.synchronize()
    assert pbr.shade_lights.launches == 1
    want = pbr.shade_lights_plain(*args, **kw)
    assert got.shape == want.shape == (3, synthetic.K15_H, synthetic.K15_W)
    assert got.is_contiguous() and _same(got, want)


RT_POINT = ((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))
RT_SPOT = ((0.0, 6.0, -5.0), (120.0, 120.0, 120.0), ((0.0, -1.0, 0.0), 20.0, 35.0))


@pytest.mark.parametrize("fields", [{}, {"spotlights": True},
                                    {"spotlights": True, "rt_light_shadows": True}],
                         ids=["point", "spot", "spot_light_shadows"])
def test_rt_frame_with_k15_equals_plain_lighting(cuda, monkeypatch, fields):
    """The Cornell ray-traced frame with a point light and a spotlight: K15
    launched once a frame, and the frame bit-equal to the same frame lit by
    the plain version on the card."""
    from arctic_tpu_torch.models import raytrace
    from arctic_tpu_torch.ops import pbr

    config, bufs, params, settings = _entry(cuda)
    config = dataclasses.replace(config, **fields)
    params.point_lights = PointLights.from_list([RT_POINT, RT_SPOT], spots=True)
    render = raytrace.make_rt_renderer(config, raytrace.build_scene_bvh(bufs), cuda)
    kernels.reset_launch_counts()
    img = render(bufs, params, settings)
    torch.cuda.synchronize()
    assert pbr.shade_lights.launches == 1
    monkeypatch.setattr(raytrace, "shade_lights", pbr.shade_lights_plain)
    want = render(bufs, params, settings)
    assert pbr.shade_lights.launches == 1
    assert img.float().mean() > 5.0 and torch.equal(img, want)


def test_k15_wrapper_raises_on_planes_it_does_not_take(cuda):
    """K15 reads each plane through its channel and pixel strides: planes
    whose pixels are not evenly spaced, of another dtype or shape, or a
    visibility stack of another light count raise; nothing falls back."""
    from arctic_tpu_torch.ops import pbr

    args, kw = synthetic.k15_inputs(cuda, "visibility")
    wp = args[0]
    padded = torch.zeros((3, wp.shape[1], wp.shape[2] + 5), device=cuda)[..., : wp.shape[2]]
    padded.copy_(wp)
    for at, bad, match in ((0, padded, "evenly spaced"), (1, args[1].double(), "float32"),
                           (2, args[2][:, :-1], "shape"), (8, args[8][:3], "shape")):
        with pytest.raises(ValueError, match=match):
            pbr.shade_lights(*args[:at], bad, *args[at + 1:], **kw)
    assert pbr.shade_lights.plain(padded, *args[1:], **kw).shape == padded.shape


def test_grouped_tile_frame_launches_k9_per_group(cuda):
    """The grouped tile route on the card: tests/test_tex_groups.py's six
    materials at 128x128 in groups of 220 rows, caps from
    autotune_tex_group_caps: K9 launched once per group and once for the
    fallback, the frame bit-equal to the plain tile route's, each of its K9
    calls bit-exact against the plain version."""
    from arctic_tpu_torch.io import procedural

    mats = procedural.textured_materials(6, 32)
    meshes = [procedural.plane_mesh(8.0, material=0, uv_scale=2.0),
              procedural.box_mesh(2.0, 2.0, 2.0, material=1),
              procedural.uv_sphere(1.0, 8, 12, material=2),
              procedural.box_mesh(1.0, 3.0, 1.0, material=3),
              procedural.uv_sphere(0.8, 8, 12, material=4),
              procedural.box_mesh(3.0, 1.0, 1.0, material=5)]
    objects = [(procedural.transform(t), i) for i, t in enumerate(
        [(0, 0, 0), (-2.0, 1.0, 0.0), (2.0, 1.0, 0.0), (0.0, 1.5, -2.0), (-1.0, 0.8, 2.0),
         (1.5, 0.5, 2.5)])]
    env = procedural.gradient_environment(16, 32)
    bufs = build_buffers(meshes, objects, mats, env, tri_bucket=512, device=cuda,
                         tile_threshold_texels=0, tex_group_budget=220 * 512,
                         tex_groups=[[0, 5], [1, 4], [2, 3]])
    params = default_scene_params(aspect=1.0)
    params.camera = make_camera([0.0, 4.0, 7.0], [-25.0, -90.0], 1.0)
    config = RenderConfig(width=128, height=128, shadow_size=128)
    plain, _ = pipeline.render_frame_stats(bufs, params, default_settings(), config)
    tuned = pipeline.autotune_tex_group_caps(bufs, params, config)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(bufs, params, default_settings(), tuned)
    torch.cuda.synchronize()
    pipeline.check_stats(stats)
    assert kernels.launch_counts()["tile_tap_resolve"] == len(bufs.atlas.tile_groups) + 1
    assert torch.equal(img, plain)
    for args, kw in calls["tile_tap_resolve"]:
        assert _same(sampling.tile_tap_resolve(*args, **kw),
                     sampling.tile_tap_resolve.plain(*args, **kw))
