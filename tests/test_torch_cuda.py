"""arctic_tpu_torch on the card: the seven CUDA kernels against their
plain torch versions, and the entry frame, on the default path, on the
quantised PCF path (pcf_row_cap) and on the textured path (the tile atlas,
forced with tile_threshold_texels=0), against the CPU frame.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets JAX up.) Tolerances: the kernels
are built with -fmad=false and must equal their plain versions exactly
(NaN positions included: dead clip slots hold 0/0 planes, and K9's env
channels of a covered pixel are a tile row's bits seen as f32); the frame must
be within 1 u8 LSB of the CPU frame on < 1% of the pixels (different libm
for sin/atan2/pow between the CPU and the card).
"""

import numpy as np
import pytest
import torch

from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import default_scene_params, default_settings, make_camera
from arctic_tpu_torch.io.build import build_buffers
from arctic_tpu_torch.io.procedural import cornell_like_scene
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import raster_tiles, sampling, shadow
from arctic_tpu_torch.utils import kernels

pytestmark = pytest.mark.cuda

W, H, SHADOW = 256, 192, 256
DEFAULT_PATH = ("raster_tiles", "pack_shade_rows", "select_interp", "tap_resolve")
QUANT_PATH = DEFAULT_PATH + ("window_lut_q", "pcf_eval")
TEX_PATH = ("raster_tiles", "pack_shade_rows", "select_interp", "tile_tap_resolve")
ROWS = (W // 64) * (H // 64) * 32  # every 128-pixel row of the frame


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _entry(device, pcf_row_cap=None, textured=False):
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, pcf_row_cap=pcf_row_cap)
    bufs = build_buffers(*cornell_like_scene(), tri_bucket=256, device=device,
                         tile_threshold_texels=0 if textured else None)
    params = default_scene_params(aspect=W / H)
    params.camera = make_camera([0.0, 4.0, 3.0], [-25.0, -90.0], W / H)
    return config, bufs, params, default_settings()


def _same(a, b):
    if a.dtype == torch.uint16:
        a, b = a.to(torch.int32), b.to(torch.int32)
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(a[~nan_a], b[~nan_b])


def _run(device, pcf_row_cap=None, textured=False):
    config, bufs, params, settings = _entry(device, pcf_row_cap, textured)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(bufs, params, settings, config)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cpu_img, cpu_stats = pipeline.render_frame_stats(*_entry("cpu", pcf_row_cap, textured)[1:], config)
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


def test_every_kernel_launches(entry_run, quant_run, tex_run):
    """Each path launches each of its kernels; the default path none of the
    quantised path's own; K6 and K9 never on the same path."""
    for run, path in ((entry_run, DEFAULT_PATH), (quant_run, QUANT_PATH), (tex_run, TEX_PATH)):
        assert min(run["counts"][k] for k in path) >= 1, run["counts"]
    assert entry_run["counts"]["window_lut_q"] == entry_run["counts"]["pcf_eval"] == 0
    assert entry_run["counts"]["tile_tap_resolve"] == quant_run["counts"]["tile_tap_resolve"] == 0
    assert tex_run["counts"]["tap_resolve"] == 0 and tex_run["counts"]["tile_tap_resolve"] == 1


@pytest.mark.parametrize("path", ["default", "quant", "textured"])
def test_entry_frame_matches_cpu(entry_run, quant_run, tex_run, path):
    run = {"default": entry_run, "quant": quant_run, "textured": tex_run}[path]
    cpu_img, cpu_stats = run["cpu"]
    d = (run["img"].cpu().to(torch.int32) - cpu_img.to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
    assert {k: int(v) for k, v in run["stats"].items()} == {
        k: int(v) for k, v in cpu_stats.items()
    }


@pytest.mark.parametrize("name", QUANT_PATH + ("tile_tap_resolve",))
def test_kernel_equals_plain_on_frame_inputs(entry_run, quant_run, tex_run, name):
    run = entry_run if name in DEFAULT_PATH else tex_run if name in TEX_PATH else quant_run
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
