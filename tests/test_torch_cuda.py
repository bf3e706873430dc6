"""arctic_tpu_torch on the card: the four CUDA kernels against their plain
torch versions, and the entry frame against the CPU frame.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets JAX up.) Tolerances: the kernels
are built with -fmad=false and must equal their plain versions exactly
(NaN positions included: dead clip slots hold 0/0 planes); the frame must
be within 1 u8 LSB of the CPU frame on < 1% of the pixels (different libm
for sin/atan2/pow between the CPU and the card).
"""

import pytest
import torch

from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import default_scene_params, default_settings, make_camera
from arctic_tpu_torch.io.build import build_buffers
from arctic_tpu_torch.io.procedural import cornell_like_scene
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.ops import raster_tiles, sampling
from arctic_tpu_torch.utils import kernels

pytestmark = pytest.mark.cuda

W, H, SHADOW = 256, 192, 256


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _entry(device):
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW)
    bufs = build_buffers(*cornell_like_scene(), tri_bucket=256, device=device)
    params = default_scene_params(aspect=W / H)
    params.camera = make_camera([0.0, 4.0, 3.0], [-25.0, -90.0], W / H)
    return config, bufs, params, default_settings()


def _same(a, b):
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(a[~nan_a], b[~nan_b])


@pytest.fixture(scope="module")
def entry_run(cuda):
    config, bufs, params, settings = _entry(cuda)
    kernels.reset_launch_counts()
    with kernels.record_calls() as calls:
        img, stats = pipeline.render_frame_stats(bufs, params, settings, config)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    cpu_img, cpu_stats = pipeline.render_frame_stats(*_entry("cpu")[1:], config)
    return dict(img=img, stats=stats, counts=counts, calls=calls, cpu=(cpu_img, cpu_stats))


def test_every_kernel_launches(entry_run):
    assert min(entry_run["counts"].values()) >= 1, entry_run["counts"]


def test_entry_frame_matches_cpu(entry_run):
    cpu_img, cpu_stats = entry_run["cpu"]
    d = (entry_run["img"].cpu().to(torch.int32) - cpu_img.to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01
    assert {k: int(v) for k, v in entry_run["stats"].items()} == {
        k: int(v) for k, v in cpu_stats.items()
    }


@pytest.mark.parametrize("name", ["raster_tiles", "pack_shade_rows", "select_interp", "tap_resolve"])
def test_kernel_equals_plain_on_frame_inputs(entry_run, name):
    fn = next(k for k in kernels.KERNELS if k.kernel_name == name)
    for args, kw in entry_run["calls"][name]:
        got, want = fn(*args, **kw), fn.plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape and _same(a, b)


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
