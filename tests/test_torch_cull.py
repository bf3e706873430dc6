"""RenderConfig.sun_frustum_cull and hdr_half_round on the port's frame, as
the JAX package's tests hold them (tests/test_cull.py:88-130).

- Cull off renders the culled frame bit for bit, with no fewer shadow
  pairs, on a camera close in over one corner where the rect really culls
  (the counts say so, in measure_pair_counts and in the frame's stats),
  and on a camera looking up past all geometry (an empty rect: no shadow
  pairs at all). Both on JAX's own case, 16-pixel shadow tiles on a 256^2
  map, and on a 1024^2 map of the default 64-pixel tiles (the same 16 x 16
  tile grid).
- The f16 HDR round off: the port's frame is within 1 u8 LSB of the JAX
  package's frame with the round off, on < 1% of the pixels (the gate of
  test_torch_pipeline), and within 1 LSB of the port's rounded frame. The
  JAX frame is brute force (it reaches no Pallas kernel) and runs eagerly,
  op by op: at this view XLA's CPU jit contracts a multiply-add into an FMA
  that moves one pixel by 4 LSB, with the round on as with it off, and the
  port rounds every product as the eager ops do.
Cornell at 160x120 (test_cull's size), on one torch thread.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.config import RenderConfig as JRenderConfig
from arctic_tpu.core.scene import default_scene_params as j_default_params
from arctic_tpu.core.scene import default_settings as j_default_settings
from arctic_tpu.io import build as jbuild
from arctic_tpu.io import procedural as jproc
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import default_scene_params, default_settings, make_camera
from arctic_tpu_torch.io import build, procedural
from arctic_tpu_torch.models import pipeline
from arctic_tpu_torch.utils import convert

W, H = 160, 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The suite runs test files in several processes at once; an
    oversubscribed torch thread pool slows these small CPU frames by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bufs():
    return build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device="cpu")


def _params(eye, rot):
    p = default_scene_params(aspect=W / H)
    p.camera = make_camera(eye, rot, W / H)
    return p


@pytest.mark.parametrize("shadow, tile", [(1024, 64), (256, 16)], ids=["map1024", "map256_tile16"])
@pytest.mark.parametrize("eye, rot, empty", [
    ([1.0, 0.5, 1.0], [-30.0, -120.0], False),  # close in over one corner
    ([0.0, 30.0, 0.0], [89.0, 0.0], True),  # straight up past all geometry
], ids=["corner", "sky"])
def test_cull_off_frame_bit_identical(bufs, eye, rot, empty, shadow, tile):
    p = _params(eye, rot)
    on = RenderConfig(width=W, height=H, shadow_size=shadow, shadow_tile=tile)
    off = dataclasses.replace(on, sun_frustum_cull=False)
    assert on.sun_frustum_cull
    _, sh_on = pipeline.measure_pair_counts(bufs, p, on)
    _, sh_off = pipeline.measure_pair_counts(bufs, p, off)
    assert sh_on < sh_off and (sh_on == 0) == empty, (sh_on, sh_off)
    img_on, st_on = pipeline.render_frame_stats(bufs, p, default_settings(), on)
    img_off, st_off = pipeline.render_frame_stats(bufs, p, default_settings(), off)
    pipeline.check_stats(st_on)
    pipeline.check_stats(st_off)
    assert (int(st_on["shadow_pairs"]), int(st_off["shadow_pairs"])) == (sh_on, sh_off)
    np.testing.assert_array_equal(img_on.numpy(), img_off.numpy())


def test_hdr_half_round_off_matches_jax():
    jb = jbuild.build_buffers(*jproc.cornell_like_scene(), tri_bucket=256)
    jp = j_default_params(aspect=W / H)
    jp = dataclasses.replace(jp, camera=dataclasses.replace(
        jp.camera, eye=jnp.asarray([0.0, 4.0, 3.0]), rotation=jnp.asarray([-25.0, -90.0])))
    js = j_default_settings()
    jc = JRenderConfig(width=W, height=H, shadow_size=256, force_bruteforce=True,
                       hdr_half_round=False)
    jimg, _ = jpipe.render_frame_stats(jb, jp, js, jc)
    tb, tp, ts = convert.scene_buffers(jb), convert.scene_params(jp), convert.settings(js)
    config = convert.render_config(jc)
    assert not config.hdr_half_round
    exact, _ = pipeline.render_frame_stats(tb, tp, ts, config)
    d = np.abs(exact.numpy().astype(np.int32) - np.asarray(jimg).astype(np.int32))
    assert int(d.max()) <= 1 and float((d > 0).mean()) < 0.01, (int(d.max()), float((d > 0).mean()))

    rounded, _ = pipeline.render_frame_stats(
        tb, tp, ts, dataclasses.replace(config, hdr_half_round=True))
    diff = (rounded.int() - exact.int()).abs()
    assert int(diff.max()) == 1  # the round moves some pixels, by one LSB at most
    assert float(rounded.float().std()) > 10
