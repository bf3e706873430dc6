"""The default fused frame through arctic_tpu_torch against the JAX package.

The entry frame of __graft_entry__ (Cornell, 256x192, 256^2 shadow map,
eye (0, 4, 3), rotation (-25, -90), tri_bucket 256): the JAX
render_frame_stats runs eagerly with its Pallas kernels in interpret mode,
the port on the CPU through its kernels' plain versions. Both get the same
scene (the parameter bridge carries the JAX buffers and params over).

Tolerances: the frames differ by at most 1 u8 LSB on < 1% of the pixels
(the JAX kernels contract FMAs in interpret mode and jnp reductions run
compiled; through the f16 HDR round an ulp can move a u8 by one — the
reference's own sharded-vs-single gate, test_sharding); the stats are equal;
both frames are >= 40 dB against the f64 golden oracle (test_golden_psnr).

The same frame on the card is tests/test_torch_cuda.py (no JAX there).
"""

import numpy as np
import pytest

import __graft_entry__ as graft
from arctic_tpu.io.procedural import cornell_like_scene
from arctic_tpu.models import golden as jgolden
from arctic_tpu.models import pipeline as jpipe
from arctic_tpu_torch.models import golden, pipeline
from arctic_tpu_torch.utils import convert

W, H, SHADOW = 256, 192, 256


def _lsb_gate(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


@pytest.fixture(scope="module")
def frames():
    config, jb, jp, js = graft._small_scene(W, H, SHADOW)
    jimg, jstats = jpipe.render_frame_stats(jb, jp, js, config)
    tb, tp, ts = convert.scene_buffers(jb), convert.scene_params(jp), convert.settings(js)
    timg, tstats = pipeline.render_frame_stats(tb, tp, ts, convert.render_config(config))
    return dict(
        jax=(np.asarray(jimg), {k: int(v) for k, v in jstats.items()}),
        port=(timg.numpy(), {k: int(v) for k, v in tstats.items()}),
    )


def test_entry_frame_within_one_lsb_of_jax(frames):
    jimg, timg = frames["jax"][0], frames["port"][0]
    assert timg.shape == jimg.shape == (H, W, 3) and timg.dtype == np.uint8
    max_lsb, frac = _lsb_gate(timg, jimg)
    assert max_lsb <= 1 and frac < 0.01, (max_lsb, frac)
    assert timg.mean() > 20  # a lit scene, not a black or sky-only frame


def test_entry_stats_equal_jax(frames):
    assert frames["port"][1] == frames["jax"][1]
    pipeline.check_stats(frames["port"][1])
    assert 0 < frames["port"][1]["cam_pairs"] <= frames["port"][1]["cam_pair_cap"]


def test_entry_frame_vs_golden_oracle(frames):
    meshes, objects, materials, env = cornell_like_scene()
    tris, mats = golden.golden_scene(meshes, objects, materials)
    gold = golden.render(
        tris, mats, env.astype(np.float64),
        dict(eye=[0.0, 4.0, 3.0], rotation=[-25.0, -90.0], aspect=W / H, fov_y=45.0,
             z_near=0.1, z_far=1000.0),
        dict(position=[-10.0, 32.0, -2.48], rotation=[-70.0, 12.0], color=[8.0, 8.0, 8.0]),
        [((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))], ambient=0.1,
        settings=dict(tm_method=0, gamma=2.2, exposure=1.0),
        width=W, height=H, shadow_size=SHADOW,
    )
    for name in ("port", "jax"):
        db = golden.psnr(frames[name][0], gold)
        assert db >= 40.0, f"{name} entry frame PSNR {db:.2f} dB < 40 dB"


@pytest.mark.parametrize("tm_method", [0, 1, 2])
def test_golden_oracle_matches_jax_package(tm_method):
    """The port's copy of the f64 oracle gives the JAX package's scene
    expansion and frame exactly (both are the same numpy code)."""
    meshes, objects, materials, env = cornell_like_scene()
    jtris, jmats = jgolden.golden_scene(meshes, objects, materials)
    tris, mats = golden.golden_scene(meshes, objects, materials)
    for k in jtris:
        np.testing.assert_array_equal(tris[k], jtris[k])
    for jm, m in zip(jmats, mats):
        for k in jm:
            np.testing.assert_array_equal(m[k], jm[k])
    args = (
        env.astype(np.float64),
        dict(eye=[0.0, 4.0, 3.0], rotation=[-25.0, -90.0], aspect=1.5, fov_y=45.0,
             z_near=0.1, z_far=1000.0),
        dict(position=[-10.0, 32.0, -2.48], rotation=[-70.0, 12.0], color=[8.0, 8.0, 8.0]),
        [((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))],
    )
    kw = dict(ambient=0.1, settings=dict(tm_method=tm_method, gamma=2.2, exposure=1.0),
              width=48, height=32, shadow_size=64)
    want = jgolden.render(jtris, jmats, *args, **kw)
    np.testing.assert_array_equal(golden.render(tris, mats, *args, **kw), want)
    assert want.mean() > 20


def test_overflow_is_loud(frames):
    stats = dict(frames["port"][1], cam_pairs=frames["port"][1]["cam_pair_cap"] + 1)
    with pytest.raises(pipeline.RenderError, match="overflowed"):
        pipeline.check_stats(stats)
