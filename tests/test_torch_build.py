"""arctic_tpu_torch scene build vs the JAX package's build_buffers.

Both builds run the same numpy body, so every leaf the port keeps must be
equal bit for bit, bf16 tables included (both round f32 -> bf16 to nearest
even). The parameter bridge (utils/convert.py) must carry the JAX buffers
into the same tensors, and the port's procedural scenes must equal the JAX
package's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.scene import PointLights as JPointLights
from arctic_tpu.core.scene import default_scene_params as j_default_params
from arctic_tpu.core.scene import default_settings as j_default_settings
from arctic_tpu.io import build as jbuild
from arctic_tpu.io import procedural as jproc
from arctic_tpu_torch.io import build, procedural
from arctic_tpu_torch.utils import convert

SCENES = {"cornell": 256, "helmet": 1024}


def _jax_leaves(jb):
    g, a, e = jb.geometry, jb.atlas, jb.environment
    return {
        "num_tris": int(g.num_tris),
        "tri_corner_pos": np.asarray(g.tri_corner_pos),
        "tri_trs": np.asarray(g.tri_trs),
        "slot_static_rows": np.asarray(g.slot_static_rows),
        "combined_slots": tuple(a.combined_slots),
        "combined_shape": tuple(a.combined_shape),
        "quad_width": int(a.combined_quads.shape[-1]),
        "combined_env_rows": np.asarray(a.combined_env_rows).view(np.uint16),
        "env_region": tuple(int(v) for v in np.asarray(e.atlas.regions)[0, 0]),
        "env_data_shape": tuple(e.atlas.data.shape[:2]),
        "env_num_rows": int(e.atlas.quads_packed.shape[0]),
    }


@pytest.fixture(scope="module", params=sorted(SCENES))
def built(request):
    name = request.param
    scene = getattr(jproc, f"{name}_like_scene")()
    jb = jbuild.build_buffers(*scene, tri_bucket=SCENES[name])
    tb = build.build_buffers(*scene, tri_bucket=SCENES[name])
    return jb, tb


def _assert_leaves_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_build_matches_jax_leaf_by_leaf(built):
    jb, tb = built
    assert tb.atlas.combined_env_rows.dtype == torch.bfloat16
    _assert_leaves_equal(convert.scene_leaves(tb), _jax_leaves(jb))


def test_convert_carries_jax_buffers_bit_for_bit(built):
    jb, tb = built
    _assert_leaves_equal(convert.scene_leaves(convert.scene_buffers(jb)), convert.scene_leaves(tb))


def test_convert_params_and_settings():
    p = j_default_params(aspect=4 / 3)
    p = dataclasses.replace(
        p, point_lights=JPointLights.from_list([((1.0, 2.0, 3.0), (4.0, 5.0, 6.0))] * 3)
    )
    s = dataclasses.replace(j_default_settings(), tm_method=jnp.int32(2))
    tp, ts = convert.scene_params(p), convert.settings(s)
    for f in ("eye", "rotation", "aspect", "fov_y", "z_near", "z_far"):
        np.testing.assert_array_equal(getattr(tp.camera, f).numpy(), np.asarray(getattr(p.camera, f)))
    np.testing.assert_array_equal(tp.point_lights.position.numpy(), np.asarray(p.point_lights.position))
    assert tp.point_lights.count == 3 and ts.tm_method == 2
    assert float(ts.gamma) == float(s.gamma) and float(tp.ambient) == float(p.ambient)


def test_bf16_bridge_round_trips():
    import ml_dtypes

    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 128)).astype(np.float32).astype(ml_dtypes.bfloat16)
    t = convert.tensor(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.to_numpy(t), x.view(np.uint16))
    # and torch's own f32 -> bf16 rounding equals ml_dtypes' (nearest even)
    f = rng.standard_normal(4096).astype(np.float32)
    np.testing.assert_array_equal(
        convert.to_numpy(torch.from_numpy(f).to(torch.bfloat16)),
        f.astype(ml_dtypes.bfloat16).view(np.uint16),
    )


@pytest.mark.parametrize("name", ["cornell", "helmet", "sponza"])
def test_procedural_scenes_match_jax(name):
    got = getattr(procedural, f"{name}_like_scene")()
    want = getattr(jproc, f"{name}_like_scene")()
    (gm, go, gmat, genv), (wm, wo, wmat, wenv) = got, want
    assert len(gm) == len(wm) and len(go) == len(wo) and len(gmat) == len(wmat)
    for a, b in zip(gm, wm):
        for f in ("positions", "normals", "uvs", "indices", "material"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for (ta, ma), (tb_, mb) in zip(go, wo):
        np.testing.assert_array_equal(ta, tb_)
        assert ma == mb
    for a, b in zip(gmat, wmat):
        for f in ("diffuse", "normal", "metal_roughness"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(genv, wenv)


def test_convert_render_config():
    """The JAX RenderConfig carries over field by field; an option whose
    path the port does not have raises instead of being dropped."""
    from arctic_tpu.core.config import RenderConfig as JRenderConfig

    jc = JRenderConfig(width=320, height=200, shadow_size=512, static_point_lights=4, pairs_per_tri=3)
    tc = convert.render_config(jc)
    for name in ("width", "height", "shadow_size", "tile_h", "tile_w", "static_point_lights"):
        assert getattr(tc, name) == getattr(jc, name)
    assert tc.pair_capacity(1000) == jc.pair_capacity(1000) == jc.pair_capacity(1000, "shadow")
    assert (tc.tiles_x, tc.tiles_y) == (jc.tiles_x, jc.tiles_y)
    for off in (dict(pcf_row_cap=4096), dict(fused_shade=False), dict(sun_frustum_cull=False)):
        with pytest.raises(ValueError, match=next(iter(off))):
            convert.render_config(JRenderConfig(**off))
