"""The ray-traced mode of arctic_tpu_torch against the JAX package: the BVH
build, the traversal (K14's plain version), the ray-traced frame and the
CLI's --raytrace.

Tolerances:
- build_bvh's arrays are bit-equal to JAX's (the same numpy median split;
  the port keeps a running leaf offset where JAX sums the leaves so far),
  on Cornell (through build_scene_bvh: the port's triangles come from
  world_corners, JAX's from vertex_world_positions) and on a 20k soup;
- trace_plain finds JAX's triangle for every ray. Its t / u / v are
  bit-equal to a numpy f32 evaluation of Moller-Trumbore that rounds every
  operation, and JAX's are bit-equal to the same evaluation with XLA's
  contraction (each cross product's first product and each dot product's
  last two fused into FMAs): the two differ only by that contraction,
  which an ill-conditioned determinant amplifies past any fixed ulp bound;
- against a numpy brute force over all triangles, tests/test_raytrace.py's
  checks (hit mask equal, t within 1e-4 relative);
- the ray-traced frame (with and without rt_light_shadows, with a
  spotlight, on the merged and the per-slot atlas) is within 1 u8 LSB of
  JAX's render_frame_rt (jitted plain XLA) on < 1% of the values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arctic_tpu.core.config import RenderConfig as JRenderConfig
from arctic_tpu.core.scene import PointLights as JPointLights
from arctic_tpu.core.scene import default_scene_params as j_default_params
from arctic_tpu.core.scene import default_settings as j_default_settings
from arctic_tpu.io import build as jbuild
from arctic_tpu.io.procedural import uv_sphere
from arctic_tpu.models import raytrace as jraytrace
from arctic_tpu.ops import rt as jrt
from arctic_tpu_torch.app.cli import main
from arctic_tpu_torch.core.config import RenderConfig
from arctic_tpu_torch.core.scene import MAX_POINT_LIGHTS
from arctic_tpu_torch.core.scene import PointLights as TPointLights
from arctic_tpu_torch.io import build, images, procedural
from arctic_tpu_torch.models import raytrace
from arctic_tpu_torch.ops import pbr, rt
from arctic_tpu_torch.utils import convert, kernels, synthetic
from arctic_tpu_torch.utils.errors import RenderError

W, H, SHADOW = 96, 64, 96
EYE, ROT = [0.0, 4.0, 3.0], [-25.0, -90.0]
SPOT = ((0.0, 6.0, -5.0), (120.0, 120.0, 120.0), ((0.0, -1.0, 0.0), 20.0, 35.0))
POINT = ((0.0, 1.0, 0.0), (10.0, 0.0, 0.0))
BEHIND_BOX = ((0.0, 0.6, -2.5), (25.0, 25.0, 25.0))  # tests/test_raytrace.py's shadowed light


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several test
    processes at once, and an oversubscribed torch thread pool slows these
    small CPU frames by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bvh_equal(tb, jb):
    for f in rt.BVH.FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)


def test_build_bvh_matches_jax_on_a_soup():
    rng = np.random.default_rng(0)
    centres = rng.uniform(-10, 10, (20000, 1, 3))
    tris = (centres + rng.normal(0, 0.5, (20000, 3, 3))).astype(np.float32)
    tb = rt.build_bvh(tris)
    _bvh_equal(tb, jrt.build_bvh(tris))
    assert tb.num_nodes > 10000
    assert tb.nbytes == tb.num_nodes * rt.NODE_BYTES + 20000 * rt.TRI_BYTES


@pytest.mark.parametrize("scene", ["cornell", "per_slot"])
def test_scene_bvh_matches_jax(scene):
    meshes, objects, materials, env = procedural.cornell_like_scene()
    if scene == "per_slot":
        materials = procedural.per_slot_materials(materials)
    jb = jbuild.build_buffers(meshes, objects, materials, env, tri_bucket=256)
    tb = build.build_buffers(meshes, objects, materials, env, tri_bucket=256, device="cpu")
    _bvh_equal(raytrace.build_scene_bvh(tb), jraytrace.build_scene_bvh(jb))


def test_empty_scene_bvh_matches_jax():
    _bvh_equal(rt.build_bvh(np.zeros((0, 3, 3), np.float32)),
               jrt.build_bvh(np.zeros((0, 3, 3), np.float32)))


def _mt(tris, o, d, fma: bool):
    """t, u, v of the ray (o, d) against each triangle, f32 Moller-Trumbore
    in rt.trace's order, every operation rounded (fma=False) or with XLA's
    contraction of the JAX package's jitted loop (fma=True)."""
    v0 = tris[:, 0]
    e1 = (tris[:, 1] - tris[:, 0]).astype(np.float32)
    e2 = (tris[:, 2] - tris[:, 0]).astype(np.float32)
    f64 = np.float64

    def mul(a, b):
        return (a * b).astype(np.float32)

    def fmadd(a, b, c):  # round(a * b + c) once
        return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(np.float32)

    def cross(a, b):
        def one(i, j):
            if fma:
                return fmadd(a[..., i], b[..., j], -mul(a[..., j], b[..., i]))
            return mul(a[..., i], b[..., j]) - mul(a[..., j], b[..., i])
        return np.stack([one(1, 2), one(2, 0), one(0, 1)], -1)

    def dot(a, b):
        if fma:
            return fmadd(a[..., 2], b[..., 2], fmadd(a[..., 1], b[..., 1], mul(a[..., 0], b[..., 0])))
        return (mul(a[..., 0], b[..., 0]) + mul(a[..., 1], b[..., 1])) + mul(a[..., 2], b[..., 2])

    dd = np.broadcast_to(d, e2.shape)
    p = cross(dd, e2)
    det = dot(e1, p)
    idet = (np.float32(1.0) / np.where(det == 0, np.float32(1.0), det)).astype(np.float32)
    tv = (o - v0).astype(np.float32)
    u = mul(dot(tv, p), idet)
    q = cross(tv, e1)
    v = mul(dot(dd, q), idet)
    t = mul(dot(e2, q), idet)
    return t, u, v


def _sphere_rays(rng):
    m = uv_sphere(1.0, 8, 12)
    tris = m.positions[m.indices].astype(np.float32)
    origins = rng.normal(0, 3, (64, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return tris, origins, dirs


def _disc_rays(rng):
    m = uv_sphere(1.0, 8, 12)
    tris = m.positions[m.indices].astype(np.float32)
    ys = rng.uniform(-2, 2, 32).astype(np.float32)
    origins = np.stack([np.full(32, -5.0), ys, np.zeros(32)], 1).astype(np.float32)
    dirs = np.tile([1.0, 0, 0], (32, 1)).astype(np.float32)
    return tris, origins, dirs


@pytest.mark.parametrize("rays, any_hit", [("sphere", False), ("sphere", True), ("disc", True),
                                           ("disc", False)])
def test_trace_plain_matches_jax(rays, any_hit):
    """tests/test_raytrace.py's rays: the same triangles as JAX's trace,
    t / u / v each JAX's but for XLA's FMA contraction (see the module
    docstring), and the numpy brute force's hits."""
    rng = np.random.default_rng(0)
    tris, o, d = (_sphere_rays if rays == "sphere" else _disc_rays)(rng)
    jh = jrt.trace(jrt.build_bvh(tris), jnp.asarray(o), jnp.asarray(d), any_hit=any_hit)
    th = rt.trace_plain(rt.build_bvh(tris), torch.from_numpy(o), torch.from_numpy(d),
                        any_hit=any_hit)
    np.testing.assert_array_equal(th.tri.numpy(), np.asarray(jh.tri))
    hit = th.tri.numpy() >= 0
    assert hit.any() and (~hit).any()
    for i in np.flatnonzero(hit):
        k = th.tri.numpy()[i]
        got = _mt(tris[k : k + 1], o[i], d[i], fma=False)
        want = _mt(tris[k : k + 1], o[i], d[i], fma=True)
        assert (th.t[i].item(), th.u[i].item(), th.v[i].item()) == tuple(float(x[0]) for x in got)
        assert (float(jh.t[i]), float(jh.u[i]), float(jh.v[i])) == tuple(float(x[0]) for x in want)
    assert (th.t.numpy()[~hit] == np.float32(3.0e38)).all()
    if rays == "disc":  # occluded iff the ray passes the unit disc
        np.testing.assert_array_equal(hit, np.abs(o[:, 1]) < 1.0)
    elif not any_hit:  # tests/test_raytrace.py's brute force
        best_t, best_i = _brute_force(tris, o, d)
        np.testing.assert_array_equal(hit, best_i >= 0)
        np.testing.assert_allclose(th.t.numpy()[hit], best_t[hit], rtol=1e-4)


def _brute_force(tris, origins, dirs):
    """tests/test_raytrace.py's numpy Moller-Trumbore against every triangle."""
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    best_t = np.full(len(origins), np.inf)
    best_i = np.full(len(origins), -1)
    for r in range(len(origins)):
        o, d = origins[r], dirs[r]
        pvec = np.cross(d, e2)
        det = np.einsum("ij,ij->i", e1, pvec)
        ok = np.abs(det) > 1e-12
        idet = np.where(ok, 1.0 / np.where(det == 0, 1, det), 0.0)
        tvec = o - v0
        u = np.einsum("ij,ij->i", tvec, pvec) * idet
        qvec = np.cross(tvec, e1)
        v = np.einsum("j,ij->i", d, qvec) * idet
        t = np.einsum("ij,ij->i", e2, qvec) * idet
        ok &= (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-5)
        if ok.any():
            i = np.where(ok, t, np.inf).argmin()
            best_t[r] = t[i]
            best_i[r] = i
    return best_t, best_i


def _walk(bvh, o, d, t_max, any_hit):
    """One ray's walk of the threaded tree in numpy f32 scalars, every
    operation rounded: K14's design (csrc/bvh_trace.cu), written apart from
    the lockstep plain version. Returns (t, tri, u, v)."""
    f = np.float32
    a = {k: getattr(bvh, k).numpy() for k in rt.BVH.FIELDS}
    inv = [f(1) / (f(1e-20) if abs(x) < f(1e-20) else x) for x in d]
    best_t, best_tri, best_u, best_v = f(t_max), -1, f(0), f(0)
    node = 0
    with np.errstate(all="ignore"):
        while node >= 0:
            t0 = [(a["bb_min"][node, i] - o[i]) * inv[i] for i in range(3)]
            t1 = [(a["bb_max"][node, i] - o[i]) * inv[i] for i in range(3)]
            tn = np.max(np.minimum(t0, t1))
            tf = np.min(np.maximum(t0, t1))
            hit = bool(tf >= np.maximum(tn, f(0))) and bool(tn < best_t)
            cnt = a["count"][node]
            if hit and cnt > 0:
                for k in range(cnt):
                    ti = a["first"][node] + k
                    v0, e1, e2 = a["v0"][ti], a["e1"][ti], a["e2"][ti]
                    p = (d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                         d[0] * e2[1] - d[1] * e2[0])
                    det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
                    idet = f(1) / (f(1) if det == 0 else det)
                    tv = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
                    u = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * idet
                    q = (tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
                         tv[0] * e1[1] - tv[1] * e1[0])
                    v = (d[0] * q[0] + d[1] * q[1] + d[2] * q[2]) * idet
                    th = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * idet
                    if (abs(det) > f(1e-12) and u >= 0 and v >= 0 and u + v <= 1
                            and th > f(1e-5) and th < best_t):
                        best_t, best_tri, best_u, best_v = th, a["tri_id"][ti], u, v
            node = node + 1 if hit and cnt == 0 else a["skip"][node]
            if any_hit and best_tri >= 0:
                node = -1
    return best_t, best_tri, best_u, best_v


@pytest.mark.parametrize("case", synthetic.K14_CASES)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_trace_plain_synthetic(case, any_hit):
    """utils/synthetic.py's K14 rays (axis-parallel and sub-clamp directions,
    grazing edges and faces, origins inside boxes, coplanar duplicates,
    per-ray t_max, the empty scene, a camera's image): the lockstep plain version equals a
    per-ray walk (K14's order) bit for bit on every ray, and finds JAX's
    triangles but on the grazing rays, whose edge and face hits XLA's FMA
    contraction decides the other way on some rays."""
    tris, o, d, t_max = synthetic.k14_rays(case)
    (bvh, to, td, tt, _), kw = synthetic.k14_inputs("cpu", case, any_hit)
    th = rt.trace(bvh, to, td, tt, any_hit, **kw)  # CPU tensors: the plain version, no launch
    tm = np.broadcast_to(np.float32(t_max), (len(o),))
    walk = [_walk(bvh, o[i], d[i], tm[i], any_hit) for i in range(0, len(o), 3)]
    for name, got, want in zip(("t", "tri", "u", "v"), th, zip(*walk)):
        np.testing.assert_array_equal(got.numpy()[::3], np.asarray(want, got.numpy().dtype),
                                      err_msg=name)
    miss = th.tri.numpy() < 0
    if case != "grazing":
        jh = jrt.trace(jrt.build_bvh(tris), jnp.asarray(o), jnp.asarray(d),
                       t_max=t_max if np.isscalar(t_max) else jnp.asarray(t_max), any_hit=any_hit)
        np.testing.assert_array_equal(th.tri.numpy(), np.asarray(jh.tri))
        np.testing.assert_array_equal(th.t.numpy()[miss], np.asarray(jh.t)[miss])
    if case == "empty":
        assert miss.all()
    elif case == "coplanar" and not any_hit:
        front = o[:, 2] < -3.0
        assert set(th.tri.numpy()[front & ~miss]) <= {len(tris) - 2, len(tris) - 1}
    else:
        assert (~miss).any() and miss.any()


def test_trace_on_cpu_tensors_launches_nothing():
    (bvh, o, d, t, any_hit), _ = synthetic.k14_inputs("cpu", "inside", False)
    kernels.reset_launch_counts()
    got = rt.trace(bvh, o, d, t, any_hit)
    assert rt.trace.launches == 0
    assert all(torch.equal(x, y) for x, y in zip(got, rt.trace_plain(bvh, o, d, t, any_hit)))


def test_trace_plain_counts_its_work():
    (bvh, o, d, t, any_hit), _ = synthetic.k14_inputs("cpu", "grazing", False)
    stats = {}
    rt.trace_plain(bvh, o, d, t, any_hit, stats=stats)
    assert stats["node_visits"] >= o.shape[0] and stats["tri_tests"] > 0
    assert 0 < stats["nodes"] <= bvh.num_nodes and 0 < stats["tris"] <= bvh.v0.shape[0]
    visits, tests = stats["visits"], stats["tests"]
    assert visits.shape == tests.shape == (o.shape[0],)
    assert visits.dtype == tests.dtype == torch.int32
    assert int(visits.sum()) == stats["node_visits"] and int(tests.sum()) == stats["tri_tests"]
    assert int(visits.min()) >= 1 and int(visits.max()) <= stats["steps"]
    assert int(tests.max()) <= rt.LEAF_SIZE * int(visits.max())


def _soup(n, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-10, 10, (n, 1, 3))
    return (centres + rng.normal(0, 0.5, (n, 3, 3))).astype(np.float32)


def _short_last_leaf():
    """Nine triangles: leaves of 4, 2 and 3 in preorder, the last short."""
    tris = _soup(9, seed=3)
    count = rt.build_bvh(tris).count.numpy()
    assert 0 < count[count > 0][-1] < rt.LEAF_SIZE
    return tris


def _records_scene(scene):
    """(port BVH, JAX BVH) of one scene for the record tests."""
    if scene in ("cornell", "per_slot"):
        meshes, objects, materials, env = procedural.cornell_like_scene()
        if scene == "per_slot":
            materials = procedural.per_slot_materials(materials)
        jb = jbuild.build_buffers(meshes, objects, materials, env, tri_bucket=256)
        tb = build.build_buffers(meshes, objects, materials, env, tri_bucket=256, device="cpu")
        return raytrace.build_scene_bvh(tb), jraytrace.build_scene_bvh(jb)
    tris = {"soup": lambda: _soup(2000), "empty": lambda: np.zeros((0, 3, 3), np.float32),
            "short_last_leaf": _short_last_leaf,
            "infinite_vertex": lambda: synthetic.k14_rays("nonfinite_scene")[0]}[scene]()
    return rt.build_bvh(tris), jrt.build_bvh(tris)


@pytest.mark.parametrize("scene", ["soup", "cornell", "per_slot", "empty", "short_last_leaf",
                                   "infinite_vertex"])
def test_packed_records_decode_to_the_jax_arrays(scene):
    """K14's records, decoded here with numpy from their words, are the JAX
    package's nine arrays bit for bit; the padding words are 0; packing
    JAX's arrays (utils/convert.bvh) gives the same records; boxes_finite
    says whether every box bound is finite."""
    tb, jb = _records_scene(scene)
    assert tb.boxes_finite == (scene != "infinite_vertex")
    nodes, tris = tb.nodes.numpy(), tb.tris.numpy()
    assert nodes.dtype == tris.dtype == np.int32
    assert nodes.shape == (tb.num_nodes, rt.NODE_BYTES // 4)
    assert tris.shape == (tb.num_tris, rt.TRI_BYTES // 4)
    decoded = {
        "bb_min": nodes[:, 0:3].view(np.float32), "skip": nodes[:, 3],
        "bb_max": nodes[:, 4:7].view(np.float32), "first": nodes[:, 7] >> 3,
        "count": nodes[:, 7] & 7, "v0": tris[:, 0:3].view(np.float32), "tri_id": tris[:, 3],
        "e1": tris[:, 4:7].view(np.float32), "e2": tris[:, 8:11].view(np.float32),
    }
    for f in rt.BVH.FIELDS:
        want = np.asarray(getattr(jb, f))
        assert decoded[f].dtype == want.dtype, f
        np.testing.assert_array_equal(decoded[f].view(np.int32), want.view(np.int32), err_msg=f)
    assert (tris[:, 7] == 0).all() and (tris[:, 11] == 0).all()
    packed = convert.bvh(jb)
    assert torch.equal(packed.nodes, tb.nodes) and torch.equal(packed.tris, tb.tris)
    assert packed.boxes_finite == tb.boxes_finite
    assert tb.nbytes == tb.num_nodes * rt.NODE_BYTES + tb.num_tris * rt.TRI_BYTES


def test_pack_refuses_the_first_limit():
    """first << 3 | count is one int32: 2**28 triangles raise RenderError
    (stride-0 inputs: nothing of that size is allocated)."""
    tri = torch.zeros(1, 3).expand(rt.TRI_LIMIT, 3)
    node = torch.zeros(1, 3).expand(1, 3)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RenderError, match=r"2\*\*28"):
        rt.BVH.pack(node, node, one, one + 1, one - 1, tri, tri, tri,
                    torch.zeros(1, dtype=torch.int32).expand(rt.TRI_LIMIT))


def test_warp_rays_cover_every_ray_once():
    """K14's lane mappings: each ray of a 37 x 23 image once, idle lanes
    -1; an 8 x 4 tile's lanes row-major in the tile."""
    for width in (0, 37):
        lanes = rt.warp_rays(37 * 23, width)
        assert lanes.shape[1] == rt.WARP
        live = lanes[lanes >= 0]
        assert torch.equal(live.sort().values, torch.arange(37 * 23))
    lanes = rt.warp_rays(37 * 23, 37)
    assert lanes.shape[0] == 5 * 6  # ceil(37 / 8) x ceil(23 / 4) tiles
    assert lanes[0].tolist() == [y * 37 + x for y in range(4) for x in range(8)]
    assert (lanes[4] >= 0).sum() == 5 * 4  # the last tile of a row: 5 columns
    with pytest.raises(ValueError, match="image"):
        rt.warp_rays(100, 37)


def test_lockstep_efficiency_by_hand():
    """Equal visits give 1.0 under both mappings; one long lane in a warp
    gives (its visits + the rest) / 32 x (its visits + the other warp's)."""
    visits = torch.full((64,), 7, dtype=torch.int32)
    assert rt.lockstep_efficiency(visits) == 1.0
    assert rt.lockstep_efficiency(visits, 8) == 1.0
    visits[5] = 39
    assert rt.lockstep_efficiency(visits) == (63 * 7 + 39) / (32 * (39 + 7))
    # The image 16 wide: ray 5 (x = 5, y = 0) is in the first 8 x 4 tile.
    assert rt.lockstep_efficiency(visits, 16) == (63 * 7 + 39) / (32 * (39 + 7))
    # Idle lanes count as no visits: 40 rays, one warp full and one of 8.
    assert rt.lockstep_efficiency(torch.ones(40, dtype=torch.int32)) == 40 / 64


def _params(lights):
    p = j_default_params(aspect=W / H)
    return dataclasses.replace(
        p, camera=dataclasses.replace(p.camera, eye=jnp.asarray(EYE), rotation=jnp.asarray(ROT)),
        point_lights=JPointLights.from_list(list(lights), spots=True),
    )


FRAMES = {
    "point": (dict(), [POINT]),
    "light_shadows": (dict(rt_light_shadows=True), [POINT, BEHIND_BOX]),
    "spot": (dict(spotlights=True, rt_light_shadows=True), [POINT, SPOT]),
    "spot_no_light_shadows": (dict(spotlights=True), [POINT, SPOT]),
    "per_slot": (dict(rt_light_shadows=True), [POINT, BEHIND_BOX]),
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_rt_frame_within_one_lsb_of_jax(frame):
    fields, lights = FRAMES[frame]
    meshes, objects, materials, env = procedural.cornell_like_scene()
    if frame == "per_slot":
        materials = procedural.per_slot_materials(materials)
    jb = jbuild.build_buffers(meshes, objects, materials, env, tri_bucket=256)
    tb = build.build_buffers(meshes, objects, materials, env, tri_bucket=256, device="cpu")
    jp, js = _params(lights), j_default_settings()
    jconfig = JRenderConfig(width=W, height=H, shadow_size=SHADOW, **fields)
    want = np.asarray(jraytrace.make_rt_renderer(jconfig, jraytrace.build_scene_bvh(jb))(jb, jp, js))
    render = raytrace.make_rt_renderer(convert.render_config(jconfig),
                                       raytrace.build_scene_bvh(tb), "cpu")
    with kernels.record_calls() as calls:
        got = render(tb, convert.scene_params(jp), convert.settings(js)).numpy()
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    n_shadow = len(lights) if fields.get("rt_light_shadows") else 0
    assert set(calls) == {"bvh_trace", "shade_lights"}
    assert len(calls["bvh_trace"]) == 2 + n_shadow and len(calls["shade_lights"]) == 1
    (_, _, _, _, _, _, _, spotlights, visibility), _ = calls["shade_lights"][0]
    assert spotlights == bool(fields.get("spotlights"))
    assert (visibility is None) == (not n_shadow)


RT_SPANS = ["rt_primary", "rt_surface", "rt_sun_shadow", "pbr_lights", "rt_sky", "post_process"]


def test_rt_frame_spans_cover_its_work(monkeypatch):
    """Under torch.profiler, the ray-traced frame's top-level ranges are its
    six passes in order, and every aten op of the frame call runs inside
    exactly one of them (the innermost range above it is one of the six).
    The profiled frame replays the unprofiled frame's traversals (a clone
    each, in place of K14's one launch): the lockstep walk of the CPU would
    bury the trace under ~10^5 ops."""
    tb = build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device="cpu")
    bvh = raytrace.build_scene_bvh(tb)
    params = convert.scene_params(_params([POINT, SPOT]))
    settings = convert.settings(j_default_settings())
    config = RenderConfig(width=W, height=H, shadow_size=SHADOW, spotlights=True,
                          rt_light_shadows=True)
    walks, trace = [], rt.trace
    monkeypatch.setattr(rt, "trace", lambda *a, **k: walks.append(trace(*a, **k)) or walks[-1])
    want = raytrace.render_frame_rt(tb, bvh, params, settings, config)
    replay = iter(walks)
    monkeypatch.setattr(rt, "trace", lambda *a, **k: rt.Hits(*(x.clone() for x in next(replay))))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("frame"):
            got = raytrace.render_frame_rt(tb, bvh, params, settings, config)
    assert torch.equal(got, want) and len(walks) == 4
    events = prof.events()
    [frame] = [e for e in events if e.name == "frame"]
    ranges = [e for e in events if e.is_user_annotation]

    def scope(e):
        """The innermost user range above e."""
        e = e.cpu_parent
        while e is not None and e not in ranges:
            e = e.cpu_parent
        return e

    top = sorted((e for e in ranges if scope(e) is frame), key=lambda e: e.time_range.start)
    assert [e.name for e in top] == RT_SPANS
    ops = [e for e in events if e.name.startswith("aten::")
           and frame.time_range.start <= e.time_range.start <= frame.time_range.end]
    assert len(ops) > 100
    assert all(any(scope(e) is t for t in top) for e in ops)


def test_rt_light_shadows_darken():
    """tests/test_raytrace.py's check on the port: the light behind the tall
    box only darkens, and does somewhere."""
    meshes, objects, materials, env = procedural.cornell_like_scene()
    tb = build.build_buffers(meshes, objects, materials, env, tri_bucket=256, device="cpu")
    params = convert.scene_params(_params([BEHIND_BOX]))
    params.sun.color = torch.zeros(3)
    params.ambient = torch.tensor(0.05)
    settings = convert.settings(j_default_settings())
    bvh = raytrace.build_scene_bvh(tb)
    base = RenderConfig(width=W, height=H, shadow_size=SHADOW)
    off = raytrace.render_frame_rt(tb, bvh, params, settings, base).numpy().astype(int)
    on = raytrace.render_frame_rt(tb, bvh, params, settings,
                                  dataclasses.replace(base, rt_light_shadows=True)).numpy().astype(int)
    assert (on <= off + 1).all()
    assert ((off - on).max(-1) > 8).mean() > 0.005


def test_rt_refuses_the_tile_atlas():
    tb = build.build_buffers(*procedural.cornell_like_scene(), tri_bucket=256, device="cpu",
                             tile_threshold_texels=0)
    params = convert.scene_params(_params([POINT]))
    with pytest.raises(RenderError, match="tile-atlas"):
        raytrace.render_frame_rt(tb, raytrace.build_scene_bvh(tb), params,
                                 convert.settings(j_default_settings()),
                                 RenderConfig(width=W, height=H, shadow_size=SHADOW))


def test_cli_raytrace_equals_in_process(tmp_path):
    """``cli render --raytrace --device cpu``: the PNG equals the in-process
    ray-traced frame (no pair-cap tuning, the default light)."""
    out = tmp_path / "rt.png"
    argv = ["render", "--procedural", "cornell", "--width", str(W), "--height", str(H),
            "--shadow-size", str(SHADOW), "--camera=0,4,3,-25,-90", "--device", "cpu",
            "--raytrace", "--out", str(out)]
    with kernels.record_calls() as calls:
        assert main(argv) == 0
    assert set(calls) == {"bvh_trace", "shade_lights"}
    png = images.load_ldr(str(out))[..., :3]
    from arctic_tpu_torch.core.scene import default_scene_params, default_settings, make_camera

    bufs = build.build_buffers(*procedural.cornell_like_scene(), device="cpu")
    params = default_scene_params(aspect=W / H)
    params.camera = make_camera(EYE, ROT, W / H)
    want = raytrace.make_rt_renderer(RenderConfig(width=W, height=H, shadow_size=SHADOW),
                                     raytrace.build_scene_bvh(bufs), "cpu")(
        bufs, params, default_settings())
    np.testing.assert_array_equal(png, want.numpy())


@pytest.mark.parametrize("case", ["spot", "visibility"])
def test_shade_lights_on_cpu_tensors_launches_nothing(case):
    """On CPU planes the K15 wrapper is its plain version (bit for bit, NaN
    at the eye's own pixel included) and launches nothing."""
    args, kw = synthetic.k15_inputs("cpu", case)
    kernels.reset_launch_counts()
    got = pbr.shade_lights(*args, **kw)
    assert pbr.shade_lights.launches == 0
    torch.testing.assert_close(got, pbr.shade_lights_plain(*args, **kw), rtol=0, atol=0,
                               equal_nan=True)
    assert got.shape == (3, synthetic.K15_H, synthetic.K15_W)


def _bank(n, spots):
    rng = np.random.default_rng(n)
    rows = [(tuple(rng.uniform(-5, 5, 3)), tuple(rng.uniform(0, 50, 3)),
             (tuple(rng.uniform(-1, 1, 3)), 15.0, 30.0) if spots and i % 2 else None)
            for i in range(n)]
    return TPointLights.from_list(rows, spots=spots)


@pytest.mark.parametrize("case", ["0", "1", "4", "16", "count_over_16", "4_spots",
                                  "4_spots_off", "4_no_cone_fields"])
def test_pack_lights(case):
    """K15's frame parameters from the host SceneParams: the eye, the sun's
    incoming direction (minus its direction), its colour, ambient, the light
    count capped at 16, and each light's rows; cone fields only under
    ``spotlights`` with a bank that has them, zero elsewhere."""
    params = convert.scene_params(_params([POINT]))
    n = 20 if case == "count_over_16" else int(case.split("_")[0])
    lights = _bank(min(n, MAX_POINT_LIGHTS), spots=case in ("4_spots", "4_spots_off"))
    lights.count = n
    params.point_lights = lights
    spotlights = case in ("4_spots", "4_no_cone_fields")
    got = pbr.pack_lights(params, spotlights)
    assert len(got) == pbr.LIGHT_FLOATS == 188 and all(isinstance(x, float) for x in got)
    assert got[pbr.LIGHT_EYE : pbr.LIGHT_EYE + 3] == EYE
    sun_wi = got[pbr.LIGHT_SUN_WI : pbr.LIGHT_SUN_WI + 3]
    assert sun_wi == (-params.sun.direction()).tolist()
    assert sun_wi[1] > 0  # toward the sun, which shines down
    assert got[pbr.LIGHT_SUN_COLOR : pbr.LIGHT_SUN_COLOR + 3] == params.sun.color.tolist()
    assert got[pbr.LIGHT_AMBIENT] == float(params.ambient)
    count = min(n, MAX_POINT_LIGHTS)
    assert got[pbr.LIGHT_COUNT] == count
    spot = case == "4_spots"
    assert got[pbr.LIGHT_SPOT] == float(spot)
    want = {pbr.LIGHT_POS: lights.position, pbr.LIGHT_COLOR: lights.color,
            pbr.LIGHT_AXIS: lights.spot_dir if spot else torch.zeros(16, 3),
            pbr.LIGHT_CONE: lights.spot_cos if spot else torch.zeros(16, 2)}
    for off, rows in want.items():
        width = rows.shape[1]
        block = torch.tensor(got[off : off + width * MAX_POINT_LIGHTS]).view(-1, width)
        assert torch.equal(block[:count], rows[:count].float()), off
        assert not block[count:].any(), off
