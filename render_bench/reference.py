"""Plain PyTorch reference of the frames the benchmark checks.

It renders chosen pixels of a frame from the scene and the viewpoint alone:
no shadow map, pair list, cap, sun cache or BVH of the program, and no
import of it. The math is a frozen copy of the port's f64 oracle
(arctic_tpu_torch/models/golden.py at commit b3e24800, itself written from
the D3D12/HLSL semantics) and of the ray-traced mode's rules
(arctic_tpu_torch/models/raytrace.py at the same commit), made to run over
251,500 triangles at full frame size: instead of a Python loop over
triangles, each queried pixel, shadow-map texel or ray is tested against
the triangles of the clusters (64 triangles in Morton order) whose bounds
it meets.

The raster frame: near clip (Sutherland-Hodgman), D3D viewport with
vertices snapped to 1/16 pixel, back faces culled in the camera pass and
front faces in the 4000^2 shadow pass, top-left fill, LESS depth, the
perspective-correct barycentrics, 25-tap PCF of bilinear depths. The
ray-traced frame: Moller-Trumbore closest hit for the primary ray, an
any-hit ray toward the sun from ``p + 1e-3 n``, and with light shadows one
toward each point light bounded at its distance less 2e-3. Both: the
forward.hlsl shading, the skybox, the f16 HDR store, the tonemap, gamma and
the u8 store.

Ties. The program computes in float32 and this reference in float64, so
where the answer hangs on a near tie each side may take either branch. The
reference keeps every branch that a float32 rounding can take and the
comparison accepts a pixel that matches any of them: a pixel centre within
EDGE_PX of a triangle edge is covered or not; a surface whose depth lies
within the float32 reach of the nearest certain one's may be the one seen
(the program's raster evaluates depth and barycentric planes anchored at
the viewport's origin, whose error grows with the magnitudes of their
terms: F32_REACH times those, per pixel and triangle); a PCF tap whose
depths differ by less than their reach and SHADOW_TIE compares either way,
and so does a shadow ray that passes within float32 reach (RAY_TIE) of an
edge. Everything else has one answer.

``exact=False`` drops the ties (one nearest surface, every test as
computed): with ``dtype=torch.bfloat16`` that is the control of the check,
the reference in the precision below the program's float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = 3.14159265
# A pixel centre nearer than this to an edge (in pixels) may fall on either
# side: float32 snapping moves a vertex by 1/16 pixel where its exact
# coordinate lies within rounding of a half step.
EDGE_PX = 1.0 / 16.0 + 1.0 / 256.0
# NDC depths within this of the nearest surface's may win the LESS test.
DEPTH_TIE = 2e-6
# A PCF tap whose light-space depth lies within this (beyond the reach of
# the depths it compares) of the bilinear map depth may compare either way.
SHADOW_TIE = 2e-6
# The program's raster evaluates plane equations anchored at the viewport's
# origin in float32: a value built from terms whose magnitudes sum to M
# carries an error of about M * 2^-24 (half a unit in the last place of
# each term). Calibrated on the card on raster frames at 3840 x 2160: half
# of this keeps the far pixels as few, a quarter multiplies them by 3 to 8.
F32_REACH = 2.0 ** -24
# Relative reach of float32 rounding in a ray-triangle test's barycentrics
# and distance (about 16 units in the last place).
RAY_TIE = 2e-6
# Triangles per cluster of the candidate search.
GROUP = 64
# Surfaces kept a pixel, those that surely cover it first (ties beyond this
# are slivers of the same surfaces).
MAX_SURFACES = 16


# --------------------------- scene ------------------------------------------


def _srgb(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def tangents_np(positions, normals, uvs, indices):
    """Per-vertex tangent frame from UV derivatives (a copy of the port's
    io/build.compute_tangents_np at commit b3e24800)."""
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    e1 = positions[i1] - positions[i0]
    e2 = positions[i2] - positions[i0]
    d1 = uvs[i1] - uvs[i0]
    d2 = uvs[i2] - uvs[i0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1.0, det))
    t_face = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    b_face = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r[:, None]
    tan = np.zeros_like(positions)
    btn = np.zeros_like(positions)
    for tri_idx in (i0, i1, i2):
        np.add.at(tan, tri_idx, t_face)
        np.add.at(btn, tri_idx, b_face)
    n = normals
    tan = tan - n * np.sum(n * tan, axis=1, keepdims=True)
    ln = np.linalg.norm(tan, axis=1, keepdims=True)
    alt = np.cross(n, np.where(np.abs(n[:, 0:1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]]))
    tan = np.where(ln > 1e-8, tan / np.maximum(ln, 1e-20),
                   alt / np.linalg.norm(alt, axis=1, keepdims=True))
    handed = np.where(np.sum(np.cross(n, tan) * btn, axis=1, keepdims=True) < 0, -1.0, 1.0)
    btn = np.cross(n, tan) * handed
    return tan.astype(np.float32), btn.astype(np.float32)


def read_hdr(path) -> np.ndarray:
    """A flat (not run-length encoded) Radiance .hdr file as (H, W, 3)
    float64 linear RGB: mantissa times 2^(e - 136), nothing where e = 0."""
    with open(path, "rb") as f:
        data = f.read()
    head, sep, rest = data.partition(b"\n\n")
    if not head.startswith((b"#?RADIANCE", b"#?RGBE")) or not sep:
        raise ValueError(f"{path}: not a Radiance file")
    res, _, pixels = rest.partition(b"\n")
    ny, h, nx, w = res.split()
    h, w = int(h), int(w)
    if (ny, nx) != (b"-Y", b"+X") or len(pixels) != h * w * 4:
        raise ValueError(f"{path}: not a flat -Y {h} +X {w} image")
    rgbe = np.frombuffer(pixels, np.uint8).reshape(h, w, 4).astype(np.float64)
    e = rgbe[..., 3:]
    return rgbe[..., :3] * np.where(e > 0, np.exp2(e - 136.0), 0.0)


class Scene:
    """The scene's triangles as per-corner float64 arrays on ``device``
    (golden.golden_scene: normals, tangents and bitangents normalised per
    vertex and not transformed, as the reference renderer does; tangents
    always from tangents_np), the materials' images in linear float64, the
    environment, and the clusters of the candidate search."""

    def __init__(self, meshes, objects, materials, env, device):
        world, nrm, tan, btn, uv, mat = [], [], [], [], [], []

        def unit(a):
            a = a.astype(np.float64)
            return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)

        for trs, mesh_idx in objects:
            m = meshes[mesh_idx]
            t, b = tangents_np(m.positions, m.normals, m.uvs, m.indices)
            ph = np.concatenate([m.positions, np.ones((len(m.positions), 1))], 1)
            wp = (np.asarray(trs, np.float64) @ ph.T).T[:, :3]
            idx = m.indices
            world.append(wp[idx])
            nrm.append(unit(m.normals)[idx])
            tan.append(unit(t)[idx])
            btn.append(unit(b)[idx])
            uv.append(m.uvs.astype(np.float64)[idx])
            mat.append(np.full(len(idx), m.material, np.int64))

        def dev(a):
            return torch.as_tensor(np.concatenate(a), device=device)

        self.device = torch.device(device)
        self.world = dev(world)  # (T, 3, 3)
        self.attrs = torch.cat([dev(nrm), dev(tan), dev(btn), dev(uv)], dim=2)  # (T, 3, 11)
        self.material = dev(mat)
        self.materials = []
        for mi in materials:
            d = mi.diffuse.astype(np.float64) / 255.0
            d[..., :3] = _srgb(d[..., :3])
            self.materials.append([torch.as_tensor(a, device=device) for a in (
                d, mi.normal.astype(np.float64) / 255.0,
                mi.metal_roughness.astype(np.float64) / 255.0)])
        self.env = torch.as_tensor(np.asarray(env, np.float64), device=device)
        # Morton order of the centroids: each cluster is compact in space.
        cen = self.world.mean(dim=1)
        lo, hi = cen.min(0).values, cen.max(0).values
        q = ((cen - lo) / torch.clamp(hi - lo, min=1e-9) * 1023).long().clamp(0, 1023)
        code = torch.zeros_like(q[:, 0])
        for bit in range(10):
            for axis in range(3):
                code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
        self.rank = torch.empty_like(code)
        order = torch.argsort(code)
        self.rank[order] = torch.arange(len(order), device=device)
        box_lo, box_hi = self.world.min(dim=1).values, self.world.max(dim=1).values
        self.ray_groups = Groups(box_lo[order], box_hi[order], order)
        # The shadow pass of the last sun, shared by the frames of a still sun.
        self.shadow_pass: dict = {}


# --------------------------- candidate search -------------------------------


class Groups:
    """Bounds of GROUP consecutive items (lo, hi: (M, D), in the order
    ``order`` gives them), and the candidate pairs of queries against
    them."""

    def __init__(self, lo, hi, order):
        m, d = lo.shape
        pad = -m % GROUP
        if pad:
            lo = torch.cat([lo, lo[-1:].expand(pad, d)])
            hi = torch.cat([hi, hi[-1:].expand(pad, d)])
        self.lo = lo.view(-1, GROUP, d).min(dim=1).values
        self.hi = hi.view(-1, GROUP, d).max(dim=1).values
        self.order = order
        self.m = m

    def expand(self, q, g):
        """(query, group) pairs -> (query, item) pairs."""
        item = g[:, None] * GROUP + torch.arange(GROUP, device=g.device)
        keep = item < self.m
        q = q[:, None].expand(-1, GROUP)[keep]
        return q, self.order[item[keep]]

    def points(self, pts, margin):
        """(query, item) pairs whose group bounds, widened by ``margin``,
        hold the point."""
        inside = ((pts[:, None, :] >= self.lo[None] - margin)
                  & (pts[:, None, :] <= self.hi[None] + margin)).all(dim=2)
        return self.expand(*inside.nonzero(as_tuple=True))

    def rays(self, org, inv_dir, t_max):
        """(ray, item) pairs whose group box (widened by a relative
        1e-6) the segment [0, t_max] meets."""
        pad = 1e-6 * (1.0 + self.hi.abs().amax(dim=1, keepdim=True))
        lo, hi = self.lo - pad, self.hi + pad
        t0 = (lo[None] - org[:, None]) * inv_dir[:, None]
        t1 = (hi[None] - org[:, None]) * inv_dir[:, None]
        near = torch.minimum(t0, t1).amax(dim=2)
        far = torch.maximum(t0, t1).amin(dim=2)
        hit = (far >= torch.clamp(near, min=0.0)) & (near <= t_max[:, None])
        return self.expand(*hit.nonzero(as_tuple=True))


def _chunks(n, size):
    for start in range(0, n, size):
        yield start, min(n, start + size)


# --------------------------- matrices ----------------------------------------


def _look_at(eye, center, up):
    eye = np.asarray(eye, np.float64)
    f = np.asarray(center, np.float64) - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def dir_from_rot(rot):
    x, y = np.radians(rot[0]), np.radians(rot[1])
    return np.array([np.cos(x) * np.cos(y), np.sin(x), np.cos(x) * np.sin(y)])


def camera_view(cam):
    eye = np.asarray(cam["eye"], np.float64)
    return _look_at(eye, eye + dir_from_rot(cam["rotation"]), [0, 1, 0])


def camera_proj_view(cam):
    t = np.tan(np.radians(cam["fov_y"]) / 2)
    n, f = cam["z_near"], cam["z_far"]
    p = np.zeros((4, 4))
    p[0, 0] = 1 / (cam["aspect"] * t)
    p[1, 1] = 1 / t
    p[2, 2] = f / (n - f)
    p[2, 3] = -f * n / (f - n)
    p[3, 2] = -1
    return p @ camera_view(cam)


def sun_proj_view(sun):
    l, r, b, t, n, f = -16.0, 16.0, -16.0, 16.0, 0.1, 50.0
    p = np.eye(4)
    p[0, 0] = 2 / (r - l)
    p[1, 1] = 2 / (t - b)
    p[2, 2] = -1 / (f - n)
    p[2, 3] = -n / (f - n)
    pos = np.asarray(sun["position"], np.float64)
    return p @ _look_at(pos, pos + dir_from_rot(sun["rotation"]), [0, 1, 0])


# --------------------------- raster ------------------------------------------


class Raster:
    """One pass's screen triangles: near-clipped, snapped, culled, with
    their source triangle and the corner weights of the clip."""

    def __init__(self, scene: Scene, pv: np.ndarray, width: int, height: int, cull: str):
        dev = scene.device
        pvt = torch.as_tensor(pv, device=dev)
        ph = torch.cat([scene.world, torch.ones_like(scene.world[..., :1])], dim=2)
        clip = ph @ pvt.T  # (T, 3, 4)
        clip, bary, src = _near_clip(clip)
        w = clip[..., 3]
        sx = torch.round((clip[..., 0] / w + 1) * width / 2 * 16) / 16
        sy = torch.round((1 - clip[..., 1] / w) * height / 2 * 16) / 16
        sz = clip[..., 2] / w
        area2 = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
                 - (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0]))
        keep = area2 < 0 if cull == "back" else area2 > 0
        self.sx, self.sy, self.sz, self.w = sx[keep], sy[keep], sz[keep], w[keep]
        self.bary, self.src, self.area2 = bary[keep], src[keep], area2[keep]
        order = torch.argsort(scene.rank[self.src])
        lo = torch.stack([self.sx.min(1).values, self.sy.min(1).values], 1)
        hi = torch.stack([self.sx.max(1).values, self.sy.max(1).values], 1)
        self.groups = Groups(lo[order], hi[order], order)

    def query(self, pts, dtype=torch.float64, exact=True, chunk=1024):
        """Coverage of the points (Q, 2) (pixel centres) by candidate
        triangles: (query, triangle, state (2 covered, 1 within EDGE_PX of
        an edge), depth, (3,) barycentrics over the source corners, and
        the float32 reach of the program's depth and barycentrics there).
        With ``exact=False`` the states are 2 alone, computed in ``dtype``,
        and the reaches 0."""
        out = []
        for a, b in _chunks(len(pts), chunk):
            q, *rest = self._query(pts[a:b], dtype, exact)
            out.append((q + a, *rest))
        return tuple(torch.cat(x) for x in zip(*out))

    def _query(self, pts, dtype, exact):
        q, t = self.groups.points(pts, EDGE_PX + 1e-3)
        px, py = pts[q, 0].to(dtype), pts[q, 1].to(dtype)
        sx, sy = self.sx[t].to(dtype), self.sy[t].to(dtype)
        sign = torch.sign(self.area2[t]).to(dtype)
        cert = torch.ones_like(px, dtype=torch.bool)
        poss = torch.ones_like(cert)
        e, reach = [], []
        for i in range(3):
            ax, ay = sx[:, (i + 1) % 3], sy[:, (i + 1) % 3]
            bx, by = sx[:, (i + 2) % 3], sy[:, (i + 2) % 3]
            a_c = -sign * (by - ay)
            b_c = sign * (bx - ax)
            c_c = sign * ((by - ay) * ax - (bx - ax) * ay)
            ei = a_c * px + b_c * py + c_c
            e.append(ei)
            if exact:
                dist = ei / torch.sqrt(a_c * a_c + b_c * b_c)
                cert &= dist > EDGE_PX
                poss &= dist >= -EDGE_PX
                reach.append((a_c * px).abs() + (b_c * py).abs()
                             + (by - ay).abs() * torch.maximum(ax.abs(), bx.abs())
                             + (bx - ax).abs() * torch.maximum(ay.abs(), by.abs()))
            else:
                top_left = ((a_c == 0) & (b_c > 0)) | (a_c > 0)
                cert &= torch.where(top_left, ei >= 0, ei > 0)
        if not exact:
            poss = cert
        inv = 1.0 / self.area2[t].abs().to(dtype)
        b = [ei * inv for ei in e]
        sz = self.sz[t].to(dtype)
        z = b[0] * sz[:, 0] + b[1] * sz[:, 1] + b[2] * sz[:, 2]
        if exact:
            # Float32 reach of the program's plane equations (anchored at the
            # viewport's origin): depth and barycentric error bounds.
            dz = F32_REACH * inv * sum(r * sz[:, i].abs() for i, r in enumerate(reach))
            db = F32_REACH * inv * torch.maximum(torch.maximum(reach[0], reach[1]), reach[2])
        else:
            dz = db = torch.zeros_like(z)
        ok = poss & (z >= -dz) & (z <= 1 + dz)
        w = self.w[t].to(dtype)
        bw = [b[i] / w[:, i] for i in range(3)]
        den = bw[0] + bw[1] + bw[2]
        u = torch.stack([x / den for x in bw], 1)  # (P, 3)
        orig = (u[:, :, None] * self.bary[t].to(dtype)).sum(1)
        state = torch.where(cert, 2, 1)
        return q[ok], self.src[t[ok]], state[ok], z[ok], orig[ok], dz[ok], db[ok]


def _near_clip(clip):
    """Sutherland-Hodgman against clip z >= 0 (golden._clip_near), fanned
    into triangles: (clip (M, 3, 4), corner weights (M, 3, 3), source (M,))."""
    dev = clip.device
    inside = clip[..., 2] >= 0
    n_in = inside.sum(1)
    eye = torch.eye(3, dtype=clip.dtype, device=dev)
    full = (n_in == 3).nonzero().squeeze(1)
    part = ((n_in > 0) & (n_in < 3)).nonzero().squeeze(1)
    outs = [(clip[full], eye.expand(len(full), 3, 3), full)]
    if len(part):
        p, b = clip[part], eye.expand(len(part), 3, 3)
        verts, weights, oks = [], [], []
        for i in range(3):
            a, c = p[:, i], p[:, (i + 1) % 3]
            ba, bc = b[:, i], b[:, (i + 1) % 3]
            za, zc = a[:, 2], c[:, 2]
            verts.append(a)
            weights.append(ba)
            oks.append(za >= 0)
            s = (za / torch.where(za == zc, 1.0, za - zc))[:, None]
            verts.append(a + s * (c - a))
            weights.append(ba + s * (bc - ba))
            oks.append((za >= 0) != (zc >= 0))
        verts, weights, ok = torch.stack(verts, 1), torch.stack(weights, 1), torch.stack(oks, 1)
        order = torch.argsort((~ok).int(), dim=1, stable=True)
        verts = torch.gather(verts, 1, order[..., None].expand(-1, -1, 4))
        weights = torch.gather(weights, 1, order[..., None].expand(-1, -1, 3))
        count = ok.sum(1)
        outs.append((verts[:, :3], weights[:, :3], part))
        quad = (count == 4).nonzero().squeeze(1)
        fan = torch.tensor([0, 2, 3], device=dev)
        outs.append((verts[quad][:, fan], weights[quad][:, fan], part[quad]))
    return tuple(torch.cat(x) for x in zip(*outs))


def _visible(q, n_q, state, key, reach, max_keep=MAX_SURFACES):
    """Per query, the pairs whose ``key`` (depth or distance) may be the
    least: within their ``reach`` of the nearest certain pair's, nearest
    first, at most ``max_keep``: (slot (Q, K) pair index or -1, whether
    the query may show nothing)."""
    dev = key.device
    inf = torch.full((n_q,), float("inf"), dtype=key.dtype, device=dev)
    cert = state == 2
    best = inf.scatter_reduce(0, q[cert], key[cert] + reach[cert], "amin")
    near = key - reach <= best[q]
    idx = near.nonzero().squeeze(1)
    # Sort by (query, certain first, key): stable sorts from the last key.
    idx = idx[torch.argsort(key[idx], stable=True)]
    idx = idx[torch.argsort(state[idx], descending=True, stable=True)]
    idx = idx[torch.argsort(q[idx], stable=True)]
    qs = q[idx]
    start = torch.searchsorted(qs, torch.arange(n_q, device=dev))
    rank = torch.arange(len(qs), device=dev) - start[qs]
    keep = rank < max_keep
    slots = torch.full((n_q, max_keep), -1, dtype=torch.long, device=dev)
    slots[qs[keep], rank[keep]] = idx[keep]
    return slots, torch.isinf(best)


# --------------------------- rays --------------------------------------------


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)


def _dot(a, b):
    return (a * b).sum(1)


def ray_hits(scene: Scene, org, dirs, t_max, dtype=torch.float64, exact=True, chunk=1024):
    """Moller-Trumbore hits of the rays (R, 3) on candidate triangles, t in
    (1e-5, t_max): (ray, triangle, state (2 hit, 1 within float32 reach of
    missing), t, u, v)."""
    out = []
    r = org.shape[0]
    for lo, hi in _chunks(r, chunk):
        o, d, tm = org[lo:hi], dirs[lo:hi], t_max[lo:hi]
        inv = 1.0 / torch.where(d.abs() < 1e-20, 1e-20, d)
        qi, ti = scene.ray_groups.rays(o, inv, tm)
        oq, dq, tq = o[qi].to(dtype), d[qi].to(dtype), tm[qi].to(dtype)
        tri = scene.world[ti].to(dtype)
        v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        pvec = _cross(dq, e2)
        det = _dot(e1, pvec)
        idet = 1.0 / torch.where(det == 0, 1.0, det)
        tvec = oq - v0
        u = _dot(tvec, pvec) * idet
        qvec = _cross(tvec, e1)
        v = _dot(dq, qvec) * idet
        t = _dot(e2, qvec) * idet
        live = det.abs() > 1e-12
        if exact:
            def norm(x):
                return torch.sqrt(_dot(x, x))

            ad = idet.abs()
            mu = RAY_TIE * norm(tvec) * norm(pvec) * ad
            mv = RAY_TIE * norm(dq) * norm(qvec) * ad
            mt = RAY_TIE * (norm(e2) * norm(qvec) * ad + t.abs())
            cert = (live & (u > mu) & (v > mv) & (u + v < 1 - mu - mv)
                    & (t > 1e-5 + mt) & (t < tq - mt))
            poss = (live & (u >= -mu) & (v >= -mv) & (u + v <= 1 + mu + mv)
                    & (t > 1e-5 - mt) & (t < tq + mt))
        else:
            cert = poss = live & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-5) & (t < tq)
        state = torch.where(cert, 2, 1)
        out.append((qi[poss] + lo, ti[poss], state[poss], t[poss], u[poss], v[poss]))
    return tuple(torch.cat(x) for x in zip(*out))


def occlusion(scene, org, dirs, t_max, dtype, exact):
    """Any-hit states of the rays: 2 blocked, 1 either, 0 free."""
    q, _, state, *_ = ray_hits(scene, org, dirs, t_max, dtype, exact)
    out = torch.zeros(org.shape[0], dtype=torch.long, device=org.device)
    return out.scatter_reduce(0, q, state, "amax")


# --------------------------- shading -----------------------------------------


def bilinear_wrap(tex, u, v):
    """D3D linear + wrap sampling of (h, w, c) at (N,) coordinates."""
    h, w = tex.shape[:2]
    tx = u * w - 0.5
    ty = v * h - 0.5
    ix = torch.floor(tx).long()
    iy = torch.floor(ty).long()
    fx = (tx - ix)[:, None]
    fy = (ty - iy)[:, None]
    c00 = tex[iy % h, ix % w]
    c10 = tex[iy % h, (ix + 1) % w]
    c01 = tex[(iy + 1) % h, ix % w]
    c11 = tex[(iy + 1) % h, (ix + 1) % w]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def _unit(x):
    return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)), min=1e-20)


def radiance(n, wo, wi, ingoing, base, metal, rough):
    """golden._radiance over (..., 3) planes."""
    h = _unit(wo + wi)
    f0 = 0.04 + (base - 0.04) * metal[..., None]
    hdwo = torch.clamp((h * wo).sum(-1), min=0.0)[..., None]
    fres = f0 + (1 - f0) * torch.clamp(1 - hdwo, 0, 1) ** 5
    a2 = rough ** 4
    ndh = torch.clamp((n * h).sum(-1), min=0.0)
    ndf = a2 / (PI * (ndh * ndh * (a2 - 1) + 1) ** 2)
    k = (rough + 1) ** 2 / 8
    ndwo = torch.clamp((n * wo).sum(-1), min=0.0)
    ndwi = torch.clamp((n * wi).sum(-1), min=0.0)
    geo = (ndwo / (ndwo * (1 - k) + k)) * (ndwi / (ndwi * (1 - k) + k))
    spec = (ndf * geo)[..., None] * fres / (4 * ndwo * ndwi + 1e-4)[..., None]
    kd = (1 - fres) * (1 - metal[..., None])
    return (kd * base / PI + spec) * ingoing * ndwi[..., None]


def surface(scene: Scene, tri, bary, dtype):
    """World position, shading normal, base colour, metalness and
    roughness at (S,) triangles with barycentrics (S, 3)."""
    a = (bary[:, :, None] * scene.attrs[tri].to(dtype)).sum(1)
    wp = (bary[:, :, None] * scene.world[tri].to(dtype)).sum(1)
    n_v, t_v, b_v, uv = a[:, 0:3], a[:, 3:6], a[:, 6:9], a[:, 9:11]
    mat = scene.material[tri]
    base = torch.zeros_like(wp)
    nm = torch.zeros_like(wp)
    mr = torch.zeros((len(tri), 4), dtype=dtype, device=wp.device)
    for mi, maps in enumerate(scene.materials):
        sel = mat == mi
        if bool(sel.any()):
            u, v = uv[sel, 0], uv[sel, 1]
            base[sel] = bilinear_wrap(maps[0].to(dtype), u, v)[:, :3]
            nm[sel] = bilinear_wrap(maps[1].to(dtype), u, v)[:, :3]
            mr[sel] = bilinear_wrap(maps[2].to(dtype), u, v)
    nm = torch.stack([nm[:, 0], 1.0 - nm[:, 1], nm[:, 2]], 1) * 2.0 - 1.0
    n = _unit(t_v * nm[:, 0:1] + b_v * nm[:, 1:2] + n_v * nm[:, 2:3])
    return wp, n, base, mr[:, 2], mr[:, 1]


def sky_dirs(cam, px, py, width, height, dtype):
    """World-space view rays through pixel centres (golden's skybox and
    the ray-traced frame's primary rays)."""
    xs = px / width * 2 - 1
    ys = 1 - py / height * 2
    tf = math.tan(math.radians(cam["fov_y"]) / 2)
    rot = torch.as_tensor(camera_view(cam)[:3, :3], dtype=dtype, device=px.device)
    dv = torch.stack([xs * cam["aspect"] * tf, ys * tf, -torch.ones_like(xs)], 1)
    return dv @ rot


def sky(scene, dirs):
    d = _unit(dirs)
    eu = torch.atan2(d[:, 2], d[:, 0]) * 0.1591 + 0.5
    ev = -(torch.asin(torch.clamp(d[:, 1], -1, 1)) * 0.3183 + 0.5)
    return bilinear_wrap(scene.env.to(d.dtype), eu, ev)


def to_u8(hdr, settings):
    """f16 HDR store, tonemap, gamma, u8 (golden.render's tail)."""
    dtype = hdr.dtype
    hdr = hdr.to(torch.float16).to(dtype)
    tm = settings["tm_method"]
    if tm == 1:
        mapped = 1 - torch.exp(-hdr * settings["exposure"])
    elif tm == 2:
        inp = torch.tensor([[0.59719, 0.35458, 0.04823], [0.076, 0.90834, 0.01566],
                            [0.0284, 0.13383, 0.837]], dtype=dtype, device=hdr.device)
        outm = torch.tensor([[1.60475, -0.53108, -0.07367], [-0.10208, 1.10813, -0.00605],
                             [-0.00327, -0.07276, 1.07]], dtype=dtype, device=hdr.device)
        c = hdr @ inp.T
        a = c * (c + 0.0245786) - 0.000090537
        bq = c * (0.983729 * c + 0.4329510) + 0.238081
        mapped = torch.clamp((a / bq) @ outm.T, 0, 1)
    else:
        mapped = hdr / (hdr + 1)
    ldr = mapped.abs() ** (1.0 / settings["gamma"])
    return torch.round(torch.clamp(ldr, 0, 1) * 255).to(torch.uint8)


def _light_terms(frame, wp, n, base, metal, rough, dtype):
    """Unshadowed sun term (S, 3) and point-light terms (S, L, 3), and the
    unit directions toward each light with their distances."""
    dev = wp.device
    wo = _unit(torch.as_tensor(frame["camera"]["eye"], dtype=dtype, device=dev) - wp)
    sun = frame["sun"]
    wi = -torch.as_tensor(dir_from_rot(sun["rotation"]), dtype=dtype, device=dev).expand_as(wp)
    sun_term = radiance(n, wo, wi, torch.as_tensor(sun["color"], dtype=dtype, device=dev),
                        base, metal, rough)
    terms, dirs, dists = [], [], []
    for pos, col in frame["lights"]:
        ldir = torch.as_tensor(pos, dtype=dtype, device=dev) - wp
        dist = torch.clamp(torch.sqrt((ldir * ldir).sum(1)), min=1e-12)
        li = ldir / dist[:, None]
        rad = torch.as_tensor(col, dtype=dtype, device=dev) / (dist * dist)[:, None]
        terms.append(radiance(n, wo, li, rad, base, metal, rough))
        dirs.append(li)
        dists.append(dist)
    lt = torch.stack(terms, 1) if terms else wp.new_zeros((len(wp), 0, 3))
    return sun_term, lt, dirs, dists


# --------------------------- frames ------------------------------------------


def render_pixels(scene: Scene, frame: dict, pixels, dtype=torch.float64, exact=True):
    """Reference colours of the frame's pixels (N, 2) (x, y) int: (N, C, 3)
    u8 candidates and (N, C) mask of the admissible ones. ``frame`` holds
    mode ("raster" or "rt"), width, height, shadow_size, camera (eye,
    rotation, aspect, fov_y, z_near, z_far), sun (position, rotation,
    color), lights [(position, color)], ambient, settings (tm_method,
    gamma, exposure) and light_shadows (ray-traced mode)."""
    dev = scene.device
    w, h = frame["width"], frame["height"]
    pix = torch.as_tensor(pixels, device=dev).long()
    n = len(pix)
    pts = pix.to(torch.float64) + 0.5
    cam = frame["camera"]
    keep = MAX_SURFACES if exact else 1
    if frame["mode"] == "raster":
        ras = Raster(scene, camera_proj_view(cam), w, h, "back")
        q, tri, state, key, bary, reach, bary_reach = ras.query(pts, dtype, exact)
        reach = reach + (DEPTH_TIE if exact else 0.0)
    else:
        dirs = sky_dirs(cam, pts[:, 0], pts[:, 1], w, h, torch.float64)
        org = torch.as_tensor(cam["eye"], dtype=torch.float64, device=dev).expand(n, 3)
        t_max = torch.full((n,), 3.0e38, dtype=torch.float64, device=dev)
        q, tri, state, key, u, v = ray_hits(scene, org, dirs, t_max, dtype, exact)
        bary = torch.stack([1.0 - u - v, u, v], 1)
        reach = key.abs() * (RAY_TIE if exact else 0.0)
    slots, may_miss = _visible(q, n, state, key, reach, keep)
    k = slots.shape[1]
    live = slots >= 0
    pick = slots[live]
    wp, nrm, base, metal, rough = surface(scene, tri[pick], bary[pick].to(dtype), dtype)
    sun_term, light_terms, ldirs, ldists = _light_terms(frame, wp, nrm, base, metal, rough, dtype)
    n_l = light_terms.shape[1]
    if frame["mode"] == "raster":
        lo, hi = pcf_counts(scene, frame, wp, bary_reach[pick], dtype, exact)
        # Combination c: c of the 25 taps occluded; sun and lights scale alike.
        combos = torch.arange(26, device=dev)
        w_sun = (1 - combos.to(dtype) / 25)[None].expand(len(pick), -1)
        w_light = w_sun[:, :, None].expand(-1, -1, n_l)
        ok = (combos[None] >= lo[:, None]) & (combos[None] <= hi[:, None])
    else:
        w_sun, w_light, ok = rt_shadow_combos(scene, frame, wp, nrm, ldirs, ldists, dtype, exact)
    color = (w_sun[:, :, None] * sun_term[:, None]
             + (w_light[..., None] * light_terms[:, None]).sum(2)
             + frame["ambient"] * base[:, None])
    n_c = color.shape[1]
    u8 = to_u8(color.reshape(-1, 3), frame["settings"]).view(-1, n_c, 3)
    out = torch.zeros((n, k, n_c, 3), dtype=torch.uint8, device=dev)
    mask = torch.zeros((n, k, n_c), dtype=torch.bool, device=dev)
    out[live] = u8
    mask[live] = ok
    # The sky, where no certain surface covers the pixel.
    sky_px = sky(scene, sky_dirs(cam, pts[:, 0].to(dtype), pts[:, 1].to(dtype), w, h, dtype))
    sky_u8 = to_u8(sky_px, frame["settings"])
    out = torch.cat([out.view(n, -1, 3), sky_u8[:, None]], 1)
    mask = torch.cat([mask.view(n, -1), may_miss[:, None]], 1)
    return out, mask


def pcf_counts(scene, frame, wp, bary_reach, dtype, exact):
    """Least and most of the 25 PCF taps that may be occluded at world
    positions (S, 3), from the shadow pass worked out again at the texels
    the taps read. ``bary_reach``: the float32 reach of the program's
    barycentrics there, which moves its light-space depth."""
    dev = wp.device
    s = frame["shadow_size"]
    pv = sun_proj_view(frame["sun"])
    lsp = wp @ torch.as_tensor(pv[:3, :3].T, dtype=dtype, device=dev) + torch.as_tensor(
        pv[:3, 3], dtype=dtype, device=dev)
    su = lsp[:, 0] * 0.5 + 0.5
    sv = 1.0 - (lsp[:, 1] * 0.5 + 0.5)
    sz = lsp[:, 2]
    outside = (sz > 1) | (su < 0) | (sv < 0) | (su > 1) | (sv > 1)
    tx, ty = su * s - 0.5, sv * s - 0.5
    x0 = torch.floor(tx).long() - 1
    y0 = torch.floor(ty).long() - 1
    win = torch.arange(4, device=dev)
    ix = (x0[:, None, None] + win[None, None, :]) % s  # (S, 4, 4): [row, col]
    iy = (y0[:, None, None] + win[None, :, None]) % s
    key = (iy * s + ix).reshape(-1)
    texels, inv = torch.unique(key, return_inverse=True)
    pts = torch.stack([texels % s, texels // s], 1).to(torch.float64) + 0.5
    zlo, zhi = shadow_depths(scene, frame, pts, dtype, exact)
    zlo, zhi = zlo[inv].view(-1, 4, 4), zhi[inv].view(-1, 4, 4)
    lo = torch.zeros(len(wp), dtype=torch.long, device=dev)
    hi = torch.zeros_like(lo)
    # Light-space depths lie in [0, 1]: a barycentric error b moves the
    # interpolated one by at most 3b.
    eps = SHADOW_TIE + 3.0 * bary_reach if exact else 0.0
    for i in range(-2, 3):
        for j in range(-2, 3):
            ux = (su + i * 1e-4) * s - 0.5
            uy = (sv + j * 1e-4) * s - 0.5
            fx, fy = ux - torch.floor(ux), uy - torch.floor(uy)
            # 0..2 in exact arithmetic; clamped for the bfloat16 control.
            cx = (torch.floor(ux).long() - x0).clamp(0, 2)[:, None, None]
            cy = (torch.floor(uy).long() - y0).clamp(0, 2)[:, None, None]

            def bil(z):
                def at(dy, dx):
                    r = torch.gather(z, 1, (cy + dy).expand(-1, 1, 4)).squeeze(1)
                    return torch.gather(r, 1, (cx[:, 0] + dx)).squeeze(1)
                top = at(0, 0) + (at(0, 1) - at(0, 0)) * fx
                bot = at(1, 0) + (at(1, 1) - at(1, 0)) * fx
                return top + (bot - top) * fy

            lo += (sz > bil(zhi) + eps).long()
            hi += (sz > bil(zlo) - eps).long()
    lo = torch.where(outside, 0, lo)
    hi = torch.where(outside, 0, hi)
    return lo, hi


def shadow_depths(scene, frame, pts, dtype, exact, chunk=4096):
    """Depth interval [lo, hi] of the shadow map at texel centres (Q, 2):
    lo over every triangle that may cover the texel, hi over those that
    surely do (1.0, the clear depth, where none does)."""
    s = frame["shadow_size"]
    key = ("shadow", tuple(frame["sun"]["position"]), tuple(frame["sun"]["rotation"]), s)
    ras = scene.shadow_pass.get(key)
    if ras is None:
        scene.shadow_pass.clear()
        ras = scene.shadow_pass[key] = Raster(scene, sun_proj_view(frame["sun"]), s, s, "front")
    lo_out, hi_out = [], []
    for a, b in _chunks(len(pts), chunk):
        q, _, state, z, _, reach, _ = ras.query(pts[a:b], dtype, exact)
        one = torch.ones(b - a, dtype=dtype, device=pts.device)
        cert = state == 2
        lo_out.append(one.scatter_reduce(0, q, z - reach, "amin"))
        hi_out.append(one.scatter_reduce(0, q[cert], z[cert] + reach[cert], "amin"))
    return torch.cat(lo_out), torch.cat(hi_out)


def rt_shadow_combos(scene, frame, wp, nrm, ldirs, ldists, dtype, exact):
    """The ray-traced frame's shadow rays from p + 1e-3 n: (sun weight (S,
    C), light weights (S, C, L), admissible (S, C)) over the C = 2^(1 + L)
    combinations of each ray blocked or free (L = 0 without light
    shadows: the lights take the sun's visibility)."""
    dev = wp.device
    org = (wp + nrm * 1e-3).to(torch.float64)
    sun_dir = -torch.as_tensor(dir_from_rot(frame["sun"]["rotation"]), dtype=torch.float64,
                               device=dev).expand_as(org)
    big = torch.full((len(wp),), 3.0e38, dtype=torch.float64, device=dev)
    states = [occlusion(scene, org, sun_dir.contiguous(), big, dtype, exact)]
    n_l = len(ldirs)
    if frame.get("light_shadows"):
        for li, dist in zip(ldirs, ldists):
            states.append(occlusion(scene, org, li.to(torch.float64), dist.to(torch.float64) - 2e-3,
                                    dtype, exact))
    n_r = len(states)
    combos = torch.arange(2 ** n_r, device=dev)
    free = ((combos[:, None] >> torch.arange(n_r, device=dev)[None]) & 1) == 1  # (C, n_r)
    st = torch.stack(states, 1)  # (S, n_r)
    ok = ((st[:, None, :] != 2) | ~free[None]) & ((st[:, None, :] != 0) | free[None])
    ok = ok.all(2)
    w_sun = free[:, 0].to(dtype)[None].expand(len(wp), -1)
    if n_r > 1:
        w_light = (free[:, 1:] & free[:, :1]).to(dtype)
    else:
        w_light = free[:, :1].to(dtype).expand(-1, n_l)
    return w_sun, w_light[None].expand(len(wp), -1, -1), ok
