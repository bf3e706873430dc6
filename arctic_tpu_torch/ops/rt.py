"""Ray tracing: a host-built threaded BVH and its traversal — torch port of
arctic_tpu/ops/rt.py around K14 ``bvh_trace`` (csrc/bvh_trace.cu).

The BVH is built once on the host (median split over centroids, binary,
LEAF_SIZE triangles a leaf) and flattened in DFS preorder with skip
pointers: a ray needs no stack, only a node cursor that moves to
``node + 1`` (descend) or ``skip[node]`` (advance). Leaves run
Moller-Trumbore over their triangles. On the device the tree is two
tables of records, one 32-B record a node and one 48-B record a triangle
(``BVH.nodes``, ``BVH.tris``); the JAX package's nine arrays are views of
them.

``trace`` launches K14 (one thread per ray walking the tree) for CUDA
tensors; for CPU tensors it runs ``trace_plain``, the JAX package's
lockstep loop (rt.py:124-190) in torch: every ray's cursor advances one
node a step until all have left the tree. A ray visits its nodes in the
same order either way, so both give the same hits bit for bit: each
3-term sum is ``(a0*b0 + a1*b1) + a2*b2`` and each cross product takes
jnp.cross's order, with no fused multiply-add (K14 builds with
-fmad=false, and torch's elementwise ops round each operation).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from arctic_tpu_torch.utils import kernels
from arctic_tpu_torch.utils.errors import RenderError

LEAF_SIZE = 4

# Operations of one node visit (the slab test: 6 sub, 6 mul, 6 min/max, 4
# max/min of the axes, 3 compares) and of one triangle test (2 cross
# products, 4 dot products, 2 differences, the divide, the scaling and the
# compares), for K14's bound.
NODE_OPS = 25
TRI_OPS = 60
# Bytes of a node record ({bb_min.xyz, skip}, {bb_max.xyz, first << 3 |
# count}) and of a triangle record ({v0.xyz, tri_id}, {e1.xyz, 0}, {e2.xyz,
# 0}), and a ray's inputs (origin, direction, t_max) and outputs (t, tri, u,
# v).
NODE_BYTES = 32
TRI_BYTES = 48
RAY_BYTES = 28 + 16
# A node record keeps first << 3 | count in one int32, so first (< the
# triangle count) must stay below 2**28.
TRI_LIMIT = 1 << 28
# K14's lanes: a warp walks 32 consecutive rays, or an 8 x 4 pixel tile of
# a row-major image (``trace``'s ``width``).
WARP = 32
TILE_W, TILE_H = 8, 4
# How K14's warps take their rays (csrc/bvh_trace.cu).
MAPPING = "8 x 4 warp tiles of an image (width > 0), persistent warps"


@dataclass
class BVH:
    """DFS-preorder flattened nodes (a leaf iff count > 0; skip = the next
    node in preorder that is not a descendant, -1 past the end) and the
    triangles in leaf order, as K14 reads them: one record a node and one a
    triangle, int32 words (floats by their bits). ``FIELDS`` are the JAX
    package's arrays: views of the records (``first`` and ``count``
    decoded from their shared word). ``boxes_finite``: no box bound is NaN
    or infinite, which lets K14 skip its NaN tests on finite rays."""

    FIELDS = ("bb_min", "bb_max", "first", "count", "skip", "v0", "e1", "e2", "tri_id")

    nodes: torch.Tensor  # (N, 8) i32: bb_min.xyz, skip, bb_max.xyz, first << 3 | count
    tris: torch.Tensor  # (T, 12) i32: v0.xyz, tri_id, e1.xyz (v1 - v0), 0, e2.xyz (v2 - v0), 0
    boxes_finite: bool

    @classmethod
    def pack(cls, bb_min, bb_max, first, count, skip, v0, e1, e2, tri_id) -> BVH:
        """The records of the nine JAX-shaped arrays (torch tensors on one
        device): bit for bit, each field reads back from the records.
        Raises RenderError for TRI_LIMIT triangles or more."""
        t = v0.shape[0]
        if t >= TRI_LIMIT:
            raise RenderError(
                f"{t} triangles: a BVH node record holds first << 3 | count in an int32, so "
                f"the ray-traced mode takes fewer than 2**28 = {TRI_LIMIT} triangles")
        i32 = torch.int32
        nodes = torch.empty((first.shape[0], 8), dtype=i32, device=first.device)
        nodes[:, 0:3] = bb_min.view(i32)
        nodes[:, 3] = skip
        nodes[:, 4:7] = bb_max.view(i32)
        nodes[:, 7] = (first << 3) | count
        tris = torch.zeros((t, 12), dtype=i32, device=v0.device)
        tris[:, 0:3] = v0.view(i32)
        tris[:, 3] = tri_id
        tris[:, 4:7] = e1.view(i32)
        tris[:, 8:11] = e2.view(i32)
        finite = bool(torch.isfinite(bb_min).all()) and bool(torch.isfinite(bb_max).all())
        return cls(nodes=nodes, tris=tris, boxes_finite=finite)

    @property
    def bb_min(self) -> torch.Tensor:  # (N, 3) f32
        return self.nodes[:, 0:3].view(torch.float32)

    @property
    def bb_max(self) -> torch.Tensor:  # (N, 3) f32
        return self.nodes[:, 4:7].view(torch.float32)

    @property
    def first(self) -> torch.Tensor:  # (N,) i32 first-triangle offset (leaves; 0 for inner)
        return self.nodes[:, 7] >> 3

    @property
    def count(self) -> torch.Tensor:  # (N,) i32 0 for inner nodes
        return self.nodes[:, 7] & 7

    @property
    def skip(self) -> torch.Tensor:  # (N,) i32
        return self.nodes[:, 3]

    @property
    def v0(self) -> torch.Tensor:  # (T, 3) f32
        return self.tris[:, 0:3].view(torch.float32)

    @property
    def e1(self) -> torch.Tensor:  # (T, 3) f32
        return self.tris[:, 4:7].view(torch.float32)

    @property
    def e2(self) -> torch.Tensor:  # (T, 3) f32
        return self.tris[:, 8:11].view(torch.float32)

    @property
    def tri_id(self) -> torch.Tensor:  # (T,) i32 original triangle index
        return self.tris[:, 3]

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]

    @property
    def nbytes(self) -> int:
        return (self.nodes.numel() + self.tris.numel()) * 4


@dataclass
class Hits:
    t: torch.Tensor  # (R,) f32 hit distance (t_max on a miss)
    tri: torch.Tensor  # (R,) i32 original triangle id (-1 = miss)
    u: torch.Tensor  # (R,) f32 barycentric of corner 1
    v: torch.Tensor  # (R,) f32 barycentric of corner 2

    def __iter__(self):
        return iter((self.t, self.tri, self.u, self.v))


def _build_nodes(lo, hi, centroid):
    """Median-split build: (nodes in DFS preorder, leaf triangle lists).
    Each node: [bb_min, bb_max, first, count, size] with size its subtree's
    node count, so that skip = index + size. ``first`` comes from a running
    count of the leaves' triangles (the JAX package sums every earlier
    leaf's length at each leaf, quadratic in the triangle count; the
    offsets are the same)."""
    nodes = []
    leaf_tris = []
    offset = 0
    work = [(0, np.arange(len(lo)), None)]  # (phase, idx, node position)
    while work:
        phase, idx, pos = work.pop()
        if phase == 1:  # after both subtrees: the subtree's size
            nodes[pos][4] = len(nodes) - pos
            continue
        node = [lo[idx].min(axis=0), hi[idx].max(axis=0), 0, 0, 1]
        pos = len(nodes)
        nodes.append(node)
        if len(idx) <= LEAF_SIZE:
            node[2], node[3] = offset, len(idx)
            offset += len(idx)
            leaf_tris.append(idx)
            continue
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        med = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        work.append((1, None, pos))
        work.append((0, idx[med[half:]], None))  # right (emitted second)
        work.append((0, idx[med[:half]], None))  # left (emitted first)
    return nodes, leaf_tris


def build_bvh(tris_world, device="cpu") -> BVH:
    """(T, 3, 3) world-space triangles -> threaded BVH on ``device``
    (JAX rt.py:80-103; the same arrays). An empty scene gets one degenerate
    triangle, which no ray hits."""
    t = np.asarray(tris_world, np.float32)
    if len(t) == 0:
        t = np.zeros((1, 3, 3), np.float32)
    lo = t.min(axis=1)
    hi = t.max(axis=1)
    centroid = (lo + hi) * 0.5
    nodes, leaf_tris = _build_nodes(lo, hi, centroid)
    n = len(nodes)
    skip = np.fromiter((i + nd[4] for i, nd in enumerate(nodes)), np.int32, n)
    skip[skip >= n] = -1
    flat = np.concatenate(leaf_tris)
    tv = t[flat]

    def arr(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    bvh = BVH.pack(
        bb_min=arr(np.stack([nd[0] for nd in nodes]).astype(np.float32)),
        bb_max=arr(np.stack([nd[1] for nd in nodes]).astype(np.float32)),
        first=arr(np.asarray([nd[2] for nd in nodes], np.int32)),
        count=arr(np.asarray([nd[3] for nd in nodes], np.int32)),
        skip=arr(skip),
        v0=arr(tv[:, 0]),
        e1=arr(tv[:, 1] - tv[:, 0]),
        e2=arr(tv[:, 2] - tv[:, 0]),
        tri_id=arr(flat.astype(np.int32)),
    )
    return BVH(nodes=bvh.nodes.to(device), tris=bvh.tris.to(device),
               boxes_finite=bvh.boxes_finite)


def _ray_t_max(t_max, r: int, device) -> torch.Tensor:
    """(R,) f32 per-ray bound, a new tensor (trace_plain updates it in place)."""
    if isinstance(t_max, torch.Tensor):
        return t_max.to(device=device, dtype=torch.float32).expand(r).clone()
    return torch.full((r,), float(t_max), dtype=torch.float32, device=device)


def _cross(a, b):
    """jnp.cross's order: (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def trace_plain(bvh: BVH, origin, direction, t_max=3.0e38, any_hit: bool = False,
                width: int = 0, stats: dict | None = None) -> Hits:
    """Plain torch K14: the JAX package's lockstep traversal (rt.py:124-190).
    Each step moves every ray still in the tree one node; rays that left it
    are dropped from the step's tensors every few steps (their state is
    final). ``width`` (K14's lane mapping) changes no ray's result and is
    not read. ``stats``, if given, receives the work: per ray, ``visits``
    (nodes) and ``tests`` (the triangle tests its leaves ask for), (R,) i32
    tensors counted on the rays' device with no host sync; their sums
    ``node_visits`` and ``tri_tests``; the distinct ``nodes`` / ``tris``
    read, and the lockstep ``steps``."""
    r = origin.shape[0]
    dev = origin.device
    o = [origin[:, i].contiguous() for i in range(3)]
    d = [direction[:, i].contiguous() for i in range(3)]
    inv = [1.0 / torch.where(torch.abs(x) < 1e-20, 1e-20, x) for x in d]
    t_best = _ray_t_max(t_max, r, dev)
    tri_best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(r, dtype=torch.float32, device=dev)
    v_best = torch.zeros(r, dtype=torch.float32, device=dev)
    node = torch.zeros(r, dtype=torch.int32, device=dev)
    live = torch.arange(r, device=dev)  # rays still in the tree
    leaf_pad = bvh.num_tris
    bmin = [bvh.bb_min[:, i].contiguous() for i in range(3)]
    bmax = [bvh.bb_max[:, i].contiguous() for i in range(3)]
    count, first_tri, skip, tri_id = (x.contiguous() for x in (bvh.count, bvh.first, bvh.skip,
                                                                bvh.tri_id))
    tri_cols = {k: [getattr(bvh, k)[:, i].contiguous() for i in range(3)] for k in ("v0", "e1", "e2")}
    if stats is not None:
        visits = torch.zeros(r, dtype=torch.int32, device=dev)
        tests = torch.zeros(r, dtype=torch.int32, device=dev)
        node_reads = torch.zeros(bvh.num_nodes, dtype=torch.int32, device=dev)
        tri_reads = torch.zeros(leaf_pad, dtype=torch.int32, device=dev)
    step = 0
    while live.numel():
        # The live rays' state, gathered once per run of steps.
        lo_, ld, linv = ([x[live] for x in a] for a in (o, d, inv))
        lt, ltri, lu, lv, lnode = t_best[live], tri_best[live], u_best[live], v_best[live], node[live]
        if stats is not None:
            lvisits, ltests = visits[live], tests[live]
        for _ in range(16):
            active = lnode >= 0
            nidx = torch.clamp(lnode, min=0).long()
            t0 = [(bmin[i][nidx] - lo_[i]) * linv[i] for i in range(3)]
            t1 = [(bmax[i][nidx] - lo_[i]) * linv[i] for i in range(3)]
            near = [torch.minimum(a, b) for a, b in zip(t0, t1)]
            far = [torch.maximum(a, b) for a, b in zip(t0, t1)]
            tn = torch.maximum(torch.maximum(near[0], near[1]), near[2])
            tf = torch.minimum(torch.minimum(far[0], far[1]), far[2])
            hit_box = active & (tf >= torch.clamp(tn, min=0.0)) & (tn < lt)
            cnt = count[nidx]
            first = first_tri[nidx]
            is_leaf = hit_box & (cnt > 0)
            if stats is not None:
                lvisits += active
                node_reads.index_add_(0, nidx, active.int())
            for k in range(LEAF_SIZE):
                ti = torch.clamp(first + k, max=leaf_pad - 1).long()
                ok = is_leaf & (k < cnt)
                if stats is not None:
                    ltests += ok
                    tri_reads.index_add_(0, ti, ok.int())
                v0, e1, e2 = ([c[ti] for c in tri_cols[key]] for key in ("v0", "e1", "e2"))
                pvec = _cross(ld, e2)
                det = _dot(e1, pvec)
                ok = ok & (torch.abs(det) > 1e-12)
                idet = 1.0 / torch.where(det == 0, 1.0, det)
                tvec = [lo_[i] - v0[i] for i in range(3)]
                u = _dot(tvec, pvec) * idet
                qvec = _cross(tvec, e1)
                v = _dot(ld, qvec) * idet
                th = _dot(e2, qvec) * idet
                ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (th > 1e-5) & (th < lt)
                lt = torch.where(ok, th, lt)
                ltri = torch.where(ok, tri_id[ti], ltri)
                lu = torch.where(ok, u, lu)
                lv = torch.where(ok, v, lv)
            descend = hit_box & (cnt == 0)
            nxt = torch.where(descend, lnode + 1, skip[nidx])
            lnode = torch.where(active, nxt, lnode)
            if any_hit:
                lnode = torch.where(ltri >= 0, -1, lnode)
            step += 1
        t_best[live], tri_best[live], u_best[live], v_best[live], node[live] = lt, ltri, lu, lv, lnode
        if stats is not None:
            visits[live], tests[live] = lvisits, ltests
        live = live[lnode >= 0]
    if stats is not None:
        stats.update(visits=visits, tests=tests, node_visits=int(visits.sum()),
                     tri_tests=int(tests.sum()), nodes=int((node_reads > 0).sum()),
                     tris=int((tri_reads > 0).sum()), steps=step)
    return Hits(t=t_best, tri=tri_best, u=u_best, v=v_best)


def warp_rays(n_rays: int, width: int = 0, device="cpu") -> torch.Tensor:
    """(warps, WARP) i64: the ray each lane of each K14 warp walks, -1 for
    an idle lane. ``width`` 0: 32 consecutive rays a warp; else the rays
    are a row-major image ``width`` wide, and each warp takes a TILE_W x
    TILE_H pixel tile, tiles in row-major order (csrc/bvh_trace.cu's
    ``ray_of``)."""
    if width == 0:
        idx = torch.arange(math.ceil(n_rays / WARP) * WARP, device=device)
        return torch.where(idx < n_rays, idx, -1).view(-1, WARP)
    height = _image_height(n_rays, width)
    tiles_x = math.ceil(width / TILE_W)
    tile = torch.arange(tiles_x * math.ceil(height / TILE_H), device=device)[:, None]
    lane = torch.arange(WARP, device=device)
    x = (tile % tiles_x) * TILE_W + lane % TILE_W
    y = (tile // tiles_x) * TILE_H + lane // TILE_W
    return torch.where((x < width) & (y < height), y * width + x, -1)


def _image_height(n_rays: int, width: int) -> int:
    if width < 0 or (width and n_rays % width):
        raise ValueError(f"{n_rays} rays are no row-major image {width} wide")
    return n_rays // width


def lockstep_efficiency(visits: torch.Tensor, width: int = 0) -> float:
    """Sum of the rays' node visits over 32 x the sum, over K14's warps
    (``warp_rays``), of the warp's most: the share of lanes busy if each
    warp walked its rays in lockstep, one node a step."""
    lanes = warp_rays(visits.shape[0], width, visits.device)
    per_lane = torch.where(lanes >= 0, visits[lanes.clamp(min=0)], 0)
    return float(visits.sum()) / float(WARP * per_lane.amax(dim=1).sum())


@kernels.kernel(
    "bvh_trace", "arctic_tpu_torch/csrc/bvh_trace.cu",
    "arctic_tpu/ops/rt.py:124 (rt.trace's lax.while_loop; no Pallas kernel)",
    trace_plain,
)
def trace(bvh: BVH, origin, direction, t_max=3.0e38, any_hit: bool = False,
          width: int = 0) -> Hits:
    """K14: closest-hit (or, with ``any_hit``, first-found) traversal of
    (R, 3) f32 rays. ``t_max``: a float or (R,) per-ray bound (hits need t
    < t_max). ``width``: the image width when the rays are a row-major
    image (each warp then walks an 8 x 4 pixel tile), 0 for 32 consecutive
    rays a warp; it changes which rays walk together, not a ray's result.
    Returns Hits (t = t_max and tri = -1 on a miss)."""
    if not origin.is_cuda:
        return trace_plain(bvh, origin, direction, t_max, any_hit, width)
    r = origin.shape[0]
    if width:
        _image_height(r, width)
    kernels.check_cuda(origin, "origin", torch.float32, (r, 3))
    kernels.check_cuda(direction, "direction", torch.float32, (r, 3))
    kernels.check_cuda(bvh.nodes, "nodes", torch.int32, (bvh.num_nodes, 8))
    kernels.check_cuda(bvh.tris, "tris", torch.int32, (bvh.num_tris, 12))
    if bvh.nodes.data_ptr() % NODE_BYTES or bvh.tris.data_ptr() % 16:
        raise ValueError("nodes / tris: K14's record loads need 32-B / 16-B aligned tables")
    tm = _ray_t_max(t_max, r, origin.device)
    out_t = torch.empty(r, dtype=torch.float32, device=origin.device)
    out_tri = torch.empty(r, dtype=torch.int32, device=origin.device)
    out_u = torch.empty(r, dtype=torch.float32, device=origin.device)
    out_v = torch.empty(r, dtype=torch.float32, device=origin.device)
    next_item = torch.empty(1, dtype=torch.int32, device=origin.device)
    kernels.launch("arctic_bvh_trace", bvh.nodes, bvh.tris, bvh.num_tris, int(bvh.boxes_finite),
                   origin, direction, tm, r, int(any_hit), width, next_item, out_t, out_tri,
                   out_u, out_v)
    trace.launches += 1
    return Hits(t=out_t, tri=out_tri, u=out_u, v=out_v)
