"""Ray tracing: a host-built threaded BVH and its traversal — torch port of
arctic_tpu/ops/rt.py around K14 ``bvh_trace`` (csrc/bvh_trace.cu).

The BVH is built once on the host (median split over centroids, binary,
LEAF_SIZE triangles a leaf) and flattened in DFS preorder with skip
pointers: a ray needs no stack, only a node cursor that moves to
``node + 1`` (descend) or ``skip[node]`` (advance). Leaves run
Moller-Trumbore over their triangles.

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

from dataclasses import dataclass

import numpy as np
import torch

from arctic_tpu_torch.utils import kernels

LEAF_SIZE = 4

# Operations of one node visit (the slab test: 6 sub, 6 mul, 6 min/max, 4
# max/min of the axes, 3 compares) and of one triangle test (2 cross
# products, 4 dot products, 2 differences, the divide, the scaling and the
# compares), for K14's bound.
NODE_OPS = 25
TRI_OPS = 60
# Bytes a node (bb_min, bb_max, first, count, skip) and a triangle (v0, e1,
# e2, tri_id) hold, and a ray's inputs (origin, direction, t_max) and
# outputs (t, tri, u, v).
NODE_BYTES = 36
TRI_BYTES = 40
RAY_BYTES = 28 + 16


@dataclass
class BVH:
    """DFS-preorder flattened nodes (a leaf iff count > 0; skip = the next
    node in preorder that is not a descendant, -1 past the end) and the
    triangles in leaf order."""

    FIELDS = ("bb_min", "bb_max", "first", "count", "skip", "v0", "e1", "e2", "tri_id")

    bb_min: torch.Tensor  # (N, 3) f32
    bb_max: torch.Tensor  # (N, 3) f32
    first: torch.Tensor  # (N,) i32 first-triangle offset (leaves; 0 for inner)
    count: torch.Tensor  # (N,) i32 0 for inner nodes
    skip: torch.Tensor  # (N,) i32
    v0: torch.Tensor  # (T, 3) f32
    e1: torch.Tensor  # (T, 3) f32 (v1 - v0)
    e2: torch.Tensor  # (T, 3) f32 (v2 - v0)
    tri_id: torch.Tensor  # (T,) i32 original triangle index

    @property
    def num_nodes(self) -> int:
        return self.count.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * 4 for f in self.FIELDS)


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

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return BVH(
        bb_min=dev(np.stack([nd[0] for nd in nodes]).astype(np.float32)),
        bb_max=dev(np.stack([nd[1] for nd in nodes]).astype(np.float32)),
        first=dev(np.asarray([nd[2] for nd in nodes], np.int32)),
        count=dev(np.asarray([nd[3] for nd in nodes], np.int32)),
        skip=dev(skip),
        v0=dev(tv[:, 0]),
        e1=dev(tv[:, 1] - tv[:, 0]),
        e2=dev(tv[:, 2] - tv[:, 0]),
        tri_id=dev(flat.astype(np.int32)),
    )


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
                stats: dict | None = None) -> Hits:
    """Plain torch K14: the JAX package's lockstep traversal (rt.py:124-190).
    Each step moves every ray still in the tree one node; rays that left it
    are dropped from the step's tensors every few steps (their state is
    final). ``stats``, if given, receives the step's work: ``node_visits``
    and ``tri_tests`` (the triangle tests the leaves ask for), summed over
    the rays, and the distinct ``nodes`` / ``tris`` read."""
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
    leaf_pad = bvh.v0.shape[0]
    bmin = [bvh.bb_min[:, i].contiguous() for i in range(3)]
    bmax = [bvh.bb_max[:, i].contiguous() for i in range(3)]
    tri_cols = {k: [getattr(bvh, k)[:, i].contiguous() for i in range(3)] for k in ("v0", "e1", "e2")}
    visits = tests = 0
    seen_nodes = torch.zeros(bvh.num_nodes, dtype=torch.bool, device=dev)
    seen_tris = torch.zeros(leaf_pad, dtype=torch.bool, device=dev)
    step = 0
    while live.numel():
        # The live rays' state, gathered once per run of steps.
        lo_, ld, linv = ([x[live] for x in a] for a in (o, d, inv))
        lt, ltri, lu, lv, lnode = t_best[live], tri_best[live], u_best[live], v_best[live], node[live]
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
            cnt = bvh.count[nidx]
            first = bvh.first[nidx]
            is_leaf = hit_box & (cnt > 0)
            if stats is not None:
                visits += int(active.sum())
                seen_nodes[nidx[active]] = True
            for k in range(LEAF_SIZE):
                ti = torch.clamp(first + k, max=leaf_pad - 1).long()
                ok = is_leaf & (k < cnt)
                if stats is not None:
                    tests += int(ok.sum())
                    seen_tris[ti[ok]] = True
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
                ltri = torch.where(ok, bvh.tri_id[ti], ltri)
                lu = torch.where(ok, u, lu)
                lv = torch.where(ok, v, lv)
            descend = hit_box & (cnt == 0)
            nxt = torch.where(descend, lnode + 1, bvh.skip[nidx])
            lnode = torch.where(active, nxt, lnode)
            if any_hit:
                lnode = torch.where(ltri >= 0, -1, lnode)
            step += 1
        t_best[live], tri_best[live], u_best[live], v_best[live], node[live] = lt, ltri, lu, lv, lnode
        live = live[lnode >= 0]
    if stats is not None:
        stats.update(node_visits=visits, tri_tests=tests, nodes=int(seen_nodes.sum()),
                     tris=int(seen_tris.sum()), steps=step)
    return Hits(t=t_best, tri=tri_best, u=u_best, v=v_best)


@kernels.kernel(
    "bvh_trace", "arctic_tpu_torch/csrc/bvh_trace.cu",
    "arctic_tpu/ops/rt.py:124 (rt.trace's lax.while_loop; no Pallas kernel)",
    trace_plain,
)
def trace(bvh: BVH, origin, direction, t_max=3.0e38, any_hit: bool = False) -> Hits:
    """K14: closest-hit (or, with ``any_hit``, first-found) traversal of
    (R, 3) f32 rays. ``t_max``: a float or (R,) per-ray bound (hits need t
    < t_max). Returns Hits (t = t_max and tri = -1 on a miss)."""
    if not origin.is_cuda:
        return trace_plain(bvh, origin, direction, t_max, any_hit)
    r = origin.shape[0]
    kernels.check_cuda(origin, "origin", torch.float32, (r, 3))
    kernels.check_cuda(direction, "direction", torch.float32, (r, 3))
    n, t = bvh.num_nodes, bvh.v0.shape[0]
    for name, shape, dtype in (("bb_min", (n, 3), torch.float32), ("bb_max", (n, 3), torch.float32),
                               ("first", (n,), torch.int32), ("count", (n,), torch.int32),
                               ("skip", (n,), torch.int32), ("v0", (t, 3), torch.float32),
                               ("e1", (t, 3), torch.float32), ("e2", (t, 3), torch.float32),
                               ("tri_id", (t,), torch.int32)):
        kernels.check_cuda(getattr(bvh, name), name, dtype, shape)
    tm = _ray_t_max(t_max, r, origin.device)
    out_t = torch.empty(r, dtype=torch.float32, device=origin.device)
    out_tri = torch.empty(r, dtype=torch.int32, device=origin.device)
    out_u = torch.empty(r, dtype=torch.float32, device=origin.device)
    out_v = torch.empty(r, dtype=torch.float32, device=origin.device)
    kernels.launch("arctic_bvh_trace", bvh.bb_min, bvh.bb_max, bvh.first, bvh.count, bvh.skip,
                   bvh.v0, bvh.e1, bvh.e2, bvh.tri_id, t, origin, direction, tm, r,
                   int(any_hit), out_t, out_tri, out_u, out_v)
    trace.launches += 1
    return Hits(t=out_t, tri=out_tri, u=out_u, v=out_v)

