// K14 bvh_trace — closest-hit / any-hit traversal of a threaded BVH.
//
// Replaces arctic_tpu/ops/rt.py:trace, which is not a Pallas kernel but a
// lax.while_loop that advances every ray's node cursor in lockstep (one
// slab test and up to LEAF_SIZE = 4 Moller-Trumbore tests per ray per step)
// until the slowest ray has left the tree. In eager torch that loop costs
// ~70 launches and a host sync per step; here one thread walks one ray's
// whole path.
//
// The tree is flattened in DFS preorder with skip pointers (ops/rt.py
// build_bvh): from a node the walk goes to node + 1 (an inner node whose
// box the ray hits) or to skip[node] (a miss, or a leaf), so it needs no
// stack and no shared memory. The lockstep loop visits each ray's nodes in
// this same order, so the per-ray walk reproduces it bit for bit:
//   inv_d = 1 / (|d| < 1e-20 ? 1e-20 : d)            (IEEE division)
//   t0 = (bb_min - o) * inv_d; t1 = (bb_max - o) * inv_d   (per axis)
//   tn = max_axes min(t0, t1); tf = min_axes max(t0, t1)
//   hit = tf >= max(tn, 0) && tn < best_t            (NaN anywhere: miss,
//         as torch.minimum / torch.max propagate it and compares fail)
//   leaf: for k < count, in order: Moller-Trumbore with jnp.cross's order
//         and each 3-term sum as (a0*b0 + a1*b1) + a2*b2, accepted when
//         |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, t > 1e-5, t < best_t
//         (strict: the earlier of equal hits stays);
//   any-hit rays stop after the whole leaf in which they found a hit.
// Built with -fmad=false (no contraction into FMAs), as the plain torch
// version rounds every operation.
//
// Bound on the H100: neither rate. The work is ~25 f32 operations a node
// visit and ~60 a triangle test over data-dependent paths, and each visit
// is a dependent load (node -> child / skip) followed by a chain of
// dependent instructions: the walk is bound by instruction throughput and that
// chain's latency, while the records of a real-size tree (16 MB) stay in
// the 50 MB L2. chip_smoke.py reports the rate bound of the visits and
// tests the plain version counts. The design makes each visit cheaper and
// keeps the lanes together, without changing any ray's node order or
// arithmetic:
//   - one node is one 32-B record, {bb_min.xyz, skip} {bb_max.xyz, first
//     << 3 | count}, read with two 128-bit read-only loads (one sector);
//     descending goes to the next record;
//   - one triangle is one 48-B record, {v0.xyz, tri_id} {e1.xyz, 0}
//     {e2.xyz, 0}, read with three; a leaf's <= 4 triangles are contiguous;
//   - a while-while walk (Aila & Laine, HPG 2009): the inner loop moves a
//     lane through inner nodes and missed boxes until it reaches a leaf
//     whose box it hits; then the warp's lanes at a leaf test theirs
//     together, two triangles' loads sent before their tests (all four
//     at once took 76 registers a thread and ran slower). A leaf is
//     tested before the next node's box, whose tn < best_t reads the
//     leaf's result: nothing is speculated;
//   - the slab test takes fminf / fmaxf (one instruction each) where the
//     reference's a < b ? a : b takes two. They differ only on NaN and on
//     the sign of a zero: a NaN makes the box a miss either way, and
//     compares do not see a zero's sign. When the tree's boxes and the
//     ray's origin and direction are finite, no t is NaN (inv_d is finite
//     and non-zero), so that walk skips the six NaN tests; any other ray
//     takes the walk with them;
//   - when the rays are a row-major image (width > 0) a warp walks an 8 x 4
//     pixel tile, whose rays take closer paths than 32 pixels of one row
//     (ops/rt.py warp_rays writes the same mapping). The grid holds the
//     warps that fit on the card at once, and a warp whose 32 rays are all
//     done takes the next tile from a counter (persistent warps);
//   - kThreads = 256-thread blocks under __launch_bounds__ (128 ran a few
//     per cent slower), no shared memory, the largest L1 carveout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeafSize = 4;
constexpr int kBatch = 2;  // triangles whose loads go out before their tests
constexpr int kWarp = 32;
constexpr int kTileW = 8;
constexpr int kTileH = 4;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

struct Best {
  float t, u, v;
  int tri;
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? 1e-20f : d);
}

// The slab test of the node whose record halves are lo and hi; kNaN: the
// t's may be NaN (see the header).
template <bool kNaN>
__device__ __forceinline__ bool hits_box(const Ray& ray, float4 lo, float4 hi, float best_t) {
  const float t0x = (lo.x - ray.ox) * ray.ix, t1x = (hi.x - ray.ox) * ray.ix;
  const float t0y = (lo.y - ray.oy) * ray.iy, t1y = (hi.y - ray.oy) * ray.iy;
  const float t0z = (lo.z - ray.oz) * ray.iz, t1z = (hi.z - ray.oz) * ray.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  const bool hit = tf >= fmaxf(tn, 0.0f) && tn < best_t;
  if (!kNaN) return hit;
  const bool nan = (t0x != t0x) | (t1x != t1x) | (t0y != t0y) | (t1y != t1y) |
                   (t0z != t0z) | (t1z != t1z);
  return hit && !nan;
}

// Moller-Trumbore against the triangle record {a, b, c}.
__device__ __forceinline__ void test_triangle(const Ray& ray, float4 a, float4 b, float4 c,
                                              Best& best) {
  const float e1x = b.x, e1y = b.y, e1z = b.z;
  const float e2x = c.x, e2y = c.y, e2z = c.z;
  // pvec = cross(d, e2)
  const float px = ray.dy * e2z - ray.dz * e2y;
  const float py = ray.dz * e2x - ray.dx * e2z;
  const float pz = ray.dx * e2y - ray.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float idet = 1.0f / (det == 0.0f ? 1.0f : det);
  const float tx = ray.ox - a.x, ty = ray.oy - a.y, tz = ray.oz - a.z;
  const float u = (tx * px + ty * py + tz * pz) * idet;
  // qvec = cross(tvec, e1)
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (ray.dx * qx + ray.dy * qy + ray.dz * qz) * idet;
  const float th = (e2x * qx + e2y * qy + e2z * qz) * idet;
  if (fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > 1e-5f &&
      th < best.t) {
    best.t = th;
    best.tri = __float_as_int(a.w);
    best.u = u;
    best.v = v;
  }
}

// The ray that lane `lane` of work item (warp tile) `item` walks, -1 for
// none: 32 consecutive rays, or an 8 x 4 tile of a row-major image.
__device__ __forceinline__ int ray_of(int item, int lane, int width, int n_rays) {
  if (width == 0) {
    const int r = item * kWarp + lane;
    return r < n_rays ? r : -1;
  }
  const int height = n_rays / width;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int x = (item % tiles_x) * kTileW + lane % kTileW;
  const int y = (item / tiles_x) * kTileH + lane / kTileW;
  return (x < width && y < height) ? y * width + x : -1;
}

// One ray's walk from the root; best holds t_max on entry.
template <bool kNaN>
__device__ __forceinline__ void walk(const float4* __restrict__ nodes,
                                     const float4* __restrict__ tris, int n_tris, int any_hit,
                                     const Ray& ray, Best& best) {
  int node = 0;
  while (node >= 0) {
    // Inner nodes and missed boxes, until a leaf whose box the ray hits.
    int leaf = 0, next = -1;
    while (node >= 0) {
      const float4 lo = __ldg(nodes + 2 * (size_t)node);
      const float4 hi = __ldg(nodes + 2 * (size_t)node + 1);
      const int skip = __float_as_int(lo.w);
      const int word = __float_as_int(hi.w);
      const bool hit = hits_box<kNaN>(ray, lo, hi, best.t);
      if (hit && (word & 7) != 0) {
        leaf = word;
        next = skip;
        break;
      }
      node = hit ? node + 1 : skip;
    }
    if (leaf == 0) break;
    // The leaf's triangles in order, kBatch at a time: loads, then tests.
    const int first = leaf >> 3, count = leaf & 7;
#pragma unroll
    for (int k0 = 0; k0 < kLeafSize; k0 += kBatch) {
      float4 a[kBatch], b[kBatch], c[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (k0 + k < count) {
          const float4* p = tris + 3 * (size_t)min(first + k0 + k, n_tris - 1);
          a[k] = __ldg(p);
          b[k] = __ldg(p + 1);
          c[k] = __ldg(p + 2);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (k0 + k < count) test_triangle(ray, a[k], b[k], c[k], best);
      }
    }
    node = (any_hit && best.tri >= 0) ? -1 : next;
  }
}

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

__device__ __forceinline__ void trace_ray(const float4* __restrict__ nodes,
                                          const float4* __restrict__ tris, int n_tris,
                                          int boxes_finite, const float* __restrict__ origin,
                                          const float* __restrict__ direction,
                                          const float* __restrict__ t_max, int any_hit, int r,
                                          float* __restrict__ out_t, int* __restrict__ out_tri,
                                          float* __restrict__ out_u, float* __restrict__ out_v) {
  Ray ray;
  ray.ox = origin[3 * r], ray.oy = origin[3 * r + 1], ray.oz = origin[3 * r + 2];
  ray.dx = direction[3 * r], ray.dy = direction[3 * r + 1], ray.dz = direction[3 * r + 2];
  ray.ix = inv_dir(ray.dx), ray.iy = inv_dir(ray.dy), ray.iz = inv_dir(ray.dz);
  Best best{t_max[r], 0.0f, 0.0f, -1};
  if (boxes_finite && finite3(ray.ox, ray.oy, ray.oz) && finite3(ray.dx, ray.dy, ray.dz)) {
    walk<false>(nodes, tris, n_tris, any_hit, ray, best);
  } else {
    walk<true>(nodes, tris, n_tris, any_hit, ray, best);
  }
  out_t[r] = best.t;
  out_tri[r] = best.tri;
  out_u[r] = best.u;
  out_v[r] = best.v;
}

// One warp a work item of 32 rays. The grid holds the warps that fit on
// the card at once; a warp whose lanes are all done takes the next item
// from *next_item (zeroed before the launch).
__global__ void __launch_bounds__(kThreads)
    bvh_trace_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tris,
                     int n_tris, int boxes_finite, const float* __restrict__ origin,
                     const float* __restrict__ direction, const float* __restrict__ t_max,
                     int n_rays, int any_hit, int width, int n_items, int* __restrict__ next_item,
                     float* __restrict__ out_t, int* __restrict__ out_tri,
                     float* __restrict__ out_u, float* __restrict__ out_v) {
  const int lane = threadIdx.x % kWarp;
  int item = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  while (item < n_items) {
    const int r = ray_of(item, lane, width, n_rays);
    if (r >= 0) {
      trace_ray(nodes, tris, n_tris, boxes_finite, origin, direction, t_max, any_hit, r, out_t,
                out_tri, out_u, out_v);
    }
    int taken = 0;
    if (lane == 0) taken = atomicAdd(next_item, 1);
    item = __shfl_sync(0xffffffffu, taken, 0) + gridDim.x * kWarpsPerBlock;
  }
}

}  // namespace

// nodes (N, 8) i32 and tris (T, 12) i32 records (ops/rt.py BVH), 32-B /
// 16-B aligned; boxes_finite: every node box is finite; origin / direction
// (R, 3) f32; t_max (R,) f32; width 0 or the image width (R a multiple of
// it); next_item one int of scratch; out_t / out_u / out_v (R,) f32,
// out_tri (R,) i32.
extern "C" int arctic_bvh_trace(const void* nodes, const void* tris, int n_tris,
                                int boxes_finite, const float* origin, const float* direction,
                                const float* t_max, int n_rays, int any_hit, int width,
                                int* next_item, float* out_t, int* out_tri, float* out_u,
                                float* out_v, void* stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  if (width < 0 || (width > 0 && n_rays % width != 0)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bvh_trace_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxL1);
  if (err != cudaSuccess) return (int)err;
  const int n_items = width == 0 ? (n_rays + kWarp - 1) / kWarp
                                 : ((width + kTileW - 1) / kTileW) *
                                       ((n_rays / width + kTileH - 1) / kTileH);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_trace_kernel, kThreads,
                                                           0)) != cudaSuccess) {
    return (int)err;
  }
  const int needed = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = needed < sms * per_sm ? needed : sms * per_sm;
  const cudaStream_t s = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(next_item, 0, sizeof(int), s)) != cudaSuccess) return (int)err;
  bvh_trace_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float4*>(nodes), static_cast<const float4*>(tris), n_tris, boxes_finite,
      origin, direction, t_max, n_rays, any_hit, width, n_items, next_item, out_t, out_tri, out_u,
      out_v);
  return (int)cudaGetLastError();
}

// out[0] registers a thread, out[1] local (spill) bytes a thread, out[2]
// the block size, out[3] blocks an SM holds at once.
extern "C" int arctic_bvh_trace_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bvh_trace_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], bvh_trace_kernel, kThreads,
                                                            0);
}
