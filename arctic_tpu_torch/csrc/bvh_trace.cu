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
// visit and ~60 a triangle test, over data-dependent paths: a warp's rays
// diverge, and each visit is a dependent load (node -> child / skip) whose
// latency, not bandwidth, sets the time. chip_smoke.py reports the rate
// bound of the visits and tests the plain version counts. A simple kernel
// first: no ray sorting, packets or wide BVHs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeafSize = 4;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? 1e-20f : d);
}

__device__ __forceinline__ float min2(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float max2(float a, float b) { return a > b ? a : b; }

__global__ void bvh_trace_kernel(const float* __restrict__ bb_min, const float* __restrict__ bb_max,
                                 const int* __restrict__ first, const int* __restrict__ count,
                                 const int* __restrict__ skip, const float* __restrict__ v0s,
                                 const float* __restrict__ e1s, const float* __restrict__ e2s,
                                 const int* __restrict__ tri_id, int n_tris,
                                 const float* __restrict__ origin,
                                 const float* __restrict__ direction,
                                 const float* __restrict__ t_max, int n_rays, int any_hit,
                                 float* __restrict__ out_t, int* __restrict__ out_tri,
                                 float* __restrict__ out_u, float* __restrict__ out_v) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  Ray ray;
  ray.ox = origin[3 * r], ray.oy = origin[3 * r + 1], ray.oz = origin[3 * r + 2];
  ray.dx = direction[3 * r], ray.dy = direction[3 * r + 1], ray.dz = direction[3 * r + 2];
  ray.ix = inv_dir(ray.dx), ray.iy = inv_dir(ray.dy), ray.iz = inv_dir(ray.dz);
  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1;
  int node = 0;
  while (node >= 0) {
    const float* lo = bb_min + 3 * (size_t)node;
    const float* hi = bb_max + 3 * (size_t)node;
    const float t0x = (lo[0] - ray.ox) * ray.ix, t1x = (hi[0] - ray.ox) * ray.ix;
    const float t0y = (lo[1] - ray.oy) * ray.iy, t1y = (hi[1] - ray.oy) * ray.iy;
    const float t0z = (lo[2] - ray.oz) * ray.iz, t1z = (hi[2] - ray.oz) * ray.iz;
    const bool nan = (t0x != t0x) | (t1x != t1x) | (t0y != t0y) | (t1y != t1y) |
                     (t0z != t0z) | (t1z != t1z);
    const float tn = max2(max2(min2(t0x, t1x), min2(t0y, t1y)), min2(t0z, t1z));
    const float tf = min2(min2(max2(t0x, t1x), max2(t0y, t1y)), max2(t0z, t1z));
    const bool hit_box = !nan && tf >= (tn > 0.0f ? tn : 0.0f) && tn < best_t;
    const int cnt = count[node];
    if (hit_box && cnt > 0) {
      const int f = first[node];
      for (int k = 0; k < kLeafSize && k < cnt; ++k) {
        const int ti = min(f + k, n_tris - 1);
        const float* a = v0s + 3 * (size_t)ti;
        const float* b = e1s + 3 * (size_t)ti;
        const float* c = e2s + 3 * (size_t)ti;
        const float e1x = b[0], e1y = b[1], e1z = b[2];
        const float e2x = c[0], e2y = c[1], e2z = c[2];
        // pvec = cross(d, e2)
        const float px = ray.dy * e2z - ray.dz * e2y;
        const float py = ray.dz * e2x - ray.dx * e2z;
        const float pz = ray.dx * e2y - ray.dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float idet = 1.0f / (det == 0.0f ? 1.0f : det);
        const float tx = ray.ox - a[0], ty = ray.oy - a[1], tz = ray.oz - a[2];
        const float u = (tx * px + ty * py + tz * pz) * idet;
        // qvec = cross(tvec, e1)
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (ray.dx * qx + ray.dy * qy + ray.dz * qz) * idet;
        const float th = (e2x * qx + e2y * qy + e2z * qz) * idet;
        if (fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > 1e-5f &&
            th < best_t) {
          best_t = th;
          best_tri = tri_id[ti];
          best_u = u;
          best_v = v;
        }
      }
    }
    node = (hit_box && cnt == 0) ? node + 1 : skip[node];
    if (any_hit && best_tri >= 0) node = -1;
  }
  out_t[r] = best_t;
  out_tri[r] = best_tri;
  out_u[r] = best_u;
  out_v[r] = best_v;
}

}  // namespace

// bb_min / bb_max (N, 3) f32; first / count / skip (N,) i32; v0 / e1 / e2
// (T, 3) f32; tri_id (T,) i32; origin / direction (R, 3) f32; t_max (R,)
// f32; out_t / out_u / out_v (R,) f32, out_tri (R,) i32.
extern "C" int arctic_bvh_trace(const float* bb_min, const float* bb_max, const int* first,
                                const int* count, const int* skip, const float* v0,
                                const float* e1, const float* e2, const int* tri_id, int n_tris,
                                const float* origin, const float* direction, const float* t_max,
                                int n_rays, int any_hit, float* out_t, int* out_tri,
                                float* out_u, float* out_v, void* stream) {
  if (n_rays <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n_rays + threads - 1) / threads);
  bvh_trace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      bb_min, bb_max, first, count, skip, v0, e1, e2, tri_id, n_tris, origin, direction, t_max,
      n_rays, any_hit, out_t, out_tri, out_u, out_v);
  return (int)cudaGetLastError();
}
