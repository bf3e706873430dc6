// K3 pack_shade_rows — builds the 128-lane shade row of every clip slot.
//
// Replaces arctic_tpu/ops/raster_tiles.py:_pack_shade_rows_kernel. Inputs
// are component-major planes along the slot dim (pipeline.build_shade_rows):
//   pf (48, N): [0:9) raw edge coeffs, [9:12) z plane, [12:15) inv_area2/w_c,
//               [15:24) clip-corner blend weights cb[c][k] at 15+3c+k,
//               [24:33) world corners wc[k][i] at 24+3k+i, [33:42)
//               light-space corners, [42:48) zero;
//   st (56, N): [0:33) corner n/t/b/uv (k*11+j), [33:56) material row.
// Output (N, 128) lane map (raster_tiles.py:218-250): [0:9) edges scaled by
// inv_area2/w_c, [9] slot id (-2 past p), [16:40) / [40:64) / [64:88) the
// corner-c blends (cb0*x0 + cb1*x1) + cb2*x2 of world xyz, 11 static
// attrs and light-space xyz, [88:111) material row, [112:121) raw edges,
// [121:124) z plane, [124] slot id (0 past p); every other lane zero.
//
// Bound on the H100: bytes — 104 floats read and 128 written per slot, a
// streaming pass. One 256-thread block handles kSlots = 32 consecutive
// slots in three steps, each coalesced:
//   1. stage their 104 input planes in shared memory (a warp reads 32
//      consecutive slots of one plane, 128 B);
//   2. compute: lane l takes slot l, warp w the 16-byte quads w, w + 8, ...
//      of the row, so every lane of a warp takes the same branch (the lane
//      map is a chain of cases) and reads its own slot's column of the
//      planes, bank-conflict free at a row pitch of 33 floats; the quads go
//      to a (32, 33) float4 buffer, whose odd pitch keeps the 16-byte
//      stores conflict free;
//   3. write the (32, 128) output block, one contiguous 16 KB run, as
//      16-byte stores, a warp 512 B at a time.
// A ragged last block stages zeros past N and stores nothing there. Built
// with -fmad=false, and each lane keeps the plain version's expression and
// order, so the blends round exactly like it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 32;  // slots per block
constexpr int kPf = 48;
constexpr int kPlanes = kPf + 56;
constexpr int kQuads = 128 / 4;  // 16-byte stores per row
static_assert(kSlots == 32, "lane l of a warp computes slot l of the block");

using Planes = float[kPlanes][kSlots + 1];

// Lane `lane` of the row of slot `slot`, whose planes are column j of s.
__device__ __forceinline__ float lane_value(const Planes& s, int j, int slot, int p, int lane) {
#define PF(r) s[r][j]
#define ST(r) s[kPf + (r)][j]
  float v = 0.0f;
  if (lane < 9) {
    v = PF(lane) * PF(12 + lane / 3);
  } else if (lane == 9) {
    v = slot < p ? (float)slot : -2.0f;
  } else if (lane >= 16 && lane < 88) {
    const int c = (lane - 16) / 24;
    const int i = (lane - 16) % 24;
    const float cb0 = PF(15 + 3 * c), cb1 = PF(16 + 3 * c), cb2 = PF(17 + 3 * c);
    if (i < 3) {
      v = cb0 * PF(24 + i) + cb1 * PF(27 + i) + cb2 * PF(30 + i);
    } else if (i < 14) {
      const int a = i - 3;
      v = cb0 * ST(a) + cb1 * ST(11 + a) + cb2 * ST(22 + a);
    } else if (i < 17) {
      const int a = i - 14;
      v = cb0 * PF(33 + a) + cb1 * PF(36 + a) + cb2 * PF(39 + a);
    }
  } else if (lane >= 88 && lane < 111) {
    v = ST(33 + lane - 88);
  } else if (lane >= 112 && lane < 124) {
    v = PF(lane - 112);  // raw edges [0:9) then the z plane [9:12)
  } else if (lane == 124) {
    v = slot < p ? (float)slot : 0.0f;
  }
#undef PF
#undef ST
  return v;
}

__global__ void __launch_bounds__(kThreads) pack_shade_rows_kernel(
    const float* __restrict__ pf, const float* __restrict__ st, int n, int p,
    float* __restrict__ out) {
  __shared__ Planes s;
  __shared__ float4 s_out[kSlots][kQuads + 1];
  const int slot0 = blockIdx.x * kSlots;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll 4
  for (int r = warp; r < kPlanes; r += kThreads / 32) {
    const int slot = slot0 + lane;
    float v = 0.0f;
    if (slot < n) v = r < kPf ? pf[(size_t)r * n + slot] : st[(size_t)(r - kPf) * n + slot];
    s[r][lane] = v;
  }
  __syncthreads();
  // Lane l computes slot slot0 + l; warp w the quads w, w + 8, ...: every
  // branch of lane_value is uniform across the warp.
#pragma unroll
  for (int q = warp; q < kQuads; q += kThreads / 32) {
    const int slot = slot0 + lane;
    s_out[lane][q] = make_float4(lane_value(s, lane, slot, p, 4 * q),
                                 lane_value(s, lane, slot, p, 4 * q + 1),
                                 lane_value(s, lane, slot, p, 4 * q + 2),
                                 lane_value(s, lane, slot, p, 4 * q + 3));
  }
  __syncthreads();
  // The block's rows are one contiguous run: quad q of it is row q / 32.
  float4* out4 = reinterpret_cast<float4*>(out) + (size_t)slot0 * kQuads;
#pragma unroll
  for (int q = threadIdx.x; q < kSlots * kQuads; q += kThreads) {
    if (slot0 + q / kQuads < n) out4[q] = s_out[q / kQuads][q % kQuads];
  }
}

}  // namespace

// pf (48, n), st (56, n) f32 component-major; out (n, 128) f32; p = clip slots.
extern "C" int arctic_pack_shade_rows(const float* pf, const float* st, int n,
                                      int p, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + kSlots - 1) / kSlots);
  pack_shade_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(pf, st, n, p, out);
  return (int)cudaGetLastError();
}
