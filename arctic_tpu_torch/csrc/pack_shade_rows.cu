// K3 pack_shade_rows and K11 pack_shade_rows_tm — build the 128-lane shade
// row of every clip slot; one kernel template, two instantiations.
//
// K3 replaces arctic_tpu/ops/raster_tiles.py:_pack_shade_rows_kernel. Its
// inputs are component-major planes along the slot dim
// (pipeline.build_shade_rows):
//   pf (48, N): [0:9) raw edge coeffs, [9:12) z plane, [12:15) inv_area2/w_c,
//               [15:24) clip-corner blend weights cb[c][k] at 15+3c+k,
//               [24:33) world corners wc[k][i] at 24+3k+i, [33:42)
//               light-space corners, [42:48) zero;
//   st (56, N): [0:33) corner n/t/b/uv (k*11+j), [33:56) material row.
// K11 replaces _pack_shade_rows_tm_kernel: the 18 wc / lsp planes are per
// triangle, so it takes pf (24, N) = K3's rows 0:24 and tri (18, cap)
// tri-major (wc[k][i] at 3k+i, lsp[k][i] at 9+3k+i), and slot s reads
// triangle s % cap for s < 2 * cap, zeros beyond — K3's rows 24:42 on the
// dup'd stack [tri; tri], which is what the TPU kernel's modular block map
// read. The JAX package only took K11 when p == 2 * cap + 1, which its
// frame's p == 2 * cap never is; K11 takes any p <= N.
// Output (N, 128) lane map (raster_tiles.py:218-250): [0:9) edges scaled by
// inv_area2/w_c, [9] slot id (-2 past p), [16:40) / [40:64) / [64:88) the
// corner-c blends (cb0*x0 + cb1*x1) + cb2*x2 of world xyz, 11 static
// attrs and light-space xyz, [88:111) material row, [112:121) raw edges,
// [121:124) z plane, [124] slot id (0 past p); every other lane zero.
//
// Bound on the H100: bytes — K3 reads 104 floats and K11 80 floats a slot
// plus its 18 tri-major planes, and both write 128; a streaming pass. One
// 256-thread block handles kSlots = 32 consecutive slots in three steps,
// each coalesced:
//   1. stage their 104 input planes in shared memory (a warp reads 32
//      consecutive slots of one plane, 128 B; K11 fills rows 24:48 from
//      the tri-major planes, at most two contiguous runs a warp where the
//      block straddles slot cap, and zeros);
//   2. compute: lane l takes slot l, warp w the 16-byte quads w, w + 8, ...
//      of the row, so every lane of a warp takes the same branch (the lane
//      map is a chain of cases) and reads its own slot's column of the
//      planes, bank-conflict free at a row pitch of 33 floats; the quads go
//      to a (32, 33) float4 buffer, whose odd pitch keeps the 16-byte
//      stores conflict free;
//   3. write the (32, 128) output block, one contiguous 16 KB run, as
//      16-byte stores, a warp 512 B at a time.
// Only step 1 depends on the instantiation. A ragged last block stages
// zeros past N and stores nothing there. Built with -fmad=false, and each
// lane keeps the plain version's expression and order, so the blends round
// exactly like it.

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

// Plane r < kPf of slot `slot` (< n): K3 reads its 48-row pf; K11 its 24-row
// pf, then slot % cap of the tri-major planes for slot < 2 * cap, else zero.
template <bool kTriMajor>
__device__ __forceinline__ float pf_plane(const float* __restrict__ pf,
                                          const float* __restrict__ tri, int n, int cap,
                                          int r, int slot) {
  if constexpr (kTriMajor) {
    if (r >= 24) {
      const int t = slot < cap ? slot : slot - cap;
      return r < 42 && t < cap ? tri[(size_t)(r - 24) * cap + t] : 0.0f;
    }
  }
  return pf[(size_t)r * n + slot];
}

// tri and cap come last and only K11 reads them, so K3's instantiation
// takes its parameters where it always has.
template <bool kTriMajor>
__global__ void __launch_bounds__(kThreads) pack_shade_rows_kernel(
    const float* __restrict__ pf, const float* __restrict__ st, int n, int p,
    float* __restrict__ out, const float* __restrict__ tri, int cap) {
  __shared__ Planes s;
  __shared__ float4 s_out[kSlots][kQuads + 1];
  const int slot0 = blockIdx.x * kSlots;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll 4
  for (int r = warp; r < kPlanes; r += kThreads / 32) {
    const int slot = slot0 + lane;
    float v = 0.0f;
    if (slot < n) {
      v = r < kPf ? pf_plane<kTriMajor>(pf, tri, n, cap, r, slot)
                  : st[(size_t)(r - kPf) * n + slot];
    }
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
  pack_shade_rows_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pf, st, n, p, out, nullptr, 0);
  return (int)cudaGetLastError();
}

// pf (24, n), tri (18, cap), st (56, n) f32; out (n, 128) f32; p <= n slots.
extern "C" int arctic_pack_shade_rows_tm(const float* pf, const float* tri, const float* st,
                                         int n, int cap, int p, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (cap <= 0 || p < 0 || p > n) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kSlots - 1) / kSlots);
  pack_shade_rows_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pf, st, n, p, out, tri, cap);
  return (int)cudaGetLastError();
}

// Each instantiation's attributes: out[0] registers a thread, out[1] local
// (spill) bytes a thread, out[2] the block size, out[3] blocks an SM holds
// at once.
template <bool kTriMajor>
static int attributes(int* out) {
  const auto kernel = pack_shade_rows_kernel<kTriMajor>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, kThreads, 0);
}

extern "C" int arctic_pack_shade_rows_attributes(int* out) { return attributes<false>(out); }

extern "C" int arctic_pack_shade_rows_tm_attributes(int* out) { return attributes<true>(out); }
