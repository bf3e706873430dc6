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
// One thread per output element: a warp writes 32 consecutive lanes of one
// row (coalesced stores) and reads its slot's planes as broadcasts. Bound on
// the H100: bytes — 104 floats read and 128 written per slot, a streaming
// pass; nothing is reused, so no shared memory. Built with -fmad=false so
// the blends round exactly like the plain torch version.

#include <cuda_runtime.h>

namespace {

__global__ void pack_shade_rows_kernel(const float* __restrict__ pf,
                                       const float* __restrict__ st, int n,
                                       int p, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n * 128) return;
  const int slot = (int)(e >> 7);
  const int lane = (int)(e & 127);
#define PF(r) pf[(size_t)(r) * n + slot]
#define ST(r) st[(size_t)(r) * n + slot]
  float v = 0.0f;
  if (lane < 9) {
    v = PF(lane) * PF(12 + lane / 3);
  } else if (lane == 9) {
    v = slot < p ? (float)slot : -2.0f;
  } else if (lane >= 16 && lane < 88) {
    const int c = (lane - 16) / 24;
    const int j = (lane - 16) % 24;
    const float cb0 = PF(15 + 3 * c), cb1 = PF(16 + 3 * c), cb2 = PF(17 + 3 * c);
    if (j < 3) {
      v = cb0 * PF(24 + j) + cb1 * PF(27 + j) + cb2 * PF(30 + j);
    } else if (j < 14) {
      const int a = j - 3;
      v = cb0 * ST(a) + cb1 * ST(11 + a) + cb2 * ST(22 + a);
    } else if (j < 17) {
      const int a = j - 14;
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
  out[e] = v;
}

}  // namespace

// pf (48, n), st (56, n) f32 component-major; out (n, 128) f32; p = clip slots.
extern "C" int arctic_pack_shade_rows(const float* pf, const float* st, int n,
                                      int p, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long total = (long long)n * 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  pack_shade_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(pf, st, n, p, out);
  return (int)cudaGetLastError();
}
