// K6 tap_resolve — the merged texture + environment tap of every pixel.
//
// Replaces arctic_tpu/ops/sampling.py:_tap_resolve_kernel, with the row
// gather that preceded it (pipeline.shade_gbuffer: merged[idx]) done inside
// the kernel. A covered pixel reads its material quad, an uncovered one its
// environment quad, from one bf16 table of 128-lane rows:
//   texture quad: lanes [c4*tq, c4*tq + c4) = [c00 | c10 | c01 | c11], c4/4 each;
//   env quad:     lanes [16*eq, 16*eq + 16) = [c00 | c10 | c01 | c11], 4 each.
// Each is widened to f32 (exact) and bilerped as sampling.py:275-286:
//   top = c00 + (c10 - c00)*fx; bot = c01 + (c11 - c01)*fx; top + (bot - top)*fy.
// Output: 16 channel planes, [0, c4/4) texture, [c4/4, c4/4 + 4) env RGBA,
// zero after.
//
// One thread per pixel. Bound on the H100: the row gather — 2 x 64 B of
// scattered reads (neighbouring pixels mostly hit the same rows in L2) and
// 64 B of coalesced writes per pixel. Built with -fmad=false so the lerps
// equal the plain torch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(((unsigned)b) << 16);
}

__global__ void tap_resolve_kernel(const uint16_t* __restrict__ table,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ tq,
                                   const int* __restrict__ eq,
                                   const float* __restrict__ tfx,
                                   const float* __restrict__ tfy,
                                   const float* __restrict__ efx,
                                   const float* __restrict__ efy, int n, int c4,
                                   float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint16_t* row = table + (size_t)idx[p] * 128;
  const int c = c4 / 4;
  const int tb = c4 * tq[p];
  const float fx = tfx[p], fy = tfy[p];
  for (int i = 0; i < c; ++i) {
    const float w0 = bf16_to_f32(row[tb + i]);
    const float w1 = bf16_to_f32(row[tb + c + i]);
    const float w2 = bf16_to_f32(row[tb + 2 * c + i]);
    const float w3 = bf16_to_f32(row[tb + 3 * c + i]);
    const float top = w0 + (w1 - w0) * fx;
    const float bot = w2 + (w3 - w2) * fx;
    out[(size_t)i * n + p] = top + (bot - top) * fy;
  }
  const int eb = 16 * eq[p];
  const float gx = efx[p], gy = efy[p];
  for (int i = 0; i < 4; ++i) {
    const float e0 = bf16_to_f32(row[eb + i]);
    const float e1 = bf16_to_f32(row[eb + 4 + i]);
    const float e2 = bf16_to_f32(row[eb + 8 + i]);
    const float e3 = bf16_to_f32(row[eb + 12 + i]);
    const float top = e0 + (e1 - e0) * gx;
    const float bot = e2 + (e3 - e2) * gx;
    out[(size_t)(c + i) * n + p] = top + (bot - top) * gy;
  }
  for (int i = c + 4; i < 16; ++i) out[(size_t)i * n + p] = 0.0f;
}

}  // namespace

// table (R, 128) bf16 bits; idx/tq/eq (n,) i32; tfx/tfy/efx/efy (n,) f32;
// out (16, n) f32. c4 in {8, ..., 48}, a multiple of 4 with c4/4 + 4 <= 16.
extern "C" int arctic_tap_resolve(const uint16_t* table, const int* idx,
                                  const int* tq, const int* eq, const float* tfx,
                                  const float* tfy, const float* efx,
                                  const float* efy, int n, int c4, float* out,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (c4 % 4 != 0 || c4 / 4 + 4 > 16 || c4 > 128) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  tap_resolve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, idx, tq, eq, tfx, tfy, efx, efy, n, c4, out);
  return (int)cudaGetLastError();
}
