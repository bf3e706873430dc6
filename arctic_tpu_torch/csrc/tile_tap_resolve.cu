// K9 tile_tap_resolve — the tile-atlas texture + environment tap of every
// pixel, for reference-scale texture sets.
//
// Replaces arctic_tpu/ops/sampling.py:_tile_tap_resolve_kernel, with the row
// gather that preceded it (pipeline.shade_gbuffer: tiles[idx], a (P, 128)
// i32 materialisation) done inside the kernel. One i32 table of 128-lane
// rows holds two kinds of row:
//   texture tile: 4x8 texels of 8 u16 channels; lane c2*32 + y*8 + x holds
//     channel 2*c2 in its low half and 2*c2+1 in its high half;
//   env row: 8 bilinear quads of 16 f32 (bit patterns), [c00|c10|c01|c11] x RGBA.
// A covered pixel's idx is its material tile, an uncovered one's an env row;
// both parts are computed for every pixel, as the TPU kernel does.
// Texture part: taps (ty, tx), (ty, tx+1), (ty+1, tx), (ty+1, tx+1); the
// high half by an unsigned shift; dequantised as float(q) * DQ with DQ the
// f32 jnp.float32(1.0 / 65535.0); env part: bitcast to f32. Each bilerped as
//   top = c00 + (c10 - c00)*fx; bot = c01 + (c11 - c01)*fx; top + (bot - top)*fy.
// Output: 16 channel planes, [0, 8) texture, [8, 12) env RGBA, zero after.
//
// One thread per pixel. Bound on the H100: bytes — 32 B of per-pixel
// inputs, the distinct 512 B table rows the pixels read (neighbouring
// pixels mostly share tiles, so most reads hit L2) and 64 B of coalesced
// writes per pixel; about 140 f32 operations a pixel. Built with
// -fmad=false so the lerps equal the plain torch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kDq = 0x1.0001p-16f;  // == jnp.float32(1.0 / 65535.0)

__device__ __forceinline__ float lerp2(float c00, float c10, float c01, float c11,
                                       float fx, float fy) {
  const float top = c00 + (c10 - c00) * fx;
  const float bot = c01 + (c11 - c01) * fx;
  return top + (bot - top) * fy;
}

__device__ __forceinline__ float lo16(uint32_t v) { return (float)(v & 0xFFFFu) * kDq; }
__device__ __forceinline__ float hi16(uint32_t v) { return (float)(v >> 16) * kDq; }

__global__ void tile_tap_resolve_kernel(const int* __restrict__ table,
                                        const int* __restrict__ idx,
                                        const int* __restrict__ ty,
                                        const int* __restrict__ tx,
                                        const int* __restrict__ eq,
                                        const float* __restrict__ tfx,
                                        const float* __restrict__ tfy,
                                        const float* __restrict__ efx,
                                        const float* __restrict__ efy, int n,
                                        float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t* row = reinterpret_cast<const uint32_t*>(table) + (size_t)idx[p] * 128;
  const int w = ty[p] * 8 + tx[p];
  const float fx = tfx[p], fy = tfy[p];
  for (int c2 = 0; c2 < 4; ++c2) {
    const uint32_t* b = row + c2 * 32 + w;
    const uint32_t v00 = b[0], v10 = b[1], v01 = b[8], v11 = b[9];
    out[(size_t)(2 * c2) * n + p] =
        lerp2(lo16(v00), lo16(v10), lo16(v01), lo16(v11), fx, fy);
    out[(size_t)(2 * c2 + 1) * n + p] =
        lerp2(hi16(v00), hi16(v10), hi16(v01), hi16(v11), fx, fy);
  }
  // Env quad: four aligned 16-byte loads (row base 512 B, quad 64 B aligned).
  const int4* e = reinterpret_cast<const int4*>(row + 16 * eq[p]);
  const int4 q0 = e[0], q1 = e[1], q2 = e[2], q3 = e[3];
  const float gx = efx[p], gy = efy[p];
  const int a0[4] = {q0.x, q0.y, q0.z, q0.w};
  const int a1[4] = {q1.x, q1.y, q1.z, q1.w};
  const int a2[4] = {q2.x, q2.y, q2.z, q2.w};
  const int a3[4] = {q3.x, q3.y, q3.z, q3.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[(size_t)(8 + i) * n + p] =
        lerp2(__int_as_float(a0[i]), __int_as_float(a1[i]), __int_as_float(a2[i]),
              __int_as_float(a3[i]), gx, gy);
  }
#pragma unroll
  for (int i = 12; i < 16; ++i) out[(size_t)i * n + p] = 0.0f;
}

}  // namespace

// table (R, 128) i32; idx/ty/tx/eq (n,) i32; tfx/tfy/efx/efy (n,) f32;
// out (16, n) f32. table must be 16-byte aligned (every torch allocation is).
extern "C" int arctic_tile_tap_resolve(const int* table, const int* idx, const int* ty,
                                       const int* tx, const int* eq, const float* tfx,
                                       const float* tfy, const float* efx,
                                       const float* efy, int n, float* out,
                                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  tile_tap_resolve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, idx, ty, tx, eq, tfx, tfy, efx, efy, n, out);
  return (int)cudaGetLastError();
}
