// K7 window_lut_q — the wrap-padded, u16-quantised shadow map that the
// quantised PCF path (K8) reads its 4x4 windows from.
//
// Replaces arctic_tpu/ops/shadow.py:_lut_kernel_q with _lut_step_q. The TPU
// kernel scattered the quantised texels into 16x8-texel blocks at y-stride
// 12 and x-stride 4, two texels per i32 lane, through one-hot matmuls,
// because a TPU gather costs by table size and row count. On Hopper a
// pixel reads its window straight from the padded map, so the table is that
// map: row y, column x holds texel ((y - 2) mod S, (x - 2) mod S) of the
// source, quantised as q = floor(clip(x * 65535 + 0.5, 0, 65535)) with the
// multiply and the add rounded separately (-fmad=false, and the intrinsics
// say so). Rows outside [y_lo, y_hi + 3] (the band of window start_y the
// frame's consumed pixels can have, read from device memory) and columns
// past S + 4 are written as 0, so the whole table is defined.
//
// One thread per pair of output texels (one 32-bit store), one grid row per
// table row. Bound on the H100: bytes — the source rows of the band read
// once (4 B a texel, coalesced; the source keeps its own row pitch, e.g. the
// raster's padded depth buffer) and the table written once (2 B a texel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t quantise(float x) {
  float t = __fadd_rn(__fmul_rn(x, 65535.0f), 0.5f);
  t = fminf(fmaxf(t, 0.0f), 65535.0f);
  return (uint32_t)floorf(t);
}

__device__ __forceinline__ int wrap2(int v, int s) {
  int w = v - 2;
  if (w < 0) w += s;
  else if (w >= s) w -= s;
  return w;
}

__global__ void window_lut_q_kernel(const float* __restrict__ src, long long src_pitch,
                                    int s, const int* __restrict__ y_range,
                                    int pitch, uint32_t* __restrict__ out) {
  const int half = pitch / 2;
  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= half) return;
  const int y = blockIdx.y;
  const int sp = s + 4;
  uint32_t v = 0;
  if (y >= y_range[0] && y <= y_range[1] + 3) {
    const float* row = src + (long long)wrap2(y, s) * src_pitch;
    const int x0 = 2 * pair;
    if (x0 < sp) v = quantise(row[wrap2(x0, s)]);
    if (x0 + 1 < sp) v |= quantise(row[wrap2(x0 + 1, s)]) << 16;
  }
  out[(long long)y * half + pair] = v;
}

}  // namespace

// src: f32 map, row pitch src_pitch floats, (s, s) used; y_range (2,) i32 on
// the device; out (s + 4, pitch) u16, pitch even and >= s + 4.
extern "C" int arctic_window_lut_q(const float* src, int src_pitch, int s,
                                   const int* y_range, int pitch, uint16_t* out,
                                   void* stream) {
  if (s < 2 || pitch % 2 != 0 || pitch < s + 4 || src_pitch < s)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)((pitch / 2 + threads - 1) / threads), (unsigned)(s + 4));
  window_lut_q_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      src, (long long)src_pitch, s, y_range, pitch, reinterpret_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
