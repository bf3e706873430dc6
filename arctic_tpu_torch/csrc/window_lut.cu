// K12 window_lut — the wrap-padded f32 shadow map that the f32 window-table
// PCF route (pcf_shadow_proj(use_lut=True, quant=False)) reads its 4x4
// windows from.
//
// Replaces arctic_tpu/ops/shadow.py:_lut_kernel. The TPU kernel scattered
// the padded map into stride-4-aligned 8x8 texel blocks, two per 128-lane
// row, through one-hot MXU matmuls with a three-way bf16 split, because a
// TPU gather costs by table size and row count. On Hopper a pixel reads its
// window straight from the padded map, so the table is that map: row y,
// column x holds texel ((y - 2) mod S, (x - 2) mod S) of the source, copied
// exactly; columns past S + 4 up to the 128-byte-aligned pitch hold 0.
//
// One thread per output texel, one grid row per table row. Bound on the
// H100: bytes — the (S, S) source read once (4 B a texel, coalesced; the
// source keeps its own row pitch, e.g. the raster's padded depth buffer)
// and the table written once (4 B a texel); no arithmetic.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap2(int v, int s) {
  int w = v - 2;
  if (w < 0) w += s;
  else if (w >= s) w -= s;
  return w;
}

__global__ void window_lut_kernel(const float* __restrict__ src, long long src_pitch, int s,
                                  int pitch, float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= pitch) return;
  const int y = blockIdx.y;
  float v = 0.0f;
  if (x < s + 4) v = src[(long long)wrap2(y, s) * src_pitch + wrap2(x, s)];
  out[(long long)y * pitch + x] = v;
}

}  // namespace

// src: f32 map, row pitch src_pitch floats, (s, s) used; out (s + 4, pitch)
// f32, pitch >= s + 4.
extern "C" int arctic_window_lut(const float* src, int src_pitch, int s, int pitch, float* out,
                                 void* stream) {
  if (s < 2 || pitch < s + 4 || src_pitch < s) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)((pitch + threads - 1) / threads), (unsigned)(s + 4));
  window_lut_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      src, (long long)src_pitch, s, pitch, out);
  return (int)cudaGetLastError();
}
