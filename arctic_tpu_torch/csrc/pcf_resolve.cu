// K13 pcf_resolve — the 16 dequantised texels of each pixel's 4x4 PCF
// window, as (16, P) f32 planes.
//
// Replaces arctic_tpu/ops/shadow.py:_pcf_resolve_kernel, which took a
// gathered 128-lane row of the blocked u16 table per pixel and picked the
// window out of it through a 24-way select over a per-pixel candidate
// (64 k2 + 4 yoff) and the x offset, with an in-register transpose. The
// JAX package later fused the resolve into the tap loop (_pcf_eval_kernel,
// here K8), and nothing calls this resolve; it is kept for the 16-plane
// interface. Here the table is K7's padded u16 map, so a thread reads its
// pixel's rows start_y .. start_y + 3, columns start_x .. start_x + 3
// directly, widens each u16 (exact) and multiplies by DQ, the f32
// jnp.float32(1.0 / 65535.0) (hex literal below). Plane 4r + c holds window
// row r, column c.
//
// One thread per pixel. Bound on the H100: bytes — 8 B of window origins
// read and 64 B of planes written per pixel (coalesced: plane-major output,
// consecutive pixels in consecutive threads), the 16 texel reads mostly L2
// hits (neighbouring pixels share windows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kDq = 0x1.0001p-16f;  // == jnp.float32(1.0 / 65535.0)

__global__ void pcf_resolve_kernel(const uint16_t* __restrict__ lut, int pitch,
                                   const int* __restrict__ start_y,
                                   const int* __restrict__ start_x, int n,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y0 = start_y[i], x0 = start_x[i];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint16_t* row = lut + (long long)(y0 + r) * pitch + x0;
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(long long)(4 * r + c) * n + i] = __fmul_rn((float)row[c], kDq);
  }
}

}  // namespace

// lut (S + 4, pitch) u16; start_y / start_x (n,) i32 in [0, S]; out (16, n) f32.
extern "C" int arctic_pcf_resolve(const uint16_t* lut, int pitch, const int* start_y,
                                  const int* start_x, int n, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  pcf_resolve_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                       (cudaStream_t)stream>>>(lut, pitch, start_y, start_x, n, out);
  return (int)cudaGetLastError();
}
