// K8 pcf_eval — the 25-tap PCF count of every pixel of the compacted
// penumbra rows, over its 4x4 window of the quantised table (K7).
//
// Replaces arctic_tpu/ops/shadow.py:_pcf_eval_kernel, with the six row
// gathers in front of it (shadow.py:947-951): a thread reads its pixel's
// start_y, start_x, z, lx and ly from the (R, 128) planes itself, at row
// order[i]. The TPU kernel selected the window from a gathered 128-lane
// block row through a select tree; here the 16 texels are read from the
// padded map (K7's table, rows start_y .. start_y + 3, columns start_x ..
// start_x + 3), widened (exact) and dequantised as q * DQ with DQ the f32
// jnp.float32(1.0 / 65535.0) (hex literal below). The taps follow
// shadow.py:727-745 in expression order: y offsets outer, x inner,
// sy = ly + off[j] with off[] the five f32 offsets from the host (the f32 of
// the double j * step), exact 3-way row / column selects on floor(sy) and
// floor(sx), lerps top = c00 + (c10 - c00) * fx, bot likewise, closest =
// top + (bot - top) * fy, each multiply and add rounded separately
// (-fmad=false). The raw count leaves the kernel; the /25 is done outside,
// as in the JAX package. Rows i >= rows_used[0] are written as 0.
//
// One block of 128 threads per listed row (one thread per pixel). Bound on
// the H100: bytes — 20 B of planes read and 4 B written per pixel
// (coalesced), the 16 texel reads mostly L2 hits (neighbouring pixels share
// windows); about 360 f32 operations a pixel are far below the card's rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;
constexpr float kDq = 0x1.0001p-16f;  // == jnp.float32(1.0 / 65535.0)

struct Offsets {
  float v[5];
};

__device__ __forceinline__ float sel3(int i, float a, float b, float c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

__global__ void pcf_eval_kernel(const uint16_t* __restrict__ lut, int pitch,
                                const int* __restrict__ order,
                                const int* __restrict__ rows_used,
                                const int* __restrict__ start_y,
                                const int* __restrict__ start_x,
                                const float* __restrict__ zp,
                                const float* __restrict__ lxp,
                                const float* __restrict__ lyp, Offsets off,
                                float* __restrict__ out) {
  const int i = blockIdx.x;
  const int l = threadIdx.x;
  const long long o = (long long)i * kRow + l;
  if (i >= rows_used[0]) {
    out[o] = 0.0f;
    return;
  }
  const long long p = (long long)order[i] * kRow + l;
  const int y0 = start_y[p], x0 = start_x[p];
  const float z = zp[p], lx = lxp[p], ly = lyp[p];
  float w[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint16_t* row = lut + (long long)(y0 + r) * pitch + x0;
#pragma unroll
    for (int c = 0; c < 4; ++c) w[r][c] = __fmul_rn((float)row[c], kDq);
  }
  float count = 0.0f;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float sy = __fadd_rn(ly, off.v[j]);
    const int iy = (int)floorf(sy);
    const float fy = __fsub_rn(sy, (float)iy);
    float row0[4], row1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      row0[c] = sel3(iy, w[0][c], w[1][c], w[2][c]);
      row1[c] = sel3(iy, w[1][c], w[2][c], w[3][c]);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float sx = __fadd_rn(lx, off.v[k]);
      const int ix = (int)floorf(sx);
      const float fx = __fsub_rn(sx, (float)ix);
      const float c00 = sel3(ix, row0[0], row0[1], row0[2]);
      const float c10 = sel3(ix, row0[1], row0[2], row0[3]);
      const float c01 = sel3(ix, row1[0], row1[1], row1[2]);
      const float c11 = sel3(ix, row1[1], row1[2], row1[3]);
      const float top = __fadd_rn(c00, __fmul_rn(__fsub_rn(c10, c00), fx));
      const float bot = __fadd_rn(c01, __fmul_rn(__fsub_rn(c11, c01), fx));
      const float closest = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), fy));
      count = __fadd_rn(count, z > closest ? 1.0f : 0.0f);
    }
  }
  out[o] = count;
}

}  // namespace

// lut (S + 4, pitch) u16; order (n,) i32 rows of the (R, 128) planes
// start_y / start_x (i32, in [0, S]) and z / lx / ly (f32); rows_used (1,)
// i32 on the device; off0..off4 the tap offsets; out (n, 128) f32.
extern "C" int arctic_pcf_eval(const uint16_t* lut, int pitch, const int* order,
                               const int* rows_used, int n, const int* start_y,
                               const int* start_x, const float* z, const float* lx,
                               const float* ly, float off0, float off1, float off2,
                               float off3, float off4, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Offsets off = {{off0, off1, off2, off3, off4}};
  pcf_eval_kernel<<<(unsigned)n, kRow, 0, (cudaStream_t)stream>>>(
      lut, pitch, order, rows_used, start_y, start_x, z, lx, ly, off, out);
  return (int)cudaGetLastError();
}
