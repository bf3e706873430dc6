// K4 select_interp — the per-pixel G-buffer resolve of the camera pass.
//
// Replaces arctic_tpu/ops/raster_tiles.py:_select_kernel. The TPU kernel
// re-streamed each tile's pair rows and picked every pixel's winning row
// with an exact one-hot matmul (a bf16x3 split on the MXU), because per-
// pixel gathers were slow there. On Hopper a pixel simply reads row
// ibuf[p] of the shade-row table, which is exact by construction.
//
// One thread per pixel of the (H_pad, W_pad) frame: bw_c = (A_c*px +
// B_c*py) + C_c from row lanes [3c, 3c+3), den = bw0 + bw1 + bw2 (0 -> 1),
// b_c = bw_c / den; G-buffer lanes [0:24) = (b0*a0 + b1*a1) + b2*a2 over row
// lanes 16:40 / 40:64 / 64:88, lanes [24:48) copy row lanes 88:112, lanes
// [48:64) are zero. Uncovered pixels (ibuf < 0) get all-zero lanes, which is
// what the one-hot product gave them.
//
// Bound on the H100: bytes — one 512 B row read (mostly L2 hits: neighbour
// pixels share rows) and 64 x 4 B written per pixel; writes are coalesced
// per G-buffer plane, row reads are not. Built with -fmad=false so the
// values equal the plain torch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 64;

__global__ void select_interp_kernel(const float* __restrict__ rows,
                                     const int* __restrict__ ibuf, int height,
                                     int width, float* __restrict__ gbuf) {
  const long long hw = (long long)height * width;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int slot = ibuf[p];
  if (slot < 0) {
    for (int j = 0; j < kLanes; ++j) gbuf[j * hw + p] = 0.0f;
    return;
  }
  const float* r = rows + (size_t)slot * 128;
  const float px = (float)(int)(p % width) + 0.5f;
  const float py = (float)(int)(p / width) + 0.5f;
  const float bw0 = r[0] * px + r[1] * py + r[2];
  const float bw1 = r[3] * px + r[4] * py + r[5];
  const float bw2 = r[6] * px + r[7] * py + r[8];
  float den = bw0 + bw1 + bw2;
  if (den == 0.0f) den = 1.0f;
  const float b0 = bw0 / den, b1 = bw1 / den, b2 = bw2 / den;
  for (int j = 0; j < 24; ++j)
    gbuf[j * hw + p] = b0 * r[16 + j] + b1 * r[40 + j] + b2 * r[64 + j];
  for (int j = 0; j < 24; ++j) gbuf[(24 + j) * hw + p] = r[88 + j];
  for (int j = 48; j < kLanes; ++j) gbuf[j * hw + p] = 0.0f;
}

}  // namespace

// rows (N, 128) f32 shade rows; ibuf (height, width) i32; gbuf (64, height, width) f32.
extern "C" int arctic_select_interp(const float* rows, const int* ibuf,
                                    int height, int width, float* gbuf,
                                    void* stream) {
  const long long hw = (long long)height * width;
  if (hw <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((hw + threads - 1) / threads);
  select_interp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(rows, ibuf, height, width, gbuf);
  return (int)cudaGetLastError();
}
