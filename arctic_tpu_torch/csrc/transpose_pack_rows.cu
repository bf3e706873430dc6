// K10 transpose_pack_rows — the (128, N) component-major shade-row stack
// to the (N, 128) row table.
//
// Replaces arctic_tpu/ops/raster_tiles.py:_transpose_pack_kernel, the last
// step of the full-stack shade-row build (pipeline.build_shade_rows for a
// Geometry without slot_static_rows): the 128 lanes are stacked as planes
// along the slot dim, and the table K1 and K4 read is slot-major. The TPU
// kernel swapped a (128, 512) block in registers; here a block of 32 x 8
// threads moves one 32 x 32 tile through shared memory, padded by one
// column so that the transposed reads hit 32 different banks. Loads and
// stores are both coalesced: a warp reads 32 consecutive slots of one lane
// and writes 32 consecutive lanes of one slot (128 B each).
//
// Bound on the H100: bytes — every value is read once and written once
// (2 x 128 x N x 4 B); there is no arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTile = 32;
constexpr int kStep = 8;  // thread rows per block; each moves kTile / kStep values

__global__ void transpose_pack_rows_kernel(const float* __restrict__ in, int n,
                                           float* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];
  const int slot0 = blockIdx.x * kTile;
  const int lane0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
#pragma unroll
  for (int r = threadIdx.y; r < kTile; r += kStep) {
    const int slot = slot0 + tx;
    if (slot < n) tile[r][tx] = in[(long long)(lane0 + r) * n + slot];
  }
  __syncthreads();
#pragma unroll
  for (int r = threadIdx.y; r < kTile; r += kStep) {
    const int slot = slot0 + r;
    if (slot < n) out[(long long)slot * kLanes + lane0 + tx] = tile[tx][r];
  }
}

}  // namespace

// in (128, n) f32; out (n, 128) f32.
extern "C" int arctic_transpose_pack_rows(const float* in, int n, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 block(kTile, kStep);
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), kLanes / kTile);
  transpose_pack_rows_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(in, n, out);
  return (int)cudaGetLastError();
}
