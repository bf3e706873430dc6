// K1 raster_tiles — the tiled depth rasterizer of both passes.
//
// Replaces arctic_tpu/ops/raster_tiles.py:_raster_kernel (camera and
// depth-only shadow variants) and, folded into its row load,
// _pack16_kernel + _phase_resolve_kernel, which only re-packed
// table16[sorted_slot] into 128-lane rows for the TPU's DMA.
//
// One thread block per screen tile; each thread owns up to 16 pixels of the
// tile (row-major within the tile). The block walks the tile's pair segment
// [tile_start[t], tile_start[t+1]) in list order — slot-ascending, so the
// strict `z < zbuf` keeps the first slot on a depth tie with no atomics —
// staging each chunk's raster rows (12 floats fetched at row sorted_slot[k]
// of a row table: lanes 112:124 of the 128-lane shade-row table for the
// camera pass, lanes 0:12 of the 16-float raster-row table for the shadow
// pass) in shared memory.
//
// Bound on the H100: per pair, 2 loads of 12 floats and 16 pixels x ~20 FP32
// ops per thread — compute and the per-chunk barrier, not bytes (tiles are
// independent, so 132 SMs run them in parallel; a dense tile's list is
// walked serially by its one block). The simple design keeps the pair loop
// serial per block for exact draw-order ties; load balancing of dense tiles
// is later work.
//
// Arithmetic matches raster_tiles.py:479-496 exactly when built with
// -fmad=false: e = (A*px + B*py) + C and the same for z; accept iff all
// three edges and z are >= 0 and z < zbuf. The comparisons are written out
// (not fminf/fmaxf, which drop NaNs) so a NaN plane rejects, as jnp.minimum
// propagates it there.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPixelsPerThread = 16;  // tiles of up to 4096 pixels
constexpr int kChunk = kThreads;         // pairs staged per chunk
constexpr int kComps = 12;               // A,B,C x 3 edges, Az,Bz,Cz

template <bool kWriteIbuf>
__global__ void __launch_bounds__(kThreads) raster_tiles_kernel(
    const float* __restrict__ rows, int row_stride, int lane0,
    const int* __restrict__ sorted_slot, const int* __restrict__ tile_start,
    int tiles_x, int tile_h, int tile_w, int out_w,
    float* __restrict__ zbuf, int* __restrict__ ibuf) {
  __shared__ float s_row[kChunk][kComps];
  __shared__ int s_slot[kChunk];

  const int t = blockIdx.x;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int npix = tile_h * tile_w;
  const int ppt = npix / kThreads;
  const int begin = tile_start[t];
  const int end = tile_start[t + 1];

  float px[kMaxPixelsPerThread], py[kMaxPixelsPerThread];
  float z[kMaxPixelsPerThread];
  int id[kMaxPixelsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPixelsPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    px[i] = (float)(tx * tile_w + p % tile_w) + 0.5f;
    py[i] = (float)(ty * tile_h + p / tile_w) + 0.5f;
    z[i] = 1.0f;
    id[i] = -1;
  }

  for (int c0 = begin; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    __syncthreads();  // the previous chunk is fully consumed
    if (threadIdx.x < n) {
      const int s = sorted_slot[c0 + threadIdx.x];
      const float* r = rows + (size_t)s * row_stride + lane0;
      s_slot[threadIdx.x] = s;
#pragma unroll
      for (int j = 0; j < kComps; ++j) s_row[threadIdx.x][j] = r[j];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* r = s_row[k];
#pragma unroll
      for (int i = 0; i < kMaxPixelsPerThread; ++i) {
        if (i < ppt) {
          const float e0 = r[0] * px[i] + r[1] * py[i] + r[2];
          const float e1 = r[3] * px[i] + r[4] * py[i] + r[5];
          const float e2 = r[6] * px[i] + r[7] * py[i] + r[8];
          const float zz = r[9] * px[i] + r[10] * py[i] + r[11];
          if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && zz >= 0.0f && zz < z[i]) {
            z[i] = zz;
            if (kWriteIbuf) id[i] = s_slot[k];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxPixelsPerThread; ++i) {
    if (i < ppt) {
      const int p = threadIdx.x + i * kThreads;
      const size_t o = (size_t)(ty * tile_h + p / tile_w) * out_w + tx * tile_w + p % tile_w;
      zbuf[o] = z[i];
      if (kWriteIbuf) ibuf[o] = id[i];
    }
  }
}

}  // namespace

// rows: (P, row_stride) f32 row table; the 12 raster comps at [lane0, lane0+12).
// sorted_slot: the binned pair list; tile_start: (num_tiles + 1,) offsets.
// zbuf / ibuf: (tiles_y * tile_h, out_w) row-major; ibuf may be null (depth only).
extern "C" int arctic_raster_tiles(
    const float* rows, int row_stride, int lane0, const int* sorted_slot,
    const int* tile_start, int num_tiles, int tiles_x, int tile_h, int tile_w,
    int out_w, float* zbuf, int* ibuf, void* stream) {
  const int npix = tile_h * tile_w;
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (npix % kThreads != 0 || npix > kThreads * kMaxPixelsPerThread)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ibuf != nullptr) {
    raster_tiles_kernel<true><<<num_tiles, kThreads, 0, s>>>(
        rows, row_stride, lane0, sorted_slot, tile_start, tiles_x, tile_h,
        tile_w, out_w, zbuf, ibuf);
  } else {
    raster_tiles_kernel<false><<<num_tiles, kThreads, 0, s>>>(
        rows, row_stride, lane0, sorted_slot, tile_start, tiles_x, tile_h,
        tile_w, out_w, zbuf, ibuf);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* arctic_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
