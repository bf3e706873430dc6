// K1 raster_tiles — the tiled depth rasterizer of both passes.
//
// Replaces arctic_tpu/ops/raster_tiles.py:_raster_kernel (camera and
// depth-only shadow variants) and, folded into its row load,
// _pack16_kernel + _phase_resolve_kernel, which only re-packed
// table16[sorted_slot] into 128-lane rows for the TPU's DMA.
//
// Function: each pixel of a tile walks the tile's pair segment
// [tile_start[t], tile_start[t+1]) in list order with the strict
// `z < zbuf`, from zbuf = 1.0 and ibuf = -1. The list is slot-ascending, so
// a depth tie keeps the first slot. A pair's 12 raster floats (A, B, C of
// three edges, then Az, Bz, Cz) sit at row sorted_slot[k] of a row table:
// lanes 112:124 of the 128-lane shade-row table for the camera pass, lanes
// 0:12 of the 16-float raster-row table for the shadow pass.
//
// Design. One block of kThreads = 128 threads per sub-tile of kBlockPixels
// = 256 pixels, two pixels a thread. The sub-tile is a power-of-two
// rectangle, bw x bh, and each tile is covered by ceil(th / bh) x ceil(tw /
// bw) of them: the fewest that cover it, the squarest of those (16 x 16 in
// a 64 x 64 tile; ops/raster_tiles.block_layout chooses, the launcher gets
// log2 bw). Each block walks its tile's whole list in chunks of 128 pairs,
// one pair a thread. The thread loads its pair's row (three 16-byte loads
// where the table's alignment allows) and tests it against the sub-tile's
// pixel rectangle. The survivors are compacted in list order (warp ballots
// plus a prefix over the 4 warps) into shared memory. The sub-tile's pixels
// fall into 8 rectangles of 32 (8 x 4 in a 16 x 16 sub-tile; also a power-
// of-two rectangle, chosen the same way), and warp w owns rectangles w and
// w + 4, one pixel of each per lane. The warp tests the survivors again, 32
// at a time, against each of its rectangles, and evaluates at a rectangle's
// pixels only those that pass there, two at a time, in list order. A dense
// tile's list is thereby spread over its sub-tiles' blocks, and each warp
// evaluates only the pairs that can reach it. The list order, and with it
// the tie rule, holds inside every block with no atomics, so the result is
// deterministic. A tile with no pairs only writes its clear values.
// 16 x 16 sub-tiles of 128 threads were faster than 32 x 32 ones, and had
// the lowest sum over both passes of the 128- and 256-thread blocks tried
// (PERF.md).
//
// Any tile shape. Where the sub-tiles tile the tile exactly (every tile of
// a multiple of 256 pixels with power-of-two factors to spare, 64 x 64 among
// them), the kernel is instantiated with kClip = false and is the code it
// always was. Otherwise (kClip) the sub-tiles on a tile's right and bottom
// edges hang over it: the block's and each warp rectangle's cull rectangle
// is clipped to the tile's pixels, so its corners are pixels of the tile
// and the argument below holds word for word, and a pixel outside the tile
// accepts nothing and is not stored. A 128-pixel tile (8 x 16, 1 x 128)
// leaves half of its block idle; a rectangle wholly outside the tile passes
// no pair.
//
// Why the cull is exact. Built with -fmad=false, an edge value is
// e = fl(fl(fl(A*px) + fl(B*py)) + C). Round-to-nearest is monotone, and
// so is overflow to +-inf. For px > 0, fl(A*px) is non-decreasing in px when
// A > 0, non-increasing when A < 0, and constant when A is +-0 or +-inf. The
// same holds for py and B, and for adding a constant. So over a rectangle of
// pixel centres [x_lo, x_hi] x [y_lo, y_hi], no pixel's e exceeds e at the
// corner px* = (A > 0 ? x_hi : x_lo), py* = (B > 0 ? y_hi : y_lo); or else
// the pixel's e is NaN (inf - inf), which its own test rejects. That corner
// is itself a pixel of the rectangle, evaluated with the same expression. A
// pair is rejected for the sub-tile (or a warp's rectangle) iff
//   - e_j at its corner is < 0 for one of the three edges, or
//   - z at its max corner is < 0, or
//   - z at its min corner (the opposite signs) is >= 1.0: zbuf starts at
//     1.0 and only decreases, so no z >= 1 is ever accepted.
// Each of these implies that no pixel of the rectangle accepts the pair. A
// NaN makes its comparison false, so it never rejects; the per-pixel test
// then rejects the pair as before. Pixel centres x + 0.5 are exact in f32
// for every coordinate below 2^23. Do not reassociate (A*px + B*py) + C, and
// keep -fmad=false (utils/kernels.NVCC_FLAGS): the argument, and the
// bit-exactness against the plain version, rest on both.
// ops/raster_tiles.block_rejects states the same test in torch.
//
// Bound on the H100: bytes — the depth (and slot) buffer written once, the
// pair list and the distinct rows read once; the operations any exact
// raster needs are 22 per covered (pair, pixel), far fewer. What the design
// pays beyond that: each block loads its tile's rows (mostly from L2) and
// tests each against its sub-tile, about 30 f32 operations, and each warp
// tests the survivors against its rectangles; a warp whose rectangle holds
// a cluster of tiny triangles evaluates them one pair (two with the unroll)
// after another, which sets the camera pass's tail.
//
// A slab of a sharded frame (parallel/sharding.py) starts at pixel row
// row0 (the JAX kernel's tile_row0, raster_tiles.py:424): row0 is added as
// an integer to the rows the arithmetic sees (the block's rectangle and
// its pixel centres, so the values are the whole frame's), and the stores
// keep slab-local rows. row0 = 0 is the unsharded frame.
//
// The per-pixel accept is raster_tiles.py:479-496's: accept iff all three
// edges and z are >= 0 and z < zbuf. The comparisons are written out (not
// fminf/fmaxf, which drop NaNs) so a NaN plane rejects, as jnp.minimum
// propagates it there.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPixelsPerThread = 2;
constexpr int kLog2BlockPixels = 8;
constexpr int kBlockPixels = 1 << kLog2BlockPixels;
static_assert(kThreads * kPixelsPerThread == kBlockPixels, "one pixel per thread per rectangle");
constexpr int kChunk = kThreads;  // pairs tested per step, one a thread
constexpr int kComps = 12;        // A,B,C x 3 edges, Az,Bz,Cz
constexpr int kUnroll = 2;        // survivors evaluated together

struct Rect {
  float x_lo, x_hi, y_lo, y_hi;  // pixel centres
};

__device__ __forceinline__ Rect pixel_rect(int x0, int y0, int w, int h) {
  return Rect{(float)x0 + 0.5f, (float)(x0 + w - 1) + 0.5f, (float)y0 + 0.5f,
              (float)(y0 + h - 1) + 0.5f};
}

// The plane's largest value over the rectangle is < 0.
__device__ __forceinline__ bool below_zero(float a, float b, float c, const Rect& r) {
  const float x = a > 0.0f ? r.x_hi : r.x_lo;
  const float y = b > 0.0f ? r.y_hi : r.y_lo;
  return a * x + b * y + c < 0.0f;
}

// The plane's smallest value over the rectangle is >= 1.
__device__ __forceinline__ bool at_least_one(float a, float b, float c, const Rect& r) {
  const float x = a > 0.0f ? r.x_lo : r.x_hi;
  const float y = b > 0.0f ? r.y_lo : r.y_hi;
  return a * x + b * y + c >= 1.0f;
}

__device__ __forceinline__ bool rejects(const float (&v)[kComps], const Rect& r) {
  return below_zero(v[0], v[1], v[2], r) || below_zero(v[3], v[4], v[5], r) ||
         below_zero(v[6], v[7], v[8], r) || below_zero(v[9], v[10], v[11], r) ||
         at_least_one(v[9], v[10], v[11], r);
}

__device__ __forceinline__ void unpack(const float4 (&q)[kComps / 4], float (&v)[kComps]) {
#pragma unroll
  for (int j = 0; j < kComps / 4; ++j) {
    v[4 * j] = q[j].x;
    v[4 * j + 1] = q[j].y;
    v[4 * j + 2] = q[j].z;
    v[4 * j + 3] = q[j].w;
  }
}

template <bool kWriteIbuf, bool kClip>
__global__ void __launch_bounds__(kThreads) raster_tiles_kernel(
    const float* __restrict__ rows, int row_stride, int lane0, bool vec_rows,
    const int* __restrict__ sorted_slot, const int* __restrict__ tile_start,
    int tiles_x, int tile_h, int tile_w, int block_w_log2, int rect_w_log2, int out_w,
    int row0, float* __restrict__ zbuf, int* __restrict__ ibuf) {
  __shared__ float4 s_row[kChunk][kComps / 4];
  __shared__ int s_slot[kChunk];
  __shared__ int s_count[kWarps];

  const int block_w = 1 << block_w_log2;
  const int block_h = kBlockPixels >> block_w_log2;
  // kClip: the edge sub-tiles hang over the tile.
  const int blocks_x = kClip ? (tile_w + block_w - 1) >> block_w_log2 : tile_w >> block_w_log2;
  const int blocks_y = kClip ? (tile_h + block_h - 1) / block_h : tile_h / block_h;
  const int per_tile = blocks_x * blocks_y;
  const int t = blockIdx.x / per_tile;
  const int b = blockIdx.x - t * per_tile;
  const int x0 = (t % tiles_x) * tile_w + (b % blocks_x) * block_w;
  // Global pixel rows: the rectangles and pixel centres see the frame's rows.
  const int y0 = row0 + (t / tiles_x) * tile_h + (b / blocks_x) * block_h;
  // One past the tile's last pixel column and row (kClip only).
  const int x_end = (t % tiles_x + 1) * tile_w;
  const int y_end = row0 + (t / tiles_x + 1) * tile_h;
  const int begin = tile_start[t];
  const int end = tile_start[t + 1];

  // The block's pixels fall into kWarps * kPixelsPerThread rectangles of 32
  // (rect_w x rect_h, row-major in the block); thread (warp, lane) owns lane
  // l's pixel (row-major) of rectangles warp + kWarps * i. With kClip a
  // rectangle is cut to its cw x ch pixels inside the tile (none: 0 wide).
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rect_w = 1 << rect_w_log2;
  const int rect_h = 32 >> rect_w_log2;
  const int rects_x = block_w >> rect_w_log2;
  int rx[kPixelsPerThread], ry[kPixelsPerThread], cw[kPixelsPerThread], ch[kPixelsPerThread];
  float px[kPixelsPerThread], py[kPixelsPerThread], z[kPixelsPerThread];
  int id[kPixelsPerThread];
  bool inside[kPixelsPerThread];
#pragma unroll
  for (int i = 0; i < kPixelsPerThread; ++i) {
    const int r = warp + kWarps * i;
    rx[i] = x0 + (r % rects_x) * rect_w;
    ry[i] = y0 + (r / rects_x) * rect_h;
    px[i] = (float)(rx[i] + (lane & (rect_w - 1))) + 0.5f;
    py[i] = (float)(ry[i] + (lane >> rect_w_log2)) + 0.5f;
    z[i] = 1.0f;
    id[i] = -1;
    if (kClip) {
      cw[i] = max(min(rect_w, x_end - rx[i]), 0);
      ch[i] = max(min(rect_h, y_end - ry[i]), 0);
      cw[i] = ch[i] > 0 ? cw[i] : 0;
      inside[i] = (lane & (rect_w - 1)) < cw[i] && (lane >> rect_w_log2) < ch[i];
    } else {
      cw[i] = rect_w;
      ch[i] = rect_h;
      inside[i] = true;
    }
  }

  if (begin < end) {
    const Rect block_rect =
        kClip ? pixel_rect(x0, y0, min(block_w, x_end - x0), min(block_h, y_end - y0))
              : pixel_rect(x0, y0, block_w, block_h);
    for (int c0 = begin; c0 < end; c0 += kChunk) {
      const int k = c0 + threadIdx.x;
      float v[kComps];
      int s = 0;
      bool keep = false;
      if (k < end) {
        s = sorted_slot[k];
        const float* r = rows + (size_t)s * row_stride + lane0;
        if (vec_rows) {
          float4 q[kComps / 4];
#pragma unroll
          for (int j = 0; j < kComps / 4; ++j) q[j] = reinterpret_cast<const float4*>(r)[j];
          unpack(q, v);
        } else {
#pragma unroll
          for (int j = 0; j < kComps; ++j) v[j] = r[j];
        }
        keep = !rejects(v, block_rect);
      }
      // Stable compaction: survivor rank = survivors in earlier warps +
      // survivors in earlier lanes of this warp.
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      __syncthreads();  // the previous chunk's survivors are consumed
      if (lane == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int pos = __popc(ballot & ((1u << lane) - 1u));
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_count[w];
        pos += w < warp ? c : 0;
        total += c;
      }
      if (keep) {
#pragma unroll
        for (int j = 0; j < kComps / 4; ++j)
          s_row[pos][j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        s_slot[pos] = s;
      }
      __syncthreads();
      for (int g = 0; g < total; g += 32) {
        bool hit[kPixelsPerThread];
        if (g + lane < total) {
          unpack(s_row[g + lane], v);
#pragma unroll
          for (int i = 0; i < kPixelsPerThread; ++i)
            hit[i] = (!kClip || cw[i] > 0) && !rejects(v, pixel_rect(rx[i], ry[i], cw[i], ch[i]));
        } else {
#pragma unroll
          for (int i = 0; i < kPixelsPerThread; ++i) hit[i] = false;
        }
#pragma unroll
        for (int i = 0; i < kPixelsPerThread; ++i) {
          // The survivors that pass rectangle i, kUnroll at a time: their
          // planes are independent, the accepts run in list order.
          unsigned mask = __ballot_sync(0xffffffffu, hit[i]);
          while (mask != 0) {
            int j[kUnroll];
            bool live[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              live[u] = mask != 0;
              j[u] = live[u] ? g + __ffs(mask) - 1 : g;
              mask &= mask - 1;
            }
            float e0[kUnroll], e1[kUnroll], e2[kUnroll], zz[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              // (A0 B0 C0 A1) (B1 C1 A2 B2) (C2 Az Bz Cz)
              const float4 ra = s_row[j[u]][0];
              const float4 rb = s_row[j[u]][1];
              const float4 rc = s_row[j[u]][2];
              e0[u] = ra.x * px[i] + ra.y * py[i] + ra.z;
              e1[u] = ra.w * px[i] + rb.x * py[i] + rb.y;
              e2[u] = rb.z * px[i] + rb.w * py[i] + rc.x;
              zz[u] = rc.y * px[i] + rc.z * py[i] + rc.w;
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (live[u] && inside[i] && e0[u] >= 0.0f && e1[u] >= 0.0f && e2[u] >= 0.0f &&
                  zz[u] >= 0.0f && zz[u] < z[i]) {
                z[i] = zz[u];
                if (kWriteIbuf) id[i] = s_slot[j[u]];
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPixelsPerThread; ++i) {
    if (!inside[i]) continue;
    // Slab-local rows in the buffers.
    const size_t o =
        (size_t)(ry[i] - row0 + (lane >> rect_w_log2)) * out_w + rx[i] + (lane & (rect_w - 1));
    zbuf[o] = z[i];
    if (kWriteIbuf) ibuf[o] = id[i];
  }
}

template <bool kWriteIbuf, bool kClip>
void launch(unsigned blocks, cudaStream_t s, const float* rows, int row_stride, int lane0,
            bool vec_rows, const int* sorted_slot, const int* tile_start, int tiles_x,
            int tile_h, int tile_w, int block_w_log2, int rect_w_log2, int out_w, int row0,
            float* zbuf, int* ibuf) {
  raster_tiles_kernel<kWriteIbuf, kClip><<<blocks, kThreads, 0, s>>>(
      rows, row_stride, lane0, vec_rows, sorted_slot, tile_start, tiles_x, tile_h, tile_w,
      block_w_log2, rect_w_log2, out_w, row0, zbuf, ibuf);
}

}  // namespace

// rows: (P, row_stride) f32 row table; the 12 raster comps at [lane0, lane0+12).
// sorted_slot: the binned pair list; tile_start: (num_tiles + 1,) offsets.
// zbuf / ibuf: (tiles_y * tile_h, out_w) row-major; ibuf may be null (depth only).
// block_w_log2 / rect_w_log2: log2 of the sub-tile's width (of 256 pixels)
// and of its warp rectangles' (of 32 pixels), which must fit in it.
// row0: the global pixel row of the buffers' first row (0: the whole frame).
extern "C" int arctic_raster_tiles(
    const float* rows, int row_stride, int lane0, const int* sorted_slot,
    const int* tile_start, int num_tiles, int tiles_x, int tile_h, int tile_w,
    int block_w_log2, int rect_w_log2, int out_w, int row0, float* zbuf, int* ibuf,
    void* stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (tile_h <= 0 || tile_w <= 0 || block_w_log2 < 0 || block_w_log2 > kLog2BlockPixels ||
      rect_w_log2 < 0 || rect_w_log2 > 5 || rect_w_log2 > block_w_log2 ||
      5 - rect_w_log2 > kLog2BlockPixels - block_w_log2)
    return (int)cudaErrorInvalidValue;
  const int block_w = 1 << block_w_log2;
  const int block_h = kBlockPixels >> block_w_log2;
  const bool clip = tile_w % block_w != 0 || tile_h % block_h != 0;
  const long long per_tile =
      (long long)((tile_w + block_w - 1) / block_w) * ((tile_h + block_h - 1) / block_h);
  const long long blocks = (long long)num_tiles * per_tile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // gridDim.x's limit
  const bool vec_rows =
      reinterpret_cast<uintptr_t>(rows) % 16 == 0 && row_stride % 4 == 0 && lane0 % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  using Launch = decltype(&launch<true, true>);
  const Launch go = ibuf != nullptr ? (clip ? &launch<true, true> : &launch<true, false>)
                                    : (clip ? &launch<false, true> : &launch<false, false>);
  go((unsigned)blocks, s, rows, row_stride, lane0, vec_rows, sorted_slot, tile_start, tiles_x,
     tile_h, tile_w, block_w_log2, rect_w_log2, out_w, row0, zbuf, ibuf);
  return (int)cudaGetLastError();
}

extern "C" const char* arctic_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
