// K16 pcf_runs — the exact f32 runs PCF in one launch: per pixel, the
// light-space NDC (x, y, z) to the map's UV, the outside-the-frustum mask,
// the 4x4 texel window of the (S, S) f32 shadow map around the centre tap,
// wrapped by index, and the 25 bilinear taps counted against z -> the
// (H, W) f32 shadow fraction (0 outside the light frustum).
//
// Replaces no TPU kernel: the JAX package writes this path as jnp
// arithmetic (arctic_tpu/ops/shadow.py:1012-1074, pcf_shadow_proj with
// use_lut=False, reached on every backend but the TPU) that XLA fuses under
// jax.jit. The port ran it as plain torch, about 1,090 launches over
// full-frame planes a call (64 index ops, 16 wrapped gathers, 25 taps of
// nested selects and lerps). Its plain version is ops/shadow.py
// pcf_runs_plain.
//
// Bit-exact against the plain version on the card: each operation is the
// one torch's CUDA kernel computes, in the same order, rounded once, with
// no fused multiply-add (built with -fmad=false):
//   - u = x * 0.5 + 0.5, v = 1 - (y * 0.5 + 0.5), t = uv * S - 0.5;
//   - floor, then torch's float -> int32 cast, which is C++'s static_cast
//     compiled by nvcc: cvt.rzi.s32.f32, saturating, NaN -> 0
//     (__float2int_rz); int32 sums wrap, as the card's integer adds do;
//   - lx = tx - float(wx); the window's rows and columns are
//     (start + r - 2) mod S, non-negative, for start = clamp(w + 2, 0, S);
//   - the taps in _tap_count's order (y offset outer, x inner, the offsets
//     passed in as floats), each filtered depth c00 + (c10 - c00) * fx,
//     then bot, then closest = top + (bot - top) * fy, counted where
//     z > closest;
//   - count / 25.0 is torch's multiplication by the float32 reciprocal
//     (a CUDA division by a Python float), then 0 where outside.
// The taps share their horizontal lerps: tap (j, k)'s top is window row
// iy_j's lerp at column ix_k, which depends on (row, k) only, so the 4 x 5
// row lerps and their row-to-row differences (each tap's bot - top) are
// computed once and each tap selects two of them: the same operations on
// the same values as selecting the four texels first. The selects are
// exact 3-way selects (any floor but 0 and 1 takes the third branch, as
// torch.where's nesting does).
//
// Bound on the H100: 16 B a pixel of planes (x, y, z in, the fraction
// out), 33 MB at 1920 x 1088, a 0.010 ms floor at 3.35 TB/s; the window
// texels come from L1 and L2 (a warp's 32 x 1 pixels and a block's 32 x 8
// share their windows' map rows). The plain function's f32 arithmetic,
// ~386 operations a pixel (0.012 ms at 67 TFLOP/s; ~225 with the shared
// lerps), and its ~180 selects bind it by instruction issue, not bytes:
//   - one thread a pixel, 32 x 8 pixel blocks, no shared memory: a warp's
//     plane loads are 32 consecutive pixels of a row (coalesced) and its
//     16 texel loads a pixel hit nearby map rows through the read-only
//     path;
//   - x, y, z and the map are read through their row pitches, so the
//     G-buffer's lanes and K1's tile-padded depth buffer go in as views;
//   - every intermediate stays in registers; the fraction is written once.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr float kHalf = 0.5f;
constexpr float kInv25 = 1.0f / 25.0f;  // torch's count / 25.0 on the card: count * (1 / 25)

struct Offsets {
  float v[5];
};

__device__ __forceinline__ float sel3(int i, float a, float b, float c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

// torch.floor(t).to(torch.int32) on the card.
__device__ __forceinline__ int floor_i32(float t) { return __float2int_rz(floorf(t)); }

// Wrapping int32 sum (the card's add.s32; C++'s signed overflow is undefined).
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// (start + d) mod s, non-negative, for start in [0, s], d in [-2, 1], s >= 2.
__device__ __forceinline__ int wrap(int start, int d, int s) {
  int i = start + d;
  if (i < 0) i += s;
  if (i >= s) i -= s;
  return i;
}

// Window texel coordinate in the (start, lx) form the plain version uses.
struct Axis {
  int start;  // padded window origin, clamp(w + 2, 0, s)
  float local;  // tap centre in the window, t - float(w)
};

__device__ __forceinline__ Axis axis(float t, int s) {
  const int w = add_wrap(floor_i32(t), -1);
  return Axis{min(max(add_wrap(w, 2), 0), s), __fsub_rn(t, __int2float_rn(w))};
}

__global__ void __launch_bounds__(kBlockX* kBlockY)
pcf_runs_kernel(const float* __restrict__ map, int map_pitch, int s,
                const float* __restrict__ xp, const float* __restrict__ yp,
                const float* __restrict__ zp, int pitch_x, int pitch_y, int pitch_z, int h,
                int w, Offsets off, float* __restrict__ out) {
  const int px = blockIdx.x * kBlockX + threadIdx.x;
  const int py = blockIdx.y * kBlockY + threadIdx.y;
  if (px >= w || py >= h) return;
  const float x = __ldg(xp + py * pitch_x + px);
  const float y = __ldg(yp + py * pitch_y + px);
  const float z = __ldg(zp + py * pitch_z + px);

  const float u = __fadd_rn(__fmul_rn(x, kHalf), kHalf);
  const float v = __fsub_rn(1.0f, __fadd_rn(__fmul_rn(y, kHalf), kHalf));
  const bool outside = (z > 1.0f) | (u < 0.0f) | (v < 0.0f) | (u > 1.0f) | (v > 1.0f);
  const float fs = (float)s;
  const Axis ax = axis(__fsub_rn(__fmul_rn(u, fs), kHalf), s);
  const Axis ay = axis(__fsub_rn(__fmul_rn(v, fs), kHalf), s);

  // The 4x4 window, rows and columns wrapped by index.
  int col[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) col[c] = wrap(ax.start, c - 2, s);
  float win[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* row = map + wrap(ay.start, r - 2, s) * map_pitch;
#pragma unroll
    for (int c = 0; c < 4; ++c) win[r][c] = __ldg(row + col[c]);
  }

  // Row lerps h[r][k] at x offset k and their row-to-row differences.
  float hl[4][5], dl[3][5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float sx = __fadd_rn(ax.local, off.v[k]);
    const int ix = floor_i32(sx);
    const float fx = __fsub_rn(sx, __int2float_rn(ix));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = sel3(ix, win[r][0], win[r][1], win[r][2]);
      const float b = sel3(ix, win[r][1], win[r][2], win[r][3]);
      hl[r][k] = __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), fx));
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) dl[r][k] = __fsub_rn(hl[r + 1][k], hl[r][k]);
  }
  float count = 0.0f;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float sy = __fadd_rn(ay.local, off.v[j]);
    const int iy = floor_i32(sy);
    const float fy = __fsub_rn(sy, __int2float_rn(iy));
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float top = sel3(iy, hl[0][k], hl[1][k], hl[2][k]);
      const float dif = sel3(iy, dl[0][k], dl[1][k], dl[2][k]);
      const float closest = __fadd_rn(top, __fmul_rn(dif, fy));
      count = __fadd_rn(count, z > closest ? 1.0f : 0.0f);
    }
  }
  out[py * w + px] = outside ? 0.0f : __fmul_rn(count, kInv25);
}

}  // namespace

// map: (s, s) f32 at row pitch map_pitch, s >= 2; x, y, z: (h, w) f32 planes
// at row pitches pitch_x / pitch_y / pitch_z (unit column stride); off0..off4
// the tap offsets (ops/shadow.tap_offsets); out: (h, w) f32, contiguous.
// Every offset fits a 32-bit int (the wrapper checks).
extern "C" int arctic_pcf_runs(const float* map, int map_pitch, int s, const float* x,
                               const float* y, const float* z, int pitch_x, int pitch_y,
                               int pitch_z, int h, int w, float off0, float off1, float off2,
                               float off3, float off4, float* out, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  const Offsets off = {{off0, off1, off2, off3, off4}};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  pcf_runs_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      map, map_pitch, s, x, y, z, pitch_x, pitch_y, pitch_z, h, w, off, out);
  return (int)cudaGetLastError();
}

// out[0..3] = registers and local (spill) bytes a thread, threads a block
// and blocks an SM of pcf_runs_kernel on the current device.
extern "C" int arctic_pcf_runs_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, pcf_runs_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pcf_runs_kernel,
                                                      kBlockX * kBlockY, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = kBlockX * kBlockY;
  out[3] = blocks;
  return (int)cudaSuccess;
}
