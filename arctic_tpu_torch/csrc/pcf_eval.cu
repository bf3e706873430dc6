// K8 pcf_eval — the 25-tap PCF count of every pixel of the compacted
// penumbra rows, over its 4x4 window of the quantised table (K7).
//
// Replaces arctic_tpu/ops/shadow.py:_pcf_eval_kernel, with the six row
// gathers in front of it (shadow.py:947-951): a thread reads its pixels'
// start_y, start_x, z, lx and ly from the (R, 128) planes itself, at row
// order[i]. The TPU kernel selected the window from a gathered 128-lane
// block row through a select tree; here the 16 texels are read from the
// padded map (K7's table, rows start_y .. start_y + 3, columns start_x ..
// start_x + 3), widened (exact) and dequantised as q * DQ with DQ the f32
// jnp.float32(1.0 / 65535.0) (hex literal below). The taps follow
// shadow.py:727-745: y offsets outer, x inner, sy = ly + off[j] with off[]
// the five f32 offsets from the host (the f32 of the double j * step),
// exact 3-way row / column selects on floor(sy) and floor(sx), lerps
// top = c00 + (c10 - c00) * fx, bot likewise, closest = top + (bot - top) * fy,
// each multiply and add rounded separately (-fmad=false). The raw count
// leaves the kernel; the /25 is done outside, as in the JAX package. Rows
// i >= rows_used[0] are written as 0.
//
// Bound on the H100: bytes — 20 B of planes read and 4 B written per pixel
// (coalesced), each texel of the windows once; about 380 f32 operations a
// pixel. What binds it in practice is latency (a row's order -> planes ->
// window -> taps chain is dependent) and instruction issue (the taps'
// selects and lerps), so:
// - a grid of resident 256-thread blocks (as many as the card holds at
//   once) walks the listed rows: thread l of a block takes pixel l % 128 of
//   every row its half of the block meets, in a pipeline that keeps the
//   order entry three rows ahead, the planes two ahead and the window one
//   ahead in flight while a row's taps run; rows_used[0] is read once per
//   block, and the rows past it are written as zeros with 16-byte stores in
//   the same launch;
// - a window row is one aligned 8-byte word at column x0 & ~3, plus the
//   next word when x0 % 4 != 0 (then x0 + 3 reaches into it, so the word
//   lies inside the row even when the pitch is s + 4): 4-8 loads for 16
//   texels, selected by funnel shifts;
// - the 25 taps share their horizontal lerps: tap (j, k)'s top is row
//   R(iy_j)'s lerp at column C(ix_k), which depends on (row, k) only, so the
//   4 x 5 row lerps and their row-to-row differences are computed once and
//   each tap selects two of them and lerps vertically — the same operations
//   on the same values as selecting the four texels first;
// - where a warp's taps all stay where a tap centre in [1, 2) puts them
//   (a vote), each 3-way select has one possible branch or two; other
//   warps take the general selects, out of line. chip_smoke prints the
//   share of a real frame's warps that take the fast form and K8's time
//   when none does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRow = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerPass = kThreads / kRow;  // rows a block takes side by side
constexpr float kDq = 0x1.0001p-16f;  // == jnp.float32(1.0 / 65535.0)

struct Offsets {
  float v[5];
  int ascending;  // v[0] <= v[1] <= ... <= v[4]: each tap's floor is monotone in k
};

// A window: 4 rows of two words holding texels x0 .. x0 + 3 (texel c in
// half c % 2 of word c / 2).
struct Window {
  uint32_t v[4][2];
};

struct Pixel {
  int y0, x0;
  float z, lx, ly;
};

__device__ __forceinline__ float sel3(int i, float a, float b, float c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

// Texel c of a window row, widened (exact) and dequantised: q * DQ.
__device__ __forceinline__ float texel(const Window& win, int r, int c) {
  const uint32_t v = win.v[r][c >> 1];
  return __fmul_rn((float)((c & 1) ? (v >> 16) : (v & 0xFFFFu)), kDq);
}

// The 3-way select of tap offset k (i = floor(sx) or floor(sy)), or its
// fast form where every tap's floor is where |offset| < 1 puts it for a
// tap centre in [1, 2): 0 or 1 for k < 2, 1 for k = 2, 1 or 2 for k > 2.
// There sel3 takes only those branches, so the fast form is the same
// select with the others dropped.
template <bool kFast>
__device__ __forceinline__ float pick(int k, int i, float a, float b, float c) {
  if (!kFast) return sel3(i, a, b, c);
  return k < 2 ? (i == 0 ? a : b) : (k == 2 ? b : (i == 1 ? b : c));
}

// The 25 taps of one pixel: tap (j, k)'s top is row R(iy_j)'s lerp at
// column C(ix_k), which depends on (row, k) only, so the 4 x 5 row lerps h
// (and their row-to-row differences d, each tap's bot - top) are computed
// once and each tap selects two of them and lerps vertically.
template <bool kFast>
__device__ __forceinline__ float taps(const Window& win, const int (&ix)[5],
                                      const float (&fx)[5], const int (&iy)[5],
                                      const float (&fy)[5], float z) {
  float w[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) w[r][c] = texel(win, r, c);
  float h[4][5], d[3][5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = pick<kFast>(k, ix[k], w[r][0], w[r][1], w[r][2]);
      const float b = pick<kFast>(k, ix[k], w[r][1], w[r][2], w[r][3]);
      h[r][k] = __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), fx[k]));
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) d[r][k] = __fsub_rn(h[r + 1][k], h[r][k]);
  }
  float count = 0.0f;
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float top = pick<kFast>(j, iy[j], h[0][k], h[1][k], h[2][k]);
      const float dif = pick<kFast>(j, iy[j], d[0][k], d[1][k], d[2][k]);
      const float closest = __fadd_rn(top, __fmul_rn(dif, fy[j]));
      count = __fadd_rn(count, z > closest ? 1.0f : 0.0f);
    }
  return count;
}

__device__ __forceinline__ void tap_floors(float lx, float ly, const Offsets& off, int (&ix)[5],
                                           float (&fx)[5], int (&iy)[5], float (&fy)[5]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float sx = __fadd_rn(lx, off.v[k]);
    ix[k] = (int)floorf(sx);
    fx[k] = __fsub_rn(sx, (float)ix[k]);
    const float sy = __fadd_rn(ly, off.v[k]);
    iy[k] = (int)floorf(sy);
    fy[k] = __fsub_rn(sy, (float)iy[k]);
  }
}

// The general taps, out of line: only warps with a tap outside the fast
// form's range take them.
__device__ __noinline__ float tap_count_general(Window win, float z, float lx, float ly,
                                                Offsets off) {
  int ix[5], iy[5];
  float fx[5], fy[5];
  tap_floors(lx, ly, off, ix, fx, iy, fy);
  return taps<false>(win, ix, fx, iy, fy, z);
}

// Raw 25-tap count of one pixel. The whole warp must call it: it votes for
// the fast form. With ascending offsets the floors are monotone in k, so
// floors 0, 1 and at most 2 at k = 0, 2 and 4 put every floor in its fast
// range.
__device__ __forceinline__ float tap_count(const Window& win, const Pixel& px,
                                           const Offsets& off) {
  int ix[5], iy[5];
  float fx[5], fy[5];
  tap_floors(px.lx, px.ly, off, ix, fx, iy, fy);
  const bool fast = off.ascending && ix[0] >= 0 && ix[2] == 1 && ix[4] <= 2 && iy[0] >= 0 &&
                    iy[2] == 1 && iy[4] <= 2;
  if (__all_sync(0xFFFFFFFFu, fast)) return taps<true>(win, ix, fx, iy, fy, px.z);
  return tap_count_general(win, px.z, px.lx, px.ly, off);
}

__device__ __forceinline__ Pixel load_pixel(const int* __restrict__ start_y,
                                            const int* __restrict__ start_x,
                                            const float* __restrict__ zp,
                                            const float* __restrict__ lxp,
                                            const float* __restrict__ lyp, int row, int l) {
  const int p = row * kRow + l;
  return Pixel{__ldg(start_y + p), __ldg(start_x + p), __ldg(zp + p), __ldg(lxp + p),
               __ldg(lyp + p)};
}

__device__ __forceinline__ Window load_window(const uint16_t* __restrict__ lut, int pitch,
                                              const Pixel& px) {
  Window win;
  const int m = px.x0 & 3;
  const uint2* base = reinterpret_cast<const uint2*>(lut + (px.y0 * pitch + px.x0 - m));
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint2* wr = base + r * (pitch / 4);
    const uint2 a = __ldg(wr);
    const uint2 b = m ? __ldg(wr + 1) : make_uint2(0u, 0u);
    // texels m .. m + 3 of the 8 in (a, b)
    const uint32_t u0 = m >= 2 ? a.y : a.x;
    const uint32_t u1 = m >= 2 ? b.x : a.y;
    const uint32_t u2 = m >= 2 ? b.y : b.x;
    const int sh = (m & 1) * 16;
    win.v[r][0] = __funnelshift_r(u0, u1, sh);
    win.v[r][1] = __funnelshift_r(u1, u2, sh);
  }
  return win;
}

__global__ void __launch_bounds__(kThreads)
pcf_eval_kernel(const uint16_t* __restrict__ lut, int pitch, const int* __restrict__ order,
                const int* __restrict__ rows_used, int n, const int* __restrict__ start_y,
                const int* __restrict__ start_x, const float* __restrict__ zp,
                const float* __restrict__ lxp, const float* __restrict__ lyp, Offsets off,
                float* __restrict__ out) {
  __shared__ int used_s;
  if (threadIdx.x == 0) used_s = max(min(__ldg(rows_used), n), 0);
  __syncthreads();
  const int used = used_s;
  {  // rows [used, n): zeros, 16-byte stores spread over the whole grid
    float4* o = reinterpret_cast<float4*>(out);
    const long long end = (long long)n * (kRow / 4);
    for (long long k = (long long)used * (kRow / 4) + (long long)blockIdx.x * kThreads +
                       threadIdx.x;
         k < end; k += (long long)gridDim.x * kThreads)
      o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // Rows i, i + g, i + 2g, ... of this half of the block, in a pipeline.
  // Every condition below is warp-uniform: a warp lies in one row.
  const int l = threadIdx.x % kRow;
  const int g = gridDim.x * kRowsPerPass;
  int i = blockIdx.x * kRowsPerPass + threadIdx.x / kRow;
  if (i >= used) return;
  int o2 = i + 2 * g < used ? __ldg(order + i + 2 * g) : 0;
  Pixel p0 = load_pixel(start_y, start_x, zp, lxp, lyp, __ldg(order + i), l);
  Pixel p1 = i + g < used ? load_pixel(start_y, start_x, zp, lxp, lyp, __ldg(order + i + g), l)
                          : p0;
  Window w0 = load_window(lut, pitch, p0);
  for (; i < used; i += g) {
    const int o3 = i + 3 * g < used ? __ldg(order + i + 3 * g) : 0;
    const Pixel p2 = i + 2 * g < used ? load_pixel(start_y, start_x, zp, lxp, lyp, o2, l) : p1;
    const Window w1 = i + g < used ? load_window(lut, pitch, p1) : w0;
    out[(long long)i * kRow + l] = tap_count(w0, p0, off);
    o2 = o3;
    p0 = p1;
    p1 = p2;
    w0 = w1;
  }
}

// Blocks of pcf_eval_kernel the card holds at once, or minus the CUDA
// error of the query. Computed once, on the first call's device: the
// grid-stride loop is right at any grid size, so a card with another SM
// count only changes how the rows are spread.
int resident_blocks() {
  static const int resident = [] {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcf_eval_kernel, kThreads, 0);
    if (e != cudaSuccess) return -(int)e;
    return sms * per_sm > 0 ? sms * per_sm : -(int)cudaErrorInvalidConfiguration;
  }();
  return resident;
}

}  // namespace

// lut (S + 4, pitch) u16, 8-byte aligned, pitch a multiple of 4, fewer than
// 2^31 texels; order (n,) i32 rows of the (R, 128) planes start_y / start_x
// (i32, in [0, S]) and z / lx / ly (f32), R * 128 < 2^31; rows_used (1,) i32
// on the device; off0..off4 the tap offsets; out (n, 128) f32, 16-byte
// aligned. The grid is as many blocks as the card holds at once (at most
// one per pair of listed rows).
extern "C" int arctic_pcf_eval(const uint16_t* lut, int pitch, const int* order,
                               const int* rows_used, int n, const int* start_y,
                               const int* start_x, const float* z, const float* lx,
                               const float* ly, float off0, float off1, float off2,
                               float off3, float off4, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (pitch % 4 != 0 || reinterpret_cast<uintptr_t>(lut) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int resident = resident_blocks();
  if (resident < 0) return -resident;
  const Offsets off = {{off0, off1, off2, off3, off4},
                       off0 <= off1 && off1 <= off2 && off2 <= off3 && off3 <= off4};
  const int pairs = (n + kRowsPerPass - 1) / kRowsPerPass;
  const int blocks = pairs < resident ? pairs : resident;
  pcf_eval_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      lut, pitch, order, rows_used, n, start_y, start_x, z, lx, ly, off, out);
  return (int)cudaGetLastError();
}

// *rows = the listed rows one pass of the full grid takes: a block's rows
// lie this far apart in `order` once the list has at least that many.
extern "C" int arctic_pcf_eval_stride(int* rows) {
  const int resident = resident_blocks();
  if (resident < 0) return -resident;
  *rows = resident * kRowsPerPass;
  return (int)cudaSuccess;
}
