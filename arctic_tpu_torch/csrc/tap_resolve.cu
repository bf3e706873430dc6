// K6 tap_resolve — the merged texture + environment tap of every pixel.
//
// Replaces arctic_tpu/ops/sampling.py:_tap_resolve_kernel, with the row
// gather that preceded it (pipeline.shade_gbuffer: merged[idx]) done inside
// the kernel. A covered pixel reads its material quad, an uncovered one its
// environment quad, from one bf16 table of 128-lane (256-byte) rows:
//   texture quad: lanes [c4*tq, c4*tq + c4) = [c00 | c10 | c01 | c11], c4/4 each;
//   env quad:     lanes [16*eq, 16*eq + 16) = [c00 | c10 | c01 | c11], 4 each.
// Each is widened to f32 (exact: the bf16 bits shifted up by 16) and
// bilerped as sampling.py:275-286:
//   top = c00 + (c10 - c00)*fx; bot = c01 + (c11 - c01)*fx; top + (bot - top)*fy.
// Output: 16 channel planes, [0, c4/4) texture, [c4/4, c4/4 + 4) env RGBA,
// zero after.
//
// Bound on the H100: bytes — 28 B of per-pixel inputs and 64 B of planes
// out per pixel, coalesced, and each table lane the pixels' quads cover
// once. The row reads are what cost: a warp-wide load touches up to 32
// rows, so each load instruction should carry as many useful bytes as it
// can. c4 is a template argument (the launcher dispatches over every width
// the wrapper accepts, so the quad loop unrolls), the texture quad is read
// with 16-byte read-only loads (8-byte where 2*c4 is not a multiple of 16)
// and the env quad with two 16-byte loads: c4/8 + 2 row loads per pixel (4
// at c4 = 16, 8 at c4 = 48), issued together after the seven per-pixel
// inputs. The row
// base is 256 B into a table the wrapper checks to be 16-byte aligned and
// contiguous. One thread per pixel keeps the 16 plane stores coalesced.
// Built with -fmad=false so the lerps equal the plain torch version bit for
// bit (NaN and Inf patterns in the table propagate the same way).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowBytes = 256;

// bf16 lane i of packed words w (lane 2k is the low half of word k), as f32.
__device__ __forceinline__ float lane(const uint32_t* w, int i) {
  const uint32_t v = w[i >> 1];
  return __uint_as_float((i & 1) ? (v & 0xFFFF0000u) : (v << 16));
}

__device__ __forceinline__ float bilerp(float c00, float c10, float c01, float c11,
                                        float fx, float fy) {
  const float top = c00 + (c10 - c00) * fx;
  const float bot = c01 + (c11 - c01) * fx;
  return top + (bot - top) * fy;
}

template <int C4>
__global__ void __launch_bounds__(kThreads)
tap_resolve_kernel(const uint8_t* __restrict__ table, const int* __restrict__ idx,
                   const int* __restrict__ tq, const int* __restrict__ eq,
                   const float* __restrict__ tfx, const float* __restrict__ tfy,
                   const float* __restrict__ efx, const float* __restrict__ efy, int n,
                   float* __restrict__ out) {
  constexpr int C = C4 / 4;
  static_assert(C4 % 4 == 0 && C4 >= 4 && C + 4 <= 16, "c4: a multiple of 4, c4/4 + 4 <= 16");
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int r = __ldg(idx + p), t = __ldg(tq + p), e = __ldg(eq + p);
  const float fx = __ldg(tfx + p), fy = __ldg(tfy + p);
  const float gx = __ldg(efx + p), gy = __ldg(efy + p);
  const uint8_t* row = table + (size_t)r * kRowBytes;

  uint32_t tw[C4 / 2];  // the texture quad, two bf16 lanes a word
  if constexpr (C4 % 8 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(row + 2 * C4 * t);
#pragma unroll
    for (int k = 0; k < C4 / 8; ++k) {
      const uint4 v = __ldg(src + k);
      tw[4 * k] = v.x, tw[4 * k + 1] = v.y, tw[4 * k + 2] = v.z, tw[4 * k + 3] = v.w;
    }
  } else {
    const uint2* src = reinterpret_cast<const uint2*>(row + 2 * C4 * t);
#pragma unroll
    for (int k = 0; k < C4 / 4; ++k) {
      const uint2 v = __ldg(src + k);
      tw[2 * k] = v.x, tw[2 * k + 1] = v.y;
    }
  }
  uint32_t ew[8];  // the env quad
  {
    const uint4* src = reinterpret_cast<const uint4*>(row + 32 * e);
    const uint4 a = __ldg(src), b = __ldg(src + 1);
    ew[0] = a.x, ew[1] = a.y, ew[2] = a.z, ew[3] = a.w;
    ew[4] = b.x, ew[5] = b.y, ew[6] = b.z, ew[7] = b.w;
  }

#pragma unroll
  for (int i = 0; i < C; ++i)
    out[(size_t)i * n + p] = bilerp(lane(tw, i), lane(tw, C + i), lane(tw, 2 * C + i),
                                    lane(tw, 3 * C + i), fx, fy);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[(size_t)(C + i) * n + p] =
        bilerp(lane(ew, i), lane(ew, 4 + i), lane(ew, 8 + i), lane(ew, 12 + i), gx, gy);
#pragma unroll
  for (int i = C + 4; i < 16; ++i) out[(size_t)i * n + p] = 0.0f;
}

template <int C4>
cudaError_t launch(const uint8_t* table, const int* idx, const int* tq, const int* eq,
                   const float* tfx, const float* tfy, const float* efx, const float* efy,
                   int n, float* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  tap_resolve_kernel<C4><<<blocks, kThreads, 0, stream>>>(table, idx, tq, eq, tfx, tfy, efx,
                                                          efy, n, out);
  return cudaGetLastError();
}

}  // namespace

// table (R, 128) bf16 bits, contiguous, 16-byte aligned; idx/tq/eq (n,) i32;
// tfx/tfy/efx/efy (n,) f32; out (16, n) f32. c4 in {4, 8, ..., 48}; any
// other width is refused.
extern "C" int arctic_tap_resolve(const uint16_t* table, const int* idx,
                                  const int* tq, const int* eq, const float* tfx,
                                  const float* tfy, const float* efx,
                                  const float* efy, int n, int c4, float* out,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const uint8_t* t = reinterpret_cast<const uint8_t*>(table);
  cudaStream_t s = (cudaStream_t)stream;
  switch (c4) {
#define ARCTIC_K6_CASE(W) \
  case W:                 \
    return (int)launch<W>(t, idx, tq, eq, tfx, tfy, efx, efy, n, out, s);
    ARCTIC_K6_CASE(4) ARCTIC_K6_CASE(8) ARCTIC_K6_CASE(12) ARCTIC_K6_CASE(16)
    ARCTIC_K6_CASE(20) ARCTIC_K6_CASE(24) ARCTIC_K6_CASE(28) ARCTIC_K6_CASE(32)
    ARCTIC_K6_CASE(36) ARCTIC_K6_CASE(40) ARCTIC_K6_CASE(44) ARCTIC_K6_CASE(48)
#undef ARCTIC_K6_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
