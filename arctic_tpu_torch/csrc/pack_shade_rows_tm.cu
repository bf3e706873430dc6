// K11 pack_shade_rows_tm — K3 with the world / light-space corner planes
// read tri-major.
//
// Replaces arctic_tpu/ops/raster_tiles.py:_pack_shade_rows_tm_kernel. The
// 18 wc / lsp planes are per triangle; K3 reads them dup'd to clip-slot
// order ([tri; tri], rows 24:42 of its 48-row stack). Here they come as
// (18, cap) tri-major planes (wc[k][i] at 3k+i, lsp[k][i] at 9+3k+i) and
// slot s reads triangle s % cap for s < 2 * cap, zero beyond — what the TPU
// kernel's modular block map read. Every other input and lane is K3's
// (csrc/pack_shade_rows.cu): pf (24, N) holds K3's rows 0:24, st (56, N) the
// static rows; the output (N, 128) equals K3's table on the dup'd stack.
// The JAX package only took this kernel when p == 2 * cap + 1, which its
// frame's p == 2 * cap never is; this kernel takes any p <= N.
//
// One thread per output element, as K3: a warp writes 32 consecutive lanes
// of one row (coalesced) and reads its slot's planes as broadcasts. Bound on
// the H100: bytes — 80 floats per slot read (24 + 56) plus the 18 tri-major
// planes once, 128 written; a streaming pass with no reuse. Built with
// -fmad=false so the blends round like the plain torch version.

#include <cuda_runtime.h>

namespace {

__global__ void pack_shade_rows_tm_kernel(const float* __restrict__ pf,
                                          const float* __restrict__ tri,
                                          const float* __restrict__ st, int n,
                                          int cap, int p, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)n * 128) return;
  const int slot = (int)(e >> 7);
  const int lane = (int)(e & 127);
  const bool dup = slot < 2 * cap;
  const int t = slot < cap ? slot : slot - cap;
#define PF(r) pf[(size_t)(r) * n + slot]
#define ST(r) st[(size_t)(r) * n + slot]
#define TRI(r) (dup ? tri[(size_t)(r) * cap + t] : 0.0f)
  float v = 0.0f;
  if (lane < 9) {
    v = PF(lane) * PF(12 + lane / 3);
  } else if (lane == 9) {
    v = slot < p ? (float)slot : -2.0f;
  } else if (lane >= 16 && lane < 88) {
    const int c = (lane - 16) / 24;
    const int j = (lane - 16) % 24;
    const float cb0 = PF(15 + 3 * c), cb1 = PF(16 + 3 * c), cb2 = PF(17 + 3 * c);
    if (j < 3) {
      v = cb0 * TRI(j) + cb1 * TRI(3 + j) + cb2 * TRI(6 + j);
    } else if (j < 14) {
      const int a = j - 3;
      v = cb0 * ST(a) + cb1 * ST(11 + a) + cb2 * ST(22 + a);
    } else if (j < 17) {
      const int a = j - 14;
      v = cb0 * TRI(9 + a) + cb1 * TRI(12 + a) + cb2 * TRI(15 + a);
    }
  } else if (lane >= 88 && lane < 111) {
    v = ST(33 + lane - 88);
  } else if (lane >= 112 && lane < 124) {
    v = PF(lane - 112);  // raw edges [0:9) then the z plane [9:12)
  } else if (lane == 124) {
    v = slot < p ? (float)slot : 0.0f;
  }
#undef PF
#undef ST
#undef TRI
  out[e] = v;
}

}  // namespace

// pf (24, n), tri (18, cap), st (56, n) f32; out (n, 128) f32; p <= n slots.
extern "C" int arctic_pack_shade_rows_tm(const float* pf, const float* tri, const float* st,
                                         int n, int cap, int p, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (cap <= 0 || p < 0 || p > n) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)n * 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  pack_shade_rows_tm_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pf, tri, st, n, cap, p, out);
  return (int)cudaGetLastError();
}
