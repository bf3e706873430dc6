// K15 shade_lights — the ray-traced frame's lighting in one launch: per
// pixel, wo from the eye, the sun's Cook-Torrance GGX term scaled by the
// sun shadow `lit`, each point light's term (direction, distance falloff,
// spot cone, scaled by `lit` and by its visibility row when light shadows
// are traced) and the ambient term -> the (3, H, W) f32 colour.
//
// Replaces no TPU kernel: the JAX package writes this chain as jnp
// arithmetic (arctic_tpu/models/raytrace.py) that XLA fuses under jax.jit.
// The port ran it as plain torch, about 100 elementwise operations over
// full-frame planes for the sun and for each light (~570 launches a frame
// with 4 lights, each writing a plane to HBM and reading it back). Its
// plain version is ops/pbr.py shade_lights_plain.
//
// Bit-exact against the plain version on the card: each operation is the
// one torch's CUDA kernel computes, in the same order, rounded once, with
// no fused multiply-add (built with -fmad=false):
//   - 3-term sums as ops/pbr.dot_cf's (a0*b0 + a1*b1) + a2*b2;
//   - a division by a Python float is torch's multiplication by its
//     float32 reciprocal (/ PI -> * (1/PI), / 8 -> * 0.125); by a tensor an
//     IEEE division; sqrt the IEEE square root;
//   - clamp propagates NaN as torch's does (NaN in, NaN out);
//   - clamp(1 - cos, 0, 1) ** 5.0 is torch's pow(Tensor, Scalar): powf;
//   - constants are the Python floats cast to float32 (the 9-digit PI,
//     0.04, 1e-4, 1e-12), and lo = lit * sun; lo = lo + vis * term_i;
//     colour = lo + ambient * base.
//
// Bound on the H100: bytes, 60 B a pixel (wp, n, base colour: 3 f32 each;
// metalness, roughness, lit: 1 each; 3 f32 out), 124.4 MB at 1920 x 1080,
// a floor of 0.037 ms at 3.35 TB/s; 4 B more a pixel and light for a
// visibility row. The arithmetic (~100 operations a term, 5 terms with 4
// lights) lies far below the ridge by count; what it costs in instruction slots
// is its IEEE divisions and square roots (~15 and 2 a point light). The
// design moves each byte once and keeps every intermediate in registers:
//   - one thread a pixel, 128-thread blocks (256 and 512 ran 4% and 7%
//     slower, 256 capped at 48 or 40 registers 2% and 6%: the arithmetic,
//     not occupancy, sets the time), no shared memory: a warp's
//     loads of one channel are 32 consecutive pixels of the plane
//     (coalesced where the pixel stride is 1; a tap's channel planes, which
//     interleave their channels, are read in place through their pixel
//     stride, and their lines serve the other channels from L1);
//   - each plane is read through its base pointer and its channel and
//     pixel strides, so the caller copies nothing (ops/pbr.py raises on a
//     plane whose pixels are not evenly spaced);
//   - the frame's parameters (eye, sun, ambient and up to 16 lights, 752 B)
//     go to the kernel by value in its parameter space, from the host:
//     no device copy, no sync; a warp reads them as uniform constants;
//   - the twelve input loads of a pixel are independent and go out before
//     any arithmetic, and the three colour planes are written once;
//   - what a GGX term needs of the pixel alone (f0, the roughness terms,
//     n.wo and its geometry factor) is computed once, not once a light.
// On an H100 at 1920 x 1080 with 4 lights it takes ~0.17 ms of device
// time, ~22% of the byte floor: the IEEE divisions that bit-exactness to
// torch's `/` needs (72 a pixel) bind it by instruction throughput, not bytes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLights = 16;
constexpr int kThreads = 128;
// wp, n, base colour, metalness, roughness, lit, visibility.
constexpr int kPlanes = 7;
// ops/pbr.py's LIGHT_* layout of the packed host floats.
constexpr int kEye = 0, kSunWi = 3, kSunColor = 6, kAmbient = 9, kCount = 10, kSpot = 11;
constexpr int kPos = 12;
constexpr int kColor = kPos + 3 * kMaxLights;
constexpr int kAxis = kColor + 3 * kMaxLights;
constexpr int kCone = kAxis + 3 * kMaxLights;

// torch's constants: Python floats cast to float32.
constexpr float kPi = (float)3.14159265;
constexpr float kInvPi = 1.0f / kPi;  // torch's x / PI on the card: x * (1 / PI)
constexpr float kF0 = (float)0.04;
constexpr float kEps = (float)1e-4;
constexpr float kMinDist = (float)1e-12;

struct Frame {
  float eye[3], sun_wi[3], sun_color[3], ambient;
  int count, spot;
  float pos[kMaxLights][3], color[kMaxLights][3], axis[kMaxLights][3], cone[kMaxLights][2];
};

struct Planes {
  const float* ptr[kPlanes];
  long long cs[kPlanes];  // channel (visibility: light) stride, in floats
  long long ps[kPlanes];  // pixel stride, in floats
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

// torch.clamp(v, min=lo) and torch.clamp(v, 0, 1) on the card.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float load(const Planes& p, int i, int c, long long pix) {
  return __ldg(p.ptr[i] + c * p.cs[i] + pix * p.ps[i]);
}

// What ops/pbr.outgoing_radiance_cf computes from the pixel alone, the
// same for every light (torch computes it again for each term; the values
// are the same).
struct Surface {
  V3 n, wo, base, f0;
  float m, a2, a2m1, k, omk, ndwo, g_wo, km;
};

__device__ __forceinline__ Surface surface(V3 n, V3 wo, V3 base, float m, float r) {
  Surface s;
  s.n = n;
  s.wo = wo;
  s.base = base;
  s.m = m;
  s.f0 = {kF0 + (base.x - kF0) * m, kF0 + (base.y - kF0) * m, kF0 + (base.z - kF0) * m};
  const float a = r * r;
  s.a2 = a * a;
  s.a2m1 = s.a2 - 1.0f;
  const float rr = r + 1.0f;
  s.k = (rr * rr) * 0.125f;
  s.omk = 1.0f - s.k;
  s.ndwo = clamp_min(dot3(n, wo), 0.0f);
  s.g_wo = s.ndwo / (s.ndwo * s.omk + s.k);
  s.km = 1.0f - m;
  return s;
}

// ops/pbr.outgoing_radiance_cf for one pixel and light (forward.hlsl:177-193).
__device__ __forceinline__ V3 outgoing(const Surface& s, V3 wi, V3 li) {
  V3 h = {s.wo.x + wi.x, s.wo.y + wi.y, s.wo.z + wi.z};
  const float hl = sqrtf(dot3(h, h));
  h = {h.x / hl, h.y / hl, h.z / hl};
  const float p = powf(clamp01(1.0f - clamp_min(dot3(h, s.wo), 0.0f)), 5.0f);
  const V3 fr = {s.f0.x + (1.0f - s.f0.x) * p, s.f0.y + (1.0f - s.f0.y) * p,
                 s.f0.z + (1.0f - s.f0.z) * p};
  // distribution_ggx_cf
  const float ndh = clamp_min(dot3(s.n, h), 0.0f);
  const float denom = ndh * ndh * s.a2m1 + 1.0f;
  const float ndf = s.a2 / (denom * kPi * denom);
  // geometry_smith_cf
  const float ndwi = clamp_min(dot3(s.n, wi), 0.0f);
  const float geo = s.g_wo * (ndwi / (ndwi * s.omk + s.k));
  const float ng = ndf * geo;
  const float den = 4.0f * s.ndwo * ndwi + kEps;
  return {((((1.0f - fr.x) * s.km) * s.base.x * kInvPi + ng * fr.x / den) * li.x) * ndwi,
          ((((1.0f - fr.y) * s.km) * s.base.y * kInvPi + ng * fr.y / den) * li.y) * ndwi,
          ((((1.0f - fr.z) * s.km) * s.base.z * kInvPi + ng * fr.z / den) * li.z) * ndwi};
}

__global__ void __launch_bounds__(kThreads)
    shade_lights_kernel(const Planes planes, const Frame f, long long n_pix, float* __restrict__ out) {
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= n_pix) return;
  const V3 wp = {load(planes, 0, 0, pix), load(planes, 0, 1, pix), load(planes, 0, 2, pix)};
  const V3 n = {load(planes, 1, 0, pix), load(planes, 1, 1, pix), load(planes, 1, 2, pix)};
  const V3 base = {load(planes, 2, 0, pix), load(planes, 2, 1, pix), load(planes, 2, 2, pix)};
  const float m = load(planes, 3, 0, pix);
  const float r = load(planes, 4, 0, pix);
  const float lit = load(planes, 5, 0, pix);

  V3 wo = {f.eye[0] - wp.x, f.eye[1] - wp.y, f.eye[2] - wp.z};
  const float wl = sqrtf(dot3(wo, wo));
  wo = {wo.x / wl, wo.y / wl, wo.z / wl};
  const Surface s = surface(n, wo, base, m, r);

  const V3 sun = outgoing(s, {f.sun_wi[0], f.sun_wi[1], f.sun_wi[2]},
                          {f.sun_color[0], f.sun_color[1], f.sun_color[2]});
  V3 lo = {lit * sun.x, lit * sun.y, lit * sun.z};

  for (int i = 0; i < f.count; ++i) {
    const V3 ldir = {f.pos[i][0] - wp.x, f.pos[i][1] - wp.y, f.pos[i][2] - wp.z};
    const float dist = clamp_min(sqrtf(dot3(ldir, ldir)), kMinDist);
    const V3 wi = {ldir.x / dist, ldir.y / dist, ldir.z / dist};
    const float d2 = dist * dist;
    V3 li = {f.color[i][0] / d2, f.color[i][1] / d2, f.color[i][2] / d2};
    if (f.spot) {
      const V3 axis = {f.axis[i][0], f.axis[i][1], f.axis[i][2]};
      const float cos_t = -dot3(wi, axis);
      const float cone = clamp01((cos_t - f.cone[i][0]) * f.cone[i][1]);
      li = {li.x * cone, li.y * cone, li.z * cone};
    }
    const float vis = planes.ptr[6] ? load(planes, 6, i, pix) * lit : lit;
    const V3 t = outgoing(s, wi, li);
    lo = {lo.x + vis * t.x, lo.y + vis * t.y, lo.z + vis * t.z};
  }

  out[pix] = lo.x + f.ambient * base.x;
  out[n_pix + pix] = lo.y + f.ambient * base.y;
  out[2 * n_pix + pix] = lo.z + f.ambient * base.z;
}

}  // namespace

// Planes: device pointers (visibility may be null: no light shadows);
// strides: host, 2 a plane (channel or light stride, pixel stride), in
// floats; lights: host, ops/pbr.py LIGHT_FLOATS floats (pack_lights); out:
// (3, height, width) contiguous.
extern "C" int arctic_shade_lights(const float* wp, const float* n, const float* base,
                                   const float* metalness, const float* roughness,
                                   const float* lit, const float* visibility,
                                   const long long* strides, int height, int width,
                                   const float* lights, float* out, void* stream) {
  if (height < 0 || width < 0) return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)height * width;
  if (n_pix == 0) return (int)cudaSuccess;
  Planes planes;
  const float* ptrs[kPlanes] = {wp, n, base, metalness, roughness, lit, visibility};
  for (int i = 0; i < kPlanes; ++i) {
    planes.ptr[i] = ptrs[i];
    planes.cs[i] = strides[2 * i];
    planes.ps[i] = strides[2 * i + 1];
  }
  Frame f;
  const int count = (int)lights[kCount];
  if (count < 0 || count > kMaxLights) return (int)cudaErrorInvalidValue;
  for (int c = 0; c < 3; ++c) {
    f.eye[c] = lights[kEye + c];
    f.sun_wi[c] = lights[kSunWi + c];
    f.sun_color[c] = lights[kSunColor + c];
  }
  f.ambient = lights[kAmbient];
  f.count = count;
  f.spot = lights[kSpot] != 0.0f;
  for (int i = 0; i < kMaxLights; ++i) {
    for (int c = 0; c < 3; ++c) {
      f.pos[i][c] = lights[kPos + 3 * i + c];
      f.color[i][c] = lights[kColor + 3 * i + c];
      f.axis[i][c] = lights[kAxis + 3 * i + c];
    }
    f.cone[i][0] = lights[kCone + 2 * i];
    f.cone[i][1] = lights[kCone + 2 * i + 1];
  }
  const long long blocks = (n_pix + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  shade_lights_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(planes, f, n_pix,
                                                                              out);
  return (int)cudaGetLastError();
}

// K15's registers, local (spill) bytes a thread, block size and the blocks
// an SM holds at once.
extern "C" int arctic_shade_lights_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, shade_lights_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shade_lights_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = kThreads;
  out[3] = blocks;
  return (int)cudaSuccess;
}
