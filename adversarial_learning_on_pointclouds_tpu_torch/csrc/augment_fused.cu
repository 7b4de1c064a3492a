// On-device augmentation in one pass: rotate about Y, clipped Gaussian
// jitter and point dropout, with counter-based random bits.
//
// Replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/augment_fused.py::
// augment_fused (_augment_kernel, pallas_call at augment_fused.py:104).
//
// Bound: bytes. Each point is read once and written once (24 bytes; 1.57
// MB per batch of 32 x 2048, about 0.5 us at 3.35 TB/s); the arithmetic
// is five Philox4x32-10 draws (about 40 integer multiplies), one log, a
// sqrt and three cos/sin per point, which the 132 SMs hide under the
// loads at this size.
// Design: one thread per point, grid (points / 256, clouds). The TPU
// kernel seeds the on-core generator per cloud and draws in order; there
// is no such generator here, so every bit is Philox4x32-10 (Random123's
// generator, written out below) keyed by (seed, 0) at counter (point,
// cloud, draw, 0): draw 0 of a point gives its three jitter u1 and its
// dropout u, draw 1 its three u2, draw 2 of point 0 the cloud's angle and
// dropout ratio. A thread draws its own point's bits and, when its point
// drops, redoes the first point's, so no thread waits on another. The
// key is itself a Philox word, at counter (step, stream, 0, 0) keyed by
// the config seed, and every thread derives it from the int64 step count
// it reads from device memory: a step neither syncs nor launches anything
// else for its seeds, and no per-step value is frozen into a graph.
// Uniforms use the mantissa trick on unsigned bits, as the TPU kernel;
// products and sums are rounded one by one (no contraction) as the plain
// PyTorch twin rounds them (ops/kernels/augment_fused.py).

#include "common.cuh"

namespace pointtpu {
namespace {

constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kRotate = 1, kJitter = 2, kDropout = 4;

struct Words { unsigned w[4]; };

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ Words philox(unsigned c0, unsigned c1, unsigned c2,
                                        unsigned c3, unsigned k0,
                                        unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const unsigned hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const unsigned hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

// The int32 key of a stream's augmentation at a step
// (augment_fused.step_seed in plain PyTorch).
__device__ __forceinline__ unsigned step_key(long long step, unsigned seed,
                                             unsigned stream) {
  return philox((unsigned)step, stream, 0u, 0u, seed, 0u).w[0] & 0x7fffffffu;
}

__device__ __forceinline__ float uniform(unsigned bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// Box-Muller: sqrt(-2 log(max(u1, 1e-7))) cos(2 pi u2).
__device__ __forceinline__ float normal(unsigned b1, unsigned b2) {
  const float u1 = fmaxf(uniform(b1), 1e-7f);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(kTwoPi, uniform(b2))));
}

// Point q of cloud b rotated (c, s) and jittered; its dropout u.
__device__ __forceinline__ void augment_point(const float* __restrict__ x,
                                              int b, int q, int n, int flags,
                                              float c, float s, float sigma,
                                              float clip, unsigned key,
                                              float v[3], float& u_drop) {
  const float* p = x + ((size_t)b * n + q) * 3;
  v[0] = __ldg(p);
  v[1] = __ldg(p + 1);
  v[2] = __ldg(p + 2);
  if (flags & kRotate) {
    const float x0 = v[0], x2 = v[2];
    v[0] = __fsub_rn(__fmul_rn(c, x0), __fmul_rn(s, x2));
    v[2] = __fadd_rn(__fmul_rn(s, x0), __fmul_rn(c, x2));
  }
  if (!(flags & (kJitter | kDropout))) return;
  const Words d0 = philox((unsigned)q, (unsigned)b, 0u, 0u, key, 0u);
  u_drop = uniform(d0.w[3]);
  if (!(flags & kJitter)) return;
  const Words d1 = philox((unsigned)q, (unsigned)b, 1u, 0u, key, 0u);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float noise = __fmul_rn(sigma, normal(d0.w[j], d1.w[j]));
    v[j] = __fadd_rn(v[j], fminf(fmaxf(noise, -clip), clip));
  }
}

__global__ void __launch_bounds__(kThreads)
augment_kernel(const float* __restrict__ x, float* __restrict__ out,
               const long long* __restrict__ step, unsigned seed,
               unsigned stream, int n, int flags, float sigma, float clip,
               float max_ratio) {
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n) return;
  const unsigned key = step_key(__ldg(step), seed, stream);
  const Words cloud = philox(0u, (unsigned)b, 2u, 0u, key, 0u);
  float c = 1.f, s = 0.f;
  if (flags & kRotate) {
    const float angle = __fmul_rn(uniform(cloud.w[0]), kTwoPi);
    c = cosf(angle);
    s = sinf(angle);
  }
  float v[3], u_drop = 1.f;
  augment_point(x, b, q, n, flags, c, s, sigma, clip, key, v, u_drop);
  if ((flags & kDropout) &&
      u_drop <= __fmul_rn(uniform(cloud.w[1]), max_ratio)) {
    float first_u;
    augment_point(x, b, 0, n, flags, c, s, sigma, clip, key, v, first_u);
  }
  float* o = out + ((size_t)b * n + q) * 3;
  o[0] = v[0];
  o[1] = v[1];
  o[2] = v[2];
}

}  // namespace
}  // namespace pointtpu

// out = augment(x [batch, n, 3]) of stream `which` at the int64 step
// count *step, keyed by the config seed; flags: 1 rotate, 2 jitter, 4
// dropout.
extern "C" int pt_augment_fused(const float* x, float* out,
                                const long long* step, unsigned seed,
                                unsigned which, int batch, int n, int flags,
                                float sigma, float clip, float max_ratio,
                                int device, cudaStream_t stream) {
  using namespace pointtpu;
  if (!x || !out || !step || batch <= 0 || batch > 65535 || n <= 0 ||
      (flags & ~(kRotate | kJitter | kDropout)))
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  augment_kernel<<<grid, kThreads, 0, stream>>>(x, out, step, seed, which, n,
                                                flags, sigma, clip, max_ratio);
  return (int)cudaGetLastError();
}
