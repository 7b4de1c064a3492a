// On-device augmentation in one pass: rotate about Y, clipped Gaussian
// jitter and point dropout, with counter-based random bits.
//
// Replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/augment_fused.py::
// augment_fused (_augment_kernel, pallas_call at augment_fused.py:104).
//
// The bits: the TPU kernel seeds the on-core generator per cloud and draws
// in order; there is no such generator here, so every bit is
// Philox4x32-10 (Random123's generator, written out below) keyed by (key,
// 0) at counter (point, cloud, draw, 0), cloud the global cloud index
// cloud0 + b (cloud0 is 0 on one device; a data-parallel rank passes its
// first row's index in the global batch and draws what one device draws
// for its clouds): draw 0 of a point gives its three
// jitter u1 and its dropout u, draw 1 its three u2, draw 2 of point 0 the
// cloud's angle and dropout ratio. The key is itself a Philox word, at
// counter (step, stream, 0, 0) keyed by the config seed, derived on the
// card from the int64 step count read from device memory: a step neither
// syncs nor launches anything else for its seeds, and no per-step value is
// frozen into a graph. Uniforms use the mantissa trick on unsigned bits,
// as the TPU kernel; products and sums are rounded one by one (no
// contraction) as the plain PyTorch twin rounds them
// (ops/kernels/augment_fused.py).
//
// What bounds it here: a G+D step augments two streams of 32 x 2048
// points, 24 bytes a point in and out, 3.15 MB: 0.94 us at 3.35 TB/s. The
// arithmetic weighs more: two Philox4x32-10 draws (about 200 integer
// instructions), three logs, square roots and cosines (about 250 more) a
// point, some 60 M instructions a step, about 1.8 us of issue on 132 SMs
// at 1.75 GHz; then the chain a block waits on (its loads, the key, the
// draws, the stores) and the launch. The first design launched once per
// stream, and every one of its threads recomputed the step key and its
// cloud's draw (20 Philox rounds, a cos and a sin) before its own two
// draws, redid point 0's whole augmentation in a divergent branch where
// its point dropped, and moved points as three 4-byte scalars.
//
// What the design does about that (augment_pair_kernel):
// * One launch augments both streams of a step: blockIdx.z picks the
//   stream (its x, out, stream id, batch and n ride in AugArgs; the pair
//   entry gives the first stream id 0, the labeled batch, and the second
//   id 1, the unlabeled), so the bench step launches once, not twice. A single stream launches the
//   same kernel with one z; each stream's output is bit for bit what a
//   launch of that stream alone gives.
// * A block owns kAugTile points of one cloud, one a thread, and one more
//   warp, the cloud warp. It derives the stream's key into shared memory;
//   after one barrier every point thread draws its point's bits while the
//   cloud warp's first lane draws the cloud's (c, s, dropout threshold)
//   and, with dropout on, point 0's augmented value, once a block and
//   beside the point draws, not after them; a second barrier publishes
//   them. Rotation and the sum with the noise come after the draws, which
//   changes no bit: each operation is rounded on its own.
// * The block's [tile x 3] floats move between device memory and shared
//   memory by 16-byte loads and stores where both ends are 16-byte
//   aligned (the tile starts on a point index that is a multiple of 4),
//   else by 4-byte ones.
// Measured (H100 80GB HBM3, 700 W; the pair at 2 x 32 x 2048, device us a
// launch, `chip_smoke.py --time bench`): 4.2-4.3, against the first
// design's 5.3-5.7 in two launches. 256 threads of 2 points each, the
// cloud's draw in thread 0 after its own, measured 4.7: two points a
// thread lengthen the issue-bound draws, and the cloud's chain after them
// lengthened every block's wait.

#include "common.cuh"

namespace pointtpu {
namespace {

constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kRotate = 1, kJitter = 2, kDropout = 4;
constexpr int kAugTile = 512;              // points a block, one a thread
constexpr int kAugBlock = kAugTile + 32;   // and the cloud warp

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

// One stream of a launch: x and out [batch, n, 3], its stream id and the
// global index of its first cloud.
struct AugStream {
  const float* x;
  float* out;
  unsigned which, cloud0;
  int batch, n;
};

struct AugArgs {
  AugStream s[2];
  const long long* step;
  unsigned seed;
  int flags;
  float sigma, clip, max_ratio;
};

// Point q of cloud b's draws: its clipped jitter noise and its dropout u
// (1 when no bit is drawn for it).
__device__ __forceinline__ void draw_point(unsigned b, int q, int flags,
                                           float sigma, float clip,
                                           unsigned key, float noise[3],
                                           float& u_drop) {
  u_drop = 1.f;
  if (!(flags & (kJitter | kDropout))) return;
  const Words d0 = philox((unsigned)q, b, 0u, 0u, key, 0u);
  u_drop = uniform(d0.w[3]);
  if (!(flags & kJitter)) return;
  const Words d1 = philox((unsigned)q, b, 1u, 0u, key, 0u);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    noise[j] = fminf(fmaxf(__fmul_rn(sigma, normal(d0.w[j], d1.w[j])), -clip),
                     clip);
}

// v rotated by (c, s) and jittered by noise.
__device__ __forceinline__ void place(float v[3], int flags, float c, float s,
                                      const float noise[3]) {
  if (flags & kRotate) {
    const float x0 = v[0], x2 = v[2];
    v[0] = __fsub_rn(__fmul_rn(c, x0), __fmul_rn(s, x2));
    v[2] = __fadd_rn(__fmul_rn(s, x0), __fmul_rn(c, x2));
  }
  if (flags & kJitter) {
#pragma unroll
    for (int j = 0; j < 3; ++j) v[j] = __fadd_rn(v[j], noise[j]);
  }
}

// count floats from src to dst by the block: 16-byte moves where both are
// 16-byte aligned.
__device__ __forceinline__ void block_copy(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int count) {
  int done = 0;
  if (!((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) &
        15)) {
    const int vecs = count / 4;
    for (int i = threadIdx.x; i < vecs; i += kAugBlock)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    done = 4 * vecs;
  }
  for (int i = done + threadIdx.x; i < count; i += kAugBlock)
    dst[i] = src[i];
}

__global__ void __launch_bounds__(kAugBlock)
augment_pair_kernel(const AugArgs a) {
  const AugStream st = blockIdx.z ? a.s[1] : a.s[0];
  const int b = blockIdx.y, q0 = blockIdx.x * kAugTile;
  if (b >= st.batch || q0 >= st.n) return;   // the other stream's extent
  const unsigned cloud = st.cloud0 + (unsigned)b;   // the counter's word
  const int pts = min(kAugTile, st.n - q0);
  __shared__ __align__(16) float tile[kAugTile * 3];
  __shared__ unsigned key_s;
  __shared__ float cloud_s[6];   // c, s, dropout threshold, point 0
  const size_t base = ((size_t)b * st.n + q0) * 3;
  block_copy(tile, st.x + base, pts * 3);
  const bool cloud_warp = threadIdx.x >= kAugTile;
  if (cloud_warp) {
    const unsigned key = step_key(__ldg(a.step), a.seed, st.which);
    if (threadIdx.x == kAugTile) key_s = key;
  }
  __syncthreads();

  const unsigned key = key_s;
  const int flags = a.flags, p = threadIdx.x;
  float noise[3], u_drop = 1.f;
  if (!cloud_warp) {
    draw_point(cloud, q0 + p, flags, a.sigma, a.clip, key, noise, u_drop);
  } else if (p == kAugTile) {
    const Words draw = philox(0u, cloud, 2u, 0u, key, 0u);
    float c = 1.f, s = 0.f;
    if (flags & kRotate) {
      const float angle = __fmul_rn(uniform(draw.w[0]), kTwoPi);
      c = cosf(angle);
      s = sinf(angle);
    }
    cloud_s[0] = c;
    cloud_s[1] = s;
    if (flags & kDropout) {
      cloud_s[2] = __fmul_rn(uniform(draw.w[1]), a.max_ratio);
      const float* p0 = st.x + (size_t)b * st.n * 3;
      float v[3] = {__ldg(p0), __ldg(p0 + 1), __ldg(p0 + 2)}, n0[3], u0;
      draw_point(cloud, 0, flags, a.sigma, a.clip, key, n0, u0);
      place(v, flags, c, s, n0);
      cloud_s[3] = v[0];
      cloud_s[4] = v[1];
      cloud_s[5] = v[2];
    }
  }
  __syncthreads();

  if (p < pts) {
    float* t = tile + 3 * p;
    float v[3] = {t[0], t[1], t[2]};
    place(v, flags, cloud_s[0], cloud_s[1], noise);
    const bool drop = (flags & kDropout) && u_drop <= cloud_s[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) t[j] = drop ? cloud_s[3 + j] : v[j];
  }
  __syncthreads();
  block_copy(st.out + base, tile, pts * 3);
}

int launch_augment(const AugArgs& a, int streams, int device,
                   cudaStream_t stream) {
  int batch = 0, n = 0;
  for (int i = 0; i < streams; ++i) {
    const AugStream& st = a.s[i];
    if (!st.x || !st.out || st.batch <= 0 || st.batch > 65535 || st.n <= 0)
      return kErrArgs;
    batch = max(batch, st.batch);
    n = max(n, st.n);
  }
  if (!a.step || (a.flags & ~(kRotate | kJitter | kDropout))) return kErrArgs;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kAugTile - 1) / kAugTile, batch, streams);
  augment_pair_kernel<<<grid, kAugBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pointtpu

// out = augment(x [batch, n, 3]) of stream `which` at the int64 step
// count *step, keyed by the config seed, its rows the global clouds
// cloud0 ..; flags: 1 rotate, 2 jitter, 4 dropout.
extern "C" int pt_augment_fused(const float* x, float* out,
                                const long long* step, unsigned seed,
                                unsigned which, unsigned cloud0, int batch,
                                int n, int flags, float sigma, float clip,
                                float max_ratio, int device,
                                cudaStream_t stream) {
  using namespace pointtpu;
  const AugArgs a{{{x, out, which, cloud0, batch, n}, {}}, step, seed, flags,
                  sigma, clip, max_ratio};
  return launch_augment(a, 1, device, stream);
}

// Both streams of a step in one launch: out0 = augment(x0 [batch0, n0, 3])
// of stream 0 and out1 = augment(x1 [batch1, n1, 3]) of stream 1, each as
// pt_augment_fused would give it.
extern "C" int pt_augment_fused_pair(const float* x0, const float* x1,
                                     float* out0, float* out1,
                                     const long long* step, unsigned seed,
                                     unsigned cloud0_0, unsigned cloud0_1,
                                     int batch0, int n0, int batch1, int n1,
                                     int flags, float sigma, float clip,
                                     float max_ratio, int device,
                                     cudaStream_t stream) {
  using namespace pointtpu;
  const AugArgs a{{{x0, out0, 0u, cloud0_0, batch0, n0},
                   {x1, out1, 1u, cloud0_1, batch1, n1}},
                  step, seed, flags, sigma, clip, max_ratio};
  return launch_augment(a, 2, device, stream);
}
