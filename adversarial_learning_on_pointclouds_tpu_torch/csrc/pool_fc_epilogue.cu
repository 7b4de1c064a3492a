// The trunk-exit epilogue: pooled feature -> ReLU -> fc1 -> batch-BN ->
// ReLU (train).
//
// Replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/pool_fc_epilogue.py::
// _make_fwd_kernel (pallas_call at pool_fc_epilogue.py:86), which serves
// pool_fc_epilogue and relu_fc_bn_relu.
//
// Bound: latency. At batch 32 the [32, 1024] x [1024, 512] product is 17
// MFMA and the weight 2 MB; the pass is a few us of work, so what counts
// is one launch and no round trip between the product, the statistics
// and the normalization.
// Design: one kernel. A block owns 8 output channels, one per warp, and
// every row: a lane holds the rows lane, lane + 32, ... in registers, so
// the batch statistics of its channel (per group of batch / groups rows,
// centred on the running mean) are a warp reduction, and the normalize
// and ReLU follow in place. The pooled feature h = relu(sel * s3c + t3)
// is built in shared memory in chunks of 128 channels (row stride 129, so
// lanes reading 32 rows hit 32 banks), the weight row is a broadcast
// read; block 0 also stores h for the backward. Under prec & kRound the
// product takes h and W1 rounded to bf16 (h is stored unrounded).

#include "common.cuh"

namespace pointtpu {

// Mirror of the Python side's ctypes structure (ops/launch.py), field for
// field, as the other training passes take theirs (train_gemm.cuh).
struct PoolFcArgs {
  int batch, c3, c1, groups, prec;  // prec: kRound or 0
  const float* mx;       // [batch, c3] per-cloud max of z3
  const float* mn;       // [batch, c3] per-cloud min of z3
  const float* s3c;      // [c3] BN3 fold: h = relu(sel * s3c + t3)
  const float* t3;
  const float* w1;       // [c1, c3] row-major (PyTorch's [out, in])
  const float* b1;       // [c1]
  const float* g1;       // [c1] BN1 affine
  const float* be1;
  const float* rm1;      // [c1] running mean the moments centre on
  float* h1;             // [batch, c1] relu(bn(z1))
  float* h;              // [batch, c3] pooled feature, for the backward
  float* z1;             // [batch, c1]
  float* mu;             // [groups, c1] per block of batch / groups rows
  float* var;
  float* inv;
};

namespace {

constexpr int kPoolKc = 128;   // pooled channels per shared-memory chunk
constexpr float kBnEps = 1e-5f;

template <int RB>   // rows per lane: batch <= 32 * RB
__global__ void __launch_bounds__(kThreads)
pool_fc_kernel(const PoolFcArgs a) {
  extern __shared__ float h_s[];  // [batch][kPoolKc + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x * kWarps + warp;
  const int batch = a.batch, c3 = a.c3, c1 = a.c1;
  constexpr int kLd = kPoolKc + 1;
  const bool bf = a.prec & kRound;
  float acc[RB] = {};
  for (int k0 = 0; k0 < c3; k0 += kPoolKc) {
    const int kn = min(kPoolKc, c3 - k0);
    __syncthreads();  // the previous chunk is read
    for (int e = threadIdx.x; e < batch * kPoolKc; e += kThreads) {
      const int bb = e / kPoolKc, kk = e - bb * kPoolKc, k = k0 + kk;
      float v = 0.f;
      if (kk < kn) {
        const float s = __ldg(a.s3c + k);
        const float sel = s >= 0.f ? __ldg(a.mx + (size_t)bb * c3 + k)
                                   : __ldg(a.mn + (size_t)bb * c3 + k);
        // rounded as PyTorch's two ops round it (no fused multiply-add)
        v = fmaxf(__fadd_rn(__fmul_rn(sel, s), __ldg(a.t3 + k)), 0.f);
        if (blockIdx.x == 0) a.h[(size_t)bb * c3 + k] = v;
      }
      h_s[bb * kLd + kk] = operand(v, bf);
    }
    __syncthreads();
    if (o < c1) {
      const float* wo = a.w1 + (size_t)o * c3 + k0;
      for (int kk = 0; kk < kn; ++kk) {
        const float wv = operand(__ldg(wo + kk), bf);
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int bb = lane + 32 * j;
          if (bb < batch) acc[j] = fmaf(h_s[bb * kLd + kk], wv, acc[j]);
        }
      }
    }
  }
  if (o >= c1) return;  // warp-uniform, after the last barrier
  const float bias = __ldg(a.b1 + o), rm = __ldg(a.rm1 + o);
  const float gam = __ldg(a.g1 + o), bet = __ldg(a.be1 + o);
  const int bg = batch / a.groups;
#pragma unroll
  for (int j = 0; j < RB; ++j) acc[j] += bias;
  for (int g = 0; g < a.groups; ++g) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int bb = lane + 32 * j;
      if (bb < batch && bb / bg == g) {
        const float zc = acc[j] - rm;
        s += zc;
        q += zc * zc;
      }
    }
    for (int sh = 16; sh; sh >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, sh);
      q += __shfl_xor_sync(0xffffffffu, q, sh);
    }
    const float mu_c = s / bg, m2 = q / bg;
    const float v = fmaxf(m2 - mu_c * mu_c, 0.f);
    const float iv = rsqrtf(v + kBnEps);
    const float m = mu_c + rm;
    if (lane == 0) {
      a.mu[(size_t)g * c1 + o] = m;
      a.var[(size_t)g * c1 + o] = v;
      a.inv[(size_t)g * c1 + o] = iv;
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int bb = lane + 32 * j;
      if (bb < batch && bb / bg == g) {
        a.z1[(size_t)bb * c1 + o] = acc[j];
        a.h1[(size_t)bb * c1 + o] =
            fmaxf((acc[j] - m) * iv * gam + bet, 0.f);
      }
    }
  }
}

template <int RB>
cudaError_t launch_pool_fc(const PoolFcArgs& a, size_t bytes,
                           cudaStream_t stream) {
  cudaError_t e = allow_smem(pool_fc_kernel<RB>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.c1 + kWarps - 1) / kWarps);
  pool_fc_kernel<RB><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pointtpu

// The forward pass (PoolFcArgs above): statistics per block of batch /
// groups rows.
extern "C" int pt_pool_fc_fwd(const pointtpu::PoolFcArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (a->batch <= 0 || a->batch > 32 * 8 || a->c3 <= 0 || a->c1 <= 0 ||
      a->groups <= 0 || a->batch % a->groups)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = (size_t)a->batch * (kPoolKc + 1) * sizeof(float);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  switch ((a->batch + 31) / 32) {
    case 1: return (int)launch_pool_fc<1>(*a, bytes, stream);
    case 2: return (int)launch_pool_fc<2>(*a, bytes, stream);
    case 3: return (int)launch_pool_fc<3>(*a, bytes, stream);
    case 4: return (int)launch_pool_fc<4>(*a, bytes, stream);
    default: return (int)launch_pool_fc<8>(*a, bytes, stream);
  }
}
