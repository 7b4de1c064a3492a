// fc_head_train: the T-Net fc head in training, fc1 + batch-BN + ReLU ->
// fc2 + batch-BN + ReLU -> fc3 on the pooled [B, 1024] rows, and the
// backward of its two BN layers.
//
// Replaces the TPU kernels
// adversarial_learning_on_pointclouds_tpu/ops/kernels/fc_head_train.py::
// _fwd_call (pallas_call at fc_head_train.py:112: the whole forward in
// one program, grid ()) and _bwd_call (fc_head_train.py:192: both BN
// layers' backward in one program). fc3's backward (dW3, db3 and the
// cotangent of h2) runs outside, as in the JAX VJP.
//
// What bounds it here: latency. At batch 32 the head is 32 x (1024 x 512
// + 512 x 256 + 256 x k^2) MACs, 0.02-0.55 GFLOP, and its weights 2.5-6.5
// MB; each layer is a few microseconds of work, and a BN couples every
// row of a column, so what counts is few launches and no round trips
// between a product, its batch statistics and the normalization.
//
// What the design does about that: the TPU runs the head as one program
// with everything in VMEM; a card has no such block, so each layer is one
// column-parallel launch: a block owns 8 output channels, one per warp,
// for every row, a lane holding the rows lane, lane + 32, ... in
// registers. A BN's batch moments are then a warp reduction (about the
// running mean, as core.batch_norm), and the normalization, ReLU and the
// stashes follow in place. The input rows stream through shared memory
// in chunks of 128 columns (row stride 129: lanes reading 32 rows hit 32
// banks) and each weight element is a broadcast read. Forward: fc1, fc2,
// fc3, three launches. Backward: layer 2 (its cotangent from fc3's
// backward), layer 1 (its cotangent dz2 @ W2 computed in the block), the
// cotangent of h (dz1 @ W1), three launches; each BN layer's block also
// makes its columns of dW from the previous activation (recomputed from
// its z stash for layer 2) staged through shared memory, a lane per
// input channel, the rows added in order.
//
// Rounding follows the JAX kernels line by line, with no fused
// multiply-add where they round twice: the forward normalizes as (z - mu)
// * (inv * gamma) + beta, the backward recomputes zhat = (z - mu) * inv
// and relu(zhat * gamma + beta) (both as written at fc_head_train.py:98
// and :160). Under mixed precision (prec & kRound) the three forward
// products and dW1/dW2 take bf16 operands (_mxu_dot, _mxu_dot_t); the
// cotangents of h1 and h stay fp32 (_mxu_dot_nt runs at HIGHEST).

#include "common.cuh"

namespace pointtpu {

// Mirror of the Python side's ctypes structure (ops/launch.py). Weights
// are PyTorch's [out, in] row-major storage.
struct FcHeadArgs {
  int batch, c0, c1, c2, c3, prec;  // prec: kRound or 0
  const float* h;                   // [batch, c0]
  const float* w1;                  // [c1, c0]
  const float* b1;
  const float* g1;
  const float* be1;
  const float* rm1;                 // running means the moments centre on
  const float* w2;                  // [c2, c1]
  const float* b2;
  const float* g2;
  const float* be2;
  const float* rm2;
  const float* w3;                  // [c3, c2]
  const float* b3;
  float* out;                       // [batch, c3]
  float* z1;                        // [batch, c1] stash
  float* z2;                        // [batch, c2] stash
  float* mu1;                       // [c1] batch mean, biased variance,
  float* var1;                      //   1 / sqrt(var + eps)
  float* inv1;
  float* mu2;                       // [c2]
  float* var2;
  float* inv2;
  float* h1;                        // [batch, c1] forward scratch
  float* h2;                        // [batch, c2] forward scratch
  const float* dh2;                 // [batch, c2] cotangent of h2 (backward)
  float* dh;                        // [batch, c0]
  float* dw1;                       // [c1, c0]
  float* db1;
  float* dg1;
  float* dbe1;
  float* dw2;                       // [c2, c1]
  float* db2;
  float* dg2;
  float* dbe2;
  float* dz1;                       // [batch, c1] backward scratch
  float* dz2;                       // [batch, c2] backward scratch
};

namespace {

constexpr int kKc = 128, kLd = kKc + 1;   // staged columns, row stride
constexpr float kBnEps = 1e-5f;

__device__ __forceinline__ float lane_sum(float v) {
  for (int s = 16; s; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// One fc layer, column-parallel.
struct Layer {
  int batch, k, cols;
  bool round;            // bf16 operands for the product
  const float* x;        // [batch, k] input rows
  const float* w;        // W(o, kk) = w[o * wso + kk * wsk]
  long long wso, wsk;
  const float* bias;     // [cols], or null
  const float* rm;       // BN (null: an affine layer, z is its output)
  const float* g;
  const float* be;
  float* z;              // [batch, cols]
  float* h;              // [batch, cols] relu(bn(z))
  float* mu;
  float* var;
  float* inv;
};

// The backward of one BN layer (h = relu(bn(z)), z = p @ W^T + b).
struct BnBwd {
  int batch, k, cols, cin;
  bool round;            // bf16 operands for dW
  const float* dh;       // [batch, cols] cotangent of h, or null: it is
  const float* x;        //   x @ W(o, :) over k, fp32
  const float* w;
  long long wso, wsk;
  const float* z;        // this BN: stash and statistics
  const float* mu;
  const float* inv;
  const float* g;
  const float* be;
  const float* p;        // [batch, cin] the layer's input, or null: it is
  const float* pz;       //   relu(bn(pz)) of the previous BN, recomputed
  const float* pmu;
  const float* pinv;
  const float* pg;
  const float* pbe;
  float* dz;             // [batch, cols]
  float* dg;
  float* dbe;
  float* db;
  float* dw;             // [cols, cin]
};

// acc[j] += sum over kk of x[lane + 32 j][kk] * W(o, kk), the rows staged
// through xs. Every thread of the block calls it (it has barriers).
template <int RB>
__device__ __forceinline__ void layer_product(float (&acc)[RB],
                                              const float* __restrict__ x,
                                              int batch, int k,
                                              const float* __restrict__ w,
                                              long long wso, long long wsk,
                                              int o, bool ok, bool bf,
                                              float* xs) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < k; k0 += kKc) {
    const int kn = min(kKc, k - k0);
    __syncthreads();  // the previous chunk is read
    for (int e = threadIdx.x; e < batch * kKc; e += kThreads) {
      const int bb = e / kKc, kk = e - bb * kKc;
      xs[bb * kLd + kk] =
          kk < kn ? operand(__ldg(x + (size_t)bb * k + k0 + kk), bf) : 0.f;
    }
    __syncthreads();
    if (ok) {
      const float* wo = w + o * wso + k0 * wsk;
      for (int kk = 0; kk < kn; ++kk) {
        const float wv = operand(__ldg(wo + kk * wsk), bf);
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int bb = lane + 32 * j;
          if (bb < batch) acc[j] = fmaf(xs[bb * kLd + kk], wv, acc[j]);
        }
      }
    }
  }
}

template <int RB>
__global__ void __launch_bounds__(kThreads) fc_layer_kernel(const Layer L) {
  extern __shared__ float xs[];  // [batch][kLd]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x * kWarps + warp;
  const bool ok = o < L.cols;
  float acc[RB] = {};
  layer_product<RB>(acc, L.x, L.batch, L.k, L.w, L.wso, L.wsk, o, ok,
                    L.round, xs);
  if (!ok) return;  // warp-uniform, after the last barrier
  if (L.bias) {
    const float bias = __ldg(L.bias + o);
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[j] += bias;
  }
  if (!L.g) {
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int bb = lane + 32 * j;
      if (bb < L.batch) L.z[(size_t)bb * L.cols + o] = acc[j];
    }
    return;
  }
  const float rm = __ldg(L.rm + o);
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    const int bb = lane + 32 * j;
    if (bb < L.batch) {
      const float zc = acc[j] - rm;
      s += zc;
      q += __fmul_rn(zc, zc);
    }
  }
  s = lane_sum(s);
  q = lane_sum(q);
  const float mu_c = s / L.batch, m2 = q / L.batch;
  const float var = fmaxf(__fsub_rn(m2, __fmul_rn(mu_c, mu_c)), 0.f);
  const float inv = rsqrtf(var + kBnEps);
  const float mu = mu_c + rm;
  if (lane == 0) {
    L.mu[o] = mu;
    L.var[o] = var;
    L.inv[o] = inv;
  }
  const float t = __fmul_rn(inv, __ldg(L.g + o)), be = __ldg(L.be + o);
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    const int bb = lane + 32 * j;
    if (bb >= L.batch) continue;
    L.z[(size_t)bb * L.cols + o] = acc[j];
    L.h[(size_t)bb * L.cols + o] =
        fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(acc[j], mu), t), be), 0.f);
  }
}

template <int RB>
__global__ void __launch_bounds__(kThreads) fc_bn_bwd_kernel(const BnBwd L) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [batch][kLd]
  float* dzs = xs + L.batch * kLd;     // [kWarps][batch] dz, as dW's operand
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x * kWarps + warp;
  const bool ok = o < L.cols;
  float dh[RB] = {};
  if (!L.dh)
    layer_product<RB>(dh, L.x, L.batch, L.k, L.w, L.wso, L.wsk, o, ok, false,
                      xs);
  if (ok) {
    const float mu = __ldg(L.mu + o), inv = __ldg(L.inv + o);
    const float g = __ldg(L.g + o), be = __ldg(L.be + o);
    float zh[RB], dy[RB];
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int bb = lane + 32 * j;
      zh[j] = dy[j] = 0.f;
      if (bb >= L.batch) continue;
      const size_t at = (size_t)bb * L.cols + o;
      if (L.dh) dh[j] = __ldg(L.dh + at);
      zh[j] = __fmul_rn(__fsub_rn(__ldg(L.z + at), mu), inv);
      const float hv = fmaxf(__fadd_rn(__fmul_rn(zh[j], g), be), 0.f);
      dy[j] = hv > 0.f ? dh[j] : 0.f;
      t1 += dy[j];
      t2 += __fmul_rn(dy[j], zh[j]);
    }
    t1 = lane_sum(t1);
    t2 = lane_sum(t2);
    const float gi = __fmul_rn(g, inv);
    const float a1 = t1 / L.batch, a2 = t2 / L.batch;
    float db = 0.f;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int bb = lane + 32 * j;
      if (bb >= L.batch) continue;
      const float dz =
          __fmul_rn(gi, __fsub_rn(__fsub_rn(dy[j], a1), __fmul_rn(zh[j], a2)));
      L.dz[(size_t)bb * L.cols + o] = dz;
      db += dz;
      dzs[warp * L.batch + bb] = operand(dz, L.round);
    }
    db = lane_sum(db);
    if (lane == 0) {
      L.dg[o] = t2;
      L.dbe[o] = t1;
      L.db[o] = db;
    }
  }
  // dW[o][i] = sum over rows of p[row][i] * dz[row][o], lane per i.
  for (int k0 = 0; k0 < L.cin; k0 += kKc) {
    const int kn = min(kKc, L.cin - k0);
    __syncthreads();  // dzs is written; the previous chunk is read
    for (int e = threadIdx.x; e < L.batch * kKc; e += kThreads) {
      const int bb = e / kKc, kk = e - bb * kKc, i = k0 + kk;
      float v = 0.f;
      if (kk < kn) {
        const size_t at = (size_t)bb * L.cin + i;
        if (L.p) {
          v = __ldg(L.p + at);
        } else {
          const float zh = __fmul_rn(__fsub_rn(__ldg(L.pz + at),
                                               __ldg(L.pmu + i)),
                                     __ldg(L.pinv + i));
          v = fmaxf(__fadd_rn(__fmul_rn(zh, __ldg(L.pg + i)), __ldg(L.pbe + i)),
                    0.f);
        }
      }
      xs[bb * kLd + kk] = operand(v, L.round);
    }
    __syncthreads();
    if (!ok) continue;
    for (int c = lane; c < kn; c += 32) {
      float s = 0.f;
      for (int bb = 0; bb < L.batch; ++bb)
        s = fmaf(xs[bb * kLd + c], dzs[warp * L.batch + bb], s);
      L.dw[(size_t)o * L.cin + k0 + c] = s;
    }
  }
}

template <int RB>
int launch_layer(const Layer& L, cudaStream_t stream) {
  const size_t bytes = (size_t)L.batch * kLd * sizeof(float);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  cudaError_t e = allow_smem(fc_layer_kernel<RB>, bytes);
  if (e != cudaSuccess) return (int)e;
  fc_layer_kernel<RB><<<(L.cols + kWarps - 1) / kWarps, kThreads, bytes,
                        stream>>>(L);
  return (int)cudaGetLastError();
}

template <int RB>
int launch_bwd(const BnBwd& L, cudaStream_t stream) {
  const size_t bytes = ((size_t)L.batch * kLd + kWarps * L.batch) *
                       sizeof(float);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  cudaError_t e = allow_smem(fc_bn_bwd_kernel<RB>, bytes);
  if (e != cudaSuccess) return (int)e;
  fc_bn_bwd_kernel<RB><<<(L.cols + kWarps - 1) / kWarps, kThreads, bytes,
                         stream>>>(L);
  return (int)cudaGetLastError();
}

// Rows per lane: 1, 2, 4 or 8 (batch <= 256).
int rows_case(int batch) {
  const int lanes = (batch + 31) / 32;
  return lanes <= 1 ? 1 : lanes <= 2 ? 2 : lanes <= 4 ? 4 : 8;
}

int run(const Layer& L, cudaStream_t stream) {
  switch (rows_case(L.batch)) {
    case 1: return launch_layer<1>(L, stream);
    case 2: return launch_layer<2>(L, stream);
    case 4: return launch_layer<4>(L, stream);
    default: return launch_layer<8>(L, stream);
  }
}

int run(const BnBwd& L, cudaStream_t stream) {
  switch (rows_case(L.batch)) {
    case 1: return launch_bwd<1>(L, stream);
    case 2: return launch_bwd<2>(L, stream);
    case 4: return launch_bwd<4>(L, stream);
    default: return launch_bwd<8>(L, stream);
  }
}

bool bad(const FcHeadArgs* a) {
  return a->batch <= 0 || a->batch > 256 || a->c0 <= 0 || a->c1 <= 0 ||
         a->c2 <= 0 || a->c3 <= 0 || !a->h || !a->w1 || !a->w2 || !a->g1 ||
         !a->be1 || !a->g2 || !a->be2 || !a->z1 || !a->z2 || !a->mu1 ||
         !a->inv1 || !a->mu2 || !a->inv2;
}

}  // namespace
}  // namespace pointtpu

// The forward (FcHeadArgs' first block of outputs): three launches.
extern "C" int pt_fc_head_fwd(const pointtpu::FcHeadArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->b1 || !a->rm1 || !a->b2 || !a->rm2 || !a->w3 || !a->b3 ||
      !a->out || !a->var1 || !a->var2 || !a->h1 || !a->h2)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const bool bf = a->prec & kRound;
  Layer f1{a->batch, a->c0, a->c1, bf, a->h, a->w1, a->c0, 1, a->b1, a->rm1,
           a->g1, a->be1, a->z1, a->h1, a->mu1, a->var1, a->inv1};
  Layer f2{a->batch, a->c1, a->c2, bf, a->h1, a->w2, a->c1, 1, a->b2, a->rm2,
           a->g2, a->be2, a->z2, a->h2, a->mu2, a->var2, a->inv2};
  Layer f3{a->batch, a->c2, a->c3, bf, a->h2, a->w3, a->c2, 1, a->b3,
           nullptr, nullptr, nullptr, a->out, nullptr, nullptr, nullptr,
           nullptr};
  int s;
  if ((s = run(f1, stream))) return s;
  if ((s = run(f2, stream))) return s;
  return run(f3, stream);
}

// The backward of both BN layers from dh2 (FcHeadArgs' second block):
// three launches.
extern "C" int pt_fc_head_bwd(const pointtpu::FcHeadArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->dh2 || !a->dh || !a->dw1 || !a->db1 || !a->dg1 ||
      !a->dbe1 || !a->dw2 || !a->db2 || !a->dg2 || !a->dbe2 || !a->dz1 ||
      !a->dz2)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const bool bf = a->prec & kRound;
  BnBwd b2{a->batch, 0, a->c2, a->c1, bf, a->dh2, nullptr, nullptr, 0, 0,
           a->z2, a->mu2, a->inv2, a->g2, a->be2, nullptr, a->z1, a->mu1,
           a->inv1, a->g1, a->be1, a->dz2, a->dg2, a->dbe2, a->db2, a->dw2};
  BnBwd b1{a->batch, a->c2, a->c1, a->c0, bf, nullptr, a->dz2, a->w2, 1,
           a->c1, a->z1, a->mu1, a->inv1, a->g1, a->be1, a->h, nullptr,
           nullptr, nullptr, nullptr, nullptr, a->dz1, a->dg1, a->dbe1,
           a->db1, a->dw1};
  Layer dh{a->batch, a->c1, a->c0, false, a->dz1, a->w1, 1, a->c0, nullptr,
           nullptr, nullptr, nullptr, a->dh, nullptr, nullptr, nullptr,
           nullptr};
  int s;
  if ((s = run(b2, stream))) return s;
  if ((s = run(b1, stream))) return s;
  return run(dh, stream);
}
