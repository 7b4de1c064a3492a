// The fused discriminator's forward and input-gradient passes: the
// pointwise k -> 64 -> 128 -> 256 -> 512 -> 1 stack with LeakyReLU(0.2)
// after the first four layers, over rows of probabilities (or one-hot
// labels). Its weight-gradient pass (and the full backward, the same
// entry point with dx) runs on the tensor cores: disc_tc.cu.
//
// Replaces the TPU kernels of
// adversarial_learning_on_pointclouds_tpu/ops/kernels/disc_fused.py:
// _fwd_call (pallas_call at disc_fused.py:101) and _bwd_dx_call (:229).
//
// Bound: FMAs. A row costs 175,744 multiply-adds through the stack (k = 50),
// 131,072 of them in the 256 -> 512 layer; the forward reads 200 bytes of
// input per row for them (about 1,700 operations per byte), so both
// passes are bound by the fp32 FMA rate, not by device memory.
// Design (train_gemm.cuh's row GEMM): a block of 256 threads owns a tile
// of 64 rows. h1..h3 of a tile live in shared memory (h0 = x, 64 x k; 64,
// 128 and 256 wide); every weight streams from L2 through the
// register-staged double buffer, so no weight has to fit a block (W4
// alone is 512 KB). The 512-wide h4 never exists whole: it is made in
// 128-column chunks, folded straight into the 512 -> 1 dot product
// (forward) or into dz4 = g * w5 * leaky'(h4) and dh3 += dz4 @ W4
// (backward). The backward recomputes h1..h3 from x, as the TPU kernel
// does; LeakyReLU' is read from the sign of the output. dz3, dz2 and dz1
// overwrite h3, h2 and h1 in place. Rows past m are zero in x and carry a
// zero cotangent, and are never stored.
// Mixed precision (prec & kRound): x, h1..h4, the cotangents dz and every
// weight are rounded to bf16 as matmul operands (h1..h3 where they are
// stored in shared memory, dz before its products); the sums stay fp32.

#include "disc_fused.cuh"
#include "train_gemm.cuh"

namespace pointtpu {
namespace {

constexpr int kC4 = 128;        // h4 columns per chunk

// out_s [kTile][NJ * 32] = leaky(in_s @ W^T + b) for W [NJ * 32, c_in],
// stored as the next matmul's operand.
template <int NJ>
__device__ __forceinline__ void dense_leaky(const float* in_s, int c_in,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            float* out_s, float* stage,
                                            bool bf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kRows][NJ] = {};
  gemm_acc<NJ, true>(acc, in_s, c_in, c_in, w, c_in, 0, NJ * 32, stage, bf);
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int o = lane + 32 * jj;
    const float bias = __ldg(b + o);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      out_s[(warp + i * kWarps) * (NJ * 32) + o] =
          operand(leaky(__fadd_rn(acc[i][jj], bias)), bf);
  }
}

// Under bf, the cotangent tile d_s rounded in place to the bf16 operand
// of the products after its column sums (barriers on both sides).
__device__ __forceinline__ void dz_operand(float* d_s, int count, bool bf) {
  if (!bf) return;
  __syncthreads();
  round_smem(d_s, count);
  __syncthreads();
}

// dz_s = dh * leaky'(h_s), in place over h_s [kTile][NJ * 32].
template <int NJ>
__device__ __forceinline__ void dz_in_place(const float (&dh)[kRows][NJ],
                                            float* h_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // every earlier reader of h_s is done
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float* at = h_s + (warp + i * kWarps) * (NJ * 32) + lane + 32 * jj;
      *at = dh[i][jj] * dleaky(*at);
    }
  __syncthreads();
}

inline size_t disc_smem(int k, bool bwd) {
  size_t f = (size_t)kTile * (k + kD1 + kD2 + kD3) + 2 * kStage;
  if (bwd) f += kTile + (size_t)kTile * kC4;
  return f * sizeof(float);
}

// BWD off: logits. BWD on: dx from g. BF: bf16 operands (prec & kRound).
// Block t owns rows [64 t, 64 t + 64).
template <bool BWD, bool BF>
__global__ void __launch_bounds__(kThreads, 1) disc_kernel(const DiscArgs a) {
  extern __shared__ float smem[];
  float* h0 = smem;                          // [kTile][k]
  float* h1 = h0 + kTile * a.k;              // [kTile][64], then dz1
  float* h2 = h1 + kTile * kD1;              // [kTile][128], then dz2
  float* h3 = h2 + kTile * kD2;              // [kTile][256], then dz3
  float* stage = h3 + kTile * kD3;           // 2 staging buffers
  float* g_s = stage + 2 * kStage;           // [kTile] (backward)
  float* dz4 = g_s + kTile;                  // [kTile][kC4] (backward)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr bool bf = BF;
  const size_t g0 = (size_t)blockIdx.x * kTile;
  const int rows = (int)min((long long)kTile, (long long)a.m - (long long)g0);

  load_tile(h0, a.k, a.x, false, g0, rows, a.k, 0, a.k, nullptr, nullptr, bf);
  if (BWD && threadIdx.x < kTile)
    g_s[threadIdx.x] = threadIdx.x < rows ? __ldg(a.g + g0 + threadIdx.x) : 0.f;
  dense_leaky<kD1 / 32>(h0, a.k, a.w1, a.b1, h1, stage, bf);
  dense_leaky<kD2 / 32>(h1, kD1, a.w2, a.b2, h2, stage, bf);
  dense_leaky<kD3 / 32>(h2, kD2, a.w3, a.b3, h3, stage, bf);

  // Layer 4 in 128-column chunks, folded into layer 5 (forward) or into
  // dz4 and dh3 = dz4 @ W4 (backward).
  float lsum[kRows] = {};
  float dh3[kRows][kD3 / 32] = {};
  for (int oc = 0; oc < kD4; oc += kC4) {
    constexpr int NJ = kC4 / 32;
    float acc[kRows][NJ] = {};
    gemm_acc<NJ, true>(acc, h3, kD3, kD3, a.w4, kD3, oc, kC4, stage, bf);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = lane + 32 * jj;
      const float bias = __ldg(a.b4 + oc + c);
      const float w5 = operand(__ldg(a.w5 + oc + c), bf);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float h = operand(leaky(__fadd_rn(acc[i][jj], bias)), bf);
        if constexpr (!BWD) {
          lsum[i] = fmaf(h, w5, lsum[i]);
        } else {
          const int r = warp + i * kWarps;
          const float g = operand(g_s[r], bf);
          dz4[r * kC4 + c] = (g * w5) * dleaky(h);
        }
      }
    }
    if constexpr (BWD) {
      __syncthreads();  // dz4 complete
      dz_operand(dz4, kTile * kC4, bf);
      gemm_acc<kD3 / 32, false>(dh3, dz4, kC4, kC4, a.w4 + (size_t)oc * kD3,
                                kD3, 0, kD3, stage, bf);
    }
  }
  if constexpr (!BWD) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float s = warp_sum(lsum[i]);
      const int r = warp + i * kWarps;
      if (lane == 0 && r < rows) a.logits[g0 + r] = __fadd_rn(s, __ldg(a.b5));
    }
  } else {
    // dz3 -> dh2 -> dz2 -> dh1 -> dz1 -> dx.
    dz_in_place<kD3 / 32>(dh3, h3);
    dz_operand(h3, kTile * kD3, bf);
    float dh2[kRows][kD2 / 32] = {};
    gemm_acc<kD2 / 32, false>(dh2, h3, kD3, kD3, a.w3, kD2, 0, kD2, stage, bf);
    dz_in_place<kD2 / 32>(dh2, h2);
    dz_operand(h2, kTile * kD2, bf);
    float dh1[kRows][kD1 / 32] = {};
    gemm_acc<kD1 / 32, false>(dh1, h2, kD2, kD2, a.w2, kD1, 0, kD1, stage, bf);
    dz_in_place<kD1 / 32>(dh1, h1);
    dz_operand(h1, kTile * kD1, bf);
    constexpr int NJ = kDiscMaxK / 32;
    float acc[kRows][NJ] = {};
    gemm_acc<NJ, false>(acc, h1, kD1, kD1, a.w1, a.k, 0, a.k, stage, bf);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int o = lane + 32 * jj;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = warp + i * kWarps;
        if (r < rows && o < a.k) a.dx[(g0 + r) * a.k + o] = acc[i][jj];
      }
    }
  }
}

template <bool BWD>
int launch_disc(const DiscArgs& a, cudaStream_t stream) {
  const size_t bytes = disc_smem(a.k, BWD);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  const auto kernel = (a.prec & kRound) ? disc_kernel<BWD, true>
                                        : disc_kernel<BWD, false>;
  const int e = (int)allow_smem(kernel, bytes);
  if (e) return e;
  kernel<<<ceil_div(a.m, kTile), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Shapes and pointers both passes need, and no bwd_dw scratch; the
// per-pass outputs are checked by the entry points.
bool disc_args_ok(const DiscArgs& a, bool bwd) {
  return a.m > 0 && a.k > 0 && a.k <= kDiscMaxK && a.x && a.w1 && a.w2 &&
         a.w3 && a.w4 && a.w5 && a.b1 && a.b2 && a.b3 && a.b4 && a.b5 &&
         bwd == (a.g != nullptr) && !a.grad && !a.part && !a.dzs && !a.hs &&
         !a.part_w;
}

}  // namespace
}  // namespace pointtpu

using pointtpu::DiscArgs;

// logits = the stack on x.
extern "C" int pt_disc_fwd(const DiscArgs* a, int device,
                           cudaStream_t stream) {
  using namespace pointtpu;
  if (!disc_args_ok(*a, false) || !a->logits || a->dx) return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : launch_disc<false>(*a, stream);
}

// dx only: the frozen discriminator of the generator step.
extern "C" int pt_disc_bwd_dx(const DiscArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (!disc_args_ok(*a, true) || !a->dx || a->logits) return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : launch_disc<true>(*a, stream);
}

// dW/db, and dx too when a->dx is set (the full backward), on the tensor
// cores (disc_tc.cu).
extern "C" int pt_disc_bwd_dw(const DiscArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  return disc_dw_tc(*a, stream);
}
