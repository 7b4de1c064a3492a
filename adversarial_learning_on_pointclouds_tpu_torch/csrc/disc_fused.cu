// The fused discriminator's passes: the pointwise k -> 64 -> 128 -> 256 ->
// 512 -> 1 stack with LeakyReLU(0.2) after the first four layers, forward
// and backward, over rows of probabilities (or one-hot labels).
//
// Replaces the TPU kernels of
// adversarial_learning_on_pointclouds_tpu/ops/kernels/disc_fused.py:
// _fwd_call (pallas_call at disc_fused.py:101), _bwd_call (:145),
// _bwd_dx_call (:229) and _bwd_dw_call (:339).
//
// Bound: FMAs. A row costs 175,744 multiply-adds through the stack (k = 50),
// 131,072 of them in the 256 -> 512 layer; the forward reads 200 bytes of
// input per row for them (about 1,700 operations per byte), so every pass
// is bound by the fp32 FMA rate, not by device memory.
// Design (train_gemm.cuh's row GEMM): a block of 256 threads owns tiles of
// 64 rows. h1..h3 of a tile live in shared memory (h0 = x, 64 x k; 64, 128
// and 256 wide); every weight streams from L2 through the register-staged
// double buffer, so no weight has to fit a block (W4 alone is 512 KB).
// The 512-wide h4 never exists whole: it is made in 128-column chunks,
// folded straight into the 512 -> 1 dot product (forward) or into dz4 =
// g * w5 * leaky'(h4) and dh3 += dz4 @ W4 (backward). The backward
// recomputes h1..h3 from x, as the TPU kernel does; LeakyReLU' is read
// from the sign of the output. dz3, dz2 and dz1 overwrite h3, h2 and h1 in
// place. The weight gradient of each layer, h_prev^T dz, is added tile by
// tile into the block's own fp32 slot of partial sums (a block owns a
// range of at most 2048 rows, so no atomics), and colsum_kernel adds the
// slots in fp64 in a fixed order: results do not depend on scheduling.
// Rows past m are zero in x and carry a zero cotangent, so they add
// nothing to dW or db and are never stored.
// Mixed precision (prec & kRound): x, h1..h4, the cotangents dz and every
// weight are rounded to bf16 as matmul operands (h1..h3 where they are
// stored in shared memory, dz after its db column sums, which take the
// unrounded values); the sums stay fp32.

#include "train_gemm.cuh"

namespace pointtpu {

// Mirror of the Python side's ctypes structure (ops/launch.py), field for
// field. A null pointer switches its output off.
struct DiscArgs {
  int m, k, per, splits, prec;  // rows, input width, tiles per block,
                                // blocks, kRound or 0
  const float* x;            // [m, k]
  const float* g;            // [m] cotangent of the logits (backward)
  const float* w1;           // [64, k]   row-major (PyTorch's [out, in])
  const float* w2;           // [128, 64]
  const float* w3;           // [256, 128]
  const float* w4;           // [512, 256]
  const float* w5;           // [1, 512]
  const float* b1;
  const float* b2;
  const float* b3;
  const float* b4;
  const float* b5;
  float* logits;             // [m] (forward)
  float* dx;                 // [m, k], or null
  float* part;               // [splits, GradLayout(k).size] scratch, or null
  float* grad;               // [GradLayout(k).size]: dW1..dW5, db1..db5
};

namespace {

constexpr int kD1 = 64, kD2 = 128, kD3 = 256, kD4 = 512;
constexpr int kC4 = 128;        // h4 columns per chunk
constexpr int kMaxK = 64;       // input width the kernel takes
constexpr float kSlope = 0.2f;

// Offsets into a gradient slot: dW1..dW5 as [out, in], then db1..db5.
struct GradLayout {
  long long w[5], b[5], size;
  __host__ __device__ explicit GradLayout(int k) {
    const long long dims[5][2] = {{kD1, k}, {kD2, kD1}, {kD3, kD2},
                                  {kD4, kD3}, {1, kD4}};
    long long at = 0;
    for (int i = 0; i < 5; ++i) { w[i] = at; at += dims[i][0] * dims[i][1]; }
    for (int i = 0; i < 5; ++i) { b[i] = at; at += dims[i][0]; }
    size = at;
  }
};

__device__ __forceinline__ float leaky(float z) {
  return z >= 0.f ? z : __fmul_rn(kSlope, z);
}

__device__ __forceinline__ float dleaky(float h) {  // from the output's sign
  return h >= 0.f ? 1.f : kSlope;
}

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

// part[o * K + k] = (first ? 0 : part[o * K + k]) + sum over the tile's
// rows of a_s[r][k] * d_s[r][o], for k < K, o < O: one layer's dW. Thread
// (tx, ty) of a 16 x 16 grid owns TK x TO outputs at stride 16, so a warp
// reads 16 consecutive words of a_s and broadcasts 2 of d_s.
template <int TK, int TO>
__device__ __forceinline__ void wgrad_tile(float* part, int K, int O,
                                           const float* a_s, int lda,
                                           const float* d_s, int ldd,
                                           bool first) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int o0 = 0; o0 < O; o0 += 16 * TO)
    for (int k0 = 0; k0 < K; k0 += 16 * TK) {
      float acc[TO][TK];
#pragma unroll
      for (int j = 0; j < TO; ++j)
#pragma unroll
        for (int i = 0; i < TK; ++i) {
          const int o = o0 + ty + 16 * j, k = k0 + tx + 16 * i;
          acc[j][i] = (!first && o < O && k < K) ? part[(size_t)o * K + k]
                                                 : 0.f;
        }
      for (int r = 0; r < kTile; ++r) {
        float av[TK], dv[TO];
#pragma unroll
        for (int i = 0; i < TK; ++i) {
          const int k = k0 + tx + 16 * i;
          av[i] = k < K ? a_s[r * lda + k] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < TO; ++j) {
          const int o = o0 + ty + 16 * j;
          dv[j] = o < O ? d_s[r * ldd + o] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < TO; ++j)
#pragma unroll
          for (int i = 0; i < TK; ++i) acc[j][i] = fmaf(dv[j], av[i], acc[j][i]);
      }
#pragma unroll
      for (int j = 0; j < TO; ++j)
#pragma unroll
        for (int i = 0; i < TK; ++i) {
          const int o = o0 + ty + 16 * j, k = k0 + tx + 16 * i;
          if (o < O && k < K) part[(size_t)o * K + k] = acc[j][i];
        }
    }
}

// part[c] (+)= sum over the tile's rows of d_s[r][c], for c < C: a db.
__device__ __forceinline__ void colsum_tile(float* part, int C,
                                            const float* d_s, int ldd,
                                            bool first) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kTile; ++r) s += d_s[r * ldd + c];
    part[c] = first ? s : part[c] + s;
  }
}

inline size_t disc_smem(int k, bool bwd) {
  size_t f = (size_t)kTile * (k + kD1 + kD2 + kD3) + 2 * kStage;
  if (bwd) f += kTile + (size_t)kTile * kC4 + kWarps * kC4;
  return f * sizeof(float);
}

// BWD off: logits. BWD on: the backward from g, with dx (DX) and the dW/db
// partials of the block's slot (DW). BF: bf16 operands (prec & kRound).
// Block s owns tiles [s * per, (s + 1) * per) of 64 rows.
template <bool BWD, bool DX, bool DW, bool BF>
__global__ void __launch_bounds__(kThreads, 1) disc_kernel(const DiscArgs a) {
  extern __shared__ float smem[];
  float* h0 = smem;                          // [kTile][k]
  float* h1 = h0 + kTile * a.k;              // [kTile][64], then dz1
  float* h2 = h1 + kTile * kD1;              // [kTile][128], then dz2
  float* h3 = h2 + kTile * kD2;              // [kTile][256], then dz3
  float* stage = h3 + kTile * kD3;           // 2 staging buffers
  float* g_s = stage + 2 * kStage;           // [kTile] (backward)
  float* dz4 = g_s + kTile;                  // [kTile][kC4] (backward)
  float* red = dz4 + kTile * kC4;            // [kWarps][kC4] (dW)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = ceil_div(a.m, kTile);
  const int t0 = blockIdx.x * a.per, t1 = min(tiles, t0 + a.per);
  const GradLayout lay(a.k);
  float* part = DW ? a.part + (size_t)blockIdx.x * lay.size : nullptr;
  constexpr bool bf = BF;

  for (int t = t0; t < t1; ++t) {
    const size_t g0 = (size_t)t * kTile;
    const int rows = (int)min((long long)kTile, (long long)a.m - (long long)g0);
    const bool first = t == t0;
    __syncthreads();  // the previous tile's shared memory is read
    load_tile(h0, a.k, a.x, false, g0, rows, a.k, 0, a.k, nullptr, nullptr,
              bf);
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
      float sdw5[NJ] = {};
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
            if (DW) sdw5[jj] = fmaf(h, g, sdw5[jj]);
          }
        }
      }
      if constexpr (BWD) {
        if (DW) {
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) red[warp * kC4 + lane + 32 * jj] = sdw5[jj];
        }
        __syncthreads();  // dz4 (and red) complete
        if (DW) {
          for (int c = threadIdx.x; c < kC4; c += kThreads) {
            float s = 0.f;
            for (int w = 0; w < kWarps; ++w) s += red[w * kC4 + c];
            float* at = part + lay.w[4] + oc + c;
            *at = first ? s : *at + s;
          }
          colsum_tile(part + lay.b[3] + oc, kC4, dz4, kC4, first);
        }
        dz_operand(dz4, kTile * kC4, bf);
        if (DW)
          wgrad_tile<8, 8>(part + lay.w[3] + (size_t)oc * kD3, kD3, kC4, h3,
                           kD3, dz4, kC4, first);
        gemm_acc<kD3 / 32, false>(dh3, dz4, kC4, kC4,
                                  a.w4 + (size_t)oc * kD3, kD3, 0, kD3, stage,
                                  bf);
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
      // dz3 -> dW3, db3, dh2 -> dz2 -> dW2, db2, dh1 -> dz1 -> dW1, db1, dx.
      dz_in_place<kD3 / 32>(dh3, h3);
      if (DW) colsum_tile(part + lay.b[2], kD3, h3, kD3, first);
      dz_operand(h3, kTile * kD3, bf);
      if (DW)
        wgrad_tile<8, 8>(part + lay.w[2], kD2, kD3, h2, kD2, h3, kD3, first);
      float dh2[kRows][kD2 / 32] = {};
      gemm_acc<kD2 / 32, false>(dh2, h3, kD3, kD3, a.w3, kD2, 0, kD2, stage,
                                bf);
      dz_in_place<kD2 / 32>(dh2, h2);
      if (DW) colsum_tile(part + lay.b[1], kD2, h2, kD2, first);
      dz_operand(h2, kTile * kD2, bf);
      if (DW)
        wgrad_tile<4, 8>(part + lay.w[1], kD1, kD2, h1, kD1, h2, kD2, first);
      float dh1[kRows][kD1 / 32] = {};
      gemm_acc<kD1 / 32, false>(dh1, h2, kD2, kD2, a.w2, kD1, 0, kD1, stage,
                                bf);
      dz_in_place<kD1 / 32>(dh1, h1);
      if (DW) colsum_tile(part + lay.b[0], kD1, h1, kD1, first);
      dz_operand(h1, kTile * kD1, bf);
      if (DW) {
        wgrad_tile<4, 4>(part + lay.w[0], a.k, kD1, h0, a.k, h1, kD1, first);
        if (threadIdx.x == 0) {
          float s = 0.f;
          for (int r = 0; r < kTile; ++r) s += g_s[r];
          part[lay.b[4]] = first ? s : part[lay.b[4]] + s;
        }
      }
      if (DX) {
        constexpr int NJ = kMaxK / 32;
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
  }
}

template <bool BWD, bool DX, bool DW, bool BF>
int launch_disc_kernel(const DiscArgs& a, size_t bytes, cudaStream_t stream) {
  const int e = (int)allow_smem(disc_kernel<BWD, DX, DW, BF>, bytes);
  if (e) return e;
  disc_kernel<BWD, DX, DW, BF><<<a.splits, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool BWD, bool DX, bool DW>
int launch_disc(const DiscArgs& a, cudaStream_t stream) {
  const size_t bytes = disc_smem(a.k, BWD);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  int e = (a.prec & kRound)
              ? launch_disc_kernel<BWD, DX, DW, true>(a, bytes, stream)
              : launch_disc_kernel<BWD, DX, DW, false>(a, bytes, stream);
  if (e) return e;
  if (!DW) return 0;
  const GradLayout lay(a.k);
  return colsum(a.part, lay.size, a.splits, (int)lay.size, 1, a.grad, 0,
                stream);
}

// Shapes and pointers every pass needs; the per-pass outputs are checked by
// the entry points.
bool disc_args_ok(const DiscArgs& a, bool bwd) {
  if (a.m <= 0 || a.k <= 0 || a.k > kMaxK || a.per <= 0 || !a.x || !a.w1 ||
      !a.w2 || !a.w3 || !a.w4 || !a.w5 || !a.b1 || !a.b2 || !a.b3 || !a.b4 ||
      !a.b5 || (bwd != (a.g != nullptr)))
    return false;
  const int tiles = ceil_div(a.m, kTile);
  return a.splits == ceil_div(tiles, a.per);
}

}  // namespace
}  // namespace pointtpu

using pointtpu::DiscArgs;

// logits = the stack on x.
extern "C" int pt_disc_fwd(const DiscArgs* a, int device,
                           cudaStream_t stream) {
  using namespace pointtpu;
  if (!disc_args_ok(*a, false) || !a->logits || a->dx || a->part) return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : launch_disc<false, false, false>(*a, stream);
}

// dx only: the frozen discriminator of the generator step.
extern "C" int pt_disc_bwd_dx(const DiscArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (!disc_args_ok(*a, true) || !a->dx || a->part || a->logits) return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : launch_disc<true, true, false>(*a, stream);
}

// dW/db, and dx too when a->dx is set (the full backward). A block sums at
// most 2048 rows into its slot.
extern "C" int pt_disc_bwd_dw(const DiscArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (!disc_args_ok(*a, true) || !a->part || !a->grad || a->logits ||
      a->per * kTile > 2048)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  return a->dx ? launch_disc<true, true, true>(*a, stream)
               : launch_disc<true, false, true>(*a, stream);
}
