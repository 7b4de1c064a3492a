// The GEMM core under pointwise_matmul.cu and tnet_apply.cu: the MXU
// products of the TPU kernels
// adversarial_learning_on_pointclouds_tpu/ops/kernels/shared_mlp.py::
// _mm_call and _dwdb_call (pallas_call at shared_mlp.py:123, :160) and
// tnet_apply.py::_apply_call and _dt_kernel (tnet_apply.py:32, :74).
//
// What bounds it on the H100: the wide layers (128 -> 1024, 512 -> 256
// over 80,000-240,000 rows) do 20-60 GFLOP a product, past the 67
// TFLOP/s of fp32 FMA; the narrow ones (c = 3-64, k = 64) are bound by
// device-memory traffic. fp32 passes have to stay fp32-accurate (the
// JAX kernels pin HIGHEST), which the tensor cores' TF32 alone is not.
//
// What the design does about that:
//
// * Tensor cores. A block of 8 warps owns a 128 x BN tile of C (BN = 128,
//   or 64 / 32 for n <= 64 / 32: a head, a dW over c_in); each warp a
//   (128 / (8 / (BN / 32))) x 32 piece of mma.sync tiles, m16n8k8 (tf32)
//   or m16n8k16 (bf16), fp32 accumulators. 128 registers a thread and
//   108 KB of shared memory let two blocks share an SM, so one block's
//   loads and stores overlap the other's products. The n tiles of one
//   row of blocks are adjacent in the launch order: the blocks that read
//   the same A tile run together and find it in L2.
// * fp32 as 3xTF32: v = hi + lo, hi = cvt.rna.tf32(v), lo =
//   cvt.rna.tf32(v - hi); per 8-deep k step each tile sums a_lo * b_hi,
//   a_hi * b_lo, then a_hi * b_hi (small terms first) on the tensor core
//   from zero, and that step's sum is added to the fp32 accumulator with
//   an ordinary round-to-nearest FADD: the tensor core's accumulation
//   does not round to nearest, so no long sum stays inside it. dW sums up
//   to 240,000 rows this way.
// * Streaming kernels where the tensor cores buy nothing. The split drops
//   a_lo * b_lo and up to a bit of lo (about 2^-22 of each product), which
//   a deep sum averages away but a product of depth 1-3 does not (5x
//   cuBLAS's fp32 error at depth 1): depth k <= kThinK (the first layer's
//   forward at c_in = 3, the classifier's dx at c_out = 1, the 3 x 3
//   T-Net transform) takes thin_kernel, fp32 FMA with 4 columns a thread.
//   Width n <= kThinN over a K-major A (the 512 -> 1 classifier) takes
//   gemv_kernel, a warp per row whose lanes' sums add pairwise: a
//   sequential sum of 64 k steps there came to 1.9x cuBLAS's error on
//   the H100.
//   All of these are bound by memory.
// * bf16 (mixed precision: the forward and dx, and the dW of the
//   generator's backward passes, train_bwd_tc.cu): both operands rounded
//   to bf16 nearest-even as the fragments load (where the JAX package's
//   _mxu_dot casts), one m16n8k16 per k16 step, summed on the tensor core.
// * Operand ring. k streams in chunks of 32 through a 3-stage ring in
//   dynamic shared memory, filled by cp.async while the previous chunks
//   compute. Each operand keeps its device-memory layout (the contiguous
//   axis contiguous in shared memory, padded by 4 or 8 floats so every
//   fragment load of a warp hits 32 distinct banks); copies are 16 bytes
//   where the view's strides and base allow, else 4 bytes (x at c_in = 3,
//   rows of 50); ragged rows, columns and k load as zero (src-size 0).
//   The stage layouts, the copies and the mma.sync steps are mma.cuh's,
//   shared with the backward passes.
// * Epilogue: the bias, then a masked store, two floats at a time where
//   the row stride allows.

#include "mma.cuh"
#include "strided_gemm.cuh"

namespace pointtpu {
namespace {

constexpr int kBm = 128, kStages = 3;

template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kWarpsM = kWarps / kWarpsN;
  static constexpr int kMt = kBm / kWarpsM / 16;      // m16 tiles a warp
  static constexpr int kA = stage_floats(kBm), kB = stage_floats(BN);
  static constexpr size_t kSmem = (size_t)kStages * (kA + kB) * sizeof(float);
};

int tile_n(int n) { return n > 64 ? 128 : n > 32 ? 64 : 32; }

// One k chunk of the warp's tiles (mma.cuh: mma_step).
template <int BN, bool AK, bool BK, bool BF>
__device__ __forceinline__ void mma_chunk(float (&acc)[Tile<BN>::kMt][4][4],
                                          const float* as, const float* bs,
                                          int mb, int nb, int g, int t) {
  const auto fa = [as](int m, int k) { return stage_at<AK, kBm>(as, m, k); };
  const auto fb = [bs](int n, int k) { return stage_at<BK, BN>(bs, n, k); };
#pragma unroll
  for (int kk = 0; kk < kBk; kk += mma_depth(BF))
    mma_step<Tile<BN>::kMt, 4, BF>(acc, fa, fb, mb, nb, kk, g, t);
}

// vec bit 1: A by 16-byte copies, 2: B, 4: C by float2 stores.
template <int BN, bool AK, bool BK, bool BF>
__global__ void __launch_bounds__(kThreads, 2)
    tc_gemm_kernel(const Gemm g, const int vec) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = smem + kStages * T::kA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mb = (warp / T::kWarpsN) * (kBm / T::kWarpsM);
  const int nb = (warp % T::kWarpsN) * 32;
  const int nt = (int)cdiv(g.n, BN);     // n tiles run fastest: the
  const long long m0 = (long long)(blockIdx.x / nt) * kBm;   // blocks of
  const int n0 = (int)(blockIdx.x % nt) * BN;   // one A tile share it in L2
  const int bz = blockIdx.z / g.splits, s = blockIdx.z - bz * g.splits;
  const int kper = (int)cdiv(cdiv(g.k, g.splits), kBk) * kBk;
  const int k_beg = (int)min((long long)g.k, (long long)s * kper);
  const int k_end = min(g.k, k_beg + kper);
  const float* A = g.a + bz * g.bsa;
  const float* B = g.b + bz * g.bsb;
  const int m_lim = (int)min((long long)kBm, g.m - m0);
  const int n_lim = min(BN, g.n - n0);
  const int chunks = (int)cdiv(k_end - k_beg, kBk);

  // g.asum: each block of the first n tile also sums its A rows over its
  // k range (thread t: row t % 128, half t / 128 of each chunk).
  const bool rowsum = g.asum && n0 == 0;
  float rs = 0.f;
  auto load = [&](int c) {
    const int k0 = k_beg + c * kBk, st = c % kStages;
    load_stage<AK, kBm>(as + st * T::kA, A, g.sam, g.sak, m0, m_lim, k0,
                       k_end - k0, vec & 1);
    load_stage<BK, BN>(bs + st * T::kB, B, g.sbn, g.sbk, n0, n_lim, k0,
                      k_end - k0, vec & 2);
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load(c);
    cp_commit();
  }
  float acc[T::kMt][4][4] = {};
  for (int c = 0; c < chunks; ++c) {
    cp_wait<kStages - 2>();
    __syncthreads();          // chunk c landed; chunk c - 1's stage is free
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    cp_commit();
    const int st = c % kStages;
    if (rowsum) {
      const int r = threadIdx.x % kBm, k0 = (threadIdx.x / kBm) * (kBk / 2);
#pragma unroll
      for (int k = 0; k < kBk / 2; ++k)
        rs += stage_at<AK, kBm>(as + st * T::kA, r, k0 + k);
    }
    mma_chunk<BN, AK, BK, BF>(acc, as + st * T::kA, bs + st * T::kB, mb, nb,
                              gq, tq);
  }
  cp_wait<0>();
  if (rowsum) {     // the two halves added in order: fp32 within the range
    __syncthreads();
    smem[threadIdx.x] = rs;
    __syncthreads();
    const long long m = m0 + threadIdx.x;
    if (threadIdx.x < kBm && m < g.m)
      g.asum[blockIdx.z * g.m + m] = smem[threadIdx.x] +
                                     smem[threadIdx.x + kBm];
  }

  float* C = g.c + blockIdx.z * g.bsc;
#pragma unroll
  for (int i = 0; i < T::kMt; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + mb + 16 * i + gq + 8 * h;
      if (m >= g.m) continue;
      float* row = C + m * g.ldc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + nb + 8 * j + 2 * tq;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (g.bias) {
          if (n < g.n) v0 += __ldg(g.bias + n);
          if (n + 1 < g.n) v1 += __ldg(g.bias + n + 1);
        }
        if ((vec & 4) && n + 1 < g.n) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          if (n < g.n) row[n] = v0;
          if (n + 1 < g.n) row[n + 1] = v1;
        }
      }
    }
}

// The streaming kernel for depth k <= kThinK (no split): each thread
// computes 4 consecutive columns of a row, stored as one float4 where the
// row stride allows, so the stores coalesce; B's k x 256 columns sit in
// shared memory, A's rows come through L1.
constexpr int kThinCols = 256, kThinElems = 4096;

template <bool BF>
__global__ void __launch_bounds__(kThreads)
    thin_kernel(const Gemm g, const int rows_per_block, const bool vec) {
  __shared__ __align__(16) float bsm[kThinK][kThinCols];
  const int n0 = blockIdx.y * kThinCols, cols = min(kThinCols, g.n - n0);
  const float* A = g.a + blockIdx.z * g.bsa;
  const float* B = g.b + blockIdx.z * g.bsb;
  for (int e = threadIdx.x; e < g.k * cols; e += kThreads) {
    const int k = e / cols, c = e - k * cols;
    bsm[k][c] = operand(__ldg(B + k * g.sbk + (n0 + c) * g.sbn), BF);
  }
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, g.m - r0);
  const int quads = (cols + 3) / 4;
  float* C = g.c + blockIdx.z * g.bsc;
  for (int q = threadIdx.x; q < rows * quads; q += kThreads) {
    const int r = q / quads, c = (q - r * quads) * 4;
    const float* a = A + (r0 + r) * g.sam;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < g.k; ++k) {
      const float av = operand(__ldg(a + k * g.sak), BF);
      const float4 b = *reinterpret_cast<const float4*>(&bsm[k][c]);
      acc[0] = fmaf(av, b.x, acc[0]);
      acc[1] = fmaf(av, b.y, acc[1]);
      acc[2] = fmaf(av, b.z, acc[2]);
      acc[3] = fmaf(av, b.w, acc[3]);
    }
    if (g.bias)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < cols) acc[i] += __ldg(g.bias + n0 + c + i);
    float* out = C + (r0 + r) * g.ldc + n0 + c;
    if (vec && c + 4 <= cols) {
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < cols) out[i] = acc[i];
    }
  }
}

// The streaming kernel for width n <= kThinN with a K-major A (no
// split): a warp per row, lane l summing k = l, l + 32, ... in fp32 FMA,
// then the 32 lanes' sums added pairwise (a butterfly, the same sum on
// every lane).
template <bool BF>
__global__ void __launch_bounds__(kThreads) gemv_kernel(const Gemm g) {
  const long long m = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= g.m) return;
  const float* a = g.a + blockIdx.z * g.bsa + m * g.sam;
  const float* B = g.b + blockIdx.z * g.bsb;
  float acc[kThinN] = {};
#pragma unroll 4
  for (int k = lane; k < g.k; k += 32) {
    const float av = operand(__ldg(a + k), BF);
#pragma unroll
    for (int n = 0; n < kThinN; ++n)
      if (n < g.n)
        acc[n] = fmaf(av, operand(__ldg(B + k * g.sbk + n * g.sbn), BF),
                      acc[n]);
  }
#pragma unroll
  for (int n = 0; n < kThinN; ++n)
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], off);
  if (lane) return;
  float* row = g.c + blockIdx.z * g.bsc + m * g.ldc;
#pragma unroll
  for (int n = 0; n < kThinN; ++n)
    if (n < g.n) row[n] = g.bias ? acc[n] + __ldg(g.bias + n) : acc[n];
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int BN, bool AK, bool BK, bool BF>
int launch(const Gemm& g, int vec, dim3 grid, cudaStream_t stream) {
  const auto kernel = tc_gemm_kernel<BN, AK, BK, BF>;
  cudaError_t e = allow_smem(kernel, Tile<BN>::kSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, Tile<BN>::kSmem, stream>>>(g, vec);
  return (int)cudaGetLastError();
}

template <int BN, bool AK, bool BK>
int launch_prec(const Gemm& g, bool bf, int vec, dim3 grid,
                cudaStream_t stream) {
  if (!bf) return launch<BN, AK, BK, false>(g, vec, grid, stream);
  // bf16 operands only where mixed precision uses them: the forward and
  // dx, whose A (x or g) is K-major, and the backward passes' dW = dz^T h
  // (train_bwd_tc.cu: an M-major A over an N-major B).
  if constexpr (AK || !BK) return launch<BN, AK, BK, true>(g, vec, grid, stream);
  return kErrArgs;
}

template <int BN>
int launch_tile(const Gemm& g, bool bf, bool ak, bool bk, int vec, dim3 grid,
                cudaStream_t stream) {
  if (ak && bk) return launch_prec<BN, true, true>(g, bf, vec, grid, stream);
  if (ak) return launch_prec<BN, true, false>(g, bf, vec, grid, stream);
  if (bk) return launch_prec<BN, false, true>(g, bf, vec, grid, stream);
  return launch_prec<BN, false, false>(g, bf, vec, grid, stream);
}

int thin(const Gemm& g, bool bf, cudaStream_t stream) {
  const int cols = min(kThinCols, g.n);
  const long long nt = cdiv(g.n, kThinCols);
  // At most kThinElems outputs a block, and rows few enough for two
  // blocks per SM: a narrow C (the 3 x 3 transform) would otherwise leave
  // most SMs idle.
  const long long fill = (long long)g.m * nt * g.batch /
                         (2LL * max(1, device_attr(cudaDevAttrMultiProcessorCount)));
  const int rows = (int)max(1LL, min((long long)(kThinElems / cols), fill));
  const long long mt = cdiv(g.m, rows);
  if (mt > 0x7fffffffLL || nt > 65535 || g.batch > 65535) return kErrArgs;
  const dim3 grid((unsigned)mt, (unsigned)nt, (unsigned)g.batch);
  const bool vec = aligned(g.c, 16) && g.ldc % 4 == 0 && g.bsc % 4 == 0;
  if (bf)
    thin_kernel<true><<<grid, kThreads, 0, stream>>>(g, rows, vec);
  else
    thin_kernel<false><<<grid, kThreads, 0, stream>>>(g, rows, vec);
  return (int)cudaGetLastError();
}

int gemv(const Gemm& g, bool bf, cudaStream_t stream) {
  const long long mt = cdiv(g.m, kWarps);
  if (mt > 0x7fffffffLL || g.batch > 65535) return kErrArgs;
  const dim3 grid((unsigned)mt, 1, (unsigned)g.batch);
  if (bf)
    gemv_kernel<true><<<grid, kThreads, 0, stream>>>(g);
  else
    gemv_kernel<false><<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ part, int splits, long long len,
                 float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= len) return;
  const long long q = blockIdx.y;
  double t = 0.0;
  for (int s = 0; s < splits; ++s)
    t += (double)__ldg(part + (q * splits + s) * len + i);
  out[q * len + i] = (float)t;
}

}  // namespace

int gemm(const Gemm& g, bool bf, cudaStream_t stream) {
  const bool ak = g.sak == 1, bk = g.sbk == 1;
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || g.batch <= 0 || g.splits <= 0 ||
      !g.a || !g.b || !g.c || (!ak && g.sam != 1) || (!bk && g.sbn != 1))
    return kErrArgs;
  if (g.k <= kThinK && g.splits == 1 && !g.asum) return thin(g, bf, stream);
  if (g.n <= kThinN && ak && g.splits == 1 && !g.asum)
    return gemv(g, bf, stream);
  const int bn = tile_n(g.n);
  const long long tiles = cdiv(g.m, kBm) * cdiv(g.n, bn);
  const long long z = (long long)g.batch * g.splits;
  if (tiles > 0x7fffffffLL || z > 65535) return kErrArgs;
  // 16-byte copies where every row of the view starts 16-byte aligned.
  const bool va = aligned(g.a, 16) && (ak ? g.sam : g.sak) % 4 == 0 &&
                  g.bsa % 4 == 0;
  const bool vb = aligned(g.b, 16) && (bk ? g.sbn : g.sbk) % 4 == 0 &&
                  g.bsb % 4 == 0;
  const bool vc = aligned(g.c, 8) && g.ldc % 2 == 0 && g.bsc % 2 == 0;
  const int vec = (va ? 1 : 0) | (vb ? 2 : 0) | (vc ? 4 : 0);
  const dim3 grid((unsigned)tiles, 1, (unsigned)z);
  if (bn == 128) return launch_tile<128>(g, bf, ak, bk, vec, grid, stream);
  if (bn == 64) return launch_tile<64>(g, bf, ak, bk, vec, grid, stream);
  return launch_tile<32>(g, bf, ak, bk, vec, grid, stream);
}

int split_sum(const float* part, int splits, long long len, int groups,
              float* out, cudaStream_t stream) {
  if (len <= 0 || groups <= 0 || groups > 65535 || splits <= 0 ||
      cdiv(len, kThreads) > 0x7fffffffLL)
    return kErrArgs;
  const dim3 grid((unsigned)cdiv(len, kThreads), (unsigned)groups);
  split_sum_kernel<<<grid, kThreads, 0, stream>>>(part, splits, len, out);
  return (int)cudaGetLastError();
}

}  // namespace pointtpu
