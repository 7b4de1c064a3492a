// A batched fp32 GEMM over strided operands, with split-K partial sums
// added in fp64 in a fixed order. Shared by pointwise_matmul.cu and
// tnet_apply.cu, whose products differ only in which operand is
// transposed and where the sum over rows goes:
//
//     C[z][m][n] = sum_{k in split s} A[b][m][k] * B[b][k][n] (+ bias[n])
//
// for batch b = z / splits and split s = z % splits. A and B are read
// through two strides each (a row-major matrix, its transpose or a
// PyTorch [out, in] weight are all such views), so no operand is ever
// copied into another layout.
//
// A block of 256 threads owns a 64 x 64 tile of C: thread (ty, tx) of a
// 16 x 16 grid holds rows ty + 16 i and columns tx + 16 j (i, j < 4) in
// registers, so a warp reads two broadcast A values and 16 consecutive
// B values per k. A and B stream through shared memory in chunks of 16
// along k; each chunk is loaded along whichever axis is contiguous in
// device memory, so the loads coalesce whatever the view. Rows, columns
// and k past their ends load as zero and store nothing: any shape works.
//
// fp32 FMA on the CUDA cores with fp32 sums. BF (mixed precision) rounds
// both operands to bf16 (nearest even) as they enter shared memory.

#pragma once

#include "common.cuh"

namespace pointtpu {

namespace {  // each translation unit keeps its own copy

constexpr int kGm = 64, kGn = 64, kGk = 16;   // C tile and k chunk

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

struct Gemm {
  int m, n, k, batch, splits;
  long long sam, sak;          // A[b][m][k] = a[b * bsa + m * sam + k * sak]
  long long sbk, sbn;          // B[b][k][n] = b[b * bsb + k * sbk + n * sbn]
  long long bsa, bsb;
  long long ldc, bsc;          // C[z][m][n] = c[z * bsc + m * ldc + n]
  const float* a;
  const float* b;
  const float* bias;           // [n], or null
  float* c;
};

template <bool BF>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Gemm g) {
  __shared__ float as[kGk][kGm + 4];
  __shared__ float bs[kGk][kGn + 4];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long m0 = (long long)blockIdx.x * kGm;
  const int n0 = blockIdx.y * kGn;
  const int bz = blockIdx.z / g.splits, s = blockIdx.z - bz * g.splits;
  const int kper = (int)cdiv(cdiv(g.k, g.splits), kGk) * kGk;
  const int k_beg = s * kper, k_end = min(g.k, k_beg + kper);
  const float* A = g.a + bz * g.bsa;
  const float* B = g.b + bz * g.bsb;
  const bool a_along_k = g.sak == 1, b_along_n = g.sbn == 1;
  float acc[4][4] = {};
  for (int k0 = k_beg; k0 < k_end; k0 += kGk) {
#pragma unroll
    for (int q = 0; q < kGm * kGk / kThreads; ++q) {
      const int e = threadIdx.x + kThreads * q;
      int mm = a_along_k ? e / kGk : e % kGm;
      int kk = a_along_k ? e % kGk : e / kGm;
      float v = 0.f;
      if (m0 + mm < g.m && k0 + kk < k_end)
        v = __ldg(A + (m0 + mm) * g.sam + (long long)(k0 + kk) * g.sak);
      as[kk][mm] = operand(v, BF);
      const int nn = b_along_n ? e % kGn : e / kGk;
      kk = b_along_n ? e / kGn : e % kGk;
      v = 0.f;
      if (n0 + nn < g.n && k0 + kk < k_end)
        v = __ldg(B + (long long)(k0 + kk) * g.sbk + (long long)(n0 + nn) * g.sbn);
      bs[kk][nn] = operand(v, BF);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGk; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* C = g.c + blockIdx.z * g.bsc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < g.n) C[m * g.ldc + n] = g.bias ? acc[i][j] + __ldg(g.bias + n)
                                             : acc[i][j];
    }
  }
}

// out[q * len + i] = sum over s < splits of part[(q * splits + s) * len +
// i], in fp64 and in the order of s, for q < groups.
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

// Status codes below are 0, a cudaError_t, or kErrArgs.
int gemm(const Gemm& g, bool bf, cudaStream_t stream) {
  const long long mt = cdiv(g.m, kGm), nt = cdiv(g.n, kGn);
  const long long z = (long long)g.batch * g.splits;
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || g.batch <= 0 || g.splits <= 0 ||
      mt > 0x7fffffffLL || nt > 65535 || z > 65535 || !g.a || !g.b || !g.c)
    return kErrArgs;
  const dim3 grid((unsigned)mt, (unsigned)nt, (unsigned)z);
  if (bf)
    gemm_kernel<true><<<grid, kThreads, 0, stream>>>(g);
  else
    gemm_kernel<false><<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
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

}  // namespace
}  // namespace pointtpu
