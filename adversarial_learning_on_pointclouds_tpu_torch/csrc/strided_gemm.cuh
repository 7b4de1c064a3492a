// The batched strided GEMM shared by pointwise_matmul.cu and tnet_apply.cu
// (defined in strided_gemm.cu), whose products differ only in which
// operand is transposed and where the sum over rows goes:
//
//     C[z][m][n] = sum_{k in split s} A[b][m][k] * B[b][k][n] (+ bias[n])
//
// for batch b = z / splits and split s = z % splits. A and B are read
// through two strides each, one of which is 1 (a row-major matrix, its
// transpose or a PyTorch [out, in] weight are all such views), so no
// operand is ever copied into another layout. Split-K partials go to
// z's slice of C and are added in fp64, in a fixed order, by split_sum.

#pragma once

#include "common.cuh"

namespace pointtpu {

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
  // Or null; else asum[z * m + i] = sum over split z's k of A[b][i][k]
  // (fp32; tensor-core products only).
  float* asum;
};

// Products of depth k <= kThinK, or of width n <= kThinN over a K-major
// A, take a streaming kernel, the rest the tensor-core kernel
// (strided_gemm.cu says why).
constexpr int kThinK = 4, kThinN = 4;

// C as above; bf: bf16 operands (nearest even) with fp32 sums, else fp32
// (3xTF32 on the tensor cores, fp32 FMA for a thin k or n). Returns 0, a
// cudaError_t, or kErrArgs.
int gemm(const Gemm& g, bool bf, cudaStream_t stream);

// out[q * len + i] = sum over s < splits of part[(q * splits + s) * len +
// i], in fp64 and in the order of s, for q < groups.
int split_sum(const float* part, int splits, long long len, int groups,
              float* out, cudaStream_t stream);

}  // namespace pointtpu
