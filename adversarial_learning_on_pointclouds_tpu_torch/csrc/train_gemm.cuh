// The argument structs of every training pass and their reductions,
// shared by trunk_train.cu, seg_head_train.cu and train_bwd_tc.cu, where
// every pass of the trunk and the seg head runs on the tensor cores, and
// by disc_tc.cu (colsum).
//
// Blocks run in no order, so nothing is carried between them: every
// reduction over the rows (column statistics, dW, db, the BN sums) is
// written as per-block partial sums and added by colsum_kernel in fp64,
// in a fixed order, so results do not depend on scheduling. Trunk F2's
// extrema (train_bwd_tc.cu) merge with one packed 64-bit atomicMax /
// atomicMin per (cloud, channel): an order-preserving key of the value
// in the high word and the point index in the low word (inverted for the
// max; max_key, min_key here, with the keys' fill and decode kernels), so
// ties go to the first point whatever the order of the blocks. The
// ragged tail of the point axis is masked: rows past N are zero in every
// tile and never enter a sum, an extremum or a store.
//
// Every tile lies in one cloud. With groups > 1 (the paired trunks'
// passes: the batch is groups stacked streams of batch / groups clouds)
// the BN statistics are [groups, C] and a tile uses its cloud's group's
// row (group_row; G, groups > 1, a template parameter of the tensor-core
// kernels that read them); each group's partial sums are a contiguous
// range of the per-block slots, added as a stream alone would add them.
//
// Under kRound (mixed precision) every matmul operand is rounded to bf16
// as it enters shared memory or a fragment; sums and statistics
// keep the unrounded fp32 values, and the stashes named in prec are read
// and written as bf16.

#pragma once

#include "common.cuh"

namespace pointtpu {

// Mirrors of the Python side's ctypes structures (ops/launch.py), field
// for field. A null pointer switches its feature off.
struct RowFwdArgs {
  int batch, n, c_in, c_out, ldw, groups, prec;
  const void* x;         // [batch * n, c_in], fp32 or (kXBf16) bf16
  const float* sc;       // [groups, c_in] prologue relu(x * sc + sh), or null
  const float* sh;
  const float* w;        // [c_out, ldw] row-major (PyTorch's [out, in])
  const float* bias;     // [c_out]
  const float* addend;   // [batch, c_out] per-cloud addend, or null
  void* z;               // [batch * n, c_out] store (kZBf16: bf16), or null
  float* sum;            // [groups, c_out] column sums, or null
  float* ssq;            // [groups, c_out] column sums of squares
  float* part;           // scratch [2, blocks, c_out]
  unsigned long long* keys;  // scratch [2, batch, c_out] (F2's extrema)
  float* mx;             // [batch, c_out] per-cloud max (F2), or null
  float* mn;
  int* imax;
  int* imin;
  float* logp;           // [batch * n, c_out] log_softmax, or null
};

enum DzMode { kDzBn = 0, kDzTrunk = 1, kDzSoftmax = 2 };

struct BwdArgs {
  int mode, batch, n, c_in, c_out, ldw, splits, groups, prec;
  const void* zp;        // [batch * n, c_in] previous stash (or raw input)
  const float* scp;      // [groups, c_in] previous BN's affine (ReLU
  const float* shp;      //   mask), or null
  const float* mup;      // [groups, c_in] previous BN's mean and 1/std for
  const float* invp;     //   t1/t2, or null
  const float* w;        // [c_out, ldw] row-major
  const float* bias;     // kDzTrunk: b3; kDzSoftmax: b4
  const void* zc;        // kDzBn: current stash [batch * n, c_out]
  const void* dy;        // kDzBn: current cotangent [batch * n, c_out]
  const float* sc;       // kDzBn: [groups, c_out]
  const float* mu;       // kDzBn, kDzTrunk: [groups, c_out]
  const float* inv;
  const float* c1;       // kDzBn: [groups, c_out]
  const float* c2;
  const float* coef1;    // kDzTrunk: [batch, c_out]
  const float* coef2;
  const float* s3dg;
  const int* idx;        // kDzTrunk: pooled winners [batch, c_out]
  const float* dlp;      // kDzSoftmax: d log-probs [batch * n, c_out]
  void* dyp;             // [batch * n, c_in] (kDypBf16: bf16)
  float* t1;             // [groups, c_in] or null
  float* t2;
  float* db;             // [c_out]
  float* r;              // [batch, c_out] per-cloud sums of dz, or null
  float* dw;             // [c_out, c_in]
  float* part;           // scratch [blocks, 2 * c_in + c_out]
  float* part_w;         // scratch [splits, c_out * c_in]
  // The tensor-core passes (train_bwd_tc.cu) only: the row pass writes
  // the dW product's operands here (head B1 reads its h, pf, from zp).
  float* dzs;            // scratch [batch * n, c_out]: dz
  float* hs;             // scratch [batch * n, c_in]: the previous
                         //   activation (trunk B1, Bmid), or null
};

namespace {  // each translation unit keeps its own copy

// The previous layer's BN affine, v * sc + sh, rounded after the product
// as PyTorch's two elementwise ops round it (no fused multiply-add): the
// backward's ReLU mask then flips at exactly the same elements as the
// plain version's.
__device__ __forceinline__ float bn_affine(float v, float sc, float sh) {
  return __fadd_rn(__fmul_rn(v, sc), sh);
}

// The row of a [groups, c] statistic (or null) for cloud b; without G
// (one group) the statistic itself.
template <bool G>
__device__ __forceinline__ const float* group_row(const float* p, int b,
                                                  int batch, int groups,
                                                  int c) {
  if (!G) return p;
  return p ? p + (size_t)(b / (batch / groups)) * c : nullptr;
}

// Order-preserving 32-bit image of a float (larger float, larger bits).
__device__ __forceinline__ unsigned int order_bits(float v) {
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_value(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Keys whose max (min) is the largest (smallest) value at its first point.
__device__ __forceinline__ unsigned long long max_key(float v, int p) {
  return ((unsigned long long)order_bits(v) << 32) |
         (0xffffffffu - (unsigned int)p);
}

__device__ __forceinline__ unsigned long long min_key(float v, int p) {
  return ((unsigned long long)order_bits(v) << 32) | (unsigned int)p;
}

// ---------------------------------------------------------------------------
// Reductions, fills and decodes
// ---------------------------------------------------------------------------

// out[g * ldo + c] = sum over p < per of part[(g * per + p) * ld + c], in
// fp64 and a fixed order. A block covers 32 columns with 8 row lanes, so
// each warp reads 128 contiguous bytes.
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* __restrict__ part, long long ld, int per,
              int cols, float* __restrict__ out, long long ldo) {
  __shared__ double red[kWarps][33];
  const int cl = threadIdx.x & 31, pl = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * 32 + cl;
  const long long g = blockIdx.y;
  double s = 0.0;
  if (c < cols)
    for (int p = pl; p < per; p += kWarps)
      s += (double)__ldg(part + (g * per + p) * ld + c);
  red[pl][cl] = s;
  __syncthreads();
  if (pl == 0 && c < cols) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t += red[w][cl];
    out[g * ldo + c] = (float)t;
  }
}

// Status codes below are 0, a cudaError_t, or kErrArgs / kErrSmem.
int colsum(const float* part, long long ld, int per, int cols, int groups,
           float* out, long long ldo, cudaStream_t stream) {
  const dim3 grid(ceil_div(cols, 32), groups);
  colsum_kernel<<<grid, kThreads, 0, stream>>>(part, ld, per, cols, out, ldo);
  return (int)cudaGetLastError();
}

__global__ void fill_keys_kernel(unsigned long long* keys, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 2 * count) keys[i] = i < count ? 0ull : ~0ull;
}

__global__ void decode_extrema_kernel(const unsigned long long* __restrict__ keys,
                                      long long count, float* mx, float* mn,
                                      int* imax, int* imin) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const unsigned long long km = keys[i], kn = keys[count + i];
  mx[i] = order_value((unsigned int)(km >> 32));
  imax[i] = (int)(0xffffffffu - (unsigned int)km);
  mn[i] = order_value((unsigned int)(kn >> 32));
  imin[i] = (int)(unsigned int)kn;
}

}  // namespace
}  // namespace pointtpu
