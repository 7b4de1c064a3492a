// The tensor-core fragment layer shared by the GEMM core (strided_gemm.cu),
// the generator's training passes (train_bwd_tc.cu), the discriminator's
// (disc_tc.cu) and the serving kernels (encoder_fused.cu): cp.async
// copies into shared memory, the GEMM core's operand stage layouts, the
// XOR-swizzled tile layout sw_at, fp32 as 3xTF32 and the mma.sync steps.
//
// * cp.async: 16-byte (cp16) or 4-byte (cp4) copies whose source bytes
//   past src-size read as zero; commit and wait by group.
// * Stage layouts of a kBk-deep chunk of an operand: K-major, element (r,
//   k) at s[r * kLdk + k], or M/N-major, at s[k * (ROWS + kPadMn) + r].
//   The pads make every fragment load of a warp hit 32 distinct banks.
// * fp32 as 3xTF32: v = hi + lo, hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v
//   - hi); per 8-deep k step each tile sums a_lo * b_hi, a_hi * b_lo, then
//   a_hi * b_hi (small terms first) on the tensor core from zero, and that
//   step's sum is added to the fp32 accumulator with an ordinary
//   round-to-nearest FADD: the tensor core's accumulation does not round
//   to nearest, so no long sum stays inside it.
// * bf16: both operands rounded to bf16 nearest-even as the fragments
//   load, one m16n8k16 per 16-deep k step, summed on the tensor core. The
//   fragments take k in the order t, t+4, t+8, t+12 for lane group t (any
//   order of k serves, the same for A and B), so they load from the same
//   conflict-free addresses as the tf32 ones.
//
// mma_step does one k step of a warp's MT x NT tiles (16 x 8 each) from
// two element accessors, fa(m, k) and fb(n, k), so each kernel keeps its
// operands in its own shared-memory layout.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace pointtpu {
namespace {  // each translation unit keeps its own copy

constexpr int kBk = 32;                // k depth of a GEMM-core stage
constexpr int kLdk = kBk + 4;          // row stride of a K-major stage
constexpr int kPadMn = 8;              // pad of an M- or N-major stage's row

// Floats of one stage of an operand tile with `rows` along m or n, either
// layout.
__host__ __device__ constexpr int stage_floats(int rows) {
  return rows * kLdk > kBk * (rows + kPadMn) ? rows * kLdk
                                             : kBk * (rows + kPadMn);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage of an operand: element (r, k) of the tile, r < ROWS along m
// (or n) and k < kBk, is base[(mn0 + r) * s_mn + (k0 + k) * s_k]; KMAJ:
// s_k == 1, stored at s[r * kLdk + k], else s_mn == 1, at s[k * (ROWS +
// kPadMn) + r]. Rows at or past r_lim and k at or past k_lim are zero.
template <bool KMAJ, int ROWS>
__device__ __forceinline__ void load_stage(float* s, const float* base,
                                           long long s_mn, long long s_k,
                                           long long mn0, int r_lim, int k0,
                                           int k_lim, bool vec) {
  constexpr int kLd = KMAJ ? kLdk : ROWS + kPadMn;
  constexpr int kInner = KMAJ ? kBk : ROWS;       // the contiguous axis
  if (vec) {
    for (int c = threadIdx.x; c < ROWS * kBk / 4; c += kThreads) {
      const int outer = c / (kInner / 4), inner = (c % (kInner / 4)) * 4;
      const int r = KMAJ ? outer : inner, k = KMAJ ? inner : outer;
      const int left = KMAJ ? (r < r_lim ? k_lim - k : 0)
                            : (k < k_lim ? r_lim - r : 0);
      const int bytes = 4 * max(0, min(4, left));
      cp16(s + outer * kLd + inner,
           bytes ? base + (mn0 + r) * s_mn + (long long)(k0 + k) * s_k : base,
           bytes);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * kBk; e += kThreads) {
      const int outer = e / kInner, inner = e % kInner;
      const int r = KMAJ ? outer : inner, k = KMAJ ? inner : outer;
      const bool ok = r < r_lim && k < k_lim;
      cp4(s + outer * kLd + inner,
          ok ? base + (mn0 + r) * s_mn + (long long)(k0 + k) * s_k : base,
          ok ? 4 : 0);
    }
  }
}

template <bool KMAJ, int ROWS>
__device__ __forceinline__ float stage_at(const float* s, int r, int k) {
  return KMAJ ? s[r * kLdk + k] : s[k * (ROWS + kPadMn) + r];
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// d += a * b, m16n8k8 tf32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b, m16n8k16 bf16.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The k depth of one mma_step.
__host__ __device__ constexpr int mma_depth(bool bf) { return bf ? 16 : 8; }

// One k step (k = kk ..) of a warp's MT x NT tiles: acc[i][j] is the 16 x
// 8 tile at rows mb + 16 i, columns nb + 8 j, and lane (g, t) = (lane /
// 4, lane % 4) holds its rows g and g + 8 at columns 2 t, 2 t + 1
// (acc[..][0..1] and [2..3]). fa(m, k) and fb(n, k) read A[m][k] and
// B[k][n] from shared memory; lane (g, t) reads A rows g and g + 8 and B
// column g of each tile at k = t, t + 4 (and t + 8, t + 12 for bf16).
template <int MT, int NT, bool BF, typename FA, typename FB>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4],
                                         const FA& fa, const FB& fb, int mb,
                                         int nb, int kk, int g, int t) {
  if constexpr (BF) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = nb + 8 * j + g;
      b[j][0] = bf16x2(fb(n, kk + t), fb(n, kk + t + 4));
      b[j][1] = bf16x2(fb(n, kk + t + 8), fb(n, kk + t + 12));
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = mb + 16 * i + g;
      uint32_t a[4];
      a[0] = bf16x2(fa(m, kk + t), fa(m, kk + t + 4));
      a[1] = bf16x2(fa(m + 8, kk + t), fa(m + 8, kk + t + 4));
      a[2] = bf16x2(fa(m, kk + t + 8), fa(m, kk + t + 12));
      a[3] = bf16x2(fa(m + 8, kk + t + 8), fa(m + 8, kk + t + 12));
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j]);
    }
  } else {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = nb + 8 * j + g;
      split(fb(n, kk + t), bh[j][0], bl[j][0]);
      split(fb(n, kk + t + 4), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = mb + 16 * i + g;
      uint32_t ah[4], al[4];
      split(fa(m, kk + t), ah[0], al[0]);
      split(fa(m + 8, kk + t), ah[1], al[1]);
      split(fa(m, kk + t + 4), ah[2], al[2]);
      split(fa(m + 8, kk + t + 4), ah[3], al[3]);
      // Each term over the NT tiles in turn: consecutive products are
      // independent, so the tensor core's latency overlaps.
      float s[NT][4] = {};
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(s[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(s[j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(s[j], ah, bh[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += s[j][q];
    }
  }
}

// Element (r, k) of a W-wide tile (W a multiple of 32) in shared memory
// that is read along its rows, or along its rows and its columns (trunk
// B1's W3 chunk: GEMM 1 reads it K-major, GEMM 2 N-major): row r, column
// k XOR a function of r's low three bits. A warp's fragment loads at (r = 8 j +
// g, k = kk + t) and at (r = kk + t (+ 4), k = 8 j + g) both land on 32
// distinct banks, which no pad achieves for both (a stride of 4 mod 32
// serves the first, 8 the second). The XOR keeps aligned groups of 4
// floats together, so 16-byte copies and stores fill it.
template <int W = 128>
__device__ __forceinline__ int sw_at(int r, int k) {
  return r * W + (k ^ (((r & 3) << 3) | (r & 4)));
}

// The sum over the 8 lanes of lane group t (lane = 4 g + t), in a fixed
// order.
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

}  // namespace
}  // namespace pointtpu
