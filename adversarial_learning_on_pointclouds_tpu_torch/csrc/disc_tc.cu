// The fused discriminator on the tensor cores: its forward, its input
// gradient, its weight-gradient pass and the full backward, with their
// entry points (pt_disc_fwd, pt_disc_bwd_dx, pt_disc_bwd_dw).
//
// Replaces the TPU kernels of
// adversarial_learning_on_pointclouds_tpu/ops/kernels/disc_fused.py:
// _fwd_call (pallas_call at disc_fused.py:101: the logits of the k -> 64
// -> 128 -> 256 -> 512 -> 1 stack, LeakyReLU(0.2) after the first four
// layers), _bwd_dx_call (:229: dx from the logits' cotangent g, no dW),
// _bwd_dw_call (:339: dW/db from the input x and g, no dx) and _bwd_call
// (:145: dW/db and dx).
//
// What bounds it on the H100: matmuls. A row costs 175,744 multiply-adds
// forward (recomputed from x in every backward, as the TPU kernels do),
// 172,032 down the dh chain and 175,744 in the weight gradients: at the
// D step's 131,072 fake rows about 137 GFLOP, past fp32 FMA's 67 TFLOP/s
// and bf16's need of the tensor cores: as fp32 FMAs on the CUDA cores,
// bf16 operands included, the forward and dx passes ran at about 26-29
// TFLOP/s (PERF.md §6).
//
// What the design does about that:
//
// * Every product on the tensor cores through mma.cuh's fragment layer:
//   fp32 as 3xTF32 (each 8-deep step summed from zero, added to the fp32
//   accumulator by a round-to-nearest FADD), bf16 (kRound) operands
//   rounded nearest-even at fragment load with fp32 sums.
// * The backward's row pass (disc_row_tc_kernel, one mode a pass: dx
//   only, dW only, or both). A block of 8 warps, 2 (rows, 32 each) by 4
//   (columns), owns 64 rows. It recomputes h1..h3 = leaky(h W^T + b)
//   into shared memory, then walks layer 4 in chunks of 128 columns: z4
//   on the tensor cores, an epilogue in registers that forms dz4 = g w5
//   leaky'(h4) (LeakyReLU' from the output's sign) and, for dW, dW5's
//   and db4's column partials from the unrounded values, and dh3 += dz4
//   W4[chunk] into a [64 x 256] accumulator held in registers across
//   the chunks. Then dz3 = dh3 leaky'(h3), dh2 = dz3 W3, dz2, dh1 = dz2
//   W2, dz1 (and dx = dz1 W1), each dz written over its h in shared
//   memory as the next product's operand. The dx-only pass is this
//   without the scratch, the partials and the dW products, so its dx
//   equals the full backward's bit for bit.
// * The forward (disc_fwd_tc_kernel): the same h1..h3, h3 computed by
//   halves of 128 columns (the first over x and h1, dead once h2 exists;
//   the second over h2 once every warp has read it), then layer 4 in
//   chunks of 128 columns folded into the logit in registers: h4 =
//   leaky(z4 + b4) and logit += h4 w5, one fp32 FMA a term (operands
//   rounded under kRound); the column warps' partials meet in shared
//   memory, plus b5. No dz, no chain, no scratch: 43 of the backward's
//   85 weight slices, and 128 rows a block (kFwdRows: 25% faster than 64
//   rows in both precisions, PERF.md §6).
// * Weights stream through one 3-stage cp.async ring of slices (16 KB
//   payloads: [256 x 16], [128 x 32] or [64 x 64] along k or along n),
//   one continuous schedule a tile (slice_at, fwd_slice_at) across all
//   of its products, so the next product's first slices land during the
//   previous one's epilogue.
// * Weight gradients (design (i) of train_bwd_tc.cu): the row pass writes
//   dz1..dz4 and h1..h3 (fp32, unrounded: 1,408 floats a row, 738 MB at
//   131,072 rows) to scratch, each tile's rows copied out of shared
//   memory by the bulk-copy engine (cp.async.bulk, a row a thread) while
//   the warps compute on: stored from the fragments instead, the same
//   writes held the row pass up by 30% on the H100 (PERF.md §6).
//   dW1..dW4 = dz^T h run on the GEMM core
//   (strided_gemm.cu: gemm, an M-major A over an N-major B, h0 = x read
//   by 4-byte copies at its row stride of k; split-K over row ranges
//   merged by split_sum in fp64). db1..db4 and dW5 (a 512-long dot
//   product a row) are per-block partials added by colsum in fp64 in a
//   fixed order. db5 = sum g, one number, is summed by one block in fp64
//   (sum_g_kernel), so it is rounded once: fp32 partials of 64-row tiles
//   round once a tile, and with no columns to take a maximum over, that
//   put it a float away from the plain pass's sum. Writing and reading
//   back the scratch is about 0.45 ms of device memory a 131,072-row
//   launch.
// * What bounds the row pass now: the weight stream. Every 64-row tile
//   reads 1.36 MB of slices from L2 (W4 twice); with its products taken
//   out the pass still took 1.17 ms at 131,072 rows (2.4 TB/s of slices),
//   against 1.58 ms for the whole bf16 pass (PERF.md §6).
// * Shared memory: the backward 212 KB (x, then the dz4 chunk; h1..h3 at
//   row strides of width + 4, so every fragment load of a warp hits 32
//   banks; the ring; the column sums), the forward 196 KB; one block per
//   SM; registers: ptxas's report in the build log (chip_smoke.py phase
//   2).
// * Rows past m are zero in x and carry g = 0, so every dz of theirs is
//   0 and they add nothing to a sum; they are never stored.

#include "disc_fused.cuh"
#include "mma.cuh"
#include "strided_gemm.cuh"
#include "train_gemm.cuh"

namespace pointtpu {
namespace {

constexpr int kDwRows = 64;                 // rows a block of the backward
constexpr int kFwdRows = 128;               // rows a block of the forward
constexpr int kDwWarpsN = 4;                // warps along the columns
constexpr int kDwThreads = 64 * kDwWarpsN;  // and 2 along the rows
constexpr int kC4 = 128;                    // layer-4 columns a chunk
constexpr int kRing = 3;                    // stages of the slice ring
constexpr int kStageF = 5120;               // floats a stage: [256][16 + 4]
// The backward's modes: dx only (the frozen D), dW/db only, or both.
constexpr int kDx = 0, kDw = 1, kFull = 2;
// Row strides of the shared-memory tiles: width + 4 (4 mod 32).
constexpr int kLd0 = kDiscMaxK + 4, kLd1 = kD1 + 4, kLd2 = kD2 + 4;
constexpr int kLd3 = kD3 + 4, kLdz = kC4 + 4;
// The scratch rows: dz1 | dz2 | dz3 | dz4 and h1 | h2 | h3.
constexpr int kDzCols = kD1 + kD2 + kD3 + kD4;      // 960
constexpr int kHCols = kD1 + kD2 + kD3;             // 448
constexpr int kDz2 = kD1, kDz3 = kD1 + kD2, kDz4 = kD1 + kD2 + kD3;
// A block's partials, in GradLayout order from dW5 on: dW5, db1..db4.
constexpr int kPB1 = kD4, kPB2 = kPB1 + kD1, kPB3 = kPB2 + kD2;
constexpr int kPB4 = kPB3 + kD3, kPartCols = kPB4 + kD4;
constexpr int kSumThreads = 1024;   // sum_g_kernel
// Ring slices a tile of the backward: L1 1, L2 2, L3 8, four layer-4
// chunks of 8 + 8, dh2 8, dh1 2, and dx 1; of the forward: L1 1, L2 2, L3
// 8 (by halves), four layer-4 chunks of 8.
constexpr int kSlices = 1 + 2 + 8 + 4 * 16 + 8 + 2;
constexpr int kFwdSlices = 1 + 2 + 8 + 4 * 8;
constexpr size_t kSmemFloats = kDwRows + (size_t)kDwRows * kLdz +
                               (size_t)kDwRows * (kLd1 + kLd2 + kLd3) +
                               (size_t)kRing * kStageF + 4 * kD3;

// The forward's shared memory: x and h1 (then h3's first half), h2 (then
// its second), the ring, the column warps' logits.
constexpr size_t kFwdSmemFloats =
    (size_t)kFwdRows * (kLd0 + kLd1 + kLd2) + (size_t)kRing * kStageF +
    (size_t)kDwWarpsN * kFwdRows;

// Offsets into the gradient buffer: dW1..dW5 as [out, in], then db1..db5.
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

// A warp's share of an N-wide product: W columns in H parts of NT n8
// tiles (at most 32 columns a part).
template <int N>
struct Cols {
  static constexpr int W = N / kDwWarpsN;
  static constexpr int H = (W + 31) / 32, NT = (W < 32 ? W : 32) / 8;
};

// One ring slice: a block of a weight that is B of a product, ROWS along
// n by DEPTH along k, element (r, k) at src[r * ld + k] (K-major: a row
// of PyTorch's [out, in] weight is a column of B) or at src[k * ld + r]
// (N-major). Stored K-major at s[r * (DEPTH + 4) + k], N-major at
// s[k * (ROWS + 8) + r]: every fragment load of a warp hits 32 banks.
// Elements at r >= r_lim or k >= k_lim are zero; vec: 16-byte copies (a
// full slice whose rows start 16-byte aligned), else 4-byte copies.
struct Slice {
  const float* src;
  int kind, ld, r_lim, k_lim;
  bool vec;
};

template <bool KMAJ, int ROWS, int DEPTH>
struct SliceShape {
  static constexpr int kLd = KMAJ ? DEPTH + 4 : ROWS + 8;
  static constexpr int kInner = KMAJ ? DEPTH : ROWS;   // contiguous axis
  static constexpr int kOuter = KMAJ ? ROWS : DEPTH;
  static_assert(ROWS * DEPTH == 4096 && kOuter * kLd <= kStageF, "slice");
};

template <bool KMAJ, int ROWS, int DEPTH>
__device__ __forceinline__ void load_slice(float* s, const Slice& sl) {
  using S = SliceShape<KMAJ, ROWS, DEPTH>;
  if (sl.vec) {
    for (int c = threadIdx.x; c < S::kOuter * S::kInner / 4;
         c += kDwThreads) {
      const int o = c / (S::kInner / 4), i = (c % (S::kInner / 4)) * 4;
      cp16(s + o * S::kLd + i, sl.src + (size_t)o * sl.ld + i, 16);
    }
  } else {
    for (int e = threadIdx.x; e < S::kOuter * S::kInner; e += kDwThreads) {
      const int o = e / S::kInner, i = e % S::kInner;
      const int r = KMAJ ? o : i, k = KMAJ ? i : o;
      const bool ok = r < sl.r_lim && k < sl.k_lim;
      cp4(s + o * S::kLd + i, ok ? sl.src + (size_t)o * sl.ld + i : sl.src,
          ok ? 4 : 0);
    }
  }
}

// Slice q of a backward tile's schedule, in the order the products
// consume them. Kinds: 0 K-major 64 x 64, 1 K-major 128 x 32, 2 K-major
// 256 x 16, 3 N-major 256 x 16, 4 N-major 128 x 32, 5 N-major 64 x 64.
__device__ __forceinline__ Slice slice_at(const DiscArgs& a, int q) {
  if (q == 0) return {a.w1, 0, a.k, kD1, a.k, false};            // h1
  if (q < 3) return {a.w2 + 32 * (q - 1), 1, kD1, kD2, 32, true};  // h2
  if (q < 11) return {a.w3 + 16 * (q - 3), 2, kD2, kD3, 16, true};  // h3
  if (q < 75) {
    const int c = (q - 11) >> 4, j = (q - 11) & 15;
    if (j < 8)                                                    // z4 chunk
      return {a.w4 + (size_t)c * kC4 * kD3 + 32 * j, 1, kD3, kC4, 32, true};
    return {a.w4 + (size_t)(c * kC4 + 16 * (j - 8)) * kD3, 3, kD3, kD3, 16,
            true};                                                // dh3
  }
  if (q < 83) return {a.w3 + (size_t)32 * (q - 75) * kD2, 4, kD2, kD2, 32,
                      true};                                      // dh2
  if (q < 85) return {a.w2 + (size_t)64 * (q - 83) * kD1, 5, kD1, kD1, 64,
                      true};                                      // dh1
  return {a.w1, 5, a.k, a.k, kD1, false};                         // dx
}

// Slice q of a forward tile's schedule: h1 and h2 as the backward's, h3
// by halves of 128 columns, then the four layer-4 chunks' z4 slices.
__device__ __forceinline__ Slice fwd_slice_at(const DiscArgs& a, int q) {
  if (q < 3) return slice_at(a, q);
  if (q < 11) {                                                   // h3
    const int half = (q - 3) >> 2, j = (q - 3) & 3;
    return {a.w3 + (size_t)half * kC4 * kD2 + 32 * j, 1, kD2, kC4, 32, true};
  }
  const int c = (q - 11) >> 3, j = (q - 11) & 7;                  // z4
  return {a.w4 + (size_t)c * kC4 * kD3 + 32 * j, 1, kD3, kC4, 32, true};
}

// Slice q (of the forward's schedule under FWD) into ring stage q %
// kRing: one commit group a call, empty past the tile's last slice.
template <bool FWD>
__device__ __forceinline__ void issue(float* ring, const DiscArgs& a, int q,
                                      int total) {
  if (q < total) {
    const Slice sl = FWD ? fwd_slice_at(a, q) : slice_at(a, q);
    float* s = ring + (q % kRing) * kStageF;
    switch (sl.kind) {
      case 0: load_slice<true, 64, 64>(s, sl); break;
      case 1: load_slice<true, 128, 32>(s, sl); break;
      case 2: load_slice<true, 256, 16>(s, sl); break;
      case 3: load_slice<false, 256, 16>(s, sl); break;
      case 4: load_slice<false, 128, 32>(s, sl); break;
      default: load_slice<false, 64, 64>(s, sl); break;
    }
  }
  cp_commit();
}

// acc += A[:, k0 .. k0 + DEPTH) times the slice s, for warp rows mb .. mb
// + 16 MT and columns nb + 32 h + 8 j (+ 8) of acc[h][i][j]; A row-major
// in shared memory (row stride lda). A warp's columns come in H parts of
// at most 32, each its own mma_step: a 64-wide part would hold twice the
// fragments at once, past the registers the accumulators leave. The k
// steps are not unrolled: on the H100 (700 W) that ran the row pass 6%
// faster than two steps unrolled and 16% faster than all of a slice's
// (which spilled), with 4 warps along the columns; 8 ran no faster in
// fp32 and 1.5x slower in bf16 (PERF.md §6).
template <bool BF, bool KMAJ, int ROWS, int DEPTH, int H, int MT, int NT>
__device__ __forceinline__ void slice_mma(float (&acc)[H][MT][NT][4],
                                          const float* A, int lda, int k0,
                                          const float* s, int mb, int nb,
                                          int g, int t) {
  using S = SliceShape<KMAJ, ROWS, DEPTH>;
  const float* ak = A + k0;
  const auto fa = [ak, lda](int m, int k) { return ak[m * lda + k]; };
  const auto fb = [s](int n, int k) {
    return KMAJ ? s[n * S::kLd + k] : s[k * S::kLd + n];
  };
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll 1
    for (int kk = 0; kk < DEPTH; kk += mma_depth(BF))
      mma_step<MT, NT, BF>(acc[h], fa, fb, mb, nb + 32 * h, kk, g, t);
}

// The lane's rows of a fragment: acc[h][i][j][2 r + q] is row mb + 16 i
// + g + 8 r, column nb + 32 h + 8 j + 2 t + q.
__device__ __forceinline__ int frag_row(int mb, int i, int r, int g) {
  return mb + 16 * i + g + 8 * r;
}

// h = leaky(acc + b) into h_s (row stride ld).
template <int H, int MT, int NT>
__device__ __forceinline__ void hidden(const float (&acc)[H][MT][NT][4],
                                       const float* __restrict__ b,
                                       float* h_s, int ld, int mb, int nb,
                                       int g, int t) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = nb + 32 * h + 8 * j + 2 * t;
      const float b0 = __ldg(b + col), b1 = __ldg(b + col + 1);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int r = frag_row(mb, i, r2, g);
          *reinterpret_cast<float2*>(h_s + r * ld + col) =
              make_float2(leaky(acc[h][i][j][2 * r2] + b0),
                          leaky(acc[h][i][j][2 * r2 + 1] + b1));
        }
    }
}

// dz = acc * leaky'(h), written over h in h_s (the next product's
// operand); under SUMS, cs[h][j][q] gets the lane's part of column nb +
// 32 h + 8 j + 2 t + q's sum.
template <bool SUMS, int H, int NT>
__device__ __forceinline__ void dz_tile(const float (&acc)[H][2][NT][4],
                                        float* h_s, int ld,
                                        float (&cs)[H][NT][2], int mb, int nb,
                                        int g, int t) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = nb + 32 * h + 8 * j + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          float2* at = reinterpret_cast<float2*>(
              h_s + frag_row(mb, i, r2, g) * ld + col);
          const float2 hv = *at;
          const float2 d =
              make_float2(acc[h][i][j][2 * r2] * dleaky(hv.x),
                          acc[h][i][j][2 * r2 + 1] * dleaky(hv.y));
          *at = d;
          if constexpr (SUMS) {
            cs[h][j][0] += d.x;
            cs[h][j][1] += d.y;
          }
        }
    }
}

// The scratch is written from shared memory by the bulk-copy engine, a
// row a thread: `publish` makes the block's stores to a tile visible to
// it (every thread's proxy fence, then a barrier); `to_scratch` then
// copies `cols` floats of each of the tile's rows < `rows` (row stride
// ld) to dst (row stride gld), asynchronously; `scratch_read` waits until
// the engine has read every tile its thread copied from (before a tile is
// overwritten; a barrier must follow), `scratch_done` until it has
// written them (before the block exits).
__device__ __forceinline__ void publish() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void to_scratch(const float* s, int ld, float* dst,
                                           int gld, int cols, int rows) {
  if ((int)threadIdx.x < rows) {
    const int r = threadIdx.x;
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst + (size_t)r * gld),
        "r"(smem_addr(s + r * ld)), "r"(cols * 4)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

__device__ __forceinline__ void scratch_read() {
  if (threadIdx.x < kDwRows)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void scratch_done() {
  if (threadIdx.x < kDwRows)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The warp's column partials cs into red[wm][column] (red: [2][kD3]).
template <int H, int NT>
__device__ __forceinline__ void put_sums(const float (&cs)[H][NT][2],
                                         float* red, int wm, int nb, int g,
                                         int t) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float v = group_sum(cs[h][j][q]);
        if (g == 0) red[wm * kD3 + nb + 32 * h + 8 * j + 2 * t + q] = v;
      }
}

// The block's sum of each of n columns, the two row warps' in order,
// into out (after a barrier that follows put_sums).
__device__ __forceinline__ void take_sums(const float* red, int n,
                                          float* out) {
  if ((int)threadIdx.x < n)
    out[threadIdx.x] = red[threadIdx.x] + red[kD3 + threadIdx.x];
}

// The backward's row pass. BF: kRound; MODE: kDx (dx only), kDw (the
// scratch and partials for dW/db) or kFull (both).
template <bool BF, int MODE>
__global__ void __launch_bounds__(kDwThreads, 1)
    disc_row_tc_kernel(const DiscArgs a) {
  constexpr bool DW = MODE != kDx, DX = MODE != kDw;
  extern __shared__ __align__(16) float smem[];
  float* g_s = smem;                               // [kDwRows]
  float* x_s = g_s + kDwRows;                      // [kDwRows][kLd0], then
  float* dz4_s = x_s;                              //   the dz4 chunk, kLdz
  float* h1_s = x_s + kDwRows * kLdz;              // [kDwRows][kLd1]
  float* h2_s = h1_s + kDwRows * kLd1;             // [kDwRows][kLd2]
  float* h3_s = h2_s + kDwRows * kLd2;             // [kDwRows][kLd3]
  float* ring = h3_s + kDwRows * kLd3;             // kRing x kStageF
  float* red = ring + kRing * kStageF;             // 2 x [2][kD3]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp / kDwWarpsN, wn = warp % kDwWarpsN, mb = wm * 32;
  const size_t g0 = (size_t)blockIdx.x * kDwRows;
  const int rows = (int)min((long long)kDwRows, (long long)a.m - (long long)g0);
  constexpr int total = kSlices + (DX ? 1 : 0);
  // dW's outputs: the block's partials and the tile's scratch rows.
  float* prow = DW ? a.part + (size_t)blockIdx.x * kPartCols : nullptr;
  float* dzs = DW ? a.dzs + g0 * kDzCols : nullptr;
  float* hs = DW ? a.hs + g0 * kHCols : nullptr;

  issue<false>(ring, a, 0, total);
  issue<false>(ring, a, 1, total);
  for (int e = threadIdx.x; e < kDwRows * kDiscMaxK; e += kDwThreads) {
    const int r = e / kDiscMaxK, c = e % kDiscMaxK;
    x_s[r * kLd0 + c] =
        r < rows && c < a.k ? __ldg(a.x + (g0 + r) * a.k + c) : 0.f;
  }
  if (threadIdx.x < kDwRows)
    g_s[threadIdx.x] = (int)threadIdx.x < rows
                           ? __ldg(a.g + g0 + threadIdx.x) : 0.f;

  // The ring's next slice: landed, visible to every warp (and so is
  // everything written to shared memory before the call), and the slice
  // kRing - 1 ahead issued into the stage the previous one freed.
  int q = 0;
  const auto next = [&]() {
    cp_wait<kRing - 2>();
    __syncthreads();
    issue<false>(ring, a, q + kRing - 1, total);
    return ring + (q++ % kRing) * kStageF;
  };

  using C1 = Cols<kD1>;
  using C2 = Cols<kD2>;
  using C3 = Cols<kD3>;
  using C4 = Cols<kC4>;
  {  // h1 = leaky(x W1^T + b1), k <= 64 in one slice
    float acc[C1::H][2][C1::NT][4] = {};
    slice_mma<BF, true, 64, 64>(acc, x_s, kLd0, 0, next(), mb, wn * C1::W,
                                gq, tq);
    hidden(acc, a.b1, h1_s, kLd1, mb, wn * C1::W, gq, tq);
  }
  {  // h2 = leaky(h1 W2^T + b2)
    float acc[C2::H][2][C2::NT][4] = {};
#pragma unroll 1
    for (int s = 0; s < kD1 / 32; ++s)
      slice_mma<BF, true, 128, 32>(acc, h1_s, kLd1, 32 * s, next(), mb,
                                   wn * C2::W, gq, tq);
    hidden(acc, a.b2, h2_s, kLd2, mb, wn * C2::W, gq, tq);
  }
  {  // h3 = leaky(h2 W3^T + b3)
    float acc[C3::H][2][C3::NT][4] = {};
#pragma unroll 1
    for (int s = 0; s < kD2 / 16; ++s)
      slice_mma<BF, true, 256, 16>(acc, h2_s, kLd2, 16 * s, next(), mb,
                                   wn * C3::W, gq, tq);
    hidden(acc, a.b3, h3_s, kLd3, mb, wn * C3::W, gq, tq);
    if constexpr (DW) {
      publish();
      to_scratch(h1_s, kLd1, hs, kHCols, kD1, rows);
      to_scratch(h2_s, kLd2, hs + kD1, kHCols, kD2, rows);
      to_scratch(h3_s, kLd3, hs + kD1 + kD2, kHCols, kD3, rows);
    }
  }

  // Layer 4 by chunks of kC4 columns: z4, then dz4 = g w5 leaky'(h4)
  // (with dW5's and db4's partials for dW), then dh3 += dz4 W4[chunk].
  static_assert(C4::H == 1, "a warp's z4 columns in one part");
  float dh[C3::H][2][C3::NT][4] = {};
#pragma unroll 1
  for (int c = 0; c < kD4 / kC4; ++c) {
    const int oc = c * kC4;
    if (DW && c) scratch_read();    // the last chunk's dz4 is copied out
    float z[1][2][C4::NT][4] = {};
#pragma unroll 1
    for (int s = 0; s < kD3 / 32; ++s)
      slice_mma<BF, true, 128, 32>(z, h3_s, kLd3, 32 * s, next(), mb,
                                   wn * C4::W, gq, tq);
    float sw5[1][C4::NT][2] = {}, sb4[1][C4::NT][2] = {};
#pragma unroll
    for (int j = 0; j < C4::NT; ++j) {
      const int col = wn * C4::W + 8 * j + 2 * tq;
      float bias[2], w5[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bias[e] = __ldg(a.b4 + oc + col + e);
        w5[e] = operand(__ldg(a.w5 + oc + col + e), BF);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int r = frag_row(mb, i, r2, gq);
          const float gv = operand(g_s[r], BF);
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float hv = leaky(z[0][i][j][2 * r2 + e] + bias[e]);
            d[e] = (gv * w5[e]) * dleaky(hv);
            if constexpr (DW) {
              sw5[0][j][e] = fmaf(operand(hv, BF), gv, sw5[0][j][e]);
              sb4[0][j][e] += d[e];
            }
          }
          *reinterpret_cast<float2*>(dz4_s + r * kLdz + col) =
              make_float2(d[0], d[1]);
        }
    }
    if constexpr (DW) {
      put_sums(sw5, red, wm, wn * C4::W, gq, tq);
      put_sums(sb4, red + 2 * kD3, wm, wn * C4::W, gq, tq);
      publish();
      to_scratch(dz4_s, kLdz, dzs + kDz4 + oc, kDzCols, kC4, rows);
      take_sums(red, kC4, prow + oc);
      take_sums(red + 2 * kD3, kC4, prow + kPB4 + oc);
    }
#pragma unroll 1
    for (int s = 0; s < kC4 / 16; ++s)
      slice_mma<BF, false, 256, 16>(dh, dz4_s, kLdz, 16 * s, next(), mb,
                                    wn * C3::W, gq, tq);
  }
  {  // dz3 = dh3 leaky'(h3), over h3
    float cs[C3::H][C3::NT][2] = {};
    if constexpr (DW) scratch_read();   // h1..h3 are copied out
    __syncthreads();
    dz_tile<DW>(dh, h3_s, kLd3, cs, mb, wn * C3::W, gq, tq);
    if constexpr (DW) {
      put_sums(cs, red, wm, wn * C3::W, gq, tq);
      publish();
      to_scratch(h3_s, kLd3, dzs + kDz3, kDzCols, kD3, rows);
      take_sums(red, kD3, prow + kPB3);
    }
  }
  {  // dh2 = dz3 W3, dz2 = dh2 leaky'(h2), over h2
    float acc[C2::H][2][C2::NT][4] = {}, cs[C2::H][C2::NT][2] = {};
#pragma unroll 1
    for (int s = 0; s < kD3 / 32; ++s)
      slice_mma<BF, false, 128, 32>(acc, h3_s, kLd3, 32 * s, next(), mb,
                                    wn * C2::W, gq, tq);
    dz_tile<DW>(acc, h2_s, kLd2, cs, mb, wn * C2::W, gq, tq);
    if constexpr (DW) {
      put_sums(cs, red, wm, wn * C2::W, gq, tq);
      publish();
      to_scratch(h2_s, kLd2, dzs + kDz2, kDzCols, kD2, rows);
      take_sums(red, kD2, prow + kPB2);
    }
  }
  {  // dh1 = dz2 W2, dz1 = dh1 leaky'(h1), over h1
    float acc[C1::H][2][C1::NT][4] = {}, cs[C1::H][C1::NT][2] = {};
#pragma unroll 1
    for (int s = 0; s < kD2 / 64; ++s)
      slice_mma<BF, false, 64, 64>(acc, h2_s, kLd2, 64 * s, next(), mb,
                                   wn * C1::W, gq, tq);
    dz_tile<DW>(acc, h1_s, kLd1, cs, mb, wn * C1::W, gq, tq);
    if constexpr (DW) {
      put_sums(cs, red, wm, wn * C1::W, gq, tq);
      publish();
      to_scratch(h1_s, kLd1, dzs, kDzCols, kD1, rows);
      take_sums(red, kD1, prow + kPB1);
    }
  }
  if constexpr (DX) {  // dx = dz1 W1 (k <= 64 columns)
    float acc[C1::H][2][C1::NT][4] = {};
    slice_mma<BF, false, 64, 64>(acc, h1_s, kLd1, 0, next(), mb, wn * C1::W,
                                 gq, tq);
#pragma unroll
    for (int j = 0; j < C1::NT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = frag_row(mb, i, r2, gq);
            const int col = wn * C1::W + 8 * j + 2 * tq + e;
            if (r < rows && col < a.k)
              a.dx[(g0 + r) * a.k + col] = acc[0][i][j][2 * r2 + e];
          }
  }
  cp_wait<0>();
  if constexpr (DW) scratch_done();
}

// The forward: logits of kFwdRows rows a block (2 row warps of 64 rows,
// 4 column warps). h3 is computed by halves of 128 columns, the first
// into the space of x and h1, the second into that of h2 once every warp
// has read h2; layer 4 by chunks of 128 columns, each lane folding its
// h4 = leaky(z4 + b4) times w5 into its rows' partial logits.
template <bool BF>
__global__ void __launch_bounds__(kDwThreads, 1)
    disc_fwd_tc_kernel(const DiscArgs a) {
  constexpr int MT = kFwdRows / 32;        // m16 tiles a warp
  static_assert(kLd0 + kLd1 >= kLdz && kLd2 == kLdz, "h3's halves fit");
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                       // [kFwdRows][kLd0]
  float* h1_s = x_s + kFwdRows * kLd0;     // [kFwdRows][kLd1]
  float* h2_s = h1_s + kFwdRows * kLd1;    // [kFwdRows][kLd2]
  float* h3a_s = x_s;                      // h3[:, :128], [kFwdRows][kLdz]
  float* h3b_s = h2_s;                     // h3[:, 128:], [kFwdRows][kLdz]
  float* ring = h2_s + kFwdRows * kLd2;    // kRing x kStageF
  float* red = ring + kRing * kStageF;     // [kDwWarpsN][kFwdRows]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wn = warp % kDwWarpsN, mb = warp / kDwWarpsN * (kFwdRows / 2);
  const size_t g0 = (size_t)blockIdx.x * kFwdRows;
  const int rows =
      (int)min((long long)kFwdRows, (long long)a.m - (long long)g0);

  issue<true>(ring, a, 0, kFwdSlices);
  issue<true>(ring, a, 1, kFwdSlices);
  for (int e = threadIdx.x; e < kFwdRows * kDiscMaxK; e += kDwThreads) {
    const int r = e / kDiscMaxK, c = e % kDiscMaxK;
    x_s[r * kLd0 + c] =
        r < rows && c < a.k ? __ldg(a.x + (g0 + r) * a.k + c) : 0.f;
  }
  int q = 0;
  const auto next = [&]() {   // as the backward's
    cp_wait<kRing - 2>();
    __syncthreads();
    issue<true>(ring, a, q + kRing - 1, kFwdSlices);
    return ring + (q++ % kRing) * kStageF;
  };

  using C1 = Cols<kD1>;
  using C2 = Cols<kD2>;
  using C4 = Cols<kC4>;
  {  // h1 = leaky(x W1^T + b1)
    float acc[C1::H][MT][C1::NT][4] = {};
    slice_mma<BF, true, 64, 64>(acc, x_s, kLd0, 0, next(), mb, wn * C1::W,
                                gq, tq);
    hidden(acc, a.b1, h1_s, kLd1, mb, wn * C1::W, gq, tq);
  }
  {  // h2 = leaky(h1 W2^T + b2)
    float acc[C2::H][MT][C2::NT][4] = {};
#pragma unroll 1
    for (int s = 0; s < kD1 / 32; ++s)
      slice_mma<BF, true, 128, 32>(acc, h1_s, kLd1, 32 * s, next(), mb,
                                   wn * C2::W, gq, tq);
    hidden(acc, a.b2, h2_s, kLd2, mb, wn * C2::W, gq, tq);
  }
  // h3 = leaky(h2 W3^T + b3) by halves. x and h1 are dead once every
  // warp is past the first h3 slice's barrier; h2 once every warp has
  // taken the last one.
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float acc[1][MT][C4::NT][4] = {};
#pragma unroll 1
    for (int s = 0; s < kD2 / 32; ++s)
      slice_mma<BF, true, 128, 32>(acc, h2_s, kLd2, 32 * s, next(), mb,
                                   wn * C4::W, gq, tq);
    if (half) __syncthreads();
    hidden(acc, a.b3 + half * kC4, half ? h3b_s : h3a_s, kLdz, mb,
           wn * C4::W, gq, tq);
  }

  // Layer 4 by chunks of kC4 columns, folded into the logit.
  float lsum[MT][2] = {};
#pragma unroll 1
  for (int c = 0; c < kD4 / kC4; ++c) {
    float z[1][MT][C4::NT][4] = {};
#pragma unroll 1
    for (int s = 0; s < kD3 / 32; ++s)
      slice_mma<BF, true, 128, 32>(z, s < 4 ? h3a_s : h3b_s, kLdz,
                                   32 * (s & 3), next(), mb, wn * C4::W,
                                   gq, tq);
#pragma unroll
    for (int j = 0; j < C4::NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c * kC4 + wn * C4::W + 8 * j + 2 * tq + e;
        const float bias = __ldg(a.b4 + col);
        const float w5 = operand(__ldg(a.w5 + col), BF);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2)
            lsum[i][r2] = fmaf(
                operand(leaky(z[0][i][j][2 * r2 + e] + bias), BF), w5,
                lsum[i][r2]);
      }
  }
  // The logit: the lane group's 32 columns, then the column warps in
  // order, then b5.
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      float v = lsum[i][r2];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tq == 0) red[wn * kFwdRows + frag_row(mb, i, r2, gq)] = v;
    }
  __syncthreads();
  if ((int)threadIdx.x < rows) {
    float s = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kDwWarpsN; ++w)
      s += red[w * kFwdRows + threadIdx.x];
    a.logits[g0 + threadIdx.x] = __fadd_rn(s, __ldg(a.b5));
  }
  cp_wait<0>();
}

// *out = the sum of g's m values in fp64, in a fixed order, rounded once.
__global__ void __launch_bounds__(kSumThreads)
sum_g_kernel(const float* __restrict__ g, int m, float* __restrict__ out) {
  __shared__ double red[kSumThreads / 32];
  double s = 0.0;
  for (int r = threadIdx.x; r < m; r += kSumThreads) s += (double)__ldg(g + r);
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kSumThreads / 32; ++w) t += red[w];
    *out = (float)t;
  }
}

template <typename K>
int launch_disc(K kernel, size_t floats, int blocks, const DiscArgs& a,
           cudaStream_t stream) {
  const size_t bytes = floats * sizeof(float);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, kDwThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_row(const DiscArgs& a, int tiles, cudaStream_t stream) {
  return (a.prec & kRound)
             ? launch_disc(disc_row_tc_kernel<true, MODE>, kSmemFloats, tiles,
                           a, stream)
             : launch_disc(disc_row_tc_kernel<false, MODE>, kSmemFloats,
                           tiles, a, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The input and weights every pass reads (the ring copies W2..W4 in 16
// bytes), and no output of another pass: `logits` for the forward, `g`
// for the backward, dW's buffers for dW; `dx` is checked by the callers.
bool disc_args_ok(const DiscArgs& a, bool fwd, bool dw) {
  return a.m > 0 && a.k > 0 && a.k <= kDiscMaxK && a.x && a.w1 && a.w2 &&
         a.w3 && a.w4 && a.w5 && a.b1 && a.b2 && a.b3 && a.b4 && a.b5 &&
         aligned16(a.w2) && aligned16(a.w3) && aligned16(a.w4) &&
         fwd == (a.logits != nullptr) && fwd != (a.g != nullptr) &&
         dw == (a.grad && a.part && a.dzs && a.hs && a.part_w) &&
         (dw || !(a.grad || a.part || a.dzs || a.hs || a.part_w)) &&
         (!dw || (aligned16(a.dzs) && aligned16(a.hs)));
}

// logits = the stack on x.
int disc_fwd_tc(const DiscArgs& a, cudaStream_t stream) {
  if (!disc_args_ok(a, true, false) || a.dx) return kErrArgs;
  const int blocks = ceil_div(a.m, kFwdRows);
  return (a.prec & kRound)
             ? launch_disc(disc_fwd_tc_kernel<true>, kFwdSmemFloats, blocks,
                           a, stream)
             : launch_disc(disc_fwd_tc_kernel<false>, kFwdSmemFloats, blocks,
                           a, stream);
}

// dx only: the frozen discriminator of the generator step.
int disc_dx_tc(const DiscArgs& a, cudaStream_t stream) {
  if (!disc_args_ok(a, false, false) || !a.dx) return kErrArgs;
  return launch_row<kDx>(a, ceil_div(a.m, kDwRows), stream);
}

// dW/db, and dx too when a.dx is set (the full backward): the row pass,
// then dW1..dW4 on the GEMM core.
int disc_dw_tc(const DiscArgs& a, cudaStream_t stream) {
  const int splits[4] = {a.split1, a.split2, a.split3, a.split4};
  for (int s : splits)
    if (s <= 0 || s > 65535) return kErrArgs;
  if (!disc_args_ok(a, false, true)) return kErrArgs;
  const int tiles = ceil_div(a.m, kDwRows);
  const bool bf = a.prec & kRound;
  int e = a.dx ? launch_row<kFull>(a, tiles, stream)
               : launch_row<kDw>(a, tiles, stream);
  if (e) return e;
  const GradLayout lay(a.k);
  // dW5 and db1..db4: the blocks' partials in fp64, in block order.
  if ((e = colsum(a.part, kPartCols, tiles, kPartCols, 1, a.grad + lay.w[4],
                  0, stream)))
    return e;
  sum_g_kernel<<<1, kSumThreads, 0, stream>>>(a.g, a.m, a.grad + lay.b[4]);
  if ((e = (int)cudaGetLastError())) return e;
  // dW_l = dz_l^T h_(l-1) on the GEMM core, h0 = x.
  const int outs[4] = {kD1, kD2, kD3, kD4}, ins[4] = {a.k, kD1, kD2, kD3};
  const int dz_off[4] = {0, kDz2, kDz3, kDz4}, h_off[4] = {0, 0, kD1,
                                                          kD1 + kD2};
  float* part_w = a.part_w;
  for (int l = 0; l < 4; ++l) {
    const long long wsz = (long long)outs[l] * ins[l];
    Gemm g{};
    g.m = outs[l], g.n = ins[l], g.k = a.m, g.batch = 1;
    g.splits = splits[l];
    g.sam = 1, g.sak = kDzCols;                  // A[o][r] = dz[r][o]
    g.a = a.dzs + dz_off[l];
    if (l == 0) {
      g.sbk = a.k, g.sbn = 1, g.b = a.x;         // B[r][i] = x[r][i]
    } else {
      g.sbk = kHCols, g.sbn = 1, g.b = a.hs + h_off[l];
    }
    g.ldc = ins[l], g.bsc = wsz, g.c = part_w;
    if ((e = gemm(g, bf, stream))) return e;
    if ((e = split_sum(part_w, splits[l], wsz, 1, a.grad + lay.w[l], stream)))
      return e;
    part_w += splits[l] * wsz;
  }
  return 0;
}

}  // namespace
}  // namespace pointtpu

using pointtpu::DiscArgs;

// The entry points: each selects the tensors' device, then launches on
// `stream`. Returns 0, a cudaError_t, kErrArgs or kErrSmem.
extern "C" int pt_disc_fwd(const DiscArgs* a, int device,
                           cudaStream_t stream) {
  const cudaError_t e = pointtpu::use_device(device);
  return e != cudaSuccess ? (int)e : pointtpu::disc_fwd_tc(*a, stream);
}

extern "C" int pt_disc_bwd_dx(const DiscArgs* a, int device,
                              cudaStream_t stream) {
  const cudaError_t e = pointtpu::use_device(device);
  return e != cudaSuccess ? (int)e : pointtpu::disc_dx_tc(*a, stream);
}

extern "C" int pt_disc_bwd_dw(const DiscArgs* a, int device,
                              cudaStream_t stream) {
  const cudaError_t e = pointtpu::use_device(device);
  return e != cudaSuccess ? (int)e : pointtpu::disc_dw_tc(*a, stream);
}
