// The generator's passes on the tensor cores: the trunk's F1, F2 and B1
// and all six of the seg head's, P1, Pmid, P4, B4, Bmid and B1.
//
// Replaces the TPU kernels
// adversarial_learning_on_pointclouds_tpu/ops/kernels/trunk_train.py::
// _f1_call (trunk F1: pallas_call at trunk_train.py:121, conv2 and BN2's
// statistics, c 64 -> 128; trunk3_train's conv1, 3 -> 64), _f2_call (trunk F2: pallas_call at trunk_train.py:212, conv3 + BN3's
// statistics + the max-pool's extrema, c 128 -> 1024), _b1_call (trunk
// B1: pallas_call at trunk_train.py:309, the backward through conv3 +
// BN3 + max-pool of every trunk) and seg_head_train.py::_pmid_call (Pmid:
// pallas_call at seg_head_train.py:118, a BN + ReLU and the next layer
// with its statistics: 512 -> 256 and 256 -> 128 in the seg head, 64 ->
// 128 in trunk3_train), _p1_call (P1: :75, the point half of layer 1
// with the global half as a per-cloud addend and BN1's statistics, 64 ->
// 512), _p4_call (P4: :155, BN3 + ReLU, conv4 and the per-point
// log_softmax, 128 -> 50 parts), _b4_call (B4: :206, the softmax and conv4
// backward, 128 -> 50 parts), _bmid_call (Bmid: :275, a BN backward and the
// matmul backward to the previous layer: 256 -> 512 and 128 -> 256 in
// the seg head, 128 -> 64 in trunk3_train) and _b1_call (head B1: :335,
// BN1's backward, dpf, dW1a, db1 and the per-cloud sums r: 512 -> 64 in
// the seg head, 64 -> 3 in trunk3_train).
//
// What bounds them on the H100: matmuls. At B=32 N=2048 (65,536 rows) F2
// is one 17.2-GFLOP product (z3 = h2 W3^T) and trunk B1 three (z3
// recomputed, dy2 = dz3 W3, dW3 = dz3^T h2), past fp32 FMA's 67 TFLOP/s
// and bf16's need of the tensor cores; Pmid is one product of 17.2 (512
// -> 256) or 4.3 GFLOP, Bmid two of 8.6 (256 -> 512) or 4.3, head B1 two
// of 4.3, B4 three of 0.8. Then traffic: head B1 reads two [65,536 x
// 512] stashes and writes dz (134 MB in fp32) for its dW; F1 (1.1 GFLOP)
// is bound by its bytes, x in (16.8 MB) and z2 out (33.5 MB in fp32, 16.8
// in bf16), and B4 nearly so (z3 and dy3 33.5 MB each in fp32, dlp 13.1);
// so are P1 (4.3 GFLOP; pf in, 16.8 MB, and z1 out, 134 MB in fp32, 67
// in bf16) and P4 (0.84 GFLOP; z3 in, 33.5 MB in fp32, 16.8 in bf16, and
// logp out, 13.1 MB). The CUDA-core kernels they replace ran them as fp32
// FMAs (bf16 operands too) on 64-point tiles with W staged through
// registers, and recomputed z3 a second time for dW3 (B4: z4, for dW4).
//
// What the design does about that:
//
// * Every product on the tensor cores through mma.cuh's fragment layer
//   (the GEMM core's): fp32 as 3xTF32, each 8-deep step summed from zero
//   and added to the fp32 accumulator by a round-to-nearest FADD; bf16
//   (kRound) operands rounded nearest-even at fragment load, fp32 sums.
//   A block of 8 warps owns 128 points of one cloud (kTcRows).
// * F2 and B1 share their prologue and first GEMM (load_h2, load_w3,
//   gemm1), so B1 recomputes exactly the z3 whose extrema F2 found. The
//   block keeps h2 = relu(bn2(z2)) in shared memory (the BN2 prologue
//   applied once). It walks c3 in chunks of 64 channels: GEMM 1 z3c = h2
//   W3[chunk]^T (K = 128), then an epilogue in registers.
// * F2's epilogue adds b3 and reduces the chunk over the tile's rows:
//   column sum and sum of squares (per-block partials) and, per channel,
//   a packed 64-bit key of the max and of the min with its point (the
//   value's order-preserving bits over the point index), merged into the
//   cloud's keys by one atomicMax / atomicMin per block and channel, so
//   the first point wins whatever the order of the blocks. z3 never
//   leaves the SM. Shared memory 166 KB (h2 64 KB, the W3 ring 96 KB),
//   one block per SM.
// * Pmid is F2's shape of work without the extrema, at any c_in: a whole
//   h tile (256 KB at c_in 512 in fp32) does not fit, so the stash and W
//   stream along c_in in 32-deep chunks through one ring, the stash as
//   stored (bf16 or fp32). Each landed chunk takes the prologue relu(x *
//   sc + sh) once, with bn_affine's roundings (h equals the plain
//   version's bit for bit), into an fp32 h stage; then z += h W^T over
//   the block's 128 output columns (blockIdx.z). The epilogue adds b,
//   stores z (bf16 nearest-even under kZBf16) and reduces the column sum
//   and sum of squares of the unrounded z to per-block partials. 130 KB.
// * B1's epilogue (+ b3, zhat3, the winner term, coef1 / coef2) takes
//   db3's per-block partials from the unrounded dz3c and leaves dz3c in
//   shared memory, then GEMM 2 acc_dy2 += dz3c W3[chunk] (K = 64) into a
//   [128 x 128] accumulator held in registers across the chunks. Both
//   GEMMs read one W3 chunk in the ring: GEMM 1 along its rows
//   (K-major), GEMM 2 along its columns (N-major). No padding keeps both
//   fragment reads free of bank conflicts (the pad that serves one
//   collides in the other), so the chunk is stored XOR-swizzled (sw_at).
//   The final epilogue masks by BN2's ReLU (h2 > 0, exactly where
//   bn_affine(z2) > 0), stores dy2 and reduces BN2's two sums.
// * Bmid's row pass: the dz tile [128 x c_out] built elementwise from the
//   zc and dy stashes straight into shared memory (db's partials from the
//   unrounded values, coalesced: a thread per column), then dyp = dz W
//   over n tiles of 128 (or 64) columns looped in the block, W streamed
//   N-major, and the same masked epilogue (dyp bf16 under kDypBf16).
// * Head B1 is Bmid's shape of work without the previous BN: the whole
//   [128 x 512] dz tile does not fit beside the ring either, so dz is
//   built chunk by chunk of 64 channels (Bmid's builder: the same fp32
//   operations, db's and r's per-block partials from the unrounded values,
//   dz written out for dW), and each chunk feeds dpf += dz_chunk
//   W1a[chunk] at once, W1a streamed N-major through the ring with c_in
//   padded by zeros to a whole n8 tile (c_in 3: rows of 12 bytes, 4-byte
//   copies). dpf is stored in fp32, unmasked. db is the colsum over every
//   block, r over each cloud's blocks, which are contiguous. 89 KB (c_in
//   64), two blocks an SM.
// * F1 keeps a 128-point tile of x and all of W2 (c_in <= 64, 32 KB
//   each in fp32) in shared memory with two blocks an SM, so one block's
//   loads are in flight while the other computes; z2 = x W2^T runs 64
//   output columns at a time into a z stage (+ b2, unrounded), which
//   gives the columns' sum and sum of squares (per-block partials) and
//   the 16-byte stores of z2 (bf16 nearest-even under kZBf16). At c_in
//   <= 4 (trunk3_train's raw points) the product is fp32 FMAs in order of
//   k, exact as cuBLAS at that depth, where 3xTF32's split is not (as
//   for strided_gemm.cu's thin_kernel), a thread per column. 106 KB
//   (c_in 64, c_out 128).
// * P1 is F1 with a per-cloud addend, z1 = (pf W1a^T + g_row[cloud]) +
//   b1 in the JAX kernel's order, at c_out 512: all of W1a (139 KB with
//   its pad) does not fit beside the tile at two blocks an SM, so a block
//   takes one slice of kF1Slice = 128 output columns (blockIdx.x, the
//   fastest grid axis: a tile's four slices are neighbouring blocks, and
//   pf's tile is read from HBM once and from L2 three times). The same
//   body (f1_tile): x 34 KB + the W slice 34 KB + the z stage 36 KB +
//   the sums 2 KB = 106 KB, two blocks an SM (launch bounds 256 x 2, at
//   most 128 registers a thread). Each slice's columns of the per-block
//   partial slots are its own, so colsum adds them as F1's.
// * P4 is B4's first half (z4_softmax: one arithmetic, so the forward's
//   logits and the backward's recompute agree bit for bit): h3 (64 KB)
//   and W4 padded by zero rows to 56 (28 KB) in shared memory, 92 KB,
//   two blocks an SM, so one block's loads of z3 are in flight while the
//   other computes (a block takes one tile). Each warp owns 16 whole rows: z4, the row's max and sum of
//   exp in quad shuffles (padded logits -inf), logp = z4 - (log(s) + m)
//   by expf / logf. The warp's rows of logp are one contiguous range of
//   16 x k floats: staged over the warp's own rows of h_s (only it read
//   them) and stored with 16-byte vectors from its first 16-byte boundary.
// * B4 keeps h3 = relu(bn3(z3)) (load_h2), W4 (50 rows padded by zeros to
//   64) and dz [128 x 64] in shared memory, 137 KB, one block per SM,
//   each block walking a contiguous range of tiles. GEMM 1 z4 = h3 W4^T
//   gives each warp 16 whole rows (N = 56, 7 n8 tiles), so the softmax
//   backward dz = dlp - softmax(z4 + b4) sum(dlp) is computed in
//   registers with quad shuffles (padded logits -inf, their dz zero).
//   GEMM 2 dy3 = dz W4 (K 56, or 64 for bf16's 16-deep steps) ends in the
//   masked epilogue (BN3's t1 / t2, dy3 bf16 under kDypBf16). GEMM 3 dW4
//   += dz^T h3 takes the tile that is already in shared memory into an
//   accumulator held across the block's tiles, one partial a block summed
//   in fp64: writing h3 and dz out for the GEMM core would add about 90
//   MB a launch. W4 and dz are each read along rows and columns, so both
//   are swizzled (sw_at).
// * Weight gradients: the backward row passes also write dz (and trunk
//   B1 and Bmid their h; head B1's h is pf itself), fp32 and unrounded,
//   to scratch, and dW = dz^T h runs on the GEMM core (strided_gemm.cu:
//   gemm, an M-major A over an N-major B, split-K over row ranges merged
//   by split_sum in fp64; B4 excepted). Writing them (302 MB at 65,536 x 1024) costs
//   the row pass about 0.08 ms on the H100, against the 17.2 GFLOP of a
//   second z3 recompute that the TPU design (VMEM-bound) paid; a
//   tensor-core dW kernel that rebuilds dz and h tile by tile, as that
//   design does, measured slower for both passes in both precisions
//   (PERF.md §6).
// * W streams through a 3-stage cp.async ring (16-byte copies where the
//   rows allow), one chunk in flight while one computes. Shared memory:
//   200 KB (B1) or up to 186 KB (Bmid at c_out 256), one block per SM.
// * Nothing carries between blocks: the statistics, t1 / t2, db and r are
//   per-block partials added by colsum in fp64 in a fixed order, each
//   group's blocks contiguous, so groups = 2 equals two groups = 1 calls
//   bit for bit (F2's sums and extrema, B1's dy2, t1, t2); a row's
//   arithmetic never depends on its neighbours. Rows past N are zero in
//   every tile and never stored, summed or ranked.

#include "mma.cuh"
#include "strided_gemm.cuh"
#include "train_bwd_tc.cuh"
#include "train_gemm.cuh"

namespace pointtpu {
namespace {

constexpr int kTcRows = 128;                // points per block, one cloud
constexpr int kRing = 3;                    // stages of the weight ring
constexpr int kC2 = 128;                    // trunk B1: c_in
constexpr int kChunk = 64;                  // trunk B1: c3 channels a chunk
constexpr int kDzLd = kChunk + 4;           // dz3 chunk row stride
constexpr int kHeadK = 32;                  // Bmid: W rows (k) a stage
constexpr int kPmidN = 128;                 // Pmid: output columns a block
constexpr int kXbLd = kBk + 8;              // Pmid: bf16 x stage row (bf16s)
constexpr int kB1Chunk = 64;                // head B1: c_out channels a chunk
constexpr int kF1Ld = 64 + 4;               // F1: x and W row (K-major, c_in <= 64)
constexpr int kF1N = 64;                    // F1: output columns an epilogue
constexpr int kF1Slice = 128;               // F1, P1: output columns a block
constexpr int kF1ZLd = kF1N + 8;            // F1: z stage row
constexpr int kB4N = 56;                    // B4: z4's columns, 7 n8 tiles
constexpr int kB4K = 64;                    // B4: dz's columns in shared memory

// Four consecutive elements i.. (i a multiple of 4) of an fp32 or (bf)
// bf16 tensor as fp32, in one 16- or 8-byte load.
__device__ __forceinline__ void load4(float (&v)[4], const void* p, bool bf,
                                      size_t i) {
  if (bf) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i));
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 f =
        __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + i));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  }
}

// Loads a thread issues before it uses any: one block a SM leaves the
// loads' latency exposed unless many are in flight.
constexpr int kBatch = 8;

// h2 = relu(z2 * sc + sh) (bn_affine's roundings) of the tile of `rows`
// points from row g0 into h_s (sw_at; rows past N zero) and, unless hs
// is null, to hs (B1's dW operand), four columns a load. sc and sh are
// the cloud's group's rows; rows past N read the last row.
__device__ __forceinline__ void load_h2(float* h_s, const void* zp, bool zpbf,
                                        const float* scp, const float* shp,
                                        float* hs, size_t g0, int rows) {
  for (int u0 = 0; u0 < kTcRows * kC2 / 4 / kThreads; u0 += kBatch) {
    float v[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = (threadIdx.x + (u0 + u) * kThreads) * 4;
      load4(v[u], zp, zpbf, (g0 + min(e / kC2, rows - 1)) * kC2 + e % kC2);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = (threadIdx.x + (u0 + u) * kThreads) * 4;
      const int r = e / kC2, k = e % kC2;
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) {
        h.x = fmaxf(bn_affine(v[u][0], __ldg(scp + k), __ldg(shp + k)), 0.f);
        h.y = fmaxf(bn_affine(v[u][1], __ldg(scp + k + 1),
                              __ldg(shp + k + 1)), 0.f);
        h.z = fmaxf(bn_affine(v[u][2], __ldg(scp + k + 2),
                              __ldg(shp + k + 2)), 0.f);
        h.w = fmaxf(bn_affine(v[u][3], __ldg(scp + k + 3),
                              __ldg(shp + k + 3)), 0.f);
        if (hs) *reinterpret_cast<float4*>(hs + (g0 + r) * kC2 + k) = h;
      }
      *reinterpret_cast<float4*>(h_s + sw_at(r, k)) = h;
    }
  }
}

// Chunk c of W3 (its rows c * kChunk ..; row stride ldw) into ring stage
// c % kRing, XOR-swizzled: one commit group a call, empty past the last
// chunk.
__device__ __forceinline__ void load_w3(float* w_s, const float* w, int ldw,
                                        int c, int chunks) {
  if (c < chunks) {
    float* s = w_s + (c % kRing) * (kChunk * kC2);
    const float* src = w + (size_t)c * kChunk * ldw;
    for (int e = threadIdx.x; e < kChunk * kC2 / 4; e += kThreads) {
      const int r = e / (kC2 / 4), k = (e % (kC2 / 4)) * 4;
      cp16(s + sw_at(r, k), src + (size_t)r * ldw + k, 16);
    }
  }
  cp_commit();
}

// GEMM 1 of a chunk, shared by F2 and B1: z = h2 W3[chunk]^T (before b3)
// for warp (wm, wn)'s 32 rows by 32 of the chunk's channels.
template <bool BF>
__device__ __forceinline__ void gemm1(float (&z)[2][4][4], const float* h_s,
                                      const float* ws, int wm, int wn,
                                      int gq, int tq) {
  const auto fh = [h_s](int m, int k) { return h_s[sw_at(m, k)]; };
  const auto fw = [ws](int n, int k) { return ws[sw_at(n, k)]; };
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[i][j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kC2; kk += mma_depth(BF))
    mma_step<2, 4, BF>(z, fh, fw, wm * 32, wn * 32, kk, gq, tq);
}

// The largest and the smallest key of lane group t's 8 lanes.
__device__ __forceinline__ unsigned long long group_max(unsigned long long v) {
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = max(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return max(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

__device__ __forceinline__ unsigned long long group_min(unsigned long long v) {
  v = min(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = min(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return min(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// Trunk F2, the forward half of B1's first GEMM: per 128-point tile of
// one cloud the same h2 and z3 = h2 W3^T + b3, chunk by chunk of 64
// channels, reduced in registers to BN3's per-block column sum and sum of
// squares and to the cloud's extrema keys; z3 never leaves the SM. Warps
// are 4 (rows) by 2 (columns), as B1's GEMM 1. BF: kRound; G: groups > 1.
template <bool BF, bool G>
__global__ void __launch_bounds__(kThreads, 1) f2_tc_kernel(const RowFwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                              // [kTcRows][kC2], sw_at
  float* w_s = h_s + kTcRows * kC2;               // kRing x [kChunk][kC2]
  float* red = w_s + kRing * kChunk * kC2;        // [2][4][kChunk] sum, ssq
  auto* red_k = reinterpret_cast<unsigned long long*>(
      red + 8 * kChunk);                          // [2][4][kChunk] max, min
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.y, p0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, a.n - p0);
  const size_t g0 = (size_t)b * a.n + p0;
  const int c_out = a.c_out, chunks = c_out / kChunk;
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;
  const size_t blocks = (size_t)gridDim.x * gridDim.y;
  unsigned long long* kmax = a.keys + (size_t)b * c_out;
  unsigned long long* kmin = kmax + (size_t)a.batch * c_out;

  load_w3(w_s, a.w, a.ldw, 0, chunks);
  load_w3(w_s, a.w, a.ldw, 1, chunks);
  load_h2(h_s, a.x, BF && (a.prec & kXBf16),
          group_row<G>(a.sc, b, a.batch, a.groups, kC2),
          group_row<G>(a.sh, b, a.batch, a.groups, kC2), nullptr, g0, rows);
  for (int c = 0; c < chunks; ++c) {
    cp_wait<kRing - 2>();
    __syncthreads();          // chunk c landed; chunk c - 1 and red are read
    load_w3(w_s, a.w, a.ldw, c + kRing - 1, chunks);
    const int oc = c * kChunk;
    float z[2][4][4];
    gemm1<BF>(z, h_s, w_s + (c % kRing) * (kChunk * kC2), wm, wn, gq, tq);
    // z3 = z + b3 of the rows < N: the sums of the unrounded values, the
    // keys with each value's point.
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = wn * 32 + 8 * j + 2 * tq + q;
        const float bias = __ldg(a.bias + oc + col);
        float s = 0.f, ss = 0.f;
        unsigned long long hi = 0ull, lo = ~0ull;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + 16 * i + gq + 8 * h;
            if (r < rows) {
              const float v = z[i][j][2 * h + q] + bias;
              s += v;
              ss += v * v;
              hi = max(hi, max_key(v, p0 + r));
              lo = min(lo, min_key(v, p0 + r));
            }
          }
        s = group_sum(s);
        ss = group_sum(ss);
        hi = group_max(hi);
        lo = group_min(lo);
        if (gq == 0) {
          red[wm * kChunk + col] = s;
          red[(4 + wm) * kChunk + col] = ss;
          red_k[wm * kChunk + col] = hi;
          red_k[(4 + wm) * kChunk + col] = lo;
        }
      }
    __syncthreads();          // red written
    if (threadIdx.x < kChunk) {
      const int t = threadIdx.x, o = oc + t;
      a.part[blk * c_out + o] = ((red[t] + red[kChunk + t]) +
                                 red[2 * kChunk + t]) + red[3 * kChunk + t];
      a.part[(blocks + blk) * c_out + o] =
          ((red[4 * kChunk + t] + red[5 * kChunk + t]) +
           red[6 * kChunk + t]) + red[7 * kChunk + t];
      unsigned long long hi = red_k[t], lo = red_k[4 * kChunk + t];
      for (int w = 1; w < 4; ++w) {
        hi = max(hi, red_k[w * kChunk + t]);
        lo = min(lo, red_k[(4 + w) * kChunk + t]);
      }
      atomicMax(kmax + o, hi);
      atomicMin(kmin + o, lo);
    }
  }
  cp_wait<0>();
}

// Warps are 4 (rows, 32 each) by 2 (columns). Trunk B1: BF is kRound,
// G groups > 1.
template <bool BF, bool G>
__global__ void __launch_bounds__(kThreads, 1) b1_tc_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                              // [kTcRows][kC2], sw_at
  float* dz_s = h_s + kTcRows * kC2;              // [kTcRows][kDzLd]
  float* w_s = dz_s + kTcRows * kDzLd;            // kRing x [kChunk][kC2]
  float* red_b = w_s + kRing * kChunk * kC2;      // [4][kChunk]
  float* red_t = red_b + 4 * kChunk;              // [2][4][kC2]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.y, p0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, a.n - p0);
  const size_t g0 = (size_t)b * a.n + p0;
  const int c_out = a.c_out, chunks = c_out / kChunk;
  float* prow = a.part + ((size_t)b * gridDim.x + blockIdx.x) *
                             (2 * kC2 + c_out);
  const bool zpbf = BF && (a.prec & kZpBf16);
  const float* mup = group_row<G>(a.mup, b, a.batch, a.groups, kC2);
  const float* invp = group_row<G>(a.invp, b, a.batch, a.groups, kC2);
  const float* mu3 = group_row<G>(a.mu, b, a.batch, a.groups, c_out);
  const float* inv3 = group_row<G>(a.inv, b, a.batch, a.groups, c_out);
  const size_t cb = (size_t)b * c_out;       // the cloud's [batch, c3] row

  load_w3(w_s, a.w, a.ldw, 0, chunks);
  load_w3(w_s, a.w, a.ldw, 1, chunks);
  load_h2(h_s, a.zp, zpbf, group_row<G>(a.scp, b, a.batch, a.groups, kC2),
          group_row<G>(a.shp, b, a.batch, a.groups, kC2), a.hs, g0, rows);

  const auto fz = [dz_s](int m, int k) { return dz_s[m * kDzLd + k]; };
  float acc[2][8][4] = {};                        // dy2 before the mask
  for (int c = 0; c < chunks; ++c) {
    cp_wait<kRing - 2>();
    __syncthreads();          // chunk c landed; chunk c - 1 is read
    load_w3(w_s, a.w, a.ldw, c + kRing - 1, chunks);
    const float* ws = w_s + (c % kRing) * (kChunk * kC2);
    const int oc = c * kChunk;
    // GEMM 1: z3 - b3 of the chunk's 64 channels.
    float z[2][4][4];
    gemm1<BF>(z, h_s, ws, wm, wn, gq, tq);
    // dz3 = [p == idx] * s3dg - coef1 - zhat3 * coef2 (per cloud,
    // channel); db3's partial from the unrounded values.
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = wn * 32 + 8 * j + 2 * tq + q, o = oc + col;
        const float bias = __ldg(a.bias + o), m3 = __ldg(mu3 + o);
        const float i3 = __ldg(inv3 + o), k1 = __ldg(a.coef1 + cb + o);
        const float k2 = __ldg(a.coef2 + cb + o), sg = __ldg(a.s3dg + cb + o);
        const int win = __ldg(a.idx + cb + o);
        float cs = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + 16 * i + gq + 8 * h;
            float v = 0.f;
            if (r < rows) {
              const float zhat = ((z[i][j][2 * h + q] + bias) - m3) * i3;
              const float sparse = p0 + r == win ? sg : 0.f;
              v = sparse - k1 - zhat * k2;
            }
            z[i][j][2 * h + q] = v;
            cs += v;
          }
        cs = group_sum(cs);
        if (gq == 0) red_b[wm * kChunk + col] = cs;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + 16 * i + gq + 8 * h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wn * 32 + 8 * j + 2 * tq;
          const float2 v = make_float2(z[i][j][2 * h], z[i][j][2 * h + 1]);
          *reinterpret_cast<float2*>(dz_s + r * kDzLd + col) = v;
          if (r < rows)
            *reinterpret_cast<float2*>(a.dzs + (g0 + r) * c_out + oc + col) =
                v;
        }
      }
    __syncthreads();          // dz_s and red_b written
    if (threadIdx.x < kChunk) {
      const int t = threadIdx.x;
      prow[2 * kC2 + oc + t] = ((red_b[t] + red_b[kChunk + t]) +
                                red_b[2 * kChunk + t]) + red_b[3 * kChunk + t];
    }
    // GEMM 2: dy2 += dz3c W3[chunk].
    const auto fw2 = [ws](int n, int k) { return ws[sw_at(k, n)]; };
#pragma unroll 2
    for (int kk = 0; kk < kChunk; kk += mma_depth(BF))
      mma_step<2, 8, BF>(acc, fz, fw2, wm * 32, wn * 64, kk, gq, tq);
  }
  cp_wait<0>();

  // dy2 = mask * acc, and BN2's sums t1 = sum dy2, t2 = sum dy2 * zhat2.
  float s1[8][2] = {}, s2[8][2] = {};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = wn * 64 + 8 * j + 2 * tq;
    const float m0 = __ldg(mup + k), m1 = __ldg(mup + k + 1);
    const float i0 = __ldg(invp + k), i1 = __ldg(invp + k + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + 16 * i + gq + 8 * h;
        if (r >= rows) continue;
        const size_t at = (g0 + r) * kC2 + k;
        float d0 = acc[i][j][2 * h], d1 = acc[i][j][2 * h + 1];
        if (!(h_s[sw_at(r, k)] > 0.f)) d0 = 0.f;
        if (!(h_s[sw_at(r, k + 1)] > 0.f)) d1 = 0.f;
        *reinterpret_cast<float2*>(static_cast<float*>(a.dyp) + at) =
            make_float2(d0, d1);
        const float z0 = load_val(a.zp, zpbf, at);
        const float z1 = load_val(a.zp, zpbf, at + 1);
        s1[j][0] += d0;
        s1[j][1] += d1;
        s2[j][0] += d0 * ((z0 - m0) * i0);
        s2[j][1] += d1 * ((z1 - m1) * i1);
      }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float v1 = group_sum(s1[j][q]), v2 = group_sum(s2[j][q]);
      if (gq == 0) {
        const int k = wn * 64 + 8 * j + 2 * tq + q;
        red_t[wm * kC2 + k] = v1;
        red_t[(4 + wm) * kC2 + k] = v2;
      }
    }
  __syncthreads();
  if (threadIdx.x < kC2) {
    const int k = threadIdx.x;
    prow[k] = ((red_t[k] + red_t[kC2 + k]) + red_t[2 * kC2 + k]) +
              red_t[3 * kC2 + k];
    prow[kC2 + k] = ((red_t[4 * kC2 + k] + red_t[5 * kC2 + k]) +
                     red_t[6 * kC2 + k]) + red_t[7 * kC2 + k];
  }
}

// Bmid, one group. NB: columns of dyp an n tile (128, or 64 for c_in =
// 64); warps 4 (rows) by 2 (NB / 2 columns each).
template <bool BF, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    bmid_tc_kernel(const BwdArgs a) {
  constexpr int kWld = NB + kPadMn;               // N-major W stage row
  constexpr int kNt = NB / 16;                    // n8 tiles a warp
  extern __shared__ __align__(16) float smem[];
  const int c_in = a.c_in, c_out = a.c_out, ldz = c_out + 4;
  float* dz_s = smem;                             // [kTcRows][ldz]
  float* w_s = dz_s + kTcRows * ldz;              // kRing x [kHeadK][kWld]
  float* red_t = w_s + kRing * kHeadK * kWld;     // [2][4][NB]
  float* red_b = red_t + 8 * NB;                  // [kThreads]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.y, p0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, a.n - p0);
  const size_t g0 = (size_t)b * a.n + p0;
  float* prow = a.part + ((size_t)b * gridDim.x + blockIdx.x) *
                             (2 * c_in + c_out);
  const bool zpbf = BF && (a.prec & kZpBf16);
  const bool zcbf = BF && (a.prec & kZcBf16);
  const bool dybf = BF && (a.prec & kDyBf16);
  const bool dypbf = BF && (a.prec & kDypBf16);
  const int kchunks = c_out / kHeadK, total = kchunks * (c_in / NB);

  // Ring chunk q: W rows (k) kc * kHeadK .. of n tile nt, q = nt *
  // kchunks + kc; one commit group a call, empty past the last.
  const auto load_w = [&](int q) {
    if (q < total) {
      const int nt = q / kchunks, kc = q - nt * kchunks;
      float* s = w_s + (q % kRing) * (kHeadK * kWld);
      const float* src = a.w + (size_t)kc * kHeadK * a.ldw + nt * NB;
      for (int e = threadIdx.x; e < kHeadK * NB / 4; e += kThreads) {
        const int r = e / (NB / 4), k = (e % (NB / 4)) * 4;
        cp16(s + r * kWld + k, src + (size_t)r * a.ldw + k, 16);
      }
    }
    cp_commit();
  };
  load_w(0);
  load_w(1);
  {  // dz = dy * sc - c1 - zhat * c2: thread t owns column t % c_out.
    const int c = threadIdx.x % c_out, step = kThreads / c_out;
    const float scv = __ldg(a.sc + c), muv = __ldg(a.mu + c);
    const float iv = __ldg(a.inv + c), k1 = __ldg(a.c1 + c);
    const float k2 = __ldg(a.c2 + c);
    float s = 0.f;
    // kTcRows / step rows a thread, a multiple of kBatch; rows past N
    // read the last row and are zeroed.
    for (int r0 = threadIdx.x / c_out; r0 < kTcRows; r0 += kBatch * step) {
      float zv[kBatch], dv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const size_t at = (g0 + min(r0 + u * step, rows - 1)) * c_out + c;
        zv[u] = load_val(a.zc, zcbf, at);
        dv[u] = load_val(a.dy, dybf, at);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = r0 + u * step;
        float v = 0.f;
        if (r < rows) {
          const float zhat = (zv[u] - muv) * iv;
          v = dv[u] * scv - k1 - zhat * k2;
          a.dzs[(g0 + r) * c_out + c] = v;
        }
        dz_s[r * ldz + c] = v;
        s += v;
      }
    }
    red_b[threadIdx.x] = s;
  }
  __syncthreads();
  if ((int)threadIdx.x < c_out) {
    float s = 0.f;
    for (int p = threadIdx.x; p < kThreads; p += c_out) s += red_b[p];
    prow[2 * c_in + threadIdx.x] = s;
  }

  float acc[2][kNt][4];
  for (int q = 0; q < total; ++q) {
    const int nt = q / kchunks, kc = q - nt * kchunks;
    cp_wait<kRing - 2>();
    __syncthreads();          // chunk q landed; chunk q - 1 is read
    load_w(q + kRing - 1);
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kNt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    const float* ws = w_s + (q % kRing) * (kHeadK * kWld);
    const float* zk = dz_s + kc * kHeadK;
    const auto fz = [zk, ldz](int m, int k) { return zk[m * ldz + k]; };
    const auto fw = [ws](int n, int k) { return ws[k * kWld + n]; };
#pragma unroll
    for (int kk = 0; kk < kHeadK; kk += mma_depth(BF))
      mma_step<2, kNt, BF>(acc, fz, fw, wm * 32, wn * (NB / 2), kk, gq, tq);
    if (kc < kchunks - 1) continue;

    // The n tile's epilogue: dyp = mask * acc, h to hs, and the previous
    // BN's sums.
    const int n0 = nt * NB + wn * (NB / 2);
    float s1[kNt][2] = {}, s2[kNt][2] = {};
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const int k = n0 + 8 * j + 2 * tq;
      const float sc0 = __ldg(a.scp + k), sc1 = __ldg(a.scp + k + 1);
      const float sh0 = __ldg(a.shp + k), sh1 = __ldg(a.shp + k + 1);
      const float m0 = __ldg(a.mup + k), m1 = __ldg(a.mup + k + 1);
      const float i0 = __ldg(a.invp + k), i1 = __ldg(a.invp + k + 1);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + 16 * i + gq + 8 * h;
          if (r >= rows) continue;
          const size_t at = (g0 + r) * c_in + k;
          const float z0 = load_val(a.zp, zpbf, at);
          const float z1 = load_val(a.zp, zpbf, at + 1);
          const float h0 = bn_affine(z0, sc0, sh0);
          const float h1 = bn_affine(z1, sc1, sh1);
          const float d0 = h0 > 0.f ? acc[i][j][2 * h] : 0.f;
          const float d1 = h1 > 0.f ? acc[i][j][2 * h + 1] : 0.f;
          if (dypbf)
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(a.dyp) + at) =
                __floats2bfloat162_rn(d0, d1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.dyp) + at) =
                make_float2(d0, d1);
          *reinterpret_cast<float2*>(a.hs + at) =
              make_float2(fmaxf(h0, 0.f), fmaxf(h1, 0.f));
          s1[j][0] += d0;
          s1[j][1] += d1;
          s2[j][0] += d0 * ((z0 - m0) * i0);
          s2[j][1] += d1 * ((z1 - m1) * i1);
        }
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v1 = group_sum(s1[j][e]), v2 = group_sum(s2[j][e]);
        if (gq == 0) {
          const int col = wn * (NB / 2) + 8 * j + 2 * tq + e;
          red_t[wm * NB + col] = v1;
          red_t[(4 + wm) * NB + col] = v2;
        }
      }
    __syncthreads();
    if (threadIdx.x < NB) {
      const int t = threadIdx.x;
      prow[nt * NB + t] = ((red_t[t] + red_t[NB + t]) + red_t[2 * NB + t]) +
                          red_t[3 * NB + t];
      prow[c_in + nt * NB + t] = ((red_t[4 * NB + t] + red_t[5 * NB + t]) +
                                  red_t[6 * NB + t]) + red_t[7 * NB + t];
    }
  }
  cp_wait<0>();
}

// Pmid: x (as stored) and W chunks of kBk along c_in through the ring, h
// = relu(bn_affine(x)) of each landed chunk into h_s, then z = h W^T on
// the block's kPmidN columns (blockIdx.z's). Warps 4 (rows, 32 each) by 2
// (64 columns each). BF: kRound.
template <bool BF>
__global__ void __launch_bounds__(kThreads, 1)
    pmid_tc_kernel(const RowFwdArgs a) {
  constexpr int kSt = stage_floats(kTcRows);      // one K-major 128-row stage
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                              // kRing x [kTcRows][kLdk]
  float* w_s = x_s + kRing * kSt;                 // kRing x [kPmidN][kLdk]
  float* h_s = w_s + kRing * kSt;                 // [kTcRows][kLdk]
  float* red = h_s + kSt;                         // [2][4][kPmidN] sum, ssq
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.y, p0 = blockIdx.x * kTcRows;
  const int n0 = blockIdx.z * kPmidN;
  const int rows = min(kTcRows, a.n - p0);
  const size_t g0 = (size_t)b * a.n + p0;
  const int c_in = a.c_in, c_out = a.c_out, chunks = ceil_div(c_in, kBk);
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;
  const size_t blocks = (size_t)gridDim.x * gridDim.y;
  const bool xbf = BF && (a.prec & kXBf16);

  // Chunk c (c_in columns c * kBk ..) of x's tile and of W's rows n0..
  // into ring stage c % kRing: one commit group a call, empty past the
  // last. A bf16 x lands as stored, [kTcRows][kXbLd] bf16.
  const auto load = [&](int c) {
    if (c < chunks) {
      const int k0 = c * kBk, st = c % kRing;
      if (xbf) {
        auto* s = reinterpret_cast<__nv_bfloat16*>(x_s + st * kSt);
        const auto* x = static_cast<const __nv_bfloat16*>(a.x);
        for (int e = threadIdx.x; e < kTcRows * kBk / 8; e += kThreads) {
          const int r = e / (kBk / 8), k = (e % (kBk / 8)) * 8;
          const bool ok = r < rows && k0 + k < c_in;
          cp16(reinterpret_cast<float*>(s + r * kXbLd + k),
               reinterpret_cast<const float*>(
                   ok ? x + (g0 + r) * c_in + k0 + k : x),
               ok ? 16 : 0);
        }
      } else {
        load_stage<true, kTcRows>(x_s + st * kSt,
                                  static_cast<const float*>(a.x), c_in, 1,
                                  (long long)g0, rows, k0, c_in - k0, true);
      }
      load_stage<true, kPmidN>(w_s + st * kSt, a.w, a.ldw, 1, n0,
                               min(kPmidN, c_out - n0), k0, c_in - k0, true);
    }
    cp_commit();
  };
  load(0);
  load(1);
  float acc[2][8][4] = {};
  const auto fh = [h_s](int m, int k) { return h_s[m * kLdk + k]; };
  for (int c = 0; c < chunks; ++c) {
    cp_wait<kRing - 2>();
    __syncthreads();          // chunk c landed; chunk c - 1 and h_s are read
    load(c + kRing - 1);
    const int st = c % kRing;
    {  // h = relu(x * sc + sh): thread t owns column t % kBk; zero past N
       // and c_in.
      const int k = threadIdx.x % kBk, kc = c * kBk + k;
      const bool in = kc < c_in;
      const float scv = in ? __ldg(a.sc + kc) : 0.f;
      const float shv = in ? __ldg(a.sh + kc) : 0.f;
      const float* xs = x_s + st * kSt;
      const auto* xb = reinterpret_cast<const __nv_bfloat16*>(xs);
      for (int r = threadIdx.x / kBk; r < kTcRows; r += kThreads / kBk) {
        const float v = xbf ? __bfloat162float(xb[r * kXbLd + k])
                            : xs[r * kLdk + k];
        h_s[r * kLdk + k] =
            r < rows && in ? fmaxf(bn_affine(v, scv, shv), 0.f) : 0.f;
      }
    }
    __syncthreads();          // h_s written
    const float* ws = w_s + st * kSt;
    const auto fw = [ws](int n, int k) { return ws[n * kLdk + k]; };
#pragma unroll
    for (int kk = 0; kk < kBk; kk += mma_depth(BF))
      mma_step<2, 8, BF>(acc, fh, fw, wm * 32, wn * 64, kk, gq, tq);
  }
  cp_wait<0>();

  // z = acc + b: stored (bf16 nearest-even under kZBf16), and the rows'
  // column sum and sum of squares from the unrounded values.
  const bool zbf = BF && (a.prec & kZBf16);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = wn * 64 + 8 * j + 2 * tq + q, o = n0 + col;
      const float bias = o < c_out ? __ldg(a.bias + o) : 0.f;
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + 16 * i + gq + 8 * h;
          const float v = acc[i][j][2 * h + q] + bias;
          acc[i][j][2 * h + q] = v;
          if (r < rows) {
            s += v;
            ss += v * v;
          }
        }
      s = group_sum(s);
      ss = group_sum(ss);
      if (gq == 0) {
        red[wm * kPmidN + col] = s;
        red[(4 + wm) * kPmidN + col] = ss;
      }
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + 16 * i + gq + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = n0 + wn * 64 + 8 * j + 2 * tq;   // c_out: whole n8s
        if (o >= c_out) continue;
        const size_t at = (g0 + r) * c_out + o;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (zbf)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.z) + at) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.z) + at) =
              make_float2(v0, v1);
      }
    }
  __syncthreads();            // red written
  if (threadIdx.x < kPmidN && n0 + (int)threadIdx.x < c_out) {
    const int t = threadIdx.x, o = n0 + t;
    a.part[blk * c_out + o] = ((red[t] + red[kPmidN + t]) +
                               red[2 * kPmidN + t]) + red[3 * kPmidN + t];
    a.part[(blocks + blk) * c_out + o] =
        ((red[4 * kPmidN + t] + red[5 * kPmidN + t]) +
         red[6 * kPmidN + t]) + red[7 * kPmidN + t];
  }
}

// Head B1: c_out in chunks of kB1Chunk, each chunk's dz built from the
// zc / dy stashes into dz_s and written to dzs (with per-block column
// sums for db and r), then dpf += dz_chunk W[chunk] with W streamed
// N-major through the ring, c_in padded with zeros to NB (8 or 64). Warps
// 4 x 2 (NB 64) or 8 x 1 (NB 8). BF: kRound.
template <bool BF, int NB>
__global__ void __launch_bounds__(kThreads, 2)
    head_b1_tc_kernel(const BwdArgs a) {
  constexpr int kWn = NB >= 32 ? NB / 32 : 1;     // warps along n
  constexpr int kWm = kWarps / kWn;               // warps along m
  constexpr int kMt = kTcRows / kWm / 16;         // m16 tiles a warp
  constexpr int kNt = NB / kWn / 8;               // n8 tiles a warp
  constexpr int kWld = NB + kPadMn;               // N-major W stage row
  constexpr int kWs = kB1Chunk * kWld;            // one W stage, floats
  constexpr int kDzLdB = kB1Chunk + 4;            // dz_s row stride
  extern __shared__ __align__(16) float smem[];
  float* dz_s = smem;                             // [kTcRows][kDzLdB]
  float* w_s = dz_s + kTcRows * kDzLdB;           // kRing x [kB1Chunk][kWld]
  float* red = w_s + kRing * kWs;                 // [kThreads]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mb = (warp / kWn) * kMt * 16, nb = (warp % kWn) * kNt * 8;
  const int b = blockIdx.y, p0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, a.n - p0);
  const size_t g0 = (size_t)b * a.n + p0;
  const int c_in = a.c_in, c_out = a.c_out, chunks = c_out / kB1Chunk;
  float* prow = a.part + ((size_t)b * gridDim.x + blockIdx.x) *
                             (2 * c_in + c_out) + 2 * c_in;
  const bool zcbf = BF && (a.prec & kZcBf16);
  const bool dybf = BF && (a.prec & kDyBf16);
  // 16-byte copies of W's rows where they start 16-byte aligned (c_in =
  // 3: rows of 12 bytes, 4-byte copies).
  const bool wvec = c_in % 4 == 0 && a.ldw % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a.w) % 16 == 0;

  // W rows (k) q * kB1Chunk .. into ring stage q % kRing, N-major, as
  // kB1Chunk / kBk stages of mma.cuh's layout: one commit group a call,
  // empty past the last chunk.
  const auto load_w = [&](int q) {
    if (q < chunks) {
      float* s = w_s + (q % kRing) * kWs;
#pragma unroll
      for (int h = 0; h < kB1Chunk / kBk; ++h) {
        const int k0 = q * kB1Chunk + h * kBk;
        load_stage<false, NB>(s + h * kBk * kWld, a.w, 1, a.ldw, 0, c_in, k0,
                              c_out - k0, wvec);
      }
    }
    cp_commit();
  };
  load_w(0);
  load_w(1);
  const auto fz = [dz_s](int m, int k) { return dz_s[m * kDzLdB + k]; };
  // Thread t builds column t % kB1Chunk of each chunk, rows t / kB1Chunk
  // + step i (kTcRows / step rows, a multiple of kBatch).
  const int col = threadIdx.x % kB1Chunk, step = kThreads / kB1Chunk;
  float acc[kMt][kNt][4] = {};
  for (int c = 0; c < chunks; ++c) {
    cp_wait<kRing - 2>();
    __syncthreads();          // chunk c landed; dz_s and red are read
    load_w(c + kRing - 1);
    const int o = c * kB1Chunk + col;
    {  // dz = dy * sc - c1 - zhat * c2; rows past N read the last row and
       // are zeroed.
      const float scv = __ldg(a.sc + o), muv = __ldg(a.mu + o);
      const float iv = __ldg(a.inv + o), k1 = __ldg(a.c1 + o);
      const float k2 = __ldg(a.c2 + o);
      float s = 0.f;
      for (int r0 = threadIdx.x / kB1Chunk; r0 < kTcRows;
           r0 += kBatch * step) {
        float zv[kBatch], dv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const size_t at = (g0 + min(r0 + u * step, rows - 1)) * c_out + o;
          zv[u] = load_val(a.zc, zcbf, at);
          dv[u] = load_val(a.dy, dybf, at);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int r = r0 + u * step;
          float v = 0.f;
          if (r < rows) {
            const float zhat = (zv[u] - muv) * iv;
            v = dv[u] * scv - k1 - zhat * k2;
            a.dzs[(g0 + r) * c_out + o] = v;
          }
          dz_s[r * kDzLdB + col] = v;
          s += v;
        }
      }
      red[threadIdx.x] = s;
    }
    __syncthreads();          // dz_s and red written
    if (threadIdx.x < kB1Chunk) {
      const int t = threadIdx.x;
      prow[c * kB1Chunk + t] =
          ((red[t] + red[kB1Chunk + t]) + red[2 * kB1Chunk + t]) +
          red[3 * kB1Chunk + t];
    }
    const float* ws = w_s + (c % kRing) * kWs;
    const auto fw = [ws](int n, int k) { return ws[k * kWld + n]; };
#pragma unroll 2
    for (int kk = 0; kk < kB1Chunk; kk += mma_depth(BF))
      mma_step<kMt, kNt, BF>(acc, fz, fw, mb, nb, kk, gq, tq);
  }
  cp_wait<0>();

  // dpf in fp32: no mask, no BN sums.
  float* dpf = static_cast<float*>(a.dyp);
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mb + 16 * i + gq + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const int n = nb + 8 * j + 2 * tq;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        float* out = dpf + (g0 + r) * c_in + n;
        if (c_in % 2 == 0 && n + 1 < c_in) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          if (n < c_in) out[0] = v0;
          if (n + 1 < c_in) out[1] = v1;
        }
      }
    }
}

// Trunk F1 and the seg head's P1: z = x W^T (+ the cloud's addend) + b
// for a tile of 128 points of one cloud and the block's slice of up to
// kF1Slice output columns (blockIdx.x; the slices of one tile are
// neighbouring blocks, so x's tile comes from L2 for all but the first),
// 64 output columns at a time: the product into z_s (unrounded), then the
// columns' sum and sum of squares of the rows < N as per-block partials
// and z stored from z_s in 16-byte vectors (bf16 nearest-even under
// kZBf16). KW 64: c_in a multiple of 16 up to 64 on mma_step (x and the
// W slice K-major, all of c_in in one stage), warps 4 (rows, 32 each) by
// 2 (32 columns each); KW 4: c_in <= 4 as exact fp32 FMAs (bf16 operands
// under BF), a thread per column. ADD (P1): z = (x W^T + addend[cloud]) +
// b, the JAX kernel's order. Groups need nothing here: a block's rows are
// one cloud's, and colsum adds each group's blocks.
template <bool BF, int KW, bool ADD>
__device__ __forceinline__ void f1_tile(const RowFwdArgs& a) {
  constexpr bool kMma = KW > 4;
  constexpr int kXld = kMma ? kF1Ld : KW;
  extern __shared__ __align__(16) float smem[];
  const int c_in = a.c_in, c_out = a.c_out;
  const int n_lo = blockIdx.x * kF1Slice;
  const int n_hi = min(c_out, n_lo + kF1Slice);
  float* x_s = smem;                              // [kTcRows][kXld]
  float* w_s = x_s + kTcRows * kXld;              // [slice][kF1Ld] (mma)
  float* z_s = w_s + (kMma ? min(c_out, kF1Slice) * kF1Ld : 0);
                                                  // [kTcRows][kF1ZLd]
  float* red = z_s + kTcRows * kF1ZLd;            // [2][4][kF1N] sum, ssq
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int b = blockIdx.z, p0 = blockIdx.y * kTcRows;
  const int rows = min(kTcRows, a.n - p0);
  const size_t g0 = (size_t)b * a.n + p0;
  const size_t blk = (size_t)b * gridDim.y + blockIdx.y;
  const size_t blocks = (size_t)gridDim.y * gridDim.z;
  const float* x = static_cast<const float*>(a.x);
  const bool zbf = BF && (a.prec & kZBf16);

  // x's tile (rows past N zero) and, for the product, the W slice.
  if constexpr (kMma) {
    const int q = c_in / 4;                       // 16-byte groups a row
    for (int e = threadIdx.x; e < kTcRows * q; e += kThreads) {
      const int r = e / q, k = (e % q) * 4;
      cp16(x_s + r * kXld + k, r < rows ? x + (g0 + r) * c_in + k : x,
           r < rows ? 16 : 0);
    }
    for (int e = threadIdx.x; e < (n_hi - n_lo) * q; e += kThreads) {
      const int r = e / q, k = (e % q) * 4;
      cp16(w_s + r * kF1Ld + k, a.w + (size_t)(n_lo + r) * a.ldw + k, 16);
    }
  } else {                                        // rows of 4-12 bytes
    for (int e = threadIdx.x; e < kTcRows * KW; e += kThreads) {
      const int r = e / KW, k = e % KW;
      const bool ok = r < rows && k < c_in;
      cp4(x_s + e, ok ? x + (g0 + r) * c_in + k : x, ok ? 4 : 0);
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const float* add = ADD ? a.addend + (size_t)b * c_out : nullptr;
  for (int n0 = n_lo; n0 < n_hi; n0 += kF1N) {
    if constexpr (kMma) {
      float acc[2][4][4] = {};
      const float* ws = w_s + (n0 - n_lo) * kF1Ld;
      const auto fx = [x_s](int m, int k) { return x_s[m * kF1Ld + k]; };
      const auto fw = [ws](int n, int k) { return ws[n * kF1Ld + k]; };
      for (int kk = 0; kk < c_in; kk += mma_depth(BF))
        mma_step<2, 4, BF>(acc, fx, fw, wm * 32, wn * 32, kk, gq, tq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + 8 * j + 2 * tq;
        const float b0 = __ldg(a.bias + n0 + col);
        const float b1 = __ldg(a.bias + n0 + col + 1);
        const float a0 = ADD ? __ldg(add + n0 + col) : 0.f;
        const float a1 = ADD ? __ldg(add + n0 + col + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + 16 * i + gq + 8 * h;
            const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
            *reinterpret_cast<float2*>(z_s + r * kF1ZLd + col) =
                ADD ? make_float2((v0 + a0) + b0, (v1 + a1) + b1)
                    : make_float2(v0 + b0, v1 + b1);
          }
      }
    } else {
      // z = x0 w0 + x1 w1 + ... by fmaf in order of k, then + b.
      const int c = threadIdx.x % kF1N, o = n0 + c;
      float wv[KW];
#pragma unroll
      for (int k = 0; k < KW; ++k)
        wv[k] = k < c_in ? operand(__ldg(a.w + (size_t)o * a.ldw + k), BF)
                         : 0.f;
      const float bias = __ldg(a.bias + o);
      const float ad = ADD ? __ldg(add + o) : 0.f;
      for (int r = threadIdx.x / kF1N; r < kTcRows; r += kThreads / kF1N) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < KW; ++k)
          if (k < c_in) v = fmaf(operand(x_s[r * KW + k], BF), wv[k], v);
        z_s[r * kF1ZLd + c] = ADD ? (v + ad) + bias : v + bias;
      }
    }
    __syncthreads();          // z_s written
    {  // Thread t sums column t % kF1N over a quarter of the rows.
      const int c = threadIdx.x % kF1N, q = threadIdx.x / kF1N;
      const int r1 = min(rows, (q + 1) * (kTcRows / 4));
      float s = 0.f, ss = 0.f;
      for (int r = q * (kTcRows / 4); r < r1; ++r) {
        const float v = z_s[r * kF1ZLd + c];
        s += v;
        ss += v * v;
      }
      red[q * kF1N + c] = s;
      red[(4 + q) * kF1N + c] = ss;
    }
    if (zbf) {                // 8 bf16 (16 bytes) a store
      auto* z = static_cast<__nv_bfloat16*>(a.z);
      for (int e = threadIdx.x; e < kTcRows * kF1N / 8; e += kThreads) {
        const int r = e / (kF1N / 8), c = (e % (kF1N / 8)) * 8;
        if (r >= rows) continue;
        const float4 u = *reinterpret_cast<const float4*>(z_s + r * kF1ZLd + c);
        const float4 v =
            *reinterpret_cast<const float4*>(z_s + r * kF1ZLd + c + 4);
        *reinterpret_cast<uint4*>(z + (g0 + r) * c_out + n0 + c) = make_uint4(
            bf16x2(u.x, u.y), bf16x2(u.z, u.w), bf16x2(v.x, v.y),
            bf16x2(v.z, v.w));
      }
    } else {
      auto* z = static_cast<float*>(a.z);
      for (int e = threadIdx.x; e < kTcRows * kF1N / 4; e += kThreads) {
        const int r = e / (kF1N / 4), c = (e % (kF1N / 4)) * 4;
        if (r < rows)
          *reinterpret_cast<float4*>(z + (g0 + r) * c_out + n0 + c) =
              *reinterpret_cast<const float4*>(z_s + r * kF1ZLd + c);
      }
    }
    __syncthreads();          // red written; z_s read
    if (threadIdx.x < kF1N) {
      const int t = threadIdx.x, o = n0 + t;
      a.part[blk * c_out + o] =
          ((red[t] + red[kF1N + t]) + red[2 * kF1N + t]) + red[3 * kF1N + t];
      a.part[(blocks + blk) * c_out + o] =
          ((red[4 * kF1N + t] + red[5 * kF1N + t]) + red[6 * kF1N + t]) +
          red[7 * kF1N + t];
    }
  }
}

template <bool BF, int KW>
__global__ void __launch_bounds__(kThreads, 2)
    f1_tc_kernel(const __grid_constant__ RowFwdArgs a) {
  f1_tile<BF, KW, false>(a);
}

// The seg head's P1: z1 = pf W1a^T + g_row[cloud] + b1 on F1's tile.
template <bool BF>
__global__ void __launch_bounds__(kThreads, 2)
    head_p1_tc_kernel(const __grid_constant__ RowFwdArgs a) {
  f1_tile<BF, 64, true>(a);
}

// W4 (row stride ldw) into w_s, XOR-swizzled, its rows from c_out to
// `rows` zero: one commit group.
__device__ __forceinline__ void load_w4(float* w_s, const float* w, int ldw,
                                        int c_out, int rows) {
  for (int e = threadIdx.x; e < rows * kC2 / 4; e += kThreads) {
    const int r = e / (kC2 / 4), k = (e % (kC2 / 4)) * 4;
    const bool ok = r < c_out;
    cp16(w_s + sw_at(r, k), ok ? w + (size_t)r * ldw + k : w, ok ? 16 : 0);
  }
  cp_commit();
}

// The forward half of B4 and P4, one arithmetic for both: z4 = h3 W4^T +
// b4 for warp `warp`'s 16 whole rows (7 n8 tiles; h_s and w_s swizzled,
// kC2 deep), its columns at or past c_out -inf; then for each row half h
// (rows gq and gq + 8 of the warp's 16), the row's max m[h], e = exp(z4 -
// m) (0 past c_out) and their sum s[h], each reduced over the row's quad
// in shuffles.
template <bool BF>
__device__ __forceinline__ void z4_softmax(float (&z)[1][7][4],
                                           float (&e)[1][7][4], float (&m)[2],
                                           float (&s)[2], const float* h_s,
                                           const float* w_s,
                                           const float* __restrict__ bias,
                                           int c_out, int warp, int gq,
                                           int tq) {
  const auto fh = [h_s](int r, int k) { return h_s[sw_at(r, k)]; };
  const auto fw = [w_s](int n, int k) { return w_s[sw_at(n, k)]; };
#pragma unroll
  for (int j = 0; j < 7; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) z[0][j][q] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kC2; kk += mma_depth(BF))
    mma_step<1, 7, BF>(z, fh, fw, warp * 16, 0, kk, gq, tq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 7; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * j + 2 * tq + q;
        const float v =
            col < c_out ? z[0][j][2 * h + q] + __ldg(bias + col) : -INFINITY;
        z[0][j][2 * h + q] = v;
        mx = fmaxf(mx, v);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 7; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * j + 2 * tq + q;
        const float v = col < c_out ? expf(z[0][j][2 * h + q] - mx) : 0.f;
        e[0][j][2 * h + q] = v;
        sum += v;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    m[h] = mx;
    s[h] = sum;
  }
}

// The seg head's P4: logp = log_softmax(relu(bn3(z3)) W4^T + b4) for a
// tile of 128 points of one cloud. h3 into h_s (load_h2) and W4 padded
// to kB4N rows into w_s, then z4_softmax with a warp per 16 whole rows,
// logp = z4 - (log(s) + m); each warp stages its rows' logp over its own
// rows of h_s (which GEMM 1 read in that warp alone) as one contiguous
// [16][k] range, the range its rows take in logp, and stores it with
// 16-byte vectors from the first 16-byte boundary on. Two blocks an SM:
// one block's loads in flight while the other computes.
template <bool BF>
__global__ void __launch_bounds__(kThreads, 2)
    head_p4_tc_kernel(const RowFwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                              // [kTcRows][kC2], sw_at
  float* w_s = h_s + kTcRows * kC2;               // [kB4N][kC2], sw_at
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y, p0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, a.n - p0);
  const size_t g0 = (size_t)b * a.n + p0;
  const int k = a.c_out;

  load_w4(w_s, a.w, a.ldw, k, kB4N);
  load_h2(h_s, a.x, BF && (a.prec & kXBf16), a.sc, a.sh, nullptr, g0, rows);
  cp_wait<0>();
  __syncthreads();            // h_s written, W4 landed

  float z[1][7][4], e[1][7][4], m[2], s[2];
  z4_softmax<BF>(z, e, m, s, h_s, w_s, a.bias, k, warp, gq, tq);
  const int r0 = warp * 16, nr = min(16, rows - r0);
  if (nr <= 0) return;        // warp-uniform
  float* st = h_s + r0 * kC2;                     // [16][k], contiguous
  __syncwarp();               // the warp's rows of h_s are read
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lse = logf(s[h]) + m[h];
    const int r = gq + 8 * h;
#pragma unroll
    for (int j = 0; j < 7; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = 8 * j + 2 * tq + q;
        if (col < k) st[r * k + col] = z[0][j][2 * h + q] - lse;
      }
  }
  __syncwarp();               // the stage written
  float* dst = a.logp + (g0 + r0) * k;
  const int total = nr * k;
  const int head =
      min(total, (int)((4 - (reinterpret_cast<uintptr_t>(dst) >> 2)) & 3));
  const int body = head + ((total - head) & ~3);
  for (int i = lane; i < head; i += 32) dst[i] = st[i];
  for (int i = head + 4 * lane; i < body; i += 128)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(st[i], st[i + 1], st[i + 2], st[i + 3]);
  for (int i = body + lane; i < total; i += 32) dst[i] = st[i];
}

// Head B4 (c_in = kC2, c_out = k <= kB4N, one group). Each block walks a
// contiguous range of 128-point tiles (tile t: cloud t / tiles a cloud);
// per tile: h3 = relu(bn3(z3)) into h_s (load_h2); GEMM 1 z4 = h3 W4^T
// with each warp owning 16 whole rows (7 n8 tiles), so the softmax
// backward dz = dlp - softmax(z4 + b4) sum(dlp) reduces each row within a
// quad; db's partial from the unrounded dz; dz into dz_s (columns past k
// zero); GEMM 2 dy3 = dz W4 (warps 4 x 2, K padded to 56, or 64 for bf16's
// 16-deep steps), masked by h3 > 0, stored (bf16 under kDypBf16) with
// BN3's t1 / t2 partials; GEMM 3 dW4 += dz^T h3 (warps 2 x 4) in
// registers across the block's tiles, one partial a block. W4 stays in
// w_s, swizzled, for GEMM 1 (K-major) and GEMM 2 (N-major); dz_s is
// read by GEMM 2 along its rows and by GEMM 3 along its columns, so it is
// swizzled too.
template <bool BF>
__global__ void __launch_bounds__(kThreads, 1) b4_tc_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                              // [kTcRows][kC2], sw_at
  float* w_s = h_s + kTcRows * kC2;               // [kB4K][kC2], sw_at
  float* dz_s = w_s + kB4K * kC2;                 // [kTcRows][kB4K], sw_at
  float* red_b = dz_s + kTcRows * kB4K;           // [kWarps][kB4N]
  float* red_t = red_b + kWarps * kB4N;           // [2][4][kC2]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;        // GEMM 2
  const int wm3 = warp >> 2, wn3 = warp & 3;      // GEMM 3
  const int c_out = a.c_out;
  const int tpc = ceil_div(a.n, kTcRows), tiles = tpc * a.batch;
  const int per = ceil_div(tiles, gridDim.x);
  const int t0 = blockIdx.x * per, t1 = min(tiles, t0 + per);
  const bool zpbf = BF && (a.prec & kZpBf16);
  const bool dypbf = BF && (a.prec & kDypBf16);

  load_w4(w_s, a.w, a.ldw, c_out, kB4K);   // once: rows past c_out zero

  const auto fz = [dz_s](int m, int k) { return dz_s[sw_at<kB4K>(m, k)]; };
  const auto fw2 = [w_s](int n, int k) { return w_s[sw_at(k, n)]; };
  const auto fzt = [dz_s](int m, int k) { return dz_s[sw_at<kB4K>(k, m)]; };
  const auto fht = [h_s](int n, int k) { return h_s[sw_at(k, n)]; };
  float dw[2][4][4] = {};                         // dW4 over the block's tiles
  for (int t = t0; t < t1; ++t) {
    const int b = t / tpc, p0 = (t - b * tpc) * kTcRows;
    const int rows = min(kTcRows, a.n - p0);
    const size_t g0 = (size_t)b * a.n + p0;
    float* prow = a.part + (size_t)t * (2 * kC2 + c_out);
    // dlp of the warp's rows, in GEMM 1's layout (rows of 4 * k bytes:
    // 4-byte loads).
    float dl[2][7][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < 7; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = 8 * j + 2 * tq + q;
          dl[h][j][q] = r < rows && col < c_out
                            ? __ldg(a.dlp + (g0 + r) * c_out + col)
                            : 0.f;
        }
    }
    __syncthreads();          // the last tile's h_s, dz_s, red_b, red_t read
    load_h2(h_s, a.zp, zpbf, a.scp, a.shp, nullptr, g0, rows);
    cp_wait<0>();
    __syncthreads();          // h_s written, W4 landed

    // GEMM 1 and the softmax (z4_softmax, P4's arithmetic), then its
    // backward row by row in registers.
    float z[1][7][4], ex[1][7][4], m[2], s[2];
    z4_softmax<BF>(z, ex, m, s, h_s, w_s, a.bias, c_out, warp, gq, tq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gq + 8 * h;
      float sdl = 0.f;
#pragma unroll
      for (int j = 0; j < 7; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) sdl += dl[h][j][q];
      sdl += __shfl_xor_sync(0xffffffffu, sdl, 1);
      sdl += __shfl_xor_sync(0xffffffffu, sdl, 2);
#pragma unroll
      for (int j = 0; j < 7; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = 8 * j + 2 * tq + q;
          z[0][j][2 * h + q] =
              r < rows && col < c_out
                  ? dl[h][j][q] - (ex[0][j][2 * h + q] / s[h]) * sdl
                  : 0.f;
        }
    }
    // db's partial (the warp's 16 rows, then the 8 warps in order) and
    // dz into dz_s, its columns past c_out zero.
#pragma unroll
    for (int j = 0; j < 7; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float v = group_sum(z[0][j][q] + z[0][j][2 + q]);
        if (gq == 0) red_b[warp * kB4N + 8 * j + 2 * tq + q] = v;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < kB4K / 8; ++j)
        *reinterpret_cast<float2*>(dz_s + sw_at<kB4K>(r, 8 * j + 2 * tq)) =
            j < 7 ? make_float2(z[0][j][2 * h], z[0][j][2 * h + 1])
                  : make_float2(0.f, 0.f);
    }
    __syncthreads();          // dz_s and red_b written
    if ((int)threadIdx.x < c_out) {
      float v = red_b[threadIdx.x];
      for (int w = 1; w < kWarps; ++w) v += red_b[w * kB4N + threadIdx.x];
      prow[2 * kC2 + threadIdx.x] = v;
    }

    // GEMM 2: dy3 = dz W4, masked by BN3's ReLU; t1 = sum dy3, t2 = sum
    // dy3 * zhat3.
    {
      float acc[2][8][4] = {};
#pragma unroll
      for (int kk = 0; kk < (BF ? kB4K : kB4N); kk += mma_depth(BF))
        mma_step<2, 8, BF>(acc, fz, fw2, wm * 32, wn * 64, kk, gq, tq);
      float s1[8][2] = {}, s2[8][2] = {};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = wn * 64 + 8 * j + 2 * tq;
        const float m0 = __ldg(a.mup + k), m1 = __ldg(a.mup + k + 1);
        const float i0 = __ldg(a.invp + k), i1 = __ldg(a.invp + k + 1);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + 16 * i + gq + 8 * h;
            if (r >= rows) continue;
            const size_t at = (g0 + r) * kC2 + k;
            const float d0 = h_s[sw_at(r, k)] > 0.f ? acc[i][j][2 * h] : 0.f;
            const float d1 =
                h_s[sw_at(r, k + 1)] > 0.f ? acc[i][j][2 * h + 1] : 0.f;
            if (dypbf)
              *reinterpret_cast<__nv_bfloat162*>(
                  static_cast<__nv_bfloat16*>(a.dyp) + at) =
                  __floats2bfloat162_rn(d0, d1);
            else
              *reinterpret_cast<float2*>(static_cast<float*>(a.dyp) + at) =
                  make_float2(d0, d1);
            const float z0 = load_val(a.zp, zpbf, at);
            const float z1 = load_val(a.zp, zpbf, at + 1);
            s1[j][0] += d0;
            s1[j][1] += d1;
            s2[j][0] += d0 * ((z0 - m0) * i0);
            s2[j][1] += d1 * ((z1 - m1) * i1);
          }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float v1 = group_sum(s1[j][q]), v2 = group_sum(s2[j][q]);
          if (gq == 0) {
            const int k = wn * 64 + 8 * j + 2 * tq + q;
            red_t[wm * kC2 + k] = v1;
            red_t[(4 + wm) * kC2 + k] = v2;
          }
        }
    }
    __syncthreads();          // red_t written
    if (threadIdx.x < kC2) {
      const int k = threadIdx.x;
      prow[k] = ((red_t[k] + red_t[kC2 + k]) + red_t[2 * kC2 + k]) +
                red_t[3 * kC2 + k];
      prow[kC2 + k] = ((red_t[4 * kC2 + k] + red_t[5 * kC2 + k]) +
                       red_t[6 * kC2 + k]) + red_t[7 * kC2 + k];
    }

    // GEMM 3: dW4 += dz^T h3 over the tile's rows (rows past N are zero
    // in both).
#pragma unroll 2
    for (int kk = 0; kk < kTcRows; kk += mma_depth(BF))
      mma_step<2, 4, BF>(dw, fzt, fht, wm3 * 32, wn3 * 32, kk, gq, tq);
  }
  cp_wait<0>();

  float* out = a.part_w + (size_t)blockIdx.x * c_out * kC2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = wm3 * 32 + 16 * i + gq + 8 * h;
      if (o >= c_out) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn3 * 32 + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(out + (size_t)o * kC2 + c) =
            make_float2(dw[i][j][2 * h], dw[i][j][2 * h + 1]);
      }
    }
}

template <typename K, typename A>
int launch_tc(K kernel, dim3 grid, size_t bytes, const A& a,
              cudaStream_t stream) {
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// dW = dz^T h on the GEMM core from the dz the row pass wrote and the
// previous activation h (bf16 operands under kRound, as the JAX package's
// _mxu_dot_t) over `splits` row ranges added in fp64.
int weight_grad(const BwdArgs& a, const float* h, cudaStream_t stream) {
  const long long wsz = (long long)a.c_out * a.c_in;
  Gemm g{};
  g.m = a.c_out, g.n = a.c_in, g.k = a.batch * a.n, g.batch = 1;
  g.splits = a.splits;
  g.sam = 1, g.sak = a.c_out;          // A[o][r] = dz[r][o]
  g.sbk = a.c_in, g.sbn = 1;           // B[r][i] = h[r][i]
  g.ldc = a.c_in, g.bsc = wsz;
  g.a = a.dzs, g.b = h, g.c = a.part_w;
  const int e = gemm(g, a.prec & kRound, stream);
  return e ? e : split_sum(a.part_w, a.splits, wsz, 1, a.dw, stream);
}

// t1 / t2 per group and db from the row kernel's per-block (per-tile)
// partials.
int bn_sums(const BwdArgs& a, int blocks, cudaStream_t stream) {
  const int per = blocks / a.groups;
  const long long ldp = 2LL * a.c_in + a.c_out;
  int e;
  if ((e = colsum(a.part, ldp, per, a.c_in, a.groups, a.t1, a.c_in, stream)))
    return e;
  if ((e = colsum(a.part + a.c_in, ldp, per, a.c_in, a.groups, a.t2, a.c_in,
                  stream)))
    return e;
  return colsum(a.part + 2 * a.c_in, ldp, blocks, a.c_out, 1, a.db, 0,
                stream);
}

// bn_sums, and dW from the dz and h the row pass wrote.
int finish(const BwdArgs& a, int blocks, cudaStream_t stream) {
  const int e = bn_sums(a, blocks, stream);
  return e ? e : weight_grad(a, a.hs, stream);
}

// F1's and P1's statistics per group from the per-block partials (a
// group's blocks are contiguous).
int f1_sums(const RowFwdArgs& a, int blocks, cudaStream_t stream) {
  const int per = blocks / a.groups;
  const int e = colsum(a.part, a.c_out, per, a.c_out, a.groups, a.sum,
                       a.c_out, stream);
  return e ? e : colsum(a.part + (size_t)blocks * a.c_out, a.c_out, per,
                        a.c_out, a.groups, a.ssq, a.c_out, stream);
}

// What trunk B1 and Bmid need: shapes in range, a 16-byte aligned W with a row
// stride of whole 16-byte groups (the ring's copies), every buffer.
bool bad_args(const BwdArgs& a) {
  return a.batch <= 0 || a.batch > 65535 || a.n <= 0 || a.c_in <= 0 ||
         a.c_out <= 0 || a.groups < 1 || a.batch % a.groups ||
         (long long)a.batch * a.n > 0x7fffffffLL ||
         (long long)a.c_out * a.c_in > 0x7fffffffLL || a.ldw < a.c_in ||
         a.ldw % 4 || reinterpret_cast<uintptr_t>(a.w) % 16 ||
         a.splits <= 0 || a.splits > 65535 || !a.zp || !a.scp || !a.shp ||
         !a.mup || !a.invp || !a.w || !a.dyp || !a.t1 || !a.t2 || !a.db ||
         !a.dw || !a.part || !a.part_w || !a.dzs || !a.hs || a.r;
}

}  // namespace

int trunk_b1_tc(const BwdArgs& a, cudaStream_t stream) {
  if (a.mode != kDzTrunk || bad_args(a) || a.c_in != kC2 ||
      a.c_out % kChunk || (a.prec & kDypBf16) || !a.bias || !a.mu ||
      !a.inv || !a.coef1 || !a.coef2 || !a.s3dg || !a.idx)
    return kErrArgs;
  const size_t bytes = ((size_t)kTcRows * (kC2 + kDzLd) +
                        (size_t)kRing * kChunk * kC2 + 4 * kChunk + 8 * kC2) *
                       sizeof(float);
  const dim3 grid(ceil_div(a.n, kTcRows), a.batch);
  const bool bf = a.prec & kRound, g = a.groups > 1;
  const int e =
      bf ? (g ? launch_tc(b1_tc_kernel<true, true>, grid, bytes, a, stream)
              : launch_tc(b1_tc_kernel<true, false>, grid, bytes, a, stream))
         : (g ? launch_tc(b1_tc_kernel<false, true>, grid, bytes, a, stream)
              : launch_tc(b1_tc_kernel<false, false>, grid, bytes, a,
                           stream));
  return e ? e : finish(a, grid.x * grid.y, stream);
}

int trunk_f2_tc(const RowFwdArgs& a, cudaStream_t stream) {
  if (a.batch <= 0 || a.batch > 65535 || a.n <= 0 || a.c_in != kC2 ||
      a.c_out <= 0 || a.c_out % kChunk || a.groups < 1 ||
      a.batch % a.groups || (long long)a.batch * a.n > 0x7fffffffLL ||
      a.ldw < kC2 || a.ldw % 4 || reinterpret_cast<uintptr_t>(a.w) % 16 ||
      !a.x || !a.sc || !a.sh || !a.w || !a.bias || a.addend || a.z ||
      a.logp || !a.sum || !a.ssq || !a.part || !a.keys || !a.mx || !a.mn ||
      !a.imax || !a.imin)
    return kErrArgs;
  const size_t bytes = ((size_t)kTcRows * kC2 + (size_t)kRing * kChunk * kC2 +
                        8 * kChunk) * sizeof(float) +
                       8 * kChunk * sizeof(unsigned long long);
  const long long count = (long long)a.batch * a.c_out;
  fill_keys_kernel<<<ceil_div(2 * count, kThreads), kThreads, 0, stream>>>(
      a.keys, count);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const dim3 grid(ceil_div(a.n, kTcRows), a.batch);
  const bool bf = a.prec & kRound, g = a.groups > 1;
  e = bf ? (g ? launch_tc(f2_tc_kernel<true, true>, grid, bytes, a, stream)
              : launch_tc(f2_tc_kernel<true, false>, grid, bytes, a, stream))
         : (g ? launch_tc(f2_tc_kernel<false, true>, grid, bytes, a, stream)
              : launch_tc(f2_tc_kernel<false, false>, grid, bytes, a,
                           stream));
  if (e) return e;
  // BN3's sums per group (a group's blocks are contiguous), then the keys'
  // decode.
  const int blocks = grid.x * grid.y, per = blocks / a.groups;
  if ((e = colsum(a.part, a.c_out, per, a.c_out, a.groups, a.sum, a.c_out,
                  stream)))
    return e;
  if ((e = colsum(a.part + (size_t)blocks * a.c_out, a.c_out, per, a.c_out,
                  a.groups, a.ssq, a.c_out, stream)))
    return e;
  decode_extrema_kernel<<<ceil_div(count, kThreads), kThreads, 0, stream>>>(
      a.keys, count, a.mx, a.mn, a.imax, a.imin);
  return (int)cudaGetLastError();
}

int trunk_f1_tc(const RowFwdArgs& a, cudaStream_t stream) {
  const bool fma = a.c_in <= 4;
  if (a.batch <= 0 || a.batch > 65535 || a.n <= 0 || a.c_in <= 0 ||
      (!fma && (a.c_in % 16 || a.c_in > 64 || a.c_out > kF1Slice ||
                a.ldw % 4 || reinterpret_cast<uintptr_t>(a.w) % 16 ||
                reinterpret_cast<uintptr_t>(a.x) % 16)) ||
      a.c_out <= 0 || a.c_out % kF1N || a.groups < 1 || a.batch % a.groups ||
      (long long)a.batch * a.n > 0x7fffffffLL || a.ldw < a.c_in ||
      (a.prec & kXBf16) || !a.x || !a.w || !a.bias || !a.z || !a.sum ||
      !a.ssq || !a.part || a.sc || a.sh || a.addend || a.keys || a.mx ||
      a.logp)
    return kErrArgs;
  const size_t bytes =
      ((size_t)kTcRows * (fma ? 4 : kF1Ld) + (fma ? 0 : a.c_out * kF1Ld) +
       (size_t)kTcRows * kF1ZLd + 8 * kF1N) * sizeof(float);
  const dim3 grid(1, ceil_div(a.n, kTcRows), a.batch);
  const bool bf = a.prec & kRound;
  int e;
  if (fma)
    e = bf ? launch_tc(f1_tc_kernel<true, 4>, grid, bytes, a, stream)
           : launch_tc(f1_tc_kernel<false, 4>, grid, bytes, a, stream);
  else
    e = bf ? launch_tc(f1_tc_kernel<true, 64>, grid, bytes, a, stream)
           : launch_tc(f1_tc_kernel<false, 64>, grid, bytes, a, stream);
  return e ? e : f1_sums(a, grid.y * grid.z, stream);
}

int head_p1_tc(const RowFwdArgs& a, cudaStream_t stream) {
  if (a.batch <= 0 || a.batch > 65535 || a.n <= 0 || a.c_in <= 0 ||
      a.c_in % 16 || a.c_in > 64 || a.c_out <= 0 || a.c_out % kF1N ||
      a.groups != 1 || (long long)a.batch * a.n > 0x7fffffffLL ||
      a.ldw < a.c_in || a.ldw % 4 || reinterpret_cast<uintptr_t>(a.w) % 16 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 || (a.prec & kXBf16) || !a.x ||
      !a.w || !a.bias || !a.addend || !a.z || !a.sum || !a.ssq || !a.part ||
      a.sc || a.sh || a.keys || a.mx || a.logp)
    return kErrArgs;
  const size_t bytes = ((size_t)kTcRows * kF1Ld +
                        (size_t)min(a.c_out, kF1Slice) * kF1Ld +
                        (size_t)kTcRows * kF1ZLd + 8 * kF1N) * sizeof(float);
  const dim3 grid(ceil_div(a.c_out, kF1Slice), ceil_div(a.n, kTcRows),
                  a.batch);
  const int e =
      a.prec & kRound
          ? launch_tc(head_p1_tc_kernel<true>, grid, bytes, a, stream)
          : launch_tc(head_p1_tc_kernel<false>, grid, bytes, a, stream);
  return e ? e : f1_sums(a, grid.y * grid.z, stream);
}

int head_p4_tc(const RowFwdArgs& a, cudaStream_t stream) {
  if (a.batch <= 0 || a.batch > 65535 || a.n <= 0 || a.c_in != kC2 ||
      a.c_out <= 0 || a.c_out > kB4N || a.groups != 1 ||
      (long long)a.batch * a.n > 0x7fffffffLL || a.ldw < a.c_in ||
      a.ldw % 4 || reinterpret_cast<uintptr_t>(a.w) % 16 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 || !a.x || !a.sc || !a.sh ||
      !a.w || !a.bias || !a.logp || a.addend || a.z || a.sum || a.keys ||
      a.mx)
    return kErrArgs;
  const size_t bytes = (size_t)(kTcRows + kB4N) * kC2 * sizeof(float);
  const dim3 grid(ceil_div(a.n, kTcRows), a.batch);
  return a.prec & kRound
             ? launch_tc(head_p4_tc_kernel<true>, grid, bytes, a, stream)
             : launch_tc(head_p4_tc_kernel<false>, grid, bytes, a, stream);
}

int head_pmid_tc(const RowFwdArgs& a, cudaStream_t stream) {
  if (a.batch <= 0 || a.batch > 65535 || a.n <= 0 || a.c_in <= 0 ||
      a.c_in % 8 || a.c_out <= 0 || a.c_out % 8 || a.groups != 1 ||
      (long long)a.batch * a.n > 0x7fffffffLL ||
      a.ldw < a.c_in || a.ldw % 4 || reinterpret_cast<uintptr_t>(a.w) % 16 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 || !a.x || !a.sc || !a.sh ||
      !a.w || !a.bias || !a.z || !a.sum || !a.ssq || !a.part || a.addend ||
      a.keys || a.mx || a.logp)
    return kErrArgs;
  const size_t bytes = ((size_t)(2 * kRing + 1) * stage_floats(kTcRows) +
                        8 * kPmidN) * sizeof(float);
  const dim3 grid(ceil_div(a.n, kTcRows), a.batch, ceil_div(a.c_out, kPmidN));
  int e = a.prec & kRound
              ? launch_tc(pmid_tc_kernel<true>, grid, bytes, a, stream)
              : launch_tc(pmid_tc_kernel<false>, grid, bytes, a, stream);
  if (e) return e;
  const int blocks = grid.x * grid.y;
  if ((e = colsum(a.part, a.c_out, blocks, a.c_out, 1, a.sum, 0, stream)))
    return e;
  return colsum(a.part + (size_t)blocks * a.c_out, a.c_out, blocks, a.c_out,
                1, a.ssq, 0, stream);
}

int head_b1_tc(const BwdArgs& a, cudaStream_t stream) {
  if (a.mode != kDzBn || a.batch <= 0 || a.batch > 65535 || a.n <= 0 ||
      a.c_in <= 0 || a.c_in > 64 || a.c_out <= 0 || a.c_out % kB1Chunk ||
      a.groups != 1 || (long long)a.batch * a.n > 0x7fffffffLL ||
      a.ldw < a.c_in || a.splits <= 0 || a.splits > 65535 ||
      (a.prec & (kZpBf16 | kDypBf16)) || !a.zp || !a.w || !a.zc || !a.dy ||
      !a.sc || !a.mu || !a.inv || !a.c1 || !a.c2 || !a.dyp || !a.db ||
      !a.r || !a.dw || !a.part || !a.part_w || !a.dzs || a.scp || a.shp ||
      a.mup || a.invp || a.t1 || a.t2 || a.hs)
    return kErrArgs;
  const int nb = a.c_in <= 8 ? 8 : 64;
  const size_t bytes = ((size_t)kTcRows * (kB1Chunk + 4) +
                        (size_t)kRing * kB1Chunk * (nb + kPadMn) + kThreads) *
                       sizeof(float);
  const dim3 grid(ceil_div(a.n, kTcRows), a.batch);
  const bool bf = a.prec & kRound;
  int e;
  if (nb == 8)
    e = bf ? launch_tc(head_b1_tc_kernel<true, 8>, grid, bytes, a, stream)
           : launch_tc(head_b1_tc_kernel<false, 8>, grid, bytes, a, stream);
  else
    e = bf ? launch_tc(head_b1_tc_kernel<true, 64>, grid, bytes, a, stream)
           : launch_tc(head_b1_tc_kernel<false, 64>, grid, bytes, a, stream);
  if (e) return e;
  // db over every block, r over each cloud's (contiguous) blocks, and dW1a
  // with pf itself as the h operand.
  const long long ldp = 2LL * a.c_in + a.c_out;
  const float* dzsum = a.part + 2 * a.c_in;
  if ((e = colsum(dzsum, ldp, grid.x * grid.y, a.c_out, 1, a.db, 0, stream)))
    return e;
  if ((e = colsum(dzsum, ldp, grid.x, a.c_out, a.batch, a.r, a.c_out,
                  stream)))
    return e;
  return weight_grad(a, static_cast<const float*>(a.zp), stream);
}

int head_b4_tc(const BwdArgs& a, cudaStream_t stream) {
  if (a.mode != kDzSoftmax || a.batch <= 0 || a.batch > 65535 || a.n <= 0 ||
      a.c_in != kC2 || a.c_out <= 0 || a.c_out > kB4N || a.groups != 1 ||
      (long long)a.batch * a.n > 0x7fffffffLL || a.ldw < a.c_in ||
      a.ldw % 4 || reinterpret_cast<uintptr_t>(a.w) % 16 || a.splits <= 0 ||
      a.splits > 65535 || (a.prec & (kZcBf16 | kDyBf16)) || !a.zp ||
      !a.scp || !a.shp || !a.mup || !a.invp || !a.w || !a.bias || !a.dlp ||
      !a.dyp || !a.t1 || !a.t2 || !a.db || !a.dw || !a.part || !a.part_w ||
      a.r || a.dzs || a.hs)
    return kErrArgs;
  const int tiles = ceil_div(a.n, kTcRows) * a.batch;
  const int per = ceil_div(tiles, a.splits), blocks = ceil_div(tiles, per);
  const size_t bytes = ((size_t)kTcRows * kC2 + kB4K * kC2 + kTcRows * kB4K +
                        kWarps * kB4N + 8 * kC2) * sizeof(float);
  int e = a.prec & kRound
              ? launch_tc(b4_tc_kernel<true>, dim3(blocks), bytes, a, stream)
              : launch_tc(b4_tc_kernel<false>, dim3(blocks), bytes, a, stream);
  if (e || (e = bn_sums(a, tiles, stream))) return e;
  // dW4 from the per-block partials.
  const int wsz = a.c_out * kC2;
  return colsum(a.part_w, wsz, blocks, wsz, 1, a.dw, 0, stream);
}

int head_bmid_tc(const BwdArgs& a, cudaStream_t stream) {
  if (a.mode != kDzBn || bad_args(a) || a.groups != 1 ||
      a.c_out > kThreads || kThreads % a.c_out || a.c_out % kHeadK ||
      (a.c_in != 64 && a.c_in % 128) || !a.zc || !a.dy || !a.sc || !a.mu ||
      !a.inv || !a.c1 || !a.c2)
    return kErrArgs;
  const int nb = a.c_in == 64 ? 64 : 128;
  const size_t bytes = ((size_t)kTcRows * (a.c_out + 4) +
                        (size_t)kRing * kHeadK * (nb + kPadMn) + 8 * nb +
                        kThreads) * sizeof(float);
  const dim3 grid(ceil_div(a.n, kTcRows), a.batch);
  const bool bf = a.prec & kRound;
  int e;
  if (nb == 64)
    e = bf ? launch_tc(bmid_tc_kernel<true, 64>, grid, bytes, a, stream)
           : launch_tc(bmid_tc_kernel<false, 64>, grid, bytes, a, stream);
  else
    e = bf ? launch_tc(bmid_tc_kernel<true, 128>, grid, bytes, a, stream)
           : launch_tc(bmid_tc_kernel<false, 128>, grid, bytes, a, stream);
  return e ? e : finish(a, grid.x * grid.y, stream);
}

}  // namespace pointtpu
