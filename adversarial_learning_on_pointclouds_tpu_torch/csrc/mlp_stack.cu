// fused_mlp_stack on the tensor cores: h <- act_i((h @ W_i^T) * scale_i +
// shift_i) over a chain of up to kMaxStack pointwise layers, forward only
// (inference: the discriminator's FCDiscriminator.infer).
//
// Replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/shared_mlp.py::
// fused_mlp_stack (its pallas_call at shared_mlp.py:296, kernel
// _stack_kernel).
//
// What bounds it on the H100:
// * Matmuls. The discriminator's chain (k = 50 -> 64 -> 128 -> 256 -> 512
//   -> 1) costs 175,744 multiply-adds a row for 200 bytes read and 4
//   written: 28.1 GFLOP at B=32 N=2500 (80,000 rows), 0.170 ms at the
//   3xTF32 rate (495 / 3 TFLOP/s), 0.420 at fp32 FMA's 67 and 0.028 at
//   bf16's 989. The CUDA-core kernel this replaces ran every product as
//   fp32 FMAs (bf16 operands too) at 20 TFLOP/s.
// * Then the weights: every row tile reads all of them (0.70 MB for the
//   discriminator) from L2; at 64 rows a tile that was 880 MB a call.
//
// What the design does about each:
// * Every product on the tensor cores through mma.cuh's fragment layer:
//   fp32 as 3xTF32 (mma_step: each 8-deep step summed from zero, added to
//   the fp32 accumulator by a round-to-nearest FADD), as the TPU kernel's
//   _mxu_dot pins HIGHEST; under mixed precision (prec & kRound) one
//   m16n8k16 bf16 mma.sync a 16-deep step with fp32 sums (bf_step:
//   mma_step's bf16 fragments, A's already bf16 in shared memory, B's
//   weights rounded nearest-even as they load).
// * A block of 8 warps, 2 along the rows by 4 along the columns, owns a
//   tile of 128 rows (64 where 128 do not fit shared memory) and keeps
//   that tile's activations in shared memory from layer to layer, so
//   only x is read from device memory and only the output is written.
//   Blocks walk contiguous ranges of tiles, one block an SM (a
//   persistent grid): 128 rows halve the L2 weight stream, to 438 MB a
//   call for the discriminator (64 rows ran 40% slower, PERF.md §6).
// * Activations live in slots of 128 columns by the tile's rows, at a row
//   stride of 128 and a 16-byte pad (every fragment load of a warp hits
//   32 banks, at fixed offsets; sw_at's XOR swizzle ran no faster, PERF.md
//   §6), fp32, or under kRound bf16 (the plain version rounds them as
//   operands anyway, so this is exact and halves the footprint) with the
//   two k of each register of an A fragment side by side (slot_at), so
//   that a register is one 32-bit load and no conversion.
//   A layer runs by chunks of 128 output columns (a warp's 32: 4 n8 tiles
//   by MT = rows / 32 m16 tiles), and every chunk reads the whole input,
//   so only the last chunk may overwrite an input slot, after a barrier;
//   the others take free slots (make_plan). The discriminator so needs
//   two slots (x, h1 and h2 in turn in one; h3 across both), 132 KB in
//   fp32 at 128 rows where two whole buffers (x or h2, h1 or h3) took 192
//   KB, which leaves room for 32-deep ring slices: half the barriers of
//   16-deep ones (0.98 -> 0.86 ms, PERF.md §6).
// * The epilogue applies scale, shift and activation in registers, the
//   product and the sum rounded apart as the plain version's two
//   elementwise ops round them (__fmul_rn, __fadd_rn), then stores the
//   chunk: into its slot as the next layer's operand; to device memory
//   after the last layer; or, where the last layer is narrower than
//   kFoldMax columns (the discriminator's 512 -> 1), folds it into that
//   layer's outputs in registers: per lane an fp32 FMA chain over its
//   columns of the chunk (operands rounded under kRound), summed over the
//   lane group (t, t ^ 1, then t ^ 2) and over the chunks into a per-warp
//   partial in shared memory, the column warps' partials added in order
//   at the tile's end, then the last layer's affine and activation. The
//   widest activation (the discriminator's 512) never exists.
// * Weights stream from L2 through one 3-stage cp.async ring of slices,
//   128 output columns by 32 of k, stored K-major with a row pad of 4
//   (every fragment load of a warp hits 32 banks). The schedule runs on
//   across the layers and the block's tiles, so the next slices land
//   during an epilogue or the next tile's x. Rows and k past a weight's
//   shape are zero-filled by the copy (src-size 0), so widths that are
//   not multiples of 8 or 16 (50, 53) need no padding in device memory;
//   16-byte copies where a weight's rows allow, else 4-byte ones.
// * Ragged rows are zero in x and never stored; the columns of an
//   activation past its width, up to a multiple of 32, are written 0.
//
// Shared memory: the slots, the ring (3 x 18 KB) and the fold's partials
// (4 warps x the last width x rows, fp32). The discriminator takes
// 192,512 bytes in fp32 and 126,976 in bf16 at 128 rows; the 3 -> 64 ->
// 128 -> 1024 chain 122,880 / 90,112. A chain that does not fit at 64
// rows, or needs more than kMaxSlots slots, is refused (kErrSmem).
// Registers: ptxas's report in the build log (chip_smoke.py phase 2).

#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma.cuh"

namespace pointtpu {

constexpr int kMaxStack = 8;    // layers a chain may have

// Mirror of the Python side's ctypes structure (ops/launch.py, StackArgs),
// field for field.
struct StackArgs {
  int rows, layers, prec;          // rows of x, chain length, kRound or 0
  int width[kMaxStack + 1];        // width[0] = x's, width[i + 1] = layer i's
  int act[kMaxStack];              // Act per layer
  const float* x;                  // [rows, width[0]]
  const float* w[kMaxStack];       // [width[i + 1], width[i]] row-major
  const float* scale[kMaxStack];   // [width[i + 1]]
  const float* shift[kMaxStack];   // [width[i + 1]]
  float* out;                      // [rows, width[layers]]
};

namespace {

constexpr int kWarpsN = 4;              // warps along a chunk's columns
constexpr int kChunkN = 32 * kWarpsN;   // output columns a chunk, a slot's
constexpr int kRing = 3;                // stages of the slice ring
constexpr int kSliceK = 32;             // k depth of a ring slice
constexpr int kSliceLd = kSliceK + 4;   // its row stride (floats)
constexpr int kSliceFloats = kChunkN * kSliceLd;
constexpr int kFoldMax = 8;             // a last layer this narrow folds
constexpr int kMaxSlots = 12;           // activation slots a plan may use

// What the launcher works out once a call, by value in the kernel's
// parameters. Activations live in slots of [rows][128] (slot_at):
// chunk j (columns 128 j ..) of layer l's input in slot[l][j].
struct StackPlan {
  int mma;                    // layers on the tensor cores
  int fold;                   // width of the folded last layer, or 0
  int slot[kMaxStack][kMaxSlots];
  int reuse;                  // bit l: layer l's last chunk overwrites
                              //   one of its input's slots
  int first[kMaxStack + 1];   // layer l's first slice of a tile's
                              //   schedule; first[mma]: slices a tile
  int ksl[kMaxStack];         // layer l's k slices a chunk
  int tiles, per_block;       // row tiles, and the run a block walks
  int ring_at, red_at;        // byte offsets of the ring, the partials
};

__host__ __device__ inline int round32(int c) { return ceil_div(c, 32) * 32; }

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ void act_store(float* p, int i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void act_store(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void act_store2(float* p, int i, float a,
                                           float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}

// A slot's row stride, in elements: 128 and a pad of 16 bytes, which puts
// a warp's fragment loads on 32 banks (row r, k or word t: bank 4 r + t).
template <bool BF>
__host__ __device__ constexpr int slot_ld() {
  return BF ? kChunkN + 8 : kChunkN + 4;
}

// Word w of row r of a bf16 slot.
__device__ __forceinline__ int bf_word(int r, int w) {
  return r * (slot_ld<true>() / 2) + w;
}

// Element k (< kChunkN) of row r of a slot. bf16: the 16-deep k groups
// hold k = t + 4 q (t, q < 4) at 2 t + (q & 1) + 8 (q >> 1), so the pairs
// (t, t + 4) and (t + 8, t + 12) that a bf16 A fragment packs into a
// register are 32-bit words (bf_step loads them whole).
template <bool BF>
__device__ __forceinline__ int slot_at(int r, int k) {
  if constexpr (BF) {
    const int q = (k >> 2) & 3;
    return 2 * bf_word(r, (k >> 4) * 8 + (k & 3) + 4 * (q >> 1)) + (q & 1);
  } else {
    return r * slot_ld<false>() + k;
  }
}

// Slice idx of a tile's schedule (layer l, chunk c, k slice s, in the
// order the products consume them) into s_dst; one thread a 16-byte
// copy, or a 4-byte copy where the weight's rows are not 16-byte aligned.
__device__ __forceinline__ void load_slice(float* s_dst, const StackArgs& a,
                                           const StackPlan& p, int idx) {
  int l = 0;
  while (idx >= p.first[l + 1]) ++l;
  const int local = idx - p.first[l], c = local / p.ksl[l];
  const int k0 = (local - c * p.ksl[l]) * kSliceK;
  const int c_in = a.width[l];
  const int r_lim = a.width[l + 1] - c * kChunkN, k_lim = c_in - k0;
  const float* w = a.w[l];
  const float* src = w + (size_t)c * kChunkN * c_in + k0;
  if (c_in % 4 == 0 && aligned16(w)) {
    for (int e = threadIdx.x; e < kChunkN * kSliceK / 4; e += kThreads) {
      const int r = e / (kSliceK / 4), k = (e % (kSliceK / 4)) * 4;
      const bool ok = r < r_lim && k < k_lim;
      cp16(s_dst + r * kSliceLd + k, ok ? src + (size_t)r * c_in + k : w,
           ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kChunkN * kSliceK; e += kThreads) {
      const int r = e / kSliceK, k = e % kSliceK;
      const bool ok = r < r_lim && k < k_lim;
      cp4(s_dst + r * kSliceLd + k, ok ? src + (size_t)r * c_in + k : w,
          ok ? 4 : 0);
    }
  }
}

// mma_step's bf16 arithmetic (one m16n8k16 a 16-deep step, the same
// fragments) with A's pairs loaded as words from a bf16 slot (slot_at):
// w0 is the step's k over 2 within the slot's row.
template <int MT, typename FB>
__device__ __forceinline__ void bf_step(float (&acc)[MT][4][4],
                                        const uint32_t* aw, int w0,
                                        const FB& fb, int kk, int mb, int nb,
                                        int g, int t) {
  uint32_t b[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nb + 8 * j + g;
    b[j][0] = bf16x2(fb(n, kk + t), fb(n, kk + t + 4));
    b[j][1] = bf16x2(fb(n, kk + t + 8), fb(n, kk + t + 12));
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = mb + 16 * i + g;
    uint32_t a[4];
    a[0] = aw[bf_word(m, w0 + t)];
    a[1] = aw[bf_word(m + 8, w0 + t)];
    a[2] = aw[bf_word(m, w0 + t + 4)];
    a[3] = aw[bf_word(m + 8, w0 + t + 4)];
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j]);
  }
}

// acc += in[:, k0 .. k0 + kSliceK) times the slice sl, for the warp's rows
// mb .. mb + 16 MT and its columns nb .. nb + 32 of the chunk; in is the
// input's slot that holds k0, kl = k0 within it.
template <bool BF, int MT, typename T>
__device__ __forceinline__ void slice_mma(float (&acc)[MT][4][4], const T* in,
                                          int kl, const float* sl, int mb,
                                          int nb, int g, int t) {
  const auto fb = [sl](int n, int k) { return sl[n * kSliceLd + k]; };
  if constexpr (BF) {
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(in);
#pragma unroll 1
    for (int kk = 0; kk < kSliceK; kk += mma_depth(BF))
      bf_step<MT>(acc, aw, (kl + kk) / 2, fb, kk, mb, nb, g, t);
  } else {
    const auto fa = [in, kl](int m, int k) {
      return in[slot_at<false>(m, kl + k)];
    };
#pragma unroll 1
    for (int kk = 0; kk < kSliceK; kk += mma_depth(BF))
      mma_step<MT, 4, BF>(acc, fa, fb, mb, nb, kk, g, t);
  }
}

// Where a layer's chunk goes: the next layer's operand in shared memory,
// the output in device memory, or folded into the narrow last layer.
enum Sink { kToSmem = 0, kToOut = 1, kFold = 2 };

// Per tile: x into its slots, then each tensor-core layer chunk by chunk
// from the ring, then (fold) the last layer from the column warps'
// partials. MT: m16 tiles a warp (rows a tile = 32 MT); BF: bf16
// operands and activations.
template <bool BF, int MT>
__global__ void __launch_bounds__(kThreads, 1)
chain_tc_kernel(const __grid_constant__ StackArgs a,
                const __grid_constant__ StackPlan p) {
  using T = typename std::conditional<BF, __nv_bfloat16, float>::type;
  constexpr int TM = 32 * MT;
  constexpr int kSlot = TM * slot_ld<BF>();   // elements of a slot
  extern __shared__ __align__(16) unsigned char smem[];
  T* act = reinterpret_cast<T*>(smem);
  float* ring = reinterpret_cast<float*>(smem + p.ring_at);
  float* red = reinterpret_cast<float*>(smem + p.red_at);  // [4][fold][TM]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wn = warp % kWarpsN, mb = warp / kWarpsN * (TM / 2);
  const int t0 = blockIdx.x * p.per_block;
  const int t1 = min(p.tiles, t0 + p.per_block);
  const int per = p.first[p.mma], total = (t1 - t0) * per;
  const int last = a.layers - 1;

  // Slice q of the block's schedule into stage q % kRing: one commit
  // group a call, empty past the last slice.
  const auto issue = [&](int q) {
    if (q < total) load_slice(ring + (q % kRing) * kSliceFloats, a, p,
                              q % per);
    cp_commit();
  };
  issue(0);
  issue(1);
  int q = 0;
  // The next slice: landed, and every warp done with the stage that the
  // slice kRing - 1 ahead overwrites.
  const auto next = [&]() {
    cp_wait<kRing - 2>();
    __syncthreads();
    issue(q + kRing - 1);
    return ring + (q++ % kRing) * kSliceFloats;
  };

  for (int t = t0; t < t1; ++t) {
    const long long g0 = (long long)t * TM;
    const int rows = (int)min((long long)TM, (long long)a.rows - g0);
    __syncthreads();          // the last tile's reads of x's slots and red
    {
      const int c0 = a.width[0], w0 = round32(c0);
      const float* xt = a.x + g0 * c0;
      for (int e = threadIdx.x; e < TM * w0; e += kThreads) {
        const int r = e / w0, c = e - r * w0;
        act_store(act + p.slot[0][c / kChunkN] * kSlot,
                  slot_at<BF>(r, c % kChunkN),
                  r < rows && c < c0 ? __ldg(xt + (size_t)r * c0 + c) : 0.f);
      }
    }
    for (int l = 0; l < p.mma; ++l) {
      const int c_out = a.width[l + 1], stored = round32(c_out);
      const int sink = l + 1 < p.mma ? kToSmem : (p.fold ? kFold : kToOut);
      const bool reuse = (p.reuse >> l) & 1;
      const float* __restrict__ sc = a.scale[l];
      const float* __restrict__ sh = a.shift[l];
      const int act_l = a.act[l], ksl = p.ksl[l];
      const int chunks = ceil_div(c_out, kChunkN);
#pragma unroll 1
      for (int c = 0; c < chunks; ++c) {
        const int n0 = c * kChunkN + wn * 32;
        // A warp whose columns all lie past the stored width idles (its
        // share of the barriers only): warp-uniform, and once off in a
        // layer, off for its later chunks.
        const bool on = n0 < stored;
        float acc[MT][4][4] = {};
#pragma unroll 1
        for (int s = 0; s < ksl; ++s) {
          const float* sl = next();
          const int k0 = s * kSliceK;
          if (on)
            slice_mma<BF, MT>(acc, act + p.slot[l][k0 / kChunkN] * kSlot,
                              k0 % kChunkN, sl, mb, wn * 32, gq, tq);
        }
        // The last chunk over an input slot: every warp has read it.
        if (reuse && c + 1 == chunks) __syncthreads();
        if (!on) continue;
        // h = act(acc * scale + shift); 0 past c_out.
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 8 * j + 2 * tq + e;
            const bool ok = col < c_out;
            const float s_ = ok ? __ldg(sc + col) : 0.f;
            const float h_ = ok ? __ldg(sh + col) : 0.f;
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int r2 = 0; r2 < 2; ++r2) {
                float& v = acc[i][j][2 * r2 + e];
                v = ok ? apply_act(__fadd_rn(__fmul_rn(v, s_), h_), act_l)
                       : 0.f;
              }
          }
        if (sink == kToSmem) {
          T* out = act + p.slot[l + 1][c] * kSlot;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int r2 = 0; r2 < 2; ++r2) {
                const int r = mb + 16 * i + gq + 8 * r2;
                const int k = wn * 32 + 8 * j + 2 * tq;
                if constexpr (BF) {   // k and k + 1 lie in two words
                  act_store(out, slot_at<BF>(r, k), acc[i][j][2 * r2]);
                  act_store(out, slot_at<BF>(r, k + 1),
                            acc[i][j][2 * r2 + 1]);
                } else {
                  act_store2(out, slot_at<BF>(r, k), acc[i][j][2 * r2],
                             acc[i][j][2 * r2 + 1]);
                }
              }
        } else if (sink == kToOut) {
          const bool pairs = (c_out & 1) == 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = n0 + 8 * j + 2 * tq;
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int r2 = 0; r2 < 2; ++r2) {
                const int r = mb + 16 * i + gq + 8 * r2;
                if (r >= rows) continue;
                float* o = a.out + (g0 + r) * c_out + col;
                if (pairs && col + 1 < c_out) {
                  *reinterpret_cast<float2*>(o) =
                      make_float2(acc[i][j][2 * r2], acc[i][j][2 * r2 + 1]);
                } else {
                  if (col < c_out) o[0] = acc[i][j][2 * r2];
                  if (col + 1 < c_out) o[1] = acc[i][j][2 * r2 + 1];
                }
              }
          }
        } else {
          // The narrow last layer: each output column o's partial of
          // this chunk, FMAs in the order (j, e), then the lane group.
          const float* wf = a.w[last];
#pragma unroll 1
          for (int o = 0; o < p.fold; ++o) {
            float part[MT][2] = {};
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = n0 + 8 * j + 2 * tq + e;
                if (col >= c_out) continue;
                const float wv =
                    operand(__ldg(wf + (size_t)o * c_out + col), BF);
#pragma unroll
                for (int i = 0; i < MT; ++i)
#pragma unroll
                  for (int r2 = 0; r2 < 2; ++r2)
                    part[i][r2] = fmaf(operand(acc[i][j][2 * r2 + e], BF),
                                       wv, part[i][r2]);
              }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int r2 = 0; r2 < 2; ++r2) {
                float v = part[i][r2];
                v += __shfl_xor_sync(0xffffffffu, v, 1);
                v += __shfl_xor_sync(0xffffffffu, v, 2);
                float* slot = red + (wn * p.fold + o) * TM + mb + 16 * i +
                              gq + 8 * r2;
                if (tq == 0) *slot = c ? *slot + v : v;
              }
          }
        }
      }
    }
    if (p.fold) {
      // The column warps' partials in order (those with a column in the
      // first chunk), then the last layer's affine and activation.
      __syncthreads();
      const int c_in = a.width[last], nw = min(kWarpsN, ceil_div(c_in, 32));
      const float* __restrict__ sc = a.scale[last];
      const float* __restrict__ sh = a.shift[last];
      for (int e = threadIdx.x; e < rows * p.fold; e += kThreads) {
        const int r = e / p.fold, o = e - r * p.fold;
        float s = red[o * TM + r];
        for (int w = 1; w < nw; ++w) s += red[(w * p.fold + o) * TM + r];
        a.out[(g0 + r) * p.fold + o] = apply_act(
            __fadd_rn(__fmul_rn(s, __ldg(sc + o)), __ldg(sh + o)),
            a.act[last]);
      }
    }
  }
  cp_wait<0>();
}

// The plan of a chain at tm rows a tile; returns the shared memory it
// needs, in bytes (SIZE_MAX past kMaxSlots). Slots are handed out
// greedily: a chunk takes the lowest slot that holds neither the layer's
// input nor an earlier chunk of its output, a new one if none is free;
// but a layer's last chunk, where no slot is free, overwrites the first
// slot of the layer's input, which every chunk has read by then (the
// discriminator: x, h1 and h2 in slot 0 in turn, h3 in slots 1 and 0).
size_t make_plan(const StackArgs& a, bool bf, int tm, StackPlan& p) {
  const int layers = a.layers;
  p.fold = layers >= 2 && a.width[layers] < kFoldMax ? a.width[layers] : 0;
  p.mma = layers - (p.fold ? 1 : 0);
  int n_in = ceil_div(a.width[0], kChunkN), slots = n_in;
  if (n_in > kMaxSlots) return SIZE_MAX;
  for (int j = 0; j < n_in; ++j) p.slot[0][j] = j;
  p.reuse = 0;
  p.first[0] = 0;
  for (int l = 0; l < p.mma; ++l) {
    const int n_out = ceil_div(a.width[l + 1], kChunkN);
    p.ksl[l] = ceil_div(a.width[l], kSliceK);
    p.first[l + 1] = p.first[l] + n_out * p.ksl[l];
    if (l + 1 == p.mma) break;            // the output leaves the block
    if (n_out > kMaxSlots) return SIZE_MAX;
    bool busy[kMaxSlots] = {};
    for (int j = 0; j < n_in; ++j) busy[p.slot[l][j]] = true;
    for (int c = 0; c < n_out; ++c) {
      int s = 0;
      while (s < slots && busy[s]) ++s;
      if (s == slots && c + 1 == n_out) {
        s = p.slot[l][0];
        p.reuse |= 1 << l;
      } else if (s == slots && ++slots > kMaxSlots) {
        return SIZE_MAX;
      }
      busy[s] = true;
      p.slot[l + 1][c] = s;
    }
    n_in = n_out;
  }
  const size_t acts = bf ? (size_t)slots * tm * slot_ld<true>() * 2
                        : (size_t)slots * tm * slot_ld<false>() * 4;
  p.ring_at = (int)acts;
  p.red_at = p.ring_at + kRing * kSliceFloats * (int)sizeof(float);
  p.tiles = ceil_div(a.rows, tm);
  return (size_t)p.red_at + (size_t)kWarpsN * p.fold * tm * sizeof(float);
}

// Launches the chain at 32 MT rows a tile if its working set fits a
// block; `fits` says whether it did.
template <bool BF, int MT>
int launch_chain(const StackArgs& a, cudaStream_t stream, bool& fits) {
  StackPlan p = {};
  const size_t bytes = make_plan(a, BF, 32 * MT, p);
  fits = bytes <= (size_t)max_smem_optin();
  if (!fits) return 0;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  p.per_block = ceil_div(p.tiles, std::min(p.tiles, sms));
  const int blocks = ceil_div(p.tiles, p.per_block);
  const cudaError_t e = allow_smem(chain_tc_kernel<BF, MT>, bytes);
  if (e != cudaSuccess) return (int)e;
  chain_tc_kernel<BF, MT><<<blocks, kThreads, bytes, stream>>>(a, p);
  return (int)cudaGetLastError();
}

// 128 rows a tile where they fit, else 64, else kErrSmem.
template <bool BF>
int run_chain(const StackArgs& a, cudaStream_t stream) {
  bool fits = false;
  const int status = launch_chain<BF, 4>(a, stream, fits);
  if (fits) return status;
  const int narrow = launch_chain<BF, 2>(a, stream, fits);
  return fits ? narrow : kErrSmem;
}

bool stack_args_ok(const StackArgs& a) {
  if (a.rows <= 0 || a.layers < 1 || a.layers > kMaxStack || !a.x ||
      !a.out || (a.prec & ~kRound))
    return false;
  for (int i = 0; i <= a.layers; ++i)
    if (a.width[i] <= 0) return false;
  for (int i = 0; i < a.layers; ++i)
    if (!a.w[i] || !a.scale[i] || !a.shift[i] || a.act[i] < kActNone ||
        a.act[i] > kActLeaky)
      return false;
  return true;
}

}  // namespace
}  // namespace pointtpu

using pointtpu::StackArgs;

// out = the chain on x.
extern "C" int pt_mlp_stack(const StackArgs* a, int device,
                            cudaStream_t stream) {
  using namespace pointtpu;
  if (!stack_args_ok(*a)) return kErrArgs;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  return (a->prec & kRound) ? run_chain<true>(*a, stream)
                            : run_chain<false>(*a, stream);
}
