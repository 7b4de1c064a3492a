// The encoder's two eval kernels on the tensor cores: the pointwise stack
// with its max over points, and the concat-free seg head with its
// log_softmax. In fp32 (the TPU kernels pin HIGHEST) every product is
// 3xTF32 on mma.sync (mma.cuh), but the stack's first layer at c_in <= 4,
// which is exact fp32 FMAs in order of k. Under mixed precision (BF, the
// prec field's kRound bit; the TPU kernels' _mxu_dot in the bf16 scope)
// every product's operands are rounded to bf16 (nearest even) as the
// fragments load, one m16n8k16 bf16 mma.sync a 16-deep k step summed on
// the tensor core (mma_step's bf16 arithmetic); the stack's FMA layer and
// the seg head's global row round their operands and keep their fp32
// FMAs. The epilogues (scale, shift, activation, max, log_softmax) are
// fp32 in both.
//
// fused_stack_maxpool replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/encoder_fused.py::
// fused_stack_maxpool (pallas_call at encoder_fused.py:109).
//   Bound: matmuls. The last layer (128 -> 1024) is 131,072 of the 139-143
//   thousand MACs a point, 22 GFLOP a stack and 67 a serving forward over
//   the three stacks (B=32, N=2500), against 30-640 KB of input a cloud;
//   the plain version also writes and rereads [B, N, 1024]. At the 3xTF32
//   rate (495 / 3 TFLOP/s) that is 0.14 ms a stack; the CUDA-core kernel
//   it replaced ran fp32 FMAs on 64-point tiles at 19 TFLOP/s.
//   Design (stack_tc_kernel, trunk F2's shape of work without the
//   statistics): a block of 8 warps owns 128 points of one cloud at a
//   time and walks a contiguous range of the flattened (cloud, tile)
//   axis. The early layers (c_in 64, or 3 as FMAs; their weights resident
//   in shared memory) run on the tile into an h stage of [128 x 128]
//   fp32; each early product's accumulator stays in registers until a
//   barrier and then overwrites its input, which aliases into that stage.
//   The last layer walks its channels 64 at a time through a 3-stage
//   cp.async ring of W chunks (32 KB each) that runs on across the
//   block's tiles, so the next tile's first chunks land while this tile
//   finishes. Its epilogue applies * scale + shift and the activation and
//   only then takes the max over the tile's valid rows (folded BN scales
//   may be negative, and the trunk's last layer has no ReLU), in
//   registers and shuffles, into a running max of the block's channels in
//   shared memory. That merges into the output once per cloud through an
//   order-preserving atomic max over a -inf fill; max is exact in any
//   order, so the result is deterministic. Where the tiles do not fill
//   the SMs (B=1: 20 tiles), blocks also split the last layer's channels
//   and each split recomputes the early layers. The ragged tail is masked
//   out of the max; nothing is padded. At most 212 KB of shared memory
//   (STNkd's), one block an SM.
//
// seg_head_fused replaces
// adversarial_learning_on_pointclouds_tpu/ops/kernels/encoder_fused.py::
// seg_head_fused (pallas_call at encoder_fused.py:182).
//   Bound: matmuls, 203 thousand MACs a point (64 x 512 + 512 x 256 + 256
//   x 128 + 128 x 50), 32 GFLOP a serving forward (0.20 ms at the 3xTF32
//   rate; the CUDA-core kernel it replaced ran at 22 TFLOP/s); then the L2
//   traffic of the 0.8 MB of weights that every tile reads.
//   Design (head_tc_kernel): the [B, N, 1088] concat never exists. A
//   prologue kernel computes the global half once per cloud, g @ W1[:,
//   64:]^T -> [B, 512], which enters layer 1 as a per-channel addend. The
//   main kernel takes 128-point tiles (a block walks a contiguous range),
//   so every weight fetched from L2 serves 128 points. h1 [128 x 512]
//   would take 256 KB and is never staged whole: layer 1 runs by chunks of
//   64 channels, h1c = relu((pf W1a[c]^T + g_row[c]) * s1 + t1) into a
//   32 KB stage, and each chunk feeds layer 2 at once, acc2 += h1c W2[:,
//   c]^T, into a [128 x 256] accumulator held in registers across the
//   chunks (128 floats a thread; the fragments are split four n8 tiles at
//   a time to stay under the register cap). h2 = relu(acc2 * s2 + t2) then
//   goes to shared memory over the dead pf and h1 stages (128 KB), layer 3
//   into h3 [128 x 128], and layer 4 (50 parts padded to 56 columns) gives
//   each warp 16 whole rows, so the log_softmax (max subtracted first,
//   padded logits -inf) is in registers with quad shuffles. Every weight
//   streams through one 3-stage cp.async ring of 32 KB slices (W1a chunks,
//   W2 column halves, W3 quarters, W4), 29 a tile, running on across the
//   block's tiles. The ragged tail is masked at the store; there are no
//   pad rows. 224 KB of shared memory, one block an SM.
//
// Shared-memory tiles read by the fragment loads are XOR-swizzled
// (mma.cuh: sw_at), so every warp's loads hit 32 distinct banks. The
// epilogues round as the plain versions do: each product is followed by
// separately rounded adds and multiplies (no fused multiply-add).
// Weights arrive in PyTorch's [out, in] row-major layout.

#include <algorithm>

#include "mma.cuh"

namespace pointtpu {
namespace {

constexpr int kTile = 128;          // points a tile, one cloud's
constexpr int kRing = 3;            // stages of the weight ring
constexpr int kSlot = 8192;         // floats of one ring stage (32 KB)
constexpr int kHalf = kTile * 64;   // floats of a [128 x 64] tile
constexpr int kStackK = 128;        // stack: the last layer's depth
constexpr int kChunk = 64;          // stack: last-layer channels a stage
constexpr int kEarlyK = 64;         // stack: depth of an early mma layer
constexpr int kHeadPf = 64;         // head: c_pf
constexpr int kHeadC2 = 256;        // head: c2
constexpr int kHeadC3 = 128;        // head: c3
constexpr int kHeadN4 = 56;         // head: z4's columns, 7 n8 tiles
constexpr int kHeadA = kTile * kHeadC2;   // head: the activation region

// One k step (k = kk .., mma_depth(BF) deep) of a warp's 2 x NT tiles (NT
// a multiple of 4): mma_step's arithmetic, 3xTF32 term for term or (BF)
// one bf16 product, with A's fragments made once and B's four n8 tiles at
// a time, so a wide NT holds 48 registers of fragments (16 in bf16) where
// mma_step would hold 8 NT + 16.
template <int NT, bool BF, typename FA, typename FB>
__device__ __forceinline__ void wide_step(float (&acc)[2][NT][4],
                                          const FA& fa, const FB& fb, int mb,
                                          int nb, int kk, int g, int t) {
  if constexpr (BF) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = mb + 16 * i + g;
      a[i][0] = bf16x2(fa(m, kk + t), fa(m, kk + t + 4));
      a[i][1] = bf16x2(fa(m + 8, kk + t), fa(m + 8, kk + t + 4));
      a[i][2] = bf16x2(fa(m, kk + t + 8), fa(m, kk + t + 12));
      a[i][3] = bf16x2(fa(m + 8, kk + t + 8), fa(m + 8, kk + t + 12));
    }
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += 4) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nb + 8 * (j0 + j) + g;
        b[j][0] = bf16x2(fb(n, kk + t), fb(n, kk + t + 4));
        b[j][1] = bf16x2(fb(n, kk + t + 8), fb(n, kk + t + 12));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j0 + j], a[i], b[j]);
    }
    return;
  }
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = mb + 16 * i + g;
    split(fa(m, kk + t), ah[i][0], al[i][0]);
    split(fa(m + 8, kk + t), ah[i][1], al[i][1]);
    split(fa(m, kk + t + 4), ah[i][2], al[i][2]);
    split(fa(m + 8, kk + t + 4), ah[i][3], al[i][3]);
  }
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += 4) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + 8 * (j0 + j) + g;
      split(fb(n, kk + t), bh[j][0], bl[j][0]);
      split(fb(n, kk + t + 4), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s[4][4] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(s[j], al[i], bh[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(s[j], ah[i], bl[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(s[j], ah[i], bh[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j0 + j][q] += s[j][q];
    }
  }
}

// act(v * scale + shift), each operation rounded on its own.
__device__ __forceinline__ float affine_act(float v, float sc, float sh,
                                            int act) {
  return apply_act(__fadd_rn(__fmul_rn(v, sc), sh), act);
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  // Non-negative floats order like their int bits, negative floats
  // inversely to their unsigned bits; -inf is the identity of both.
  if (!signbit(v))
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void fill_kernel(float* p, float v, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) p[i] = v;
}

// ---------------------------------------------------------------------------
// fused_stack_maxpool
// ---------------------------------------------------------------------------

// The stacks the kernel takes: [64, 128, C] (the encoder trunk) or [c0,
// 64, 128, C] with c0 64 (STNkd) or at most 4 (STN3d, its first layer as
// FMAs); C a multiple of kChunk.
struct StackArgs {
  const float* x;
  float* out;
  const float* w[3];
  const float* shift[3];
  const float* scale[3];
  int width[4];
  int act[3];
  int n_layers;
  int batch, n;
  int tiles_per_block;   // of the flattened (cloud, tile) axis: blockIdx.x
  int chunks_per_block;  // of the last layer's kChunk-channel chunks: .y
};

// Floats of the early mma layers' resident weights: [c_out][kEarlyK]
// each, sw_at<64>.
__host__ __device__ inline int early_floats(const StackArgs& a) {
  int f = 0;
  for (int l = 0; l + 1 < a.n_layers; ++l)
    if (a.width[l] == kEarlyK) f += a.width[l + 1] * kEarlyK;
  return f;
}

inline size_t stack_smem_bytes(const StackArgs& a) {
  return ((size_t)kTile * kStackK + (size_t)kRing * kSlot + early_floats(a) +
          (size_t)a.chunks_per_block * kChunk) * sizeof(float);
}

// An early mma layer, c_in = kEarlyK -> NT * 16 (64 or 128) channels:
// act((in W^T) * sc + sh) of the tile at in_s (sw_at<64>), warps 4 (rows,
// 32 each) by 2 (columns). The output overwrites the stage after a
// barrier: [128 x 128] at h_s (sw_at<128>), or [128 x 64] at h_s + kHalf
// (sw_at<64>).
template <int NT, bool BF>
__device__ __forceinline__ void early_layer(float* h_s, const float* in_s,
                                            const float* w_s, const float* sc,
                                            const float* sh, int act, int wm,
                                            int wn, int gq, int tq) {
  float acc[2][NT][4] = {};
  const auto fi = [in_s](int m, int k) { return in_s[sw_at<64>(m, k)]; };
  const auto fw = [w_s](int n, int k) { return w_s[sw_at<64>(n, k)]; };
#pragma unroll 2
  for (int kk = 0; kk < kEarlyK; kk += mma_depth(BF))
    wide_step<NT, BF>(acc, fi, fw, wm * 32, wn * NT * 8, kk, gq, tq);
  __syncthreads();            // every warp has read in_s
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wn * NT * 8 + 8 * j + 2 * tq;
    const float s0 = __ldg(sc + col), s1 = __ldg(sc + col + 1);
    const float h0 = __ldg(sh + col), h1 = __ldg(sh + col + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + 16 * i + gq + 8 * h;
        const float2 v = make_float2(affine_act(acc[i][j][2 * h], s0, h0, act),
                                     affine_act(acc[i][j][2 * h + 1], s1, h1,
                                                act));
        if (NT == 8)
          *reinterpret_cast<float2*>(h_s + sw_at<128>(r, col)) = v;
        else
          *reinterpret_cast<float2*>(h_s + kHalf + sw_at<64>(r, col)) = v;
      }
  }
  __syncthreads();            // the layer's output written
}

// Per tile: x into the stage (rows past N zero), the early layers, then
// the last layer chunk by chunk from the ring, each chunk's column max of
// the valid rows merged into run_s by shared-memory atomics; run_s goes
// to the output when the block leaves a cloud. Warps 4 x 2 on every
// product. KW: the first layer's depth, kEarlyK (mma) or 4 (c_in <= 4,
// FMAs); BF: bf16 operands.
template <int KW, bool BF>
__global__ void __launch_bounds__(kThreads, 1)
stack_tc_kernel(const StackArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                              // [kTile][kStackK] stage
  float* ring = h_s + kTile * kStackK;            // kRing x [kChunk][kStackK]
  float* we_s = ring + kRing * kSlot;             // early mma weights
  float* run_s = we_s + early_floats(a);          // [chunks_per_block * 64]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int layers = a.n_layers, c0 = a.width[0];
  const int c_last = a.width[layers], last = layers - 1;
  const int tpc = ceil_div(a.n, kTile), tiles = a.batch * tpc;
  const int t0 = blockIdx.x * a.tiles_per_block;
  const int t1 = min(tiles, t0 + a.tiles_per_block);
  const int ch0 = blockIdx.y * a.chunks_per_block;
  const int nch = min(c_last / kChunk - ch0, a.chunks_per_block);
  const int slices = (t1 - t0) * nch;
  const float* wl = a.w[last];

  // The early mma layers' weights, resident (one commit group).
  {
    float* p = we_s;
    for (int l = 0; l < last; ++l) {
      if (a.width[l] != kEarlyK) continue;
      const int c_out = a.width[l + 1];
      for (int e = threadIdx.x; e < c_out * (kEarlyK / 4); e += kThreads) {
        const int r = e / (kEarlyK / 4), k = (e % (kEarlyK / 4)) * 4;
        cp16(p + sw_at<64>(r, k), a.w[l] + (size_t)r * kEarlyK + k, 16);
      }
      p += c_out * kEarlyK;
    }
    cp_commit();
  }
  // Ring slice s: last-layer chunk ch0 + s % nch into stage s % kRing,
  // sw_at<128>; one commit group a call, empty past the last slice.
  const auto load_slice = [&](int s) {
    if (s < slices) {
      float* st = ring + (s % kRing) * kSlot;
      const float* src = wl + (size_t)(ch0 + s % nch) * kChunk * kStackK;
      for (int e = threadIdx.x; e < kChunk * kStackK / 4; e += kThreads) {
        const int r = e / (kStackK / 4), k = (e % (kStackK / 4)) * 4;
        cp16(st + sw_at<128>(r, k), src + (size_t)r * kStackK + k, 16);
      }
    }
    cp_commit();
  };
  load_slice(0);
  load_slice(1);
  for (int o = threadIdx.x; o < nch * kChunk; o += kThreads)
    run_s[o] = -INFINITY;

  const auto fh = [h_s](int m, int k) { return h_s[sw_at<128>(m, k)]; };
  for (int t = t0; t < t1; ++t) {
    const int b = t / tpc, p0 = (t - b * tpc) * kTile;
    const int rows = min(kTile, a.n - p0);
    const float* xb = a.x + ((size_t)b * a.n + p0) * c0;
    __syncthreads();          // the last tile's stage read; run_s reset
    if constexpr (KW == kEarlyK) {
      float4 v[kHalf / 4 / kThreads];
#pragma unroll
      for (int u = 0; u < kHalf / 4 / kThreads; ++u) {
        const int e = threadIdx.x + u * kThreads;
        const int r = e / (kEarlyK / 4), k = (e % (kEarlyK / 4)) * 4;
        v[u] = r < rows ? __ldg(reinterpret_cast<const float4*>(
                              xb + (size_t)r * kEarlyK + k))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kHalf / 4 / kThreads; ++u) {
        const int e = threadIdx.x + u * kThreads;
        const int r = e / (kEarlyK / 4), k = (e % (kEarlyK / 4)) * 4;
        *reinterpret_cast<float4*>(h_s + sw_at<64>(r, k)) = v[u];
      }
    } else {                  // [kTile][4], columns past c0 zero
      for (int e = threadIdx.x; e < kTile * KW; e += kThreads) {
        const int r = e / KW, k = e % KW;
        h_s[e] = r < rows && k < c0 ? __ldg(xb + (size_t)r * c0 + k) : 0.f;
      }
    }
    if (t == t0) cp_wait<2>();  // the early weights landed
    __syncthreads();          // x written

    // The early layers. Layer 0 reads x at h_s; a 64-wide output goes to
    // h_s + kHalf, the 128-wide one (the last layer's input) over the
    // whole stage.
    const float* w_l = we_s;
    for (int l = 0; l < last; ++l) {
      const int c_out = a.width[l + 1];
      if (KW != kEarlyK && l == 0) {
        // h1 = act(x W^T * sc + sh) by fmaf in order of k (exact fp32 at
        // this depth; BF: on the bf16-rounded operands), a thread per
        // column and every fourth row.
        const int col = threadIdx.x % kChunk;
        float wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wv[k] = k < c0 ? operand(__ldg(a.w[0] + (size_t)col * c0 + k), BF)
                         : 0.f;
        const float sc = __ldg(a.scale[0] + col), sh = __ldg(a.shift[0] + col);
        for (int r = threadIdx.x / kChunk; r < kTile; r += kThreads / kChunk) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < c0) v = fmaf(operand(h_s[r * 4 + k], BF), wv[k], v);
          h_s[kHalf + sw_at<64>(r, col)] = affine_act(v, sc, sh, a.act[0]);
        }
        __syncthreads();      // h1 written
        continue;
      }
      const float* in_s = l == 0 ? h_s : h_s + kHalf;
      if (c_out == kStackK)
        early_layer<8, BF>(h_s, in_s, w_l, a.scale[l], a.shift[l], a.act[l],
                           wm, wn, gq, tq);
      else
        early_layer<4, BF>(h_s, in_s, w_l, a.scale[l], a.shift[l], a.act[l],
                           wm, wn, gq, tq);
      w_l += c_out * kEarlyK;
    }

    // The last layer: chunk by chunk through the ring.
    for (int c = 0; c < nch; ++c) {
      const int s = (t - t0) * nch + c;
      cp_wait<kRing - 2>();
      __syncthreads();        // slice s landed; slice s - 1 is read
      load_slice(s + kRing - 1);
      const float* ws = ring + (s % kRing) * kSlot;
      const auto fw = [ws](int n, int k) { return ws[sw_at<128>(n, k)]; };
      float z[2][4][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kStackK; kk += mma_depth(BF))
        wide_step<4, BF>(z, fh, fw, wm * 32, wn * 32, kk, gq, tq);
      const int oc = (ch0 + c) * kChunk;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = wn * 32 + 8 * j + 2 * tq + q;
          const float sc = __ldg(a.scale[last] + oc + col);
          const float sh = __ldg(a.shift[last] + oc + col);
          float m = -INFINITY;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (wm * 32 + 16 * i + gq + 8 * h < rows)
                m = fmaxf(m, affine_act(z[i][j][2 * h + q], sc, sh,
                                        a.act[last]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          if (gq == 0 && m != -INFINITY)
            atomic_max_float(run_s + c * kChunk + col, m);
        }
    }
    // Leaving the cloud: its running max to the output, run_s reset.
    if (t + 1 == t1 || (t + 1) / tpc != b) {
      __syncthreads();        // every warp's chunk maxima are in run_s
      for (int o = threadIdx.x; o < nch * kChunk; o += kThreads) {
        atomic_max_float(a.out + (size_t)b * c_last + ch0 * kChunk + o,
                         run_s[o]);
        run_s[o] = -INFINITY;
      }
    }
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// seg_head_fused
// ---------------------------------------------------------------------------

struct HeadArgs {
  const float* pf;
  const float* grow;   // [B, c1]: g @ W1[:, c_pf:]^T
  const float* w1;
  const float* shift1;
  const float* scale1;
  const float* w2;
  const float* shift2;
  const float* scale2;
  const float* w3;
  const float* shift3;
  const float* scale3;
  const float* w4;
  const float* b4;
  float* out;
  int batch, n, c_g, c1, k;
  int tiles_per_block;
};

// g_row = g W1[:, c_pf:]^T, a warp a row by fmaf (bf: on bf16-rounded
// operands).
__global__ void __launch_bounds__(kThreads)
global_row_kernel(const float* __restrict__ g, const float* __restrict__ w1,
                  float* __restrict__ grow, int batch, int c_pf, int c_g,
                  int c1, bool bf) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // one per warp
  const int lane = threadIdx.x & 31;
  if (row >= batch * c1) return;
  const int b = row / c1, o = row - b * c1;
  const float* gb = g + (size_t)b * c_g;
  const float* wo = w1 + (size_t)o * (c_pf + c_g) + c_pf;
  float acc = 0.f;
  for (int i = lane; i < c_g; i += 32)
    acc = fmaf(operand(__ldg(gb + i), bf), operand(__ldg(wo + i), bf), acc);
  for (int s = 16; s; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) grow[row] = acc;
}

// Per 128-point tile of one cloud (a block walks a contiguous range of
// the flattened (cloud, tile) axis), every weight through one ring of
// slices, S = 3 c1 / 64 + 5 a tile:
//   c1 / 64 chunks, each three slices: W1a[c] ([64 x 64], sw_at<64>):
//     z1 = pf W1a[c]^T, h1c = relu((z1 + g_row) * s1 + t1) into h1_s; W2
//     [:, c] in two 32-deep halves ([256 x 32], sw_at<32>): acc2 += h1c
//     W2[:, c]^T, acc2 [128 x 256] in registers (warps 4 x 2: 32 rows by
//     128 columns);
//   W3 in four 64-deep quarters ([128 x 64], sw_at<64>): h2 = relu(acc2 *
//     s2 + t2) over the whole activation region (sw_at<256>) at the
//     first, then acc3 += h2 W3^T (warps 4 x 2: 32 rows by 64 columns);
//   W4 ([56 x 128], rows past k zero): h3 = relu(acc3 * s3 + t3) into the
//     region's second half (sw_at<128>), z4 = h3 W4^T + b4 with a warp per
//     16 whole rows, the log_softmax in registers, the valid rows stored.
// pf (sw_at<64>) and h1_s sit in the region's first half; the next tile's
// pf is copied in (its own commit group) while layer 4 runs. BF: bf16
// operands.
template <bool BF>
__global__ void __launch_bounds__(kThreads, 1)
head_tc_kernel(const HeadArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* act_s = smem;                            // pf, h1 | h2 | h3
  float* pf_s = act_s;                            // [kTile][64]
  float* h1_s = act_s + kHalf;                    // [kTile][64]
  float* h3_s = act_s + kHeadA / 2;               // [kTile][kHeadC3]
  float* ring = act_s + kHeadA;                   // kRing x kSlot
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int c1 = a.c1, k = a.k, ldw1 = kHeadPf + a.c_g;
  const int chunks = c1 / 64, per_tile = 3 * chunks + 5;
  const int tpc = ceil_div(a.n, kTile), tiles = a.batch * tpc;
  const int t0 = blockIdx.x * a.tiles_per_block;
  const int t1 = min(tiles, t0 + a.tiles_per_block);
  const int slices = (t1 - t0) * per_tile;

  // Slice s of the ring into stage s % kRing: one commit group a call,
  // empty past the last slice.
  const auto load_slice = [&](int s) {
    if (s < slices) {
      float* st = ring + (s % kRing) * kSlot;
      const int u = s % per_tile;
      if (u < 3 * chunks && u % 3 == 0) {         // W1a[c]: [64][64]
        const float* src = a.w1 + (size_t)(u / 3) * 64 * ldw1;
        for (int e = threadIdx.x; e < 64 * 16; e += kThreads) {
          const int r = e / 16, q = (e % 16) * 4;
          cp16(st + sw_at<64>(r, q), src + (size_t)r * ldw1 + q, 16);
        }
      } else if (u < 3 * chunks) {                // W2 half: [256][32]
        const float* src = a.w2 + (u / 3) * 64 + (u % 3 - 1) * 32;
        for (int e = threadIdx.x; e < kHeadC2 * 8; e += kThreads) {
          const int r = e / 8, q = (e % 8) * 4;
          cp16(st + sw_at<32>(r, q), src + (size_t)r * c1 + q, 16);
        }
      } else if (u < 3 * chunks + 4) {            // W3 quarter: [128][64]
        const float* src = a.w3 + (u - 3 * chunks) * 64;
        for (int e = threadIdx.x; e < kHeadC3 * 16; e += kThreads) {
          const int r = e / 16, q = (e % 16) * 4;
          cp16(st + sw_at<64>(r, q), src + (size_t)r * kHeadC2 + q, 16);
        }
      } else {                                    // W4: [56][128]
        for (int e = threadIdx.x; e < kHeadN4 * 32; e += kThreads) {
          const int r = e / 32, q = (e % 32) * 4;
          const bool ok = r < k;
          cp16(st + sw_at<128>(r, q), ok ? a.w4 + (size_t)r * kHeadC3 + q
                                         : a.w4, ok ? 16 : 0);
        }
      }
    }
    cp_commit();
  };
  // The tile's pf rows into pf_s (rows past N zero): one commit group.
  const auto load_pf = [&](int t) {
    const int b = t / tpc, p0 = (t - b * tpc) * kTile;
    const int rows = min(kTile, a.n - p0);
    const float* src = a.pf + ((size_t)b * a.n + p0) * kHeadPf;
    for (int e = threadIdx.x; e < kTile * 16; e += kThreads) {
      const int r = e / 16, q = (e % 16) * 4;
      cp16(pf_s + sw_at<64>(r, q), r < rows ? src + (size_t)r * kHeadPf + q
                                            : a.pf, r < rows ? 16 : 0);
    }
    cp_commit();
  };
  load_pf(t0);
  load_slice(0);
  load_slice(1);

  const auto fpf = [pf_s](int m, int q) { return pf_s[sw_at<64>(m, q)]; };
  const auto fh2 = [act_s](int m, int q) { return act_s[sw_at<256>(m, q)]; };
  const auto fh3 = [h3_s](int m, int q) { return h3_s[sw_at<128>(m, q)]; };
  for (int t = t0; t < t1; ++t) {
    const int b = t / tpc, p0 = (t - b * tpc) * kTile;
    const int rows = min(kTile, a.n - p0);
    const size_t g0 = (size_t)b * a.n + p0;
    int s = (t - t0) * per_tile;

    // Layers 1 and 2, chunk by chunk of c1.
    float acc2[2][16][4] = {};
    for (int c = 0; c < chunks; ++c) {
      {  // W1a[c]: h1c into h1_s.
        if (c == 0)
          cp_wait<0>();       // the tile's pf too
        else
          cp_wait<kRing - 2>();
        __syncthreads();      // slice s landed; h1_s is read
        load_slice(s + kRing - 1);
        const float* ws = ring + (s % kRing) * kSlot;
        const auto fw = [ws](int n, int q) { return ws[sw_at<64>(n, q)]; };
        const float* gr = a.grow + (size_t)b * c1 + c * 64;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nb = wn * 32 + half * 16;
          float z[2][2][4] = {};
#pragma unroll 2
          for (int kk = 0; kk < kHeadPf; kk += mma_depth(BF))
            mma_step<2, 2, BF>(z, fpf, fw, wm * 32, nb, kk, gq, tq);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = nb + 8 * j + 2 * tq, o = c * 64 + col;
            const float g0v = __ldg(gr + col), g1v = __ldg(gr + col + 1);
            const float s0 = __ldg(a.scale1 + o), s1 = __ldg(a.scale1 + o + 1);
            const float h0 = __ldg(a.shift1 + o), h1 = __ldg(a.shift1 + o + 1);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = wm * 32 + 16 * i + gq + 8 * h;
                *reinterpret_cast<float2*>(h1_s + sw_at<64>(r, col)) =
                    make_float2(
                        affine_act(__fadd_rn(z[i][j][2 * h], g0v), s0, h0,
                                   kActRelu),
                        affine_act(__fadd_rn(z[i][j][2 * h + 1], g1v), s1, h1,
                                   kActRelu));
              }
          }
        }
        ++s;
      }
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {      // W2[:, c], 32 deep
        cp_wait<kRing - 2>();
        __syncthreads();      // slice s landed; h1_s written
        load_slice(s + kRing - 1);
        const float* ws = ring + (s % kRing) * kSlot;
        const auto fw = [ws](int n, int q) { return ws[sw_at<32>(n, q)]; };
        const auto fa = [h1_s, half](int m, int q) {
          return h1_s[sw_at<64>(m, half * 32 + q)];
        };
        for (int kk = 0; kk < 32; kk += mma_depth(BF))
          wide_step<16, BF>(acc2, fa, fw, wm * 32, wn * 128, kk, gq, tq);
        ++s;
      }
    }

    // Layer 3 by quarters of W3; h2 written at the first.
    float acc3[2][8][4] = {};
    for (int q4 = 0; q4 < 4; ++q4) {
      cp_wait<kRing - 2>();
      __syncthreads();        // slice s landed; acc2's GEMM done: pf, h1 dead
      load_slice(s + kRing - 1);
      if (q4 == 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = wn * 128 + 8 * j + 2 * tq;
          const float s0 = __ldg(a.scale2 + col);
          const float s1 = __ldg(a.scale2 + col + 1);
          const float h0 = __ldg(a.shift2 + col);
          const float h1 = __ldg(a.shift2 + col + 1);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wm * 32 + 16 * i + gq + 8 * h;
              *reinterpret_cast<float2*>(act_s + sw_at<256>(r, col)) =
                  make_float2(affine_act(acc2[i][j][2 * h], s0, h0, kActRelu),
                              affine_act(acc2[i][j][2 * h + 1], s1, h1,
                                         kActRelu));
            }
        }
        __syncthreads();      // h2 written
      }
      const float* ws = ring + (s % kRing) * kSlot;
      const auto fw = [ws](int n, int q) { return ws[sw_at<64>(n, q)]; };
      const auto fa = [fh2, q4](int m, int q) { return fh2(m, q4 * 64 + q); };
#pragma unroll 2
      for (int kk = 0; kk < 64; kk += mma_depth(BF))
        wide_step<8, BF>(acc3, fa, fw, wm * 32, wn * 64, kk, gq, tq);
      ++s;
    }

    // Layer 4 and the log_softmax.
    cp_wait<kRing - 2>();
    __syncthreads();          // W4 landed; h2 is read
    load_slice(s + kRing - 1);
    if (t + 1 < t1) load_pf(t + 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = wn * 64 + 8 * j + 2 * tq;
      const float s0 = __ldg(a.scale3 + col), s1 = __ldg(a.scale3 + col + 1);
      const float h0 = __ldg(a.shift3 + col), h1 = __ldg(a.shift3 + col + 1);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + 16 * i + gq + 8 * h;
          *reinterpret_cast<float2*>(h3_s + sw_at<128>(r, col)) = make_float2(
              affine_act(acc3[i][j][2 * h], s0, h0, kActRelu),
              affine_act(acc3[i][j][2 * h + 1], s1, h1, kActRelu));
        }
    }
    __syncthreads();          // h3 written
    const float* ws = ring + (s % kRing) * kSlot;
    const auto fw = [ws](int n, int q) { return ws[sw_at<128>(n, q)]; };
    float z[1][7][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < kHeadC3; kk += mma_depth(BF))
      mma_step<1, 7, BF>(z, fh3, fw, warp * 16, 0, kk, gq, tq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gq + 8 * h;
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 7; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = 8 * j + 2 * tq + q;
          const float v = col < k ? __fadd_rn(z[0][j][2 * h + q],
                                              __ldg(a.b4 + col))
                                  : -INFINITY;
          z[0][j][2 * h + q] = v;
          m = fmaxf(m, v);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 7; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (8 * j + 2 * tq + q < k) sum += expf(z[0][j][2 * h + q] - m);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float lse = logf(sum);
      if (r >= rows) continue;
      float* dst = a.out + (g0 + r) * k;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const int col = 8 * j + 2 * tq;
        const float v0 = (z[0][j][2 * h] - m) - lse;
        const float v1 = (z[0][j][2 * h + 1] - m) - lse;
        if (k % 2 == 0) {     // rows of 8-byte multiples: 8-byte stores
          if (col < k)
            *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
        } else {
          if (col < k) dst[col] = v0;
          if (col + 1 < k) dst[col + 1] = v1;
        }
      }
    }
  }
  cp_wait<0>();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
}  // namespace pointtpu

// x [batch, n, widths[0]] -> out [batch, widths[n_layers]]: the max over
// points of the chained act_l((h @ W_l^T) * scale_l + shift_l). w, shift
// and scale hold n_layers device pointers each. Takes widths [64, 128, C]
// or [c0, 64, 128, C] with c0 64 or at most 4, C a multiple of 64, 16-byte
// aligned weights (and x at c0 = 64); kErrArgs for anything else. prec
// kRound: bf16 operands (0: fp32).
extern "C" int pt_stack_maxpool(const float* x, float* out,
                                const void* const* w,
                                const void* const* shift,
                                const void* const* scale, const int* widths,
                                const int* acts, int n_layers, int batch,
                                int n, int prec, int device,
                                cudaStream_t stream) {
  using namespace pointtpu;
  if (n_layers < 2 || n_layers > 3 || batch <= 0 || batch > 65535 || n <= 0 ||
      (long long)batch * n > 0x7fffffffLL || (prec & ~kRound))
    return kErrArgs;
  StackArgs a{};
  a.x = x;
  a.out = out;
  a.n_layers = n_layers;
  a.batch = batch;
  a.n = n;
  for (int l = 0; l <= n_layers; ++l) a.width[l] = widths[l];
  for (int l = 0; l < n_layers; ++l) {
    if (acts[l] < 0 || acts[l] > kActLeaky) return kErrArgs;
    a.w[l] = static_cast<const float*>(w[l]);
    a.shift[l] = static_cast<const float*>(shift[l]);
    a.scale[l] = static_cast<const float*>(scale[l]);
    a.act[l] = acts[l];
    if (!aligned16(a.w[l])) return kErrArgs;
  }
  const int c0 = widths[0], c_last = widths[n_layers];
  const bool fma = c0 <= 4;
  const bool ok = widths[n_layers - 1] == kStackK && c_last > 0 &&
                  c_last % kChunk == 0 &&
                  (n_layers == 2 ? c0 == kEarlyK
                                 : (c0 == kEarlyK || (c0 >= 1 && fma)) &&
                                       widths[1] == kEarlyK);
  if (!ok || (!fma && !aligned16(x))) return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;

  // Contiguous tile ranges over the SMs; where the tiles do not fill them,
  // channel splits too.
  const int tiles = batch * ceil_div(n, kTile), chunks = c_last / kChunk;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  a.tiles_per_block = ceil_div(tiles, sms);
  a.chunks_per_block =
      tiles >= sms ? chunks : ceil_div(chunks, std::max(1, sms / tiles));
  const dim3 grid(ceil_div(tiles, a.tiles_per_block),
                  ceil_div(chunks, a.chunks_per_block));
  const size_t bytes = stack_smem_bytes(a);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;

  const long long count = (long long)batch * c_last;
  fill_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0,
                stream>>>(out, -INFINITY, count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool bf = prec & kRound;
  const auto kernel =
      fma ? (bf ? stack_tc_kernel<4, true> : stack_tc_kernel<4, false>)
          : (bf ? stack_tc_kernel<kEarlyK, true>
                : stack_tc_kernel<kEarlyK, false>);
  e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// pf [batch, n, c_pf], g [batch, c_g], w1 [c1, c_pf + c_g], w2 [c2, c1],
// w3 [c3, c2], w4 [k, c3] -> out [batch, n, k] log-probabilities.
// grow is [batch, c1] scratch. Takes c_pf 64, c1 a multiple of 64, c2
// 256, c3 128, k at most 56, c_g a multiple of 4 and 16-byte aligned pf
// and weights; kErrArgs for anything else. prec kRound: bf16 operands (0:
// fp32).
extern "C" int pt_seg_head(const float* pf, const float* g, const float* w1,
                           const float* shift1, const float* scale1,
                           const float* w2, const float* shift2,
                           const float* scale2, const float* w3,
                           const float* shift3, const float* scale3,
                           const float* w4, const float* b4, float* grow,
                           float* out, int batch, int n, int c_pf, int c_g,
                           int c1, int c2, int c3, int k, int prec,
                           int device, cudaStream_t stream) {
  using namespace pointtpu;
  if (batch <= 0 || batch > 65535 || n <= 0 ||
      (long long)batch * n > 0x7fffffffLL || c_pf != kHeadPf || c_g <= 0 ||
      c_g % 4 || c1 <= 0 || c1 % 64 || c2 != kHeadC2 || c3 != kHeadC3 ||
      k <= 0 || k > kHeadN4 || !aligned16(pf) || !aligned16(w1) ||
      !aligned16(w2) || !aligned16(w3) || !aligned16(w4) || (prec & ~kRound))
    return kErrArgs;
  const bool bf = prec & kRound;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = ((size_t)kHeadA + kRing * kSlot) * sizeof(float);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;

  const long long rows = (long long)batch * c1;
  global_row_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                      stream>>>(g, w1, grow, batch, c_pf, c_g, c1, bf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const auto kernel = bf ? head_tc_kernel<true> : head_tc_kernel<false>;
  e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  HeadArgs a{pf, grow, w1, shift1, scale1, w2, shift2, scale2, w3, shift3,
             scale3, w4, b4, out, batch, n, c_g, c1, k, 0};
  const int tiles = batch * ceil_div(n, kTile);
  a.tiles_per_block =
      ceil_div(tiles, device_attr(cudaDevAttrMultiProcessorCount));
  kernel<<<ceil_div(tiles, a.tiles_per_block), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}
