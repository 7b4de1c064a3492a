// The encoder's two eval megakernels: the pointwise stack with its max
// over points, and the concat-free seg head with its log_softmax.
//
// fused_stack_maxpool replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/encoder_fused.py::
// fused_stack_maxpool (pallas_call at encoder_fused.py:109).
//   Bound: FMAs. The trunk's last layer is 128 x 1024 per point, about
//   4 GFLOP per batch of 32 x 2500 points, against 10 KB of input per
//   cloud. The plain version also writes and rereads [B, N, 1024].
//   Design: [B, N, c_out] never reaches device memory. A block owns one
//   cloud, one tile of at most 256 output channels and a range of point
//   tiles; its slice of the last weight (128 x 256 fp32 = 128 KB) and the
//   narrow earlier weights stay resident in shared memory (dynamic, above
//   48 KB) for the whole loop, and the early layers are recomputed per
//   64-point tile in shared memory, in two ping-pong activation tiles
//   (STNkd's working set is then 225 KB of the 227 KB a block may have).
//   Per k step a warp reads 8 broadcast activations and 8 weight words
//   for 64 FMAs, so shared-memory bandwidth and FMA issue are about
//   even. The running max lives in registers. The
//   TPU carried it across a sequential grid axis; here blocks run in no
//   order, so each block merges its max into the output with one
//   order-preserving atomic max per channel and warp, over an output set
//   to -inf first. Max is exact in any order, so the result is
//   deterministic. Point ranges are split across blocks only as far as
//   needed to fill the SMs (one cloud: 4 channel tiles x 20 ranges).
//   The ragged tail is masked out of the max; nothing is padded.
//
// seg_head_fused replaces
// adversarial_learning_on_pointclouds_tpu/ops/kernels/encoder_fused.py::
// seg_head_fused (pallas_call at encoder_fused.py:182).
//   Bound: FMAs, about 2e5 per point (64x512 + 512x256 + 256x128 +
//   128x50), and the L2 traffic of the weights streamed to every tile.
//   Design: the [B, N, 1088] concat never exists. A prologue kernel
//   computes the global half once per cloud, g @ W1[:, 64:]^T -> [B, 512],
//   which enters layer 1 as a per-channel addend. The main kernel takes a
//   tile of 64 points through 512/256/128/k channels with every
//   intermediate in shared memory (two ping-pong buffers, 192 KB), and
//   ends in a per-point log_softmax that subtracts the max first. The
//   weights (0.8 MB fp32 past the global half, L2-resident) stream in
//   16-row chunks through a double buffer: the next chunk's loads are in
//   flight in registers while the current one is multiplied, so each
//   chunk costs one barrier and no exposed L2 latency, and every weight
//   fetched serves 64 points. The ragged tail is masked at the store;
//   there are no pad rows.
//
// Weights arrive in PyTorch's [out, in] row-major layout.

#include <algorithm>

#include "common.cuh"

namespace pointtpu {

constexpr int kMaxLayers = 4;
constexpr int kStackRows = 8;                      // stack: 64-point tiles
constexpr int kStackTile = kStackRows * kWarps;
constexpr int kHeadRows = 8;                       // head: 64-point tiles
constexpr int kHeadTile = kHeadRows * kWarps;
constexpr int kKChunk = 16;   // weight rows per staging step (seg head)

struct StackArgs {
  const float* x;
  float* out;
  const float* w[kMaxLayers];
  const float* shift[kMaxLayers];
  const float* scale[kMaxLayers];
  int width[kMaxLayers + 1];
  int act[kMaxLayers];
  int n_layers;
  int n;                 // points per cloud
  int tile_cols;         // last-layer channels per block
  int tiles_per_split;   // point tiles per block
};

// Activation l of the stack (the input for l = 0, else layer l-1's
// output) lives in ping-pong tile l % 2: the widest activation of that
// parity sets the tile's width.
__host__ __device__ inline int act_width(const int* width, int layers,
                                         int parity) {
  int c = 0;
  for (int l = parity; l < layers; l += 2) c = width[l] > c ? width[l] : c;
  return c;
}

// Shared-memory floats of stack_maxpool_kernel: the two activation tiles,
// each hidden layer's resident transposed weight, then the block's tile
// of the last weight.
inline size_t stack_smem_floats(const int* width, int layers, int tile_cols) {
  size_t f = (size_t)kStackTile * (act_width(width, layers, 0) +
                                   act_width(width, layers, 1));
  for (int l = 0; l + 1 < layers; ++l)
    f += (size_t)width[l] * (pad32(width[l + 1]) + 1);
  return f + (size_t)width[layers - 1] * (tile_cols + 1);
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

// A hidden layer of the stack: all cout columns, weights resident.
__device__ __forceinline__ void resident_layer(const float* in_s, int nk,
                                               const float* w_s, int cout,
                                               const float* scale,
                                               const float* shift, int act,
                                               float* out_s) {
  const int cp = pad32(cout);
  for (int o0 = 0; o0 < cp; o0 += kMaxCols) {
    with_nj(min(kMaxCols, cp - o0), [&](auto nj) {
      constexpr int NJ = decltype(nj)::value;
      float acc[kStackRows][NJ] = {};
      tile_fma<kStackRows, NJ>(acc, in_s, nk, w_s + o0, cp + 1, nk);
      store_tile<kStackRows, NJ>(acc, out_s, cout, o0, cout, scale, shift,
                                 nullptr, act);
    });
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
stack_maxpool_kernel(const StackArgs a) {
  extern __shared__ float smem[];
  const int layers = a.n_layers;
  const int b = blockIdx.z;
  const int o0 = blockIdx.x * a.tile_cols;
  const int c_last = a.width[layers], k_last = a.width[layers - 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float* act_s[2];
  act_s[0] = smem;
  act_s[1] = act_s[0] + kStackTile * act_width(a.width, layers, 0);
  float* p = act_s[1] + kStackTile * act_width(a.width, layers, 1);
  float* w_s[kMaxLayers];
  for (int l = 0; l + 1 < layers; ++l) {
    w_s[l] = p;
    p += (size_t)a.width[l] * (pad32(a.width[l + 1]) + 1);
    load_wt(w_s[l], pad32(a.width[l + 1]) + 1, a.w[l], a.width[l], 0,
            a.width[l + 1], pad32(a.width[l + 1]), 0, a.width[l]);
  }
  float* wl_s = p;
  constexpr int kLd = NJ * 32 + 1;
  load_wt(wl_s, kLd, a.w[layers - 1], k_last, o0, min(NJ * 32, c_last - o0),
          NJ * 32, 0, k_last);

  float sc[NJ], sh[NJ], run[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = o0 + lane + 32 * j;
    sc[j] = o < c_last ? __ldg(a.scale[layers - 1] + o) : 0.f;
    sh[j] = o < c_last ? __ldg(a.shift[layers - 1] + o) : 0.f;
    run[j] = -INFINITY;
  }
  const int act_last = a.act[layers - 1];
  const int n_tiles = (a.n + kStackTile - 1) / kStackTile;
  const int t0 = blockIdx.y * a.tiles_per_split;
  const int t1 = min(n_tiles, t0 + a.tiles_per_split);
  const float* xb = a.x + (size_t)b * a.n * a.width[0];

  for (int t = t0; t < t1; ++t) {
    const int p0 = t * kStackTile;
    const int rows = min(kStackTile, a.n - p0);
    __syncthreads();  // weights loaded / previous tile fully read
    load_rows(act_s[0], xb + (size_t)p0 * a.width[0], rows, a.width[0],
              kStackTile);
    __syncthreads();
    for (int l = 0; l + 1 < layers; ++l) {
      resident_layer(act_s[l & 1], a.width[l], w_s[l], a.width[l + 1],
                     a.scale[l], a.shift[l], a.act[l], act_s[(l + 1) & 1]);
      __syncthreads();
    }
    float acc[kStackRows][NJ] = {};
    tile_fma<kStackRows, NJ>(acc, act_s[(layers - 1) & 1], k_last, wl_s, kLd,
                             k_last);
#pragma unroll
    for (int i = 0; i < kStackRows; ++i) {
      if (warp + i * kWarps >= rows) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        run[j] = fmaxf(run[j],
                       apply_act(acc[i][j] * sc[j] + sh[j], act_last));
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = o0 + lane + 32 * j;
    if (o < c_last && t0 < t1)
      atomic_max_float(a.out + (size_t)b * c_last + o, run[j]);
  }
}

template <int NJ>
cudaError_t launch_stack(const StackArgs& a, dim3 grid, size_t bytes,
                         cudaStream_t stream) {
  cudaError_t e = allow_smem(stack_maxpool_kernel<NJ>, bytes);
  if (e != cudaSuccess) return e;
  stack_maxpool_kernel<NJ><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

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
  int n, c_pf, c_g, c1, c2, c3, k;
};

// Floats of one staging buffer: kKChunk weight rows of up to kMaxCols
// columns, row stride cols + 2 (see HeadStage).
constexpr int kStageFloats = kKChunk * (kMaxCols + 2);

// A kKChunk x COLS slice of W^T staged for tile_fma. Thread t holds
// W[o0 + t/16 + 16q][k0 + t%16] for q < COLS/16 in registers: a warp
// reads two 64-byte row segments, with no integer division. The row
// stride COLS + 2 puts the two half-warps on even and odd banks, so the
// transposing stores do not conflict.
template <int COLS>
struct HeadStage {
  static constexpr int kLd = COLS + 2;
  static constexpr int kPer = COLS / 16;
  float v[kPer];

  __device__ __forceinline__ void fetch(const float* __restrict__ w, int ldw,
                                        int o0, int cout, int k0, int nk) {
    const int kk = threadIdx.x & (kKChunk - 1), rg = threadIdx.x / kKChunk;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int o = o0 + rg + 16 * q;
      v[q] = (o < cout && k0 + kk < nk)
                 ? __ldg(w + (size_t)o * ldw + k0 + kk) : 0.f;
    }
  }
  __device__ __forceinline__ void put(float* buf) const {
    const int kk = threadIdx.x & (kKChunk - 1), rg = threadIdx.x / kKChunk;
#pragma unroll
    for (int q = 0; q < kPer; ++q) buf[kk * kLd + rg + 16 * q] = v[q];
  }
};

// out_s = act((in_s @ W[:, :nk]^T + extra) * scale + shift), with W
// (row stride ldw) streamed from L2 through two staging buffers: the
// next chunk's loads are in flight in registers while the current chunk
// is multiplied, and one barrier per chunk separates the two.
__device__ __forceinline__ void streamed_layer(
    const float* in_s, int nk, const float* w, int ldw, int cout,
    const float* scale, const float* shift, const float* extra, int act,
    float* stage, float* out_s) {
  const int cp = pad32(cout);
  const int chunks = (nk + kKChunk - 1) / kKChunk;
  for (int o0 = 0; o0 < cp; o0 += kMaxCols) {
    with_nj(min(kMaxCols, cp - o0), [&](auto nj) {
      constexpr int NJ = decltype(nj)::value;
      using Stage = HeadStage<NJ * 32>;
      Stage st;
      float acc[kHeadRows][NJ] = {};
      st.fetch(w, ldw, o0, cout, 0, nk);
      st.put(stage);
      __syncthreads();  // chunk 0 staged; in_s written
      for (int c = 0; c < chunks; ++c) {
        const int k0 = c * kKChunk;
        if (c + 1 < chunks) st.fetch(w, ldw, o0, cout, k0 + kKChunk, nk);
        tile_fma<kHeadRows, NJ>(acc, in_s + k0, nk,
                                stage + (c & 1) * kStageFloats, Stage::kLd,
                                min(kKChunk, nk - k0));
        if (c + 1 < chunks) st.put(stage + ((c + 1) & 1) * kStageFloats);
        __syncthreads();
      }
      store_tile<kHeadRows, NJ>(acc, out_s, cout, o0, cout, scale, shift,
                                extra, act);
    });
  }
}

__global__ void __launch_bounds__(kThreads)
global_row_kernel(const float* __restrict__ g, const float* __restrict__ w1,
                  float* __restrict__ grow, int batch, int c_pf, int c_g,
                  int c1) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // one per warp
  const int lane = threadIdx.x & 31;
  if (row >= batch * c1) return;
  const int b = row / c1, o = row - b * c1;
  const float* gb = g + (size_t)b * c_g;
  const float* wo = w1 + (size_t)o * (c_pf + c_g) + c_pf;
  float acc = 0.f;
  for (int i = lane; i < c_g; i += 32) acc = fmaf(__ldg(gb + i), __ldg(wo + i), acc);
  for (int s = 16; s; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) grow[row] = acc;
}

inline size_t head_smem_floats(int c_pf, int c1, int c2, int c3, int k) {
  const int a = std::max(c1, c3), b = std::max(std::max(c_pf, c2), k);
  return (size_t)kHeadTile * (a + b) + 2 * (size_t)kStageFloats;
}

__global__ void __launch_bounds__(kThreads, 1)
seg_head_kernel(const HeadArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, p0 = blockIdx.x * kHeadTile;
  const int rows = min(kHeadTile, a.n - p0);
  float* buf_a = smem;                                   // h1, h3
  float* buf_b = buf_a + kHeadTile * max(a.c1, a.c3);    // pf, h2, z4
  float* stage = buf_b + kHeadTile * max(max(a.c_pf, a.c2), a.k);

  load_rows(buf_b, a.pf + ((size_t)b * a.n + p0) * a.c_pf, rows, a.c_pf,
            kHeadTile);
  streamed_layer(buf_b, a.c_pf, a.w1, a.c_pf + a.c_g, a.c1, a.scale1,
                 a.shift1, a.grow + (size_t)b * a.c1, kActRelu, stage, buf_a);
  streamed_layer(buf_a, a.c1, a.w2, a.c1, a.c2, a.scale2, a.shift2, nullptr,
                 kActRelu, stage, buf_b);
  streamed_layer(buf_b, a.c2, a.w3, a.c2, a.c3, a.scale3, a.shift3, nullptr,
                 kActRelu, stage, buf_a);
  streamed_layer(buf_a, a.c3, a.w4, a.c3, a.k, nullptr, a.b4, nullptr,
                 kActNone, stage, buf_b);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    const float* z = buf_b + r * a.k;
    float m = -INFINITY;
    for (int o = lane; o < a.k; o += 32) m = fmaxf(m, z[o]);
    for (int s = 16; s; s >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    float sum = 0.f;
    for (int o = lane; o < a.k; o += 32) sum += expf(z[o] - m);
    for (int s = 16; s; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
    const float lse = logf(sum) + m;
    float* dst = a.out + ((size_t)b * a.n + p0 + r) * a.k;
    for (int o = lane; o < a.k; o += 32) dst[o] = z[o] - lse;
  }
}

}  // namespace pointtpu

// x [batch, n, widths[0]] -> out [batch, widths[n_layers]]: the max over
// points of the chained act_l((h @ W_l^T) * scale_l + shift_l). w, shift
// and scale hold n_layers device pointers each.
extern "C" int pt_stack_maxpool(const float* x, float* out,
                                const void* const* w,
                                const void* const* shift,
                                const void* const* scale, const int* widths,
                                const int* acts, int n_layers, int batch,
                                int n, int device, cudaStream_t stream) {
  using namespace pointtpu;
  if (n_layers < 1 || n_layers > kMaxLayers || batch <= 0 || batch > 65535 ||
      n <= 0)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  StackArgs a{};
  a.x = x;
  a.out = out;
  a.n_layers = n_layers;
  a.n = n;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] <= 0) return kErrArgs;
    a.width[l] = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    if (acts[l] < 0 || acts[l] > kActLeaky) return kErrArgs;
    a.w[l] = static_cast<const float*>(w[l]);
    a.shift[l] = static_cast<const float*>(shift[l]);
    a.scale[l] = static_cast<const float*>(scale[l]);
    a.act[l] = acts[l];
  }
  const int c_last = widths[n_layers];
  const size_t limit = (size_t)max_smem_optin();
  int tile = std::min(kMaxCols, pad32(c_last));
  while (tile >= 32 &&
         stack_smem_floats(widths, n_layers, tile) * sizeof(float) > limit)
    tile -= 32;
  if (tile < 32) return kErrSmem;
  const size_t bytes = stack_smem_floats(widths, n_layers, tile) * sizeof(float);
  a.tile_cols = tile;

  const int col_tiles = (c_last + tile - 1) / tile;
  const int n_tiles = (n + kStackTile - 1) / kStackTile;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  int splits = sms / (batch * col_tiles);
  splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
  a.tiles_per_split = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + a.tiles_per_split - 1) / a.tiles_per_split;

  const long long count = (long long)batch * c_last;
  fill_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0,
                stream>>>(out, -INFINITY, count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(col_tiles, splits, batch);
  switch (tile / 32) {
    case 1: return (int)launch_stack<1>(a, grid, bytes, stream);
    case 2: return (int)launch_stack<2>(a, grid, bytes, stream);
    case 3: return (int)launch_stack<3>(a, grid, bytes, stream);
    case 4: return (int)launch_stack<4>(a, grid, bytes, stream);
    case 5: return (int)launch_stack<5>(a, grid, bytes, stream);
    case 6: return (int)launch_stack<6>(a, grid, bytes, stream);
    case 7: return (int)launch_stack<7>(a, grid, bytes, stream);
    default: return (int)launch_stack<8>(a, grid, bytes, stream);
  }
}

// pf [batch, n, c_pf], g [batch, c_g], w1 [c1, c_pf + c_g], w2 [c2, c1],
// w3 [c3, c2], w4 [k, c3] -> out [batch, n, k] log-probabilities.
// grow is [batch, c1] scratch.
extern "C" int pt_seg_head(const float* pf, const float* g, const float* w1,
                           const float* shift1, const float* scale1,
                           const float* w2, const float* shift2,
                           const float* scale2, const float* w3,
                           const float* shift3, const float* scale3,
                           const float* w4, const float* b4, float* grow,
                           float* out, int batch, int n, int c_pf, int c_g,
                           int c1, int c2, int c3, int k, int device,
                           cudaStream_t stream) {
  using namespace pointtpu;
  if (batch <= 0 || batch > 65535 || n <= 0 || c_pf <= 0 || c_g <= 0 ||
      c1 <= 0 || c2 <= 0 || c3 <= 0 || k <= 0)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = head_smem_floats(c_pf, c1, c2, c3, k) * sizeof(float);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;

  const long long rows = (long long)batch * c1;
  global_row_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                      stream>>>(g, w1, grow, batch, c_pf, c_g, c1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(seg_head_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  HeadArgs a{pf, grow, w1, shift1, scale1, w2, shift2, scale2, w3, shift3,
             scale3, w4, b4, out, n, c_pf, c_g, c1, c2, c3, k};
  const dim3 grid((n + kHeadTile - 1) / kHeadTile, batch);
  seg_head_kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}
