// Shared building blocks of the port's hand-written Hopper kernels.
//
// Every kernel here is a pointwise MLP over point tiles: a block of 256
// threads (8 warps) owns a tile of 8 * ROWS points, held row-major in
// shared memory, and computes one layer as
//
//     acc[p][o] = sum_k in_s[p][k] * w_s[k][o]            (fp32 FMA)
//
// Warp w owns rows w, w+8, w+16, ... (ROWS of them); lane l owns columns
// l, l+32, ... (NJ per lane, at most 8, so one pass covers 256). The
// activation operand is read as a warp-wide broadcast and the weight
// operand as 32 consecutive words, so neither read conflicts on the
// shared-memory banks. Weights are stored in shared memory transposed
// ([k][o], row stride cols + 1) from PyTorch's [out, in] layout: the
// global reads run along k (coalesced) and the padded stride keeps the
// transposing writes conflict-free.
//
// fp32 on the CUDA cores with fp32 accumulation, as the serving path
// runs in fp32 (the TPU kernels pin HIGHEST outside mixed precision).
// The training and discriminator kernels also take mixed precision (the
// prec bits below): every matmul operand rounded to bf16 (nearest even)
// where it enters shared memory, the FMA loop and its sums in fp32, and
// the pre-BN stashes between passes stored as __nv_bfloat16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace pointtpu {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 256;                    // columns per pass

// Status codes shared with the Python wrappers (ops/build.py).
constexpr int kErrArgs = -1;     // shapes the kernel does not take
constexpr int kErrSmem = -2;     // working set exceeds shared memory

// Bits of the argument structs' prec field (ops/launch.py: ROUND,
// BF16_BITS): round every matmul operand to bf16, and which tensors are
// bf16 stashes (RowFwdArgs: x, z; BwdArgs: zp, zc, dy, dyp).
constexpr int kRound = 1;
constexpr int kXBf16 = 2, kZBf16 = 4, kDyBf16 = 8, kDypBf16 = 16;
constexpr int kZpBf16 = kXBf16, kZcBf16 = kZBf16;

enum Act { kActNone = 0, kActRelu = 1, kActLeaky = 2 };

__host__ __device__ __forceinline__ int pad32(int c) { return (c + 31) & ~31; }

// v as a matmul operand: rounded to bf16 (nearest even) under bf.
__device__ __forceinline__ float operand(float v, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// p[i] of an fp32 or (bf) bf16 tensor, as fp32.
__device__ __forceinline__ float load_val(const void* p, bool bf, size_t i) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : __ldg(static_cast<const float*>(p) + i);
}

__device__ __forceinline__ void store_val(void* p, bool bf, size_t i,
                                          float v) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// Rounds count shared-memory operands to bf16 in place (no barrier).
__device__ __forceinline__ void round_smem(float* s, int count) {
  for (int e = threadIdx.x; e < count; e += kThreads) s[e] = operand(s[e], true);
}

__device__ __forceinline__ float apply_act(float z, int act) {
  if (act == kActRelu) return fmaxf(z, 0.f);
  if (act == kActLeaky) return z >= 0.f ? z : 0.2f * z;
  return z;
}

// w_s[kk * ld + o] = W[(o0 + o) * ldw + k0 + kk] for o < cols, kk < nk;
// columns at or past n_valid are zero.
__device__ __forceinline__ void load_wt(float* w_s, int ld,
                                        const float* __restrict__ w, int ldw,
                                        int o0, int n_valid, int cols,
                                        int k0, int nk) {
  for (int idx = threadIdx.x; idx < cols * nk; idx += kThreads) {
    const int o = idx / nk;
    const int kk = idx - o * nk;
    w_s[kk * ld + o] =
        o < n_valid ? __ldg(w + (size_t)(o0 + o) * ldw + k0 + kk) : 0.f;
  }
}

// Rows [0, rows) of a contiguous [rows, c] block into the tile of
// tile_rows rows at in_s; the rest is zero (inert: those rows are never
// stored or pooled).
__device__ __forceinline__ void load_rows(float* in_s,
                                          const float* __restrict__ src,
                                          int rows, int c, int tile_rows) {
  const int valid = rows * c;
  for (int idx = threadIdx.x; idx < tile_rows * c; idx += kThreads)
    in_s[idx] = idx < valid ? __ldg(src + idx) : 0.f;
}

template <int ROWS, int NJ>
__device__ __forceinline__ void tile_fma(float (&acc)[ROWS][NJ],
                                         const float* in_s, int ld_in,
                                         const float* w_s, int ld_w, int nk) {
  const int lane = threadIdx.x & 31;
  const float* a = in_s + (threadIdx.x >> 5) * ld_in;
  const float* w = w_s + lane;
#pragma unroll 4
  for (int k = 0; k < nk; ++k) {
    float av[ROWS], wv[NJ];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) av[i] = a[i * kWarps * ld_in + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) wv[j] = w[k * ld_w + 32 * j];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
  }
}

// out_s[p][o0 + c] = act((acc + extra[o]) * scale[o] + shift[o]) for the
// columns below cout. extra and scale may be null (0 and 1).
template <int ROWS, int NJ>
__device__ __forceinline__ void store_tile(const float (&acc)[ROWS][NJ],
                                           float* out_s, int ld_out, int o0,
                                           int cout,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift,
                                           const float* __restrict__ extra,
                                           int act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = o0 + lane + 32 * j;
    if (o >= cout) continue;
    const float sc = scale ? __ldg(scale + o) : 1.f;
    const float sh = __ldg(shift + o);
    const float ex = extra ? __ldg(extra + o) : 0.f;
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      out_s[(warp + i * kWarps) * ld_out + o] =
          apply_act((acc[i][j] + ex) * sc + sh, act);
  }
}

template <int NJ>
using Nj = std::integral_constant<int, NJ>;

// Calls f(Nj<cols / 32>{}) so the column count is a compile-time
// constant inside f (cols is a multiple of 32, at most kMaxCols).
template <typename F>
__device__ __forceinline__ void with_nj(int cols, F&& f) {
  switch (cols >> 5) {
    case 1: f(Nj<1>{}); break;
    case 2: f(Nj<2>{}); break;
    case 3: f(Nj<3>{}); break;
    case 4: f(Nj<4>{}); break;
    case 5: f(Nj<5>{}); break;
    case 6: f(Nj<6>{}); break;
    case 7: f(Nj<7>{}); break;
    default: f(Nj<8>{}); break;
  }
}

// The library links its own copy of the CUDA runtime, whose current
// device is not PyTorch's: every entry point selects the tensors' device.
inline cudaError_t use_device(int device) { return cudaSetDevice(device); }

inline int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

inline int max_smem_optin() {
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// Allow a kernel above the 48 KB default of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace pointtpu
