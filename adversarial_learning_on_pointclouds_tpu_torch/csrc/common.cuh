// Shared building blocks of the port's hand-written Hopper kernels.
//
// A CUDA-core kernel built on tile_fma (train_gemm.cuh's row GEMM) is a
// pointwise MLP over point tiles: a block of 256 threads (8 warps) owns a
// tile of 8 * ROWS points, held row-major in shared memory, and computes
// one layer as
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
// fp32 on the CUDA cores with fp32 accumulation (the TPU kernels pin
// HIGHEST outside mixed precision). The kernels also take mixed precision
// (the prec bits below): every matmul operand rounded to bf16 (nearest even)
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
constexpr int kErrCluster = -3;  // no GPC holds the thread-block cluster

// Bits of the argument structs' prec field (ops/launch.py: ROUND,
// BF16_BITS): round every matmul operand to bf16, and which tensors are
// bf16 stashes (RowFwdArgs: x, z; BwdArgs: zp, zc, dy, dyp).
constexpr int kRound = 1;
constexpr int kXBf16 = 2, kZBf16 = 4, kDyBf16 = 8, kDypBf16 = 16;
constexpr int kZpBf16 = kXBf16, kZcBf16 = kZBf16;

enum Act { kActNone = 0, kActRelu = 1, kActLeaky = 2 };

__host__ __device__ __forceinline__ int pad32(int c) { return (c + 31) & ~31; }

__host__ __device__ inline int ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// v as a matmul operand: rounded to bf16 (nearest even) under bf.
__device__ __forceinline__ float operand(float v, bool bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// p[i] of an fp32 or (bf) bf16 tensor, as fp32.
__device__ __forceinline__ float load_val(const void* p, bool bf, size_t i) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : __ldg(static_cast<const float*>(p) + i);
}

__device__ __forceinline__ float apply_act(float z, int act) {
  if (act == kActRelu) return fmaxf(z, 0.f);
  if (act == kActLeaky) return z >= 0.f ? z : 0.2f * z;
  return z;
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

template <int NJ>
using Nj = std::integral_constant<int, NJ>;

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
