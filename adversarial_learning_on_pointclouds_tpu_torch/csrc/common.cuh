// Shared building blocks of the port's hand-written Hopper kernels: the
// block shape of the CUDA-core kernels (256 threads, 8 warps), the status
// codes and prec bits shared with the Python wrappers, the activations,
// the bf16 operand rounding of mixed precision, and the host-side device
// queries. The tensor-core kernels build on mma.cuh, which includes this.
//
// fp32 is the default (the TPU kernels pin HIGHEST outside mixed
// precision). Under mixed precision (the prec bits below) every matmul
// operand is rounded to bf16 (nearest even) before it is multiplied, sums
// stay fp32, and the pre-BN stashes between passes are stored as
// __nv_bfloat16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace pointtpu {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
