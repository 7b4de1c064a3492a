// The fused discriminator's argument struct, the widths of its stack and
// its LeakyReLU (its passes: disc_tc.cu).

#pragma once

#include <cuda_runtime.h>

namespace pointtpu {

constexpr int kD1 = 64, kD2 = 128, kD3 = 256, kD4 = 512;
constexpr int kDiscMaxK = 64;       // input width the kernels take
constexpr float kSlope = 0.2f;

namespace {  // each translation unit keeps its own copy

__device__ __forceinline__ float leaky(float z) {
  return z >= 0.f ? z : __fmul_rn(kSlope, z);
}

__device__ __forceinline__ float dleaky(float h) {  // from the output's sign
  return h >= 0.f ? 1.f : kSlope;
}

}  // namespace

// Mirror of the Python side's ctypes structure (ops/launch.py), field for
// field. A null pointer switches its output off.
struct DiscArgs {
  int m, k, prec;            // rows, input width, kRound or 0
  int split1, split2, split3, split4;  // row ranges of dW1..dW4 (bwd_dw)
  const float* x;            // [m, k]
  const float* g;            // [m] cotangent of the logits (backward)
  const float* w1;           // [64, k]   row-major (PyTorch's [out, in])
  const float* w2;           // [128, 64]
  const float* w3;           // [256, 128]
  const float* w4;           // [512, 256]
  const float* w5;           // [1, 512]
  const float* b1;
  const float* b2;
  const float* b3;
  const float* b4;
  const float* b5;
  float* logits;             // [m] (forward)
  float* dx;                 // [m, k], or null
  float* grad;               // [GradLayout(k).size]: dW1..dW5, db1..db5
  // bwd_dw's scratch (disc_tc.cu): the row pass's per-block partials,
  // its dz and h for dW = dz^T h on the GEMM core, and that product's
  // split-K partials.
  float* part;               // [tiles, kPartCols]
  float* dzs;                // [m, kDzCols]: dz1 | dz2 | dz3 | dz4
  float* hs;                 // [m, kHCols]: h1 | h2 | h3
  float* part_w;             // dW1..dW4's partials, split s at [s][out][in]
};

}  // namespace pointtpu
