// tnet_apply: the T-Net transform y[b] = x[b] @ T[b] of every cloud, and
// its backward dx[b] = g[b] @ T[b]^T, dT[b] = x[b]^T g[b].
//
// Replaces the TPU kernels
// adversarial_learning_on_pointclouds_tpu/ops/kernels/tnet_apply.py::
// _apply_call (pallas_call at tnet_apply.py:32: the forward, and dx on
// the transposed T) and _dt_kernel (tnet_apply.py:74: dT accumulated over
// the point tiles of each cloud).
//
// What bounds it on the H100: k is 3 (the input transform) or 64 (the
// feature transform), so each point does k FMAs per output value against
// 8 bytes moved: 0.75 or 16 FMAs per byte, far under the card's balance
// point. Device-memory traffic bounds all three products.
//
// What the design does about that: at k = 64 each product is one batched
// call of the GEMM core (strided_gemm.cu: a 128-point by 64-column tile
// of one cloud on the tensor cores, 3xTF32, operands through a cp.async
// ring), x, g, y and dx each read or written once and T^T and x^T
// strided views of the same storage, never copies. At k = 3 a 128 x 64
// tile would be more than 95% padding, so the forward and dx take the
// core's streaming kernel for depth <= 4 (T in shared memory, 9 fp32
// FMAs a point, stores in row-major order) and dT takes thin_dt_kernel
// below: 9 products a point summed over a point range per thread, then
// across the warp and the block in a fixed order. dT sums over all
// points of a cloud: the points split into ranges, each range's partial
// [k, k] goes to scratch and the ranges of each cloud are added in fp64
// in a fixed order. All three products are fp32 (3xTF32 at k = 64), under
// mixed precision too, as the JAX kernels pin HIGHEST precision.

#include "strided_gemm.cuh"

namespace pointtpu {

// Mirror of the Python side's ctypes structure (ops/launch.py).
struct TnetArgs {
  int batch, n, k, splits;
  const float* x;      // [batch, n, k] (forward, dT)
  const float* t;      // [batch, k, k] (forward, dx)
  const float* g;      // [batch, n, k] cotangent of y (dx, dT)
  float* y;            // [batch, n, k] (forward)
  float* dx;           // [batch, n, k]
  float* dt;           // [batch, k, k]
  float* part;         // scratch [batch, splits, k, k] (dT)
};

namespace {

// part[(b * splits + s) * k * k + i * k + j] = sum of x[b][p][i] *
// g[b][p][j] over the points p of range s, for k <= kThinK: fp32 per
// thread in point order, then the warp's lanes and the block's warps
// added in a fixed order.
__global__ void __launch_bounds__(kThreads)
thin_dt_kernel(const float* __restrict__ x, const float* __restrict__ g,
               int n, int k, int splits, float* __restrict__ part) {
  constexpr int kKK = kThinK * kThinK;
  __shared__ float red[kWarps][kKK];
  const int s = blockIdx.x, b = blockIdx.y;
  const int per = (int)cdiv(n, splits);
  const int p0 = s * per, p1 = min(n, p0 + per);
  const float* xb = x + (size_t)b * n * k;
  const float* gb = g + (size_t)b * n * k;
  float acc[kKK] = {};
  for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
    float xv[kThinK], gv[kThinK];
#pragma unroll
    for (int i = 0; i < kThinK; ++i) {
      xv[i] = i < k ? __ldg(xb + (size_t)p * k + i) : 0.f;
      gv[i] = i < k ? __ldg(gb + (size_t)p * k + i) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kThinK; ++i)
#pragma unroll
      for (int j = 0; j < kThinK; ++j)
        acc[i * kThinK + j] = fmaf(xv[i], gv[j], acc[i * kThinK + j]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kKK; ++e) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc[e] += __shfl_down_sync(0xffffffffu, acc[e], off);
    if (lane == 0) red[warp][e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < k * k) {
    const int i = threadIdx.x / k, j = threadIdx.x - i * k;
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w][i * kThinK + j];
    part[((size_t)b * splits + s) * k * k + threadIdx.x] = t;
  }
}

bool bad(const TnetArgs* a) {
  return a->batch <= 0 || a->n <= 0 || a->k <= 0;
}

// One cloud's [n, k] rows against a [k, k] matrix per cloud.
Gemm per_cloud(const TnetArgs* a, const float* rows, const float* mat,
               bool transposed, float* out) {
  Gemm g{};
  g.m = a->n, g.n = a->k, g.k = a->k, g.batch = a->batch, g.splits = 1;
  g.sam = a->k, g.sak = 1;
  g.sbk = transposed ? 1 : a->k;       // B[j][c] = T[j][c], or T[c][j]
  g.sbn = transposed ? a->k : 1;
  g.bsa = (long long)a->n * a->k, g.bsb = (long long)a->k * a->k;
  g.ldc = a->k, g.bsc = (long long)a->n * a->k;
  g.a = rows, g.b = mat, g.c = out;
  return g;
}

}  // namespace
}  // namespace pointtpu

// y[b] = x[b] @ T[b].
extern "C" int pt_tnet_fwd(const pointtpu::TnetArgs* a, int device,
                           cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->x || !a->t || !a->y) return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  return gemm(per_cloud(a, a->x, a->t, false, a->y), false, stream);
}

// dx[b] = g[b] @ T[b]^T.
extern "C" int pt_tnet_dx(const pointtpu::TnetArgs* a, int device,
                          cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->g || !a->t || !a->dx) return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  return gemm(per_cloud(a, a->g, a->t, true, a->dx), false, stream);
}

// dT[b] = x[b]^T g[b], over `splits` point ranges per cloud added in fp64.
extern "C" int pt_tnet_dt(const pointtpu::TnetArgs* a, int device,
                          cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->x || !a->g || !a->dt || !a->part || a->splits <= 0)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const long long kk = (long long)a->k * a->k;
  if (a->k <= kThinK) {
    if (a->batch > 65535) return kErrArgs;
    thin_dt_kernel<<<dim3((unsigned)a->splits, (unsigned)a->batch), kThreads,
                     0, stream>>>(a->x, a->g, a->n, a->k, a->splits, a->part);
    const int s = (int)cudaGetLastError();
    if (s) return s;
    return split_sum(a->part, a->splits, kk, a->batch, a->dt, stream);
  }
  Gemm g{};
  g.m = a->k, g.n = a->k, g.k = a->n, g.batch = a->batch;
  g.splits = a->splits;
  g.sam = 1, g.sak = a->k;             // A[i][p] = x[b][p][i]
  g.sbk = a->k, g.sbn = 1;             // B[p][j] = g[b][p][j]
  g.bsa = g.bsb = (long long)a->n * a->k;
  g.ldc = a->k, g.bsc = kk;            // partial (b, s) at (b * splits + s)
  g.a = a->x, g.b = a->g, g.c = a->part;
  const int s = gemm(g, false, stream);
  if (s) return s;
  return split_sum(a->part, a->splits, kk, a->batch, a->dt, stream);
}
