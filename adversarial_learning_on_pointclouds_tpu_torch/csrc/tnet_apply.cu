// tnet_apply: the T-Net transform y[b] = x[b] @ T[b] of every cloud, and
// its backward dx[b] = g[b] @ T[b]^T, dT[b] = x[b]^T g[b].
//
// Replaces the TPU kernels
// adversarial_learning_on_pointclouds_tpu/ops/kernels/tnet_apply.py::
// _apply_call (pallas_call at tnet_apply.py:32: the forward, and dx on
// the transposed T) and _dt_kernel (tnet_apply.py:74: dT accumulated over
// the point tiles of each cloud).
//
// What bounds it here: k is 3 (the input transform) or 64 (the feature
// transform), so each point does k FMAs per output value against 8 bytes
// moved: 0.75 or 16 FMAs per byte, far under the card's balance point.
// Device-memory traffic bounds all three products.
//
// What the design does about that: each product is one batched strided
// GEMM (strided_gemm.cuh), a block per 64 points by 64 columns of one
// cloud with that cloud's T streamed through shared memory; x, g, y and
// dx are each read or written once, and T^T and x^T are strided views of
// the same storage, never copies. dT sums over all points of a cloud: the
// points split into ranges, each range's partial [k, k] goes to scratch
// and the ranges of each cloud are added in fp64 in a fixed order. All
// three products are fp32, under mixed precision too, as the JAX kernels
// pin HIGHEST precision.

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
