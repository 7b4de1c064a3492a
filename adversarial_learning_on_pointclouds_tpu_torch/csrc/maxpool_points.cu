// maxpool_points: the symmetric max over the point axis, [B, N, C] ->
// [B, C], with the first point that attains each maximum, and its
// backward, which sends each (cloud, channel)'s cotangent to that point.
//
// Replaces the TPU kernels
// adversarial_learning_on_pointclouds_tpu/ops/kernels/maxpool_points.py::
// _fwd_call (pallas_call at maxpool_points.py:76: the max, carried across
// the sequential grid of point tiles) and _mp_bwd (maxpool_points.py:103:
// the first-occurrence scatter, with a "seen" flag carried across tiles).
//
// What bounds it here: one compare per input value, so device-memory
// traffic: at [32, 2500, 1024] the forward reads 328 MB, the backward
// writes as much (0.098 ms each at 3.35 TB/s).
//
// What the design does about that. Forward: a block owns 32 channels of
// one cloud and all its points; a warp reads 32 consecutive channels of a
// point (128 bytes) and its 8 warps take every 8th point, so each value
// is read once, coalesced. A lane keeps its running max and the first
// point reaching it (a strict >), and the 8 lanes of a channel merge in
// order, a tie going to the lower point: the winner is the first point
// attaining the max, whatever the layout, as the TPU kernel's "seen" flag
// makes it. The winner index is kept for the backward, so the backward
// neither reads x nor compares again: each thread writes consecutive
// elements of dx, g where the point is the winner and 0 elsewhere, one
// coalesced store of dx and nothing else.

#include "common.cuh"

namespace pointtpu {

// Mirror of the Python side's ctypes structure (ops/launch.py).
struct MaxpoolArgs {
  int batch, n, c;
  const float* x;      // [batch, n, c] (forward)
  const float* g;      // [batch, c] cotangent of y (backward)
  const int* win;      // [batch, c] winners (backward input)
  float* y;            // [batch, c] (forward)
  int* idx;            // [batch, c] winners (forward output)
  float* dx;           // [batch, n, c] (backward)
};

namespace {

__global__ void __launch_bounds__(kThreads)
maxpool_fwd_kernel(const MaxpoolArgs a) {
  __shared__ float val[kWarps][32];
  __shared__ int at[kWarps][32];
  const int cl = threadIdx.x & 31, rl = threadIdx.x >> 5;
  const int ch = blockIdx.x * 32 + cl, b = blockIdx.y;
  float best = -INFINITY;
  int bi = -1;
  if (ch < a.c && rl < a.n) {
    const float* xb = a.x + (size_t)b * a.n * a.c + ch;
    best = __ldg(xb + (size_t)rl * a.c);
    bi = rl;
    for (int p = rl + kWarps; p < a.n; p += kWarps) {
      const float v = __ldg(xb + (size_t)p * a.c);
      if (v > best) {
        best = v;
        bi = p;
      }
    }
  }
  val[rl][cl] = best;
  at[rl][cl] = bi;
  __syncthreads();
  if (rl == 0 && ch < a.c) {
    for (int w = 1; w < kWarps; ++w) {
      const int i = at[w][cl];
      if (i >= 0 && (val[w][cl] > best || (val[w][cl] == best && i < bi))) {
        best = val[w][cl];
        bi = i;
      }
    }
    a.y[(size_t)b * a.c + ch] = best;
    a.idx[(size_t)b * a.c + ch] = bi;
  }
}

__global__ void __launch_bounds__(kThreads)
maxpool_bwd_kernel(const MaxpoolArgs a) {
  const int per_cloud = a.n * a.c, b = blockIdx.y;
  const float* g = a.g + (size_t)b * a.c;
  const int* win = a.win + (size_t)b * a.c;
  float* dx = a.dx + (size_t)b * per_cloud;
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < per_cloud;
       r += gridDim.x * kThreads) {
    const int p = r / a.c, ch = r - p * a.c;
    dx[r] = __ldg(win + ch) == p ? __ldg(g + ch) : 0.f;
  }
}

bool bad(const MaxpoolArgs* a) {
  return a->batch <= 0 || a->batch > 65535 || a->n <= 0 || a->c <= 0;
}

}  // namespace
}  // namespace pointtpu

// y[b][c] = max over points of x[b][:, c]; idx the first point attaining it.
extern "C" int pt_maxpool_fwd(const pointtpu::MaxpoolArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->x || !a->y || !a->idx) return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a->c + 31) / 32, a->batch);
  maxpool_fwd_kernel<<<grid, kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}

// dx[b][p][c] = g[b][c] where p == win[b][c], else 0.
extern "C" int pt_maxpool_bwd(const pointtpu::MaxpoolArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->g || !a->win || !a->dx) return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  // A cloud's [n, c] is indexed in 32 bits (with room for the loop's
  // step); the clouds share some 16 blocks per SM, each looping over its
  // part of its cloud.
  if ((long long)a->n * a->c > 0x3fffffffLL) return kErrArgs;
  const int per_cloud = a->n * a->c;
  const int want = (16 * device_attr(cudaDevAttrMultiProcessorCount) +
                    a->batch - 1) / a->batch;
  const int need = (per_cloud + kThreads - 1) / kThreads;
  const dim3 grid(need < want ? need : want, a->batch);
  maxpool_bwd_kernel<<<grid, kThreads, 0, stream>>>(*a);
  return (int)cudaGetLastError();
}
