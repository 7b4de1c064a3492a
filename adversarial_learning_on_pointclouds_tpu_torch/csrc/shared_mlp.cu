// fused_linear_affine_act: y = act((x @ W^T) * scale + shift) over points.
//
// Replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/shared_mlp.py::
// fused_linear_affine_act (its pallas_call at shared_mlp.py:227).
//
// What bounds it here: on the serving path it runs conv1 only (3 -> 64
// channels), 12 bytes in, 256 bytes out and 192 FMAs per point, so it is
// bound by device-memory traffic, the output store above all.
//
// What the design does about that: a block owns 64 points, one thread
// per output element, with consecutive threads on consecutive channels
// of one point, so every warp stores whole 128-byte lines; the point's
// inputs are a warp-wide broadcast and the small weight stays in L1.
// Each thread steps its (point, channel) pair by a constant, so the loop
// has no integer division. Product, scale, shift and activation stay in
// registers, so [M, cout] is written once (the plain version writes it
// once per elementwise op). The ragged tail is a bound on the block's
// point count: any point count works.
//
// W is PyTorch's [cout, cin] row-major layout (Conv1d weight, squeezed).

#include "common.cuh"

namespace pointtpu {

constexpr int kPointsPerBlock = 64;

__global__ void __launch_bounds__(kThreads)
linear_affine_act_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ shift,
                         const float* __restrict__ scale,
                         float* __restrict__ out, long long m, int cin,
                         int cout, int act) {
  const long long p0 = (long long)blockIdx.x * kPointsPerBlock;
  const int points = (int)min((long long)kPointsPerBlock, m - p0);
  const float* xb = x + p0 * cin;
  float* ob = out + p0 * cout;
  // Element e = p * cout + o; thread t starts at e = t and steps by
  // kThreads = dp * cout + dout.
  int p = threadIdx.x / cout, o = threadIdx.x - p * cout;
  const int dp = kThreads / cout, dout = kThreads - dp * cout;
  for (int e = threadIdx.x; e < points * cout; e += kThreads) {
    const float* xp = xb + p * cin;
    const float* wo = w + (size_t)o * cin;
    float acc = 0.f;
    for (int k = 0; k < cin; ++k) acc = fmaf(__ldg(xp + k), __ldg(wo + k), acc);
    ob[e] = apply_act(acc * __ldg(scale + o) + __ldg(shift + o), act);
    p += dp;
    o += dout;
    if (o >= cout) {
      o -= cout;
      ++p;
    }
  }
}

}  // namespace pointtpu

// x [m, cin], w [cout, cin], shift/scale [cout] -> out [m, cout].
extern "C" int pt_linear_affine_act(const float* x, const float* w,
                                    const float* shift, const float* scale,
                                    float* out, long long m, int cin,
                                    int cout, int act, int device,
                                    cudaStream_t stream) {
  using namespace pointtpu;
  if (m <= 0 || cin <= 0 || cout <= 0 || act < 0 || act > kActLeaky)
    return kErrArgs;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (m + kPointsPerBlock - 1) / kPointsPerBlock;
  if (blocks > 0x7fffffffLL) return kErrArgs;
  linear_affine_act_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, w, shift, scale, out, m, cin, cout, act);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int status) {
  if (status == pointtpu::kErrArgs) return "arguments the kernel does not take";
  if (status == pointtpu::kErrSmem)
    return "working set exceeds the shared memory of one block";
  return cudaGetErrorString((cudaError_t)status);
}
