// fused_mlp_stack: h <- act_i((h @ W_i^T) * scale_i + shift_i) over a chain
// of pointwise layers, forward only (inference: the discriminator's
// FCDiscriminator.infer).
//
// Replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/shared_mlp.py::
// fused_mlp_stack (its pallas_call at shared_mlp.py:296, kernel
// _stack_kernel).
//
// Bound: FMAs. The discriminator's chain (k = 50 -> 64 -> 128 -> 256 ->
// 512 -> 1) costs 175,744 multiply-adds a row for 200 bytes read and 4
// written, about 860 FMAs per byte, far above the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s, 20 operations per byte).
// Design (train_gemm.cuh's row GEMM): a block of 256 threads owns a tile
// of 64 rows and keeps that tile's activations in shared memory from
// layer to layer, in two buffers that alternate (layer i reads buffer
// i & 1 and writes the other), so only x is read from device memory and
// only the last layer's output is written. Every weight streams from L2
// through gemm_acc's register-staged double buffer, 256 output columns a
// pass, so no weight has to fit a block (the discriminator's are 0.7 MB).
// The epilogue applies scale, shift and activation in registers, the
// product and the sum rounded apart as the plain version's two
// elementwise ops round them, and stores the result as the next layer's
// operand, or to device memory after the last layer. The rows of the
// ragged tail are zero in x and never stored. Working set: 64 rows of the
// widest input of each parity plus the staging buffers (the
// discriminator's: 64 x (512 + 256) floats + 33 KB, 224 KB); a chain
// that needs more shared memory than a block has is refused.
// Mixed precision (prec & kRound): x, every activation and every weight
// rounded to bf16 as a matmul operand, sums and epilogue in fp32, as the
// JAX package's _mxu_dot under its mixed-precision scope.

#include "train_gemm.cuh"

namespace pointtpu {

constexpr int kMaxStack = 8;    // layers a chain may have

// Mirror of the Python side's ctypes structure (ops/launch.py, StackArgs),
// field for field.
struct StackArgs {
  int rows, layers, prec;          // rows of x, chain length, kRound or 0
  int width[kMaxStack + 1];        // width[0] = x's, width[i + 1] = layer i's
  int act[kMaxStack];              // Act per layer
  const float* x;                  // [rows, width[0]]
  const float* w[kMaxStack];       // [width[i + 1], width[i]] row-major
  const float* scale[kMaxStack];   // [width[i + 1]]
  const float* shift[kMaxStack];   // [width[i + 1]]
  float* out;                      // [rows, width[layers]]
};

namespace {

// Floats of the two activation buffers: buffer p holds the input of the
// layers i with i & 1 == p (the last layer's output goes to device
// memory).
struct StackSmem {
  size_t buf[2], total;
  explicit StackSmem(const StackArgs& a) : buf{0, 0} {
    for (int i = 0; i < a.layers; ++i) {
      const size_t need = (size_t)kTile * a.width[i];
      if (need > buf[i & 1]) buf[i & 1] = need;
    }
    total = buf[0] + buf[1] + 2 * (size_t)kStage;
  }
};

template <bool BF>
__global__ void __launch_bounds__(kThreads, 1)
stack_kernel(const StackArgs a, int odd_at, int stage_at) {
  extern __shared__ float smem[];
  float* stage = smem + stage_at;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t g0 = (size_t)blockIdx.x * kTile;
  const int rows = (int)min((long long)kTile, (long long)a.rows - (long long)g0);

  load_tile(smem, a.width[0], a.x, false, g0, rows, a.width[0], 0,
            a.width[0], nullptr, nullptr, BF);
  for (int l = 0; l < a.layers; ++l) {
    const float* in_s = smem + (l & 1) * odd_at;        // buffer l & 1
    float* out_s = smem + ((l + 1) & 1) * odd_at;
    const int c_in = a.width[l], c_out = a.width[l + 1], act = a.act[l];
    const bool last = l + 1 == a.layers;
    const float* __restrict__ scale = a.scale[l];
    const float* __restrict__ shift = a.shift[l];
    const int cp = pad32(c_out);
    for (int n0 = 0; n0 < cp; n0 += kMaxCols) {
      with_nj_pow2(min(kMaxCols, cp - n0), [&](auto nj) {
        constexpr int NJ = decltype(nj)::value;
        float acc[kRows][NJ] = {};
        // Ends with a barrier: every read of in_s and stage is done, and
        // the epilogue's writes into out_s meet no reader of it.
        gemm_acc<NJ, true>(acc, in_s, c_in, c_in, a.w[l], c_in, n0,
                           c_out - n0, stage, BF);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int o = n0 + lane + 32 * jj;
          if (o >= c_out) continue;
          const float sc = __ldg(scale + o), sh = __ldg(shift + o);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int r = warp + i * kWarps;
            const float v =
                apply_act(__fadd_rn(__fmul_rn(acc[i][jj], sc), sh), act);
            if (!last)
              out_s[r * c_out + o] = operand(v, BF);
            else if (r < rows)
              a.out[(g0 + r) * c_out + o] = v;
          }
        }
      });
    }
  }
}

bool stack_args_ok(const StackArgs& a) {
  if (a.rows <= 0 || a.layers < 1 || a.layers > kMaxStack || !a.x ||
      !a.out || (a.prec & ~kRound))
    return false;
  for (int i = 0; i <= a.layers; ++i)
    if (a.width[i] <= 0) return false;
  for (int i = 0; i < a.layers; ++i)
    if (!a.w[i] || !a.scale[i] || !a.shift[i] || a.act[i] < kActNone ||
        a.act[i] > kActLeaky)
      return false;
  return true;
}

}  // namespace
}  // namespace pointtpu

using pointtpu::StackArgs;

// out = the chain on x, one block per 64 rows.
extern "C" int pt_mlp_stack(const StackArgs* a, int device,
                            cudaStream_t stream) {
  using namespace pointtpu;
  if (!stack_args_ok(*a)) return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const StackSmem sm(*a);
  const size_t bytes = sm.total * sizeof(float);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  const int odd_at = (int)sm.buf[0], stage_at = (int)(sm.buf[0] + sm.buf[1]);
  const int blocks = ceil_div(a->rows, kTile);
  if (a->prec & kRound) {
    if ((e = allow_smem(stack_kernel<true>, bytes))) return (int)e;
    stack_kernel<true><<<blocks, kThreads, bytes, stream>>>(*a, odd_at,
                                                            stage_at);
  } else {
    if ((e = allow_smem(stack_kernel<false>, bytes))) return (int)e;
    stack_kernel<false><<<blocks, kThreads, bytes, stream>>>(*a, odd_at,
                                                             stage_at);
  }
  return (int)cudaGetLastError();
}
