// The fused training trunk's three passes: conv2 + BN2 + ReLU -> conv3 +
// BN3 -> max over points, forward and backward.
//
// Replaces the TPU kernels of
// adversarial_learning_on_pointclouds_tpu/ops/kernels/trunk_train.py::
// trunk2_train: F1 (_f1_call, pallas_call at trunk_train.py:121), F2
// (_f2_call, :212) and B1 (_b1_call, :309).
//
// Bound: matmul work. At batch 32 x 2048 points the 128 -> 1024 layer is
// 8.6 GFMA, computed once in F2 and three times in B1 (the recomputed
// z3, dz3 @ W3 and dz3^T h2), all on the tensor cores, against 33.5 MB of
// z2 stash read per pass. F1 (64 -> 128, 0.5 GFMA) is bound by its bytes:
// x in (16.8 MB), z2 out (16.8 MB in bf16, 33.5 in fp32).
// Design: every pass runs on the tensor cores (train_bwd_tc.cu), 128
// points of one cloud a block. z3 [B, N, 1024] never reaches device
// memory in the forward, as on the TPU. F1 keeps the tile of x and all of
// W2 in shared memory (two blocks an SM, for the bytes in flight), takes
// z2 = x W2^T on mma_step (exact fp32 FMAs at c_in <= 4, trunk3_train's
// raw points), stages z2 in shared memory for its column partial sums
// and stores it in 16-byte vectors. F2 and B1 share a prologue and first
// GEMM per tile: h2 = relu(bn2(z2)) in shared memory, z3 = h2 W3^T chunk
// by chunk. F2 reduces z3 in registers to the BN3 partial sums and each
// cloud's max and min with the first point attaining them (packed 64-bit
// atomics, so the winner does not depend on the order of the blocks). B1
// rebuilds dz3 chunk by chunk in shared memory and accumulates dy2 =
// mask * dz3 @ W3; dW3 = dz3^T h2 on the GEMM core from the dz3 and h2
// the row pass writes out. All row reductions add per-block partials in
// fp64.
// groups > 1 (trunk2_train(groups=2), the paired trunks): the batch is
// stacked streams, every BN2/BN3 statistic and BN term is [groups, C] and
// read by the tile's cloud, and each stream's sums add its own blocks
// in the order a call on that stream alone adds them, so the pooled
// values are bit-identical to per-stream calls. Mixed precision (prec):
// bf16 operands, the z2 stash in bf16 (F1 stores it, F2 and B1 read it);
// the statistics come from the unrounded z2 and z3, dy2 stays fp32.

#include "train_bwd_tc.cuh"
#include "train_gemm.cuh"

using pointtpu::BwdArgs;
using pointtpu::RowFwdArgs;

// z2 = x @ W2^T + b2 [batch * n, c2] and its column sum / sum of squares.
extern "C" int pt_trunk_f1(const RowFwdArgs* a, int device,
                           cudaStream_t stream) {
  using namespace pointtpu;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  return trunk_f1_tc(*a, stream);
}

// z3 = relu(z2 * sc2 + sh2) @ W3^T + b3, not stored: its column sum / sum
// of squares and per-cloud max / min with their first points.
extern "C" int pt_trunk_f2(const RowFwdArgs* a, int device,
                           cudaStream_t stream) {
  using namespace pointtpu;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  return trunk_f2_tc(*a, stream);
}

// Backward through conv3 + BN3 + pool: dy2, dW3, db3 and BN2's t1 / t2.
extern "C" int pt_trunk_b1(const BwdArgs* a, int device,
                           cudaStream_t stream) {
  using namespace pointtpu;
  if (a->mode != kDzTrunk || !a->scp || !a->mup || a->r) return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  return trunk_b1_tc(*a, stream);
}
