// The fused training seg head's six passes: [point | global] -> 512 ->
// 256 -> 128 -> k with batch-statistic BNs and a per-point log_softmax,
// forward and backward.
//
// Replaces the TPU kernels of
// adversarial_learning_on_pointclouds_tpu/ops/kernels/seg_head_train.py::
// seg_head_train: P1 (_p1_call, pallas_call at seg_head_train.py:75),
// Pmid (_pmid_call, :118), P4 (_p4_call, :155), B4 (_b4_call, :206),
// Bmid (_bmid_call, :275) and B1 (_b1_call, :335).
//
// Bound: matmuls, about 1.8e5 FMAs per point forward (64x512 + 512x256 +
// 256x128 + 128x50) and twice that backward, at batch 32 x 2048 points;
// then the stashes: each pass reads and writes [B, N, C] tensors of up to
// 134 MB (z1), a few us each at 3.35 TB/s.
//
// All six run on the tensor cores (train_bwd_tc.cu):
// * P1 (the point half of layer 1, 64 -> 512) on trunk F1's tile: the
//   global half enters as a per-cloud addend g_row = g W1b, so the
//   1088-wide concat never exists; a block takes 128 points and a slice
//   of 128 output columns, the four slices of a tile neighbours on the
//   card. pf is fp32 in both precisions (it is head B1's dW operand too,
//   and both kernels refuse a bf16 pf).
// * Pmid (512 -> 256, 256 -> 128; trunk3_train's 64 -> 128) streams the
//   stash and W through a cp.async ring, applies the previous BN + ReLU
//   once per landed chunk and reduces the statistics in its epilogue.
// * P4 and B4 share their first half (z4_softmax): z4 = h3 W4^T + b4
//   with a warp per 16 whole rows and the row's max and sum of exp in
//   quad shuffles. P4 stores logp = z4 - lse; B4 takes the softmax
//   backward in registers, dy3 = dz W4 and dW4 = dz^T h3 on the tile in
//   shared memory (a partial per block).
// * Bmid (256 -> 512, 128 -> 256) and B1 (512 -> 64; trunk3_train's
//   64 -> 3) build dz from the stashes into shared memory (B1 by
//   64-channel chunks), take dz @ W on mma.sync and write dz for dW =
//   dz^T h on the GEMM core (B1's h is pf itself).
// B4 and Bmid mask by the previous ReLU, store dy_prev and reduce the
// previous BN's sums, one pass behind as on the TPU. All row
// reductions add per-block partials in fp64. Mixed precision (prec): bf16
// operands and bf16 stashes z1, z2, z3 (P1, Pmid), dy3 (B4) and dy_prev
// (Bmid); each statistic and BN sum is taken from the unrounded values in
// the pass that makes them, and dpf stays fp32.

#include "train_bwd_tc.cuh"
#include "train_gemm.cuh"

using pointtpu::BwdArgs;
using pointtpu::RowFwdArgs;

// z1 = pf @ W1a^T + g_row[cloud] + b1 and its column sums.
extern "C" int pt_head_p1(const RowFwdArgs* a, int device,
                          cudaStream_t stream) {
  using namespace pointtpu;
  if (!a->z || !a->sum || a->sc || !a->addend || a->mx || a->logp)
    return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : head_p1_tc(*a, stream);
}

// z = relu(z_prev * sc + sh) @ W^T + b and its column sums.
extern "C" int pt_head_pmid(const RowFwdArgs* a, int device,
                            cudaStream_t stream) {
  using namespace pointtpu;
  if (!a->z || !a->sum || !a->sc || !a->sh || a->addend || a->mx || a->logp)
    return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : head_pmid_tc(*a, stream);
}

// logp = log_softmax(relu(z3 * sc3 + sh3) @ W4^T + b4) per point.
extern "C" int pt_head_p4(const RowFwdArgs* a, int device,
                          cudaStream_t stream) {
  using namespace pointtpu;
  if (a->z || a->sum || !a->sc || !a->sh || a->addend || a->mx || !a->logp)
    return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : head_p4_tc(*a, stream);
}

// Softmax + conv4 backward: dy3, dW4, db4 and BN3's t1 / t2.
extern "C" int pt_head_b4(const BwdArgs* a, int device, cudaStream_t stream) {
  using namespace pointtpu;
  if (a->mode != kDzSoftmax || !a->scp || !a->mup || a->r) return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : head_b4_tc(*a, stream);
}

// A BN backward and the matmul backward to the previous layer.
extern "C" int pt_head_bmid(const BwdArgs* a, int device,
                            cudaStream_t stream) {
  using namespace pointtpu;
  if (a->mode != kDzBn || !a->scp || !a->mup || a->r) return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : head_bmid_tc(*a, stream);
}

// BN1 backward and the point half of layer 1: dpf, dW1a, db1 and the
// per-cloud sums r of dz1.
extern "C" int pt_head_b1(const BwdArgs* a, int device, cudaStream_t stream) {
  using namespace pointtpu;
  if (a->mode != kDzBn || a->scp || a->mup || !a->r) return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : head_b1_tc(*a, stream);
}
