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
// Bound: FMAs, about 1.8e5 per point forward (64x512 + 512x256 + 256x128
// + 128x50) and twice that backward, at batch 32 x 2048 points; then the
// stashes: each pass reads and writes [B, N, C] tensors of up to 134 MB
// (z1), a few us each at 3.35 TB/s against ms of FMAs.
// Design (train_gemm.cuh): each forward pass is a row GEMM over 64-point
// tiles that applies the previous BN + ReLU as it loads the stash, stores
// only the pre-BN z and reduces its column sums; the global half of
// layer 1 enters P1 as a per-cloud addend, so the 1088-wide concat never
// exists; P4 takes the log_softmax across the lanes of the warp that owns
// the row. Each backward pass rebuilds dz from the stashes (B4: the
// softmax backward through a recomputed z4), accumulates dz @ W in
// 128-channel chunks, masks by the previous ReLU, stores dy_prev and
// reduces the previous BN's sums, one pass behind as on the TPU; its
// weight-gradient kernel rebuilds dz and h tile by tile for dW = dz^T h.
// Bmid, the widest (256 -> 512, 128 -> 256), runs on the tensor cores
// instead (train_bwd_tc.cu: dz built into shared memory, dz @ W over n
// tiles, dW on the GEMM core from the dz and h the row pass writes out).
// All row reductions add per-block partials in fp64. Mixed precision
// (prec): bf16 operands and bf16 stashes z1, z2, z3 (P1, Pmid), dy3 (B4)
// and dy_prev (Bmid); each statistic and BN sum is taken from the
// unrounded values in the pass that makes them, and dpf stays fp32.

#include "train_bwd_tc.cuh"
#include "train_gemm.cuh"

using pointtpu::BwdArgs;
using pointtpu::RowFwdArgs;

namespace {

// The head runs per stream: one group.
int forward(const RowFwdArgs* a, int device, cudaStream_t stream) {
  using namespace pointtpu;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : row_fwd<false>(*a, stream);
}

template <int MODE>
int backward(const BwdArgs* a, int device, cudaStream_t stream) {
  using namespace pointtpu;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : backward_pass<MODE>(*a, stream);
}

}  // namespace

// z1 = pf @ W1a^T + g_row[cloud] + b1 and its column sums.
extern "C" int pt_head_p1(const RowFwdArgs* a, int device,
                          cudaStream_t stream) {
  if (!a->z || !a->sum || a->sc || !a->addend || a->mx || a->logp)
    return pointtpu::kErrArgs;
  return forward(a, device, stream);
}

// z = relu(z_prev * sc + sh) @ W^T + b and its column sums.
extern "C" int pt_head_pmid(const RowFwdArgs* a, int device,
                            cudaStream_t stream) {
  if (!a->z || !a->sum || !a->sc || !a->sh || a->addend || a->mx || a->logp)
    return pointtpu::kErrArgs;
  return forward(a, device, stream);
}

// logp = log_softmax(relu(z3 * sc3 + sh3) @ W4^T + b4) per point.
extern "C" int pt_head_p4(const RowFwdArgs* a, int device,
                          cudaStream_t stream) {
  if (a->z || a->sum || !a->sc || !a->sh || a->addend || a->mx || !a->logp)
    return pointtpu::kErrArgs;
  return forward(a, device, stream);
}

// Softmax + conv4 backward: dy3, dW4, db4 and BN3's t1 / t2.
extern "C" int pt_head_b4(const BwdArgs* a, int device, cudaStream_t stream) {
  if (a->mode != pointtpu::kDzSoftmax || !a->scp || !a->mup || a->r)
    return pointtpu::kErrArgs;
  return backward<pointtpu::kDzSoftmax>(a, device, stream);
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
  if (a->mode != pointtpu::kDzBn || a->scp || a->mup || !a->r)
    return pointtpu::kErrArgs;
  return backward<pointtpu::kDzBn>(a, device, stream);
}
