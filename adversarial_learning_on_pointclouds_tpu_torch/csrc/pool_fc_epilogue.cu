// The trunk-exit epilogue: pooled feature -> ReLU -> fc1 -> batch-BN ->
// ReLU (train).
//
// Replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/pool_fc_epilogue.py::
// _make_fwd_kernel (pallas_call at pool_fc_epilogue.py:86), which serves
// pool_fc_epilogue and relu_fc_bn_relu.
//
// Bound: latency. At batch 32 the [32, 1024] x [1024, 512] product is 34
// MFLOP and the weight 2 MB; the pass is a few us of work. The TPU ran it
// as one grid=() program with everything in VMEM; the nearest thing here
// is a thread-block cluster.
// Design: one launch of small_fc.cuh's split-K product (fc_cluster):
// clusters of 8 CTAs own 16 of fc1's columns each (32 clusters), CTA q
// takes the q-th 128-deep slice of the pooled feature: it copies only
// that slice of sel (mx or mn by the sign of s3c) and of W1 into shared
// memory by cp.async and builds h = relu(sel * s3c + t3) there in place
// (__fmul_rn / __fadd_rn: no fused multiply-add, as PyTorch's two ops
// round); the partials are added through distributed shared memory in
// rank order, and each CTA runs the batch statistics (per group of batch
// / groups rows, centred on the running mean), the normalize ((z - mu) *
// inv) * g + be and the ReLU for its two columns. The first cluster
// stores h for the backward.
// With s3c null the fold is the identity (relu_fc_bn_relu): h = relu(mx),
// and mn and t3 are not read. Under prec & kRound the product takes h and
// W1 as bf16 operands (h is stored unrounded).

#include "small_fc.cuh"

namespace pointtpu {

// Mirror of the Python side's ctypes structure (ops/launch.py), field for
// field, as the other training passes take theirs (train_gemm.cuh).
struct PoolFcArgs {
  int batch, c3, c1, groups, prec;  // prec: kRound or 0
  const float* mx;       // [batch, c3] per-cloud max of z3
  const float* mn;       // [batch, c3] per-cloud min of z3 (null: identity)
  const float* s3c;      // [c3] BN3 fold: h = relu(sel * s3c + t3); null:
  const float* t3;       //   the identity fold, h = relu(mx)
  const float* w1;       // [c1, c3] row-major (PyTorch's [out, in])
  const float* b1;       // [c1]
  const float* g1;       // [c1] BN1 affine
  const float* be1;
  const float* rm1;      // [c1] running mean the moments centre on
  float* h1;             // [batch, c1] relu(bn(z1))
  float* h;              // [batch, c3] pooled feature, for the backward
  float* z1;             // [batch, c1]
  float* mu;             // [groups, c1] per block of batch / groups rows
  float* var;
  float* inv;
};

}  // namespace pointtpu

// The forward pass (PoolFcArgs above): statistics per block of batch /
// groups rows. One cluster launch.
extern "C" int pt_pool_fc_fwd(const pointtpu::PoolFcArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (a->batch <= 0 || a->c3 <= 0 || a->c1 <= 0 || a->groups <= 0 ||
      a->batch % a->groups || !a->mx || !a->w1 || !a->b1 || !a->g1 ||
      !a->be1 || !a->rm1 || !a->h1 || !a->h || !a->z1 || !a->mu ||
      !a->var || !a->inv || !a->s3c != !a->t3 || (a->s3c && !a->mn))
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  FcLayer L = {};
  L.rows = a->batch;
  L.k = a->c3;
  L.cols = a->c1;
  L.groups = a->groups;
  fc_split(L);
  L.pro = kProPool;
  L.epi = kEpiBnFwd;
  L.fold = 0;
  L.mx = a->mx;
  L.mn = a->mn;
  L.s3c = a->s3c;
  L.t3 = a->t3;
  L.xout = a->h;
  L.w = a->w1;
  L.wso = a->c3;
  L.wsk = 1;
  L.bias = a->b1;
  L.z = a->z1;
  L.rm = a->rm1;
  L.g = a->g1;
  L.be = a->be1;
  L.h = a->h1;
  L.mu = a->mu;
  L.var = a->var;
  L.inv = a->inv;
  return run_fc(L, DwTile{}, a->prec & kRound, stream);
}
