// The generator's two widest backward passes on the tensor cores (defined
// in train_bwd_tc.cu): the trunk's B1 (trunk_train.cu: pt_trunk_b1) and
// the seg head's Bmid (seg_head_train.cu: pt_head_bmid). Each takes the
// BwdArgs of train_gemm.cuh, with the dzs and hs scratch buffers, and
// returns 0, a cudaError_t, kErrArgs for a shape or layout it does not
// take, or kErrSmem.

#pragma once

#include <cuda_runtime.h>

namespace pointtpu {

struct BwdArgs;

// Trunk B1: dy2, dW3, db3 and BN2's t1 / t2 (mode kDzTrunk; c_in 128,
// c_out a multiple of 64; groups >= 1).
int trunk_b1_tc(const BwdArgs& a, cudaStream_t stream);

// Seg-head Bmid: dy_prev, dW, db and the previous BN's t1 / t2 (mode
// kDzBn; c_out 32, 64, 128 or 256, c_in 64 or a multiple of 128; one
// group).
int head_bmid_tc(const BwdArgs& a, cudaStream_t stream);

}  // namespace pointtpu
