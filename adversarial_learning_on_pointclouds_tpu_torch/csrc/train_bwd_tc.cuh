// The generator's passes on the tensor cores (defined in
// train_bwd_tc.cu): the trunk's F2 and B1 (trunk_train.cu: pt_trunk_f2,
// pt_trunk_b1) and the seg head's Bmid (seg_head_train.cu:
// pt_head_bmid). F2 takes the RowFwdArgs of train_gemm.cuh, the backward
// passes its BwdArgs with the dzs and hs scratch buffers; each returns 0,
// a cudaError_t, kErrArgs for a shape or layout it does not take, or
// kErrSmem.

#pragma once

#include <cuda_runtime.h>

namespace pointtpu {

struct BwdArgs;
struct RowFwdArgs;

// Trunk F2: BN3's column sum and sum of squares per group and each
// cloud's max / min with the first point attaining them (c_in 128, c_out
// a multiple of 64; groups >= 1).
int trunk_f2_tc(const RowFwdArgs& a, cudaStream_t stream);

// Trunk B1: dy2, dW3, db3 and BN2's t1 / t2 (mode kDzTrunk; c_in 128,
// c_out a multiple of 64; groups >= 1).
int trunk_b1_tc(const BwdArgs& a, cudaStream_t stream);

// Seg-head Bmid: dy_prev, dW, db and the previous BN's t1 / t2 (mode
// kDzBn; c_out 32, 64, 128 or 256, c_in 64 or a multiple of 128; one
// group).
int head_bmid_tc(const BwdArgs& a, cudaStream_t stream);

}  // namespace pointtpu
