// The generator's passes on the tensor cores (defined in train_bwd_tc.cu):
// the trunk's F1, F2 and B1 (trunk_train.cu: pt_trunk_f1, pt_trunk_f2,
// pt_trunk_b1) and all six of the seg head's (seg_head_train.cu:
// pt_head_p1, pt_head_pmid, pt_head_p4, pt_head_b4, pt_head_bmid,
// pt_head_b1). The forward passes take the RowFwdArgs of train_gemm.cuh,
// the backward passes its BwdArgs (trunk B1, Bmid and head B1 with the
// dzs and, for the first two, hs scratch buffers; B4 with neither); each
// returns 0, a cudaError_t, kErrArgs for a shape or layout it does not
// take, or kErrSmem.

#pragma once

#include <cuda_runtime.h>

namespace pointtpu {

struct BwdArgs;
struct RowFwdArgs;

// Trunk F1: z2 = x W2^T + b2 (a bf16 stash under kZBf16) and its column
// sum and sum of squares per group (x fp32; c_in a multiple of 16 up to
// 64, x and W 16-byte aligned, c_out 64 or 128; or c_in <= 4 and c_out a
// multiple of 64; groups >= 1).
int trunk_f1_tc(const RowFwdArgs& a, cudaStream_t stream);

// Trunk F2: BN3's column sum and sum of squares per group and each
// cloud's max / min with the first point attaining them (c_in 128, c_out
// a multiple of 64; groups >= 1).
int trunk_f2_tc(const RowFwdArgs& a, cudaStream_t stream);

// Trunk B1: dy2, dW3, db3 and BN2's t1 / t2 (mode kDzTrunk; c_in 128,
// c_out a multiple of 64; groups >= 1).
int trunk_b1_tc(const BwdArgs& a, cudaStream_t stream);

// Seg-head P1: z1 = pf W1a^T + g_row[cloud] + b1 (a bf16 stash under
// kZBf16) and its column sum and sum of squares (pf fp32, c_in a multiple
// of 16 up to 64, c_out a multiple of 64, pf and W 16-byte aligned; one
// group).
int head_p1_tc(const RowFwdArgs& a, cudaStream_t stream);

// Seg-head Pmid: z = relu(x * sc + sh) W^T + b (a bf16 stash under
// kZBf16) and its column sum and sum of squares (c_in and c_out multiples
// of 8, x and W 16-byte aligned; one group).
int head_pmid_tc(const RowFwdArgs& a, cudaStream_t stream);

// Seg-head P4: logp = log_softmax(relu(z3 * sc3 + sh3) W4^T + b4) per
// point, fp32 (c_in 128, c_out at most 56, z3 and W 16-byte aligned; one
// group).
int head_p4_tc(const RowFwdArgs& a, cudaStream_t stream);

// Seg-head B4: dy3 (a bf16 stash under kDypBf16), dW4, db4 and BN3's t1
// / t2 from the softmax backward (mode kDzSoftmax; c_in 128, c_out at
// most 56; one group; part_w holds a dW4 partial per block, at most
// splits blocks).
int head_b4_tc(const BwdArgs& a, cudaStream_t stream);

// Seg-head Bmid: dy_prev, dW, db and the previous BN's t1 / t2 (mode
// kDzBn; c_out 32, 64, 128 or 256, c_in 64 or a multiple of 128; one
// group).
int head_bmid_tc(const BwdArgs& a, cudaStream_t stream);

// Seg-head B1: dpf = dz W (fp32), dW = dz^T pf, db and each cloud's sums
// r of dz (mode kDzBn; c_in at most 64, c_out a multiple of 64, pf fp32;
// no previous BN; one group).
int head_b1_tc(const BwdArgs& a, cudaStream_t stream);

}  // namespace pointtpu
