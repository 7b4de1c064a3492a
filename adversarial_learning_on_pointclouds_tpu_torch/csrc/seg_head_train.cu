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
// Where each pass runs:
// * Pmid (512 -> 256, 256 -> 128; trunk3_train's 64 -> 128), Bmid (256
//   -> 512, 128 -> 256) and B1 (512 -> 64; trunk3_train's 64 -> 3), the
//   widest, on the tensor cores (train_bwd_tc.cu): Pmid streams the stash
//   and W through a cp.async ring, applies the previous BN + ReLU once per
//   landed chunk and reduces the statistics in its epilogue; the backward
//   passes build dz from the stashes into shared memory (B1 by 64-channel
//   chunks), take dz @ W on mma.sync and write dz for dW = dz^T h on the
//   GEMM core (B1's h is pf itself).
// * P1, P4 and B4 on the CUDA cores (fp32 FMAs over 64-point tiles; P1
//   and P4 on train_gemm.cuh's row GEMM, B4 here): P1 takes the global
//   half of layer 1 as a per-cloud addend, so the 1088-wide concat never
//   exists; P4 takes the log_softmax across the lanes of the warp that
//   owns the row. B4's row kernel builds each tile's dz, the softmax
//   backward through a recomputed z4 (make_dz), multiplies it by W4 and
//   masks by BN3's ReLU; its weight-gradient kernel keeps a [64, 128]
//   slice of dW4 in registers over a range of at most 2048 rows,
//   rebuilding dz and h3 tile by tile exactly as the row kernel does.
// B4 and Bmid mask by the previous ReLU, store dy_prev and reduce the
// previous BN's sums, one pass behind as on the TPU. All row
// reductions add per-block partials in fp64. Mixed precision (prec): bf16
// operands and bf16 stashes z1, z2, z3 (P1, Pmid), dy3 (B4) and dy_prev
// (Bmid); each statistic and BN sum is taken from the unrounded values in
// the pass that makes them, and dpf stays fp32.

#include "train_bwd_tc.cuh"
#include "train_gemm.cuh"

namespace pointtpu {
namespace {

constexpr int kGradO = 64;                // B4's dW rows (output channels) a block

// ---------------------------------------------------------------------------
// dz of one tile (B4's softmax backward), for the backward row kernel and
// the dW kernel
// ---------------------------------------------------------------------------

// dz_s[r][c] = dz[b, p0 + r][oc + c] for c < OC (0 past rows or c_out),
// unrounded: the tile's rows are points p0.. of cloud b, and z is
// recomputed from the previous activation h_s [kTile][c_in]. Ends with a
// barrier.
template <int OC, bool BF>
__device__ __forceinline__ void make_dz(const BwdArgs& a, int oc, int b,
                                        int p0, int rows, const float* h_s,
                                        float* dz_s, float* stage) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t g0 = (size_t)b * a.n + p0;
  constexpr int NJ = OC / 32;
  float acc[kRows][NJ] = {};
  gemm_acc<NJ, true>(acc, h_s, a.c_in, a.c_in, a.w, a.ldw, oc, a.c_out - oc,
                     stage, BF);
  // dz = dlp - softmax(z) * sum(dlp), per row.
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + i * kWarps;
    float z[NJ], dl[NJ];
    bool ok[NJ];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int o = oc + lane + 32 * jj;
      ok[jj] = r < rows && o < a.c_out;
      z[jj] = ok[jj] ? acc[i][jj] + __ldg(a.bias + o) : -INFINITY;
      dl[jj] = ok[jj] ? __ldg(a.dlp + (g0 + r) * a.c_out + o) : 0.f;
    }
    if (r < rows) {  // warp-uniform
      float m = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) m = fmaxf(m, z[jj]);
      m = warp_max(m);
      float s = 0.f, sdl = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        z[jj] = ok[jj] ? expf(z[jj] - m) : 0.f;
        s += z[jj];
        sdl += dl[jj];
      }
      s = warp_sum(s);
      sdl = warp_sum(sdl);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) z[jj] = dl[jj] - (z[jj] / s) * sdl;
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      dz_s[r * OC + lane + 32 * jj] = ok[jj] ? z[jj] : 0.f;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Backward row kernel: dy_prev = mask * (dz @ W), the previous BN's sums,
// and the per-block column sums of dz (for db)
// ---------------------------------------------------------------------------

template <int OC, bool BF>
__global__ void __launch_bounds__(kThreads, 1)
row_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* h_s = smem;                                       // [kTile][c_in]
  float* dz_s = h_s + kTile * a.c_in;                      // [kTile][OC]
  float* stage = dz_s + kTile * OC;
  float* red = stage + 2 * kStage;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, p0 = blockIdx.x * kTile;
  const int rows = min(kTile, a.n - p0);
  const size_t g0 = (size_t)b * a.n + p0;
  const int blk = b * gridDim.x + blockIdx.x;
  float* prow = a.part + (size_t)blk * (2 * a.c_in + a.c_out);
  constexpr bool bf = BF;
  const bool zpbf = BF && (a.prec & kZpBf16);
  const bool dypbf = BF && (a.prec & kDypBf16);
  const float* scp = a.scp;
  const float* shp = a.shp;
  const float* mup = a.mup;
  const float* invp = a.invp;

  load_tile(h_s, a.c_in, a.zp, zpbf, g0, rows, a.c_in, 0, a.c_in, scp, shp,
            bf);
  const int cp = pad32(a.c_in);
  for (int kc = 0; kc < cp; kc += kMaxCols) {
    with_nj_pow2(min(kMaxCols, cp - kc), [&](auto nj) {
      constexpr int NJ = decltype(nj)::value;
      float acc[kRows][NJ] = {};
      for (int oc = 0; oc < a.c_out; oc += OC) {
        make_dz<OC, BF>(a, oc, b, p0, rows, h_s, dz_s, stage);
        if (kc == 0)
          for (int c = threadIdx.x; c < OC && oc + c < a.c_out; c += kThreads) {
            float s = 0.f;
            for (int r = 0; r < rows; ++r) s += dz_s[r * OC + c];
            prow[2 * a.c_in + oc + c] = s;
          }
        if (bf) {  // db took the unrounded dz; the product takes bf16
          __syncthreads();
          round_smem(dz_s, kTile * OC);
          __syncthreads();
        }
        gemm_acc<NJ, false>(acc, dz_s, OC, min(OC, a.c_out - oc),
                            a.w + (size_t)oc * a.ldw, a.ldw, kc, a.c_in - kc,
                            stage, bf);
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int k = kc + lane + 32 * jj;
        float s1 = 0.f, s2 = 0.f;
        if (k < a.c_in) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int r = warp + i * kWarps;
            if (r >= rows) continue;
            const size_t at = (g0 + r) * a.c_in + k;
            const float zp = load_val(a.zp, zpbf, at);
            float d = acc[i][jj];
            if (!(bn_affine(zp, __ldg(scp + k), __ldg(shp + k)) > 0.f))
              d = 0.f;
            store_val(a.dyp, dypbf, at, d);
            s1 += d;
            s2 += d * ((zp - __ldg(mup + k)) * __ldg(invp + k));
          }
        }
        red[warp * kMaxCols + lane + 32 * jj] = s1;
        red[(kWarps + warp) * kMaxCols + lane + 32 * jj] = s2;
      }
      __syncthreads();
      for (int c = threadIdx.x; c < NJ * 32; c += kThreads) {
        const int k = kc + c;
        if (k >= a.c_in) continue;
        float s1 = 0.f, s2 = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          s1 += red[w * kMaxCols + c];
          s2 += red[(kWarps + w) * kMaxCols + c];
        }
        prow[k] = s1;
        prow[a.c_in + k] = s2;
      }
      __syncthreads();
    });
  }
}

// ---------------------------------------------------------------------------
// Weight-gradient kernel: part_w[split][o][k] = sum over the split's tiles
// (64 points of one cloud, as the row kernels tile) of dz[row][o] *
// h[row][k]
// ---------------------------------------------------------------------------

// A block owns kGradO output channels by KJ * 32 input channels.
template <int KJ, bool BF>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  float* h_s = smem;                                       // [kTile][c_in]
  float* dz_s = h_s + kTile * a.c_in;                      // [kTile][kGradO]
  float* stage = dz_s + kTile * kGradO;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int oc = blockIdx.x * kGradO, kc = blockIdx.y * KJ * 32;
  const int tpc = ceil_div(a.n, kTile);                    // tiles per cloud
  const int tiles = tpc * a.batch;
  const int per = ceil_div(tiles, a.splits);
  const int t0 = blockIdx.z * per, t1 = min(tiles, t0 + per);
  constexpr bool bf = BF;
  const bool zpbf = BF && (a.prec & kZpBf16);

  float acc[kRows][KJ] = {};
  for (int t = t0; t < t1; ++t) {
    const int b = t / tpc, p0 = (t - b * tpc) * kTile;
    const int rows = min(kTile, a.n - p0);
    const size_t g0 = (size_t)b * a.n + p0;
    __syncthreads();  // the previous tile's h_s and dz_s are read
    load_tile(h_s, a.c_in, a.zp, zpbf, g0, rows, a.c_in, 0, a.c_in, a.scp,
              a.shp, bf);
    make_dz<kGradO, BF>(a, oc, b, p0, rows, h_s, dz_s, stage);
    if (bf) {
      round_smem(dz_s, kTile * kGradO);
      __syncthreads();
    }
    for (int r = 0; r < rows; ++r) {
      float av[kRows], bv[KJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) av[i] = dz_s[r * kGradO + warp * kRows + i];
#pragma unroll
      for (int jj = 0; jj < KJ; ++jj) {
        const int j = lane + 32 * jj;
        bv[jj] = kc + j < a.c_in ? h_s[r * a.c_in + kc + j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < KJ; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
  }
  float* out = a.part_w + (size_t)blockIdx.z * a.c_out * a.c_in;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int o = oc + warp * kRows + i;
    if (o >= a.c_out) continue;
#pragma unroll
    for (int jj = 0; jj < KJ; ++jj) {
      const int k = kc + lane + 32 * jj;
      if (k < a.c_in) out[(size_t)o * a.c_in + k] = acc[i][jj];
    }
  }
}

template <int KJ>
int launch_wgrad(const BwdArgs& a, cudaStream_t stream) {
  const size_t bytes =
      ((size_t)kTile * a.c_in + kTile * kGradO + 2 * kStage) * sizeof(float);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  const dim3 grid(ceil_div(a.c_out, kGradO), ceil_div(a.c_in, KJ * 32),
                  a.splits);
  int e;
  if (a.prec & kRound) {
    if ((e = (int)allow_smem(wgrad_kernel<KJ, true>, bytes))) return e;
    wgrad_kernel<KJ, true><<<grid, kThreads, bytes, stream>>>(a);
  } else {
    if ((e = (int)allow_smem(wgrad_kernel<KJ, false>, bytes))) return e;
    wgrad_kernel<KJ, false><<<grid, kThreads, bytes, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int OC>
int launch_row_bwd(const BwdArgs& a, cudaStream_t stream) {
  const size_t bytes = ((size_t)kTile * a.c_in + kTile * OC + 2 * kStage +
                        2 * kWarps * kMaxCols) * sizeof(float);
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  const dim3 grid(ceil_div(a.n, kTile), a.batch);
  int e;
  if (a.prec & kRound) {
    if ((e = (int)allow_smem(row_bwd_kernel<OC, true>, bytes))) return e;
    row_bwd_kernel<OC, true><<<grid, kThreads, bytes, stream>>>(a);
  } else {
    if ((e = (int)allow_smem(row_bwd_kernel<OC, false>, bytes))) return e;
    row_bwd_kernel<OC, false><<<grid, kThreads, bytes, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The seg head's B4 (mode kDzSoftmax, one group, c_out at most kGradO):
// the row kernel (dy_prev, the BN sums, db), the weight-gradient kernel
// (128 input channels a block, KJ = 4), and the fp64 sums of their
// partials.
int backward_pass(const BwdArgs& a, cudaStream_t stream) {
  if (a.mode != kDzSoftmax || a.batch <= 0 || a.batch > 65535 || a.n <= 0 ||
      a.c_in <= 0 || a.c_in > 128 || a.c_out <= 0 || a.c_out > kGradO ||
      a.groups != 1 || a.ldw < a.c_in || a.splits <= 0 ||
      a.splits > 65535 || !a.zp || !a.scp || !a.shp || !a.mup || !a.invp ||
      !a.w || !a.bias || !a.dlp || !a.dyp || !a.t1 || !a.t2 || !a.db ||
      !a.dw || !a.part || !a.part_w || a.r)
    return kErrArgs;
  int e = launch_row_bwd<kGradO>(a, stream);
  if (e) return e;
  if ((e = launch_wgrad<4>(a, stream))) return e;
  const int blocks = ceil_div(a.n, kTile) * a.batch;
  const long long ldp = 2LL * a.c_in + a.c_out;
  if ((e = colsum(a.part, ldp, blocks, a.c_in, 1, a.t1, a.c_in, stream)))
    return e;
  if ((e = colsum(a.part + a.c_in, ldp, blocks, a.c_in, 1, a.t2, a.c_in,
                  stream)))
    return e;
  if ((e = colsum(a.part + 2 * a.c_in, ldp, blocks, a.c_out, 1, a.db, 0,
                  stream)))
    return e;
  const long long wsz = (long long)a.c_out * a.c_in;
  if (wsz > 0x7fffffffLL) return kErrArgs;
  return colsum(a.part_w, wsz, a.splits, (int)wsz, 1, a.dw, 0, stream);
}

}  // namespace
}  // namespace pointtpu

using pointtpu::BwdArgs;
using pointtpu::RowFwdArgs;

namespace {

// The head runs per stream: one group.
int forward(const RowFwdArgs* a, int device, cudaStream_t stream) {
  using namespace pointtpu;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : row_fwd<false>(*a, stream);
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
  using namespace pointtpu;
  if (!a->z || !a->sum || !a->sc || !a->sh || a->addend || a->mx || a->logp)
    return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : head_pmid_tc(*a, stream);
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
  using namespace pointtpu;
  if (a->mode != kDzSoftmax || !a->scp || !a->mup || a->r) return kErrArgs;
  cudaError_t e = use_device(device);
  return e != cudaSuccess ? (int)e : backward_pass(*a, stream);
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
