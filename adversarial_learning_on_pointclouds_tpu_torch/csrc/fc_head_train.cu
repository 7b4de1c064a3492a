// fc_head_train: the T-Net fc head in training, fc1 + batch-BN + ReLU ->
// fc2 + batch-BN + ReLU -> fc3 on the pooled [B, 1024] rows, and the
// backward of its two BN layers.
//
// Replaces the TPU kernels
// adversarial_learning_on_pointclouds_tpu/ops/kernels/fc_head_train.py::
// _fwd_call (pallas_call at fc_head_train.py:112: the whole forward in
// one program, grid ()) and _bwd_call (fc_head_train.py:192: both BN
// layers' backward in one program). fc3's backward (dW3, db3 and the
// cotangent of h2) runs outside, as in the JAX VJP.
//
// What bounds it here: latency. At batch 32 the head is 32 x (1024 x 512
// + 512 x 256 + 256 x k^2) MACs, 0.02-0.55 GFLOP, and its weights 2.5-6.5
// MB; each layer is a few microseconds of work, and a BN couples every
// row of a column, so what counts is how many SMs share each weight
// stream, a short serial chain, and no round trip between a product, its
// batch statistics and the normalization.
//
// What the design does about that: every layer is small_fc.cuh's split-K
// tensor-core product across a thread-block cluster (fc_cluster: 16
// output columns a cluster of 8 CTAs, each CTA one slice of k, the
// partials added through distributed shared memory in rank order), its
// epilogue in the CTA that owns the columns. Forward, three launches:
// fc1 and fc2 with the batch-BN forward (moments about the running mean,
// the stashes z1, z2, the statistics, h1 and h2 for the next layer), fc3
// with its bias (at k = 64, 256 column groups: two CTAs a cluster).
// Backward, three launches: (1) dW2 = dz2^T h1 as 64 x 64 output tiles,
// each tile building its dz2 columns by BN2's backward from dh2 (the
// first column of tiles stores dz2, db2, dg2, dbe2) and its h1 columns
// from the z1 stash; (2) dh1 = dz2 W2 split-K, BN1's backward in the
// owner CTAs (dz1, db1, dg1, dbe1); (3) dh = dz1 W1 split-K, and in the
// same launch's tail dW1 = dz1^T h as output tiles.
//
// Rounding follows the JAX kernels line by line, with no fused
// multiply-add where they round twice: the forward normalizes as (z - mu)
// * (inv * gamma) + beta, the backward recomputes zhat = (z - mu) * inv
// and relu(zhat * gamma + beta) (both as written at fc_head_train.py:98
// and :160). Under mixed precision (prec & kRound) the three forward
// products and dW1/dW2 take bf16 operands (_mxu_dot, _mxu_dot_t); the
// cotangents of h1 and h stay fp32 as 3xTF32 (_mxu_dot_nt runs at
// HIGHEST).

#include "small_fc.cuh"

namespace pointtpu {

// Mirror of the Python side's ctypes structure (ops/launch.py). Weights
// are PyTorch's [out, in] row-major storage.
struct FcHeadArgs {
  int batch, c0, c1, c2, c3, prec;  // prec: kRound or 0
  const float* h;                   // [batch, c0]
  const float* w1;                  // [c1, c0]
  const float* b1;
  const float* g1;
  const float* be1;
  const float* rm1;                 // running means the moments centre on
  const float* w2;                  // [c2, c1]
  const float* b2;
  const float* g2;
  const float* be2;
  const float* rm2;
  const float* w3;                  // [c3, c2]
  const float* b3;
  float* out;                       // [batch, c3]
  float* z1;                        // [batch, c1] stash
  float* z2;                        // [batch, c2] stash
  float* mu1;                       // [c1] batch mean, biased variance,
  float* var1;                      //   1 / sqrt(var + eps)
  float* inv1;
  float* mu2;                       // [c2]
  float* var2;
  float* inv2;
  float* h1;                        // [batch, c1] forward scratch
  float* h2;                        // [batch, c2] forward scratch
  const float* dh2;                 // [batch, c2] cotangent of h2 (backward)
  float* dh;                        // [batch, c0]
  float* dw1;                       // [c1, c0]
  float* db1;
  float* dg1;
  float* dbe1;
  float* dw2;                       // [c2, c1]
  float* db2;
  float* dg2;
  float* dbe2;
  float* dz1;                       // [batch, c1] backward scratch
  float* dz2;                       // [batch, c2] backward scratch
};

namespace {

bool bad(const FcHeadArgs* a) {
  return a->batch <= 0 || a->batch > kFcMaxRows || a->c0 <= 0 ||
         a->c1 <= 0 || a->c2 <= 0 || a->c3 <= 0 || !a->h || !a->w1 ||
         !a->w2 || !a->g1 || !a->be1 || !a->g2 || !a->be2 || !a->z1 ||
         !a->z2 || !a->mu1 || !a->inv1 || !a->mu2 || !a->inv2;
}

// A layer of the head on the split-K product: rows, k, cols, x, and
// W(col, kk) = w[col * wso + kk * wsk].
FcLayer layer(int rows, int k, int cols, const float* x, const float* w,
              long long wso, long long wsk) {
  FcLayer L = {};
  L.rows = rows;
  L.k = k;
  L.cols = cols;
  L.groups = 1;
  fc_split(L);
  L.pro = kProLoad;
  L.x = x;
  L.w = w;
  L.wso = wso;
  L.wsk = wsk;
  return L;
}

// fc1 / fc2: the product, bias, and the BN forward ((z - mu) * (inv * g)
// + be).
FcLayer bn_layer(const FcHeadArgs* a, int k, int cols, const float* x,
                 const float* w, const float* b, const float* rm,
                 const float* g, const float* be, float* z, float* h,
                 float* mu, float* var, float* inv) {
  FcLayer L = layer(a->batch, k, cols, x, w, k, 1);
  L.epi = kEpiBnFwd;
  L.fold = 1;
  L.bias = b;
  L.rm = rm;
  L.g = g;
  L.be = be;
  L.z = z;
  L.h = h;
  L.mu = mu;
  L.var = var;
  L.inv = inv;
  return L;
}

// dW = dz^T x as tiles: [m, n] over the batch's rows.
DwTile dw_tiles(const FcHeadArgs* a, int m, int n, float* dw) {
  DwTile D = {};
  D.mtiles = ceil_div(m, kDwTile);
  D.tiles = D.mtiles * ceil_div(n, kDwTile);
  D.rows = a->batch;
  D.m = m;
  D.n = n;
  D.bf = a->prec & kRound;
  D.dw = dw;
  return D;
}

}  // namespace
}  // namespace pointtpu

// The forward (FcHeadArgs' first block of outputs): three launches.
extern "C" int pt_fc_head_fwd(const pointtpu::FcHeadArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->b1 || !a->rm1 || !a->b2 || !a->rm2 || !a->w3 || !a->b3 ||
      !a->out || !a->var1 || !a->var2 || !a->h1 || !a->h2)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const bool bf = a->prec & kRound;
  const FcLayer f1 = bn_layer(a, a->c0, a->c1, a->h, a->w1, a->b1, a->rm1,
                              a->g1, a->be1, a->z1, a->h1, a->mu1, a->var1,
                              a->inv1);
  const FcLayer f2 = bn_layer(a, a->c1, a->c2, a->h1, a->w2, a->b2, a->rm2,
                              a->g2, a->be2, a->z2, a->h2, a->mu2, a->var2,
                              a->inv2);
  FcLayer f3 = layer(a->batch, a->c2, a->c3, a->h2, a->w3, a->c2, 1);
  f3.epi = kEpiAffine;
  f3.bias = a->b3;
  f3.z = a->out;
  int s;
  if ((s = run_fc(f1, DwTile{}, bf, stream))) return s;
  if ((s = run_fc(f2, DwTile{}, bf, stream))) return s;
  return run_fc(f3, DwTile{}, bf, stream);
}

// The backward of both BN layers from dh2 (FcHeadArgs' second block):
// three launches.
extern "C" int pt_fc_head_bwd(const pointtpu::FcHeadArgs* a, int device,
                              cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->dh2 || !a->dh || !a->dw1 || !a->db1 || !a->dg1 ||
      !a->dbe1 || !a->dw2 || !a->db2 || !a->dg2 || !a->dbe2 || !a->dz1 ||
      !a->dz2)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  // (1) dW2 = dz2^T h1, dz2 by BN2's backward, h1 recomputed.
  DwTile d2 = dw_tiles(a, a->c2, a->c1, a->dw2);
  d2.dh = a->dh2;
  d2.z = a->z2;
  d2.mu = a->mu2;
  d2.inv = a->inv2;
  d2.g = a->g2;
  d2.be = a->be2;
  d2.dz = a->dz2;
  d2.db = a->db2;
  d2.dg = a->dg2;
  d2.dbe = a->dbe2;
  d2.pz = a->z1;
  d2.pmu = a->mu1;
  d2.pinv = a->inv1;
  d2.pg = a->g1;
  d2.pbe = a->be1;
  // (2) dh1 = dz2 W2 (W2 [c2, c1]: W(i, o) = w2[o * c1 + i]), BN1's
  // backward in the owner CTAs.
  FcLayer b1 = layer(a->batch, a->c2, a->c1, a->dz2, a->w2, 1, a->c1);
  b1.epi = kEpiBnBwd;
  b1.zs = a->z1;
  b1.smu = a->mu1;
  b1.sinv = a->inv1;
  b1.g = a->g1;
  b1.be = a->be1;
  b1.dz = a->dz1;
  b1.dg = a->dg1;
  b1.dbe = a->dbe1;
  b1.db = a->db1;
  // (3) dh = dz1 W1, and dW1 = dz1^T h in the tail.
  FcLayer dh = layer(a->batch, a->c1, a->c0, a->dz1, a->w1, 1, a->c0);
  dh.epi = kEpiAffine;
  dh.z = a->dh;
  DwTile d1 = dw_tiles(a, a->c1, a->c0, a->dw1);
  d1.a = a->dz1;
  d1.b = a->h;
  int s;
  if ((s = run_fc(FcLayer{}, d2, false, stream))) return s;
  if ((s = run_fc(b1, DwTile{}, false, stream))) return s;
  return run_fc(dh, d1, false, stream);
}
