// The T-Net's fc layers on the tensor cores: a split-K product of a few
// rows across a thread-block cluster, with its epilogue (bias, a batch-BN
// forward or backward) in the CTA that owns the columns, and the weight
// gradients dW = dz^T h as output tiles. pool_fc_epilogue.cu and
// fc_head_train.cu build their passes on it.
//
// What bounds these layers on the H100: latency. At batch 32 fc1 (1024 ->
// 512) is a 34-MFLOP product whose weight is 2 MB; each layer is a few
// microseconds of work, and a BN couples every row of a column. What
// counts is how many SMs share the weight stream and how short the
// serial chain of each is.
//
// The product, fc_cluster. Z[rows, cols] = X[rows, k] W^T (+ b), rows <=
// 256. A cluster of cs CTAs (kFcCluster, the portable size, unless the
// layer has columns enough for every SM: fc_split) owns kFcCols output
// columns; CTA q of the cluster takes the q-th slice of k, kc deep
// (at most kFcSlice), copies its slice of W and of X into shared memory
// with cp.async (pool-fc: the selected extrema, then h in place), and
// computes
// its partial [rows x kFcCols] on mma.sync through mma.cuh (fp32 as
// 3xTF32, bf16 operands under BF), a warp per 16 x 8 tile over the whole
// slice. After cluster.sync() CTA q adds, for its kFcCols / cs columns,
// the cluster's partials through distributed shared memory
// (map_shared_rank) in rank order 0, 1, ..., cs - 1, with no atomics:
// the sums do not depend on the order the CTAs ran in. A second
// cluster.sync() keeps every CTA's partials alive until all have read
// them. The owner then holds every row of its columns and runs the
// epilogue: the bias; or the batch-BN forward per group of rows / groups
// contiguous rows (moments centred on the running mean, var = max(m2 -
// mu_c^2, 0), or a second pass where that cancels: bn_fwd_column; inv =
// rsqrt(var + eps), the normalize, ReLU, the stores of z, h, mu, var,
// inv); or the BN backward of h = relu(bn(zs)) with the product as the
// cotangent of h (dz, db, dgamma, dbeta); a warp per column and group,
// lanes over rows, sums by a fixed shuffle tree.
//
// The weight gradient, dw_tile. dW[m, n] = sum over rows of A[r, m] B[r,
// n], depth = rows: a 64 x 64 output tile a CTA, A and B columns over
// every row in shared memory, 8 warps of 32 x 16 on mma.sync. A and B are
// copied (dz and the layer's input), or built: A as the BN backward of its
// columns from the cotangent of h (the tiles of the first column group
// store dz, db, dgamma, dbeta), B as relu(bn(z)) recomputed from the
// stash. The tail of a cluster launch takes such tiles (the blocks past
// the product's), so a pass and the weight gradient of the layer before
// share one launch.
//
// Rounding follows the JAX kernels: no fused multiply-add where they
// round twice (__fmul_rn, __fadd_rn, __fsub_rn).

#pragma once

#include <cooperative_groups.h>

#include <mutex>

#include "mma.cuh"

namespace pointtpu {
namespace {  // each translation unit keeps its own copy

namespace cg = cooperative_groups;

constexpr int kFcCols = 16;      // output columns a cluster owns
constexpr int kFcCluster = 8;    // CTAs a cluster (the portable maximum)
constexpr int kFcSlice = 128;    // the deepest k slice a CTA takes
constexpr int kFcWide = 128;     // column groups from which a layer fills
                                 // the card without splitting k further
constexpr int kFcMaxRows = 256;
constexpr int kDwTile = 64;      // a weight-gradient tile, 64 x 64
constexpr int kDwLd = kDwTile + 8;
constexpr float kFcEps = 1e-5f;
constexpr float kFcOnePassLimit = 4096.f;   // core.ONE_PASS_LIMIT

enum FcPro { kProLoad = 0, kProPool = 1 };
enum FcEpi { kEpiAffine = 0, kEpiBnFwd = 1, kEpiBnBwd = 2 };

// One layer: Z = X W^T (+ bias) and its epilogue. W(col, kk) = w[col *
// wso + kk * wsk]: wsk == 1 (K-major, PyTorch's [out, in]) or wso == 1.
struct FcLayer {
  int rows, k, cols, groups;   // groups: kEpiBnFwd's row blocks
  int cs, kc;                  // CTAs a cluster, k slice depth (fc_split)
  int pro, epi;
  int fold;                    // kEpiBnFwd: (z - mu) * (inv * g) + be;
                               // else ((z - mu) * inv) * g + be
  const float* x;              // kProLoad: [rows, k]
  const float* mx;             // kProPool: x = relu(sel * s3c + t3), sel
  const float* mn;             //   = mx where s3c >= 0, else mn; with
  const float* s3c;            //   s3c null, x = relu(mx)
  const float* t3;
  float* xout;                 // kProPool: x [rows, k], stored by the
                               //   first cluster
  const float* w;
  long long wso, wsk;
  const float* bias;           // [cols] or null
  float* z;                    // [rows, cols]: Z (+ bias), or null
  const float* rm;             // kEpiBnFwd: running mean, [cols]
  const float* g;              // BN affine (both BN epilogues)
  const float* be;
  float* h;                    // kEpiBnFwd: relu(bn(z)) [rows, cols]
  float* mu;                   //   [groups, cols]
  float* var;
  float* inv;
  const float* zs;             // kEpiBnBwd: the stash [rows, cols], its
  const float* smu;            //   statistics; the product is the
  const float* sinv;           //   cotangent of h = relu(bn(zs))
  float* dz;                   //   [rows, cols]
  float* dg;
  float* dbe;
  float* db;
};

// dW [m, n] = sum over rows of A[r, m] B[r, n], tiles of kDwTile squared,
// tile t at (t % mtiles, t / mtiles). A, B both given, or both null:
// then built (A by the BN backward, B by relu(bn) of the stash).
struct DwTile {
  int tiles, mtiles, rows, m, n, bf;
  const float* a;              // [rows, m] (dz)
  const float* b;              // [rows, n] (the layer's input)
  float* dw;                   // [m, n] row-major
  const float* dh;             // built A: dz of h = relu(bn(z)) from dh,
  const float* z;              //   all [rows, m] or [m]; the tiles of
  const float* mu;             //   column group 0 store dz, db, dg, dbe
  const float* inv;
  const float* g;
  const float* be;
  float* dz;
  float* db;
  float* dg;
  float* dbe;
  const float* pz;             // built B: relu(((pz - pmu) * pinv) * pg +
  const float* pmu;            //   pbe), all [rows, n] or [n]
  const float* pinv;
  const float* pg;
  const float* pbe;
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// The sum over a warp's lanes, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// cp.async of an R x C block, element (i, j) = base[(i0 + i) * si + j0 +
// j], to dst[i * ld + j]; zero for i >= r_lim or j >= c_lim. vec: 16-byte
// copies (C, ld, si, j0 multiples of 4 and base 16-byte aligned).
__device__ __forceinline__ void copy_block(float* dst, int ld,
                                           const float* base, long long si,
                                           long long i0, long long j0, int R,
                                           int C, int r_lim, int c_lim,
                                           bool vec) {
  if (vec) {
    for (int c = threadIdx.x; c < R * (C / 4); c += kThreads) {
      const int i = c / (C / 4), j = (c % (C / 4)) * 4;
      const int bytes = i < r_lim ? 4 * max(0, min(4, c_lim - j)) : 0;
      cp16(dst + i * ld + j, bytes ? base + (i0 + i) * si + j0 + j : base,
           bytes);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += kThreads) {
      const int i = e / C, j = e % C;
      const bool ok = i < r_lim && j < c_lim;
      cp4(dst + i * ld + j, ok ? base + (i0 + i) * si + j0 + j : base,
          ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((unsigned long long)p & 15) == 0;
}

// relu(((z - mu) * inv) * g + be), as recompute_h rounds it.
__device__ __forceinline__ float bn_relu(float z, float mu, float inv,
                                         float g, float be) {
  return fmaxf(
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z, mu), inv), g), be), 0.f);
}

// ---------------------------------------------------------------------------
// The split-K product and its epilogue
// ---------------------------------------------------------------------------

// Floats of shared memory fc_cluster takes.
__host__ __device__ inline int fc_floats(const FcLayer& L, bool wk) {
  const int rp = round16(L.rows), ldx = L.kc + 4;
  return rp * ldx + (wk ? kFcCols * ldx : L.kc * (kFcCols + 8)) +
         kFcCols * (rp + 4) + 2 * L.kc;
}

// The BN forward of column c over the rows of group grp (zc[r]: row r's
// z, the bias added): one warp. The moments of d = z - rm in one pass,
// var = max(m2 - mu_c^2, 0), as the JAX kernels take them, unless m2
// reaches kFcOnePassLimit times the variance (at a few rows a column's
// variance can sit near eps with |mu_c| hundreds of times its spread,
// where one pass keeps about two digits); then the second pass's
// variance about the mean, mean((d - mu_c)^2). The branch is taken on
// the second pass's variance, which any order of sums gives to a few
// ulps (the one-pass form moves by m2 / var ulps: at the limit the
// kernel's shuffle tree and the twin's sums would pick different
// branches), and it is the warp's.
__device__ __forceinline__ void bn_fwd_column(const FcLayer& L,
                                              const float* zc, int c,
                                              int grp) {
  const int lane = threadIdx.x & 31;
  const int bg = L.rows / L.groups, r0 = grp * bg;
  const float rm = __ldg(L.rm + c);
  float s = 0.f, q = 0.f;
  for (int r = r0 + lane; r < r0 + bg; r += 32) {
    const float d = __fsub_rn(zc[r], rm);
    s += d;
    q += __fmul_rn(d, d);
  }
  s = warp_sum(s);
  q = warp_sum(q);
  const float mu_c = s / bg, m2 = q / bg;
  float q2 = 0.f;
  for (int r = r0 + lane; r < r0 + bg; r += 32) {
    const float d = __fsub_rn(__fsub_rn(zc[r], rm), mu_c);
    q2 += __fmul_rn(d, d);
  }
  const float var2 = warp_sum(q2) / bg;
  const float var =
      __fmul_rn(var2, kFcOnePassLimit) > m2
          ? fmaxf(__fsub_rn(m2, __fmul_rn(mu_c, mu_c)), 0.f)
          : var2;
  const float inv = rsqrtf(var + kFcEps);
  const float mu = mu_c + rm;
  if (lane == 0) {
    L.mu[(size_t)grp * L.cols + c] = mu;
    L.var[(size_t)grp * L.cols + c] = var;
    L.inv[(size_t)grp * L.cols + c] = inv;
  }
  const float g = __ldg(L.g + c), be = __ldg(L.be + c);
  const float t = __fmul_rn(inv, g);
  for (int r = r0 + lane; r < r0 + bg; r += 32) {
    const float z = zc[r];
    L.z[(size_t)r * L.cols + c] = z;
    L.h[(size_t)r * L.cols + c] =
        L.fold ? fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(z, mu), t), be), 0.f)
               : bn_relu(z, mu, inv, g, be);
  }
}

// The BN backward of column c, the cotangent of h = relu(bn(zs)) in
// dh[r]: dz = (g inv) ((dy - t1 / b) - zhat (t2 / b)), one warp.
__device__ __forceinline__ void bn_bwd_column(const FcLayer& L,
                                              const float* dh, int c) {
  const int lane = threadIdx.x & 31, rows = L.rows;
  const float mu = __ldg(L.smu + c), inv = __ldg(L.sinv + c);
  const float g = __ldg(L.g + c), be = __ldg(L.be + c);
  float t1 = 0.f, t2 = 0.f;
  for (int r = lane; r < rows; r += 32) {
    const float zh =
        __fmul_rn(__fsub_rn(__ldg(L.zs + (size_t)r * L.cols + c), mu), inv);
    const float hv = fmaxf(__fadd_rn(__fmul_rn(zh, g), be), 0.f);
    const float dy = hv > 0.f ? dh[r] : 0.f;
    t1 += dy;
    t2 += __fmul_rn(dy, zh);
  }
  t1 = warp_sum(t1);
  t2 = warp_sum(t2);
  const float gi = __fmul_rn(g, inv), a1 = t1 / rows, a2 = t2 / rows;
  float db = 0.f;
  for (int r = lane; r < rows; r += 32) {
    const float zh =
        __fmul_rn(__fsub_rn(__ldg(L.zs + (size_t)r * L.cols + c), mu), inv);
    const float hv = fmaxf(__fadd_rn(__fmul_rn(zh, g), be), 0.f);
    const float dy = hv > 0.f ? dh[r] : 0.f;
    const float dz =
        __fmul_rn(gi, __fsub_rn(__fsub_rn(dy, a1), __fmul_rn(zh, a2)));
    L.dz[(size_t)r * L.cols + c] = dz;
    db += dz;
  }
  db = warp_sum(db);
  if (lane == 0) {
    L.dg[c] = t2;
    L.dbe[c] = t1;
    L.db[c] = db;
  }
}

template <bool BF, bool WK>
__device__ __forceinline__ void fc_cluster(const FcLayer& L, float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = L.cs, kc = L.kc, rows = L.rows;
  const int rank = (int)cluster.block_rank();
  const int n0 = (int)(blockIdx.x / cs) * kFcCols, k0 = rank * kc;
  const int rp = round16(rows), ldx = kc + 4, pld = rp + 4;
  constexpr int kLdw = kFcCols + 8;  // N-major W stage row
  float* xs = smem;                  // [rp][ldx]
  float* ws = xs + rp * ldx;         // WK: [kFcCols][ldx], else [kc][kLdw]
  float* part = ws + (WK ? kFcCols * ldx : kc * kLdw);   // [kFcCols][pld]
  float* sv = part + kFcCols * pld;  // [kc] pool-fc: s3c's slice
  float* tv = sv + kc;               // [kc] t3's

  // The slices of W and X by cp.async (pool-fc: the selected extrema, made
  // into h in place below).
  if (WK)
    copy_block(ws, ldx, L.w, L.wso, n0, k0, kFcCols, kc, L.cols - n0,
               L.k - k0, L.k % 4 == 0 && L.wso % 4 == 0 && aligned16(L.w));
  else
    copy_block(ws, kLdw, L.w, L.wsk, k0, n0, kc, kFcCols, L.k - k0,
               L.cols - n0, L.cols % 4 == 0 && L.wsk % 4 == 0 &&
               aligned16(L.w));
  if (L.pro == kProLoad || !L.s3c) {
    const float* x = L.pro == kProLoad ? L.x : L.mx;
    copy_block(xs, ldx, x, L.k, 0, k0, rp, kc, rows, L.k - k0,
               L.k % 4 == 0 && aligned16(x));
  } else {
    // Pool-fc: each element's extremum (mx where its column's scale is
    // >= 0, else mn) by a 4-byte cp.async, all in flight at once.
    for (int kk = threadIdx.x; kk < kc; kk += kThreads) {
      const bool ok = k0 + kk < L.k;
      sv[kk] = ok ? __ldg(L.s3c + k0 + kk) : 0.f;
      tv[kk] = ok ? __ldg(L.t3 + k0 + kk) : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rp * kc; e += kThreads) {
      const int r = e / kc, kk = e - r * kc;
      const bool ok = r < rows && k0 + kk < L.k;
      const float* src = (sv[kk] >= 0.f ? L.mx : L.mn) + (size_t)r * L.k +
                         k0 + kk;
      cp4(xs + r * ldx + kk, ok ? src : L.mx, ok ? 4 : 0);
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  if (L.pro == kProPool) {
    // h = relu(sel * s3c + t3) in place, rounded as PyTorch's two ops
    // round it (no fused multiply-add), or relu(mx); the first cluster
    // stores it.
    const bool store = blockIdx.x < (unsigned)cs;
#pragma unroll 4
    for (int e = threadIdx.x; e < rp * kc; e += kThreads) {
      const int r = e / kc, kk = e - r * kc;
      if (r >= rows || k0 + kk >= L.k) continue;   // zero-filled
      const float x = xs[r * ldx + kk];
      const float v =
          L.s3c ? fmaxf(__fadd_rn(__fmul_rn(x, sv[kk]), tv[kk]), 0.f)
                : fmaxf(x, 0.f);
      xs[r * ldx + kk] = v;
      if (store) L.xout[(size_t)r * L.k + k0 + kk] = v;
    }
    __syncthreads();
  }

  // The partial product of the slice: a warp per 16 x 8 tile.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto fa = [&](int m, int kk) { return xs[m * ldx + kk]; };
  auto fb = [&](int n, int kk) {
    return WK ? ws[n * ldx + kk] : ws[kk * kLdw + n];
  };
  for (int j = warp; j < (rp / 16) * (kFcCols / 8); j += kWarps) {
    const int mb = (j / (kFcCols / 8)) * 16, nb = (j % (kFcCols / 8)) * 8;
    float acc[1][1][4] = {};
    for (int kk = 0; kk < kc; kk += mma_depth(BF))
      mma_step<1, 1, BF>(acc, fa, fb, mb, nb, kk, g, t);
    const int c = nb + 2 * t, r = mb + g;
    part[c * pld + r] = acc[0][0][0];
    part[(c + 1) * pld + r] = acc[0][0][1];
    part[c * pld + r + 8] = acc[0][0][2];
    part[(c + 1) * pld + r + 8] = acc[0][0][3];
  }
  cluster.sync();

  // The owned columns' sums over the cluster, in rank order; over xs,
  // which no warp reads any more.
  const int own = kFcCols / cs, c_lo = rank * own;
  float* zc = xs;   // [own][rp]
  for (int e = threadIdx.x; e < own * rp; e += kThreads) {
    const int cl = e / rp, r = e - cl * rp;
    const int at = (c_lo + cl) * pld + r;
    float s = cluster.map_shared_rank(part, 0)[at];
    for (int q = 1; q < cs; ++q) s += cluster.map_shared_rank(part, q)[at];
    zc[e] = s;
  }
  cluster.sync();   // every partial read: a CTA may now exit

  if (L.epi == kEpiAffine) {
    for (int e = threadIdx.x; e < own * rows; e += kThreads) {
      const int r = e / own, cl = e - r * own, c = n0 + c_lo + cl;
      if (c >= L.cols) continue;
      float v = zc[cl * rp + r];
      if (L.bias) v = __fadd_rn(v, __ldg(L.bias + c));
      L.z[(size_t)r * L.cols + c] = v;
    }
  } else if (L.epi == kEpiBnFwd) {
    for (int e = threadIdx.x; e < own * rp; e += kThreads) {
      const int cl = e / rp, c = n0 + c_lo + cl;
      if (c < L.cols) zc[e] = __fadd_rn(zc[e], __ldg(L.bias + c));
    }
    __syncthreads();
    for (int p = warp; p < own * L.groups; p += kWarps) {
      const int cl = p % own, c = n0 + c_lo + cl;
      if (c < L.cols) bn_fwd_column(L, zc + cl * rp, c, p / own);
    }
  } else {
    for (int cl = warp; cl < own; cl += kWarps) {
      const int c = n0 + c_lo + cl;
      if (c < L.cols) bn_bwd_column(L, zc + cl * rp, c);
    }
  }
}

// ---------------------------------------------------------------------------
// The weight gradient
// ---------------------------------------------------------------------------

__host__ __device__ inline int dw_floats(const DwTile& D) {
  return D.tiles ? 2 * round16(D.rows) * kDwLd + 2 * kDwTile : 0;
}

// A's columns o0.. as the BN backward builds them: dy into as, zhat into
// bs (scratch), the column sums t1, t2, then dz into as (zero past the
// rows); the tiles of column group 0 (store) write dz, db, dg, dbe.
__device__ __forceinline__ void dw_bn_prologue(const DwTile& D, int o0,
                                               bool store, float* as,
                                               float* bs, float* st, int rp) {
  const int rows = D.rows, m = D.m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 4
  for (int e = threadIdx.x; e < rp * kDwTile; e += kThreads) {
    const int r = e / kDwTile, c = e % kDwTile, o = o0 + c;
    float dy = 0.f, zh = 0.f;
    if (r < rows && o < m) {
      const size_t at = (size_t)r * m + o;
      const float g = __ldg(D.g + o), be = __ldg(D.be + o);
      zh = __fmul_rn(__fsub_rn(__ldg(D.z + at), __ldg(D.mu + o)),
                     __ldg(D.inv + o));
      const float hv = fmaxf(__fadd_rn(__fmul_rn(zh, g), be), 0.f);
      dy = hv > 0.f ? __ldg(D.dh + at) : 0.f;
    }
    as[r * kDwLd + c] = dy;
    bs[r * kDwLd + c] = zh;
  }
  __syncthreads();
  for (int c = warp; c < kDwTile; c += kWarps) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float dy = as[r * kDwLd + c];
      t1 += dy;
      t2 += __fmul_rn(dy, bs[r * kDwLd + c]);
    }
    t1 = warp_sum(t1);
    t2 = warp_sum(t2);
    if (lane == 0) {
      st[c] = t1;
      st[kDwTile + c] = t2;
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < rp * kDwTile; e += kThreads) {
    const int r = e / kDwTile, c = e % kDwTile, o = o0 + c;
    float dz = 0.f;
    if (r < rows && o < m) {
      const float gi = __fmul_rn(__ldg(D.g + o), __ldg(D.inv + o));
      const float a1 = st[c] / rows, a2 = st[kDwTile + c] / rows;
      dz = __fmul_rn(gi, __fsub_rn(__fsub_rn(as[r * kDwLd + c], a1),
                                   __fmul_rn(bs[r * kDwLd + c], a2)));
      if (store) D.dz[(size_t)r * m + o] = dz;
    }
    as[r * kDwLd + c] = dz;
  }
  __syncthreads();
  if (!store) return;
  for (int c = warp; c < kDwTile; c += kWarps) {
    float s = 0.f;
    for (int r = lane; r < rows; r += 32) s += as[r * kDwLd + c];
    s = warp_sum(s);
    if (lane == 0 && o0 + c < m) {
      D.db[o0 + c] = s;
      D.dg[o0 + c] = st[kDwTile + c];
      D.dbe[o0 + c] = st[c];
    }
  }
}

template <bool BF>
__device__ __forceinline__ void dw_tile(const DwTile& D, int tile,
                                        float* smem) {
  const int mt = tile % D.mtiles, nt = tile / D.mtiles;
  const int o0 = mt * kDwTile, i0 = nt * kDwTile;
  const int rows = D.rows, rp = round16(rows), n = D.n;
  float* as = smem;                // [rp][kDwLd]: A's columns o0..
  float* bs = as + rp * kDwLd;     // [rp][kDwLd]: B's columns i0..
  float* st = bs + rp * kDwLd;     // [2][kDwTile]
  if (D.a) {
    copy_block(as, kDwLd, D.a, D.m, 0, o0, rp, kDwTile, rows, D.m - o0,
               D.m % 4 == 0 && aligned16(D.a));
    copy_block(bs, kDwLd, D.b, n, 0, i0, rp, kDwTile, rows, n - i0,
               n % 4 == 0 && aligned16(D.b));
    cp_commit();
    cp_wait<0>();
  } else {
    dw_bn_prologue(D, o0, nt == 0, as, bs, st, rp);   // then bs is free
#pragma unroll 4
    for (int e = threadIdx.x; e < rp * kDwTile; e += kThreads) {
      const int r = e / kDwTile, c = e % kDwTile, i = i0 + c;
      bs[r * kDwLd + c] =
          r < rows && i < n
              ? bn_relu(__ldg(D.pz + (size_t)r * n + i), __ldg(D.pmu + i),
                        __ldg(D.pinv + i), __ldg(D.pg + i), __ldg(D.pbe + i))
              : 0.f;
    }
  }
  __syncthreads();

  // 8 warps of 32 x 16 over the 64 x 64 tile, k = the rows.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mb = (warp & 1) * 32, nb = (warp >> 1) * 16;
  auto fa = [&](int mm, int kk) { return as[kk * kDwLd + mm]; };
  auto fb = [&](int nn, int kk) { return bs[kk * kDwLd + nn]; };
  float acc[2][2][4] = {};
  for (int kk = 0; kk < rp; kk += mma_depth(BF))
    mma_step<2, 2, BF>(acc, fa, fb, mb, nb, kk, g, t);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + mb + 16 * i + g + 8 * h;
        const int c = i0 + nb + 8 * j + 2 * t;
        if (o >= D.m) continue;
        float* out = D.dw + (size_t)o * n + c;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (c + 1 < n && n % 2 == 0) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          if (c < n) out[0] = v0;
          if (c + 1 < n) out[1] = v1;
        }
      }
}

// A cluster launch of the split-K product (fc_ctas CTAs, clusters of
// L.cs) followed by D's weight-gradient tiles; L.rows == 0: tiles only.
template <bool BF, bool WK>
__global__ void __launch_bounds__(kThreads)
fc_tc_kernel(const FcLayer L, const DwTile D) {
  extern __shared__ __align__(16) float smem[];
  const int fc_ctas = L.rows ? ceil_div(L.cols, kFcCols) * L.cs : 0;
  if ((int)blockIdx.x < fc_ctas) {
    fc_cluster<BF, WK>(L, smem);
    return;
  }
  const int tile = blockIdx.x - fc_ctas;
  if (tile >= D.tiles) return;   // a cluster's padding
  if (D.bf)
    dw_tile<true>(D, tile, smem);
  else
    dw_tile<false>(D, tile, smem);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The cluster of a layer (ops/launch.py: fc_split mirrors it): kFcCluster
// CTAs, each a kc-deep slice of k, unless the layer has kFcWide column
// groups or more (fc3 at k = 64: 256): then the fewest CTAs whose slices
// are at most kFcSlice deep. kc is a multiple of 16 (bf16's k step).
inline void fc_split(FcLayer& L) {
  int cs = kFcCluster;
  if (ceil_div(L.cols, kFcCols) >= kFcWide) {
    cs = 1;
    while (cs < kFcCluster && ceil_div(L.k, cs) > kFcSlice) cs *= 2;
  }
  L.cs = cs;
  L.kc = round16(ceil_div(L.k, cs));
}

inline bool fc_ok(const FcLayer& L) {
  return L.rows > 0 && L.rows <= kFcMaxRows && L.k > 0 && L.cols > 0 &&
         L.kc <= kFcSlice && L.groups > 0 && L.rows % L.groups == 0;
}

// Refuses (kErrCluster) a cluster of cs CTAs of `bytes` shared memory that
// no GPC can hold, asked once per kernel, device, size and cluster.
inline int cluster_fits(const void* fn, const cudaLaunchConfig_t& cfg,
                        int cs, size_t bytes) {
  struct Seen {
    const void* fn;
    int device, cs;
    size_t bytes;
  };
  static std::mutex lock;
  static Seen seen[64];
  static int count = 0;
  int device = 0;
  cudaGetDevice(&device);
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < count; ++i)
    if (seen[i].fn == fn && seen[i].device == device && seen[i].cs == cs &&
        seen[i].bytes >= bytes)
      return 0;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return kErrCluster;
  if (count < 64) seen[count++] = {fn, device, cs, bytes};
  return 0;
}

template <bool BF, bool WK>
int launch_fc(const FcLayer& L, const DwTile& D, cudaStream_t stream) {
  const int cs = L.rows ? L.cs : 1;
  const int fc_ctas = L.rows ? ceil_div(L.cols, kFcCols) * cs : 0;
  const int grid = fc_ctas + ceil_div(D.tiles, cs) * cs;
  const size_t bytes =
      sizeof(float) * (size_t)max(L.rows ? fc_floats(L, WK) : 0,
                                  dw_floats(D));
  if (grid <= 0) return kErrArgs;
  if (bytes > (size_t)max_smem_optin()) return kErrSmem;
  auto kernel = fc_tc_kernel<BF, WK>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int fit = cluster_fits((const void*)kernel, cfg, cs, bytes);
  if (fit) return fit;
  e = cudaLaunchKernelEx(&cfg, kernel, L, D);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// A layer's launch in its precision, W K-major (wsk == 1) or N-major.
inline int run_fc(const FcLayer& L, const DwTile& D, bool bf,
                  cudaStream_t stream) {
  if (L.rows && !fc_ok(L)) return kErrArgs;
  const bool wk = !L.rows || L.wsk == 1;
  if (bf) return wk ? launch_fc<true, true>(L, D, stream)
                    : launch_fc<true, false>(L, D, stream);
  return wk ? launch_fc<false, true>(L, D, stream)
            : launch_fc<false, false>(L, D, stream);
}

}  // namespace
}  // namespace pointtpu
