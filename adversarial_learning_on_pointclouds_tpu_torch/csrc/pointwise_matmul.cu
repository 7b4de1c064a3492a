// pointwise_matmul: the per-layer training matmul y = x @ W^T + b over
// points, and its backward dx = g @ W, dW = g^T x, db = sum g.
//
// Replaces the TPU kernels
// adversarial_learning_on_pointclouds_tpu/ops/kernels/shared_mlp.py::
// _mm_call (pallas_call at shared_mlp.py:123: the forward, and dx through
// the same kernel on W^T) and _dwdb_call (shared_mlp.py:160: dW and db
// accumulated over the grid).
//
// What bounds it on the H100: the layers on its path run 3 -> 64 up to
// 128 -> 1024 (the generator) and 50 -> 64 down to 512 -> 1 (the
// discriminator) over 65,536-240,000 rows. The wide ones are 20-60 GFLOP
// a product, past the 67 TFLOP/s of fp32 FMA; the narrow ones (c_in or
// c_out 1-64) are bound by device-memory traffic.
//
// What the design does about that: every product is one call of the
// GEMM core (strided_gemm.cu: tensor cores, a cp.async ring, 3xTF32 for
// fp32, streaming kernels for depth or width <= 4) on the tensors as
// they lie:
// the forward reads the weight as PyTorch's [out, in] rows, dx reads the
// same storage along its columns, and dW reads g and x along their rows
// (both views' contiguous axis is the one the core copies along), so
// nothing is copied. The bias is added in the GEMM's store. dW and db sum
// over all rows: the rows split into ranges, one per block of the grid's
// z axis, each range's fp32 partial written to scratch and the ranges
// added in fp64 in a fixed order, so the result does not depend on
// scheduling; db's partials come from the dW blocks of the first column
// tile, which sum the g tiles already in their shared memory, so g is
// read once. Under mixed precision (prec & kRound) the forward and dx
// take bf16-rounded operands, as the JAX package's _mxu_dot; dW and db
// never do (its _dwdb_call runs at HIGHEST precision on the fp32
// operands).

#include "strided_gemm.cuh"

namespace pointtpu {

// Mirror of the Python side's ctypes structure (ops/launch.py), field for
// field. Each entry point reads the fields it names.
struct PmArgs {
  int rows, c_in, c_out, splits, prec;  // prec: kRound or 0
  const float* x;      // [rows, c_in]
  const float* w;      // [c_out, c_in] row-major (PyTorch's [out, in])
  const float* bias;   // [c_out] (forward)
  const float* g;      // [rows, c_out] cotangent of y (dx, dW/db)
  float* y;            // [rows, c_out] (forward)
  float* dx;           // [rows, c_in]
  float* dw;           // [c_out, c_in]
  float* db;           // [c_out]
  float* part;         // scratch [splits, c_out * (c_in + 1)] (dW/db)
};

namespace {

bool bad(const PmArgs* a) {
  return a->rows <= 0 || a->c_in <= 0 || a->c_out <= 0;
}

}  // namespace
}  // namespace pointtpu

// y = x @ W^T + bias (prec: bf16 operands).
extern "C" int pt_pm_fwd(const pointtpu::PmArgs* a, int device,
                         cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->x || !a->w || !a->bias || !a->y) return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  Gemm g{};
  g.m = a->rows, g.n = a->c_out, g.k = a->c_in, g.batch = 1, g.splits = 1;
  g.sam = a->c_in, g.sak = 1;          // x, row-major
  g.sbk = 1, g.sbn = a->c_in;          // B[k][o] = W[o][k]
  g.ldc = a->c_out;
  g.a = a->x, g.b = a->w, g.bias = a->bias, g.c = a->y;
  return gemm(g, a->prec & kRound, stream);
}

// dx = g @ W (prec: bf16 operands).
extern "C" int pt_pm_dx(const pointtpu::PmArgs* a, int device,
                        cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->g || !a->w || !a->dx) return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  Gemm g{};
  g.m = a->rows, g.n = a->c_in, g.k = a->c_out, g.batch = 1, g.splits = 1;
  g.sam = a->c_out, g.sak = 1;         // g, row-major
  g.sbk = a->c_in, g.sbn = 1;          // B[o][i] = W[o][i]
  g.ldc = a->c_in;
  g.a = a->g, g.b = a->w, g.c = a->dx;
  return gemm(g, a->prec & kRound, stream);
}

// dW = g^T x and db = sum of g over the rows, fp32 operands, each over
// `splits` row ranges added in fp64.
extern "C" int pt_pm_dwdb(const pointtpu::PmArgs* a, int device,
                          cudaStream_t stream) {
  using namespace pointtpu;
  if (bad(a) || !a->x || !a->g || !a->dw || !a->db || !a->part ||
      a->splits <= 0 || a->splits > 65535)
    return kErrArgs;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const long long wsz = (long long)a->c_out * a->c_in;
  Gemm g{};
  g.m = a->c_out, g.n = a->c_in, g.k = a->rows, g.batch = 1;
  g.splits = a->splits;
  g.sam = 1, g.sak = a->c_out;         // A[o][r] = g[r][o]
  g.sbk = a->c_in, g.sbn = 1;          // B[r][i] = x[r][i]
  g.ldc = a->c_in, g.bsc = wsz;        // one [c_out, c_in] partial per range
  g.a = a->g, g.b = a->x, g.c = a->part;
  float* part_b = a->part + (size_t)a->splits * wsz;
  g.asum = part_b;                     // db's partial: A's row sums
  int s = gemm(g, false, stream);
  if (s) return s;
  if ((s = split_sum(a->part, a->splits, wsz, 1, a->dw, stream))) return s;
  return split_sum(part_b, a->splits, a->c_out, 1, a->db, stream);
}
