// fused_linear_affine_act: y = act((x @ W^T) * scale + shift) over points.
//
// Replaces the TPU kernel
// adversarial_learning_on_pointclouds_tpu/ops/kernels/shared_mlp.py::
// fused_linear_affine_act (its pallas_call at shared_mlp.py:227).
//
// What bounds it here: on the serving path it runs conv1 only (3 -> 64
// channels over M = B * N = 80,000 points at B=32 N=2500): 12 bytes in,
// 256 bytes out and 192 FMAs a point, 0.96 MB in and 20.48 MB out, 6.4 us
// at 3.35 TB/s. It is bound by bytes, the output's above all. The first
// design (a thread an output element, 64 points a block, 1,250 blocks)
// issued 8 loads (3 of x, 3 of W, scale and shift) for each 4-byte store
// and moved about 1 TB/s: bound by load and store issue, not by memory.
//
// What the design does about that (conv_group_kernel):
// * A thread owns a group of 4 consecutive output channels. For cin 3
//   (CIN = 3, conv1's depth, the one depth built with its weights in
//   registers) and cout a multiple of 4 (at most 1024), the group's 4 x 3
//   weights, 4 scales and 4 shifts sit in registers, loaded once before
//   the point loop. At cout 64, 16 lanes cover a point and a warp two
//   points.
// * A point's cin inputs are read once per group of lanes, as a broadcast
//   load; a thread issues the loads of kUnroll points before it computes,
//   so their latencies overlap.
// * Outputs leave as 16-byte float4 stores: a warp writes 512 contiguous
//   bytes. No streaming or evict-first hint: the 20.5 MB output fits in
//   the 50 MB L2, and STNkd's stack kernel reads it next.
// * A persistent grid: as many blocks as stay resident on the card at
//   once (the occupancy calculator's count times the SMs, asked once for
//   each depth path, device and shared-memory size), balanced so
//   that every block walks the same number of point tiles by grid
//   stride; the weights load once per block, not once per 64 points.
// Rounding stays that of the first design: the product summed in order of
// k by fmaf from 0, then fmaf(acc, scale, shift), then the activation.
// Under mixed precision (BF, the prec field's kRound bit: the JAX
// package's _mxu_dot in its bf16 scope) x and W are rounded to bf16
// (nearest even) as they load; their products are exact in fp32 and the
// FMAs, their order and the epilogue stay as in fp32.
//
// Every other shape (cin other than 3, cout not a multiple of 4 or above
// 1024)
// runs the general path of the same kernel (CIN = 0): W^T's column slice
// sits in shared memory as [cin][cols] (a group's 4 weights of one k are
// one float4), column slices over blockIdx.y, sized to the block's shared
// memory (cin up to 14,528 at 227 KB); a group that runs past cout stores
// element by element. Nothing falls back to a plain version.
//
// Measured (H100 80GB HBM3, 700 W; conv1 at B=32 N=2500, device us a
// launch, `chip_smoke.py --time serve`): 7.8-7.9, against the first
// design's 21.3-21.6 and the byte bound's 6.4.
//
// W is PyTorch's [cout, cin] row-major layout (Conv1d weight, squeezed).

#include <mutex>

#include "common.cuh"

namespace pointtpu {
namespace {

constexpr int kGroup = 4;        // output channels a thread
constexpr int kUnroll = 2;       // point tiles a thread takes per step
constexpr int kRegCin = 3;       // the register path's input depth
constexpr int kSliceCols = kGroup * kThreads;  // channels a column slice

template <int CIN, bool BF>
__global__ void __launch_bounds__(kThreads)
conv_group_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ shift,
                  const float* __restrict__ scale, float* __restrict__ out,
                  long long m, int cin, int cout, int cols, int act) {
  // General path: W^T's column slice, [cin][cols] (cols a multiple of 4).
  extern __shared__ float4 wt4[];
  const int col0 = blockIdx.y * cols;
  const int groups = (min(cols, cout - col0) + kGroup - 1) / kGroup;
  const int per_tile = kThreads / groups;     // points a tile
  const int g = threadIdx.x % groups, lane_p = threadIdx.x / groups;
  const int c0 = col0 + kGroup * g;
  const int valid = min(kGroup, cout - c0);   // channels of this group
  const bool vec = valid == kGroup && (cout & (kGroup - 1)) == 0;

  float wr[CIN > 0 ? CIN : 1][kGroup], sc[kGroup], sh[kGroup];
  if (CIN == 0) {
    float* wt = reinterpret_cast<float*>(wt4);
    const int width = min(cols, cout - col0);
    // Consecutive threads read consecutive k of one W row (coalesced).
    for (int e = threadIdx.x; e < cin * cols; e += kThreads) {
      const int j = e / cin, k = e - j * cin;
      wt[k * cols + j] =
          j < width ? operand(__ldg(w + (size_t)(col0 + j) * cin + k), BF)
                    : 0.f;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int k = 0; k < (CIN > 0 ? CIN : 1); ++k)
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        wr[k][j] =
            j < valid ? operand(__ldg(w + (size_t)(c0 + j) * CIN + k), BF)
                      : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    sc[j] = j < valid ? __ldg(scale + c0 + j) : 0.f;
    sh[j] = j < valid ? __ldg(shift + c0 + j) : 0.f;
  }
  if (lane_p >= per_tile) return;   // after the only barrier

  const long long tiles = (m + per_tile - 1) / per_tile;
  const long long stride = gridDim.x;
  for (long long t = blockIdx.x; t < tiles; t += stride * kUnroll) {
    long long row[kUnroll];
    float acc[kUnroll][kGroup];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      row[u] = (t + u * stride) * per_tile + lane_p;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) acc[u][j] = 0.f;
    }
    if (CIN > 0) {
      float xv[kUnroll][CIN > 0 ? CIN : 1];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < (CIN > 0 ? CIN : 1); ++k)
          xv[u][k] = row[u] < m ? operand(__ldg(x + row[u] * CIN + k), BF)
                                : 0.f;
#pragma unroll
      for (int k = 0; k < (CIN > 0 ? CIN : 1); ++k)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            acc[u][j] = fmaf(xv[u][k], wr[k][j], acc[u][j]);
    } else {
      const int ld4 = cols / kGroup;
      for (int k = 0; k < cin; ++k) {
        const float4 wv = wt4[k * ld4 + g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float xk =
              row[u] < m ? operand(__ldg(x + row[u] * cin + k), BF) : 0.f;
          acc[u][0] = fmaf(xk, wv.x, acc[u][0]);
          acc[u][1] = fmaf(xk, wv.y, acc[u][1]);
          acc[u][2] = fmaf(xk, wv.z, acc[u][2]);
          acc[u][3] = fmaf(xk, wv.w, acc[u][3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row[u] >= m) continue;
      float y[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        y[j] = apply_act(fmaf(acc[u][j], sc[j], sh[j]), act);
      float* o = out + row[u] * cout + c0;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (j < valid) o[j] = y[j];
      }
    }
  }
}

// Blocks of conv_group_kernel<CIN, BF> resident on the whole card at once at
// `smem` bytes of shared memory, into *blocks; the kernel allowed that
// much first. Asked of CUDA once for each path, device and size; 0, else
// the CUDA error.
template <int CIN, bool BF>
int resident_blocks(size_t smem, int* blocks) {
  struct Seen {
    int device;
    size_t smem;
    int blocks;
  };
  static std::mutex lock;
  static Seen seen[64];
  static int count = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < count; ++i)
    if (seen[i].device == device && seen[i].smem == smem) {
      *blocks = seen[i].blocks;
      return 0;
    }
  e = allow_smem(conv_group_kernel<CIN, BF>, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv_group_kernel<CIN, BF>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return kErrSmem;
  *blocks = per_sm * device_attr(cudaDevAttrMultiProcessorCount);
  if (count < 64) seen[count++] = {device, smem, *blocks};
  return 0;
}

template <int CIN, bool BF>
int launch_conv(const float* x, const float* w, const float* shift,
                const float* scale, float* out, long long m, int cin,
                int cout, int act, cudaStream_t stream) {
  const int pad = (cout + kGroup - 1) / kGroup * kGroup;
  int cols = min(pad, kSliceCols);
  size_t smem = 0;
  if (CIN == 0) {
    const int fit = max_smem_optin() / (cin * (int)sizeof(float)) /
                    kGroup * kGroup;
    if (fit < kGroup) return kErrSmem;
    cols = min(cols, fit);
    smem = (size_t)cin * cols * sizeof(float);
  }
  int resident = 0;
  const int status = resident_blocks<CIN, BF>(smem, &resident);
  if (status) return status;
  const int slices = (cout + cols - 1) / cols;
  if (slices > 65535) return kErrArgs;
  const int per_tile = kThreads / (cols / kGroup);
  const long long tiles = (m + per_tile - 1) / per_tile;
  // Every block walks the same number of tiles (but the last few).
  const long long fill = (long long)resident / slices;
  const long long cap = fill > 0 ? fill : 1;
  const long long each = (tiles + cap - 1) / cap;
  const long long blocks = (tiles + each - 1) / each;
  conv_group_kernel<CIN, BF><<<dim3((unsigned)blocks, slices), kThreads, smem,
                               stream>>>(x, w, shift, scale, out, m, cin,
                                         cout, cols, act);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace pointtpu

// x [m, cin], w [cout, cin], shift/scale [cout] -> out [m, cout]; prec
// kRound: bf16 operands (0: fp32).
extern "C" int pt_linear_affine_act(const float* x, const float* w,
                                    const float* shift, const float* scale,
                                    float* out, long long m, int cin,
                                    int cout, int act, int prec, int device,
                                    cudaStream_t stream) {
  using namespace pointtpu;
  if (m <= 0 || cin <= 0 || cout <= 0 || act < 0 || act > kActLeaky ||
      (prec & ~kRound))
    return kErrArgs;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  const bool reg = cin == kRegCin && cout % kGroup == 0 && cout <= kSliceCols;
  if (prec & kRound)
    return reg ? launch_conv<kRegCin, true>(x, w, shift, scale, out, m, cin,
                                            cout, act, stream)
               : launch_conv<0, true>(x, w, shift, scale, out, m, cin, cout,
                                      act, stream);
  return reg ? launch_conv<kRegCin, false>(x, w, shift, scale, out, m, cin,
                                           cout, act, stream)
             : launch_conv<0, false>(x, w, shift, scale, out, m, cin, cout,
                                     act, stream);
}

extern "C" const char* pt_error_string(int status) {
  if (status == pointtpu::kErrArgs) return "arguments the kernel does not take";
  if (status == pointtpu::kErrSmem)
    return "working set exceeds the shared memory of one block";
  if (status == pointtpu::kErrCluster)
    return "no GPC holds a thread-block cluster of this shared memory";
  return cudaGetErrorString((cudaError_t)status);
}
