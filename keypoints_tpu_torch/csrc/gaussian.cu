// Gaussian raster on Hopper, forward and backward.
//   forward:  keypoints (N, 2) f32 (x, y) -> maps (N, H, W) f32,
//             G[n, v, u] = exp(-((u - x_n)^2 + (v - y_n)^2) / (2 sigma^2))
//   backward: keypoints, dL/dmaps (N, H, W) f32 -> dL/dkeypoints (N, 2) f32,
//             (sum g G (u - x) / sigma^2, sum g G (v - y) / sigma^2)
//
// Replaces keypoints_tpu/kernels/gaussian_pallas.py:93 gaussian_maps_pallas:
// the forward _fwd_kernel (:32) and the hand-written backward _bwd_kernel
// (:40). As there, the pixel coordinates u, v come from
// keypoints_tpu.coords.axis_coords (either align_corners) computed in the
// kernel, nothing but the keypoints and the maps crosses device memory, and
// the backward recomputes G instead of reading it back.
//
// What bounds it: the forward writes N*H*W*4 bytes, the backward reads as
// many; at the train step's N = 128 * 10 rows of 32x32 that is 5.2 MB, 1.6
// us at 3.35 TB/s, for a few flops and one exp per element. At the presets'
// sizes (N = 1,280 and 2,048 at 32^2, 256 at 16^2) the launch (~2.5 us on
// an H100 for N = 1 at 1x1, PERF.md) costs more than the bytes: both
// kernels are launch and latency bound.
//
// Design. Forward: the maps are N * H rows of W; a block takes a group of
// rows, a thread runs of 4 neighbouring pixels of its row, each one float4
// store where W % 4 == 0 (else scalar stores). Each column's coordinate is
// computed once a block and each row's, with its keypoint, once a row, by
// axis_coord into shared memory; the pixel's value is
// kpcommon::gaussian_value, as in fused_bottleneck.cu, so K3's maps equal
// this kernel's on the same keypoints bit for bit. Backward: a team of 32
// to 256 threads (a power of two) takes a map, a thread runs of 4 pixels of
// dL/dmaps (float4 loads where W % 4 == 0) with the coordinates from the
// block's tables, recomputing G; a shuffle sum a warp, then the team's
// warps added in warp order: no atomics, so two calls give the same bits.
// Both give a thread 4, 2 or 1 runs, the most that leave ~4 blocks a
// streaming multiprocessor, so each block's fixed cost (its tables, the
// keypoint loads) covers more pixels where there are blocks to spare. No
// 64-bit division: a row's map and y come from two 32-bit ones.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using kpcommon::axis_coord;
using kpcommon::gaussian_value;
using kpcommon::kWarp;
using kpcommon::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kRun = 4;  // neighbouring pixels of a row a thread takes
// Blocks a launch should keep (about 4 a streaming multiprocessor of an
// H100): a thread takes 4, 2 or 1 runs, the most that leave this many.
constexpr int kMinBlocks = 512;

// The maps as N * H rows of W pixels. A block takes kThreads / tpr rows,
// `tpr` threads a row, and a thread runs of kRun pixels of its row, tpr
// apart; `vec` (W % 4 == 0, maps 16-byte aligned): one float4 store a run.
// Each column's coordinate is computed once a block (u), each row's with
// its keypoint once a row (v, kx, ky).
__global__ void __launch_bounds__(kThreads)
gaussian_fwd(const float* __restrict__ kp, float* __restrict__ out, int rows,
             int h, int w, int tpr, float inv_two_s2, bool align, bool vec) {
  extern __shared__ float u[];                 // u[w], then 3 a block row
  float* rv = u + w;
  const int per_block = kThreads / tpr;
  const int t = threadIdx.x;
  const int lr = t / tpr, lane = t - lr * tpr;
  const int row = blockIdx.x * per_block + lr;
  for (int x = t; x < w; x += kThreads) u[x] = axis_coord(x, w, align);
  if (lane == 0 && row < rows) {
    const int n = row / h;
    rv[3 * lr] = axis_coord(row - n * h, h, align);
    rv[3 * lr + 1] = __ldg(kp + 2 * static_cast<size_t>(n));
    rv[3 * lr + 2] = __ldg(kp + 2 * static_cast<size_t>(n) + 1);
  }
  __syncthreads();
  if (row >= rows) return;
  const float v = rv[3 * lr], kx = rv[3 * lr + 1], ky = rv[3 * lr + 2];
  float* o = out + static_cast<size_t>(row) * w;
  for (int x0 = lane * kRun; x0 < w; x0 += tpr * kRun) {
    float g[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      g[j] = gaussian_value(u[min(x0 + j, w - 1)], v, kx, ky, inv_two_s2);
    if (vec) {
      *reinterpret_cast<float4*>(o + x0) = make_float4(g[0], g[1], g[2], g[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (x0 + j < w) o[x0 + j] = g[j];
    }
  }
}

// A team of `tpm` threads (32 to kThreads, a power of two) a map,
// kThreads / tpm maps a block. A thread sums runs of kRun pixels of its
// map, tpm runs apart (float4 loads of dL/dmaps where `vec`), with the
// coordinates from the block's tables (u[w], v[h]); then a shuffle sum a
// warp and, for a team of several warps, the warps' sums added in warp
// order. No atomics: two calls give the same bits.
__global__ void __launch_bounds__(kThreads)
gaussian_bwd(const float* __restrict__ kp, const float* __restrict__ g,
             float* __restrict__ out, int n_rows, int h, int w, int tpm,
             float inv_two_s2, float inv_s2, bool align, bool vec) {
  extern __shared__ float u[];                 // u[w], v[h]
  float* v = u + w;
  __shared__ float2 part[kWarps];
  const int t = threadIdx.x;
  for (int x = t; x < w; x += kThreads) u[x] = axis_coord(x, w, align);
  for (int y = t; y < h; y += kThreads) v[y] = axis_coord(y, h, align);
  __syncthreads();
  const int team = t / tpm, lane = t - team * tpm;
  const int row = blockIdx.x * (kThreads / tpm) + team;
  float sx = 0.0f, sy = 0.0f;
  if (row < n_rows) {
    const float kx = __ldg(kp + 2 * static_cast<size_t>(row));
    const float ky = __ldg(kp + 2 * static_cast<size_t>(row) + 1);
    const int hw = h * w;
    const float* gr = g + static_cast<size_t>(row) * hw;
    for (int i = lane * kRun; i < hw; i += tpm * kRun) {
      float gv[kRun];
      int y[kRun], x[kRun];
      if (vec) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(gr + i));
        gv[0] = q.x, gv[1] = q.y, gv[2] = q.z, gv[3] = q.w;
        y[0] = i / w;
        x[0] = i - y[0] * w;
#pragma unroll
        for (int j = 1; j < kRun; ++j) y[j] = y[0], x[j] = x[0] + j;
      } else {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          const int e = min(i + j, hw - 1);
          gv[j] = i + j < hw ? __ldg(gr + e) : 0.0f;
          y[j] = e / w;
          x[j] = e - y[j] * w;
        }
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const float du = u[x[j]] - kx;
        const float dv = v[y[j]] - ky;
        const float wg = gv[j] * expf(-(du * du + dv * dv) * inv_two_s2);
        sx += wg * du;
        sy += wg * dv;
      }
    }
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  if (tpm > kWarp) {
    if (t % kWarp == 0) part[t / kWarp] = make_float2(sx, sy);
    __syncthreads();
    if (lane == 0) {
      const int first = team * (tpm / kWarp);
      sx = part[first].x, sy = part[first].y;
      for (int k = 1; k < tpm / kWarp; ++k) {
        sx += part[first + k].x;
        sy += part[first + k].y;
      }
    }
  }
  if (lane == 0 && row < n_rows) {
    out[2 * static_cast<size_t>(row)] = sx * inv_s2;
    out[2 * static_cast<size_t>(row) + 1] = sy * inv_s2;
  }
}

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// the least power of two >= v, within [lo, kThreads]
int pow2_within(int v, int lo) {
  int p = lo;
  while (p < v && p < kThreads) p *= 2;
  return p;
}

// Threads for each of `items` rows (forward) or maps (backward) of `runs`
// runs: the fewest, a power of two from `lo`, that give each thread at most
// 4, 2 or 1 runs (the most that keep kMinBlocks blocks), so that each
// block's fixed cost (its tables, the keypoint loads) covers more pixels
// where there are blocks to spare.
int threads_per_item(long long items, int runs, int lo) {
  int per = lo;
  for (int r = 4; r >= 1; r /= 2) {
    per = pow2_within((runs + r - 1) / r, lo);
    const long long blocks = (items + kThreads / per - 1) / (kThreads / per);
    if (blocks >= kMinBlocks) break;
  }
  return per;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// opt in above the default 48 KB of dynamic shared memory
template <typename Kernel>
cudaError_t fit_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// N * H * W < 2^31; 4 * (W + 768) bytes of shared memory (forward) and
// 4 * (W + H) (backward) at most 227 KB. Launch on `stream`; return
// cudaGetLastError() (0 on success). No sync.
extern "C" int kp_gaussian_fwd(int n, int h, int w, float sigma,
                               int align_corners, const void* kp, void* out,
                               void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(w) + 3 * kThreads);
  if (n < 0 || h < 1 || w < 1 || !(sigma > 0.0f) ||
      static_cast<long long>(n) * h * w >= (1LL << 31) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int rows = n * h;
  const int tpr = threads_per_item(rows, (w + kRun - 1) / kRun, 1);
  const int per_block = kThreads / tpr;
  const cudaError_t e = fit_smem(gaussian_fwd, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  gaussian_fwd<<<(rows + per_block - 1) / per_block, kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kp), static_cast<float*>(out), rows, h, w,
      tpr, 1.0f / (2.0f * sigma * sigma), align_corners != 0,
      w % kRun == 0 && aligned16(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kp_gaussian_bwd(int n, int h, int w, float sigma,
                               int align_corners, const void* kp,
                               const void* g, void* out, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(w) + h);
  if (n < 0 || h < 1 || w < 1 || !(sigma > 0.0f) ||
      static_cast<long long>(n) * h * w >= (1LL << 31) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int tpm = threads_per_item(n, (h * w + kRun - 1) / kRun, kWarp);
  const int per_block = kThreads / tpm;
  const cudaError_t e = fit_smem(gaussian_bwd, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  gaussian_bwd<<<(n + per_block - 1) / per_block, kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kp), static_cast<const float*>(g),
      static_cast<float*>(out), n, h, w, tpm, 1.0f / (2.0f * sigma * sigma),
      1.0f / (sigma * sigma), align_corners != 0,
      w % kRun == 0 && aligned16(g));
  return static_cast<int>(cudaGetLastError());
}
