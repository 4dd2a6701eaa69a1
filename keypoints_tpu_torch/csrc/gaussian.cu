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
// us at 3.35 TB/s, for a few flops and one exp per element. At that size the
// launch (a few us) costs more than the bytes: both kernels are launch bound
// on the main path.
//
// Design: the forward is one thread per output element, so the stores of a
// warp are one coalesced 128-byte line. The backward is one warp per row n:
// each lane walks the row with stride 32 (coalesced loads of g), keeps its
// two partial sums in registers, and one shuffle reduction ends the row. No
// atomics, so the result does not depend on scheduling.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using kpcommon::axis_coord;
using kpcommon::gaussian_value;
using kpcommon::kWarp;
using kpcommon::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;

__global__ void __launch_bounds__(kThreads)
gaussian_fwd(const float* __restrict__ kp, float* __restrict__ out,
             long long total, int h, int w, float inv_two_s2, bool align) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int hw = h * w;
  const long long n = i / hw;
  const int r = static_cast<int>(i - n * hw);
  const int y = r / w;
  const int x = r - y * w;
  out[i] = gaussian_value(axis_coord(x, w, align), axis_coord(y, h, align),
                          __ldg(kp + 2 * n), __ldg(kp + 2 * n + 1), inv_two_s2);
}

__global__ void __launch_bounds__(kThreads)
gaussian_bwd(const float* __restrict__ kp, const float* __restrict__ g,
             float* __restrict__ out, int n_rows, int h, int w,
             float inv_two_s2, float inv_s2, bool align) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;                 // uniform across the warp
  const int hw = h * w;
  const float kx = kp[2 * static_cast<size_t>(row)];
  const float ky = kp[2 * static_cast<size_t>(row) + 1];
  const float* gr = g + static_cast<size_t>(row) * hw;
  float sx = 0.0f, sy = 0.0f;
  for (int i = lane; i < hw; i += kWarp) {
    const int y = i / w;
    const int x = i - y * w;
    const float du = axis_coord(x, w, align) - kx;
    const float dv = axis_coord(y, h, align) - ky;
    const float wg = __ldg(gr + i) * expf(-(du * du + dv * dv) * inv_two_s2);
    sx += wg * du;
    sy += wg * dv;
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  if (lane == 0) {
    out[2 * static_cast<size_t>(row)] = sx * inv_s2;
    out[2 * static_cast<size_t>(row) + 1] = sy * inv_s2;
  }
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 on success). No sync.
extern "C" int kp_gaussian_fwd(int n, int h, int w, float sigma,
                               int align_corners, const void* kp, void* out,
                               void* stream) {
  if (n < 0 || h < 1 || w < 1 || !(sigma > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * h * w;
  if (total == 0) return 0;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  gaussian_fwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kp), static_cast<float*>(out), total, h, w,
      1.0f / (2.0f * sigma * sigma), align_corners != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kp_gaussian_bwd(int n, int h, int w, float sigma,
                               int align_corners, const void* kp,
                               const void* g, void* out, void* stream) {
  if (n < 0 || h < 1 || w < 1 || !(sigma > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gaussian_bwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kp), static_cast<const float*>(g),
      static_cast<float*>(out), n, h, w, 1.0f / (2.0f * sigma * sigma),
      1.0f / (sigma * sigma), align_corners != 0);
  return static_cast<int>(cudaGetLastError());
}
