// Soft-argmax forward on Hopper: heatmaps (N, H, W) f32 -> keypoints (N, 2) f32.
//
// Replaces keypoints_tpu/kernels/spatial_softmax_pallas.py:267
// spatial_softmax_pallas, forward ops _joint_fwd_kernel (:77) and
// _marginal_fwd_kernel (:151). It computes what they compute: float32 math,
// the max subtracted before exp, coordinates from keypoints_tpu.coords
// axis_coords with the given align_corners, output (x, y) per row.
//
// What bounds it: it reads N*H*W*4 bytes and writes N*8. At the celeba128
// extract batch of 1024 (N = 10240 rows of 32x32) that is 41.9 MB in, about
// 12.5 us at the data-sheet 3.35 TB/s; the arithmetic is a few flops per
// byte, so the kernel is memory bound.
//
// Design: one warp per row. Lane x reads column x (and x + 32), so every
// row of the heatmap is one coalesced load per warp.
//  * marginal: the lane keeps its column sums over y in registers; each row
//    sum is a warp reduction whose result parks on lane y % 32. The two
//    1-D softmaxes and their expectations are then warp reductions over at
//    most 64 values held two per lane. One read of the heatmap.
//  * joint: pass 1 takes the max of h/T over the row, pass 2 sums exp(h/T -
//    max) and its x- and y-weighted sums (the second read mostly hits L1).
// The TPU kernel's 0/1 indicator-matrix matmuls (:97-121) exist only because
// Mosaic has no lane-splitting reshape; plain loads and shuffles replace
// them here. H and W may be 1..64, any shape; the wrapper checks the bound.
// Making it fast (vector loads, several rows per warp, reading bf16
// heatmaps directly) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxSide = 2 * kWarp;        // each lane holds index i and i + 32
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// keypoints_tpu.coords.axis_coords: coordinate of pixel i on an axis of n.
__device__ __forceinline__ float axis_coord(int i, int n, bool align) {
  const float fi = static_cast<float>(i);
  if (align) return n > 1 ? -1.0f + 2.0f * fi / static_cast<float>(n - 1) : 0.0f;
  return -1.0f + (2.0f * fi + 1.0f) / static_cast<float>(n);
}

// Softmax over n <= 64 logits held two per lane (index lane and lane + 32),
// then the expectation of axis_coord under it. Every lane gets the result.
__device__ float softmax_expectation(float v0, float v1, int n, bool align,
                                     int lane) {
  const bool ok0 = lane < n, ok1 = lane + kWarp < n;
  const float m = warp_max(fmaxf(ok0 ? v0 : -CUDART_INF_F,
                                 ok1 ? v1 : -CUDART_INF_F));
  const float e0 = ok0 ? expf(v0 - m) : 0.0f;
  const float e1 = ok1 ? expf(v1 - m) : 0.0f;
  const float s = warp_sum(e0 + e1);
  const float c = warp_sum(e0 * axis_coord(lane, n, align) +
                           e1 * axis_coord(lane + kWarp, n, align));
  return c / s;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
marginal_fwd(const float* __restrict__ in, float* __restrict__ out, int n_rows,
             int h, int w, float inv_t, bool align) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;                 // uniform across the warp
  const float* p = in + static_cast<size_t>(row) * h * w;
  const bool ok0 = lane < w, ok1 = lane + kWarp < w;
  float col0 = 0.0f, col1 = 0.0f;            // column sums of x = lane, lane+32
  float row0 = 0.0f, row1 = 0.0f;            // row sums of y = lane, lane+32
  for (int y = 0; y < h; ++y) {
    const float* r = p + static_cast<size_t>(y) * w;
    const float a = ok0 ? __ldg(r + lane) : 0.0f;
    const float b = ok1 ? __ldg(r + lane + kWarp) : 0.0f;
    col0 += a;
    col1 += b;
    const float t = warp_sum(a + b);
    if (y == lane) row0 = t;
    if (y == lane + kWarp) row1 = t;
  }
  const float ex = softmax_expectation(col0 * inv_t, col1 * inv_t, w, align, lane);
  const float ey = softmax_expectation(row0 * inv_t, row1 * inv_t, h, align, lane);
  if (lane == 0) {
    out[2 * static_cast<size_t>(row)] = ex;
    out[2 * static_cast<size_t>(row) + 1] = ey;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
joint_fwd(const float* __restrict__ in, float* __restrict__ out, int n_rows,
          int h, int w, float inv_t, bool align) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;                 // uniform across the warp
  const float* p = in + static_cast<size_t>(row) * h * w;
  const bool ok0 = lane < w, ok1 = lane + kWarp < w;

  float m = -CUDART_INF_F;
  for (int y = 0; y < h; ++y) {
    const float* r = p + static_cast<size_t>(y) * w;
    if (ok0) m = fmaxf(m, __ldg(r + lane) * inv_t);
    if (ok1) m = fmaxf(m, __ldg(r + lane + kWarp) * inv_t);
  }
  m = warp_max(m);

  float c0 = 0.0f, c1 = 0.0f;                // sum over y of e at x = lane, lane+32
  float sy = 0.0f;                           // sum of e * y-coordinate
  for (int y = 0; y < h; ++y) {
    const float* r = p + static_cast<size_t>(y) * w;
    const float a = ok0 ? expf(__ldg(r + lane) * inv_t - m) : 0.0f;
    const float b = ok1 ? expf(__ldg(r + lane + kWarp) * inv_t - m) : 0.0f;
    c0 += a;
    c1 += b;
    sy += (a + b) * axis_coord(y, h, align);
  }
  const float s = warp_sum(c0 + c1);
  const float sx = warp_sum(c0 * axis_coord(lane, w, align) +
                            c1 * axis_coord(lane + kWarp, w, align));
  sy = warp_sum(sy);
  if (lane == 0) {
    out[2 * static_cast<size_t>(row)] = sx / s;
    out[2 * static_cast<size_t>(row) + 1] = sy / s;
  }
}

}  // namespace

// variant: 0 = joint, 1 = marginal. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int kp_spatial_softmax_fwd(int variant, int n, int h, int w,
                                      float inv_t, int align_corners,
                                      const void* heatmaps, void* out,
                                      void* stream) {
  if (n < 0 || h < 1 || w < 1 || h > kMaxSide || w > kMaxSide ||
      (variant != 0 && variant != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const dim3 block(kWarpsPerBlock * kWarp);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(heatmaps);
  auto* o = static_cast<float*>(out);
  if (variant == 0)
    joint_fwd<<<grid, block, 0, s>>>(x, o, n, h, w, inv_t, align_corners != 0);
  else
    marginal_fwd<<<grid, block, 0, s>>>(x, o, n, h, w, inv_t, align_corners != 0);
  return static_cast<int>(cudaGetLastError());
}
