// Soft-argmax on Hopper, forward and backward.
//   forward:  heatmaps (N, H, W) f32 -> keypoints (N, 2) f32
//   backward: heatmaps, keypoints (N, 2), dL/dkeypoints (N, 2) -> dL/dheatmaps
//             (N, H, W) f32
//
// Replaces keypoints_tpu/kernels/spatial_softmax_pallas.py:267
// spatial_softmax_pallas: forward ops _joint_fwd_kernel (:77) and
// _marginal_fwd_kernel (:151), backward ops _joint_bwd_kernel (:83) and
// _marginal_bwd_kernel (:157). It computes what they compute: float32 math,
// the max subtracted before exp, coordinates from keypoints_tpu.coords
// axis_coords with the given align_corners, output (x, y) per row. Like the
// TPU backward, it recomputes the softmax from the heatmap instead of saving
// the probabilities, and takes the forward's keypoints as the expectations.
//
// What bounds it: the forward reads N*H*W*4 bytes and writes N*8. At the
// celeba128 extract batch of 1024 (N = 10240 rows of 32x32) that is 41.9 MB
// in, about 12.5 us at the data-sheet 3.35 TB/s. The backward reads the
// heatmap and writes a tensor of the same size: at the train batch of 128
// (N = 1280) 5.2 MB + 5.2 MB, 3.1 us. The arithmetic is a few flops per
// byte, so both are memory bound (and at N = 1280, launch bound).
//
// Design: one warp per row. Lane x reads column x (and x + 32), so every
// row of the heatmap is one coalesced load per warp.
//  * marginal: the lane keeps its column sums over y in registers; each row
//    sum is a warp reduction whose result parks on lane y % 32. The two
//    1-D softmaxes and their expectations are then warp reductions over at
//    most 64 values held two per lane. One read of the heatmap. The
//    backward recomputes px and py the same way, forms
//    fx[x] = gx px[x] (xs[x] - ex) / T and fy[y] = gy py[y] (ys[y] - ey) / T
//    in registers, and writes dh[y, x] = fx[x] + fy[y] row by row (fy[y]
//    comes from lane y % 32 by a shuffle): one read, one write.
//  * joint: pass 1 takes the max of h/T over the row, pass 2 sums exp(h/T -
//    max) and its x- and y-weighted sums (the second read mostly hits L1).
//    The backward does the max and the sum, then writes
//    p (gx (u - ex) + gy (v - ey)) / T in a third pass.
// The TPU kernel's 0/1 indicator-matrix matmuls (:97-121) exist only because
// Mosaic has no lane-splitting reshape; plain loads and shuffles replace
// them here. H and W may be 1..64, any shape; the wrapper checks the bound.
// The per-row functions live in softmax.cuh, which the fused bottleneck
// (fused_bottleneck.cu, K3) shares. Making it fast (vector loads, several
// rows per warp, reading bf16 heatmaps directly) is later work.

#include <cuda_runtime.h>

#include "softmax.cuh"

namespace {

using kpcommon::axis_coord;
using kpcommon::kFull;
using kpcommon::kWarp;
using kpcommon::warp_sum;
using kpsoftmax::bad_shape;
using kpsoftmax::joint_keypoint;
using kpsoftmax::joint_max;
using kpsoftmax::marginal_keypoint;
using kpsoftmax::marginal_sums;
using kpsoftmax::softmax_probs;

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
marginal_fwd(const float* __restrict__ in, float* __restrict__ out, int n_rows,
             int h, int w, float inv_t, bool align) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;                 // uniform across the warp
  float ex, ey;
  marginal_keypoint(in + static_cast<size_t>(row) * h * w, h, w, inv_t, align,
                    lane, ex, ey);
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
  float ex, ey;
  joint_keypoint(in + static_cast<size_t>(row) * h * w, h, w, inv_t, align,
                 lane, ex, ey);
  if (lane == 0) {
    out[2 * static_cast<size_t>(row)] = ex;
    out[2 * static_cast<size_t>(row) + 1] = ey;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
marginal_bwd(const float* __restrict__ in, const float* __restrict__ kp,
             const float* __restrict__ g, float* __restrict__ out, int n_rows,
             int h, int w, float inv_t, bool align) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;                 // uniform across the warp
  const size_t base = static_cast<size_t>(row) * h * w;
  float col0, col1, row0, row1;
  marginal_sums(in + base, h, w, lane, col0, col1, row0, row1);
  float px0, px1, py0, py1;
  softmax_probs(col0 * inv_t, col1 * inv_t, w, lane, px0, px1);
  softmax_probs(row0 * inv_t, row1 * inv_t, h, lane, py0, py1);
  const float ex = kp[2 * static_cast<size_t>(row)];
  const float ey = kp[2 * static_cast<size_t>(row) + 1];
  const float gx = g[2 * static_cast<size_t>(row)] * inv_t;
  const float gy = g[2 * static_cast<size_t>(row) + 1] * inv_t;
  const float fx0 = gx * px0 * (axis_coord(lane, w, align) - ex);
  const float fx1 = gx * px1 * (axis_coord(lane + kWarp, w, align) - ex);
  const float fy0 = gy * py0 * (axis_coord(lane, h, align) - ey);
  const float fy1 = gy * py1 * (axis_coord(lane + kWarp, h, align) - ey);
  const bool ok0 = lane < w, ok1 = lane + kWarp < w;
  float* o = out + base;
  for (int y = 0; y < h; ++y) {
    // y is uniform across the warp, so every lane takes the same branch
    const float fy = __shfl_sync(kFull, y < kWarp ? fy0 : fy1, y % kWarp);
    float* r = o + static_cast<size_t>(y) * w;
    if (ok0) r[lane] = fx0 + fy;
    if (ok1) r[lane + kWarp] = fx1 + fy;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
joint_bwd(const float* __restrict__ in, const float* __restrict__ kp,
          const float* __restrict__ g, float* __restrict__ out, int n_rows,
          int h, int w, float inv_t, bool align) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;                 // uniform across the warp
  const size_t base = static_cast<size_t>(row) * h * w;
  const float* p = in + base;
  const bool ok0 = lane < w, ok1 = lane + kWarp < w;
  const float m = joint_max(p, h, w, inv_t, lane);
  float s = 0.0f;
  for (int y = 0; y < h; ++y) {
    const float* r = p + static_cast<size_t>(y) * w;
    if (ok0) s += expf(__ldg(r + lane) * inv_t - m);
    if (ok1) s += expf(__ldg(r + lane + kWarp) * inv_t - m);
  }
  const float inv_s = 1.0f / warp_sum(s);
  const float ex = kp[2 * static_cast<size_t>(row)];
  const float ey = kp[2 * static_cast<size_t>(row) + 1];
  const float gx = g[2 * static_cast<size_t>(row)] * inv_t;
  const float gy = g[2 * static_cast<size_t>(row) + 1] * inv_t;
  const float du0 = gx * (axis_coord(lane, w, align) - ex);
  const float du1 = gx * (axis_coord(lane + kWarp, w, align) - ex);
  float* o = out + base;
  for (int y = 0; y < h; ++y) {
    const float dv = gy * (axis_coord(y, h, align) - ey);
    const float* r = p + static_cast<size_t>(y) * w;
    float* q = o + static_cast<size_t>(y) * w;
    if (ok0) q[lane] = expf(__ldg(r + lane) * inv_t - m) * inv_s * (du0 + dv);
    if (ok1)
      q[lane + kWarp] = expf(__ldg(r + lane + kWarp) * inv_t - m) * inv_s * (du1 + dv);
  }
}

}  // namespace

// variant: 0 = joint, 1 = marginal. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int kp_spatial_softmax_fwd(int variant, int n, int h, int w,
                                      float inv_t, int align_corners,
                                      const void* heatmaps, void* out,
                                      void* stream) {
  if (bad_shape(variant, n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
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

// dL/dheatmaps from the heatmaps, the forward's keypoints and dL/dkeypoints,
// all f32 and contiguous. Same conventions as kp_spatial_softmax_fwd.
extern "C" int kp_spatial_softmax_bwd(int variant, int n, int h, int w,
                                      float inv_t, int align_corners,
                                      const void* heatmaps, const void* kp,
                                      const void* g, void* out, void* stream) {
  if (bad_shape(variant, n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const dim3 block(kWarpsPerBlock * kWarp);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(heatmaps);
  const auto* k = static_cast<const float*>(kp);
  const auto* d = static_cast<const float*>(g);
  auto* o = static_cast<float*>(out);
  if (variant == 0)
    joint_bwd<<<grid, block, 0, s>>>(x, k, d, o, n, h, w, inv_t, align_corners != 0);
  else
    marginal_bwd<<<grid, block, 0, s>>>(x, k, d, o, n, h, w, inv_t, align_corners != 0);
  return static_cast<int>(cudaGetLastError());
}
