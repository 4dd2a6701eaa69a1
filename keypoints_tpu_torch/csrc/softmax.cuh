// Warp-per-row soft-argmax device functions shared by the soft-argmax
// kernels (spatial_softmax.cu, K1 and K1b) and the fused bottleneck
// (fused_bottleneck.cu, K3), so that K3's keypoints are K1's to the bit.
// One warp holds one (h, w) heatmap row set, h and w at most 64: lane x reads
// columns x and x + 32, and every loop over y is uniform across the warp.
// Header only; every .cu that includes it gets its own internal copy.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace kpsoftmax {

using kpcommon::axis_coord;
using kpcommon::kWarp;
using kpcommon::warp_max;
using kpcommon::warp_sum;

constexpr int kMaxSide = 2 * kWarp;        // each lane holds index i and i + 32

// Softmax over n <= 64 logits held two per lane (index lane and lane + 32),
// then the expectation of axis_coord under it. Every lane gets the result.
__device__ __forceinline__ float softmax_expectation(float v0, float v1, int n,
                                                     bool align, int lane) {
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

// The same softmax, returning the probabilities of index lane and lane + 32.
__device__ __forceinline__ void softmax_probs(float v0, float v1, int n,
                                              int lane, float& p0, float& p1) {
  const bool ok0 = lane < n, ok1 = lane + kWarp < n;
  const float m = warp_max(fmaxf(ok0 ? v0 : -CUDART_INF_F,
                                 ok1 ? v1 : -CUDART_INF_F));
  const float e0 = ok0 ? expf(v0 - m) : 0.0f;
  const float e1 = ok1 ? expf(v1 - m) : 0.0f;
  const float inv = 1.0f / warp_sum(e0 + e1);
  p0 = e0 * inv;
  p1 = e1 * inv;
}

// Column sums (x = lane, lane + 32) and row sums (y = lane, lane + 32) of one
// (h, w) heatmap, one coalesced pass.
__device__ __forceinline__ void marginal_sums(const float* __restrict__ p,
                                              int h, int w, int lane,
                                              float& col0, float& col1,
                                              float& row0, float& row1) {
  const bool ok0 = lane < w, ok1 = lane + kWarp < w;
  col0 = col1 = row0 = row1 = 0.0f;
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
}

// Max of h/T over one (h, w) heatmap, on every lane.
__device__ __forceinline__ float joint_max(const float* __restrict__ p, int h,
                                           int w, float inv_t, int lane) {
  const bool ok0 = lane < w, ok1 = lane + kWarp < w;
  float m = -CUDART_INF_F;
  for (int y = 0; y < h; ++y) {
    const float* r = p + static_cast<size_t>(y) * w;
    if (ok0) m = fmaxf(m, __ldg(r + lane) * inv_t);
    if (ok1) m = fmaxf(m, __ldg(r + lane + kWarp) * inv_t);
  }
  return warp_max(m);
}

// Marginal soft-argmax (x, y) of one heatmap, on every lane: the softmaxes
// of the column and row sums and their expectations. One read.
__device__ __forceinline__ void marginal_keypoint(const float* __restrict__ p,
                                                  int h, int w, float inv_t,
                                                  bool align, int lane,
                                                  float& ex, float& ey) {
  float col0, col1, row0, row1;
  marginal_sums(p, h, w, lane, col0, col1, row0, row1);
  ex = softmax_expectation(col0 * inv_t, col1 * inv_t, w, align, lane);
  ey = softmax_expectation(row0 * inv_t, row1 * inv_t, h, align, lane);
}

// Joint soft-argmax (x, y) of one heatmap, on every lane: pass 1 takes the
// max of h/T, pass 2 sums exp(h/T - max) and its x- and y-weighted sums (the
// second read mostly hits L1).
__device__ __forceinline__ void joint_keypoint(const float* __restrict__ p,
                                               int h, int w, float inv_t,
                                               bool align, int lane,
                                               float& ex, float& ey) {
  const bool ok0 = lane < w, ok1 = lane + kWarp < w;
  const float m = joint_max(p, h, w, inv_t, lane);
  float c0 = 0.0f, c1 = 0.0f;                // sum over y of e, x = lane, +32
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
  ex = sx / s;
  ey = warp_sum(sy) / s;
}

// 0 = joint, 1 = marginal; the shapes one warp per row takes.
inline bool bad_shape(int variant, int n, int h, int w) {
  return n < 0 || h < 1 || w < 1 || h > kMaxSide || w > kMaxSide ||
         (variant != 0 && variant != 1);
}

}  // namespace kpsoftmax
