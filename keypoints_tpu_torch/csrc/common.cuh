// Helpers shared by the kernels in this directory (header only; every .cu
// that includes it gets its own internal copy).
#pragma once

#include <cuda_runtime.h>

namespace kpcommon {

constexpr int kWarp = 32;
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

// The Gaussian raster's value at a pixel of coordinates (u, v) for a keypoint
// (kx, ky): exp(-((u - kx)^2 + (v - ky)^2) * inv_two_s2), inv_two_s2 =
// 1 / (2 sigma^2), u and v from axis_coord. The raster (gaussian.cu) and the
// fused bottleneck (fused_bottleneck.cu) both write it, so their maps agree
// to the bit.
__device__ __forceinline__ float gaussian_value(float u, float v, float kx,
                                                float ky, float inv_two_s2) {
  const float du = u - kx;
  const float dv = v - ky;
  return expf(-(du * du + dv * dv) * inv_two_s2);
}

}  // namespace kpcommon
