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

}  // namespace kpcommon
