// grid_sample's bilinear corner math, shared by the dense-grid and field
// warps (warp.cu, K4 and K5) and the banded warps (warp_experimental.cu, K7
// and K8), so that all of them weigh the same corners with the same f32
// arithmetic and agree to the bit wherever they read the same source rows.
#pragma once

#include <cuda_runtime.h>

namespace kpwarp {

// grid_sample's unnormalize: [-1, 1] -> fractional pixel index.
__device__ __forceinline__ float unnormalize(float c, int size, bool align) {
  if (align) return (c + 1.0f) * 0.5f * static_cast<float>(size - 1);
  return (c + 1.0f) * 0.5f * static_cast<float>(size) - 0.5f;
}

__device__ __forceinline__ int clamp_index(float v, int size) {
  return static_cast<int>(fminf(fmaxf(v, 0.0f), static_cast<float>(size - 1)));
}

// floor of the vertical sampling position of a grid y in [-1, 1]: the upper
// corner row before clamping (border padding clamps the position first)
template <bool kBorder>
__device__ __forceinline__ float source_row(float gy, int h, bool align) {
  float iy = unnormalize(gy, h, align);
  if (kBorder) iy = fminf(fmaxf(iy, 0.0f), static_cast<float>(h - 1));
  return floorf(iy);
}

// The four corners of one sampling point: rows yi0/yi1 and columns xi0/xi1,
// clamped into the image, and the weights of (y0,x0), (y0,x1), (y1,x0),
// (y1,x1), the order of ops/warp.py, zero for a corner outside the image
// under zeros padding.
struct Corners {
  int xi0, xi1, yi0, yi1;
  float w00, w01, w10, w11;
};

template <bool kBorder>
__device__ __forceinline__ Corners corners(float gx, float gy, int h, int w,
                                           bool align) {
  float ix = unnormalize(gx, w, align);
  float iy = unnormalize(gy, h, align);
  if (kBorder) {
    ix = fminf(fmaxf(ix, 0.0f), static_cast<float>(w - 1));
    iy = fminf(fmaxf(iy, 0.0f), static_cast<float>(h - 1));
  }
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float wx1 = ix - x0, wy1 = iy - y0;
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  Corners k;
  k.w00 = wy0 * wx0;
  k.w01 = wy0 * wx1;
  k.w10 = wy1 * wx0;
  k.w11 = wy1 * wx1;
  if (!kBorder) {
    const float wm = static_cast<float>(w - 1), hm = static_cast<float>(h - 1);
    const bool vx0 = x0 >= 0.0f && x0 <= wm, vx1 = x1 >= 0.0f && x1 <= wm;
    const bool vy0 = y0 >= 0.0f && y0 <= hm, vy1 = y1 >= 0.0f && y1 <= hm;
    k.w00 = (vy0 && vx0) ? k.w00 : 0.0f;
    k.w01 = (vy0 && vx1) ? k.w01 : 0.0f;
    k.w10 = (vy1 && vx0) ? k.w10 : 0.0f;
    k.w11 = (vy1 && vx1) ? k.w11 : 0.0f;
  }
  k.xi0 = clamp_index(x0, w);
  k.xi1 = clamp_index(x1, w);
  k.yi0 = clamp_index(y0, h);
  k.yi1 = clamp_index(y1, h);
  return k;
}

// The corner sum of one channel: each product and sum in f32, in the order
// above (the compiler fuses each product into the running sum).
__device__ __forceinline__ float blend(const Corners& k, float v00, float v01,
                                       float v10, float v11) {
  float v = v00 * k.w00;
  v += v01 * k.w01;
  v += v10 * k.w10;
  v += v11 * k.w11;
  return v;
}

// a bf16 value (its 16 bits) widened to f32, exactly
__device__ __forceinline__ float bf16_bits(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

}  // namespace kpwarp
