// Fused keypoint bottleneck on Hopper: soft-argmax, then the Gaussian raster
// of its keypoint, in one pass per heatmap.
//   heatmaps (N, H, W) f32 -> keypoints (N, 2) f32 (x, y)
//                           and maps (N, Ho, Wo) f32,
//   maps[n, v, u] = exp(-((u - x_n)^2 + (v - y_n)^2) / (2 sigma^2))
//
// Replaces keypoints_tpu/kernels/fused_bottleneck.py:121
// softargmax_raster_fused, forward: _fused_fwd_kernel (:44), called at :66,
// both variants (joint and marginal). Its backward (:84-115) composes the
// raster backward and the soft-argmax backward kernels; so does the port's
// (kernels/fused_bottleneck_cuda.py: gaussian.cu's K2 backward, then
// spatial_softmax.cu's K1b), so this file holds the forward only.
//
// What bounds it: it reads N*H*W*4 bytes and writes N*Ho*Wo*4 + N*8, a few
// flops and one exp per element, so it is byte bound. At 3.35 TB/s:
// transporter_atari b64 (N = 256, 16x16 -> 16x16) moves 0.53 MB, 0.16 us,
// far below a launch: launch bound; celeba128 b128 (N = 1280, 32x32) 10.5
// MB, 3.1 us; pose256 b128 (N = 2048, 32x32) 16.8 MB, 5.0 us. The fusion
// saves the (N, 2) round trip and the second launch of the unfused K1 -> K2
// pair, so kernels.extract_and_render takes it in both variants.
//
// Design: one warp per heatmap, as K1, and K1's launch geometry
// (kWarpsPerBlock warps a block). The keypoint comes from K1's own functions
// (softmax.cuh: marginal_keypoint, joint_keypoint, with K1's chunk and load
// width), so it equals K1's to the bit, and every lane holds it after the
// butterfly reductions. The warp then writes the map straight from
// registers, lane i at flat pixels i, i + 32, ... (one coalesced 128-byte
// store per step), each pixel by the raster's own formula (common.cuh
// gaussian_value), so the map equals K2's on that keypoint. A warp has 32
// threads for Ho*Wo pixels where K2 has one thread a pixel, so the loop is
// kept short: the output grid's coordinates (axis_coord, two float
// divisions each) are computed once per block into shared memory, and the
// pixel's (x, y) advance by 32 without an integer division. The table
// (Ho + Wo floats, and on the block path the sums and reduction scratch
// beside it) may take a block's whole 227 KB of shared memory, as the
// raster's (gaussian.cu) may; above the default 48 KB the kernel opts in.
//
// H or W above 64: one block of 256 threads per heatmap, as K1's block
// path. The keypoint comes from the same block functions (softmax.cuh:
// block_marginal_keypoint, block_joint_keypoint), so it equals K1's to the
// bit there too; then the block writes the map, thread t at flat pixels t,
// t + 256, ..., each by gaussian_value from the coordinate table. The TPU
// kernel's
// block-row tiling (_block_rows, _flat_spec) and indicator-matrix marginals
// exist for Mosaic's lack of lane-splitting reshapes and have no
// counterpart here.

#include <cuda_runtime.h>

#include "softmax.cuh"

namespace {

using kpcommon::axis_coord;
using kpcommon::gaussian_value;
using kpcommon::kWarp;
using kpsoftmax::bad_shape;
using kpsoftmax::joint_keypoint;
using kpsoftmax::kWarpsPerBlock;
using kpsoftmax::marginal_keypoint;

constexpr size_t kDefaultSmem = 48 * 1024;  // without an opt-in
constexpr size_t kMaxSmem = 227 * 1024;     // a block's shared memory, sm_90
// Static shared memory of block_fused_fwd (part, scratch), in floats
constexpr int kBlockStatic = kpsoftmax::kPart + 3 * kpsoftmax::kBlockWarps;

// Shared memory, in floats, that K3 needs: the output's coordinate table,
// and on the block path the static scratch and a marginal map's sums
// (kernels/fused_bottleneck_cuda.py table_floats mirrors it).
inline size_t table_floats(int variant, int h, int w, int ho, int wo) {
  size_t f = static_cast<size_t>(ho) + wo;
  if (kpsoftmax::wide(h, w))
    f += kBlockStatic + kpsoftmax::sums_floats(variant, h, w);
  return f;
}

// opt in above the default 48 KB of dynamic shared memory
template <typename Kernel>
cudaError_t fit_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool kJoint, int R, bool kQuad>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
fused_fwd(const float* __restrict__ in, float* __restrict__ kp,
          float* __restrict__ maps, int n_rows, int h, int w, int ho, int wo,
          float inv_t, float inv_two_s2, bool align) {
  extern __shared__ float coords[];          // u of x < wo, then v of y < ho
  for (int i = threadIdx.x; i < wo + ho; i += blockDim.x)
    coords[i] = i < wo ? axis_coord(i, wo, align)
                       : axis_coord(i - wo, ho, align);
  __syncthreads();
  const float* us = coords;
  const float* vs = coords + wo;

  const int lane = threadIdx.x % kWarp;
  const long long row = kpsoftmax::warp_heatmap(n_rows);
  if (row < 0) return;
  const float* p = in + row * h * w;
  float ex, ey;
  if (kJoint)
    joint_keypoint<R, kQuad>(p, h, w, inv_t, align, lane, ex, ey);
  else
    marginal_keypoint<R, kQuad>(p, h, w, inv_t, align, lane, ex, ey);
  if (lane == 0) {
    kp[2 * row] = ex;
    kp[2 * row + 1] = ey;
  }
  const int hw = ho * wo;
  float* o = maps + row * hw;
  int y = lane / wo, x = lane - y * wo;      // of flat pixel i = lane
#pragma unroll 4
  for (int i = lane; i < hw; i += kWarp) {
    o[i] = gaussian_value(us[x], vs[y], ex, ey, inv_two_s2);
    x += kWarp;                              // pixel i + 32
    while (x >= wo) {
      x -= wo;
      ++y;
    }
  }
}

// H or W above 64: a block per heatmap. Dynamic shared memory: the output
// coordinates (u of x < wo, then v of y < ho), then, marginal, the column
// and row sums (w, then h floats).
template <bool kJoint>
__global__ void __launch_bounds__(kpsoftmax::kBlock)
block_fused_fwd(const float* __restrict__ in, float* __restrict__ kp,
                float* __restrict__ maps, int h, int w, int ho, int wo,
                float inv_t, float inv_two_s2, bool align) {
  using kpsoftmax::kBlock;
  extern __shared__ float smem[];
  __shared__ float part[kpsoftmax::kPart];
  __shared__ float scratch[3 * kpsoftmax::kBlockWarps];
  float* coords = smem;
  for (int i = threadIdx.x; i < wo + ho; i += kBlock)
    coords[i] = i < wo ? axis_coord(i, wo, align)
                       : axis_coord(i - wo, ho, align);
  // the keypoint functions synchronise before the table is read
  const size_t row = blockIdx.x;
  const float* p = in + row * h * w;
  float ex, ey;
  if (kJoint) {
    kpsoftmax::block_joint_keypoint(p, h, w, inv_t, align, scratch, ex, ey);
  } else {
    float* sums = smem + wo + ho;
    kpsoftmax::block_marginal_keypoint(p, h, w, inv_t, align, sums, sums + w,
                                       part, scratch, ex, ey);
  }
  if (threadIdx.x == 0) {
    kp[2 * row] = ex;
    kp[2 * row + 1] = ey;
  }
  const float* us = coords;
  const float* vs = coords + wo;
  const int hw = ho * wo;
  float* o = maps + row * hw;
  const int dy = kBlock / wo, dx = kBlock - dy * wo;
  int y = threadIdx.x / wo, x = threadIdx.x - y * wo;  // of flat pixel t
  for (int i = threadIdx.x; i < hw; i += kBlock) {
    o[i] = gaussian_value(us[x], vs[y], ex, ey, inv_two_s2);
    x += dx;                                 // pixel i + kBlock
    y += dy;
    if (x >= wo) {
      x -= wo;
      ++y;
    }
  }
}

// The warp-path kernel of a variant, chunk and load width, launched.
template <int R, bool kQuad>
cudaError_t warp_fused(int variant, int n, size_t table, cudaStream_t s,
                       const float* x, float* k, float* m, int h, int w,
                       int ho, int wo, float inv_t, float inv_two_s2,
                       bool align) {
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock),
      block(kWarpsPerBlock * kWarp);
  const auto kernel =
      variant == 0 ? fused_fwd<true, R, kQuad> : fused_fwd<false, R, kQuad>;
  const cudaError_t e = fit_smem(kernel, table);
  if (e != cudaSuccess) return e;
  kernel<<<grid, block, table, s>>>(x, k, m, n, h, w, ho, wo, inv_t,
                                    inv_two_s2, align);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 = joint, 1 = marginal. table_floats(...) * 4 bytes at most
// 227 KB. Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise.
extern "C" int kp_softargmax_raster_fwd(int variant, int n, int h, int w,
                                        int ho, int wo, float inv_t,
                                        float sigma, int align_corners,
                                        const void* heatmaps, void* kp,
                                        void* maps, void* stream) {
  if (bad_shape(variant, n, h, w) || ho < 1 || wo < 1 || !(sigma > 0.0f) ||
      table_floats(variant, h, w, ho, wo) * sizeof(float) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(heatmaps);
  auto* k = static_cast<float*>(kp);
  auto* m = static_cast<float*>(maps);
  // the raster's 1 / (2 sigma^2), computed as gaussian.cu computes it
  const float inv_two_s2 = 1.0f / (2.0f * sigma * sigma);
  const bool align = align_corners != 0;
  const size_t table = (static_cast<size_t>(ho) + wo) * sizeof(float);
  if (kpsoftmax::wide(h, w)) {
    const size_t dyn =
        table + kpsoftmax::sums_floats(variant, h, w) * sizeof(float);
    const auto kernel =
        variant == 0 ? block_fused_fwd<true> : block_fused_fwd<false>;
    const cudaError_t e = fit_smem(kernel, dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<n, kpsoftmax::kBlock, dyn, s>>>(x, k, m, h, w, ho, wo, inv_t,
                                             inv_two_s2, align);
    return static_cast<int>(cudaGetLastError());
  }
  const bool quad = kpsoftmax::quad_ok(w, x);
  cudaError_t e;
  if (kpsoftmax::warp_chunk(h, w) == kpsoftmax::kSmallChunk) {
    e = quad ? warp_fused<kpsoftmax::kSmallChunk, true>(
                   variant, n, table, s, x, k, m, h, w, ho, wo, inv_t,
                   inv_two_s2, align)
             : warp_fused<kpsoftmax::kSmallChunk, false>(
                   variant, n, table, s, x, k, m, h, w, ho, wo, inv_t,
                   inv_two_s2, align);
  } else {
    e = quad ? warp_fused<kpsoftmax::kChunk, true>(
                   variant, n, table, s, x, k, m, h, w, ho, wo, inv_t,
                   inv_two_s2, align)
             : warp_fused<kpsoftmax::kChunk, false>(
                   variant, n, table, s, x, k, m, h, w, ho, wo, inv_t,
                   inv_two_s2, align);
  }
  return static_cast<int>(e);
}
