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
// Design. Up to 64 a side, one warp per heatmap and kFusedWarps heatmaps a
// block. The keypoint comes from K1's own functions (softmax.cuh:
// marginal_keypoint, joint_keypoint, with K1's chunk and load width), so it
// equals K1's to the bit, and every lane holds it after the butterfly
// reductions. Then the warp writes its map, each pixel by the raster's own
// formula (common.cuh gaussian_value) on the coordinates axis_coord gives,
// so the map equals K2's on that keypoint to the bit. What the map writing
// costs is a warp's chain of exps and stores behind its keypoint, so:
//  * runs of 4: where Wo % 4 == 0 and the maps are 16-byte aligned (every
//    preset), lane l writes runs of 4 neighbouring pixels l, l + 32, ...
//    (runs of a row, never across one), one float4 store and one float4
//    read of the column table each: 8 stores a lane at 32^2, 2 at 16^2.
//    A lane's runs are independent (4 unrolled), so their exps overlap.
//    Otherwise a lane writes pixels l, l + 32, ... with scalar stores. In
//    both, (x, y) step by a fixed (dx, dy) and one conditional wrap, with no
//    division and no loop a pixel;
//  * the table after the loads: the output's coordinates (Ho + Wo
//    axis_coord values, a division each) go to shared memory after the
//    keypoint functions have issued their loads, so their latency overlaps
//    the keypoint's chain, and the block's one barrier sits between the
//    keypoints and the maps (a warp past the last heatmap still reaches it).
//    The table (and on the block path the sums and reduction scratch beside
//    it) may take a block's whole 227 KB of shared memory, as the raster's
//    (gaussian.cu) may; above the default 48 KB the kernel opts in.
// kFusedWarps is K3's own (K1 keeps softmax.cuh's kWarpsPerBlock): of 1,
// 2, 4 and 8, the fastest summed over the presets' train steps on an H100
// (PERF.md; tools/softmax_ab.py --set kFusedWarps=N times the others).
//
// H or W above 64: one block of 256 threads per heatmap, as K1's block
// path. The keypoint comes from the same block functions (softmax.cuh:
// block_marginal_keypoint, block_joint_keypoint), so it equals K1's to the
// bit there too; then the block writes the map from the coordinate table,
// thread t at runs t, t + 256, ... of 4 pixels (float4) where Wo % 4 == 0
// and the maps are aligned, else at pixels t, t + 256, ... The TPU
// kernel's block-row tiling (_block_rows, _flat_spec) and indicator-matrix
// marginals exist for Mosaic's lack of lane-splitting reshapes and have no
// counterpart here.

#include <cuda_runtime.h>

#include <cstdint>

#include "softmax.cuh"

namespace {

using kpcommon::axis_coord;
using kpcommon::gaussian_value;
using kpcommon::kWarp;
using kpsoftmax::bad_shape;
using kpsoftmax::joint_keypoint;
using kpsoftmax::marginal_keypoint;

// Heatmaps (warps) a block of the warp-path kernel
constexpr int kFusedWarps = 1;
constexpr int kRun = 4;                     // pixels a float4 store writes
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

// The (ho, wo) map `o` of keypoint (ex, ey) from the coordinate table (us
// of x < wo, 16-byte aligned; vs of y < ho), written by kThreads threads,
// this one `t`: where `vec`, runs t, t + kThreads, ... of kRun pixels, one
// float4 each; else pixels t, t + kThreads, ... Each pixel by
// gaussian_value, as gaussian.cu writes it. (x, y) step by a fixed (dx, dy)
// and wrap once at most: dx is below the row.
template <int kThreads>
__device__ __forceinline__ void write_map(float* __restrict__ o,
                                          const float* us, const float* vs,
                                          int ho, int wo, float ex, float ey,
                                          float inv_two_s2, int t, bool vec) {
  if (vec) {
    const int rr = wo / kRun;                // runs a row
    const int runs = ho * rr;
    const int dy = kThreads / rr, dx = kThreads - dy * rr;
    int y = t / rr, x = t - y * rr;
    const float4* u4 = reinterpret_cast<const float4*>(us);
    float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll 4
    for (int i = t; i < runs; i += kThreads) {
      const float4 u = u4[x];
      const float v = vs[y];
      o4[i] = make_float4(gaussian_value(u.x, v, ex, ey, inv_two_s2),
                          gaussian_value(u.y, v, ex, ey, inv_two_s2),
                          gaussian_value(u.z, v, ex, ey, inv_two_s2),
                          gaussian_value(u.w, v, ex, ey, inv_two_s2));
      x += dx;
      y += dy;
      if (x >= rr) {
        x -= rr;
        ++y;
      }
    }
    return;
  }
  const int hw = ho * wo;
  const int dy = kThreads / wo, dx = kThreads - dy * wo;
  int y = t / wo, x = t - y * wo;
#pragma unroll 4
  for (int i = t; i < hw; i += kThreads) {
    o[i] = gaussian_value(us[x], vs[y], ex, ey, inv_two_s2);
    x += dx;
    y += dy;
    if (x >= wo) {
      x -= wo;
      ++y;
    }
  }
}

// The output's coordinate table: u of x < wo, then v of y < ho.
__device__ __forceinline__ void coord_table(float* coords, int ho, int wo,
                                            bool align) {
  for (int i = threadIdx.x; i < wo + ho; i += blockDim.x)
    coords[i] = i < wo ? axis_coord(i, wo, align)
                       : axis_coord(i - wo, ho, align);
}

template <bool kJoint, int R, bool kQuad>
__global__ void __launch_bounds__(kFusedWarps * kWarp)
fused_fwd(const float* __restrict__ in, float* __restrict__ kp,
          float* __restrict__ maps, int n_rows, int h, int w, int ho, int wo,
          float inv_t, float inv_two_s2, bool align, bool vec) {
  extern __shared__ __align__(16) float coords[];  // coord_table
  const int lane = threadIdx.x % kWarp;
  const long long row = kpsoftmax::warp_heatmap(n_rows);
  float ex = 0.0f, ey = 0.0f;
  if (row >= 0) {
    const float* p = in + row * h * w;
    if (kJoint)
      joint_keypoint<R, kQuad>(p, h, w, inv_t, align, lane, ex, ey);
    else
      marginal_keypoint<R, kQuad>(p, h, w, inv_t, align, lane, ex, ey);
    if (lane == 0) {
      kp[2 * row] = ex;
      kp[2 * row + 1] = ey;
    }
  }
  // the table after the keypoint's loads, then the block's one barrier
  coord_table(coords, ho, wo, align);
  __syncthreads();
  if (row < 0) return;
  write_map<kWarp>(maps + row * ho * wo, coords, coords + wo, ho, wo, ex, ey,
                   inv_two_s2, lane, vec);
}

// H or W above 64: a block per heatmap. Dynamic shared memory: the output
// coordinates (coord_table), then, marginal, the column and row sums (w,
// then h floats).
template <bool kJoint>
__global__ void __launch_bounds__(kpsoftmax::kBlock)
block_fused_fwd(const float* __restrict__ in, float* __restrict__ kp,
                float* __restrict__ maps, int h, int w, int ho, int wo,
                float inv_t, float inv_two_s2, bool align, bool vec) {
  using kpsoftmax::kBlock;
  extern __shared__ __align__(16) float smem[];
  __shared__ float part[kpsoftmax::kPart];
  __shared__ float scratch[3 * kpsoftmax::kBlockWarps];
  // the keypoint functions synchronise before the table is read
  coord_table(smem, ho, wo, align);
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
  write_map<kBlock>(maps + row * ho * wo, smem, smem + wo, ho, wo, ex, ey,
                    inv_two_s2, threadIdx.x, vec);
}

// The warp-path kernel of a variant, chunk and load width, launched.
template <int R, bool kQuad>
cudaError_t warp_fused(int variant, int n, size_t table, cudaStream_t s,
                       const float* x, float* k, float* m, int h, int w,
                       int ho, int wo, float inv_t, float inv_two_s2,
                       bool align, bool vec) {
  const dim3 grid((n + kFusedWarps - 1) / kFusedWarps),
      block(kFusedWarps * kWarp);
  const auto kernel =
      variant == 0 ? fused_fwd<true, R, kQuad> : fused_fwd<false, R, kQuad>;
  const cudaError_t e = fit_smem(kernel, table);
  if (e != cudaSuccess) return e;
  kernel<<<grid, block, table, s>>>(x, k, m, n, h, w, ho, wo, inv_t,
                                    inv_two_s2, align, vec);
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
  // float4 runs where a run never crosses a row and every map is aligned
  const bool vec = wo % kRun == 0 &&
                   reinterpret_cast<std::uintptr_t>(maps) % 16 == 0;
  const size_t table = (static_cast<size_t>(ho) + wo) * sizeof(float);
  if (kpsoftmax::wide(h, w)) {
    const size_t dyn =
        table + kpsoftmax::sums_floats(variant, h, w) * sizeof(float);
    const auto kernel =
        variant == 0 ? block_fused_fwd<true> : block_fused_fwd<false>;
    const cudaError_t e = fit_smem(kernel, dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<n, kpsoftmax::kBlock, dyn, s>>>(x, k, m, h, w, ho, wo, inv_t,
                                             inv_two_s2, align, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const bool quad = kpsoftmax::quad_ok(w, x);
  cudaError_t e;
  if (kpsoftmax::warp_chunk(h, w) == kpsoftmax::kSmallChunk) {
    e = quad ? warp_fused<kpsoftmax::kSmallChunk, true>(
                   variant, n, table, s, x, k, m, h, w, ho, wo, inv_t,
                   inv_two_s2, align, vec)
             : warp_fused<kpsoftmax::kSmallChunk, false>(
                   variant, n, table, s, x, k, m, h, w, ho, wo, inv_t,
                   inv_two_s2, align, vec);
  } else {
    e = quad ? warp_fused<kpsoftmax::kChunk, true>(
                   variant, n, table, s, x, k, m, h, w, ho, wo, inv_t,
                   inv_two_s2, align, vec)
             : warp_fused<kpsoftmax::kChunk, false>(
                   variant, n, table, s, x, k, m, h, w, ho, wo, inv_t,
                   inv_two_s2, align, vec);
  }
  return static_cast<int>(e);
}
