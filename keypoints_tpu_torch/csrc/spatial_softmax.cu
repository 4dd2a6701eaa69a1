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
// Design, H and W at most 64 (every preset: 16^2 and 32^2 heatmaps): one
// warp per row. Lane x reads column x (and x + 32), so every row of the
// heatmap is one coalesced load per warp.
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
// Design, H or W above 64 (e.g. 128^2 heatmaps from stride-1 encoders or
// 512^2 images): one block of 256 threads per row, striding over the map
// (softmax.cuh, block_*). Where W is a multiple of 4 up to 128 and the map
// 16-byte aligned, the block reads rows as float4 quads, a segment of
// lanes a row, and writes the backward's rows the same way. Marginal: the
// column sums and the row sums (one read on quads; else a column pass and
// a warp-a-row pass) go to shared memory (H + W floats), then two
// block-level softmax-expectations over them. Joint: block reductions of
// max(h/T), then of the sums of exp, exp * u and exp * v. The backward
// recomputes the softmax as the warp path does, then writes dh: marginal
// fx[x] + fy[y] from the two vectors in shared memory, joint
// p (gx (u - ex) + gy (v - ey)) / T. The block reductions combine the
// warps in a fixed order and nothing uses float atomics, so both are
// deterministic. At b128 K=10 with 128^2 maps the forward reads 83.9 MB,
// ~25 us at 3.35 TB/s; the backward reads and writes as much again.
// The TPU kernel's 0/1 indicator-matrix matmuls (:97-121) exist only because
// Mosaic has no lane-splitting reshape; plain loads and shuffles replace
// them here. The row functions live in softmax.cuh, which the fused
// bottleneck (fused_bottleneck.cu, K3) shares. Making it fast (vector
// loads, several rows per warp, reading bf16 heatmaps directly) is later
// work.

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

// ---- block per row: H or W above 64 ----

using kpsoftmax::block_axis_softmax;
using kpsoftmax::block_joint_keypoint;
using kpsoftmax::block_joint_max;
using kpsoftmax::block_marginal_keypoint;
using kpsoftmax::block_marginal_sums;
using kpsoftmax::block_reduce;
using kpsoftmax::kBlock;
using kpsoftmax::kBlockWarps;
using kpsoftmax::kPart;
using kpsoftmax::load_quad;
using kpsoftmax::quad_ok;
using kpsoftmax::Quads;
using kpsoftmax::quads;
using kpsoftmax::Sum;
using kpsoftmax::Tiling;
using kpsoftmax::tiling;

template <bool kJoint>
__global__ void __launch_bounds__(kBlock)
block_fwd(const float* __restrict__ in, float* __restrict__ out, int h, int w,
          float inv_t, bool align) {
  extern __shared__ float sums[];            // marginal: col[w], then row[h]
  __shared__ float part[kPart];
  __shared__ float scratch[3 * kBlockWarps];
  const size_t row = blockIdx.x;
  const float* p = in + row * h * w;
  float ex, ey;
  if (kJoint)
    block_joint_keypoint(p, h, w, inv_t, align, scratch, ex, ey);
  else
    block_marginal_keypoint(p, h, w, inv_t, align, sums, sums + w, part,
                            scratch, ex, ey);
  if (threadIdx.x == 0) {
    out[2 * row] = ex;
    out[2 * row + 1] = ey;
  }
}

__global__ void __launch_bounds__(kBlock)
block_marginal_bwd(const float* __restrict__ in, const float* __restrict__ kp,
                   const float* __restrict__ g, float* __restrict__ out, int h,
                   int w, float inv_t, bool align) {
  extern __shared__ float sums[];            // col[w], then row[h]
  __shared__ float part[kPart];
  __shared__ float scratch[2 * kBlockWarps];
  float* col = sums;
  float* rows = sums + w;
  const size_t row = blockIdx.x;
  const size_t base = row * h * w;
  block_marginal_sums(in + base, h, w, col, rows, part);
  float m[2], s[2];
  block_axis_softmax(col, w, rows, h, inv_t, scratch, m, s);
  // every read of col and rows above ends before block_reduce's last sync
  const float ex = kp[2 * row], ey = kp[2 * row + 1];
  const float gx = g[2 * row] * inv_t, gy = g[2 * row + 1] * inv_t;
  const float inv_x = 1.0f / s[0], inv_y = 1.0f / s[1];
  for (int i = threadIdx.x; i < w; i += kBlock)
    col[i] = gx * (expf(col[i] * inv_t - m[0]) * inv_x) *
             (axis_coord(i, w, align) - ex);
  for (int i = threadIdx.x; i < h; i += kBlock)
    rows[i] = gy * (expf(rows[i] * inv_t - m[1]) * inv_y) *
              (axis_coord(i, h, align) - ey);
  __syncthreads();
  float* o = out + base;
  if (quad_ok(w, o)) {
    const Quads qd = quads(w);
    if (!qd.on) return;
    const float* fx = col + 4 * qd.quad;
    for (int y = qd.slot; y < h; y += qd.rows) {
      const float fy = rows[y];
      reinterpret_cast<float4*>(o + static_cast<size_t>(y) * w)[qd.quad] =
          make_float4(fx[0] + fy, fx[1] + fy, fx[2] + fy, fx[3] + fy);
    }
    return;
  }
  const Tiling tl = tiling(w);
  for (int x = tl.x0; x < w; x += tl.xstep) {
    const float fx = col[x];
    for (int y = tl.y0; y < h; y += tl.ystep)
      o[static_cast<size_t>(y) * w + x] = fx + rows[y];
  }
}

__global__ void __launch_bounds__(kBlock)
block_joint_bwd(const float* __restrict__ in, const float* __restrict__ kp,
                const float* __restrict__ g, float* __restrict__ out, int h,
                int w, float inv_t, bool align) {
  __shared__ float scratch[kBlockWarps];
  const size_t row = blockIdx.x;
  const size_t base = row * h * w;
  const float* p = in + base;
  const float m = block_joint_max(p, h, w, inv_t, scratch);
  const Tiling tl = tiling(w);
  const Quads qd = quads(w);
  float* o = out + base;
  const bool quad = quad_ok(w, p) && quad_ok(w, o);
  float s[1] = {0.0f};
  if (quad) {
#pragma unroll 4
    for (int y = qd.slot; y < h; y += qd.rows) {
      if (!qd.on) continue;
      const float4 v = load_quad(p, w, y, qd.quad);
      s[0] += (expf(v.x * inv_t - m) + expf(v.y * inv_t - m)) +
              (expf(v.z * inv_t - m) + expf(v.w * inv_t - m));
    }
  } else {
    for (int x = tl.x0; x < w; x += tl.xstep)
      for (int y = tl.y0; y < h; y += tl.ystep)
        s[0] += expf(__ldg(p + static_cast<size_t>(y) * w + x) * inv_t - m);
  }
  block_reduce(s, scratch, Sum());
  const float inv_s = 1.0f / s[0];
  const float ex = kp[2 * row], ey = kp[2 * row + 1];
  const float gx = g[2 * row] * inv_t, gy = g[2 * row + 1] * inv_t;
  if (quad) {
    if (!qd.on) return;
    float du[4];
    for (int i = 0; i < 4; ++i)
      du[i] = gx * (axis_coord(4 * qd.quad + i, w, align) - ex);
#pragma unroll 4
    for (int y = qd.slot; y < h; y += qd.rows) {
      const float dv = gy * (axis_coord(y, h, align) - ey);
      const float4 v = load_quad(p, w, y, qd.quad);
      reinterpret_cast<float4*>(o + static_cast<size_t>(y) * w)[qd.quad] =
          make_float4(expf(v.x * inv_t - m) * inv_s * (du[0] + dv),
                      expf(v.y * inv_t - m) * inv_s * (du[1] + dv),
                      expf(v.z * inv_t - m) * inv_s * (du[2] + dv),
                      expf(v.w * inv_t - m) * inv_s * (du[3] + dv));
    }
    return;
  }
  for (int x = tl.x0; x < w; x += tl.xstep) {
    const float du = gx * (axis_coord(x, w, align) - ex);
    for (int y = tl.y0; y < h; y += tl.ystep) {
      const float dv = gy * (axis_coord(y, h, align) - ey);
      const size_t i = static_cast<size_t>(y) * w + x;
      o[i] = expf(__ldg(p + i) * inv_t - m) * inv_s * (du + dv);
    }
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
  const bool align = align_corners != 0;
  if (kpsoftmax::wide(h, w)) {
    const size_t sums = kpsoftmax::sums_floats(variant, h, w) * sizeof(float);
    if (variant == 0)
      block_fwd<true><<<n, kBlock, sums, s>>>(x, o, h, w, inv_t, align);
    else
      block_fwd<false><<<n, kBlock, sums, s>>>(x, o, h, w, inv_t, align);
  } else if (variant == 0) {
    joint_fwd<<<grid, block, 0, s>>>(x, o, n, h, w, inv_t, align);
  } else {
    marginal_fwd<<<grid, block, 0, s>>>(x, o, n, h, w, inv_t, align);
  }
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
  const bool align = align_corners != 0;
  if (kpsoftmax::wide(h, w)) {
    const size_t sums = kpsoftmax::sums_floats(variant, h, w) * sizeof(float);
    if (variant == 0)
      block_joint_bwd<<<n, kBlock, 0, s>>>(x, k, d, o, h, w, inv_t, align);
    else
      block_marginal_bwd<<<n, kBlock, sums, s>>>(x, k, d, o, h, w, inv_t, align);
  } else if (variant == 0) {
    joint_bwd<<<grid, block, 0, s>>>(x, k, d, o, n, h, w, inv_t, align);
  } else {
    marginal_bwd<<<grid, block, 0, s>>>(x, k, d, o, n, h, w, inv_t, align);
  }
  return static_cast<int>(cudaGetLastError());
}
