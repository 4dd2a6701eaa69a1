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
// warp per heatmap, the heatmap in registers (softmax.cuh, warp path). A
// lane reads 16 bytes a load where W % 4 == 0 and the map is 16-byte
// aligned (4 scalar loads of the same columns otherwise): a 32^2 heatmap is
// 8 loads a lane, 4 rows a warp load, a 16^2 one 2 loads, 8 rows; all of a
// chunk's loads (2 or 8, a template parameter) are issued before any
// reduction.
//  * marginal: the row sums are butterflies within each row's 8 (32 wide)
//    or 4 (16 wide) lanes, all the lane's rows together; the column sums
//    are the lane's 4 column partials over its rows, then a butterfly
//    across the row slots. The two 1-D softmaxes run on the sums held 4
//    columns, or a chunk's rows, a lane. One read. The backward recomputes
//    px and py the same way, forms fx[x] = gx px[x] (xs[x] - ex) / T for
//    its 4 columns and fy[y] = gy py[y] (ys[y] - ey) / T for its rows, and
//    writes dh[y, x] = fx[x] + fy[y] as float4 stores: one read, one write.
//  * joint: the max of h/T over the registers, then each exp(h/T - max)
//    once, for the sum and both weighted sums. One read. The backward
//    keeps the exps in registers and writes p (gx (u - ex) + gy (v - ey)) /
//    T from them: one read, one write.
//  A heatmap of more than 8 loads a lane (above 32 rows of 32, e.g. 64^2)
//  takes chunks of 8 and reads the map once a step of the softmax (two
//  passes forward, three backward; the later ones hit L1).
//  Each warp's chain of dependent latencies is short: the loads, a few
//  butterfly levels, the exps (exp2 of one fused multiply-add) and one
//  division; coordinates are a + b i, one division an axis, not one a
//  pixel.
//  Launch geometry: kWarpsPerBlock (2) warps, one heatmap each, a block
//  (softmax.cuh), so that N = 256 and N = 1,280 spread over the card's SMs.
// Design, H or W above 64 (e.g. 128^2 heatmaps from stride-1 encoders or
// 512^2 images): one block of 256 threads per row, striding over the map
// (softmax.cuh, block_*). Where W is a multiple of 4 up to 128 and the map
// 16-byte aligned, the block reads rows as float4 quads, a segment of
// lanes a row, and writes the backward's rows the same way. Marginal: the
// column sums and the row sums (one read on quads; else a column pass and
// a warp-a-row pass) go to shared memory (H + W floats), then two
// block-level softmax-expectations over them. Joint: block reductions of
// max(h/T), then of the sums of exp, exp * u and exp * v. The backward
// recomputes the softmax, then writes dh: marginal
// fx[x] + fy[y] from the two vectors in shared memory, joint
// p (gx (u - ex) + gy (v - ey)) / T. The block reductions combine the
// warps in a fixed order and nothing uses float atomics, so both are
// deterministic. At b128 K=10 with 128^2 maps the forward reads 83.9 MB,
// ~25 us at 3.35 TB/s; the backward reads and writes as much again.
// The TPU kernel's 0/1 indicator-matrix matmuls (:97-121) exist only because
// Mosaic has no lane-splitting reshape; plain loads and shuffles replace
// them here. The row functions live in softmax.cuh, which the fused
// bottleneck (fused_bottleneck.cu, K3) shares. Reading bf16 heatmaps
// directly is later work.

#include <cuda_runtime.h>

#include "softmax.cuh"

namespace {

using kpcommon::axis_coord;
using kpcommon::kWarp;
using kpsoftmax::Axis;
using kpsoftmax::axis;
using kpsoftmax::bad_shape;
using kpsoftmax::chunk_exp;
using kpsoftmax::chunk_sums;
using kpsoftmax::joint_keypoint;
using kpsoftmax::kWarpsPerBlock;
using kpsoftmax::joint_stats;
using kpsoftmax::lanes_sum;
using kpsoftmax::load_chunk;
using kpsoftmax::marginal_keypoint;
using kpsoftmax::marginal_stats;
using kpsoftmax::warp_heatmap;
using kpsoftmax::warp_rows;
using kpsoftmax::WarpRows;


template <int R, bool kQuad>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
marginal_fwd(const float* __restrict__ in, float* __restrict__ out, int n_rows,
             int h, int w, float inv_t, bool align) {
  const long long row = warp_heatmap(n_rows);
  if (row < 0) return;
  const int lane = threadIdx.x % kWarp;
  float ex, ey;
  marginal_keypoint<R, kQuad>(in + row * h * w, h, w, inv_t, align, lane, ex,
                              ey);
  if (lane == 0) {
    out[2 * row] = ex;
    out[2 * row + 1] = ey;
  }
}

template <int R, bool kQuad>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
joint_fwd(const float* __restrict__ in, float* __restrict__ out, int n_rows,
          int h, int w, float inv_t, bool align) {
  const long long row = warp_heatmap(n_rows);
  if (row < 0) return;
  const int lane = threadIdx.x % kWarp;
  float ex, ey;
  joint_keypoint<R, kQuad>(in + row * h * w, h, w, inv_t, align, lane, ex, ey);
  if (lane == 0) {
    out[2 * row] = ex;
    out[2 * row + 1] = ey;
  }
}

// Writes v[r] to the lane's quad of row y0 + slot + r * step, where that
// lies inside the heatmap: one float4 store where kQuad, else up to four
// scalar stores.
template <int R, bool kQuad>
__device__ __forceinline__ void store_chunk(float* __restrict__ o, int h,
                                            int w, int y0, const WarpRows& L,
                                            const float4 (&v)[R]) {
  const int x = 4 * L.quad;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + L.slot + r * L.step;
    if (y >= h || x >= w) continue;
    float* q = o + y * w + x;
    if (kQuad) {
      *reinterpret_cast<float4*>(q) = v[r];
    } else {
      q[0] = v[r].x;
      if (x + 1 < w) q[1] = v[r].y;
      if (x + 2 < w) q[2] = v[r].z;
      if (x + 3 < w) q[3] = v[r].w;
    }
  }
}

// dh[y, x] = fx[x] + fy[y], fx[x] = gx px[x] (xs[x] - ex) / T and
// fy[y] = gy py[y] (ys[y] - ey) / T: the column terms stay in registers
// (4 a lane), the row terms come from the row sums of each chunk.
template <int R, bool kQuad>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
marginal_bwd(const float* __restrict__ in, const float* __restrict__ kp,
             const float* __restrict__ g, float* __restrict__ out, int n_rows,
             int h, int w, float inv_t, bool align) {
  const long long row = warp_heatmap(n_rows);
  if (row < 0) return;
  const WarpRows L = warp_rows(w, threadIdx.x % kWarp);
  const float* p = in + row * h * w;
  float* o = out + row * h * w;
  float rs[R], e[4], s, sc, m, t[2];
  marginal_stats<R, kQuad>(p, h, w, inv_t, align, L, rs, e, s, sc, m, t);
  const float ex = kp[2 * row], ey = kp[2 * row + 1];
  const float gx = g[2 * row] * inv_t, gy = g[2 * row + 1] * inv_t;
  const float inv_x = 1.0f / s, inv_y = 1.0f / t[0];
  const Axis xs = axis(w, align);
  const Axis ys = axis(h, align);
  float fx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    fx[i] = gx * (e[i] * inv_x) * (xs(4 * L.quad + i) - ex);
  const int rows = R * L.step;
  float4 v[R];
  for (int y0 = 0; y0 < h; y0 += rows) {     // uniform across the warp
    if (h > rows) {                          // sum the chunk's rows again
      float unused[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      load_chunk<R, kQuad>(p, h, w, y0, L, v);
      chunk_sums(v, L.seg, unused, rs);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = y0 + L.slot + r * L.step;
      const float fy = gy * (kpsoftmax::softmax_exp(rs[r], inv_t, m) * inv_y) *
                       (ys(y) - ey);
      v[r] = make_float4(fx[0] + fy, fx[1] + fy, fx[2] + fy, fx[3] + fy);
    }
    store_chunk<R, kQuad>(o, h, w, y0, L, v);
  }
}

// dh = p (gx (u - ex) + gy (v - ey)) / T, p = exp(h/T - max) / sum: a
// heatmap of one chunk is written from the exps joint_stats left in
// registers; above one chunk a third pass reads it again.
template <int R, bool kQuad>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
joint_bwd(const float* __restrict__ in, const float* __restrict__ kp,
          const float* __restrict__ g, float* __restrict__ out, int n_rows,
          int h, int w, float inv_t, bool align) {
  const long long row = warp_heatmap(n_rows);
  if (row < 0) return;
  const WarpRows L = warp_rows(w, threadIdx.x % kWarp);
  const float* p = in + row * h * w;
  float* o = out + row * h * w;
  float4 v[R];
  float m, cs[4], sy;
  joint_stats<R, kQuad>(p, h, w, inv_t, align, L, v, m, cs, sy);
  float s[1] = {(cs[0] + cs[1]) + (cs[2] + cs[3])};
  lanes_sum(s, 1, kWarp);
  const float inv_s = 1.0f / s[0];
  const float ex = kp[2 * row], ey = kp[2 * row + 1];
  const float gx = g[2 * row] * inv_t, gy = g[2 * row + 1] * inv_t;
  const Axis xs = axis(w, align);
  const Axis ys = axis(h, align);
  float du[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) du[i] = gx * (xs(4 * L.quad + i) - ex);
  const int rows = R * L.step;
  for (int y0 = 0; y0 < h; y0 += rows) {     // uniform across the warp
    if (h > rows) {                          // the chunk's exps again
      float unused[4] = {0.0f, 0.0f, 0.0f, 0.0f}, unused_y = 0.0f;
      load_chunk<R, kQuad>(p, h, w, y0, L, v);
      chunk_exp(v, y0, h, w, L, inv_t, m, align, unused, unused_y);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dv = gy * (ys(y0 + L.slot + r * L.step) - ey);
      v[r] = make_float4(v[r].x * inv_s * (du[0] + dv),
                         v[r].y * inv_s * (du[1] + dv),
                         v[r].z * inv_s * (du[2] + dv),
                         v[r].w * inv_s * (du[3] + dv));
    }
    store_chunk<R, kQuad>(o, h, w, y0, L, v);
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

// The warp-path kernel of a variant, chunk and load width, launched.
template <int R, bool kQuad>
void warp_fwd(int variant, int n, cudaStream_t s, const float* x, float* o,
              int h, int w, float inv_t, bool align) {
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock),
      block(kWarpsPerBlock * kWarp);
  if (variant == 0)
    joint_fwd<R, kQuad><<<grid, block, 0, s>>>(x, o, n, h, w, inv_t, align);
  else
    marginal_fwd<R, kQuad><<<grid, block, 0, s>>>(x, o, n, h, w, inv_t, align);
}

template <int R, bool kQuad>
void warp_bwd(int variant, int n, cudaStream_t s, const float* x,
              const float* k, const float* d, float* o, int h, int w,
              float inv_t, bool align) {
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock),
      block(kWarpsPerBlock * kWarp);
  if (variant == 0)
    joint_bwd<R, kQuad><<<grid, block, 0, s>>>(x, k, d, o, n, h, w, inv_t,
                                               align);
  else
    marginal_bwd<R, kQuad><<<grid, block, 0, s>>>(x, k, d, o, n, h, w, inv_t,
                                                  align);
}

}  // namespace

// variant: 0 = joint, 1 = marginal. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int kp_spatial_softmax_fwd(int variant, int n, int h, int w,
                                      float inv_t, int align_corners,
                                      const void* heatmaps, void* out,
                                      void* stream) {
  if (bad_shape(variant, n, h, w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
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
    return static_cast<int>(cudaGetLastError());
  }
  const bool quad = quad_ok(w, x);
  if (kpsoftmax::warp_chunk(h, w) == kpsoftmax::kSmallChunk) {
    if (quad)
      warp_fwd<kpsoftmax::kSmallChunk, true>(variant, n, s, x, o, h, w,
                                             inv_t, align);
    else
      warp_fwd<kpsoftmax::kSmallChunk, false>(variant, n, s, x, o, h,
                                              w, inv_t, align);
  } else if (quad) {
    warp_fwd<kpsoftmax::kChunk, true>(variant, n, s, x, o, h, w, inv_t,
                                      align);
  } else {
    warp_fwd<kpsoftmax::kChunk, false>(variant, n, s, x, o, h, w, inv_t,
                                       align);
  }
  return static_cast<int>(cudaGetLastError());
}

// dL/dheatmaps from the heatmaps, the forward's keypoints and dL/dkeypoints,
// all f32 and contiguous. Same conventions as kp_spatial_softmax_fwd.
extern "C" int kp_spatial_softmax_bwd(int variant, int n, int h, int w,
                                      float inv_t, int align_corners,
                                      const void* heatmaps, const void* kp,
                                      const void* g, void* out,
                                      void* stream) {
  if (bad_shape(variant, n, h, w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
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
    return static_cast<int>(cudaGetLastError());
  }
  const bool quad = quad_ok(w, x) && quad_ok(w, o);
  if (kpsoftmax::warp_chunk(h, w) == kpsoftmax::kSmallChunk) {
    if (quad)
      warp_bwd<kpsoftmax::kSmallChunk, true>(variant, n, s, x, k, d, o,
                                             h, w, inv_t, align);
    else
      warp_bwd<kpsoftmax::kSmallChunk, false>(variant, n, s, x, k, d,
                                              o, h, w, inv_t, align);
  } else if (quad) {
    warp_bwd<kpsoftmax::kChunk, true>(variant, n, s, x, k, d, o, h, w,
                                      inv_t, align);
  } else {
    warp_bwd<kpsoftmax::kChunk, false>(variant, n, s, x, k, d, o, h, w,
                                       inv_t, align);
  }
  return static_cast<int>(cudaGetLastError());
}
