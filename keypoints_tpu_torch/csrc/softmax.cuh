// Soft-argmax device functions shared by the soft-argmax kernels
// (spatial_softmax.cu, K1 and K1b) and the fused bottleneck
// (fused_bottleneck.cu, K3), so that K3's keypoints are K1's to the bit.
// Two paths, chosen by the heatmap's size:
//  * warp per row, H and W at most 64: one warp holds one (h, w) heatmap,
//    lane x reads columns x and x + 32, and every loop over y is uniform
//    across the warp;
//  * block per heatmap, H or W above 64: one block of kBlock threads strides
//    over the heatmap (block_* below), with block-level reductions through
//    shared memory in a fixed order, so the result does not change from run
//    to run.
// Header only; every .cu that includes it gets its own internal copy.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace kpsoftmax {

using kpcommon::axis_coord;
using kpcommon::kFull;
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

// ---- block per heatmap: H or W above 64 ---------------------------------

constexpr int kBlock = 256;                  // threads of a block-path kernel
constexpr int kBlockWarps = kBlock / kWarp;
// H + W of a wide marginal heatmap: its column and row sums live in shared
// memory (16 KB), beside K3's coordinate table (16 KB at most)
constexpr int kMaxSums = 4096;

// The H, W the block path takes (the warp path takes the rest).
__host__ __device__ __forceinline__ bool wide(int h, int w) {
  return h > kMaxSide || w > kMaxSide;
}

// Dynamic shared memory, in floats, that a block-path kernel of this
// variant needs for its row and column sums: H + W (marginal), 0 (joint).
inline int sums_floats(int variant, int h, int w) {
  return variant == 1 ? h + w : 0;
}

struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};
struct Sum {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};

// Reduces each of v[0..N) over the block; every thread gets the results.
// The warps' partials are combined in warp order, so the result is the same
// on every thread and in every run. `scratch`: N * kBlockWarps floats of
// shared memory, free again on return.
template <int N, typename Op>
__device__ __forceinline__ void block_reduce(float (&v)[N], float* scratch,
                                             Op op) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      v[i] = op(v[i], __shfl_xor_sync(kFull, v[i], o));
    if (lane == 0) scratch[i * kBlockWarps + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float r = scratch[i * kBlockWarps];
    for (int j = 1; j < kBlockWarps; ++j) r = op(r, scratch[i * kBlockWarps + j]);
    v[i] = r;
  }
  __syncthreads();
}

// How a block's threads cover one (h, w) heatmap: columns x0, x0 + xstep, ...
// below w and, for each, rows y0, y0 + ystep, ... below h. Above kBlock / 2
// columns a thread takes whole columns; below, the block splits the rows
// into kBlock / w groups, thread t taking column t % w of group t / w. A
// warp's loads at one step of both loops are contiguous either way.
struct Tiling {
  int x0, xstep, y0, ystep;
};

__device__ __forceinline__ Tiling tiling(int w) {
  const int t = threadIdx.x;
  const int groups = kBlock / w;
  if (groups <= 1) return {t, kBlock, 0, 1};
  if (t >= groups * w) return {w, w, 0, groups};    // no column
  return {t % w, w, t / w, groups};
}

// Up to kMaxQuadWidth columns, W a multiple of 4 and the map 16-byte
// aligned (every wide preset override: 96^2, 128^2): the block reads rows
// as float4 quads, `seg` lanes a row (the power of 2 at or above W / 4) and
// kWarp / seg rows a warp at a time, so one read gives a lane four column
// sums and its row's sum is a reduction within its segment of lanes.
constexpr int kMaxQuadWidth = 128;
// `part` floats a block-path kernel holds: a column partial for each of the
// block's row slots, at most kBlock * 4 (kBlock slots of W = 4, or 8 of 128)
constexpr int kPart = 4 * kBlock;

__device__ __forceinline__ bool quad_ok(int w, const void* p) {
  return w % 4 == 0 && w <= kMaxQuadWidth &&
         reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

struct Quads {
  int seg;   // lanes a row: a power of 2, W / 4 <= seg <= kWarp
  int quad;  // this lane's quad of its row
  int slot;  // this lane's row slot in the block; rows slot, slot + rows, ...
  int rows;  // row slots of the block: kBlockWarps * kWarp / seg
  bool on;   // quad < W / 4
};

__device__ __forceinline__ Quads quads(int w) {
  int seg = 1;
  while (seg < w / 4) seg <<= 1;
  const int lane = threadIdx.x % kWarp;
  const int per_warp = kWarp / seg;
  return {seg, lane % seg, (threadIdx.x / kWarp) * per_warp + lane / seg,
          kBlockWarps * per_warp, lane % seg < w / 4};
}

__device__ __forceinline__ float4 load_quad(const float* __restrict__ p,
                                            int w, int y, int quad) {
  return __ldg(reinterpret_cast<const float4*>(p + static_cast<size_t>(y) * w) +
               quad);
}

// Sum over the `seg` lanes of this lane's aligned segment (seg a power of 2).
__device__ __forceinline__ float segment_sum(float v, int seg) {
  for (int o = seg / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// block_marginal_sums on quads: one read. The column partials of each row
// slot meet in `part` and are summed in slot order.
__device__ __forceinline__ void quad_marginal_sums(const float* __restrict__ p,
                                                   int h, int w, float* col,
                                                   float* row, float* part) {
  const Quads qd = quads(w);
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int y0 = 0; y0 < h; y0 += qd.rows) {  // uniform across the block
    const int y = y0 + qd.slot;
    const bool ok = y < h && qd.on;
    const float4 v = ok ? load_quad(p, w, y, qd.quad) : make_float4(0, 0, 0, 0);
    c[0] += v.x;
    c[1] += v.y;
    c[2] += v.z;
    c[3] += v.w;
    const float r = segment_sum((v.x + v.y) + (v.z + v.w), qd.seg);
    if (qd.quad == 0 && y < h) row[y] = r;
  }
  if (qd.on)
    for (int i = 0; i < 4; ++i) part[qd.slot * w + 4 * qd.quad + i] = c[i];
  __syncthreads();
  for (int x = threadIdx.x; x < w; x += kBlock) {
    float s = 0.0f;
    for (int j = 0; j < qd.rows; ++j) s += part[j * w + x];
    col[x] = s;
  }
  __syncthreads();
}

// Column sums col[0..w) and row sums row[0..h) of one (h, w) heatmap into
// shared memory. On quads (quad_marginal_sums) or else: the columns by the
// tiling (with row groups, their partial sums meet in `part` in group
// order), the rows a warp a row; that second read mostly hits L1.
// Synchronises before returning.
__device__ __forceinline__ void block_marginal_sums(const float* __restrict__ p,
                                                    int h, int w, float* col,
                                                    float* row, float* part) {
  if (quad_ok(w, p)) {
    quad_marginal_sums(p, h, w, col, row, part);
    return;
  }
  const int groups = kBlock / w;
  const Tiling tl = tiling(w);
  for (int x = tl.x0; x < w; x += tl.xstep) {
    float s = 0.0f;
    for (int y = tl.y0; y < h; y += tl.ystep)
      s += __ldg(p + static_cast<size_t>(y) * w + x);
    if (groups > 1)
      part[threadIdx.x] = s;
    else
      col[x] = s;
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int y = warp; y < h; y += kBlockWarps) {
    const float* r = p + static_cast<size_t>(y) * w;
    float s = 0.0f;
    for (int x = lane; x < w; x += kWarp) s += __ldg(r + x);
    s = warp_sum(s);
    if (lane == 0) row[y] = s;
  }
  __syncthreads();
  if (groups > 1) {                          // uniform across the block
    for (int x = threadIdx.x; x < w; x += kBlock) {
      float s = 0.0f;
      for (int g = 0; g < groups; ++g) s += part[g * w + x];
      col[x] = s;
    }
    __syncthreads();
  }
}

// The softmaxes of inv_t * col[0..w) and inv_t * row[0..h) (max subtracted
// first): their maxima m[0], m[1] and sums of exp s[0], s[1], on every
// thread.
__device__ __forceinline__ void block_axis_softmax(const float* col, int w,
                                                   const float* row, int h,
                                                   float inv_t, float* scratch,
                                                   float (&m)[2],
                                                   float (&s)[2]) {
  m[0] = m[1] = -CUDART_INF_F;
  for (int i = threadIdx.x; i < w; i += kBlock) m[0] = fmaxf(m[0], col[i] * inv_t);
  for (int i = threadIdx.x; i < h; i += kBlock) m[1] = fmaxf(m[1], row[i] * inv_t);
  block_reduce(m, scratch, Max());
  s[0] = s[1] = 0.0f;
  for (int i = threadIdx.x; i < w; i += kBlock) s[0] += expf(col[i] * inv_t - m[0]);
  for (int i = threadIdx.x; i < h; i += kBlock) s[1] += expf(row[i] * inv_t - m[1]);
  block_reduce(s, scratch, Sum());
}

// Marginal soft-argmax (x, y) of one wide heatmap, on every thread: the
// softmaxes of the column and row sums (in `col`, `row`) and their
// expectations. `scratch`: 2 * kBlockWarps floats.
__device__ __forceinline__ void block_marginal_keypoint(
    const float* __restrict__ p, int h, int w, float inv_t, bool align,
    float* col, float* row, float* part, float* scratch, float& ex,
    float& ey) {
  block_marginal_sums(p, h, w, col, row, part);
  float m[2], s[2];
  block_axis_softmax(col, w, row, h, inv_t, scratch, m, s);
  float c[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < w; i += kBlock)
    c[0] += expf(col[i] * inv_t - m[0]) * axis_coord(i, w, align);
  for (int i = threadIdx.x; i < h; i += kBlock)
    c[1] += expf(row[i] * inv_t - m[1]) * axis_coord(i, h, align);
  block_reduce(c, scratch, Sum());
  ex = c[0] / s[0];
  ey = c[1] / s[1];
}

// Max of h/T over one wide heatmap, on every thread.
__device__ __forceinline__ float block_joint_max(const float* __restrict__ p,
                                                 int h, int w, float inv_t,
                                                 float* scratch) {
  float m[1] = {-CUDART_INF_F};
  if (quad_ok(w, p)) {
    const Quads qd = quads(w);
#pragma unroll 4
    for (int y = qd.slot; y < h; y += qd.rows) {
      if (!qd.on) continue;
      const float4 v = load_quad(p, w, y, qd.quad);
      m[0] = fmaxf(fmaxf(fmaxf(m[0], v.x * inv_t), v.y * inv_t),
                   fmaxf(v.z * inv_t, v.w * inv_t));
    }
  } else {
    const Tiling tl = tiling(w);
    for (int x = tl.x0; x < w; x += tl.xstep)
      for (int y = tl.y0; y < h; y += tl.ystep)
        m[0] = fmaxf(m[0], __ldg(p + static_cast<size_t>(y) * w + x) * inv_t);
  }
  block_reduce(m, scratch, Max());
  return m[0];
}

// Joint soft-argmax (x, y) of one wide heatmap, on every thread: pass 1
// takes the max of h/T, pass 2 sums exp(h/T - max) and its x- and
// y-weighted sums (the second read mostly hits L1). `scratch`:
// 3 * kBlockWarps floats.
__device__ __forceinline__ void block_joint_keypoint(
    const float* __restrict__ p, int h, int w, float inv_t, bool align,
    float* scratch, float& ex, float& ey) {
  const float m = block_joint_max(p, h, w, inv_t, scratch);
  float v[3] = {0.0f, 0.0f, 0.0f};           // sum of e, e * u, e * v
  if (quad_ok(w, p)) {
    const Quads qd = quads(w);
    float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int y = qd.slot; y < h; y += qd.rows) {
      if (!qd.on) continue;
      const float4 q = load_quad(p, w, y, qd.quad);
      const float e0 = expf(q.x * inv_t - m), e1 = expf(q.y * inv_t - m);
      const float e2 = expf(q.z * inv_t - m), e3 = expf(q.w * inv_t - m);
      cs[0] += e0;
      cs[1] += e1;
      cs[2] += e2;
      cs[3] += e3;
      v[2] += ((e0 + e1) + (e2 + e3)) * axis_coord(y, h, align);
    }
    for (int i = 0; i < 4; ++i) {
      v[0] += cs[i];
      v[1] += cs[i] * axis_coord(4 * qd.quad + i, w, align);
    }
  } else {
    const Tiling tl = tiling(w);
    for (int x = tl.x0; x < w; x += tl.xstep) {
      float cs = 0.0f, cy = 0.0f;
      for (int y = tl.y0; y < h; y += tl.ystep) {
        const float e = expf(__ldg(p + static_cast<size_t>(y) * w + x) * inv_t - m);
        cs += e;
        cy += e * axis_coord(y, h, align);
      }
      v[0] += cs;
      v[1] += cs * axis_coord(x, w, align);
      v[2] += cy;
    }
  }
  block_reduce(v, scratch, Sum());
  ex = v[1] / v[0];
  ey = v[2] / v[0];
}

// 0 = joint, 1 = marginal. The warp path takes H, W <= 64; the block path
// any larger H or W, the marginal variant with H + W <= kMaxSums.
inline bool bad_shape(int variant, int n, int h, int w) {
  if (n < 0 || h < 1 || w < 1 || (variant != 0 && variant != 1)) return true;
  return wide(h, w) && variant == 1 && h + w > kMaxSums;
}

}  // namespace kpsoftmax
