// Soft-argmax device functions shared by the soft-argmax kernels
// (spatial_softmax.cu, K1 and K1b) and the fused bottleneck
// (fused_bottleneck.cu, K3), so that K3's keypoints are K1's to the bit.
// Two paths, chosen by the heatmap's size:
//  * warp per heatmap, H and W at most 64: one warp holds one (h, w)
//    heatmap in registers. A row is ceil(w / 4) quads of 4 columns; lane l
//    takes quad l % seg of its row (seg, the row's lanes: the power of 2 at
//    or above its quads) and rows l / seg, l / seg + 32 / seg, ... A 32-wide
//    row is 8 lanes, so one warp load covers 4 rows: a 32^2 heatmap is 8
//    loads a lane, a 16^2 one 2. Where w % 4 == 0 and the map is 16-byte
//    aligned (every preset), a quad is one float4 load, else four scalar
//    loads of the same columns. A lane issues its loads in chunks of 2 or 8
//    (a template parameter), all before any reduction; a heatmap of more
//    than 8 loads a lane (e.g. 64^2: 32) takes several chunks and one pass
//    over the map for each of the softmax's steps (the later ones hit L1).
//    A row's sum is a butterfly within its segment of lanes, a column's the
//    lane's partials over its rows, then a butterfly across the row slots;
//    the 1-D softmaxes then run on sums held 4 (columns) or a chunk's worth
//    (rows) a lane. Instructions, not bytes, set the pace at the presets'
//    sizes, so an exp is the exp2 unit on one fused multiply-add, a
//    coordinate is a + b i (one division an axis), maxima are trees and
//    masked entries are selected, not branched round;
//  * block per heatmap, H or W above 64: one block of kBlock threads strides
//    over the heatmap (block_* below), with block-level reductions through
//    shared memory in a fixed order.
// Every reduction has a fixed order and none uses float atomics, so every
// lane gets the same bits and two calls give equal bits.
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
using kpcommon::warp_sum;

// ---- warp per heatmap: H and W at most 64 --------------------------------

constexpr int kMaxSide = 2 * kWarp;        // the warp path's largest H and W
// Loads a lane makes a chunk: kSmallChunk for a heatmap of at most that many
// loads a lane (16^2 and smaller), kChunk for the rest
constexpr int kSmallChunk = 2;
constexpr int kChunk = 8;
// Warps (heatmaps) a block of the warp-path kernels: 2 gives N = 256 (the
// Transporter's bottleneck) 128 blocks over the H100's 132 SMs. Of 1, 2, 4
// and 8, none was fastest at every preset's heatmaps (PERF.md).
constexpr int kWarpsPerBlock = 2;

// Lanes a row of w columns takes: the power of 2 at or above its ceil(w / 4)
// quads of 4 columns (at most 16 up to 64 columns).
__host__ __device__ __forceinline__ int row_lanes(int w) {
  int seg = 1;
  while (4 * seg < w) seg <<= 1;
  return seg;
}

// Loads a lane makes for one (h, w) heatmap on the warp path.
__host__ __device__ __forceinline__ int warp_loads(int h, int w) {
  const int step = kWarp / row_lanes(w);
  return (h + step - 1) / step;
}

// The chunk a warp-path kernel instantiates for an (h, w) heatmap.
inline int warp_chunk(int h, int w) {
  return warp_loads(h, w) <= kSmallChunk ? kSmallChunk : kChunk;
}

// Where a lane of the warp sits in the heatmap: columns 4 quad .. 4 quad + 3
// of rows slot, slot + step, ...
struct WarpRows {
  int seg;   // lanes a row (row_lanes)
  int step;  // rows one warp load covers: kWarp / seg
  int quad;  // lane % seg
  int slot;  // lane / seg
};

__device__ __forceinline__ WarpRows warp_rows(int w, int lane) {
  const int seg = row_lanes(w);
  return {seg, kWarp / seg, lane % seg, lane / seg};
}

// The heatmap of this thread's warp in a block of warps, one heatmap each,
// or -1 past the last of n (uniform across the warp).
__device__ __forceinline__ long long warp_heatmap(int n) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
      threadIdx.x / kWarp;
  return row < n ? row : -1;
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The coordinates of an axis of n pixels as a + b i: axis_coord's values
// (to within a rounding) for one division an axis instead of one a pixel.
struct Axis {
  float a, b;
  __device__ __forceinline__ float operator()(int i) const {
    return fmaf(b, static_cast<float>(i), a);
  }
};

__device__ __forceinline__ Axis axis(int n, bool align) {
  if (align)
    return n > 1 ? Axis{-1.0f, 2.0f / static_cast<float>(n - 1)}
                 : Axis{0.0f, 0.0f};
  const float inv = 1.0f / static_cast<float>(n);
  return {inv - 1.0f, 2.0f * inv};
}

// exp(a * inv_t - m) as exp2(a * inv_t log2(e) - m log2(e)): one fused
// multiply-add and the exp2 unit.
__device__ __forceinline__ float softmax_exp(float a, float inv_t, float m) {
  constexpr float kLog2e = 1.44269504088896341f;
  return exp2f(fmaf(a, inv_t * kLog2e, -m * kLog2e));
}

// softmax_exp where `in`, else 0: computed either way, then selected, so
// that no branch goes round it.
__device__ __forceinline__ float softmax_exp_if(bool in, float a, float inv_t,
                                                float m) {
  const float e = softmax_exp(a, inv_t, m);
  return in ? e : 0.0f;
}

// The max of v[0..N) as a tree, so the comparisons do not wait on each
// other in a chain.
template <int N>
__device__ __forceinline__ float tree_max(float (&v)[N]) {
#pragma unroll
  for (int s = 1; s < N; s <<= 1)
#pragma unroll
    for (int i = 0; i + s < N; i += 2 * s) v[i] = fmaxf(v[i], v[i + s]);
  return v[0];
}

// Butterflies over the lanes whose indices differ only in the bits from lo
// up to hi: (1, seg) within a segment of a row's lanes, (seg, kWarp) across
// the row slots, (1, kWarp) over the warp. All N values shuffle at each
// level together; the order is fixed, so every lane gets the same bits.
template <int N>
__device__ __forceinline__ void lanes_sum(float (&v)[N], int lo, int hi) {
  for (int o = lo; o < hi; o <<= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
}

__device__ __forceinline__ float lanes_max(float v, int lo, int hi) {
  for (int o = lo; o < hi; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One chunk of a heatmap: load r of the lane reads its quad of row
// y0 + slot + r * step. All R loads are issued before any use; entries
// outside the heatmap read as 0. kQuad: one float4 (w % 4 == 0 and the map
// 16-byte aligned); else four scalar loads of the same columns.
template <int R, bool kQuad>
__device__ __forceinline__ void load_chunk(const float* __restrict__ p, int h,
                                           int w, int y0, const WarpRows& L,
                                           float4 (&v)[R]) {
  const int x = 4 * L.quad;
  if (kQuad) {
    const int w4 = w / 4;
    const float4* q = reinterpret_cast<const float4*>(p) + L.quad;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = y0 + L.slot + r * L.step;
      v[r] = y < h && x < w ? __ldg(q + y * w4)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = y0 + L.slot + r * L.step;
      const float* q = p + y * w + x;
      const bool ok = y < h;
      v[r].x = ok && x < w ? __ldg(q) : 0.0f;
      v[r].y = ok && x + 1 < w ? __ldg(q + 1) : 0.0f;
      v[r].z = ok && x + 2 < w ? __ldg(q + 2) : 0.0f;
      v[r].w = ok && x + 3 < w ? __ldg(q + 3) : 0.0f;
    }
  }
}

// Marginal: adds the chunk to the lane's 4 column partials c and puts its
// rows' sums in rs (rs[r]: row y0 + slot + r * step, on every lane of the
// row's segment).
template <int R>
__device__ __forceinline__ void chunk_sums(const float4 (&v)[R], int seg,
                                           float (&c)[4], float (&rs)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c[0] += v[r].x;
    c[1] += v[r].y;
    c[2] += v[r].z;
    c[3] += v[r].w;
    rs[r] = (v[r].x + v[r].y) + (v[r].z + v[r].w);
  }
  lanes_sum(rs, 1, seg);
}

// Max of m and inv_t * rs over the chunk's rows below h.
template <int R>
__device__ __forceinline__ float rows_max(const float (&rs)[R], int y0, int h,
                                          const WarpRows& L, float inv_t,
                                          float m) {
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    v[r] = y0 + L.slot + r * L.step < h ? rs[r] * inv_t : -CUDART_INF_F;
  return fmaxf(m, tree_max(v));
}

// Adds exp(inv_t * rs - m) (t[0]) and that times the row's coordinate (t[1])
// over the chunk's rows below h.
template <int R>
__device__ __forceinline__ void rows_exp(const float (&rs)[R], int y0, int h,
                                         const WarpRows& L, float inv_t,
                                         float m, bool align, float (&t)[2]) {
  const Axis ys = axis(h, align);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + L.slot + r * L.step;
    const float e = softmax_exp_if(y < h, rs[r], inv_t, m);
    t[0] += e;
    t[1] += e * ys(y);
  }
}

// The softmax of inv_t * c over the columns 4 quad + i < w, held 4 a lane
// on the lanes of each segment (every segment holds the same): e[i] =
// exp(inv_t c[i] - max), 0 past w; on every lane the sum s of e and the sum
// sc of e times the column's coordinate.
__device__ __forceinline__ void column_softmax(const float (&c)[4], int w,
                                               const WarpRows& L, float inv_t,
                                               bool align, float (&e)[4],
                                               float& s, float& sc) {
  float m = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * L.quad + i < w) m = fmaxf(m, c[i] * inv_t);
  m = lanes_max(m, 1, L.seg);
  const Axis xs = axis(w, align);
  float t[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x = 4 * L.quad + i;
    e[i] = softmax_exp_if(x < w, c[i], inv_t, m);
    t[0] += e[i];
    t[1] += e[i] * xs(x);
  }
  lanes_sum(t, 1, L.seg);
  s = t[0];
  sc = t[1];
}

// The marginal softmax statistics of one heatmap, on every lane: the column
// sums c (the lane's 4 columns), the column softmax (e, s, sc as
// column_softmax), and the row softmax's max m and sums t (t[0] of exp,
// t[1] of exp times the row's coordinate). The rows of a heatmap of one
// chunk stay in rs; above one chunk, the rows are summed again in a second
// pass (it hits L1).
template <int R, bool kQuad>
__device__ __forceinline__ void marginal_stats(
    const float* __restrict__ p, int h, int w, float inv_t, bool align,
    const WarpRows& L, float (&rs)[R], float (&e)[4], float& s, float& sc,
    float& m, float (&t)[2]) {
  const int rows = R * L.step;               // rows a chunk
  float4 v[R];
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  m = -CUDART_INF_F;
  for (int y0 = 0; y0 < h; y0 += rows) {     // uniform across the warp
    load_chunk<R, kQuad>(p, h, w, y0, L, v);
    chunk_sums(v, L.seg, c, rs);
    m = rows_max(rs, y0, h, L, inv_t, m);
  }
  lanes_sum(c, L.seg, kWarp);
  column_softmax(c, w, L, inv_t, align, e, s, sc);
  m = lanes_max(m, L.seg, kWarp);
  t[0] = t[1] = 0.0f;
  if (h <= rows) {
    rows_exp(rs, 0, h, L, inv_t, m, align, t);
  } else {
    for (int y0 = 0; y0 < h; y0 += rows) {
      float unused[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      load_chunk<R, kQuad>(p, h, w, y0, L, v);
      chunk_sums(v, L.seg, unused, rs);
      rows_exp(rs, y0, h, L, inv_t, m, align, t);
    }
  }
  lanes_sum(t, L.seg, kWarp);
}

// Marginal soft-argmax (x, y) of one heatmap, on every lane: the softmaxes
// of the column and row sums and their expectations.
template <int R, bool kQuad>
__device__ __forceinline__ void marginal_keypoint(const float* __restrict__ p,
                                                  int h, int w, float inv_t,
                                                  bool align, int lane,
                                                  float& ex, float& ey) {
  const WarpRows L = warp_rows(w, lane);
  float rs[R], e[4], s, sc, m, t[2];
  marginal_stats<R, kQuad>(p, h, w, inv_t, align, L, rs, e, s, sc, m, t);
  ex = sc / s;
  ey = t[1] / t[0];
}

// Joint: max of m and inv_t * v over the chunk's entries inside the heatmap.
template <int R>
__device__ __forceinline__ float chunk_max(const float4 (&v)[R], int y0, int h,
                                           int w, const WarpRows& L,
                                           float inv_t, float m) {
  float mr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool row = y0 + L.slot + r * L.step < h;
    float q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = row && 4 * L.quad + i < w ? component(v[r], i) * inv_t
                                       : -CUDART_INF_F;
    mr[r] = tree_max(q);
  }
  return fmaxf(m, tree_max(mr));
}

// Joint: replaces each entry of the chunk by e = exp(inv_t v - m) (0
// outside the heatmap), adds e to the lane's column sums cs and e times the
// row's coordinate to sy.
template <int R>
__device__ __forceinline__ void chunk_exp(float4 (&v)[R], int y0, int h, int w,
                                          const WarpRows& L, float inv_t,
                                          float m, bool align, float (&cs)[4],
                                          float& sy) {
  const Axis ys = axis(h, align);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + L.slot + r * L.step;
    const bool row = y < h;
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = softmax_exp_if(row && 4 * L.quad + i < w, component(v[r], i),
                            inv_t, m);
      cs[i] += e[i];
    }
    v[r] = make_float4(e[0], e[1], e[2], e[3]);
    sy += ((e[0] + e[1]) + (e[2] + e[3])) * ys(y);   // 0 past the last row
  }
}

// The joint softmax of one heatmap: its max m on every lane, and the lane's
// sums of exp(inv_t h - m) by column (cs) and times the row's coordinate
// (sy). A heatmap of one chunk is left in v as exp(inv_t h - m); above one
// chunk the max takes one pass and the sums a second (it hits L1).
template <int R, bool kQuad>
__device__ __forceinline__ void joint_stats(const float* __restrict__ p, int h,
                                            int w, float inv_t, bool align,
                                            const WarpRows& L, float4 (&v)[R],
                                            float& m, float (&cs)[4],
                                            float& sy) {
  const int rows = R * L.step;
  m = -CUDART_INF_F;
  for (int y0 = 0; y0 < h; y0 += rows) {     // uniform across the warp
    load_chunk<R, kQuad>(p, h, w, y0, L, v);
    m = chunk_max(v, y0, h, w, L, inv_t, m);
  }
  m = lanes_max(m, 1, kWarp);
  cs[0] = cs[1] = cs[2] = cs[3] = sy = 0.0f;
  if (h <= rows) {
    chunk_exp(v, 0, h, w, L, inv_t, m, align, cs, sy);
  } else {
    for (int y0 = 0; y0 < h; y0 += rows) {
      load_chunk<R, kQuad>(p, h, w, y0, L, v);
      chunk_exp(v, y0, h, w, L, inv_t, m, align, cs, sy);
    }
  }
}

// Joint soft-argmax (x, y) of one heatmap, on every lane: the sums of
// exp(h/T - max), times x and times y, over the warp.
template <int R, bool kQuad>
__device__ __forceinline__ void joint_keypoint(const float* __restrict__ p,
                                               int h, int w, float inv_t,
                                               bool align, int lane,
                                               float& ex, float& ey) {
  const WarpRows L = warp_rows(w, lane);
  float4 v[R];
  float m, cs[4], sy;
  joint_stats<R, kQuad>(p, h, w, inv_t, align, L, v, m, cs, sy);
  const Axis xs = axis(w, align);
  float t[3] = {(cs[0] + cs[1]) + (cs[2] + cs[3]), 0.0f, sy};
#pragma unroll
  for (int i = 0; i < 4; ++i) t[1] += cs[i] * xs(4 * L.quad + i);
  lanes_sum(t, 1, kWarp);
  ex = t[1] / t[0];
  ey = t[2] / t[0];
}

// ---- block per heatmap: H or W above 64 ---------------------------------

constexpr int kBlock = 256;                  // threads of a block-path kernel
constexpr int kBlockWarps = kBlock / kWarp;
// H + W of a wide marginal heatmap: its column and row sums live in shared
// memory (16 KB), beside K3's coordinate table
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

__host__ __device__ __forceinline__ bool quad_ok(int w, const void* p) {
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
