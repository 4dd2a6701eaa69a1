// Bilinear warps on Hopper, forward only, image (B, C, H, W) f32 or bf16 ->
// (B, C, Ho, Wo) in the image's dtype:
//   warp_bilinear  at a dense grid (B, Ho, Wo, 2) f32, (x, y) in [-1, 1]
//   warp_field     at a coarse field (B, F, F, 2) f32, upsampled per output
//                  pixel; the dense grid never exists
//
// warp_bilinear replaces keypoints_tpu/kernels/warp_pallas.py:447
// warp_bilinear_pallas (K4; _warp_kernel :93, index math _grid_math :63).
// It computes exactly torch.nn.functional.grid_sample in bilinear mode with
// padding_mode zeros or border and an explicit align_corners: the corner,
// clip and zero-weight rules of _grid_math and of
// keypoints_tpu/ops/warp.py:85-110. Index and weight arithmetic is f32
// whatever the image's dtype; the four-corner sum is taken in f32 and
// rounded once to the output dtype (round to nearest even for bf16), as the
// Pallas kernel casts its f32 result at :202.
//
// warp_field replaces warp_pallas.py:390 warp_field_pallas (K5; kernel
// _warp_field_kernel :237). It computes upsample_field_aligned(field, Ho,
// Wo) followed by grid_sample: the field is lerped along H, then along W,
// with the align_corners=True positions i * (F - 1) / (n - 1), each product
// and sum rounded on its own as PyTorch computes the upsample, so the grid
// point it samples at is the plain version's to the bit. (The Pallas kernel
// lerps W first; JAX's own test allows 1e-4 for that at 256^2.) Both
// kernels weigh the corners with sampler.cuh's corner math and sum, which
// the banded warps of warp_experimental.cu share too, so warp_field equals
// upsample_field_aligned + warp_bilinear bit for bit (checked on an H100 in
// f32 and bf16, both paddings, both align_corners, at the presets' and
// ragged shapes).
//
// What bounds them: bytes. A warp reads its image once and writes C values
// per output pixel; warp_bilinear also reads 8 bytes of grid per pixel,
// warp_field 8 * F * F bytes of field per image. At the celeba128 train step
// (b128, 3 x 128^2 bf16) warp_bilinear moves 12.6 MB of image + 16.8 MB of
// grid + 12.6 MB of output = 42 MB, 12.5 us at 3.35 TB/s (f32: 67 MB, 20.0
// us), warp_field 26.3 MB, 7.9 us. At pose256's (b128, 3 x 256^2 bf16, F =
// 33) warp_field moves 50.3 + 1.1 + 50.3 = 101.8 MB, 30.4 us; upsampling to
// a dense grid and then warping would add 67.1 MB written and read again.
// In practice both are bound by instructions and their latency: ~100 a
// pixel (the corner math, 12 gathers, 12 widenings, the sums) against 12
// bytes moved (bf16, C = 3).
//
// Both run one tile body, warp_tile, which differs only in where a
// pixel's sample point comes from (kDense: read from the grid; else lerped
// from the field), so sampler.cuh's corners and blend are the only corner
// math of both and their results agree to the bit. A block of 256 threads
// takes a tile of one image, a thread pairs of neighbours along Wo (a
// warp's pass 2 rows x 32 columns): a 32 x 64 tile and four pairs a thread
// for the field, a 16 x 32 tile and one pair a thread for a dense grid
// (more blocks, fewer registers, no idle warp at an output 32 wide). All
// index math within an image is 32-bit: blockIdx.x carries the tile,
// blockIdx.y the image (at most 65535 a launch, the host launches again
// past them), and no thread divides a 64-bit index.
//  * The points first. warp_bilinear: a thread reads its pairs' points from
//    the grid before anything else, a pair as one 16-byte load where Wo is
//    even and the grid 16-byte aligned (else two 8-byte loads).
//    warp_field: each tile row's (r, fy) and column's (q, fx) go to shared
//    memory, then the field's first (H) lerp at each tile row for the field
//    columns the tile reaches; a pixel does only the second (W) lerp, with
//    the same rounded operations, so its point stays the upsample's to the
//    bit.
//  * warp_field's footprint next, where a budget allows staging: the
//    H-lerped values, which bound every point of the tile, give by a min
//    and max over the block, before any gather, the box of source pixels
//    the tile reads (a pixel wider on each side for rounding; NaN widens it
//    to the image). A box whose C planes fit the staging budget
//    (kernels/warp_cuda.py's STAGE_BYTES) is copied with 16-byte cp.async
//    into shared memory (rows of a whole number of chunks where W allows)
//    while the first pair's corners are computed, and the pairs gather from
//    there; a larger box, a budget of 0, and every warp_bilinear tile gather
//    from device memory through the read-only cache.
//  * A pair's C x 8 corner loads go out before its first store
//    (cuobjdump -sass of the bf16 field kernels, C = 3: 24 LDS.U16, or 24
//    LDG.E.U16, then the pair's stores, in each of the four pairs),
//    through eight corner pointers formed once and stepped a plane a
//    channel; each channel's pair is one bf16x2 (4-byte) or float2 (8-byte)
//    store where Wo is even, else two.
//  * Limits: H * W < 2^31 and fewer than 2^31 tiles an image (warp_bilinear:
//    any B; warp_field: Ho * Wo < 2^31, B <= 65535 and any F from 2 to
//    kMaxField: the tile's H-lerped field rows are the only field in shared
//    memory; over 48 KB in all, the launch opts in).
// Measured on an H100 (chip_smoke.py phases 9, 14 and 25, PERF.md): staged
// tiles beat direct gathers (stage_bytes = 0) for warp_field at b128 3 x
// 128^2 and 3 x 256^2 bf16 by 16 % and 23 %. warp_bilinear's direct 16 x 32
// tiles beat staged 32 x 64 ones in f32 and at the b128 3 x 32^2 bf16 grids
// the package sends it; staging won only at dense grids of 128^2 and more,
// which no path of the package sends, so warp_bilinear does not stage.
// The TPU kernels' y-window band, row-pair bf16 packing, tent y-select and
// 128-lane output chunks (warp_pallas.py:114-131, 188-201, 254-272) exist
// because Mosaic cannot gather along sublanes and VMEM holds only a band of
// rows; a CUDA gather reads any row, so none of them is needed and the
// result is grid_sample everywhere, at any Ho and Wo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "sampler.cuh"

namespace {

constexpr int kMaxField = 512;  // a tile's H-lerped field: <= 128 KB
constexpr int kMaxStageBytes = 96 * 1024;

// a * (1 - t) + b * t with each operation rounded on its own (no fused
// multiply-add), as upsample_field_aligned computes it in PyTorch.
__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, t)), __fmul_rn(b, t));
}

// Position `i` of an output axis on the field's axis of `f` points
// (align_corners=True): the lower field index and the fraction past it.
__device__ __forceinline__ int field_cell(int i, float scale, int f,
                                          float* frac) {
  const float pos = __fmul_rn(static_cast<float>(i), scale);
  const int k = min(max(static_cast<int>(floorf(pos)), 0), f - 2);
  *frac = __fsub_rn(pos, static_cast<float>(k));
  return k;
}

// The tile geometry: a block of kTileThreads (8 warps) warps a tile of one
// image; a warp's pass covers 2 rows x 32 columns (a lane a pair of
// neighbours along Wo), kWarpsX warps side by side, and a thread takes
// kTilePairs pairs, one a pass of the block. Field tiles are kTileRows x
// kTileCols (two warps across, kPairs pairs a thread, so a tile's set-up and
// staging serve 8 pixels a thread); dense-grid tiles are 16 x 32 (one warp
// across, one pair a thread: more blocks, fewer registers, and no idle warp
// at an output 32 wide).
constexpr int kTileThreads = 256;
constexpr int kPairs = 4;
constexpr int kTileRows = 32;
constexpr int kTileCols = 64;
constexpr int kLanesX = 16;  // a warp's lanes along a row
constexpr int kGroup = 3;    // channels whose gathers go out together

// Rows and columns of a tile of kTilePairs pairs a thread, kWarpsX warps
// across.
template <int kTilePairs_, int kWarpsX_>
struct Tile {
  static constexpr int kTilePairs = kTilePairs_;
  static constexpr int kWarpsX = kWarpsX_;
  static constexpr int kCols = 2 * kLanesX * kWarpsX;
  static constexpr int kPass = kTileThreads / 32 / kWarpsX * 2;
  static constexpr int kRows = kPass * kTilePairs;
};
// The tile of a dense grid (kDense) or of the field.
template <bool kDense>
using TileOf = Tile<kDense ? 1 : kPairs, kDense ? 1 : 2>;
static_assert(TileOf<false>::kRows == kTileRows &&
                  TileOf<false>::kCols == kTileCols,
              "the field's tile");

// One channel value of a corner: from device memory through the read-only
// cache, or from the tile's footprint in shared memory.
template <bool kShared>
__device__ __forceinline__ float fetch(const float* p) {
  if constexpr (kShared) return *p;
  return __ldg(p);
}

template <bool kShared>
__device__ __forceinline__ float fetch(const __nv_bfloat16* p) {
  const auto* q = reinterpret_cast<const unsigned short*>(p);
  if constexpr (kShared) return kpwarp::bf16_bits(*q);
  return kpwarp::bf16_bits(__ldg(q));
}

// Two neighbouring results of one channel: one 8-byte (f32) or 4-byte
// (bf16) store where both are live and `vec`, else one store each.
__device__ __forceinline__ void store_pair(float* p, float a, float b,
                                           int live, bool vec) {
  if (vec && live == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
    return;
  }
  if (live > 0) p[0] = a;
  if (live > 1) p[1] = b;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b,
                                           int live, bool vec) {
  if (vec && live == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    return;
  }
  if (live > 0) p[0] = __float2bfloat16_rn(a);
  if (live > 1) p[1] = __float2bfloat16_rn(b);
}

// A pixel pair's C channels from `base` (row stride `stride`, channel
// planes `plane` apart, origin (ox, oy) of the image): per group of kGroup
// channels all 8 gathers a channel, then K4's sum (sampler.cuh) and one
// pair store a channel. The eight corner pointers are formed once and
// stepped a plane a channel, and so is the output pointer.
template <typename T, bool kShared>
__device__ __forceinline__ void sample_pair(const T* base, int stride,
                                            long long plane, int ox, int oy,
                                            const kpwarp::Corners (&k)[2],
                                            int c, T* dst, long long per_image,
                                            int live, bool vec) {
  const T* a[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const T* r0 = base + (k[j].yi0 - oy) * stride - ox;
    const T* r1 = base + (k[j].yi1 - oy) * stride - ox;
    a[j][0] = r0 + k[j].xi0;
    a[j][1] = r0 + k[j].xi1;
    a[j][2] = r1 + k[j].xi0;
    a[j][3] = r1 + k[j].xi1;
  }
  for (int ch = 0; ch < c; ch += kGroup) {
    float v[kGroup][2][4];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (ch + g < c) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[g][j][q] = fetch<kShared>(a[j][q]);
            a[j][q] += plane;
          }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (ch + g < c) {
        store_pair(dst,
                   kpwarp::blend(k[0], v[g][0][0], v[g][0][1], v[g][0][2],
                                 v[g][0][3]),
                   kpwarp::blend(k[1], v[g][1][0], v[g][1][1], v[g][1][2],
                                 v[g][1][3]),
                   live, vec);
        dst += per_image;
      }
    }
  }
}

// Shared memory of a tile's block: for the field, the tile's row and column
// terms and the field lerped along H at each tile row for the `ncols` field
// columns a tile can touch (none for a dense grid); the footprint's box;
// then the staging area (16-byte aligned).
struct TileSmem {
  int rows, cols, lerped, box, stage, bytes;
};

__host__ __device__ inline TileSmem tile_smem(bool field, int ncols,
                                              int stage_bytes) {
  TileSmem m;
  m.rows = 0;                                       // int r, float fy
  m.cols = m.rows + (field ? 8 * kTileRows : 0);    // int q, float fx
  m.lerped = m.cols + (field ? 8 * kTileCols : 0);  // [kTileRows][ncols]
  m.box = m.lerped + 8 * kTileRows * ncols;  // int ymin, ymax, xmin, xmax
  m.stage = (m.box + 16 + 15) / 16 * 16;
  m.bytes = m.stage + stage_bytes;
  return m;
}

// The point of tile column `col` in the tile row whose lerped field row is
// `lr` (indexed by field column): upsample_field_aligned's second pass.
__device__ __forceinline__ float2 field_point(const float2* lr,
                                              const int* col_q,
                                              const float* col_f, int col) {
  const int q = col_q[col];
  const float fx = col_f[col];
  const float2 a = lr[q], e = lr[q + 1];
  return make_float2(lerp_rn(a.x, e.x, fx), lerp_rn(a.y, e.y, fx));
}

// Copies the footprint, rows fy0 .. fy0 + fh - 1 and columns fx0 .. fx0 +
// fw - 1 of each channel, to `staged` (C x fh x fw). `wide`: 16-byte
// cp.async copies, waited for by the caller (fx0 and fw whole chunks, rows
// starting on one); else a warp a row, one value a lane.
template <typename T>
__device__ __forceinline__ void stage(const T* src, long long plane, int w,
                                      int fy0, int fx0, int fh, int fw, int c,
                                      T* staged, bool wide) {
  const int t = threadIdx.x;
  if (wide) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = fw / kVec;
    const int chunks = c * fh * per_row;
    for (int i = t; i < chunks; i += kTileThreads) {
      const int rr = i / per_row, ch = rr / fh, k = i - rr * per_row;
      const T* row = src + ch * plane +
                     static_cast<long long>(fy0 + rr - ch * fh) * w + fx0;
      const auto to = static_cast<unsigned>(
          __cvta_generic_to_shared(staged + i * kVec));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                   "l"(reinterpret_cast<const uint4*>(row) + k));
    }
    return;
  }
  for (int rr = t / 32; rr < c * fh; rr += kTileThreads / 32) {
    const int ch = rr / fh;
    const T* s = src + ch * plane + static_cast<long long>(fy0 + rr - ch * fh) * w + fx0;
    T* d = staged + rr * fw;
    for (int xx = t % 32; xx < fw; xx += 32) d[xx] = s[xx];
  }
}

// The pixel index `pad` past the floor of g's sampling position (border
// padding clamps the position first, as kpwarp::corners does), within
// [0, size - 1]: every step keeps the order of its argument, so the bounds
// of the positions' range bound the corners of the positions in it.
template <bool kBorder>
__device__ __forceinline__ int pixel_bound(float g, float pad, int size,
                                           bool align) {
  float v = kpwarp::unnormalize(g, size, align);
  if (kBorder) v = fminf(fmaxf(v, 0.0f), static_cast<float>(size - 1));
  const float i = floorf(v) + pad;
  return static_cast<int>(fminf(fmaxf(i, 0.0f), static_cast<float>(size - 1)));
}

// What a tile kernel is given besides its tensors. The field's terms (f,
// ncols, sy, sx) are warp_field's only; `pairs` (a pair's two points as one
// 16-byte load) warp_bilinear's.
struct TileArgs {
  int b, c, h, w, ho, wo, tiles_x;
  int f, ncols;      // field points a side; field columns a tile touches
  float sy, sx;      // the field's align_corners=True scales
  bool align;        // grid_sample's align_corners
  bool vec;          // pair stores
  bool wide;         // 16-byte staging loads
  bool pairs;        // 16-byte grid loads
  int stage_elems;   // channel values a footprint may stage (0: none)
};

// The tile kernels' body: block (x, y) warps tile x of image y (of the
// launch's images). kDense: the points come from `points`, the (B, Ho, Wo,
// 2) grid, and nothing is staged; else from the (B, F, F, 2) field,
// upsampled.
template <typename T, bool kBorder, bool kDense>
__device__ __forceinline__ void warp_tile(const T* __restrict__ image,
                                          const float* __restrict__ points,
                                          T* __restrict__ out,
                                          const TileArgs& a) {
  using G = TileOf<kDense>;
  constexpr int kTilePairs = G::kTilePairs, kWarpsX = G::kWarpsX;
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem m = tile_smem(!kDense, a.ncols, 0);
  const bool staging = !kDense && a.stage_elems > 0;
  int* row_r = reinterpret_cast<int*>(smem + m.rows);
  float* row_f = reinterpret_cast<float*>(row_r + kTileRows);
  int* col_q = reinterpret_cast<int*>(smem + m.cols);
  float* col_f = reinterpret_cast<float*>(col_q + kTileCols);
  float2* lerped = reinterpret_cast<float2*>(smem + m.lerped);
  int* box = reinterpret_cast<int*>(smem + m.box);
  T* staged = reinterpret_cast<T*>(smem + m.stage);

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int c = a.c, h = a.h, w = a.w, ho = a.ho, wo = a.wo;
  const bool align = a.align;
  const int tile_y = a.tiles_x == 1 ? blockIdx.x : blockIdx.x / a.tiles_x;
  const int y0 = tile_y * G::kRows;
  const int x0 = (blockIdx.x - tile_y * a.tiles_x) * G::kCols;
  const int xl = min(x0 + G::kCols, wo) - 1;  // the tile's last column
  // the thread's pairs: pair p at tile row pr[p], tile columns pc[p] and
  // pc[p] + 1
  int pr[kTilePairs], pc[kTilePairs];
#pragma unroll
  for (int p = 0; p < kTilePairs; ++p) {
    const int wi = t / 32, l = t % 32;
    pr[p] = p * G::kPass + wi / kWarpsX * (32 / kLanesX) + l / kLanesX;
    pc[p] = wi % kWarpsX * (2 * kLanesX) + 2 * (l % kLanesX);
  }
  if (staging && t == 0) {
    box[0] = INT_MAX;
    box[1] = INT_MIN;
    box[2] = INT_MAX;
    box[3] = INT_MIN;
  }
  float gx_lo = INFINITY, gx_hi = -INFINITY, gy_lo = INFINITY,
        gy_hi = -INFINITY;
  // the range of the points v: NaN widens it to everything
  const auto widen = [&](float2 v) {
    if (v.x != v.x || v.y != v.y) {
      gx_lo = gy_lo = -INFINITY;
      gx_hi = gy_hi = INFINITY;
    }
    gx_lo = fminf(gx_lo, v.x);
    gx_hi = fmaxf(gx_hi, v.x);
    gy_lo = fminf(gy_lo, v.y);
    gy_hi = fmaxf(gy_hi, v.y);
  };

  // 1. the points. Dense: the thread's pairs' points from the grid, rows
  // and columns past the output repeating its last ones.
  float2 pt[kTilePairs][2];
  int q_lo = 0;
  if constexpr (kDense) {
    const float2* grid = reinterpret_cast<const float2*>(points) +
                         static_cast<long long>(b) * ho * wo;
#pragma unroll
    for (int p = 0; p < kTilePairs; ++p) {
      const long long row =
          static_cast<long long>(min(y0 + pr[p], ho - 1)) * wo;
      if (a.pairs) {                         // wo even: a pair never splits
        const float4 q = __ldg(reinterpret_cast<const float4*>(
            grid + row + min(x0 + pc[p], wo - 2)));
        pt[p][0] = make_float2(q.x, q.y);
        pt[p][1] = make_float2(q.z, q.w);
      } else {
        pt[p][0] = __ldg(grid + row + min(x0 + pc[p], xl));
        pt[p][1] = __ldg(grid + row + min(x0 + pc[p] + 1, xl));
      }
    }
  } else {
    // Field: each tile row's (r, fy) and each column's (q, fx), once; rows
    // and columns past the output repeat its last ones
    if (t < kTileRows) {
      float fr;
      row_r[t] = field_cell(min(y0 + t, ho - 1), a.sy, a.f, &fr);
      row_f[t] = fr;
    } else if (t >= 32 && t < 32 + kTileCols) {
      float fc;
      col_q[t - 32] = field_cell(min(x0 + t - 32, xl), a.sx, a.f, &fc);
      col_f[t - 32] = fc;
    }
    // the field columns the tile's points lie between
    float unused;
    q_lo = field_cell(x0, a.sx, a.f, &unused);
    const int nq = field_cell(xl, a.sx, a.f, &unused) + 2 - q_lo;
    __syncthreads();

    // upsample_field_aligned's first pass at each tile row: field rows r
    // and r + 1 lerped at fy, for the columns q_lo .. q_lo + nq - 1. Every
    // sample point of the tile lies between two of these (its second
    // pass), so their range bounds the tile's footprint.
    const float* fb = points + static_cast<long long>(b) * 2 * a.f * a.f;
    for (int i = t; i < kTileRows * nq; i += kTileThreads) {
      const int ty = i / nq, k = i - ty * nq;
      const float* top = fb + 2 * (row_r[ty] * a.f + q_lo + k);
      const float* bot = top + 2 * a.f;
      const float fy = row_f[ty];
      const float2 v = make_float2(lerp_rn(__ldg(top), __ldg(bot), fy),
                                   lerp_rn(__ldg(top + 1), __ldg(bot + 1), fy));
      lerped[ty * a.ncols + k] = v;
      widen(v);
    }
  }
  // 2. the box of the corners those points can take, a pixel wider on each
  // side (rounding), within the image: a min and max over each warp, then
  // over the block
  if (staging) {
    int x0b = INT_MAX, x1b = INT_MIN, y0b = INT_MAX, y1b = INT_MIN;
    if (gx_lo <= gx_hi) {
      x0b = pixel_bound<kBorder>(gx_lo, -1.0f, w, align);
      x1b = pixel_bound<kBorder>(gx_hi, 2.0f, w, align);
      y0b = pixel_bound<kBorder>(gy_lo, -1.0f, h, align);
      y1b = pixel_bound<kBorder>(gy_hi, 2.0f, h, align);
    }
    x0b = __reduce_min_sync(0xffffffffu, x0b);
    x1b = __reduce_max_sync(0xffffffffu, x1b);
    y0b = __reduce_min_sync(0xffffffffu, y0b);
    y1b = __reduce_max_sync(0xffffffffu, y1b);
    if (t % 32 == 0) {
      atomicMin(box, y0b);
      atomicMax(box + 1, y1b);
      atomicMin(box + 2, x0b);
      atomicMax(box + 3, x1b);
    }
  }
  if constexpr (!kDense) __syncthreads();  // lerped, box

  // the corners of pair p's two pixels
  const auto pair_corners = [&](int p, kpwarp::Corners (&k)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float2 g;
      if constexpr (kDense)
        g = pt[p][j];
      else
        g = field_point(lerped + pr[p] * a.ncols - q_lo, col_q, col_f,
                        pc[p] + j);
      k[j] = kpwarp::corners<kBorder>(g.x, g.y, h, w, align);
    }
  };
  const long long plane = static_cast<long long>(h) * w;
  const long long per_image = static_cast<long long>(ho) * wo;
  const T* src = image + static_cast<long long>(b) * c * plane;
  T* dst = out + static_cast<long long>(b) * c * per_image + x0;
  const auto live = [&](int p) {
    return y0 + pr[p] < ho ? max(0, min(2, wo - x0 - pc[p])) : 0;
  };
  if (staging) {
    // the box's columns widened to whole 16-byte chunks for a wide copy
    constexpr int kVec = 16 / sizeof(T);
    const int fy0 = box[0], fh = box[1] - fy0 + 1;
    const int fx0 = a.wide ? box[2] / kVec * kVec : box[2];
    const int fw = a.wide ? (box[3] + kVec - fx0) / kVec * kVec
                          : box[3] + 1 - fx0;
    if (static_cast<long long>(c) * fh * fw <= a.stage_elems) {
      // 3. the footprint copied to shared memory, the first pair's corners
      // computed while it lands, then pair by pair the gathers from there
      stage(src, plane, w, fy0, fx0, fh, fw, c, staged, a.wide);
      kpwarp::Corners k[2];
      pair_corners(0, k);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kTilePairs; ++p) {
        if (p > 0) pair_corners(p, k);
        sample_pair<T, true>(staged, fw, static_cast<long long>(fh) * fw, fx0,
                             fy0, k, c,
                             dst + static_cast<long long>(y0 + pr[p]) * wo +
                                 pc[p],
                             per_image, live(p), a.vec);
      }
      return;
    }
  }
  // 4. a dense grid, no staging, or a footprint over the budget: pair by
  // pair the corners, then the gathers from device memory
#pragma unroll
  for (int p = 0; p < kTilePairs; ++p) {
    kpwarp::Corners k[2];
    pair_corners(p, k);
    sample_pair<T, false>(src, w, plane, 0, 0, k, c,
                          dst + static_cast<long long>(y0 + pr[p]) * wo + pc[p],
                          per_image, live(p), a.vec);
  }
}

// K4 and K5: the one tile body, each under its own name.
template <typename T, bool kBorder>
__global__ void __launch_bounds__(kTileThreads, 4)
warp_bilinear(const T* __restrict__ image, const float* __restrict__ grid,
              T* __restrict__ out, const TileArgs a) {
  warp_tile<T, kBorder, true>(image, grid, out, a);
}

template <typename T, bool kBorder>
__global__ void __launch_bounds__(kTileThreads, 4)
warp_field(const T* __restrict__ image, const float* __restrict__ field,
           T* __restrict__ out, const TileArgs a) {
  warp_tile<T, kBorder, false>(image, field, out, a);
}

// Launches K4 (kDense) or K5 over a.b images of (ho, wo) output: a block a
// tile of an image, the tiles along x, the images along y, at most 65535 a
// launch.
template <typename T, bool kDense>
int launch_tiles(bool border, const void* image, const void* points,
                 void* out, TileArgs a, int smem_bytes, cudaStream_t s) {
  using G = TileOf<kDense>;
  const int tiles_y = (a.ho + G::kRows - 1) / G::kRows;
  a.tiles_x = (a.wo + G::kCols - 1) / G::kCols;
  if (static_cast<long long>(a.tiles_x) * tiles_y >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = border ? warp_field<T, true> : warp_field<T, false>;
  if constexpr (kDense)
    kernel = border ? warp_bilinear<T, true> : warp_bilinear<T, false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int kMaxImages = 65535;
  const long long in_image = static_cast<long long>(a.c) * a.h * a.w;
  const long long out_image = static_cast<long long>(a.c) * a.ho * a.wo;
  const long long points_image =
      kDense ? 2LL * a.ho * a.wo : 2LL * a.f * a.f;
  for (int b0 = 0; b0 < a.b; b0 += kMaxImages) {
    const T* im = static_cast<const T*>(image) + b0 * in_image;
    const float* pts = static_cast<const float*>(points) + b0 * points_image;
    T* o = static_cast<T*>(out) + b0 * out_image;
    // pair stores where every pair starts aligned; 16-byte staging loads
    // where every image row does; 16-byte grid loads where every pair's
    // points start on 16 bytes
    a.vec = a.wo % 2 == 0 &&
            reinterpret_cast<std::uintptr_t>(o) % (2 * sizeof(T)) == 0;
    a.wide = a.w % (16 / sizeof(T)) == 0 &&
             reinterpret_cast<std::uintptr_t>(im) % 16 == 0;
    a.pairs = kDense && a.wo % 2 == 0 &&
              reinterpret_cast<std::uintptr_t>(pts) % 16 == 0;
    const dim3 blocks(static_cast<unsigned>(a.tiles_x * tiles_y),
                      static_cast<unsigned>(min(a.b - b0, kMaxImages)));
    kernel<<<blocks, kTileThreads, smem_bytes, s>>>(im, pts, o, a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// The tile kernel of an image dtype (0 = float32, 1 = bfloat16).
template <bool kDense>
int launch_dtype(int dtype, bool border, const void* image,
                 const void* points, void* out, TileArgs a, int stage_bytes,
                 cudaStream_t s) {
  const TileSmem m = tile_smem(!kDense, a.ncols, stage_bytes);
  if (dtype == 0) {
    a.stage_elems = stage_bytes / static_cast<int>(sizeof(float));
    return launch_tiles<float, kDense>(
        border, image, points, out, a, m.bytes, s);
  }
  a.stage_elems = stage_bytes / static_cast<int>(sizeof(__nv_bfloat16));
  return launch_tiles<__nv_bfloat16, kDense>(
      border, image, points, out, a, m.bytes, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (image and output). padding: 0 = zeros,
// 1 = border. The dense-grid warp: image (B, C, H, W), grid (B, Ho, Wo, 2)
// f32, 8-byte aligned -> (B, C, Ho, Wo). H * W < 2^31, B <= 65535^2.
// Launches on `stream` (again past 65,535 images), returns
// cudaGetLastError(); no sync.
extern "C" int kp_warp_bilinear(int dtype, int padding, int align_corners,
                                int b, int c, int h, int w, int ho, int wo,
                                const void* image, const void* grid,
                                void* out, void* stream) {
  if (b < 0 || c < 0 || h < 1 || w < 1 ||
      static_cast<long long>(h) * w >= (1LL << 31) || ho < 0 || wo < 0 ||
      (dtype != 0 && dtype != 1) || (padding != 0 && padding != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || c == 0 || ho == 0 || wo == 0) return 0;
  TileArgs a{};
  a.b = b, a.c = c, a.h = h, a.w = w, a.ho = ho, a.wo = wo;
  a.align = align_corners != 0;
  return launch_dtype<true>(dtype, padding == 1, image, grid, out, a, 0,
                            static_cast<cudaStream_t>(stream));
}

// The field warp: image (B, C, H, W), field (B, F, F, 2) f32 -> (B, C, Ho,
// Wo). dtype and padding as above; 2 <= F <= kMaxField, H * W < 2^31,
// Ho * Wo < 2^31, B <= 65535, 0 <= stage_bytes <= kMaxStageBytes.
extern "C" int kp_warp_field(int dtype, int padding, int align_corners,
                             int b, int c, int h, int w, int f, int ho, int wo,
                             int stage_bytes, const void* image,
                             const void* field, void* out, void* stream) {
  if (b < 0 || b > 65535 || c < 0 || h < 1 || w < 1 ||
      static_cast<long long>(h) * w >= (1LL << 31) || f < 2 ||
      f > kMaxField || ho < 0 || wo < 0 ||
      static_cast<long long>(ho) * wo >= (1LL << 31) || stage_bytes < 0 ||
      stage_bytes > kMaxStageBytes || (dtype != 0 && dtype != 1) ||
      (padding != 0 && padding != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || c == 0 || ho == 0 || wo == 0) return 0;
  TileArgs a{};
  a.b = b, a.c = c, a.h = h, a.w = w, a.ho = ho, a.wo = wo, a.f = f;
  a.align = align_corners != 0;
  // align_corners=True positions: i * (F - 1) / (n - 1), the scale rounded
  // to f32 once, as torch rounds a Python float it multiplies a tensor by
  const double span = static_cast<double>(f - 1);
  a.sy = ho > 1 ? static_cast<float>(span / (ho - 1)) : 0.0f;
  a.sx = wo > 1 ? static_cast<float>(span / (wo - 1)) : 0.0f;
  // field columns a tile's kTileCols columns reach: q of its last column
  // less q of its first, plus the next column, plus rounding slack
  a.ncols = static_cast<int>(min(static_cast<double>(f),
                                 (kTileCols - 1) * static_cast<double>(a.sx) +
                                     4.0));
  return launch_dtype<false>(dtype, padding == 1, image, field, out, a,
                             stage_bytes, static_cast<cudaStream_t>(stream));
}
