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
// grid + 12.6 MB of output = 42 MB, 12.5 us at 3.35 TB/s, warp_field 26.3
// MB, 7.9 us. At pose256's (b128, 3 x 256^2 bf16, F = 33) warp_field moves
// 50.3 + 1.1 + 50.3 = 101.8 MB, 30.4 us; upsampling to a dense grid and
// then warping would add 67.1 MB written and read again. In practice both
// are bound by instructions and their latency: ~100 a pixel (the corner
// math, 12 gathers, 12 widenings, the sums) against 12 bytes moved (bf16,
// C = 3).
//
// warp_bilinear's design: one thread per output pixel (b, ho, wo), wo
// fastest, so the grid reads and the per-channel output stores of a warp
// are coalesced. The thread finds its sampling point once, computes the
// four corner offsets and weights once, and loops over C; the gathers go
// through the read-only cache (__ldg), where neighbouring output pixels
// mostly hit the same lines.
//
// warp_field's design: a block of 256 threads takes a tile of 32 x 64
// output pixels of one image, a thread four pairs of neighbours along Wo (a
// warp's pass 2 rows x 32 columns).
//  * Field terms once: each tile row's (r, fy) and column's (q, fx) go to
//    shared memory, then the field's first (H) lerp at each tile row for
//    the field columns the tile reaches; a pixel does only the second (W)
//    lerp, with the same rounded operations, so its point stays the
//    upsample's to the bit.
//  * The footprint first: the H-lerped values bound every sample point of
//    the tile, so their range gives, before any gather, the box of source
//    pixels the tile reads (a pixel wider on each side for rounding; NaN
//    widens it to the image). A box whose C planes fit the staging budget
//    (kernels/warp_cuda.py's STAGE_BYTES: 32 KB for bf16, 48 KB for f32) is
//    copied with 16-byte cp.async into shared memory (rows of a whole number
//    of chunks where W allows) while the first pair's corners are computed,
//    and the pairs gather from there; a larger box, or a budget of 0,
//    gathers from device memory through the read-only cache.
//  * A pair's C x 8 corner loads go out before its first store
//    (cuobjdump -sass of the bf16 kernels, C = 3: 24 LDS.U16, or 24
//    LDG.E.U16, then the pair's stores, in each of the four pairs),
//    through eight corner pointers formed once and stepped a plane a
//    channel; each channel's pair is one bf16x2 (4-byte) or float2 (8-byte)
//    store where Wo is even, else two.
//  * Limits: any F from 2 to kMaxField (the tile's H-lerped field rows are
//    the only field in shared memory; over 48 KB in all, the launch opts
//    in), H * W and Ho * Wo < 2^31, B <= 65535.
// Measured on an H100 (chip_smoke.py phase 14, PERF.md): the staged tiles
// beat the direct gathers (stage_bytes = 0) at b128 3 x 128^2 and 3 x 256^2
// bf16 by 16 % and 23 %.
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

constexpr int kThreads = 256;
constexpr int kMaxField = 512;  // a tile's H-lerped field: <= 128 KB
constexpr int kMaxStageBytes = 96 * 1024;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return kpwarp::bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid_sample of one output pixel at (gx, gy) in [-1, 1] (x, y order):
// the four corners and their weights (sampler.cuh), then the C channels,
// each summed in f32 and rounded once. `src` is the pixel's image, `dst` its
// first output channel.
template <typename T, bool kBorder>
__device__ __forceinline__ void sample_pixel(const T* src, T* dst, float gx,
                                             float gy, int c, int h, int w,
                                             long long per_image, bool align) {
  const kpwarp::Corners k = kpwarp::corners<kBorder>(gx, gy, h, w, align);
  const int o00 = k.yi0 * w + k.xi0, o01 = k.yi0 * w + k.xi1;
  const int o10 = k.yi1 * w + k.xi0, o11 = k.yi1 * w + k.xi1;
  const long long plane = static_cast<long long>(h) * w;
  for (int ch = 0; ch < c; ++ch) {
    const T* s = src + ch * plane;
    store(dst + ch * per_image, kpwarp::blend(k, load(s + o00), load(s + o01),
                                              load(s + o10), load(s + o11)));
  }
}

template <typename T, bool kBorder>
__global__ void __launch_bounds__(kThreads)
warp_bilinear(const T* __restrict__ image, const float* __restrict__ grid,
              T* __restrict__ out, long long total, int c, int h, int w,
              long long per_image, bool align) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  // the grid point first: its load overlaps the 64-bit division
  const float2 g = __ldg(reinterpret_cast<const float2*>(grid) + i);
  const long long b = i / per_image;
  const long long pix = i - b * per_image;
  const long long plane = static_cast<long long>(h) * w;
  sample_pixel<T, kBorder>(image + b * c * plane, out + b * c * per_image + pix,
                           g.x, g.y, c, h, w, per_image, align);
}

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

// K5's geometry: a block of kFieldThreads (8 warps) warps a tile of
// kTileRows x kTileCols output pixels of one image; a thread takes kPairs
// pairs of neighbours along Wo. A warp's pass covers 2 rows x 32 columns
// (a lane a pair), the block's a pass of 8 rows x 64 columns, and a thread's
// pairs lie in passes kTileRows / kPairs rows apart.
constexpr int kFieldThreads = 256;
constexpr int kPairs = 4;
constexpr int kTileRows = 32;
constexpr int kTileCols = 64;
constexpr int kLanesX = 16;  // a warp's lanes along a row
constexpr int kGroup = 3;    // channels whose gathers go out together
static_assert(kFieldThreads / 32 * (32 / kLanesX) * (2 * kLanesX) ==
                  kTileRows / kPairs * kTileCols,
              "a pass of the block covers kTileRows / kPairs rows");

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

// Shared memory of a K5 block: the tile's row and column terms, the field
// lerped along H at each tile row for the `ncols` field columns a tile can
// touch, the footprint's box, then the staging area (16-byte aligned).
struct FieldSmem {
  int rows, cols, lerped, box, stage, bytes;
};

__host__ __device__ inline FieldSmem field_smem(int ncols, int stage_bytes) {
  FieldSmem m;
  m.rows = 0;                                // int r, float fy
  m.cols = m.rows + 8 * kTileRows;           // int q, float fx
  m.lerped = m.cols + 8 * kTileCols;         // float2 [kTileRows][ncols]
  m.box = m.lerped + 8 * kTileRows * ncols;  // int ymin, ymax, xmin, xmax
  m.stage = (m.box + 16 + 15) / 16 * 16;
  m.bytes = m.stage + stage_bytes;
  return m;
}

// The corners of tile column `col` in the tile row whose lerped field row
// is `lr` (indexed by field column): upsample_field_aligned's second pass,
// then grid_sample's corners.
template <bool kBorder>
__device__ __forceinline__ kpwarp::Corners tile_corners(
    const float2* lr, const int* col_q, const float* col_f, int col, int h,
    int w, bool align) {
  const int q = col_q[col];
  const float fx = col_f[col];
  const float2 a = lr[q], e = lr[q + 1];
  return kpwarp::corners<kBorder>(lerp_rn(a.x, e.x, fx), lerp_rn(a.y, e.y, fx),
                                  h, w, align);
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
    for (int i = t; i < chunks; i += kFieldThreads) {
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
  for (int rr = t / 32; rr < c * fh; rr += kFieldThreads / 32) {
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

// Block (x, y) warps tile x of image y. `ncols` bounds the field columns a
// tile touches; `stage_elems` the channel values of a footprint that may be
// staged (0: every tile gathers from device memory); `vec`: pair stores;
// `wide`: 16-byte staging loads.
template <typename T, bool kBorder>
__global__ void __launch_bounds__(kFieldThreads, 4)
warp_field(const T* __restrict__ image, const float* __restrict__ field,
           T* __restrict__ out, int c, int h, int w, int f, int ho, int wo,
           int tiles_x, int ncols, float sy, float sx, bool align, bool vec,
           bool wide, int stage_elems) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FieldSmem m = field_smem(ncols, 0);
  int* row_r = reinterpret_cast<int*>(smem + m.rows);
  float* row_f = reinterpret_cast<float*>(row_r + kTileRows);
  int* col_q = reinterpret_cast<int*>(smem + m.cols);
  float* col_f = reinterpret_cast<float*>(col_q + kTileCols);
  float2* lerped = reinterpret_cast<float2*>(smem + m.lerped);
  int* box = reinterpret_cast<int*>(smem + m.box);
  T* staged = reinterpret_cast<T*>(smem + m.stage);

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int y0 = blockIdx.x / tiles_x * kTileRows;
  const int x0 = (blockIdx.x - blockIdx.x / tiles_x * tiles_x) * kTileCols;
  const int xl = min(x0 + kTileCols, wo) - 1;  // the tile's last column
  // 1. each tile row's (r, fy) and each column's (q, fx), once; rows and
  // columns past the output repeat its last ones
  if (t < kTileRows) {
    float fr;
    row_r[t] = field_cell(min(y0 + t, ho - 1), sy, f, &fr);
    row_f[t] = fr;
  } else if (t >= 32 && t < 32 + kTileCols) {
    float fc;
    col_q[t - 32] = field_cell(min(x0 + t - 32, xl), sx, f, &fc);
    col_f[t - 32] = fc;
  }
  if (t == 0) {
    box[0] = INT_MAX;
    box[1] = INT_MIN;
    box[2] = INT_MAX;
    box[3] = INT_MIN;
  }
  // the field columns the tile's points lie between
  float unused;
  const int q_lo = field_cell(x0, sx, f, &unused);
  const int nq = field_cell(xl, sx, f, &unused) + 2 - q_lo;
  __syncthreads();

  // 2. upsample_field_aligned's first pass at each tile row: field rows r
  // and r + 1 lerped at fy, for the columns q_lo .. q_lo + nq - 1. Every
  // sample point of the tile lies between two of these (its second pass),
  // so their range bounds the tile's footprint.
  const float* fb = field + static_cast<long long>(b) * 2 * f * f;
  float gx_lo = INFINITY, gx_hi = -INFINITY, gy_lo = INFINITY,
        gy_hi = -INFINITY;
  for (int i = t; i < kTileRows * nq; i += kFieldThreads) {
    const int ty = i / nq, k = i - ty * nq;
    const float* top = fb + 2 * (row_r[ty] * f + q_lo + k);
    const float* bot = top + 2 * f;
    const float fy = row_f[ty];
    const float2 v = make_float2(lerp_rn(__ldg(top), __ldg(bot), fy),
                                 lerp_rn(__ldg(top + 1), __ldg(bot + 1), fy));
    lerped[ty * ncols + k] = v;
    if (v.x != v.x || v.y != v.y) {  // NaN: the footprint is the image
      gx_lo = gy_lo = -INFINITY;
      gx_hi = gy_hi = INFINITY;
    }
    gx_lo = fminf(gx_lo, v.x);
    gx_hi = fmaxf(gx_hi, v.x);
    gy_lo = fminf(gy_lo, v.y);
    gy_hi = fmaxf(gy_hi, v.y);
  }
  if (stage_elems > 0) {
    // the box of the corners those points can take, a pixel wider on each
    // side (rounding), within the image: a min and max over each warp, then
    // over the block
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
  __syncthreads();

  const long long plane = static_cast<long long>(h) * w;
  const long long per_image = static_cast<long long>(ho) * wo;
  const T* src = image + static_cast<long long>(b) * c * plane;
  // the thread's pairs: pair p at tile row pr[p], tile columns pc[p] and
  // pc[p] + 1
  int pr[kPairs], pc[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    constexpr int kWarpsX = kTileCols / (2 * kLanesX);
    const int wi = t / 32, l = t % 32;
    pr[p] = p * (kTileRows / kPairs) + wi / kWarpsX * (32 / kLanesX) +
            l / kLanesX;
    pc[p] = wi % kWarpsX * (2 * kLanesX) + 2 * (l % kLanesX);
  }
  T* dst = out + static_cast<long long>(b) * c * per_image + x0;
  if (stage_elems > 0) {
    // the box's columns widened to whole 16-byte chunks for a wide copy
    constexpr int kVec = 16 / sizeof(T);
    const int fy0 = box[0], fh = box[1] - fy0 + 1;
    const int fx0 = wide ? box[2] / kVec * kVec : box[2];
    const int fw = wide ? (box[3] + kVec - fx0) / kVec * kVec
                        : box[3] + 1 - fx0;
    if (static_cast<long long>(c) * fh * fw <= stage_elems) {
      // 3. the footprint copied to shared memory, the first pair's corners
      // computed while it lands, then pair by pair the gathers from there
      stage(src, plane, w, fy0, fx0, fh, fw, c, staged, wide);
      kpwarp::Corners k[2] = {
          tile_corners<kBorder>(lerped + pr[0] * ncols - q_lo, col_q, col_f,
                                pc[0], h, w, align),
          tile_corners<kBorder>(lerped + pr[0] * ncols - q_lo, col_q, col_f,
                                pc[0] + 1, h, w, align)};
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        if (p > 0) {
          const float2* lr = lerped + pr[p] * ncols - q_lo;
          k[0] = tile_corners<kBorder>(lr, col_q, col_f, pc[p], h, w, align);
          k[1] = tile_corners<kBorder>(lr, col_q, col_f, pc[p] + 1, h, w,
                                       align);
        }
        const int y = y0 + pr[p];
        sample_pair<T, true>(staged, fw, static_cast<long long>(fh) * fw, fx0,
                             fy0, k, c, dst + static_cast<long long>(y) * wo + pc[p],
                             per_image, y < ho ? max(0, min(2, wo - x0 - pc[p])) : 0,
                             vec);
      }
      return;
    }
  }
  // 4. no staging, or a footprint over the budget: pair by pair the
  // corners, then the gathers from device memory
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const float2* lr = lerped + pr[p] * ncols - q_lo;
    const kpwarp::Corners k[2] = {
        tile_corners<kBorder>(lr, col_q, col_f, pc[p], h, w, align),
        tile_corners<kBorder>(lr, col_q, col_f, pc[p] + 1, h, w, align)};
    const int y = y0 + pr[p];
    sample_pair<T, false>(src, w, plane, 0, 0, k, c,
                          dst + static_cast<long long>(y) * wo + pc[p],
                          per_image, y < ho ? max(0, min(2, wo - x0 - pc[p])) : 0,
                          vec);
  }
}

template <typename T>
void launch(bool border, const void* image, const void* grid, void* out,
            long long total, int c, int h, int w, long long per_image,
            bool align, cudaStream_t s) {
  const dim3 blocks(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  const auto* im = static_cast<const T*>(image);
  const auto* gr = static_cast<const float*>(grid);
  auto* o = static_cast<T*>(out);
  if (border)
    warp_bilinear<T, true><<<blocks, kThreads, 0, s>>>(im, gr, o, total, c, h,
                                                       w, per_image, align);
  else
    warp_bilinear<T, false><<<blocks, kThreads, 0, s>>>(im, gr, o, total, c, h,
                                                        w, per_image, align);
}

template <typename T>
int launch_field(bool border, const void* image, const void* field,
                 void* out, int b, int c, int h, int w, int f, int ho, int wo,
                 bool align, int stage_bytes, cudaStream_t s) {
  const int tiles_x = (wo + kTileCols - 1) / kTileCols;
  const int tiles_y = (ho + kTileRows - 1) / kTileRows;
  // align_corners=True positions: i * (F - 1) / (n - 1), the scale rounded
  // to f32 once, as torch rounds a Python float it multiplies a tensor by
  const double span = static_cast<double>(f - 1);
  const float sy = ho > 1 ? static_cast<float>(span / (ho - 1)) : 0.0f;
  const float sx = wo > 1 ? static_cast<float>(span / (wo - 1)) : 0.0f;
  // field columns a tile's kTileCols columns reach: q of its last column
  // less q of its first, plus the next column, plus rounding slack
  const int ncols = static_cast<int>(
      min(static_cast<double>(f), (kTileCols - 1) * static_cast<double>(sx) + 4.0));
  const FieldSmem m = field_smem(ncols, stage_bytes);
  // pair stores where every pair starts aligned; 16-byte staging loads
  // where every image row does
  const bool vec = wo % 2 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % (2 * sizeof(T)) == 0;
  const bool wide = w % (16 / sizeof(T)) == 0 &&
                    reinterpret_cast<std::uintptr_t>(image) % 16 == 0;
  const auto kernel = border ? warp_field<T, true> : warp_field<T, false>;
  if (m.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, m.bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 blocks(static_cast<unsigned>(tiles_x * tiles_y),
                    static_cast<unsigned>(b));
  kernel<<<blocks, kFieldThreads, m.bytes, s>>>(
      static_cast<const T*>(image), static_cast<const float*>(field),
      static_cast<T*>(out), c, h, w, f, ho, wo, tiles_x, ncols, sy, sx, align,
      vec, wide, stage_bytes / static_cast<int>(sizeof(T)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (image and output). padding: 0 = zeros,
// 1 = border. Launches on `stream`, returns cudaGetLastError(); no sync.
extern "C" int kp_warp_bilinear(int dtype, int padding, int align_corners,
                                int b, int c, int h, int w, int ho, int wo,
                                const void* image, const void* grid,
                                void* out, void* stream) {
  if (b < 0 || c < 0 || h < 1 || w < 1 || ho < 0 || wo < 0 ||
      (dtype != 0 && dtype != 1) || (padding != 0 && padding != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_image = static_cast<long long>(ho) * wo;
  const long long total = static_cast<long long>(b) * per_image;
  if (total == 0 || c == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(padding == 1, image, grid, out, total, c, h, w, per_image,
                  align_corners != 0, s);
  else
    launch<__nv_bfloat16>(padding == 1, image, grid, out, total, c, h, w,
                          per_image, align_corners != 0, s);
  return static_cast<int>(cudaGetLastError());
}

// The field warp: image (B, C, H, W), field (B, F, F, 2) f32 -> (B, C, Ho,
// Wo). dtype and padding as above; 2 <= F <= kMaxField, H * W < 2^31,
// Ho * Wo < 2^31, B <= 65535, 0 <= stage_bytes <= kMaxStageBytes (the
// shared memory a tile's footprint may take; 0 gathers every tile from
// device memory).
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
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_field<float>(padding == 1, image, field, out, b, c, h, w, f,
                               ho, wo, align_corners != 0, stage_bytes, s);
  return launch_field<__nv_bfloat16>(padding == 1, image, field, out, b, c, h,
                                     w, f, ho, wo, align_corners != 0,
                                     stage_bytes, s);
}
