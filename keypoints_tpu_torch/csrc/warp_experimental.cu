// Banded bilinear warps of bf16 images on Hopper, forward only: image
// (B, C, H, W) bf16 at a dense grid (B, Ho, Wo, 2) f32 -> (B, C, Ho, Wo)
// bf16, read through bands of source rows; a corner row outside its band
// reads as 0.
//   warp_band    (K7) one band for each block of 8 output rows; replaces
//                keypoints_tpu/kernels/experimental.py:157
//                warp_bilinear_tree (_warp_kernel_tree :70, the select tree
//                _tree_select :53, y corners _y_corners :38)
//   warp_rowwin  (K8) one band for each output row; replaces
//                experimental.py:272 warp_bilinear_rowwin
//                (_warp_kernel_rowwin :210)
//
// A band (of a block of 8 rows for K7, of one row for K8) has `win` rows
// from start = floor16(clamp(min floor(iy) over its pixels, 0, H - win));
// win = H is no band. The wrapper (kernels/experimental_cuda.py) computes
// win from the caller's y_window as the JAX entries do, and
// ops/experimental.py is the plain version. The corner math and the
// four-corner sum are K4's (sampler.cuh), so where every corner row lies in
// its band a banded warp equals warp_bilinear (warp.cu) bit for bit.
//
// Design: the TPU kernels stage a band of source rows in VMEM because
// Mosaic cannot gather along sublanes, and select rows from it with a
// select tree (K7) or a masked sum over 16-row chunks (K8). Here the band is
// staged in shared memory and is an ordinary gather source. One block of
// 256 threads takes `block_rows` (16) output rows of one image: 2 K7 bands
// or 16 K8 bands, whose rows overlap. It reduces each band's start and the
// last row any of its corners reads (shared-memory atomics), then, channel
// by channel, copies the union of the rows its bands read into shared
// memory (16 bytes a thread where the rows allow it) and samples its pixels
// from there, one thread a pixel, each corner row outside its own band as
// 0. K8's chunks past a row's last corner row are rows not copied. A block
// stages `reserve` = min(H, win + 2 * block_rows) rows of one channel at
// most (28 KB at celeba128, 3 x 128^2, y_window 40 -> K7 win 80, 112 rows
// of 128; 72 KB at pose256, 3 x 256^2, y_window 75 -> win 112, 144 rows of
// 256; K8's windows are narrower); a block whose bands read more
// rows (a violated window), or every block when the reserve passes what the
// card lets a block hold, reads the rows in place from device memory with
// the same masks and sums, so the result is the same.
//
// What bounds them: bytes, as K4. A warp reads its image once (here each
// block's union again from L2, ~2-3x the image at these warps), its grid
// (8 bytes a pixel, read again from L1/L2 for every channel) and writes C
// bf16 values a pixel: 12.6 + 16.8 + 12.6 MB at celeba128 b128, 12.5 us at
// 3.35 TB/s. The first design, one block for each band with all channels
// staged at once, copied each band again for every 8 rows (K7) or every row
// (K8): 10x and 30x the image from L2 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sampler.cuh"

namespace {

constexpr int kWarpSize = 32;
constexpr int kChunk = 16;

// f32 -> bf16 bits, round to nearest even, as warp.cu's store
__device__ __forceinline__ unsigned short bf16_round(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

constexpr int kThreads = 256;
constexpr int kMaxBands = 32;   // bands a block holds: block_rows / unit

template <bool kShared>
__device__ __forceinline__ unsigned short ld(const unsigned short* p) {
  if constexpr (kShared) return *p;
  else return __ldg(p);
}

// Channel `ch`'s output of the block's n pixels from the source rows at
// `base` (row `row0` first: the staged rows in shared memory, or the whole
// channel plane in device memory), each corner row outside its pixel's band
// [start, start + win) as 0.
template <bool kBorder, bool kShared>
__device__ __forceinline__ void sample_channel(
    const unsigned short* base, int row0, const float2* __restrict__ g,
    unsigned short* __restrict__ dst, int n, int band_px,
    const int* band_start, int win, int h, int w, bool align) {
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float2 gp = __ldg(&g[p]);
    const kpwarp::Corners k = kpwarp::corners<kBorder>(gp.x, gp.y, h, w, align);
    const int start = band_start[p / band_px];
    float v00 = 0.0f, v01 = 0.0f, v10 = 0.0f, v11 = 0.0f;
    if (k.yi0 >= start && k.yi0 < start + win) {
      const unsigned short* r = base + (k.yi0 - row0) * w;
      v00 = kpwarp::bf16_bits(ld<kShared>(r + k.xi0));
      v01 = kpwarp::bf16_bits(ld<kShared>(r + k.xi1));
    }
    if (k.yi1 >= start && k.yi1 < start + win) {
      const unsigned short* r = base + (k.yi1 - row0) * w;
      v10 = kpwarp::bf16_bits(ld<kShared>(r + k.xi0));
      v11 = kpwarp::bf16_bits(ld<kShared>(r + k.xi1));
    }
    dst[p] = bf16_round(kpwarp::blend(k, v00, v01, v10, v11));
  }
}

// `unit` output rows share a band: 8 (K7) or 1 (K8).
template <bool kBorder>
__device__ __forceinline__ void banded(
    const unsigned short* __restrict__ image, const float2* __restrict__ grid,
    unsigned short* __restrict__ out, int c, int h, int w, int ho, int wo,
    int win, int unit, int block_rows, int reserve, bool align, bool vec) {
  extern __shared__ __align__(16) unsigned short rows_smem[];
  __shared__ int band_start[kMaxBands];
  __shared__ int band_end[kMaxBands];
  __shared__ int span[2];
  const int b = blockIdx.y;
  const int first_row = blockIdx.x * block_rows;
  const int n = min(block_rows, ho - first_row) * wo;
  const int band_px = unit * wo;
  const int bands = n / band_px;
  const float2* g = grid + (static_cast<long long>(b) * ho + first_row) * wo;

  // 1. each band's smallest source row, clamped to [0, H - win] (the clamp
  // of the minimum is the minimum of the clamps), and the last row any of
  // its lower corners reads
  for (int i = threadIdx.x; i < bands; i += kThreads) {
    band_start[i] = h;
    band_end[i] = 0;
  }
  __syncthreads();
  const float top = static_cast<float>(h - win);
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float y0 = kpwarp::source_row<kBorder>(__ldg(&g[p].y), h, align);
    const int i = p / band_px;
    atomicMin(&band_start[i], static_cast<int>(fminf(fmaxf(y0, 0.0f), top)));
    atomicMax(&band_end[i], kpwarp::clamp_index(y0 + 1.0f, h));
  }
  __syncthreads();

  // 2. each band's start, a multiple of 16 (0 without a band), and the
  // union [span[0], span[1]) of the rows the bands read
  if (threadIdx.x < kWarpSize) {
    int lo = h, hi = 0;
    if (threadIdx.x < bands) {
      const int start = win < h ? band_start[threadIdx.x] / kChunk * kChunk : 0;
      band_start[threadIdx.x] = start;
      lo = start;
      hi = min(start + win, band_end[threadIdx.x] + 1);
    }
#pragma unroll
    for (int o = kWarpSize / 2; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (threadIdx.x == 0) {
      span[0] = lo;
      span[1] = hi;
    }
  }
  __syncthreads();
  const int lo = span[0];
  const int count = span[1] - lo;  // rows read
  const bool staged = count <= reserve;

  // 3. channel by channel: copy the rows, then sample from them
  const long long plane = static_cast<long long>(h) * w;
  const long long per_image = static_cast<long long>(ho) * wo;
  const unsigned short* img = image + static_cast<long long>(b) * c * plane;
  unsigned short* dst = out + static_cast<long long>(b) * c * per_image +
                        static_cast<long long>(first_row) * wo;
  for (int ch = 0; ch < c; ++ch) {
    const unsigned short* src = img + ch * plane;
    unsigned short* dst_ch = dst + ch * per_image;
    if (!staged) {
      sample_channel<kBorder, false>(src, 0, g, dst_ch, n, band_px,
                                     band_start, win, h, w, align);
      continue;
    }
    const int values = count * w;
    const unsigned short* from = src + static_cast<long long>(lo) * w;
    if (vec) {  // w % 8 == 0 and a 16-byte aligned image: 8 values a load
      const uint4* s = reinterpret_cast<const uint4*>(from);
      uint4* d = reinterpret_cast<uint4*>(rows_smem);
      for (int i = threadIdx.x; i < values / 8; i += kThreads) d[i] = __ldg(s + i);
    } else {
      for (int i = threadIdx.x; i < values; i += kThreads)
        rows_smem[i] = __ldg(from + i);
    }
    __syncthreads();
    sample_channel<kBorder, true>(rows_smem, lo, g, dst_ch, n, band_px,
                                  band_start, win, h, w, align);
    __syncthreads();  // before the next channel's rows overwrite these
  }
}

template <bool kBorder>
__global__ void __launch_bounds__(kThreads)
warp_band(const unsigned short* __restrict__ image,
          const float2* __restrict__ grid, unsigned short* __restrict__ out,
          int c, int h, int w, int ho, int wo, int win, int block_rows,
          int reserve, bool align, bool vec) {
  banded<kBorder>(image, grid, out, c, h, w, ho, wo, win, 8, block_rows,
                  reserve, align, vec);
}

template <bool kBorder>
__global__ void __launch_bounds__(kThreads)
warp_rowwin(const unsigned short* __restrict__ image,
            const float2* __restrict__ grid, unsigned short* __restrict__ out,
            int c, int h, int w, int ho, int wo, int win, int block_rows,
            int reserve, bool align, bool vec) {
  banded<kBorder>(image, grid, out, c, h, w, ho, wo, win, 1, block_rows,
                  reserve, align, vec);
}

using Kernel = void (*)(const unsigned short*, const float2*, unsigned short*,
                        int, int, int, int, int, int, int, int, bool, bool);

Kernel pick(bool rowwin, bool border) {
  if (rowwin) return border ? warp_rowwin<true> : warp_rowwin<false>;
  return border ? warp_band<true> : warp_band<false>;
}

}  // namespace

// The most shared memory, in bytes, a block may take for its rows on the
// current device (the opt-in limit less the static scratch); a larger
// reserve is read in place.
extern "C" long long kp_warp_band_smem_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return static_cast<long long>(optin) - 1024;
}

// unit: 8 = K7 (a band for each block of 8 output rows), 1 = K8 (a band for
// each output row). block_rows: output rows a block takes, a multiple of 8
// with block_rows / unit <= 32. padding: 0 = zeros, 1 = border. win: the
// band's rows, 1 <= win <= h (win = h: no band). Ho % 8 == 0, B <= 65535.
// Launches on `stream`, returns cudaGetLastError(); no sync.
extern "C" int kp_warp_band(int unit, int block_rows, int padding,
                            int align_corners, int b, int c, int h, int w,
                            int ho, int wo, int win, const void* image,
                            const void* grid, void* out, void* stream) {
  if ((unit != 8 && unit != 1) || block_rows < 8 || block_rows % 8 ||
      block_rows / unit > kMaxBands || (padding != 0 && padding != 1) ||
      b < 0 || b > 65535 || c < 0 || h < 1 || w < 1 || ho < 0 || wo < 0 ||
      ho % 8 || win < 1 || win > h)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || c == 0 || ho == 0 || wo == 0) return 0;
  const long long limit = kp_warp_band_smem_limit();
  if (limit < 0) return static_cast<int>(cudaGetLastError());
  int reserve = min(h, win + 2 * block_rows);
  if (2LL * reserve * w > limit) reserve = 0;  // every block reads in place
  const size_t dyn = 2 * static_cast<size_t>(reserve) * w;
  const Kernel kernel = pick(unit == 1, padding == 1);
  // opt in to the rows' size: a launch whose shared memory, the static
  // scratch included, passes the default 48 KB is refused otherwise
  if (dyn > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec = w % 8 == 0 &&
                   reinterpret_cast<std::uintptr_t>(image) % 16 == 0;
  const dim3 blocks(static_cast<unsigned>((ho + block_rows - 1) / block_rows),
                    static_cast<unsigned>(b));
  kernel<<<blocks, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(image),
      static_cast<const float2*>(grid), static_cast<unsigned short*>(out), c,
      h, w, ho, wo, win, block_rows, reserve, align_corners != 0, vec);
  return static_cast<int>(cudaGetLastError());
}
