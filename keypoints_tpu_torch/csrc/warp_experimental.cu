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
// Mosaic cannot gather along sublanes. A CUDA thread gathers from any row,
// so here the band is only a mask: each thread gathers its corners straight
// from device memory through the read-only cache, as K4 does, and reads a
// corner row outside its pixel's band as 0 without loading it.
//  * A thread takes items of P output pixels that lie next to each other
//    along Wo: P = 2 with one 16-byte grid load and one bf16x2 store a
//    channel where Wo is even and the grid 16-byte aligned, else P = 1.
//  * Geometry: blocks of 256 threads. A band's items go to a slot of whole
//    warps, item i to thread i % slot: K7's band (8 x Wo pixels) is one
//    block (4 items a thread at Wo = 256), K8's band (one row) a slot of
//    Wo / 2 threads rounded up to warps, 256 / slot rows a block (4 at
//    Wo = 128).
//  * The band's start needs every pixel of the band before any gather. The
//    slot reads its band's grid once, with streaming (evict-first) loads so
//    L1 keeps the image's lines, into shared memory (8 bytes a pixel: 16 KB
//    for K7 at Wo = 256), and takes the least upper corner row on the way:
//    a __reduce_min_sync a warp, then the slot's warps combined through one
//    int each in shared memory. No shared atomics, no second grid read
//    from device memory. (Keeping each thread's corners in registers
//    instead takes 4 items a thread for K7 at Wo = 256, 147 registers, and
//    ran slower than K4; so did splitting the band over a cluster of
//    blocks, or over blocks that each read the others' y: PERF.md.)
//  * Then item by item, two at a time: the corners once (sampler.cuh), the
//    band mask folded into the row offsets, and, channel by channel, the
//    four gathers, K4's sum and a streaming store.
// Nothing of the image is staged, so a violated window runs the same code
// as a held one, and no band height is limited; a band's grid must fit in
// shared memory (Wo up to 3,584 for K7, 28,672 for K8).
//
// What bounds them: bytes, as K4. A warp reads its image (about once, from
// L1/L2 for neighbouring pixels), its grid (8 bytes a pixel, once) and
// writes C bf16 values a pixel: 12.6 + 16.8 + 12.6 MB at celeba128 b128
// (3 x 128^2), 12.5 us at 3.35 TB/s; 50.3 + 67.1 + 50.3 MB at pose256 b128
// (3 x 256^2), 50.1 us. The gathers make them latency bound in practice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "sampler.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpSize = 32;
constexpr int kWarps = kThreads / kWarpSize;
constexpr int kChunk = 16;                // bands start on a multiple of 16 rows
constexpr int kMaxBandBytes = 224 * 1024; // a band's grid in shared memory

// f32 -> bf16 bits, round to nearest even, as warp.cu's store
__device__ __forceinline__ unsigned short bf16_round(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// One channel's sample of a pixel from its channel plane `s`; k.yi0 and
// k.yi1 hold the corner rows' offsets (row * w), or -1 for a row outside
// the pixel's band, which reads as 0 and is not loaded.
__device__ __forceinline__ float sample(const unsigned short* __restrict__ s,
                                        const kpwarp::Corners& k) {
  float v00 = 0.0f, v01 = 0.0f, v10 = 0.0f, v11 = 0.0f;
  if (k.yi0 >= 0) {
    v00 = kpwarp::bf16_bits(__ldg(s + k.yi0 + k.xi0));
    v01 = kpwarp::bf16_bits(__ldg(s + k.yi0 + k.xi1));
  }
  if (k.yi1 >= 0) {
    v10 = kpwarp::bf16_bits(__ldg(s + k.yi1 + k.xi0));
    v11 = kpwarp::bf16_bits(__ldg(s + k.yi1 + k.xi1));
  }
  return kpwarp::blend(k, v00, v01, v10, v11);
}

// `unit` output rows share a band: 8 (K7) or 1 (K8). A band's pixels go in
// items of kP neighbours along Wo to a slot of `slot` threads (whole
// warps), item i to thread i % slot; a block of kThreads holds
// kThreads / slot slots, one band each. Block (x, y): image y, bands
// x * slots, ...
template <bool kBorder, int kP>
__global__ void __launch_bounds__(kThreads)
banded(const unsigned short* __restrict__ image,
       const float2* __restrict__ grid, unsigned short* __restrict__ out,
       int c, int h, int w, int ho, int wo, int win, int unit, int slot,
       bool align) {
  extern __shared__ float2 points[];  // each slot's band of grid points
  __shared__ int warp_low[kWarps];
  const int b = blockIdx.y;
  const int slots = kThreads / slot;
  const int s = threadIdx.x / slot;
  const int u = threadIdx.x - s * slot;
  const int band = blockIdx.x * slots + s;
  const int band_px = unit * wo;
  const int items = band_px / kP;
  const bool live = s < slots && band < ho / unit;  // uniform across a warp
  const long long per_image = static_cast<long long>(ho) * wo;
  const long long first = b * per_image + static_cast<long long>(band) * band_px;
  float2* pts = points + (live ? s * band_px : 0);
  const int top = h - win;

  // 1. the band's grid points, read once (streaming) into shared memory,
  // and the least upper corner row clamped to [0, H - win] (the clamp of
  // the minimum is the minimum of the clamps)
  int low = INT_MAX;
  if (live) {
    const float ftop = static_cast<float>(top);
    for (int i = u; i < items; i += slot) {
      if constexpr (kP == 2) {
        const float4 f = __ldcs(reinterpret_cast<const float4*>(grid + first) + i);
        pts[2 * i] = make_float2(f.x, f.y);
        pts[2 * i + 1] = make_float2(f.z, f.w);
        const float y0 = fminf(kpwarp::source_row<kBorder>(f.y, h, align),
                               kpwarp::source_row<kBorder>(f.w, h, align));
        low = min(low, static_cast<int>(fminf(fmaxf(y0, 0.0f), ftop)));
      } else {
        const float2 f = __ldcs(grid + first + i);
        pts[i] = f;
        const float y0 = kpwarp::source_row<kBorder>(f.y, h, align);
        low = min(low, static_cast<int>(fminf(fmaxf(y0, 0.0f), ftop)));
      }
    }
  }

  // 2. the band's start: a min over each warp, then over the slot's warps
  low = __reduce_min_sync(0xffffffffu, low);
  if (threadIdx.x % kWarpSize == 0) warp_low[threadIdx.x / kWarpSize] = low;
  __syncthreads();
  if (!live) return;
  const int warps = slot / kWarpSize;
  int start = INT_MAX;
  for (int i = 0; i < warps; ++i) start = min(start, warp_low[s * warps + i]);
  start = start / kChunk * kChunk;  // 0 without a band (top = 0)

  // 3. item by item: its corners once, each corner row in the band as its
  // offset in a channel plane (outside, -1), then channel by channel the
  // gathers, K4's sum and a streaming store
  const long long plane = static_cast<long long>(h) * w;
  const unsigned short* img = image + static_cast<long long>(b) * c * plane;
  unsigned short* dst = out + static_cast<long long>(b) * c * per_image +
                        static_cast<long long>(band) * band_px;
#pragma unroll 2  // two items' gathers in flight
  for (int i = u; i < items; i += slot) {
    kpwarp::Corners k[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const float2 pt = pts[i * kP + p];
      k[p] = kpwarp::corners<kBorder>(pt.x, pt.y, h, w, align);
      k[p].yi0 = k[p].yi0 >= start && k[p].yi0 < start + win ? k[p].yi0 * w : -1;
      k[p].yi1 = k[p].yi1 >= start && k[p].yi1 < start + win ? k[p].yi1 * w : -1;
    }
    unsigned short* d = dst + i * kP;
    for (int ch = 0; ch < c; ++ch) {
      const unsigned short* src = img + ch * plane;
      if constexpr (kP == 2) {
        const unsigned lo = bf16_round(sample(src, k[0]));
        const unsigned hi = bf16_round(sample(src, k[1]));
        __stcs(reinterpret_cast<unsigned*>(d + ch * per_image), lo | (hi << 16));
      } else {
        __stcs(d + ch * per_image, bf16_round(sample(src, k[0])));
      }
    }
  }
}

using Kernel = void (*)(const unsigned short*, const float2*, unsigned short*,
                        int, int, int, int, int, int, int, int, bool);

Kernel pick(bool border, bool paired) {
  if (border) return paired ? banded<true, 2> : banded<true, 1>;
  return paired ? banded<false, 2> : banded<false, 1>;
}

}  // namespace

// unit: 8 = K7 (a band for each block of 8 output rows), 1 = K8 (a band for
// each output row). padding: 0 = zeros, 1 = border. win: the band's rows,
// 1 <= win <= h (win = h: no band). Ho % 8 == 0, B <= 65535, H*W < 2**31,
// the grid 8-byte aligned, a band's grid (unit * wo * 8 bytes) at most
// kMaxBandBytes. Launches on `stream`, returns cudaGetLastError(); no sync.
extern "C" int kp_warp_band(int unit, int padding, int align_corners, int b,
                            int c, int h, int w, int ho, int wo, int win,
                            const void* image, const void* grid, void* out,
                            void* stream) {
  if ((unit != 8 && unit != 1) || (padding != 0 && padding != 1) || b < 0 ||
      b > 65535 || c < 0 || h < 1 || w < 1 ||
      static_cast<long long>(h) * w >= (1LL << 31) || ho < 0 || wo < 0 ||
      ho % 8 || win < 1 || win > h ||
      8LL * unit * wo > kMaxBandBytes ||
      reinterpret_cast<std::uintptr_t>(grid) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || c == 0 || ho == 0 || wo == 0) return 0;
  // two neighbouring pixels an item (one 16-byte grid load, one bf16x2
  // store a channel) where every pair starts 16-byte aligned
  const bool paired = wo % 2 == 0 &&
                      reinterpret_cast<std::uintptr_t>(grid) % 16 == 0;
  const int items = unit * wo / (paired ? 2 : 1);  // of a band
  const int slot = min(kThreads, (items + kWarpSize - 1) / kWarpSize * kWarpSize);
  const int slots = kThreads / slot;
  const size_t dyn = sizeof(float2) * slots * unit * wo;
  const Kernel kernel = pick(padding == 1, paired);
  // opt in above the default 48 KB (K7 wider than 768)
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 blocks(static_cast<unsigned>((ho / unit + slots - 1) / slots),
                    static_cast<unsigned>(b));
  kernel<<<blocks, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(image),
      static_cast<const float2*>(grid), static_cast<unsigned short*>(out), c,
      h, w, ho, wo, win, unit, slot, align_corners != 0);
  return static_cast<int>(cudaGetLastError());
}
