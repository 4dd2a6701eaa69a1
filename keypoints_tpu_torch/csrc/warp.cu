// Bilinear warp on Hopper: image (B, C, H, W) f32 or bf16, grid (B, Ho, Wo, 2)
// f32 (x, y) in [-1, 1] -> (B, C, Ho, Wo) in the image's dtype.
//
// Replaces keypoints_tpu/kernels/warp_pallas.py:447 warp_bilinear_pallas
// (_warp_kernel :93, index math _grid_math :63). It computes exactly
// torch.nn.functional.grid_sample in bilinear mode with padding_mode zeros
// or border and an explicit align_corners: the corner, clip and zero-weight
// rules of _grid_math and of keypoints_tpu/ops/warp.py:85-110. Index and
// weight arithmetic is f32 whatever the image's dtype; the four-corner sum
// is taken in f32 and rounded once to the output dtype (round to nearest
// even for bf16), as the Pallas kernel casts its f32 result at :202.
//
// What bounds it: each output pixel reads its grid point (8 bytes), four
// image pixels per channel and writes C pixels. Counting each input once,
// one warp of the celeba128 train step (b128, 3 x 128^2 bf16) moves 12.6 MB
// of image + 16.8 MB of grid + 12.6 MB of output = 42 MB, 12.5 us at 3.35
// TB/s; the arithmetic is ~30 flops per pixel. It is memory bound, and the
// gathers make it latency bound in practice.
//
// Design: one thread per output pixel (b, ho, wo), wo fastest, so the grid
// reads and the per-channel output stores of a warp are coalesced. The
// thread reads its grid point once, computes the four corner offsets and
// weights once, and loops over C; the gathers go through the read-only
// cache (__ldg), where neighbouring output pixels mostly hit the same lines.
// The TPU kernel's y-window band, row-pair bf16 packing and tent y-select
// (warp_pallas.py:114-131, 188-201) exist because Mosaic cannot gather along
// sublanes and VMEM holds only a band of rows; a CUDA gather reads any row,
// so none of them is needed and the result is grid_sample everywhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid_sample's unnormalize: [-1, 1] -> fractional pixel index.
__device__ __forceinline__ float unnormalize(float c, int size, bool align) {
  if (align) return (c + 1.0f) * 0.5f * static_cast<float>(size - 1);
  return (c + 1.0f) * 0.5f * static_cast<float>(size) - 0.5f;
}

__device__ __forceinline__ int clamp_index(float v, int size) {
  return static_cast<int>(fminf(fmaxf(v, 0.0f), static_cast<float>(size - 1)));
}

template <typename T, bool kBorder>
__global__ void __launch_bounds__(kThreads)
warp_bilinear(const T* __restrict__ image, const float* __restrict__ grid,
              T* __restrict__ out, long long total, int c, int h, int w,
              long long per_image, bool align) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long b = i / per_image;
  const long long pix = i - b * per_image;
  float ix = unnormalize(__ldg(grid + 2 * i), w, align);
  float iy = unnormalize(__ldg(grid + 2 * i + 1), h, align);
  if (kBorder) {
    ix = fminf(fmaxf(ix, 0.0f), static_cast<float>(w - 1));
    iy = fminf(fmaxf(iy, 0.0f), static_cast<float>(h - 1));
  }
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
  const float wx1 = ix - x0, wy1 = iy - y0;
  const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
  // corners in the order of ops/warp.py: (y0,x0), (y0,x1), (y1,x0), (y1,x1)
  float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;
  if (!kBorder) {
    const float wm = static_cast<float>(w - 1), hm = static_cast<float>(h - 1);
    const bool vx0 = x0 >= 0.0f && x0 <= wm, vx1 = x1 >= 0.0f && x1 <= wm;
    const bool vy0 = y0 >= 0.0f && y0 <= hm, vy1 = y1 >= 0.0f && y1 <= hm;
    w00 = (vy0 && vx0) ? w00 : 0.0f;
    w01 = (vy0 && vx1) ? w01 : 0.0f;
    w10 = (vy1 && vx0) ? w10 : 0.0f;
    w11 = (vy1 && vx1) ? w11 : 0.0f;
  }
  const int xi0 = clamp_index(x0, w), xi1 = clamp_index(x1, w);
  const int yi0 = clamp_index(y0, h), yi1 = clamp_index(y1, h);
  const int o00 = yi0 * w + xi0, o01 = yi0 * w + xi1;
  const int o10 = yi1 * w + xi0, o11 = yi1 * w + xi1;
  const long long plane = static_cast<long long>(h) * w;
  const T* src = image + b * c * plane;
  T* dst = out + b * c * per_image + pix;
  for (int ch = 0; ch < c; ++ch) {
    const T* s = src + ch * plane;
    float v = load(s + o00) * w00;
    v += load(s + o01) * w01;
    v += load(s + o10) * w10;
    v += load(s + o11) * w11;
    store(dst + ch * per_image, v);
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
