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
// kernels share the sampler, sample_pixel.
//
// What bounds them: bytes. A warp reads its image once and writes C values
// per output pixel; warp_bilinear also reads 8 bytes of grid per pixel,
// warp_field 8 * F * F bytes of field per image. At the celeba128 train step
// (b128, 3 x 128^2 bf16) warp_bilinear moves 12.6 MB of image + 16.8 MB of
// grid + 12.6 MB of output = 42 MB, 12.5 us at 3.35 TB/s. At pose256's
// (b128, 3 x 256^2 bf16, F = 33) warp_field moves 50.3 + 1.1 + 50.3 = 101.8
// MB, 30.4 us; upsampling to a dense grid and then warping would add 67.1
// MB written and read again. The arithmetic is ~30 flops per pixel (~50
// with the field lerps); the gathers make both latency bound in practice.
//
// Design: one thread per output pixel (b, ho, wo), wo fastest, so the grid
// reads and the per-channel output stores of a warp are coalesced. The
// thread finds its sampling point once, computes the four corner offsets and
// weights once, and loops over C; the gathers go through the read-only
// cache (__ldg), where neighbouring output pixels mostly hit the same lines.
// warp_field's blocks each take 2,048 output pixels of one image (eight a
// thread) and first copy that image's field (8.7 KB at F = 33) into shared
// memory, so the field is read from device memory about once per block.
// The TPU kernels' y-window band, row-pair bf16 packing, tent y-select and
// 128-lane output chunks (warp_pallas.py:114-131, 188-201, 254-272) exist
// because Mosaic cannot gather along sublanes and VMEM holds only a band of
// rows; a CUDA gather reads any row, so none of them is needed and the
// result is grid_sample everywhere, at any Ho and Wo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFieldPixels = 8 * kThreads;  // output pixels a field block warps
constexpr int kMaxField = 78;               // 2 * 78^2 floats < 48 KB

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

// grid_sample of one output pixel at (gx, gy) in [-1, 1] (x, y order):
// unnormalise, the four corners and their weights, border clamp or zero
// weights, then the C channels, each summed in f32 and rounded once. `src`
// is the pixel's image, `dst` its first output channel.
template <typename T, bool kBorder>
__device__ __forceinline__ void sample_pixel(const T* src, T* dst, float gx,
                                             float gy, int c, int h, int w,
                                             long long per_image, bool align) {
  float ix = unnormalize(gx, w, align);
  float iy = unnormalize(gy, h, align);
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
  for (int ch = 0; ch < c; ++ch) {
    const T* s = src + ch * plane;
    float v = load(s + o00) * w00;
    v += load(s + o01) * w01;
    v += load(s + o10) * w10;
    v += load(s + o11) * w11;
    store(dst + ch * per_image, v);
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

// Each block warps kFieldPixels output pixels of one image (blockIdx.y);
// its field, (F, F, 2) f32, is read once into shared memory.
template <typename T, bool kBorder>
__global__ void __launch_bounds__(kThreads)
warp_field(const T* __restrict__ image, const float* __restrict__ field,
           T* __restrict__ out, int c, int h, int w, int f, int ho, int wo,
           float sy, float sx, bool align) {
  extern __shared__ float fs[];
  const int b = blockIdx.y;
  const int n = 2 * f * f;
  const float* fb = field + static_cast<long long>(b) * n;
  for (int k = threadIdx.x; k < n; k += kThreads) fs[k] = __ldg(fb + k);
  __syncthreads();
  const long long plane = static_cast<long long>(h) * w;
  const long long per_image = static_cast<long long>(ho) * wo;
  const T* src = image + static_cast<long long>(b) * c * plane;
  T* dst = out + static_cast<long long>(b) * c * per_image;
  const int first = blockIdx.x * kFieldPixels;
  for (int k = threadIdx.x; k < kFieldPixels; k += kThreads) {
    const int pix = first + k;
    if (pix >= per_image) return;
    const int y = pix / wo, x = pix - y * wo;
    float fy, fx;
    const int r = field_cell(y, sy, f, &fy);
    const int q = field_cell(x, sx, f, &fx);
    // upsample_field_aligned: lerp between field rows r and r + 1 at
    // columns q and q + 1, then between the two columns
    const float* top = fs + 2 * (r * f + q);
    const float* bot = top + 2 * f;
    const float gx = lerp_rn(lerp_rn(top[0], bot[0], fy),
                             lerp_rn(top[2], bot[2], fy), fx);
    const float gy = lerp_rn(lerp_rn(top[1], bot[1], fy),
                             lerp_rn(top[3], bot[3], fy), fx);
    sample_pixel<T, kBorder>(src, dst + pix, gx, gy, c, h, w, per_image,
                             align);
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
void launch_field(bool border, const void* image, const void* field,
                  void* out, int b, int c, int h, int w, int f, int ho,
                  int wo, bool align, cudaStream_t s) {
  const long long per_image = static_cast<long long>(ho) * wo;
  const dim3 blocks(
      static_cast<unsigned>((per_image + kFieldPixels - 1) / kFieldPixels),
      static_cast<unsigned>(b));
  const size_t smem = sizeof(float) * 2 * f * f;
  // align_corners=True positions: i * (F - 1) / (n - 1), the scale rounded
  // to f32 once, as torch rounds a Python float it multiplies a tensor by
  const double span = static_cast<double>(f - 1);
  const float sy = ho > 1 ? static_cast<float>(span / (ho - 1)) : 0.0f;
  const float sx = wo > 1 ? static_cast<float>(span / (wo - 1)) : 0.0f;
  const auto* im = static_cast<const T*>(image);
  const auto* fl = static_cast<const float*>(field);
  auto* o = static_cast<T*>(out);
  if (border)
    warp_field<T, true><<<blocks, kThreads, smem, s>>>(im, fl, o, c, h, w, f,
                                                       ho, wo, sy, sx, align);
  else
    warp_field<T, false><<<blocks, kThreads, smem, s>>>(im, fl, o, c, h, w, f,
                                                        ho, wo, sy, sx, align);
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
// Wo). dtype and padding as above; 2 <= F <= kMaxField (the field of one
// image fits the 48 KB of shared memory a launch gets without opting in),
// Ho * Wo < 2^31, B <= 65535.
extern "C" int kp_warp_field(int dtype, int padding, int align_corners,
                             int b, int c, int h, int w, int f, int ho, int wo,
                             const void* image, const void* field, void* out,
                             void* stream) {
  if (b < 0 || b > 65535 || c < 0 || h < 1 || w < 1 || f < 2 ||
      f > kMaxField || ho < 0 || wo < 0 ||
      static_cast<long long>(ho) * wo >= (1LL << 31) ||
      (dtype != 0 && dtype != 1) || (padding != 0 && padding != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || c == 0 || ho == 0 || wo == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_field<float>(padding == 1, image, field, out, b, c, h, w, f, ho, wo,
                        align_corners != 0, s);
  else
    launch_field<__nv_bfloat16>(padding == 1, image, field, out, b, c, h, w, f,
                                ho, wo, align_corners != 0, s);
  return static_cast<int>(cudaGetLastError());
}
