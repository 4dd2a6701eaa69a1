// 2x2/stride-2 max pool on Hopper, NCHW, f32 or bf16, forward and backward.
//   forward:  x (N, C, H, W) -> y (N, C, H/2, W/2), the max of each window
//   backward: x, dL/dy -> dL/dx (N, C, H, W): dL/dy goes to the first
//             maximum of its window in row-major order (h0w0, h0w1, h1w0,
//             h1w1), 0 to the other three corners
//
// Replaces keypoints_tpu/kernels/pool_pallas.py:141 max_pool_2x2_pallas
// (forward _fwd_kernel :92, backward _bwd_kernel :102), in the port's NCHW
// layout (the Pallas kernel is NHWC). The routing is that of XLA's
// select-and-scatter, of F.max_pool2d and of the plain version
// (keypoints_tpu_torch/ops/pool.py): a NaN counts as larger than any number,
// as in torch's argmax. Values are compared in f32, which holds every bf16
// value exactly, so both outputs are copies of input values and the results
// are bit-exact, ties included.
//
// What bounds it: bytes. The forward reads x once and writes y, a quarter of
// its size; the backward reads x and dL/dy and writes dL/dx. At the VGG pools of pose256 b128 in bf16 (pool1: 128 x 64 x
// 256^2 in, pool2: 128 x 128 x 128^2 in) that is 1,342 and 671 MB forward,
// 2,416 and 1,208 MB backward: 401, 200, 721 and 361 us at 3.35 TB/s. One
// compare-select per element; nothing else.
//
// Design: one thread per output element, output index fastest, so a warp's
// stores of y and loads of dL/dy are coalesced and its loads of x are two
// runs of 64 adjacent values. The two horizontal neighbours of a window row
// are one aligned word (bf16x2, or a float2), so each window is two loads.
// The backward recomputes the window's first maximum from x, as the TPU
// kernel does from x and y, and writes all four corners of dL/dx (the
// others as 0), so dL/dx needs no zero fill. The Pallas kernel's selection
// matmuls and its f32 casts for compares work around Mosaic (no sublane
// shuffles, no bf16 vector equality); none of that is needed here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Pair {
  float a, b;
};

__device__ __forceinline__ Pair load_pair(const float* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return {v.x, v.y};
}

// bf16 -> f32 is a 16-bit shift; p[0] is the low half of the word.
__device__ __forceinline__ Pair load_pair(const __nv_bfloat16* p) {
  const unsigned bits = __ldg(reinterpret_cast<const unsigned*>(p));
  return {__uint_as_float(bits << 16), __uint_as_float(bits & 0xffff0000u)};
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// The stored values are copies of bf16 inputs (or 0), so dropping the low
// 16 bits of their f32 form is exact.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *reinterpret_cast<unsigned short*>(p) =
      static_cast<unsigned short>(__float_as_uint(v) >> 16);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<unsigned*>(p) =
      (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u);
}

// Is v the new maximum over best? Strictly larger, or the first NaN.
__device__ __forceinline__ bool beats(float v, float best) {
  return v > best || (v != v && best == best);
}

// The first maximum of (v0, v1, v2, v3): its index, and its value in *m.
__device__ __forceinline__ int first_max(float v0, float v1, float v2,
                                         float v3, float* m) {
  int k = 0;
  float best = v0;
  if (beats(v1, best)) { k = 1; best = v1; }
  if (beats(v2, best)) { k = 2; best = v2; }
  if (beats(v3, best)) { k = 3; best = v3; }
  *m = best;
  return k;
}

// Output element i is column `col` of output row `row` (rows of all planes
// in order); its window starts at input element row * 4 * wo + 2 * col
// (input rows are 2 * wo wide, two of them per output row).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
max_pool_fwd(const T* __restrict__ x, T* __restrict__ y, I total, I wo) {
  const I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const I row = i / wo;
  const I col = i - row * wo;
  const T* top = x + (row * 4 * wo + 2 * col);
  const Pair t = load_pair(top), b = load_pair(top + 2 * wo);
  float m;
  first_max(t.a, t.b, b.a, b.b, &m);
  store(y + i, m);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
max_pool_bwd(const T* __restrict__ x, const T* __restrict__ g,
             T* __restrict__ dx, I total, I wo) {
  const I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const I row = i / wo;
  const I col = i - row * wo;
  const I off = row * 4 * wo + 2 * col;
  const Pair t = load_pair(x + off), b = load_pair(x + off + 2 * wo);
  float m;
  const int k = first_max(t.a, t.b, b.a, b.b, &m);
  const float gv = load(g + i);
  store_pair(dx + off, k == 0 ? gv : 0.0f, k == 1 ? gv : 0.0f);
  store_pair(dx + off + 2 * wo, k == 2 ? gv : 0.0f, k == 3 ? gv : 0.0f);
}

// Shapes are checked and the index type chosen here: 32-bit indices (one
// cheap division a thread) whenever every input offset fits in them.
bool plan(long long planes, int h, int w, long long* total, unsigned* blocks,
          bool* wide) {
  if (planes < 0 || h < 0 || w < 0 || h % 2 || w % 2) return false;
  *total = planes * (h / 2) * (w / 2);
  const long long n_blocks = (*total + kThreads - 1) / kThreads;
  if (n_blocks > 0x7fffffffLL) return false;
  *blocks = static_cast<unsigned>(n_blocks);
  *wide = planes * h * w >= (1LL << 31);
  return true;
}

template <typename T>
void launch_fwd(bool wide, unsigned blocks, const void* x, void* y,
                long long total, int wo, cudaStream_t s) {
  const auto* xi = static_cast<const T*>(x);
  auto* yo = static_cast<T*>(y);
  if (wide)
    max_pool_fwd<T, long long><<<blocks, kThreads, 0, s>>>(xi, yo, total, wo);
  else
    max_pool_fwd<T, unsigned><<<blocks, kThreads, 0, s>>>(
        xi, yo, static_cast<unsigned>(total), static_cast<unsigned>(wo));
}

template <typename T>
void launch_bwd(bool wide, unsigned blocks, const void* x, const void* g,
                void* dx, long long total, int wo, cudaStream_t s) {
  const auto* xi = static_cast<const T*>(x);
  const auto* gi = static_cast<const T*>(g);
  auto* o = static_cast<T*>(dx);
  if (wide)
    max_pool_bwd<T, long long><<<blocks, kThreads, 0, s>>>(xi, gi, o, total,
                                                            wo);
  else
    max_pool_bwd<T, unsigned><<<blocks, kThreads, 0, s>>>(
        xi, gi, o, static_cast<unsigned>(total), static_cast<unsigned>(wo));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, dL/dy, dL/dx alike). planes = N*C.
// x and dL/dx aligned to two elements. Launch on `stream`, return
// cudaGetLastError(); no sync.
extern "C" int kp_max_pool_fwd(int dtype, long long planes, int h, int w,
                               const void* x, void* y, void* stream) {
  long long total;
  unsigned blocks;
  bool wide;
  if ((dtype != 0 && dtype != 1) || !plan(planes, h, w, &total, &blocks,
                                          &wide))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_fwd<float>(wide, blocks, x, y, total, w / 2, s);
  else
    launch_fwd<__nv_bfloat16>(wide, blocks, x, y, total, w / 2, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kp_max_pool_bwd(int dtype, long long planes, int h, int w,
                               const void* x, const void* g, void* dx,
                               void* stream) {
  long long total;
  unsigned blocks;
  bool wide;
  if ((dtype != 0 && dtype != 1) || !plan(planes, h, w, &total, &blocks,
                                          &wide))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_bwd<float>(wide, blocks, x, g, dx, total, w / 2, s);
  else
    launch_bwd<__nv_bfloat16>(wide, blocks, x, g, dx, total, w / 2, s);
  return static_cast<int>(cudaGetLastError());
}
