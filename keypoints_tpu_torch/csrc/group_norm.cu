// GroupNorm + ReLU on Hopper, NCHW, f32 or bf16, forward and backward.
//   forward:  x (N, C, H, W), gamma, beta (C) f32, G groups, eps ->
//             y = relu(gamma * (x - mu) * rstd + beta) in x's dtype, and
//             mu, rstd (N, G) f32 (biased variance, eps inside the root, as
//             F.group_norm)
//   backward: dL/dy, x, mu, rstd, gamma, beta -> dL/dx in x's dtype, and
//             dL/dgamma, dL/dbeta (C) f32
//
// Replaces no TPU kernel. The JAX package leaves the norm to flax and XLA,
// which fuses it with its casts and the ReLU into the conv's neighbours. In
// eager PyTorch every conv block of Phi, Psi and the decoder ran it as a
// chain of aten kernels: an upcast to f32, the moments, the affine, a
// downcast and the ReLU forward, five more passes backward, ~66 bytes an
// element, with an f32 copy of each conv output kept for the backward. The
// chain was the largest share of the celeba128 train step (PERF.md). The
// math here is the module's: statistics and affine in f32, one rounding to
// x's dtype at the end.
//
// What bounds it: bytes. The forward needs to read x and write y (4 bytes
// an element in bf16), the backward to read dL/dy and x and write dL/dx (6),
// plus (N, G) statistics and (N, C) partial sums. At celeba128's paper
// widths, b128 bf16, the 23 blocks of a step normalise 688 M elements:
// 2.75 GB forward and 4.1 GB backward, 0.82 + 1.23 ms at 3.35 TB/s.
//
// Design. In NCHW a group of a sample (a slice) is contiguous, C/G * H * W
// elements, and its statistics need all of it before the first output, so
// a block takes a slice. Forward: a slice of up to kThreads * kMaxHeld
// 16-byte vectors (64 K bf16 or 32 K f32 values; every slice of celeba128
// and transporter_atari in bf16) is held in registers, R vectors a thread
// with R a power of two: read once, summed, normalised and written from the
// registers (gn_relu_fwd_held). Larger slices, and ragged H * W or
// unaligned tensors (scalar loads), read the slice twice (gn_relu_fwd): the
// grid is persistent, sized so that the slices in flight fill at most
// kReuseBytes, half the L2, and the second read finds the first's lines
// there. Backward (gn_relu_bwd), on the same persistent grid: pass 1 has a
// warp per (channel, part of a channel), a channel cut into parts so that
// every warp has one when C/G is under the block's warps, and sums dz and
// dz * xhat; the parts are added in order into the (n, c) sums, which go to
// a (N, C) scratch, and their gamma-weighted totals over the slice give dx's
// two slice terms; pass 2 rereads the slice from L2 and writes dL/dx. A
// second small kernel (gn_relu_bwd_params) adds the (n, c) sums over n in a
// fixed order into dL/dgamma and dL/dbeta. Statistics are shifted sums (x
// minus the slice's first element, so an offset far above the spread costs
// no precision) reduced by shuffles a warp, then across warps in warp
// order: no float atomics anywhere, so two runs give the same bits. The
// affine is formed with pinned roundings (__fmul_rn, __fmaf_rn) in both
// kernels, so the backward recomputes the forward's f32 value before its
// rounding, and its ReLU mask, bit for bit: no y and no f32 copy is kept.
// Nothing allocates or synchronises: CUDA graphs capture both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using kpcommon::kWarp;
using kpcommon::warp_sum;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
// 16-byte vectors a forward thread holds at most
constexpr int kMaxHeld = 16;
// bytes of slices a persistent grid keeps in flight: half of the H100's
// 50 MB L2, so a slice's second read hits the lines its first one brought
constexpr long long kReuseBytes = 24LL << 20;
// channels a group at most: the backward's per-part sums live in 48 KB of
// shared memory
constexpr int kMaxGroupChannels = 4096;
// the parameter-gradient kernel: 32 channels a block, kParamRows rows of n
constexpr int kParamRows = 8;

template <typename T>
struct Elems;
template <>
struct Elems<float> {
  static constexpr int kVec = 4;
};
template <>
struct Elems<__nv_bfloat16> {
  static constexpr int kVec = 8;
};

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

// bf16 -> f32 is a 16-bit shift
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A 16-byte vector as 4 f32 or 8 bf16 values (element 0 in the low half).
__device__ __forceinline__ void unpack(uint4 r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(uint4 r, float (&v)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// E values at p: one 16-byte vector (E = Elems<T>::kVec) or one scalar.
template <typename T, int E>
__device__ __forceinline__ void load(const T* p, float (&v)[E]) {
  static_assert(E == 1 || E == Elems<T>::kVec, "a vector or a scalar");
  if constexpr (E == 1)
    v[0] = load1(p);
  else
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

template <typename T, int E>
__device__ __forceinline__ void store(T* p, const float (&v)[E]) {
  static_assert(E == 1 || E == Elems<T>::kVec, "a vector or a scalar");
  if constexpr (E == 1)
    store1(p, v[0]);
  else
    *reinterpret_cast<uint4*>(p) = pack(v);
}

struct Affine {
  float a, b;
};

// Channel c's affine over its slice's statistics: z = x * a + b with
// a = gamma * rstd, b = beta - mu * a, every rounding pinned, so both
// kernels compute the same z.
__device__ __forceinline__ Affine affine(const float* gamma,
                                         const float* beta, int c,
                                         float mean, float rstd) {
  const float a = __fmul_rn(__ldg(gamma + c), rstd);
  return {a, __fmaf_rn(-mean, a, __ldg(beta + c))};
}

__device__ __forceinline__ float pre_relu(float x, Affine f) {
  return __fmaf_rn(x, f.a, f.b);
}

// torch's relu and its backward mask: z <= 0 gives 0, a NaN passes
__device__ __forceinline__ bool passes(float z) { return !(z <= 0.0f); }

__device__ __forceinline__ float relu(float z) {
  return passes(z) ? z : 0.0f;
}

__device__ __forceinline__ float xhat(float x, float mean, float rstd) {
  return __fmul_rn(x - mean, rstd);
}

// The block's sums of a and b: shuffles a warp, then the warps' sums in
// warp order by warp 0. Every thread gets them. scratch holds kWarps + 1.
__device__ float2 block_sum2(float a, float b, float2* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 p = lane < kWarps ? scratch[lane] : make_float2(0.0f, 0.0f);
    p.x = warp_sum(p.x);
    p.y = warp_sum(p.y);
    if (lane == 0) scratch[kWarps] = p;
  }
  __syncthreads();
  return scratch[kWarps];
}

struct Stats {
  float mean, rstd;
};

// From the sums of d = x - pivot and of d^2 over a slice of m values.
__device__ __forceinline__ Stats slice_stats(float2 t, float pivot, int m,
                                             float eps) {
  const float inv = 1.0f / static_cast<float>(m);
  const float d = t.x * inv;
  const float var = fmaxf(fmaf(-d, d, t.y * inv), 0.0f);
  return {pivot + d, rsqrtf(var + eps)};
}

__device__ __forceinline__ void accumulate(float v, float pivot, float* sum,
                                           float* sq) {
  const float d = v - pivot;
  *sum += d;
  *sq = fmaf(d, d, *sq);
}

// Forward, a slice a block held in registers: R vectors a thread, vector i
// of the slice in thread i % kThreads.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
gn_relu_fwd_held(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ y,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                 int groups, int cg, int hw, float eps) {
  constexpr int E = Elems<T>::kVec;
  __shared__ float2 scratch[kWarps + 1];
  const int s = blockIdx.x;
  const int m = cg * hw, vecs = m / E, per_channel = hw / E;
  const long long base = static_cast<long long>(s) * m;
  const uint4* xs = reinterpret_cast<const uint4*>(x + base);
  const float pivot = load1(x + base);
  uint4 held[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * kThreads;
    held[r] = i < vecs ? __ldg(xs + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (threadIdx.x + r * kThreads < vecs) {
      float v[E];
      unpack(held[r], v);
#pragma unroll
      for (int e = 0; e < E; ++e) accumulate(v[e], pivot, &sum, &sq);
    }
  }
  const Stats st = slice_stats(block_sum2(sum, sq, scratch), pivot, m, eps);
  if (threadIdx.x == 0) {
    mean_out[s] = st.mean;
    rstd_out[s] = st.rstd;
  }
  const int c0 = (s % groups) * cg;
  uint4* ys = reinterpret_cast<uint4*>(y + base);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i < vecs) {
      const Affine f = affine(gamma, beta, c0 + i / per_channel, st.mean,
                              st.rstd);
      float v[E];
      unpack(held[r], v);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = relu(pre_relu(v[e], f));
      ys[i] = pack(v);
    }
  }
}

// Forward, read twice: blocks loop over slices (a persistent grid), E
// values a step (a 16-byte vector, or 1).
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
gn_relu_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, T* __restrict__ y,
            float* __restrict__ mean_out, float* __restrict__ rstd_out,
            int count, int groups, int cg, int hw, float eps) {
  __shared__ float2 scratch[kWarps + 1];
  const int m = cg * hw, steps = m / E, per_channel = hw / E;
  for (int s = blockIdx.x; s < count; s += gridDim.x) {
    const long long base = static_cast<long long>(s) * m;
    const T* xs = x + base;
    const float pivot = load1(xs);
    float sum = 0.0f, sq = 0.0f;
#pragma unroll 4
    for (int i = threadIdx.x; i < steps; i += kThreads) {
      float v[E];
      load<T, E>(xs + i * E, v);
#pragma unroll
      for (int e = 0; e < E; ++e) accumulate(v[e], pivot, &sum, &sq);
    }
    const Stats st = slice_stats(block_sum2(sum, sq, scratch), pivot, m, eps);
    if (threadIdx.x == 0) {
      mean_out[s] = st.mean;
      rstd_out[s] = st.rstd;
    }
    const int c0 = (s % groups) * cg;
    T* ys = y + base;
#pragma unroll 4
    for (int i = threadIdx.x; i < steps; i += kThreads) {
      const Affine f = affine(gamma, beta, c0 + i / per_channel, st.mean,
                              st.rstd);
      float v[E];
      load<T, E>(xs + i * E, v);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = relu(pre_relu(v[e], f));
      store<T, E>(ys + i * E, v);
    }
  }
}

// Backward on a persistent grid. part: (N * C) float2 of (sum dz * xhat,
// sum dz), the (n, c) partials of dL/dgamma and dL/dbeta. Dynamic shared
// memory: cg * parts float2.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
gn_relu_bwd(const T* __restrict__ dy, const T* __restrict__ x,
            const float* __restrict__ mean_in,
            const float* __restrict__ rstd_in,
            const float* __restrict__ gamma, const float* __restrict__ beta,
            T* __restrict__ dx, float2* __restrict__ part, int count,
            int groups, int cg, int hw, int parts) {
  extern __shared__ float2 items[];
  __shared__ float2 scratch[kWarps + 1];
  const int m = cg * hw, steps = m / E, per_channel = hw / E;
  const int len = (per_channel + parts - 1) / parts;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const float inv_m = 1.0f / static_cast<float>(m);
  for (int s = blockIdx.x; s < count; s += gridDim.x) {
    const long long base = static_cast<long long>(s) * m;
    const T* xs = x + base;
    const T* gs = dy + base;
    const float mean = mean_in[s], rstd = rstd_in[s];
    const int c0 = (s % groups) * cg;
    // pass 1: a warp an item (a channel's part): sums of dz and dz * xhat
    for (int item = warp; item < cg * parts; item += kWarps) {
      const int c = item / parts;
      const int lo = (item - c * parts) * len;
      const int hi = min(lo + len, per_channel);
      const Affine f = affine(gamma, beta, c0 + c, mean, rstd);
      const T* xc = xs + c * hw;
      const T* gc = gs + c * hw;
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
      for (int j = lo + lane; j < hi; j += kWarp) {
        float xv[E], gv[E];
        load<T, E>(xc + j * E, xv);
        load<T, E>(gc + j * E, gv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dz = passes(pre_relu(xv[e], f)) ? gv[e] : 0.0f;
          s1 += dz;
          s2 = fmaf(dz, xhat(xv[e], mean, rstd), s2);
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) items[item] = make_float2(s1, s2);
    }
    __syncthreads();
    // a channel's parts in order: its (n, c) sums, and the slice's
    // gamma-weighted totals
    float a = 0.0f, b = 0.0f;
    for (int c = threadIdx.x; c < cg; c += kThreads) {
      float2 t = items[c * parts];
      for (int p = 1; p < parts; ++p) {
        t.x += items[c * parts + p].x;
        t.y += items[c * parts + p].y;
      }
      part[static_cast<long long>(s) * cg + c] = make_float2(t.y, t.x);
      const float g = __ldg(gamma + c0 + c);
      a = fmaf(g, t.x, a);
      b = fmaf(g, t.y, b);
    }
    // its syncs also keep the next slice's pass 1 off items until every
    // thread has read them
    const float2 tot = block_sum2(a, b, scratch);
    const float ka = rstd * (tot.x * inv_m), kb = rstd * (tot.y * inv_m);
    // pass 2: dx = rstd * (gamma dz - sum(gamma dz) / m - xhat *
    // sum(gamma dz xhat) / m)
    T* ds = dx + base;
#pragma unroll 4
    for (int i = threadIdx.x; i < steps; i += kThreads) {
      const Affine f = affine(gamma, beta, c0 + i / per_channel, mean, rstd);
      float xv[E], gv[E];
      load<T, E>(xs + i * E, xv);
      load<T, E>(gs + i * E, gv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float dz = passes(pre_relu(xv[e], f)) ? gv[e] : 0.0f;
        xv[e] = fmaf(f.a, dz, -fmaf(xhat(xv[e], mean, rstd), kb, ka));
      }
      store<T, E>(ds + i * E, xv);
    }
  }
}

// dL/dgamma and dL/dbeta: the (n, c) partials added over n. A block takes
// 32 channels; its row r adds n = r, r + kParamRows, ... in order, then row
// 0 adds the rows' sums in order.
__global__ void __launch_bounds__(kWarp * kParamRows)
gn_relu_bwd_params(const float2* __restrict__ part,
                   float* __restrict__ dgamma, float* __restrict__ dbeta,
                   int n, int c) {
  __shared__ float2 rows[kParamRows][kWarp];
  const int ch = blockIdx.x * kWarp + threadIdx.x;
  float2 t = make_float2(0.0f, 0.0f);
  if (ch < c) {
    for (int i = threadIdx.y; i < n; i += kParamRows) {
      const float2 p = __ldg(part + static_cast<long long>(i) * c + ch);
      t.x += p.x;
      t.y += p.y;
    }
  }
  rows[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    for (int r = 1; r < kParamRows; ++r) {
      t.x += rows[r][threadIdx.x].x;
      t.y += rows[r][threadIdx.x].y;
    }
    dgamma[ch] = t.x;
    dbeta[ch] = t.y;
  }
}

// Blocks of a grid that reads each slice twice: slices in flight fill at
// most kReuseBytes, but at least one block an SM, at most one a slice.
unsigned persistent_blocks(long long count, int sms, long long slice_bytes) {
  long long blocks = kReuseBytes / (slice_bytes > 0 ? slice_bytes : 1);
  if (blocks < sms) blocks = sms;
  if (blocks > count) blocks = count;
  return static_cast<unsigned>(blocks);
}

// The shapes both entry points take; false for anything else.
bool valid(int dtype, int sms, long long n, int c, int groups, int hw) {
  if ((dtype != 0 && dtype != 1) || sms < 1 || n < 0 || c < 1 ||
      groups < 1 || c % groups || hw < 1)
    return false;
  const int cg = c / groups;
  return cg <= kMaxGroupChannels &&
         static_cast<long long>(cg) * hw < (1LL << 31) &&
         n * groups < (1LL << 31);
}

template <typename T, int R>
void launch_held(long long count, const void* x, const void* gamma,
                 const void* beta, void* y, void* mean, void* rstd,
                 int groups, int cg, int hw, float eps, cudaStream_t s) {
  gn_relu_fwd_held<T, R><<<static_cast<unsigned>(count), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), groups, cg, hw,
      eps);
}

template <typename T>
void launch_fwd(bool vec, int sms, long long count, const void* x,
                const void* gamma, const void* beta, void* y, void* mean,
                void* rstd, int groups, int cg, int hw, float eps,
                cudaStream_t s) {
  constexpr int E = Elems<T>::kVec;
  const long long m = static_cast<long long>(cg) * hw;
  if (vec) {
    const long long per_thread = (m / E + kThreads - 1) / kThreads;
    if (per_thread <= 1)
      return launch_held<T, 1>(count, x, gamma, beta, y, mean, rstd, groups,
                               cg, hw, eps, s);
    if (per_thread <= 2)
      return launch_held<T, 2>(count, x, gamma, beta, y, mean, rstd, groups,
                               cg, hw, eps, s);
    if (per_thread <= 4)
      return launch_held<T, 4>(count, x, gamma, beta, y, mean, rstd, groups,
                               cg, hw, eps, s);
    if (per_thread <= 8)
      return launch_held<T, 8>(count, x, gamma, beta, y, mean, rstd, groups,
                               cg, hw, eps, s);
    if (per_thread <= kMaxHeld)
      return launch_held<T, kMaxHeld>(count, x, gamma, beta, y, mean, rstd,
                                      groups, cg, hw, eps, s);
  }
  const unsigned blocks =
      persistent_blocks(count, sms, m * static_cast<long long>(sizeof(T)));
  const auto* xi = static_cast<const T*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* yo = static_cast<T*>(y);
  auto* mo = static_cast<float*>(mean);
  auto* ro = static_cast<float*>(rstd);
  const int cnt = static_cast<int>(count);
  if (vec)
    gn_relu_fwd<T, E><<<blocks, kThreads, 0, s>>>(xi, g, b, yo, mo, ro, cnt,
                                                  groups, cg, hw, eps);
  else
    gn_relu_fwd<T, 1><<<blocks, kThreads, 0, s>>>(xi, g, b, yo, mo, ro, cnt,
                                                  groups, cg, hw, eps);
}

template <typename T>
void launch_bwd(bool vec, int sms, long long count, const void* dy,
                const void* x, const void* mean, const void* rstd,
                const void* gamma, const void* beta, void* dx, void* part,
                int groups, int cg, int hw, cudaStream_t s) {
  constexpr int E = Elems<T>::kVec;
  const int parts = cg < kWarps ? kWarps / cg : 1;
  const size_t smem = sizeof(float2) * static_cast<size_t>(cg) * parts;
  const unsigned blocks = persistent_blocks(
      count, sms, 2 * static_cast<long long>(cg) * hw *
                      static_cast<long long>(sizeof(T)));
  const auto* gi = static_cast<const T*>(dy);
  const auto* xi = static_cast<const T*>(x);
  const auto* mi = static_cast<const float*>(mean);
  const auto* ri = static_cast<const float*>(rstd);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* o = static_cast<T*>(dx);
  auto* p = static_cast<float2*>(part);
  const int cnt = static_cast<int>(count);
  if (vec)
    gn_relu_bwd<T, E><<<blocks, kThreads, smem, s>>>(
        gi, xi, mi, ri, g, b, o, p, cnt, groups, cg, hw, parts);
  else
    gn_relu_bwd<T, 1><<<blocks, kThreads, smem, s>>>(
        gi, xi, mi, ri, g, b, o, p, cnt, groups, cg, hw, parts);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, dL/dy, dL/dx alike; gamma, beta,
// mu, rstd and the parameter gradients are float32). vec: 1 takes 16-byte
// vector loads and stores, which needs every x, y, dL/dy, dL/dx pointer
// 16-byte aligned and H * W a multiple of 16 / sizeof(dtype); 0 takes
// scalar ones. sms: the device's streaming multiprocessors. Launch on
// `stream`, return cudaGetLastError(); no sync, no allocation.
extern "C" int kp_gn_relu_fwd(int dtype, int vec, int sms, long long n,
                              int c, int groups, int hw, float eps,
                              const void* x, const void* gamma,
                              const void* beta, void* y, void* mean,
                              void* rstd, void* stream) {
  if (!valid(dtype, sms, n, c, groups, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long count = n * groups;
  if (count == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int cg = c / groups;
  if (dtype == 0)
    launch_fwd<float>(vec != 0, sms, count, x, gamma, beta, y, mean, rstd,
                      groups, cg, hw, eps, s);
  else
    launch_fwd<__nv_bfloat16>(vec != 0, sms, count, x, gamma, beta, y, mean,
                              rstd, groups, cg, hw, eps, s);
  return static_cast<int>(cudaGetLastError());
}

// part: scratch of N * C * 2 floats, written before it is read.
extern "C" int kp_gn_relu_bwd(int dtype, int vec, int sms, long long n,
                              int c, int groups, int hw, const void* dy,
                              const void* x, const void* mean,
                              const void* rstd, const void* gamma,
                              const void* beta, void* dx, void* part,
                              void* dgamma, void* dbeta, void* stream) {
  if (!valid(dtype, sms, n, c, groups, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long count = n * groups;
  const int cg = c / groups;
  if (count > 0) {
    if (dtype == 0)
      launch_bwd<float>(vec != 0, sms, count, dy, x, mean, rstd, gamma, beta,
                        dx, part, groups, cg, hw, s);
    else
      launch_bwd<__nv_bfloat16>(vec != 0, sms, count, dy, x, mean, rstd,
                                gamma, beta, dx, part, groups, cg, hw, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gn_relu_bwd_params<<<(c + kWarp - 1) / kWarp, dim3(kWarp, kParamRows), 0,
                       s>>>(static_cast<const float2*>(part),
                            static_cast<float*>(dgamma),
                            static_cast<float*>(dbeta),
                            static_cast<int>(n), c);
  return static_cast<int>(cudaGetLastError());
}
