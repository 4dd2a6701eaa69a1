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
//
// NHWC (channels_last) pair, gn_relu_fwd_nhwc and gn_relu_bwd_nhwc: the
// same math (shifted sums, pinned affine, the mask recomputed, no float
// atomics) over another layout. cuDNN's bf16 convs on sm90 are NHWC
// kernels, so the nets hand them channels_last activations, and the norm
// between two convs must take that layout or the transposes come back. In
// NHWC a group of a sample is not contiguous: each pixel holds C/G
// channels of it beside the other groups' (8 bytes at C = 32 in bf16); a
// sample, H * W * C values, is. So a cluster of CTAs takes a sample, CTA
// rank k the k-th run of its pixels, and the cluster adds its sums over
// distributed shared memory. The runs are cut to fit kStageBytes (64 KB;
// celeba128's 1 MiB samples at 32@128^2 in bf16 take 16 CTAs, a cluster
// above the portable 8) and copied into shared memory with cp.async, so
// both passes read them there, with three CTAs an SM: device memory is
// read once and written once. A column is one 16-byte vector of a pixel's
// channels (or one value, on the scalar path); thread t takes column t %
// cols' (cols' = C / vector rounded up to a power of two; threads past the
// columns idle) of pixels t / cols', t / cols' + rows, ... of the run (a
// sweep is rows = kNhwcThreads / cols' pixels), so a thread's channels are
// fixed and neighbouring threads read neighbouring vectors. A thread keeps
// its channels' sums in registers: the backward's per-(n, c) sums of dz
// and dz * (x - mean) need no cross-lane work until the end. Lanes of one
// column meet by shuffles, then warps or rows in shared memory, a group's
// channels in a warp, the cluster's CTAs as a tree (added in a row, 16
// slots and 64 channels put a one-group mean past the tolerance the NCHW
// pair meets). The forward reads the other CTAs' group sums after the
// cluster's barrier. The backward stages x and dL/dy where both fit, else
// x alone and reads dL/dy twice (the second time from L2); it copies its
// runs in kChunks commit groups and sums each chunk as it lands, pushes
// its groups' gamma-weighted sums into every CTA's shared memory before
// the cluster's one barrier, and writes its run's (n, c) sums to its own
// row of the parameters' scratch, which gn_relu_bwd_params adds up. Where
// x is not staged (the scalar path: C not a multiple of a vector,
// unaligned tensors; runs too long for a cluster), the clusters loop over
// samples, as many as keep kReuseBytes in flight, so the second read
// finds the first's lines in L2. On the H100 the pair still takes
// 1.2-1.7x the NCHW pair's time at celeba128's shapes (PERF.md, with the
// designs measured slower).
//
// The conv's bias (cb, optional, in x's dtype). cuDNN does not fuse a conv's
// bias: PyTorch runs the conv, then a broadcast add over its output, and in
// the backward sums the gradient over N, H and W, two more passes over an
// activation that these kernels read anyway. So a block's conv runs without
// its bias and both pairs take it: they form z = x + cb as they load x (the
// sum in f32, rounded once to x's dtype, as aten's add does, so z is bit
// for bit the tensor conv-then-add wrote), normalise z, and the backward
// recomputes z the same way. dL/dcb is the sum over n, h, w of dL/dz =
// dL/dx, formed without a pass of its own: pass 2 writes each value as a
// dz - (d k1 + k0) (a = gamma rstd, k0 and k1 the group's terms, d = z -
// mean in NHWC, xhat in NCHW), so a channel's sum is a sum(dz) - (k1
// sum(d) + k0 count), and pass 1, which sums dz already, also sums d.
// Those (n, c) partials (a row of the NHWC scratch a CTA) are added over
// the rows by gn_relu_bwd_params in the same fixed order as dL/dgamma and
// dL/dbeta. It is the sum of the f32 values before their rounding to x's
// dtype (the unfused chain summed the rounded ones). Summing the written
// values in pass 2 cost registers the NHWC backward does not have at three
// CTAs an SM: it spilled and took 1.24x its time. Every kernel is a template
// on the fold (kFold), so a launch without cb runs as before. Where the
// NHWC backward stages x, its pass 1 writes z over x in shared memory, so
// pass 2 holds no bias (the forward folds in both passes: its write-back
// measured slower).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

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
// NHWC: threads a CTA, and channels at most (a column a thread)
constexpr int kNhwcThreads = 256;
constexpr int kNhwcWarps = kNhwcThreads / kWarp;
// NHWC backward: CTAs an SM its registers must leave room for
constexpr int kNhwcBlocks = 3;
// NHWC: CTAs a cluster (a sample) at most; above the portable 8, which
// Hopper allows on request (group_norm_cuda.MAX_NHWC_CLUSTER)
constexpr int kMaxCluster = 16;
// NHWC: bytes of a CTA's runs staged in shared memory at most: three CTAs
// an SM, so one's copies and passes overlap another's
constexpr long long kStageBytes = 64 << 10;
// NHWC: commit groups a run is copied in; pass 1 sums each as it lands
constexpr int kChunks = 4;
constexpr size_t kDefaultSmem = 48 * 1024;  // without an opt-in

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

// v rounded to T's precision (to nearest even), and back to f32
template <typename T>
__device__ __forceinline__ float to_dtype(float v);
template <>
__device__ __forceinline__ float to_dtype<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_dtype<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// z = x + b in x's dtype: the f32 sum rounded once, as aten's add of the
// conv's bias.
template <typename T, int E>
__device__ __forceinline__ void fold(float (&v)[E], float b) {
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = to_dtype<T>(v[e] + b);
}

struct Affine {
  float a, b;
};

// A channel's affine over its slice's statistics: z = x * a + b with
// a = gamma * rstd, b = beta - mu * a, every rounding pinned, so every
// kernel computes the same z.
__device__ __forceinline__ Affine affine_of(float gamma, float beta,
                                            float mean, float rstd) {
  const float a = __fmul_rn(gamma, rstd);
  return {a, __fmaf_rn(-mean, a, beta)};
}

// affine_of() for channel c of gamma and beta in device memory.
__device__ __forceinline__ Affine affine(const float* gamma,
                                         const float* beta, int c,
                                         float mean, float rstd) {
  return affine_of(__ldg(gamma + c), __ldg(beta + c), mean, rstd);
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
// of the slice in thread i % kThreads. kFold: cb is given and folded in.
template <typename T, int R, bool kFold>
__global__ void __launch_bounds__(kThreads)
gn_relu_fwd_held(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ cb,
                 T* __restrict__ y, float* __restrict__ mean_out,
                 float* __restrict__ rstd_out, int groups, int cg, int hw,
                 float eps) {
  constexpr int E = Elems<T>::kVec;
  __shared__ float2 scratch[kWarps + 1];
  const int s = blockIdx.x;
  const int m = cg * hw, vecs = m / E, per_channel = hw / E;
  const long long base = static_cast<long long>(s) * m;
  const uint4* xs = reinterpret_cast<const uint4*>(x + base);
  float pivot = load1(x + base);
  if constexpr (kFold)
    pivot = to_dtype<T>(pivot + load1(cb + (s % groups) * cg));
  uint4 held[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * kThreads;
    held[r] = i < vecs ? __ldg(xs + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i < vecs) {
      float v[E];
      unpack(held[r], v);
      if constexpr (kFold)
        fold<T>(v, load1(cb + (s % groups) * cg + i / per_channel));
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
      const int c = c0 + i / per_channel;
      const Affine f = affine(gamma, beta, c, st.mean, st.rstd);
      float v[E];
      unpack(held[r], v);
      if constexpr (kFold) fold<T>(v, load1(cb + c));
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = relu(pre_relu(v[e], f));
      ys[i] = pack(v);
    }
  }
}

// Forward, read twice: blocks loop over slices (a persistent grid), E
// values a step (a 16-byte vector, or 1). kFold as above.
template <typename T, int E, bool kFold>
__global__ void __launch_bounds__(kThreads)
gn_relu_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
            const float* __restrict__ beta, const T* __restrict__ cb,
            T* __restrict__ y, float* __restrict__ mean_out,
            float* __restrict__ rstd_out, int count, int groups, int cg,
            int hw, float eps) {
  __shared__ float2 scratch[kWarps + 1];
  const int m = cg * hw, steps = m / E, per_channel = hw / E;
  for (int s = blockIdx.x; s < count; s += gridDim.x) {
    const long long base = static_cast<long long>(s) * m;
    const T* xs = x + base;
    float pivot = load1(xs);
    if constexpr (kFold)
      pivot = to_dtype<T>(pivot + load1(cb + (s % groups) * cg));
    float sum = 0.0f, sq = 0.0f;
#pragma unroll 4
    for (int i = threadIdx.x; i < steps; i += kThreads) {
      float v[E];
      load<T, E>(xs + i * E, v);
      if constexpr (kFold)
        fold<T>(v, load1(cb + (s % groups) * cg + i / per_channel));
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
      const int c = c0 + i / per_channel;
      const Affine f = affine(gamma, beta, c, st.mean, st.rstd);
      float v[E];
      load<T, E>(xs + i * E, v);
      if constexpr (kFold) fold<T>(v, load1(cb + c));
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = relu(pre_relu(v[e], f));
      store<T, E>(ys + i * E, v);
    }
  }
}

// Sums a channel of two or three values, added a component at a time.
__device__ __forceinline__ void add_to(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}

__device__ __forceinline__ void add_to(float3& a, float3 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
}

__device__ __forceinline__ float2 shfl_xor(float2 v, int o) {
  return make_float2(__shfl_xor_sync(kpcommon::kFull, v.x, o),
                     __shfl_xor_sync(kpcommon::kFull, v.y, o));
}

__device__ __forceinline__ float3 shfl_xor(float3 v, int o) {
  return make_float3(__shfl_xor_sync(kpcommon::kFull, v.x, o),
                     __shfl_xor_sync(kpcommon::kFull, v.y, o),
                     __shfl_xor_sync(kpcommon::kFull, v.z, o));
}

// Backward on a persistent grid. part: (N * C) float2 of (sum dz * xhat,
// sum dz), the (n, c) partials of dL/dgamma and dL/dbeta. kFold: cb is
// given, and pcb: (N * C) floats of sum dL/dx, those of dL/dcb, as pass 2
// forms each value (a dz - (xhat kb + ka)): a sum(dz) - (kb sum(xhat) + ka
// hw), sum(xhat) from pass 1. Dynamic shared memory: cg * parts float2,
// then with the fold cg * parts floats.
template <typename T, int E, bool kFold>
__global__ void __launch_bounds__(kThreads)
gn_relu_bwd(const T* __restrict__ dy, const T* __restrict__ x,
            const float* __restrict__ mean_in,
            const float* __restrict__ rstd_in,
            const float* __restrict__ gamma, const float* __restrict__ beta,
            const T* __restrict__ cb, T* __restrict__ dx,
            float2* __restrict__ part, float* __restrict__ pcb, int count,
            int groups, int cg, int hw, int parts) {
  extern __shared__ float2 items[];
  float* items_cb = reinterpret_cast<float*>(items + cg * parts);
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
    // pass 1: a warp an item (a channel's part): sums of dz and dz * xhat,
    // and with the fold of xhat
    for (int item = warp; item < cg * parts; item += kWarps) {
      const int c = item / parts;
      const int lo = (item - c * parts) * len;
      const int hi = min(lo + len, per_channel);
      const Affine f = affine(gamma, beta, c0 + c, mean, rstd);
      const float bc = kFold ? load1(cb + c0 + c) : 0.0f;
      const T* xc = xs + c * hw;
      const T* gc = gs + c * hw;
      float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll 4
      for (int j = lo + lane; j < hi; j += kWarp) {
        float xv[E], gv[E];
        load<T, E>(xc + j * E, xv);
        load<T, E>(gc + j * E, gv);
        if constexpr (kFold) fold<T>(xv, bc);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dz = passes(pre_relu(xv[e], f)) ? gv[e] : 0.0f;
          const float h = xhat(xv[e], mean, rstd);
          s1 += dz;
          s2 = fmaf(dz, h, s2);
          if constexpr (kFold) s3 += h;
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) items[item] = make_float2(s1, s2);
      if constexpr (kFold) {
        s3 = warp_sum(s3);
        if (lane == 0) items_cb[item] = s3;
      }
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
    if constexpr (kFold) {
      for (int c = threadIdx.x; c < cg; c += kThreads) {
        float s1 = items[c * parts].x, s3 = items_cb[c * parts];
        for (int p = 1; p < parts; ++p) {
          s1 += items[c * parts + p].x;
          s3 += items_cb[c * parts + p];
        }
        const float fa = __fmul_rn(__ldg(gamma + c0 + c), rstd);
        pcb[static_cast<long long>(s) * cg + c] =
            fmaf(fa, s1, -fmaf(s3, kb, ka * static_cast<float>(hw)));
      }
      __syncthreads();  // the next slice's pass 1 writes items
    }
    // pass 2: dx = rstd * (gamma dz - sum(gamma dz) / m - xhat *
    // sum(gamma dz xhat) / m)
    T* ds = dx + base;
#pragma unroll 4
    for (int i = threadIdx.x; i < steps; i += kThreads) {
      const int c = c0 + i / per_channel;
      const Affine f = affine(gamma, beta, c, mean, rstd);
      float xv[E], gv[E];
      load<T, E>(xs + i * E, xv);
      load<T, E>(gs + i * E, gv);
      if constexpr (kFold) fold<T>(xv, load1(cb + c));
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float dz = passes(pre_relu(xv[e], f)) ? gv[e] : 0.0f;
        xv[e] = fmaf(f.a, dz, -fmaf(xhat(xv[e], mean, rstd), kb, ka));
      }
      store<T, E>(ds + i * E, xv);
    }
  }
}

// dL/dgamma and dL/dbeta, and with the fold dL/dcb from pcb: the (n, c)
// partials added over n. A block takes 32 channels; its row r adds n = r,
// r + kParamRows, ... in order, then row 0 adds the rows' sums in order.
template <bool kFold>
__global__ void __launch_bounds__(kWarp * kParamRows)
gn_relu_bwd_params(const float2* __restrict__ part,
                   const float* __restrict__ pcb, float* __restrict__ dgamma,
                   float* __restrict__ dbeta, float* __restrict__ dcb, int n,
                   int c) {
  using Sums = std::conditional_t<kFold, float3, float2>;
  __shared__ Sums rows[kParamRows][kWarp];
  const int ch = blockIdx.x * kWarp + threadIdx.x;
  Sums t{};
  if (ch < c) {
    for (int i = threadIdx.y; i < n; i += kParamRows) {
      const long long at = static_cast<long long>(i) * c + ch;
      const float2 p = __ldg(part + at);
      t.x += p.x;
      t.y += p.y;
      if constexpr (kFold) t.z += __ldg(pcb + at);
    }
  }
  rows[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    for (int r = 1; r < kParamRows; ++r) add_to(t, rows[r][threadIdx.x]);
    dgamma[ch] = t.x;
    dbeta[ch] = t.y;
    if constexpr (kFold) dcb[ch] = t.z;
  }
}

// ---- NHWC ----------------------------------------------------------------

// The cluster's barrier in halves: arrive after the last read of another
// CTA's shared memory, wait before this CTA's is written again or it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes from device memory to shared memory, asynchronously, through L2
// alone; copies_commit() closes a group of them, copies_wait() waits.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (< kChunks) of this thread's committed
// groups are in flight
__device__ __forceinline__ void copies_wait(int pending) {
  static_assert(kChunks == 4, "one wait_group a count");
  switch (pending) {
    case 0:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      break;
    case 1:
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      break;
    case 2:
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      break;
    default:
      asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  }
}

// The block's copies of 16-byte vectors [v0, v1) from src to dst.
__device__ __forceinline__ void stage(void* dst, const void* src,
                                     long long v0, long long v1) {
  for (long long i = v0 + threadIdx.x; i < v1; i += kNhwcThreads)
    copy16(static_cast<uint4*>(dst) + i, static_cast<const uint4*>(src) + i);
}

// E values at p, in shared or device memory (a generic pointer): one
// 16-byte vector or one value.
__device__ __forceinline__ float load_one(const float* p) { return *p; }

__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  const unsigned short bits = *reinterpret_cast<const unsigned short*>(p);
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

template <typename T, int E>
__device__ __forceinline__ void load_any(const T* p, float (&v)[E]) {
  if constexpr (E == 1)
    v[0] = load_one(p);
  else
    unpack(*reinterpret_cast<const uint4*>(p), v);
}

// bf16 sums in bf16 arithmetic, rounded once to nearest even (subnormals
// kept): the bits of aten's f32 sum rounded to bf16, since two bf16 values
// add exactly in f32 unless their exponents differ by 16 or more, and then
// the smaller lies far below half a bf16 spacing of the sum
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned short add_bf16(unsigned short a,
                                                   unsigned short b) {
  unsigned short d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

// A thread's conv biases, E channels as a vector of x holds them: f32
// values, or a bf16 vector's (or one value's) bits.
template <typename T, int E>
struct Bias {
  float v[E];
};
template <>
struct Bias<__nv_bfloat16, 8> {
  uint4 bits;
};
template <>
struct Bias<__nv_bfloat16, 1> {
  unsigned short bits;
};

// The biases of channels c .. c + E - 1 from cbs (shared memory, 16-byte
// aligned, c a multiple of E).
template <typename T, int E>
__device__ __forceinline__ Bias<T, E> bias_at(const T* cbs, int c) {
  Bias<T, E> b;
  if constexpr (std::is_same_v<T, __nv_bfloat16> && E > 1)
    b.bits = *reinterpret_cast<const uint4*>(cbs + c);
  else if constexpr (std::is_same_v<T, __nv_bfloat16>)
    b.bits = *reinterpret_cast<const unsigned short*>(cbs + c);
  else
#pragma unroll
    for (int e = 0; e < E; ++e) b.v[e] = cbs[c + e];
  return b;
}

// E values of x at p with the conv bias added, z = x + b in T's arithmetic
// (aten's add, bit for bit), as f32; z also written to w where w is given
// (over x in a staged run).
template <typename T, int E>
__device__ __forceinline__ void load_folded(const T* p, const Bias<T, E>& b,
                                            T* w, float (&v)[E]) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && E > 1) {
    uint4 r = *reinterpret_cast<const uint4*>(p);
    r = make_uint4(add_bf16x2(r.x, b.bits.x), add_bf16x2(r.y, b.bits.y),
                   add_bf16x2(r.z, b.bits.z), add_bf16x2(r.w, b.bits.w));
    if (w) *reinterpret_cast<uint4*>(w) = r;
    unpack(r, v);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const unsigned short h =
        add_bf16(*reinterpret_cast<const unsigned short*>(p), b.bits);
    if (w) *reinterpret_cast<unsigned short*>(w) = h;
    v[0] = __uint_as_float(static_cast<unsigned>(h) << 16);
  } else {
    load_any<T, E>(p, v);
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] += b.v[e];
    if (w) store<T, E>(w, v);
  }
}

// Stage the conv bias (C values) into cbs, for bias_at after the block's
// next barrier.
template <typename T>
__device__ __forceinline__ void stage_bias(T* cbs, const T* cb, int c) {
  for (int i = threadIdx.x; i < c; i += kNhwcThreads) cbs[i] = cb[i];
}

// Bytes rounded up to a 16-byte boundary.
__host__ __device__ __forceinline__ long long align16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// An NHWC launch's shape: n samples of p pixels of c channels in groups of
// cg; 2^lg columns a sweep (rounded up); a CTA's run is `sweeps` sweeps;
// the first `staged` of the tensors a pass reads (x, then dL/dy) are
// copied to shared memory first, the others read twice from device
// memory.
struct Nhwc {
  long long n;
  int p, c, groups, cg, lg, sweeps, staged;
};

// The float2 pairs channel_sums stages a block: a warp's first 2^lg lanes
// where 2^lg <= 32, else every thread, E pairs each.
__host__ __device__ __forceinline__ int red_pairs(int lg, int e) {
  return ((1 << lg) <= kWarp ? kNhwcWarps << lg : kNhwcThreads) * e;
}

// The backward's channel sums (pairs, or triples with the fold): red_pairs,
// then C rounded up to even, so the float2 that follow a float3 stay
// aligned.
__host__ __device__ __forceinline__ int sums_values(int lg, int e, int c) {
  return red_pairs(lg, e) + ((c + 1) & ~1);
}

// Where a thread reads: its column (E channels from c0), its first pixel
// in its CTA's run (row) and the run's pixels [lo, hi) in the sample;
// `active` where the column exists.
struct Lane {
  int c0, row, rows, lo, hi;
  bool active;
};

__device__ __forceinline__ Lane lane_of(const Nhwc& sh, int e, int rank) {
  const int rows = kNhwcThreads >> sh.lg;
  const int col = threadIdx.x & ((1 << sh.lg) - 1);
  const int lo = min(rank * rows * sh.sweeps, sh.p);
  return {col * e, static_cast<int>(threadIdx.x >> sh.lg), rows, lo,
          min(lo + rows * sh.sweeps, sh.p), col * e < sh.c};
}

// The sum of N pairs (or triples) as a tree: (0 + N/2), ..., then halves
// again.
template <typename V, int N>
__device__ __forceinline__ V tree_sum(V (&v)[N]) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) add_to(v[i], v[i + w]);
  }
  return v[0];
}

// The CTA's sums of each channel's pair (or triple): v[e] holds this
// thread's for channel c0 + e (zeros where it holds none) -> chan[c], c <
// C. Lanes of a column meet by shuffles; then, where 2^lg <= 32, a warp's
// first 2^lg lanes, else every thread, put theirs in red (red_pairs), one
// slot a warp or a row, and the slots (at most kNhwcWarps) meet as a tree.
// Ends with the block synchronised.
template <int E, typename V>
__device__ void channel_sums(V (&v)[E], const Nhwc& sh, V* red, V* chan) {
  const int cols_p = 1 << sh.lg;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int o = kWarp / 2; o >= cols_p; o >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) add_to(v[e], shfl_xor(v[e], o));
  }
  const bool by_warp = cols_p <= kWarp;
  const int slot = by_warp ? warp : threadIdx.x >> sh.lg;
  const int col = threadIdx.x & (cols_p - 1);
  const int slots = by_warp ? kNhwcWarps : kNhwcThreads >> sh.lg;
  if ((!by_warp || lane < cols_p) && col * E < sh.c) {
#pragma unroll
    for (int e = 0; e < E; ++e) red[(slot * cols_p + col) * E + e] = v[e];
  }
  __syncthreads();
  // slot s's pair of channel ch, column ch / E, is red[s * cols_p * E + ch]
  for (int ch = threadIdx.x; ch < sh.c; ch += kNhwcThreads) {
    V t[kNhwcWarps];
#pragma unroll
    for (int i = 0; i < kNhwcWarps; ++i)
      t[i] = i < slots ? red[i * cols_p * E + ch] : V{};
    chan[ch] = tree_sum(t);
  }
  __syncthreads();
}

// Chunk q of a run of `sweeps` sweeps: sweeps [first, last).
struct Chunk {
  int first, last;
};

__device__ __forceinline__ Chunk chunk_of(int q, int sweeps) {
  const int per = (sweeps + kChunks - 1) / kChunks;
  return {min(q * per, sweeps), min((q + 1) * per, sweeps)};
}

// Copy the CTA's run of x (and of dL/dy where g_dst) into shared memory,
// one commit group a chunk.
template <typename T>
__device__ void stage_run(T* x_dst, const T* x_src, T* g_dst,
                          const T* g_src, const Nhwc& sh, const Lane& ln) {
  const long long px = ln.hi - ln.lo, vectors_px = sh.c / Elems<T>::kVec;
  for (int q = 0; q < kChunks; ++q) {
    const Chunk ch = chunk_of(q, sh.sweeps);
    const long long v0 = min(static_cast<long long>(ch.first) * ln.rows, px);
    const long long v1 = min(static_cast<long long>(ch.last) * ln.rows, px);
    stage(x_dst, x_src, v0 * vectors_px, v1 * vectors_px);
    if (g_dst) stage(g_dst, g_src, v0 * vectors_px, v1 * vectors_px);
    copies_commit();
  }
}

// Before pass 1 reads chunk q of a staged run: this thread's copies of it
// done, then everyone's.
__device__ __forceinline__ void chunk_landed(int q, bool staged) {
  if (staged) {
    copies_wait(kChunks - 1 - q);
    __syncthreads();
  }
}

// The cluster's sum of src[i] (shared memory of each CTA), ranks as a tree.
__device__ __forceinline__ float2 cluster_sum(cg::cluster_group& cluster,
                                              int ranks, float2* src,
                                              int i) {
  float2 v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = r < ranks ? cluster.map_shared_rank(src, r)[i]
                     : make_float2(0.0f, 0.0f);
  return tree_sum(v);
}

// Push this CTA's n pairs `mine` to slot `rank` of every CTA's `recv`
// (ranks slots of n pairs), so that after the cluster's barrier each CTA
// adds the ranks' pairs from its own shared memory.
__device__ __forceinline__ void push(cg::cluster_group& cluster, int ranks,
                                     int rank, const float2* mine,
                                     float2* recv, int n) {
  for (int i = threadIdx.x; i < ranks * n; i += kNhwcThreads)
    cluster.map_shared_rank(recv, i / n)[rank * n + i % n] = mine[i % n];
}

// The sum over the ranks' slots of pair i in recv (n pairs a slot), as a
// tree.
__device__ __forceinline__ float2 ranks_sum(const float2* recv, int ranks,
                                            int n, int i) {
  float2 v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = r < ranks ? recv[r * n + i] : make_float2(0.0f, 0.0f);
  return tree_sum(v);
}

// Forward over NHWC, a cluster a sample (the clusters loop over the
// samples where x is read twice). kFold: cb is given, and both passes fold
// it (in registers: writing z over the staged run measured slower).
// Dynamic shared memory: the staged run (sh.staged * sweeps * rows * C
// values), then red_pairs + C + 2 * groups float2, then groups floats,
// then with the fold the bias (C values, 16-byte aligned).
template <typename T, int E, bool kFold>
__global__ void __launch_bounds__(kNhwcThreads)
gn_relu_fwd_nhwc(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ cb,
                 T* __restrict__ y, float* __restrict__ mean_out,
                 float* __restrict__ rstd_out, Nhwc sh, float eps) {
  extern __shared__ float4 nhwc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const Lane ln = lane_of(sh, E, rank);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int groups = sh.groups;
  T* run = reinterpret_cast<T*>(nhwc_smem);
  float2* red = reinterpret_cast<float2*>(
      run + static_cast<long long>(sh.staged) * sh.sweeps * ln.rows * sh.c);
  float2* chan = red + red_pairs(sh.lg, E);
  float2* grp = chan + sh.c;  // the CTA's group sums, read by the cluster
  float2* stat = grp + groups;
  float* piv = reinterpret_cast<float*>(stat + groups);
  T* cbs = reinterpret_cast<T*>(
      reinterpret_cast<char*>(nhwc_smem) +
      align16(reinterpret_cast<char*>(piv + groups) -
              reinterpret_cast<char*>(nhwc_smem)));
  if constexpr (kFold) stage_bias(cbs, cb, sh.c);
  const int m = sh.p * sh.cg;
  const long long first = static_cast<long long>(ln.lo) * sh.c;
  const long long sample = static_cast<long long>(sh.p) * sh.c;
  const long long step = gridDim.x / ranks;
  // a channel's gamma and beta, the same for every sample
  float gm[E], bt[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = ln.active ? ln.c0 + e : 0;
    gm[e] = __ldg(gamma + c);
    bt[e] = __ldg(beta + c);
  }
  for (long long n = blockIdx.x / ranks; n < sh.n; n += step) {
    const T* xs = x + n * sample;
    if (sh.staged) {
      stage(run, xs + first, 0,
            (ln.hi - ln.lo) * static_cast<long long>(sh.c) / Elems<T>::kVec);
      copies_commit();
    }
    if (threadIdx.x < groups) {
      const int c = threadIdx.x * sh.cg;
      float v[1] = {load1(xs + c)};
      if constexpr (kFold) fold<T>(v, load1(cb + c));
      piv[threadIdx.x] = v[0];
    }
    copies_wait(0);
    __syncthreads();
    const T* src = sh.staged ? run : xs + first;
    Bias<T, E> bc;
    if constexpr (kFold) bc = bias_at<T, E>(cbs, ln.active ? ln.c0 : 0);
    float pv[E];
    float2 acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      pv[e] = ln.active ? piv[(ln.c0 + e) / sh.cg] : 0.0f;
      acc[e] = make_float2(0.0f, 0.0f);
    }
    if (ln.active) {
#pragma unroll 4
      for (int px = ln.row; px < ln.hi - ln.lo; px += ln.rows) {
        const long long at = static_cast<long long>(px) * sh.c + ln.c0;
        float v[E];
        if constexpr (kFold)
          load_folded<T, E>(src + at, bc, nullptr, v);
        else
          load_any<T, E>(src + at, v);
#pragma unroll
        for (int e = 0; e < E; ++e)
          accumulate(v[e], pv[e], &acc[e].x, &acc[e].y);
      }
    }
    channel_sums<E>(acc, sh, red, chan);
    // a group's channels: a warp a group, its lanes over the channels
    for (int g = warp; g < groups; g += kNhwcWarps) {
      float2 t = make_float2(0.0f, 0.0f);
      for (int j = lane; j < sh.cg; j += kWarp) {
        t.x += chan[g * sh.cg + j].x;
        t.y += chan[g * sh.cg + j].y;
      }
      t.x = warp_sum(t.x);
      t.y = warp_sum(t.y);
      if (lane == 0) grp[g] = t;
    }
    cluster.sync();
    for (int g = threadIdx.x; g < groups; g += kNhwcThreads) {
      const Stats st =
          slice_stats(cluster_sum(cluster, ranks, grp, g), piv[g], m, eps);
      stat[g] = make_float2(st.mean, st.rstd);
      if (rank == 0) {
        mean_out[n * groups + g] = st.mean;
        rstd_out[n * groups + g] = st.rstd;
      }
    }
    cluster_arrive();  // done with the other CTAs' shared memory
    __syncthreads();
    Affine f[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float2 s = stat[(ln.active ? ln.c0 + e : 0) / sh.cg];
      f[e] = affine_of(gm[e], bt[e], s.x, s.y);
    }
    T* ys = y + n * sample + first;
    if (ln.active) {
#pragma unroll 4
      for (int px = ln.row; px < ln.hi - ln.lo; px += ln.rows) {
        const long long at = static_cast<long long>(px) * sh.c + ln.c0;
        float v[E];
        if constexpr (kFold)
          load_folded<T, E>(src + at, bc, nullptr, v);
        else
          load_any<T, E>(src + at, v);
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = relu(pre_relu(v[e], f[e]));
        store<T, E>(ys + at, v);
      }
    }
    cluster_wait();  // nobody reads this CTA's grp any more
    __syncthreads();  // the run is off every pass: the next copy may go
  }
}

// Backward over NHWC, a cluster a sample (the clusters loop over the
// samples where a tensor is read twice). part: (N * ranks * C) float2 of
// (sum dz * xhat, sum dz) over each CTA's run, row n * ranks + rank; the
// groups' gamma-weighted sums are pushed as in the forward. kFold: cb is
// given; pass 1 folds it and, where x is staged, writes z over x there, so
// pass 2 reads z and holds no bias (x read twice from device memory is
// folded twice); pass 1 also sums z - mean a channel, so that the run's
// sum of dL/dx a channel, a sum(dz) - (kb sum(z - mean) + ka px), goes to
// pcb's rows (as part's) with pass 2 left as it is. Dynamic shared memory:
// the staged runs (x, then dL/dy), then sums_values pairs (triples with the
// fold), then groups + 2 * ranks * groups + 2 * groups float2, then with
// the fold the bias (C values, 16-byte aligned).
template <typename T, int E, bool kFold>
__global__ void __launch_bounds__(kNhwcThreads, kNhwcBlocks)
gn_relu_bwd_nhwc(const T* __restrict__ dy, const T* __restrict__ x,
                 const float* __restrict__ mean_in,
                 const float* __restrict__ rstd_in,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ cb,
                 T* __restrict__ dx, float2* __restrict__ part,
                 float* __restrict__ pcb, Nhwc sh) {
  extern __shared__ float4 nhwc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();  // this CTA has started: others may push into it
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const Lane ln = lane_of(sh, E, rank);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int groups = sh.groups;
  const long long run_values =
      static_cast<long long>(sh.sweeps) * ln.rows * sh.c;
  using Sums = std::conditional_t<kFold, float3, float2>;
  T* run_x = reinterpret_cast<T*>(nhwc_smem);
  T* run_g = run_x + run_values;
  Sums* red = reinterpret_cast<Sums*>(run_x + sh.staged * run_values);
  Sums* chan = red + red_pairs(sh.lg, E);
  float2* gw = reinterpret_cast<float2*>(red + sums_values(sh.lg, E, sh.c));
  float2* recv = gw + groups;  // two slots of ranks * groups pairs
  float2* stat = recv + 2 * ranks * groups;
  float2* terms = stat + groups;
  T* cbs = reinterpret_cast<T*>(
      reinterpret_cast<char*>(nhwc_smem) +
      align16(reinterpret_cast<char*>(terms + groups) -
              reinterpret_cast<char*>(nhwc_smem)));
  if constexpr (kFold) stage_bias(cbs, cb, sh.c);
  const float inv_m = 1.0f / static_cast<float>(sh.p * sh.cg);
  const long long first = static_cast<long long>(ln.lo) * sh.c;
  const long long sample = static_cast<long long>(sh.p) * sh.c;
  const long long step = gridDim.x / ranks;
  int slot = 0;
  for (long long n = blockIdx.x / ranks; n < sh.n; n += step, slot ^= 1) {
    const long long base = n * sample;
    if (sh.staged)
      stage_run<T>(run_x, x + base + first, sh.staged > 1 ? run_g : nullptr,
                   dy + base + first, sh, ln);
    for (int g = threadIdx.x; g < groups; g += kNhwcThreads)
      stat[g] = make_float2(mean_in[n * groups + g], rstd_in[n * groups + g]);
    __syncthreads();
    const T* xs = sh.staged > 0 ? run_x : x + base + first;
    const T* gs = sh.staged > 1 ? run_g : dy + base + first;
    // a thread's channels: the affine, the mean (rstd is a group's, put
    // in at the sums)
    float mean[E];
    Affine f[E];
    Sums acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = ln.active ? ln.c0 + e : 0;
      const float2 s = stat[c / sh.cg];
      mean[e] = s.x;
      f[e] = affine(gamma, beta, c, s.x, s.y);
      acc[e] = Sums{};
    }
    // pass 1, chunk by chunk as the copies land: this thread's channels'
    // sums of dz and dz * (z - mean), and with the fold of z - mean
    {
      Bias<T, E> bc;
      if constexpr (kFold) bc = bias_at<T, E>(cbs, ln.active ? ln.c0 : 0);
      T* z_out = sh.staged ? run_x : nullptr;  // z over x, for pass 2
      for (int q = 0; q < kChunks; ++q) {
        chunk_landed(q, sh.staged);
        const Chunk ch = chunk_of(q, sh.sweeps);
        if (!ln.active) continue;
        // with the fold, one pixel at a time: two would spill
#pragma unroll(kFold ? 1 : 2)
        for (int i = ch.first; i < ch.last; ++i) {
          const int px = ln.row + i * ln.rows;
          if (px >= ln.hi - ln.lo) break;
          const long long at = static_cast<long long>(px) * sh.c + ln.c0;
          float xv[E], gv[E];
          if constexpr (kFold)
            load_folded<T, E>(xs + at, bc, z_out ? z_out + at : nullptr, xv);
          else
            load_any<T, E>(xs + at, xv);
          load_any<T, E>(gs + at, gv);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float dz = passes(pre_relu(xv[e], f[e])) ? gv[e] : 0.0f;
            const float d = xv[e] - mean[e];
            acc[e].x += dz;
            acc[e].y = fmaf(dz, d, acc[e].y);
            if constexpr (kFold) acc[e].z += d;
          }
        }
      }
    }
    channel_sums<E>(acc, sh, red, chan);
    // this run's (n, c) sums of dz * xhat and dz, for the parameters
    float2* row = part + (n * ranks + rank) * sh.c;
    for (int c = threadIdx.x; c < sh.c; c += kNhwcThreads)
      row[c] = make_float2(chan[c].y * stat[c / sh.cg].y, chan[c].x);
    // a group's gamma-weighted sums: a warp a group, its lanes over the
    // channels
    for (int g = warp; g < groups; g += kNhwcWarps) {
      float a = 0.0f, b = 0.0f;
      for (int j = lane; j < sh.cg; j += kWarp) {
        const int c = g * sh.cg + j;
        const float w = __ldg(gamma + c);
        a = fmaf(w, chan[c].x, a);
        b = fmaf(w, chan[c].y, b);
      }
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) gw[g] = make_float2(a, b);
    }
    __syncthreads();
    if (n == blockIdx.x / ranks) cluster_wait();  // every CTA has started
    float2* in = recv + slot * ranks * groups;
    push(cluster, ranks, rank, gw, in, groups);
    cluster.sync();
    // dx's group terms: rstd * sum(gamma dz) / m, and rstd *
    // sum(gamma dz xhat) / m times rstd, for z - mean in place of xhat
    for (int g = threadIdx.x; g < groups; g += kNhwcThreads) {
      const float2 t = ranks_sum(in, ranks, groups, g);
      const float r = stat[g].y;
      terms[g] = make_float2(r * (t.x * inv_m), r * (r * (r * (t.y * inv_m))));
    }
    __syncthreads();
    if constexpr (kFold) {
      // this run's (n, c) sums of dL/dx, of pass 2's a dz - ((z - mean) kb
      // + ka) a value
      float* row_cb = pcb + (n * ranks + rank) * sh.c;
      const float cnt = static_cast<float>(ln.hi - ln.lo);
      for (int c = threadIdx.x; c < sh.c; c += kNhwcThreads) {
        const float2 st = stat[c / sh.cg], k = terms[c / sh.cg];
        const float a = __fmul_rn(__ldg(gamma + c), st.y);
        row_cb[c] = fmaf(a, chan[c].x, -fmaf(chan[c].z, k.y, k.x * cnt));
      }
    }
    float ka[E], kb[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float2 k = terms[(ln.active ? ln.c0 + e : 0) / sh.cg];
      ka[e] = k.x;
      kb[e] = k.y;
    }
    // pass 2: dx = rstd * (gamma dz - sum(gamma dz) / m - xhat *
    // sum(gamma dz xhat) / m); z refolded where x is not staged
    T* ds = dx + base + first;
    const auto pass2 = [&](auto refold) {
      Bias<T, E> bc;
      if constexpr (decltype(refold)::value)
        bc = bias_at<T, E>(cbs, ln.active ? ln.c0 : 0);
#pragma unroll 2
      for (int px = ln.row; px < ln.hi - ln.lo; px += ln.rows) {
        const long long at = static_cast<long long>(px) * sh.c + ln.c0;
        float xv[E], gv[E];
        if constexpr (decltype(refold)::value)
          load_folded<T, E>(xs + at, bc, nullptr, xv);
        else
          load_any<T, E>(xs + at, xv);
        load_any<T, E>(gs + at, gv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float dz = passes(pre_relu(xv[e], f[e])) ? gv[e] : 0.0f;
          xv[e] = fmaf(f[e].a, dz, -fmaf(xv[e] - mean[e], kb[e], ka[e]));
        }
        store<T, E>(ds + at, xv);
      }
    };
    if (ln.active) {
      if (kFold && !sh.staged)
        pass2(std::true_type{});
      else
        pass2(std::false_type{});
    }
    __syncthreads();  // the runs are off every pass: the next copy may go
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

template <typename T, int R, bool kFold>
void launch_held(long long count, const void* x, const void* gamma,
                 const void* beta, const void* cb, void* y, void* mean,
                 void* rstd, int groups, int cg, int hw, float eps,
                 cudaStream_t s) {
  gn_relu_fwd_held<T, R, kFold>
      <<<static_cast<unsigned>(count), kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), static_cast<const T*>(cb),
          static_cast<T*>(y), static_cast<float*>(mean),
          static_cast<float*>(rstd), groups, cg, hw, eps);
}

template <typename T, bool kFold>
void launch_fwd(bool vec, int sms, long long count, const void* x,
                const void* gamma, const void* beta, const void* cb, void* y,
                void* mean, void* rstd, int groups, int cg, int hw, float eps,
                cudaStream_t s) {
  constexpr int E = Elems<T>::kVec;
  const long long m = static_cast<long long>(cg) * hw;
  if (vec) {
    const long long per_thread = (m / E + kThreads - 1) / kThreads;
    if (per_thread <= 1)
      return launch_held<T, 1, kFold>(count, x, gamma, beta, cb, y, mean,
                                      rstd, groups, cg, hw, eps, s);
    if (per_thread <= 2)
      return launch_held<T, 2, kFold>(count, x, gamma, beta, cb, y, mean,
                                      rstd, groups, cg, hw, eps, s);
    if (per_thread <= 4)
      return launch_held<T, 4, kFold>(count, x, gamma, beta, cb, y, mean,
                                      rstd, groups, cg, hw, eps, s);
    if (per_thread <= 8)
      return launch_held<T, 8, kFold>(count, x, gamma, beta, cb, y, mean,
                                      rstd, groups, cg, hw, eps, s);
    if (per_thread <= kMaxHeld)
      return launch_held<T, kMaxHeld, kFold>(count, x, gamma, beta, cb, y,
                                             mean, rstd, groups, cg, hw, eps,
                                             s);
  }
  const unsigned blocks =
      persistent_blocks(count, sms, m * static_cast<long long>(sizeof(T)));
  const auto* xi = static_cast<const T*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  const auto* cbi = static_cast<const T*>(cb);
  auto* yo = static_cast<T*>(y);
  auto* mo = static_cast<float*>(mean);
  auto* ro = static_cast<float*>(rstd);
  const int cnt = static_cast<int>(count);
  if (vec)
    gn_relu_fwd<T, E, kFold><<<blocks, kThreads, 0, s>>>(
        xi, g, b, cbi, yo, mo, ro, cnt, groups, cg, hw, eps);
  else
    gn_relu_fwd<T, 1, kFold><<<blocks, kThreads, 0, s>>>(
        xi, g, b, cbi, yo, mo, ro, cnt, groups, cg, hw, eps);
}

template <typename T, bool kFold>
cudaError_t launch_bwd(bool vec, int sms, long long count, const void* dy,
                       const void* x, const void* mean, const void* rstd,
                       const void* gamma, const void* beta, const void* cb,
                       void* dx, void* part, void* pcb, int groups, int cg,
                       int hw, cudaStream_t s) {
  const int parts = cg < kWarps ? kWarps / cg : 1;
  const size_t smem =
      (kFold ? sizeof(float2) + sizeof(float) : sizeof(float2)) *
      static_cast<size_t>(cg) * parts;
  const unsigned blocks = persistent_blocks(
      count, sms, 2 * static_cast<long long>(cg) * hw *
                      static_cast<long long>(sizeof(T)));
  const auto kernel = vec ? gn_relu_bwd<T, Elems<T>::kVec, kFold>
                          : gn_relu_bwd<T, 1, kFold>;
  // the default 48 KB holds the static scratch and, without the fold, any
  // group's items; with it, a group of over 4,084 channels asks for more
  constexpr size_t kStatic = sizeof(float2) * (kWarps + 1);
  if (smem + kStatic > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const T*>(cb), static_cast<T*>(dx),
      static_cast<float2*>(part), static_cast<float*>(pcb),
      static_cast<int>(count), groups, cg, hw, parts);
  return cudaSuccess;
}

// gn_relu_bwd_params over `rows` rows of part (and pcb with the fold).
void launch_params(bool fold, const void* part, const void* pcb,
                   void* dgamma, void* dbeta, void* dcb, int rows, int c,
                   cudaStream_t s) {
  const dim3 grid((c + kWarp - 1) / kWarp), block(kWarp, kParamRows);
  (fold ? gn_relu_bwd_params<true> : gn_relu_bwd_params<false>)
      <<<grid, block, 0, s>>>(
          static_cast<const float2*>(part), static_cast<const float*>(pcb),
          static_cast<float*>(dgamma), static_cast<float*>(dbeta),
          static_cast<float*>(dcb), rows, c);
}

// An NHWC launch: the shape, the cluster (CTAs a sample), the blocks and
// the dynamic shared memory.
struct NhwcPlan {
  Nhwc sh;
  int cluster;
  unsigned blocks;
  size_t smem;
};

// tensors: those a pass reads (1 forward: x; 2 backward: x, dL/dy); e:
// values a column; vec: 16-byte vectors. The cluster is the fewest CTAs
// (a power of two up to kMaxCluster) whose runs of every tensor fit
// kStageBytes, and as many tensors as fit are staged (vectors only). Where
// x is read twice, the clusters loop over the samples, as many as keep
// kReuseBytes in flight but at least one CTA an SM; where x is staged and
// dL/dy is not, what the card holds at once keeps dL/dy's runs in L2.
NhwcPlan plan_nhwc(long long n, int c, int groups, int hw, int e,
                   int tensors, int elem, bool vec, int sms, bool fold) {
  int lg = 0;
  while ((1 << lg) < c / e) ++lg;
  const int rows = kNhwcThreads >> lg;
  const int sweeps = (hw + rows - 1) / rows;
  const long long sweep_bytes = static_cast<long long>(rows) * c * elem;
  int cluster = 1;
  while (cluster < kMaxCluster &&
         (sweeps + cluster - 1) / cluster * sweep_bytes * tensors >
             kStageBytes)
    cluster *= 2;
  const int per = (sweeps + cluster - 1) / cluster;
  int staged = 0;
  while (vec && staged < tensors &&
         (staged + 1) * per * sweep_bytes <= kStageBytes)
    ++staged;
  long long clusters = n;
  if (staged == 0) {
    clusters = kReuseBytes /
               ((tensors - staged) * static_cast<long long>(hw) * c * elem);
    const long long least = (sms + cluster - 1) / cluster;
    if (clusters < least) clusters = least;
    if (clusters > n) clusters = n;
  }
  // the forward's pairs (red, chan, grp, stat) and pivots; the
  // backward's sums (red, chan: triples with the fold) and pairs (gw, two
  // slots of pushes, stat, terms)
  const size_t sums =
      tensors == 1 ? sizeof(float2) * (red_pairs(lg, e) + c)
                   : (fold ? sizeof(float3) : sizeof(float2)) *
                         sums_values(lg, e, c);
  const long long pairs =
      tensors == 1 ? 2 * groups
                   : (3 + 2 * static_cast<long long>(cluster)) * groups;
  const long long before_bias =
      staged * per * sweep_bytes + sums + sizeof(float2) * pairs +
      (tensors == 1 ? sizeof(float) * groups : 0);
  const size_t smem = fold ? align16(before_bias) + align16(c * elem)
                           : before_bias;
  return {{n, hw, c, groups, c / groups, lg, per, staged}, cluster,
          static_cast<unsigned>(clusters * cluster), smem};
}

// Launch `kernel` over plan's blocks in clusters of plan.cluster CTAs,
// opting in to its shared memory and to a cluster above the portable 8.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), const NhwcPlan& plan,
                           cudaStream_t s, Args&&... args) {
  if (plan.smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem));
    if (e != cudaSuccess) return e;
  }
  if (plan.cluster > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(plan.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.blocks);
  cfg.blockDim = dim3(kNhwcThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

template <typename T, int E>
cudaError_t launch_fwd_nhwc(int sms, long long n, int c, int groups, int hw,
                            float eps, const void* x, const void* gamma,
                            const void* beta, const void* cb, void* y,
                            void* mean, void* rstd, cudaStream_t s) {
  const NhwcPlan p = plan_nhwc(n, c, groups, hw, E, 1, sizeof(T), E > 1,
                               sms, cb != nullptr);
  return launch_cluster(cb ? gn_relu_fwd_nhwc<T, E, true>
                           : gn_relu_fwd_nhwc<T, E, false>,
                        p, s, static_cast<const T*>(x),
                        static_cast<const float*>(gamma),
                        static_cast<const float*>(beta),
                        static_cast<const T*>(cb), static_cast<T*>(y),
                        static_cast<float*>(mean), static_cast<float*>(rstd),
                        p.sh, eps);
}

// *cluster: the CTAs a sample, so part's (and pcb's) rows, N * *cluster.
template <typename T, int E>
cudaError_t launch_bwd_nhwc(int sms, long long n, int c, int groups, int hw,
                            const void* dy, const void* x, const void* mean,
                            const void* rstd, const void* gamma,
                            const void* beta, const void* cb, void* dx,
                            void* part, void* pcb, cudaStream_t s,
                            int* cluster) {
  const NhwcPlan p = plan_nhwc(n, c, groups, hw, E, 2, sizeof(T), E > 1,
                               sms, cb != nullptr);
  *cluster = p.cluster;
  return launch_cluster(
      cb ? gn_relu_bwd_nhwc<T, E, true> : gn_relu_bwd_nhwc<T, E, false>, p,
      s, static_cast<const T*>(dy),
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(cb),
      static_cast<T*>(dx), static_cast<float2*>(part),
      static_cast<float*>(pcb), p.sh);
}

// The NHWC shapes: C up to a column a thread, vectors only where C holds
// whole ones, a sample under 2**31 values.
bool valid_nhwc(int dtype, int vec, int sms, long long n, int c, int groups,
                int hw) {
  if (!valid(dtype, sms, n, c, groups, hw) || c > kNhwcThreads ||
      static_cast<long long>(hw) * c >= (1LL << 31))
    return false;
  return !vec || c % (dtype == 0 ? Elems<float>::kVec
                                 : Elems<__nv_bfloat16>::kVec) == 0;
}

// dL/dcb's partials: with a conv bias, the floats after part's `rows` rows
// of C float2; none without.
void* cb_partials(const void* cb, void* part, long long rows, int c) {
  return cb ? static_cast<float*>(part) + 2 * rows * c : nullptr;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, dL/dy, dL/dx and cb alike; gamma,
// beta, mu, rstd and the parameter gradients are float32). cb: the conv's
// bias (C), or null for none. vec: 1 takes 16-byte vector loads and
// stores, which needs every x, y, dL/dy, dL/dx pointer 16-byte aligned and
// H * W a multiple of 16 / sizeof(dtype); 0 takes scalar ones (cb is read
// a value at a time, at any alignment). sms: the device's streaming
// multiprocessors. Launch on `stream`, return cudaGetLastError(); no sync,
// no allocation.
extern "C" int kp_gn_relu_fwd(int dtype, int vec, int sms, long long n,
                              int c, int groups, int hw, float eps,
                              const void* x, const void* gamma,
                              const void* beta, const void* cb, void* y,
                              void* mean, void* rstd, void* stream) {
  if (!valid(dtype, sms, n, c, groups, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long count = n * groups;
  if (count == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int cg = c / groups;
  using bf16 = __nv_bfloat16;
  const bool fold = cb != nullptr;
  (dtype == 0 ? (fold ? launch_fwd<float, true> : launch_fwd<float, false>)
              : (fold ? launch_fwd<bf16, true> : launch_fwd<bf16, false>))(
      vec != 0, sms, count, x, gamma, beta, cb, y, mean, rstd, groups, cg, hw,
      eps, s);
  return static_cast<int>(cudaGetLastError());
}

// part: scratch of N * C * 2 floats, 3 with cb, written before it is read;
// dcb: dL/dcb (C) float32, null without cb.
extern "C" int kp_gn_relu_bwd(int dtype, int vec, int sms, long long n,
                              int c, int groups, int hw, const void* dy,
                              const void* x, const void* mean,
                              const void* rstd, const void* gamma,
                              const void* beta, const void* cb, void* dx,
                              void* part, void* dgamma, void* dbeta,
                              void* dcb, void* stream) {
  if (!valid(dtype, sms, n, c, groups, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long count = n * groups;
  const int cg = c / groups;
  using bf16 = __nv_bfloat16;
  const bool fold = cb != nullptr;
  void* pcb = cb_partials(cb, part, n, c);
  if (count > 0) {
    const cudaError_t err =
        (dtype == 0
             ? (fold ? launch_bwd<float, true> : launch_bwd<float, false>)
             : (fold ? launch_bwd<bf16, true> : launch_bwd<bf16, false>))(
            vec != 0, sms, count, dy, x, mean, rstd, gamma, beta, cb, dx,
            part, pcb, groups, cg, hw, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
  }
  launch_params(fold, part, pcb, dgamma, dbeta, dcb, static_cast<int>(n), c,
                s);
  return static_cast<int>(cudaGetLastError());
}

// The NHWC pair: x, y, dL/dy, dL/dx (N, H, W, C) in memory (channels_last
// (N, C, H, W)); the rest, the arguments and the vector rule as above, save
// that vec needs C (not H * W) a multiple of 16 / sizeof(dtype), and that
// the backward's part holds N * 16 * C * 2 floats, 3 with cb (a row a CTA
// of a sample's cluster). C at most 256.
extern "C" int kp_gn_relu_fwd_nhwc(int dtype, int vec, int sms, long long n,
                                   int c, int groups, int hw, float eps,
                                   const void* x, const void* gamma,
                                   const void* beta, const void* cb, void* y,
                                   void* mean, void* rstd, void* stream) {
  if (!valid_nhwc(dtype, vec, sms, n, c, groups, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const cudaError_t err =
      dtype == 0 ? (vec ? launch_fwd_nhwc<float, 4>
                        : launch_fwd_nhwc<float, 1>)(
                       sms, n, c, groups, hw, eps, x, gamma, beta, cb, y,
                       mean, rstd, s)
                 : (vec ? launch_fwd_nhwc<bf16, 8>
                        : launch_fwd_nhwc<bf16, 1>)(
                       sms, n, c, groups, hw, eps, x, gamma, beta, cb, y,
                       mean, rstd, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int kp_gn_relu_bwd_nhwc(int dtype, int vec, int sms, long long n,
                                   int c, int groups, int hw, const void* dy,
                                   const void* x, const void* mean,
                                   const void* rstd, const void* gamma,
                                   const void* beta, const void* cb,
                                   void* dx, void* part, void* dgamma,
                                   void* dbeta, void* dcb, void* stream) {
  if (!valid_nhwc(dtype, vec, sms, n, c, groups, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  void* pcb = cb_partials(cb, part, n * kMaxCluster, c);
  int cluster = 1;
  if (n > 0) {
    const cudaError_t err =
        dtype == 0 ? (vec ? launch_bwd_nhwc<float, 4>
                          : launch_bwd_nhwc<float, 1>)(
                         sms, n, c, groups, hw, dy, x, mean, rstd, gamma,
                         beta, cb, dx, part, pcb, s, &cluster)
                   : (vec ? launch_bwd_nhwc<bf16, 8>
                          : launch_bwd_nhwc<bf16, 1>)(
                         sms, n, c, groups, hw, dy, x, mean, rstd, gamma,
                         beta, cb, dx, part, pcb, s, &cluster);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  launch_params(cb != nullptr, part, pcb, dgamma, dbeta, dcb,
                static_cast<int>(n * cluster), c, s);
  return static_cast<int>(cudaGetLastError());
}
