// AdamW for Hopper (sm_90a): the global norm of the gradients and one
// fused update pass, each over many leaves a launch.
//
// Replaces no TPU kernel: the JAX package's AdamW (repro/train/
// optimizer.py) is elementwise code that XLA fuses.  It was added because
// the port's plain version (repro_torch.train.optimizer.apply_updates'
// loop, a stacked leaf one layer slice at a time) makes about 27 aten
// launches a slice and float32 temporaries of each slice: about 890
// launches and over 200 bytes a parameter in a step of a 1.6 B-parameter
// model, where the update needs 24.
//
// Bound: memory.  The update reads p, g, m and v once and writes p, m and
// v once (bf16 params and grads, float32 moments: 22 bytes a parameter);
// the norm reads g once more (2).  At 1.625 B parameters that is 39.0 GB,
// 11.6 ms over 3.35 TB/s; about 19 float32 operations a parameter are far
// below the card's operations-per-byte balance.
//
// Design.  A launch takes a table of up to kMaxLeaves leaves as a kernel
// parameter (__grid_constant__, read in place from the constant bank): no
// device allocation and no copy to the card a step.  Each leaf is cut into
// chunks of kChunk elements and a block takes one chunk; the table holds
// each leaf's first chunk, and a block finds its leaf by a walk over at
// most kMaxLeaves entries.  A leaf whose pointers all lie on 16-byte
// boundaries is read and written kVec elements a thread at a time (16
// bytes of bf16, 32 of float32) with streaming loads and stores, the
// leaf's ragged end one element a thread; any other leaf (an odd view, a
// 0-d leaf) one element a thread.  A call with more leaves than a table
// holds launches once per table.
//
// The update, per element, is the loop's arithmetic in float32 with the
// loop's rounding: no FMA contraction (the build passes --fmad=false and
// each step is an explicit _rn intrinsic), IEEE division and square root,
// each constant rounded to float as aten rounds a Python scalar, and p, m
// and v rounded once each to their dtypes.  lr, the bias corrections and
// the clip scale are read from float32 device scalars, so the step makes
// no host sync.  So with the same scale, p, m and v come out bit for bit
// as the loop's on the card.  The kernel is a template on the dtype of each
// role: P (params), G (grads), S (state) in {float, bf16}.
//
// The norm: each block sums its chunk's squares in float32 (kVec
// accumulators a thread, added in a fixed tree, then the block in a fixed
// tree) and writes its partial to scratch; one block of the finishing
// kernel adds the partials in a fixed order, with no atomics, takes the
// square root and writes the norm and the clip scale
// min(grad_clip / max(norm, 1e-9), 1) (1 when grad_clip is 0) after the
// partials.  The same grads give the same bits on every run; the result
// differs from the loop's only in the order of the sum.
//
// dtype code: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kMaxLeaves = 32;     // leaves a launch's table holds
constexpr int kThreads = 256;      // threads a block of the passes
constexpr int kFinishThreads = 1024;
constexpr int kVec = 8;            // elements a thread a step (aligned)
constexpr long long kChunk = 32768;  // elements a block

struct LeafTable {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  long long n[kMaxLeaves];
  long long first[kMaxLeaves + 1];  // each leaf's first chunk; [count]: all
  unsigned aligned;  // bit i: leaf i's pointers on 16-byte boundaries
  unsigned g_bf16;   // bit i: leaf i's grad in bf16 (the norm's table)
  int count;
};

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// kVec elements at a 16-byte boundary, as float32, and back (bf16 rounded
// to nearest even); streaming, since each byte is touched once a pass
__device__ __forceinline__ void load_vec(const float* src, float (&f)[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(src));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(src) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float (&f)[kVec]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store_vec(float* dst, const float (&f)[kVec]) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(f[0], f[1], f[2], f[3]));
  __stcs(reinterpret_cast<float4*>(dst) + 1,
         make_float4(f[4], f[5], f[6], f[7]));
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst,
                                          const float (&f)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], w[2], w[3]));
}

// the leaf of a chunk, and the chunk's [lo, hi) in it
struct Span {
  int leaf;
  long long lo, hi;
};
__device__ __forceinline__ Span span_of(const LeafTable& t, long long chunk) {
  int i = 0;
  while (chunk >= t.first[i + 1]) ++i;
  const long long lo = (chunk - t.first[i]) * kChunk;
  const long long hi = lo + kChunk < t.n[i] ? lo + kChunk : t.n[i];
  return {i, lo, hi};
}

// One element of the loop's AdamW (repro_torch.train.optimizer), in its
// order: g32 = g * scale; m1 = b1 m + (1 - b1) g32; v1 = b2 v + (1 - b2)
// g32 g32; delta = (m1 / bc1) / (sqrt(v1 / bc2) + eps) + wd p;
// p - lr delta.
__device__ __forceinline__ void adamw_element(float& p, float g, float& m,
                                              float& v, float lr, float bc1,
                                              float bc2, float scale,
                                              const Hyper& h) {
  const float g32 = __fmul_rn(g, scale);
  const float m1 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g32));
  const float v1 = __fadd_rn(__fmul_rn(h.b2, v),
                             __fmul_rn(__fmul_rn(h.one_minus_b2, g32), g32));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, bc2)), h.eps);
  const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(m1, bc1), den),
                                __fmul_rn(h.weight_decay, p));
  p = __fsub_rn(p, __fmul_rn(lr, delta));
  m = m1;
  v = v1;
}

template <typename P, typename G, typename S>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ LeafTable t,
                    const float* __restrict__ lr_p,
                    const float* __restrict__ bc1_p,
                    const float* __restrict__ bc2_p,
                    const float* __restrict__ scale_p, const Hyper h) {
  const Span s = span_of(t, blockIdx.x);
  P* __restrict__ p = static_cast<P*>(t.p[s.leaf]);
  const G* __restrict__ g = static_cast<const G*>(t.g[s.leaf]);
  S* __restrict__ m = static_cast<S*>(t.m[s.leaf]);
  S* __restrict__ v = static_cast<S*>(t.v[s.leaf]);
  const float lr = *lr_p, bc1 = *bc1_p, bc2 = *bc2_p, scale = *scale_p;
  long long tail = s.lo;
  if ((t.aligned >> s.leaf) & 1u) {
    tail = s.lo + (s.hi - s.lo) / kVec * kVec;
    for (long long e = s.lo + (long long)threadIdx.x * kVec; e < tail;
         e += kThreads * kVec) {
      float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
      load_vec(p + e, pf);
      load_vec(g + e, gf);
      load_vec(m + e, mf);
      load_vec(v + e, vf);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        adamw_element(pf[k], gf[k], mf[k], vf[k], lr, bc1, bc2, scale, h);
      store_vec(p + e, pf);
      store_vec(m + e, mf);
      store_vec(v + e, vf);
    }
  }
  for (long long e = tail + threadIdx.x; e < s.hi; e += kThreads) {
    float pf = to_f32(p[e]), mf = to_f32(m[e]), vf = to_f32(v[e]);
    adamw_element(pf, to_f32(g[e]), mf, vf, lr, bc1, bc2, scale, h);
    p[e] = from_f32<P>(pf);
    m[e] = from_f32<S>(mf);
    v[e] = from_f32<S>(vf);
  }
}

// the sum of a block's values in a fixed order: shuffles within each warp,
// then the warps' sums by the first warp, in warp order
template <int kBlock>
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sums[kBlock / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = 0.0f;
  if (warp == 0) {
    x = lane < kBlock / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;  // thread 0's is the block's
}

template <typename G>
__device__ __forceinline__ float sum_squares(const G* __restrict__ g,
                                             long long lo, long long hi,
                                             bool aligned) {
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
  long long tail = lo;
  if (aligned) {
    tail = lo + (hi - lo) / kVec * kVec;
    for (long long e = lo + (long long)threadIdx.x * kVec; e < tail;
         e += kThreads * kVec) {
      float f[kVec];
      load_vec(g + e, f);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(f[k], f[k]));
    }
  }
  for (long long e = tail + threadIdx.x; e < hi; e += kThreads) {
    const float f = to_f32(g[e]);
    acc[0] = __fadd_rn(acc[0], __fmul_rn(f, f));
  }
#pragma unroll
  for (int w = 1; w < kVec; w <<= 1)
#pragma unroll
    for (int k = 0; k < kVec; k += 2 * w) acc[k] = __fadd_rn(acc[k], acc[k + w]);
  return acc[0];
}

__global__ void __launch_bounds__(kThreads)
adamw_norm_kernel(const __grid_constant__ LeafTable t,
                  float* __restrict__ partial) {
  const Span s = span_of(t, blockIdx.x);
  const bool aligned = (t.aligned >> s.leaf) & 1u;
  const float x =
      (t.g_bf16 >> s.leaf) & 1u
          ? sum_squares(static_cast<const __nv_bfloat16*>(t.g[s.leaf]), s.lo,
                        s.hi, aligned)
          : sum_squares(static_cast<const float*>(t.g[s.leaf]), s.lo, s.hi,
                        aligned);
  const float total = block_sum<kThreads>(x);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// out[0] = sqrt(sum of partial[0:count]); out[1] = the clip scale, as
// optimizer.apply_updates computes it: clamp(grad_clip / clamp(norm,
// min=1e-9), max=1), which aten takes as reciprocal(...) * grad_clip
__global__ void __launch_bounds__(kFinishThreads)
adamw_norm_finish_kernel(const float* __restrict__ partial, long long count,
                         float grad_clip, float* __restrict__ out) {
  float x = 0.0f;
  for (long long i = threadIdx.x; i < count; i += kFinishThreads)
    x = __fadd_rn(x, partial[i]);
  x = block_sum<kFinishThreads>(x);
  if (threadIdx.x != 0) return;
  const float norm = __fsqrt_rn(x);
  float scale = 1.0f;
  if (grad_clip != 0.0f) {
    const float floor = isnan(norm) ? norm : fmaxf(norm, 1e-9f);
    const float r = __fmul_rn(__fdiv_rn(1.0f, floor), grad_clip);
    scale = isnan(r) ? r : fminf(r, 1.0f);
  }
  out[0] = norm;
  out[1] = scale;
}

inline bool aligned16(const void* a) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

// Fills `t` with leaves [from, ...) of the call that have elements, at
// most kMaxLeaves; returns the index after the last leaf taken.
template <typename Fill>
int fill_table(LeafTable& t, int from, int count, const long long* n,
               Fill&& fill) {
  t.count = 0;
  t.aligned = t.g_bf16 = 0u;
  t.first[0] = 0;
  int i = from;
  for (; i < count && t.count < kMaxLeaves; ++i) {
    if (n[i] <= 0) continue;
    const int j = t.count++;
    t.n[j] = n[i];
    fill(j, i);
    t.first[j + 1] = t.first[j] + (n[i] + kChunk - 1) / kChunk;
  }
  return i;
}

template <typename P, typename G, typename S>
int launch_update(void** p, const void** g, void** m, void** v,
                  const long long* n, int count,
                  const float* lr, const float* bc1, const float* bc2,
                  const float* scale, const Hyper& h, cudaStream_t stream) {
  LeafTable t;
  for (int i = 0; i < count;) {
    i = fill_table(t, i, count, n, [&](int j, int k) {
      t.p[j] = p[k], t.g[j] = g[k], t.m[j] = m[k], t.v[j] = v[k];
      if (aligned16(p[k]) && aligned16(g[k]) && aligned16(m[k]) &&
          aligned16(v[k]))
        t.aligned |= 1u << j;
    });
    if (t.count == 0) break;
    adamw_update_kernel<P, G, S><<<(unsigned)t.first[t.count], kThreads, 0,
                                   stream>>>(t, lr, bc1, bc2, scale, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// the chunks (the norm's partial sums) of leaves of n[0:count] elements
long long chunks_of(const long long* n, int count) {
  long long chunks = 0;
  for (int i = 0; i < count; ++i)
    if (n[i] > 0) chunks += (n[i] + kChunk - 1) / kChunk;
  return chunks;
}

}  // namespace

// The global norm of grads g[0:count] (n[i] elements each, dtype code
// dtype[i]): the partial sums into scratch[0:partials], then the norm and
// the clip scale into scratch[partials] and scratch[partials + 1].
// `partials` must be the leaves' chunks of kChunk
// elements (repro_torch.kernels.adamw.partials).
extern "C" int adamw_norm_launch(const void** g, const long long* n,
                                 const int* dtype, int count, void* scratch,
                                 long long partials, float grad_clip,
                                 int device, void* stream) {
  if (count < 0 || partials != chunks_of(n, count) ||
      partials > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i)
    if (dtype[i] != 0 && dtype[i] != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* partial = static_cast<float*>(scratch);
  return on_device(device, [&] {
    LeafTable t;
    long long base = 0;
    for (int i = 0; i < count;) {
      i = fill_table(t, i, count, n, [&](int j, int k) {
        t.p[j] = t.m[j] = t.v[j] = nullptr;
        t.g[j] = g[k];
        if (aligned16(g[k])) t.aligned |= 1u << j;
        if (dtype[k] == 1) t.g_bf16 |= 1u << j;
      });
      if (t.count == 0) break;
      adamw_norm_kernel<<<(unsigned)t.first[t.count], kThreads, 0, s>>>(
          t, partial + base);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      base += t.first[t.count];
    }
    adamw_norm_finish_kernel<<<1, kFinishThreads, 0, s>>>(
        partial, partials, grad_clip, partial + partials);
    return (int)cudaGetLastError();
  });
}

// One AdamW step of leaves p, g, m, v [0:count] (n[i] elements each, the
// dtype codes of params, grads and state), lr, bc1, bc2 and scale float32
// device scalars, the constants as the loop rounds them.
extern "C" int adamw_launch(void** p, const void** g, void** m, void** v,
                            const long long* n, int count, const void* lr,
                            const void* bc1, const void* bc2,
                            const void* scale, float b1, float one_minus_b1,
                            float b2, float one_minus_b2, float eps,
                            float weight_decay, int p_dtype, int g_dtype,
                            int s_dtype, int device, void* stream) {
  if (count < 0 || (p_dtype | g_dtype | s_dtype) & ~1)
    return (int)cudaErrorInvalidValue;
  if (chunks_of(n, count) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay};
  const float *lr_f = (const float*)lr, *bc1_f = (const float*)bc1,
              *bc2_f = (const float*)bc2, *scale_f = (const float*)scale;
  cudaStream_t s = (cudaStream_t)stream;
  using B = __nv_bfloat16;
  return on_device(device, [&] {
#define ADAMW_CASE(code, P, G, S)                                          \
  case code:                                                               \
    return launch_update<P, G, S>(p, g, m, v, n, count, lr_f, bc1_f, bc2_f, \
                                  scale_f, h, s);
    switch (p_dtype << 2 | g_dtype << 1 | s_dtype) {
      ADAMW_CASE(0, float, float, float)
      ADAMW_CASE(1, float, float, B)
      ADAMW_CASE(2, float, B, float)
      ADAMW_CASE(3, float, B, B)
      ADAMW_CASE(4, B, float, float)
      ADAMW_CASE(5, B, float, B)
      ADAMW_CASE(6, B, B, float)
      ADAMW_CASE(7, B, B, B)
    }
#undef ADAMW_CASE
    return (int)cudaErrorInvalidValue;
  });
}

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
