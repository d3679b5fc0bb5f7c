// RMSNorm over the rows of an (M, D) matrix, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py::rmsnorm (body
// _kernel): out = x * rsqrt(mean(x*x) + eps) * scale, all in float32, cast
// to the input type once at the end.  The plain version is
// repro_torch.kernels.ref.rmsnorm.
//
// Bound: memory.  Each element is read once and written once (2 x 2 bytes
// in bf16) for about four operations, far below the card's
// operations-per-byte balance; at (2000, 3072) bf16 the least time is about
// 7 us (24.6 MB over 3.35 TB/s).
// Design: one block of 256 threads per row.  Each thread strides over the
// row (neighbouring threads on neighbouring addresses, so loads coalesce)
// and keeps its partial sum of squares in float32; warp shuffles and one
// shared-memory hop reduce it.  The row is then read a second time (from
// L1/L2: a 3072-wide bf16 row is 6 KB) and written once.  The TPU version's
// divisibility of M by the row block is gone: one block per row takes any M.
//
// dtype code: 0 = float32, 1 = bfloat16 (x, scale and out share it).
//
// Backward (rmsnorm_bwd_launch): the gradient of the same function, which
// the TPU kernel never had (the JAX models differentiate an inline RMSNorm
// with XLA, repro/models/layers.py:87).  With r = rsqrt(mean(x*x) + eps)
// and g = dy * scale, all in float32:
//   dx     = r * g - x * r^3 * mean(g * x)      (one cast a row)
//   dscale = sum over rows of dy * x * r        (one cast at the end)
// Bound: memory, x and dy read and dx written once (plus the partial sums):
// at (16384, 3072) bf16, 302 MB, 0.090 ms over 3.35 TB/s; at (16384, 4096)
// 0.120 ms, at (16384, 8192) 0.240 ms.  Design: a row over W warps (W = 1,
// 2 or 4), 8 / W rows in flight a block, each block walking every
// (blocks x 8 / W)-th row.  On the register path (D a multiple of the
// 16-byte vector and at most 12 vectors a lane: W = 1 up to 3072 bf16 /
// 1536 float32 (rmsnorm_bwd_warp_kernel), W = 2 up to 6144 / 3072 and
// W = 4 up to 12288 / 6144 (rmsnorm_bwd_split_kernel<T, W>); x, dy and dx
// on 16-byte boundaries) a lane loads its 12 vectors of x and of dy at
// once (24 loads of 16 bytes in flight a lane), so x and dy come from
// device memory once; the row's two sums reduce with shuffles, and over
// its W warps in warp order through shared memory behind one named
// barrier a row; dx is written 16 bytes a lane; each lane adds its
// columns' dy * x * r into registers across its rows, and the block adds
// its row groups' partials in order into one partial row, written once.
// Scale sits in shared memory as float32, laid out so the lanes of a warp
// read neighbouring words.  Rows past the register path (D not a multiple
// of the vector, misaligned views, D past 12288 bf16 / 6144 float32) take
// rmsnorm_bwd_loop_kernel: a block a row, the row read twice (the second
// pass from L1 or L2), 16-byte loads where aligned, each thread's columns'
// partials in shared memory and written once a block.  A second kernel
// sums the blocks' partial rows in row order, so dscale is the same bits
// on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "hopper.cuh"  // named_barrier

namespace {

constexpr int kThreads = 256;

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
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int D, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = out + row * D;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float warp_sums[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  const float r = rsqrtf(total / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += kThreads)
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(scale[i]));
}

// the float32 values of 16 bytes of T, and back (rounded to nearest)
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

constexpr int kBwdWarps = 8;     // warps a block
constexpr int kBwdRegVecs = 12;  // 16-byte vectors of x (and of dy) a lane
                                 // holds: rows of 3072 bf16, 1536 float32
                                 // a warp

// The register path, a row over W warps (W = 1: rmsnorm_bwd_warp_kernel;
// 2 and 4: rmsnorm_bwd_split_kernel), kBwdWarps / W rows in flight a
// block: a lane's kBwdRegVecs vectors of x and dy (vector (j W + part) 32
// + lane of the row, so the W warps read neighbouring vectors) loaded at
// once and kept until dx is written; the row's two sums reduced with
// shuffles, then (W > 1) over its W warps in warp order through shared
// memory, behind one named barrier a row (the slots alternate by row, so
// a slot is written again only after the barrier of the row between); the
// lane's columns' dscale partials in registers across its rows, then the
// block's row groups' partials added in group order into row blockIdx.x
// of `partial`.  Shared memory: scale in float32 and the block's partial
// row, [D] each, element e of vector v at e * (D / VEC) + v, so that the
// lanes of a warp read and write neighbouring words; the slots first.
template <typename T, int W>
__device__ __forceinline__ void bwd_rows(const T* __restrict__ x,
                                         const T* __restrict__ scale,
                                         const T* __restrict__ dy,
                                         T* __restrict__ dx,
                                         float* __restrict__ partial,
                                         long long M, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T), NV = kBwdRegVecs;
  constexpr int G = kBwdWarps / W;  // rows in flight a block
  extern __shared__ float2 bwd_smem[];
  const int nvec = D / VEC;
  float2* slots = bwd_smem;  // [2][G][W]
  float* sc = reinterpret_cast<float*>(slots + 2 * kBwdWarps);  // [VEC][nvec]
  float* red = sc + D;                                          // [VEC][nvec]
  for (int i = threadIdx.x; i < D; i += kBwdWarps * 32)
    sc[(i % VEC) * nvec + i / VEC] = to_f32(scale[i]);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / W, part = warp % W;
  float acc[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;
  int parity = 0;
  for (long long row = (long long)blockIdx.x * G + grp; row < M;
       row += (long long)gridDim.x * G) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + row * D);
    uint4 xv[NV], gv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = (j * W + part) * 32 + lane;
      xv[j] = v < nvec ? xr[v] : make_uint4(0u, 0u, 0u, 0u);
      gv[j] = v < nvec ? gr[v] : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.0f, gx = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = (j * W + part) * 32 + lane;
      if (v >= nvec) continue;
      float xf[VEC], gf[VEC];
      unpack(xv[j], xf);
      unpack(gv[j], gf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss += xf[e] * xf[e];
        gx += gf[e] * sc[e * nvec + v] * xf[e];
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    if constexpr (W > 1) {
      float2* slot = slots + (parity * G + grp) * W;
      if (lane == 0) slot[part] = make_float2(ss, gx);
      named_barrier(1 + grp, 32 * W);
      ss = gx = 0.0f;
#pragma unroll
      for (int p = 0; p < W; ++p) {
        const float2 t = slot[p];
        ss += t.x;
        gx += t.y;
      }
      parity ^= 1;
    }
    const float r = rsqrtf(ss / (float)D + eps);
    const float c = r * r * r * (gx / (float)D);
    uint4* dr = reinterpret_cast<uint4*>(dx + row * D);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = (j * W + part) * 32 + lane;
      if (v >= nvec) continue;
      float xf[VEC], gf[VEC], out[VEC];
      unpack(xv[j], xf);
      unpack(gv[j], gf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        out[e] = r * (gf[e] * sc[e * nvec + v]) - xf[e] * c;
        acc[j][e] += gf[e] * xf[e] * r;
      }
      dr[v] = pack(out);
    }
  }
  // the row groups' partials into red in group order: the same sum on
  // every run
  for (int g = 0; g < G; ++g) {
    if (grp == g) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = (j * W + part) * 32 + lane;
        if (v >= nvec) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red[e * nvec + v] =
              g == 0 ? acc[j][e] : red[e * nvec + v] + acc[j][e];
      }
    }
    __syncthreads();
  }
  float* pr = partial + (long long)blockIdx.x * D;
  for (int i = threadIdx.x; i < D; i += kBwdWarps * 32)
    pr[i] = red[(i % VEC) * nvec + i / VEC];
}

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
rmsnorm_bwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, long long M, int D,
                        float eps) {
  bwd_rows<T, 1>(x, scale, dy, dx, partial, M, D, eps);
}

template <typename T, int W>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
rmsnorm_bwd_split_kernel(const T* __restrict__ x,
                         const T* __restrict__ scale,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ partial, long long M, int D,
                         float eps) {
  bwd_rows<T, W>(x, scale, dy, dx, partial, M, D, eps);
}

// Rows past the register path (D not a multiple of the vector, operands
// off 16-byte boundaries, or wider than 4 warps' registers): a block a row,
// walking every gridDim.x-th row, which it reads twice (the sums, then dx;
// the second pass from L1 or L2), 16 bytes at a time where VECT (D a
// multiple of the vector, x, dy and dx aligned), else element by element.
// The row's sums reduce over the block in warp order through a slot pair
// that alternates by row (one __syncthreads a row); each thread adds its
// own columns' dscale partials in shared memory (a column belongs to one
// thread: no atomics, no global read-modify-write) and writes them once,
// to row blockIdx.x of `partial`.
template <typename T, bool VECT>
__global__ void __launch_bounds__(kBwdWarps * 32)
rmsnorm_bwd_loop_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, long long M, int D,
                        float eps) {
  constexpr int VEC = VECT ? 16 / sizeof(T) : 1;
  constexpr int NT = kBwdWarps * 32;
  extern __shared__ float2 bwd_smem[];
  float2* slots = bwd_smem;  // [2][kBwdWarps]
  float* red = reinterpret_cast<float*>(slots + 2 * kBwdWarps);  // [D]
  const int nvec = D / VEC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < nvec; i += NT)
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[e * nvec + i] = 0.0f;
  // the VEC values of vector i of a row, as float32
  auto load = [&](const T* row, int i, float (&f)[VEC]) {
    if constexpr (VECT)
      unpack(reinterpret_cast<const uint4*>(row)[i], f);
    else
      f[0] = to_f32(row[i]);
  };
  int parity = 0;
  for (long long row = blockIdx.x; row < M; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float ss = 0.0f, gx = 0.0f;
    for (int i = threadIdx.x; i < nvec; i += NT) {
      float xf[VEC], gf[VEC];
      load(xr, i, xf);
      load(gr, i, gf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss += xf[e] * xf[e];
        gx += gf[e] * to_f32(scale[i * VEC + e]) * xf[e];
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    float2* slot = slots + parity * kBwdWarps;
    if (lane == 0) slot[warp] = make_float2(ss, gx);
    __syncthreads();
    ss = gx = 0.0f;
    for (int w = 0; w < kBwdWarps; ++w) {
      ss += slot[w].x;
      gx += slot[w].y;
    }
    parity ^= 1;
    const float r = rsqrtf(ss / (float)D + eps);
    const float c = r * r * r * (gx / (float)D);
    T* dr = dx + row * D;
    for (int i = threadIdx.x; i < nvec; i += NT) {
      float xf[VEC], gf[VEC], out[VEC];
      load(xr, i, xf);
      load(gr, i, gf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        out[e] = r * (gf[e] * to_f32(scale[i * VEC + e])) - xf[e] * c;
        red[e * nvec + i] += gf[e] * xf[e] * r;
      }
      if constexpr (VECT)
        reinterpret_cast<uint4*>(dr)[i] = pack(out);
      else
        dr[i] = from_f32<T>(out[0]);
    }
  }
  float* pr = partial + (long long)blockIdx.x * D;
  for (int i = threadIdx.x; i < nvec; i += NT)
#pragma unroll
    for (int e = 0; e < VEC; ++e) pr[i * VEC + e] = red[e * nvec + i];
}

// dscale[i] = the partial rows' column i, added in row order
template <typename T>
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partial,
                                      T* __restrict__ dscale, int rows,
                                      int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D) return;
  float s = 0.0f;
  for (int b = 0; b < rows; ++b) s += partial[(long long)b * D + i];
  dscale[i] = from_f32<T>(s);
}

// the warps a row of D values takes on the register path (1, 2 or 4: at
// most kBwdRegVecs vectors a lane), or 0 when it is wider
template <typename T>
int bwd_row_warps(int D) {
  constexpr int PER = kBwdRegVecs * 32 * (16 / (int)sizeof(T));  // a warp's
  return D <= PER ? 1 : D <= 2 * PER ? 2 : D <= 4 * PER ? 4 : 0;
}

template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, T*, float*,
                           long long, int, float);

// launch with `bytes` of dynamic shared memory, raising the kernel's limit
// first where they pass the default 48 KB
template <typename T>
cudaError_t launch_with_smem(BwdKernel<T> kernel, int blocks, size_t bytes,
                             cudaStream_t s, const void* x,
                             const void* scale, const void* dy, void* dx,
                             void* partial, long long M, int D, float eps) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kBwdWarps * 32, bytes, s>>>(
      (const T*)x, (const T*)scale, (const T*)dy, (T*)dx, (float*)partial, M,
      D, eps);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale, void* partial, long long M, int D, int blocks,
               float eps, cudaStream_t s) {
  // 16-byte vectors: D a multiple of the vector, x, dy, dx aligned
  const bool vect = D % (16 / sizeof(T)) == 0 &&
                    (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx) & 15) == 0;
  const size_t slots = 2 * sizeof(float2) * kBwdWarps;
  const size_t reg_bytes = 2 * sizeof(float) * (size_t)D + slots;
  const size_t loop_bytes = sizeof(float) * (size_t)D + slots;
  cudaError_t err;
  switch (vect ? bwd_row_warps<T>(D) : 0) {
    case 1:
      err = launch_with_smem<T>(rmsnorm_bwd_warp_kernel<T>, blocks,
                                reg_bytes, s, x, scale, dy, dx, partial, M,
                                D, eps);
      break;
    case 2:
      err = launch_with_smem<T>(rmsnorm_bwd_split_kernel<T, 2>, blocks,
                                reg_bytes, s, x, scale, dy, dx, partial, M,
                                D, eps);
      break;
    case 4:
      err = launch_with_smem<T>(rmsnorm_bwd_split_kernel<T, 4>, blocks,
                                reg_bytes, s, x, scale, dy, dx, partial, M,
                                D, eps);
      break;
    default:
      err = vect ? launch_with_smem<T>(rmsnorm_bwd_loop_kernel<T, true>,
                                       blocks, loop_bytes, s, x, scale, dy,
                                       dx, partial, M, D, eps)
                 : launch_with_smem<T>(rmsnorm_bwd_loop_kernel<T, false>,
                                       blocks, loop_bytes, s, x, scale, dy,
                                       dx, partial, M, D, eps);
  }
  if (err != cudaSuccess) return (int)err;
  // one partial row a block, whatever the route
  rmsnorm_dscale_kernel<T><<<(D + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const float*)partial, (T*)dscale, blocks, D);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward: dx (M, D) and dscale (D,) from x, scale and dy, with
// `partial` a float32 (blocks, D) scratch the caller allocates, one row a
// block; blocks in [1, ceil(M / 8)].  Launches on `stream`
// with `device` current; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a dtype code other than 0 or 1, a block count
// outside [1, ceil(M / 8)] or D past 32768.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* dy, void* dx, void* dscale,
                                  void* partial, long long M, int D,
                                  int blocks, float eps, int dtype,
                                  int device, void* stream) {
  if (M <= 0 || D <= 0) return 0;
  if (blocks < 1 || blocks > (M + kBwdWarps - 1) / kBwdWarps || D > 32768 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    return dtype == 0
               ? launch_bwd<float>(x, scale, dy, dx, dscale, partial, M, D,
                                   blocks, eps, s)
               : launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale,
                                           partial, M, D, blocks, eps, s);
  });
}

// Launches on `stream` with `device` current; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a dtype code other than 0 or 1.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              long long M, int D, float eps, int dtype,
                              int device, void* stream) {
  if (M <= 0 || D <= 0) return 0;
  if (M > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    if (dtype == 0)
      rmsnorm_kernel<float><<<(unsigned)M, kThreads, 0, s>>>(
          (const float*)x, (const float*)scale, (float*)out, D, eps);
    else
      rmsnorm_kernel<__nv_bfloat16><<<(unsigned)M, kThreads, 0, s>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)scale,
          (__nv_bfloat16*)out, D, eps);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
