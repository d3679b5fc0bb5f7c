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
// Bound: memory, x and dy read and dx written once (plus the partial sums,
// blocks x D floats).  One block of 256 threads walks a run of rows (rows
// / blocks, from the wrapper's block count): a row is reduced like the
// forward's (both sums in one pass, warp shuffles, one shared hop), then
// dx is written and each thread adds its columns' dy * x * r into the
// block's dscale partial in shared memory (a column belongs to one thread,
// so no atomics and no barrier).  A second kernel sums the partials over
// the blocks in block order, so dscale is the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

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

// one block per run of rows; `partial` (gridDim.x, D) gets the block's
// dscale partial sums
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, long long M, int D,
                   long long rows, float eps) {
  extern __shared__ float acc[];  // [D], column i owned by thread i % 256
  __shared__ float red[2][kThreads / 32];
  for (int i = threadIdx.x; i < D; i += kThreads) acc[i] = 0.0f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * D;
    const T* gr = dy + row * D;
    float ss = 0.0f, gx = 0.0f;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float v = to_f32(xr[i]);
      ss += v * v;
      gx += to_f32(gr[i]) * to_f32(scale[i]) * v;
    }
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = gx;
    }
    __syncthreads();
    float ss_t = 0.0f, gx_t = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) {
      ss_t += red[0][w];
      gx_t += red[1][w];
    }
    __syncthreads();  // red is read by all before the next row writes it
    const float r = rsqrtf(ss_t / (float)D + eps);
    const float c = r * r * r * (gx_t / (float)D);
    T* dr = dx + row * D;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float v = to_f32(xr[i]);
      const float gy = to_f32(gr[i]);
      dr[i] = from_f32<T>(r * (gy * to_f32(scale[i])) - v * c);
      acc[i] += gy * v * r;
    }
  }
  float* pr = partial + (long long)blockIdx.x * D;
  for (int i = threadIdx.x; i < D; i += kThreads) pr[i] = acc[i];
}

// dscale[i] = the blocks' partials of column i, added in block order
template <typename T>
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ partial,
                                      T* __restrict__ dscale, int blocks,
                                      int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * D + i];
  dscale[i] = from_f32<T>(s);
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale, void* partial, long long M, int D, int blocks,
               float eps, cudaStream_t s) {
  const size_t bytes = sizeof(float) * (size_t)D;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)rmsnorm_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long rows = (M + blocks - 1) / blocks;
  rmsnorm_bwd_kernel<T><<<blocks, kThreads, bytes, s>>>(
      (const T*)x, (const T*)scale, (const T*)dy, (T*)dx, (float*)partial,
      M, D, rows, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_dscale_kernel<T><<<(D + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const float*)partial, (T*)dscale, blocks, D);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward: dx (M, D) and dscale (D,) from x, scale and dy, with
// `partial` a float32 (blocks, D) scratch the caller allocates; blocks in
// [1, M].  Launches on `stream` with `device` current; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a dtype
// code other than 0 or 1, a block count outside [1, M] or D past 32768
// (the partial row lives in shared memory).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* dy, void* dx, void* dscale,
                                  void* partial, long long M, int D,
                                  int blocks, float eps, int dtype,
                                  int device, void* stream) {
  if (M <= 0 || D <= 0) return 0;
  if (blocks < 1 || blocks > M || D > 32768 || (dtype != 0 && dtype != 1))
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
