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

}  // namespace

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
