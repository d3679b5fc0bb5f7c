// Fused SwiGLU gate, silu(x @ w1) * (x @ w3), for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/fused_swiglu.py::fused_swiglu
// (body _kernel): x (M, D), w1 and w3 (D, F), row-major; out (M, F) in the
// input type.  Both products accumulate in float32 and the gate
// silu(a) * b = a / (1 + exp(-a)) * b is applied in float32 before the one
// cast, as the reference does.  The plain version is
// repro_torch.kernels.ref.fused_swiglu.
//
// Bound: operations for many rows, bytes for few.  At M = 2000, D = 3072,
// F = 8192 the two products are 201 GFLOP, about 0.2 ms at the bf16
// tensor-core peak; at M = 4 (one decode step of a batch of 4) the 100 MB
// of w1 and w3 bound it, about 30 us over 3.35 TB/s.
// Design (simple first, no tensor cores yet): one block owns one (BM, BN)
// output tile and keeps both float32 accumulators in registers, TM x TN
// per thread.  The TPU kernel's sequential k grid axis becomes a loop over
// D inside the block: each step stages a (BM, BK) tile of x and (BK, BN)
// tiles of w1 and w3 in shared memory as float32; the one x tile feeds both
// products.  The gate is the epilogue, so the (M, F) intermediates never
// reach device memory.  A tall tile (64 x 64) serves many rows; a flat one
// (16 x 64, deeper BK) serves decode, where M is a handful of rows and the
// weights are the traffic.  Ragged M, F and D are masked in the loads and
// the store; nothing is padded on the host.  The products use fmaf
// explicitly: the library is built with --fmad=false.
//
// dtype code: 0 = float32, 1 = bfloat16 (x, w1, w3 and out share it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

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

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
fused_swiglu_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const T* __restrict__ w3, T* __restrict__ out, int M,
                    int D, int F) {
  constexpr int TX = BN / TN;            // threads along F
  constexpr int NT = (BM / TM) * TX;     // threads per block
  __shared__ float xs[BK][BM + 1];       // x tile, transposed, padded
  __shared__ float w1s[BK][BN];
  __shared__ float w3s[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc1[TM][TN], acc3[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc1[i][j] = acc3[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // stage x: neighbouring threads read neighbouring k of one row
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < D) ? to_f32(x[(long long)m * D + k]) : 0.0f;
    }
    // stage w1, w3: neighbouring threads read neighbouring f of one k
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int r = idx / BN, c = idx % BN;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < D && n < F;
      const long long off = (long long)k * F + n;
      w1s[r][c] = ok ? to_f32(w1[off]) : 0.0f;
      w3s[r][c] = ok ? to_f32(w3[off]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b1[TN], b3[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b1[j] = w1s[kk][tx + j * TX];
        b3[j] = w3s[kk][tx + j * TX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc1[i][j] = fmaf(a[i], b1[j], acc1[i][j]);
          acc3[i][j] = fmaf(a[i], b3[j], acc3[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= F) continue;
      const float a = acc1[i][j];
      const float g = a / (1.0f + expf(-a)) * acc3[i][j];
      out[(long long)m * F + n] = from_f32<T>(g);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x, const void* w1, const void* w3, void* out, int M,
           int D, int F, cudaStream_t s) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  const int threads = (BM / TM) * (BN / TN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fused_swiglu_kernel<T, BM, BN, BK, TM, TN><<<grid, threads, 0, s>>>(
      (const T*)x, (const T*)w1, (const T*)w3, (T*)out, M, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for(const void* x, const void* w1, const void* w3, void* out,
               int M, int D, int F, cudaStream_t s) {
  if (M <= 16)  // decode: a flat, deep tile; weights are the traffic
    return launch<T, 16, 64, 32, 1, 4>(x, w1, w3, out, M, D, F, s);
  return launch<T, 64, 64, 16, 4, 4>(x, w1, w3, out, M, D, F, s);
}

}  // namespace

// Launches on `stream` with `device` current; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a dtype code other than 0 or 1
// or a grid the card cannot take.
extern "C" int fused_swiglu_launch(const void* x, const void* w1,
                                   const void* w3, void* out, int M, int D,
                                   int F, int dtype, int device,
                                   void* stream) {
  if (M <= 0 || F <= 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    return dtype == 0
               ? launch_for<float>(x, w1, w3, out, M, D, F, s)
               : launch_for<__nv_bfloat16>(x, w1, w3, out, M, D, F, s);
  });
}

extern "C" const char* fused_swiglu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
