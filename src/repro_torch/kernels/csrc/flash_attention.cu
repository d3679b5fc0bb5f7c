// Causal / sliding-window flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel): q (H, S, d), k and v (H / kv_group, S, d),
// out (H, S, d), row-major.  Query head h reads kv head h / kv_group, so
// grouped-query attention needs no repeated k/v; kv_group = 1 is the TPU
// kernel's function.  Scores are (q . k) / sqrt(d) in float32; masked ones
// (k > q when causal, q - k >= window when a window is set) are -1e30; the
// softmax runs online over k tiles carrying (m, l, acc), and the output is
// acc / max(l, 1e-30), cast to the input type.  The plain version is
// repro_torch.kernels.ref.flash_attention.
//
// Bound: bytes for short sequences.  At (96, 500, 128) bf16, causal, with
// kv_group 3, the inputs and output are 32.8 MB (about 10 us over
// 3.35 TB/s) against 6.2 GFLOP of live tiles (about 6 us at the bf16 peak).
// Design (simple first, no tensor cores yet): one block of 256 threads per
// (head, 64-row q tile).  The TPU kernel's sequential k grid axis becomes a
// loop inside the block over 64-row k tiles; a tile wholly outside the
// causal band or the window is skipped with the TPU kernel's own test.  q
// (transposed), k (transposed), v and the probabilities live in dynamic
// shared memory as float32 (about 113 KB at d = 128, above the 48 KB static
// limit, so the launch raises the block's limit first); the (S, S) scores
// never reach device memory.  Each thread owns 4 query rows x 4 key columns
// of a score tile and 4 rows x d/16 columns of the output, with columns
// interleaved by 16 so shared-memory reads do not collide.  A row's 16
// threads sit in one half-warp, so its max and sum reduce with shuffles.
// Ragged S is masked: k/v rows past S load as zero and their scores as
// -inf; q rows past S are never stored.
//
// dtype code: 0 = float32, 1 = bfloat16 (q, k, v and out share it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int DMAX = 128;    // largest head dim
constexpr int kThreads = 256;
constexpr int RI = BQ / 16;  // rows per thread
constexpr int CJ = BK / 16;  // score columns per thread
constexpr int DJ = DMAX / 16;  // output columns per thread (at most)
constexpr float NEG = -1e30f;

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

size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)d * (BQ + 1) + (size_t)d * (BK + 1) + (size_t)BK * d +
          (size_t)BQ * (BK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int d, int causal, int window, int kv_group,
                       float scale) {
  extern __shared__ float smem[];
  float* qt = smem;                   // [d][BQ + 1]  q tile, transposed
  float* kt = qt + d * (BQ + 1);      // [d][BK + 1]  k tile, transposed
  float* vs = kt + d * (BK + 1);      // [BK][d]      v tile
  float* ps = vs + BK * d;            // [BQ][BK + 1] probabilities

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long qbase = (long long)h * S * d;
  const long long kbase = (long long)(h / kv_group) * S * d;

  for (int idx = tid; idx < BQ * d; idx += kThreads) {
    const int r = idx / d, c = idx % d;
    qt[c * (BQ + 1) + r] =
        q0 + r < S ? to_f32(q[qbase + (long long)(q0 + r) * d + c]) : 0.0f;
  }

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  const int n_k = (S + BK - 1) / BK;
  for (int ki = 0; ki < n_k; ++ki) {
    const int k0 = ki * BK;
    // visit the tile only if it meets the causal band / the window
    // (the TPU kernel's test; uniform over the block)
    if (causal && q0 + BQ - 1 < k0) break;
    if (window && !(q0 < k0 + BK + window)) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * d; idx += kThreads) {
      const int r = idx / d, c = idx % d;
      const bool ok = k0 + r < S;
      const long long off = kbase + (long long)(k0 + r) * d + c;
      kt[c * (BK + 1) + r] = ok ? to_f32(k[off]) : 0.0f;
      vs[r * d + c] = ok ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float a[RI], b[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = qt[c * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = kt[c * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if ((causal && qp < kp) || (window && qp - kp >= window)) x = NEG;
        if (kp >= S) x = -INFINITY;  // past the sequence: no weight at all
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // ps complete

    for (int c = 0; c < BK; ++c) {
      float p[RI], w[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int col = tx + 16 * j;
        w[j] = col < d ? vs[c * d + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d)
        out[qbase + (long long)qp * d + col] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int H,
           int S, int d, int causal, int window, int kv_group, float scale,
           cudaStream_t s) {
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)flash_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (S + BQ - 1) / BQ);
  flash_attention_kernel<T><<<grid, kThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, d, causal, window,
      kv_group, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a dtype code other than 0 or 1, d outside
// [1, 128], a kv_group that does not divide H, or a grid the card cannot
// take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int H, int S,
                                      int d, int causal, int window,
                                      int kv_group, float scale, int dtype,
                                      void* stream) {
  if (H <= 0 || S <= 0) return 0;
  if (d < 1 || d > DMAX || kv_group < 1 || H % kv_group != 0 ||
      (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, H, S, d, causal, window, kv_group,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, H, S, d, causal, window,
                                 kv_group, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
