// Fused SwiGLU gate, silu(x @ w1) * (x @ w3), for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/fused_swiglu.py::fused_swiglu
// (body _kernel): x (M, D), w1 and w3 (D, F), row-major and contiguous, in
// the layout models/convert.py gives them (nothing is transposed or
// repacked on the host); out (M, F) in the input type.  Both products
// accumulate in float32 and the gate silu(a) * b = a / (1 + exp(-a)) * b
// is applied in float32 before the one cast, as the reference does.  The
// plain version is repro_torch.kernels.ref.fused_swiglu.
//
// The caller picks one of three routes by shape, dtype and the operands'
// 16-byte alignment (repro_torch/kernels/fused_swiglu.py::route); a route
// the call cannot take is refused with cudaErrorInvalidValue, never
// replaced by another.
//
// 0. Stream route, decode: M <= 16 rows, float32 or bfloat16.  Bound by
//    bytes: at (4, 3072) x (3072, 8192) bf16 the 100.7 MB of w1 and w3
//    take 30 us over 3.35 TB/s, against 0.2 GFLOP.  No tensor cores, so
//    float32 keeps its precision.  A block of 2 warps owns 128 bytes of F
//    (64 bf16 or 32 f32 columns) and a quarter of D: a cluster of 4
//    blocks splits D, so the serve shape runs 512 blocks (3.9 an SM).
//    Each thread reads 16 bytes of a w1 row and 16 of the w3 row (eight
//    lanes cover a row's 128 bytes, a warp four rows), issues kUnroll = 8
//    such pairs before it uses any, and never waits on a barrier between
//    load and use: 256 bytes in flight a thread, 16 KB a block, about 62
//    KB an SM at the serve shape (Little's law asks 15-25 KB: 3.35 TB/s x
//    0.6-1 us over 132 SMs).  At the same bytes in flight, fewer and
//    deeper warps ran faster on the H100 than more and shallower ones.  x
//    (at most 8 rows of the block's quarter of D, 1024 columns at a time)
//    sits once in shared memory as float32.  The four lanes that share
//    columns reduce with shuffles, the warps through shared memory, and
//    the cluster's four blocks through distributed shared memory; each
//    block then gates and stores a quarter of the tile.  One launch, no
//    workspace.  Rows past 8 take a second cluster over the same columns,
//    launched beside the first so the weights come from L2 the second
//    time.  A row that is not 16-byte aligned (F not a multiple of the
//    vector width, or an odd base address) loads element by element,
//    masked at F; nothing is padded.  The products are written as fmaf:
//    the library is built with --fmad=false.
// 1. Tensor-core route, prefill: M > 16, bfloat16, D and F multiples of 8
//    (TMA needs 16-byte strides), operands on 16-byte boundaries (any
//    tensor PyTorch allocates; a view at an odd element offset goes to the
//    SIMT route).  Bound by operations: at (2000, 3072) x
//    (3072, 8192) the two products are 201 GFLOP, 0.204 ms at the 989
//    TFLOP/s bf16 peak, against 0.044 ms for the 146 MB it moves.  A GEMM
//    with two B operands and the gate as its epilogue.  A block of 384
//    threads owns 128 rows x 128 columns of F; its B tile is
//    [w1[:, n0:n0+128] | w3[:, n0:n0+128]], 256 columns, and K runs in steps
//    of 64 through 4 stages of shared memory (16 KB of x + 32 KB of w each,
//    192 KB).  One producer thread issues the TMA loads
//    (cp.async.bulk.tensor, 128-byte swizzle) that complete on an mbarrier
//    per stage; two consumer warpgroups of 64 rows each run
//    wgmma.mma_async m64n256k16 (bf16 in, float32 accumulators, 128
//    registers a thread) with x as the K-major A operand and w1 | w3 as the
//    MN-major B operand read in place through the descriptor's transpose
//    bit (a 256-column tile is four 64-column TMA boxes, 8 KB apart: the
//    descriptor's leading byte offset).  One product group stays in flight
//    while the next stage is awaited; each consumer frees a stage on its
//    "empty" mbarrier once the products reading it are done.  setmaxnreg
//    moves registers from the producer warpgroup (40) to the consumers
//    (232).  Column c of w1 and column c of w3 land in the same thread, 64
//    registers apart, so the gate is computed in registers and stored
//    straight from them, masked at the ragged M and F edges; TMA fills
//    reads past M, D and F with zeros.  The M tiles run fastest over the
//    grid, so the M tiles of one F column read their weight tile from L2
//    and the weights come from HBM about once.
// 2. SIMT route: everything else (float32 at M > 16, whose TF32 products
//    would miss the float32 tolerance; bfloat16 whose strides TMA cannot
//    describe).  One block owns a 64 x 64 output tile and keeps both
//    float32 accumulators in registers, 4 x 4 per thread; each 16-deep k
//    step stages x, w1 and w3 in shared memory as float32.
//
// dtype code: 0 = float32, 1 = bfloat16 (x, w1, w3 and out share it).
// route code: 0 = stream, 1 = tensor cores, 2 = SIMT.
//
// Backward of the gate (swiglu_gate_bwd_launch), which the TPU kernel never
// had (the JAX models differentiate an inline SwiGLU with XLA,
// repro/models/layers.py:359).  From dh and the two products a = x @ w1 and
// b = x @ w3 (recomputed by the caller with torch.matmul in the input
// type, so a bf16 caller's a and b are rounded to bf16 first), with
// s = 1 / (1 + exp(-a)), all in float32 and cast once:
//   da = dh * b * s * (1 + a * (1 - s))      (silu'(a))
//   db = dh * a * s                           (silu(a))
// The products dx, dw1 and dw3 stay with the caller (torch.matmul), as the
// JAX package leaves them to XLA.  Bound: memory, 3 reads and 2 writes an
// element (1.34 GB at (16384, 8192) bf16, 0.40 ms over 3.35 TB/s).  A
// grid-stride loop over the flat buffers, 16 bytes a load where every
// pointer is 16-byte aligned, one element at a time otherwise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

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

__device__ __forceinline__ float gate(float a, float b) {
  return a / (1.0f + expf(-a)) * b;
}

// ---------------------------------------------------------------- SIMT --

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
      out[(long long)m * F + n] = from_f32<T>(gate(acc1[i][j], acc3[i][j]));
    }
  }
}

template <typename T>
int launch_simt(const void* x, const void* w1, const void* w3, void* out,
                int M, int D, int F, cudaStream_t s) {
  constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fused_swiglu_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN),
                                                0, s>>>(
      (const T*)x, (const T*)w1, (const T*)w3, (T*)out, M, D, F);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- stream --

constexpr int kStreamWarps = 2;
constexpr int kStreamThreads = 32 * kStreamWarps;
constexpr int kCluster = 4;     // blocks splitting D
constexpr int kUnroll = 8;      // 16-byte load pairs in flight a thread
constexpr int kXChunk = 1024;   // columns of x staged at a time
constexpr int kStreamMaxRows = 16;

// 16 bytes of a weight row from p (columns n .. n + 16 / sizeof(T) - 1,
// `left` = F - n of them inside the row) as raw bits; zeros where masked.
template <typename T, bool VECTOR>
__device__ __forceinline__ uint4 load16(const T* p, bool ok, int left) {
  if (!ok || left <= 0) return make_uint4(0u, 0u, 0u, 0u);
  if constexpr (VECTOR) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 2) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < left) w[j / 2] |= (uint32_t)__ldg(q + j) << (16 * (j & 1));
  } else {
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < left) w[j] = __ldg(q + j);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the float32 values of 16 raw bytes of T
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

// Grid: (F tiles x R row groups x kCluster) blocks along x, clusters of
// kCluster consecutive blocks; block rank r of a cluster sums over
// D rows [r * kc, (r + 1) * kc).  MT rows of x per block.
template <typename T, int MT, bool VECTOR>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kStreamThreads)
fused_swiglu_stream_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                           const T* __restrict__ w3, T* __restrict__ out,
                           int M, int D, int F, int R, int kc, int xcols) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int BN = 8 * VEC;             // 128 bytes of a row
  constexpr int STEP = 4 * kStreamWarps;  // rows one load of the block covers
  constexpr int PART = MT * BN * 2;       // (w1, w3) partial sums of a block
  extern __shared__ float stream_smem[];
  float* xs = stream_smem;                         // [MT][xcols]
  float* red = xs + MT * xcols;                    // [kStreamWarps][PART]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / kCluster;
  const int n0 = (group / R) * BN, m0 = (group % R) * MT;
  const int k_lo = rank * kc, k_hi = min(D, k_lo + kc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = lane & 7, sub = lane >> 3;
  const int n = n0 + seg * VEC;
  const int left = F - n;

  float acc1[MT][VEC], acc3[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc1[m][j] = acc3[m][j] = 0.0f;

  for (int c0 = k_lo; c0 < k_hi; c0 += xcols) {
    const int len = min(xcols, k_hi - c0);
    __syncthreads();  // the last chunk's readers are done with xs
    for (int i = tid; i < MT * len; i += kStreamThreads) {
      const int m = i / len, kk = i - m * len;
      xs[m * xcols + kk] = m0 + m < M
          ? to_f32(x[(long long)(m0 + m) * D + c0 + kk]) : 0.0f;
    }
    __syncthreads();
    for (int base = warp * 4 + sub; base < len; base += STEP * kUnroll) {
      uint4 v1[kUnroll], v3[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = base + u * STEP;
        const long long off = (long long)(c0 + kk) * F + n;
        v1[u] = load16<T, VECTOR>(w1 + off, kk < len, left);
        v3[u] = load16<T, VECTOR>(w3 + off, kk < len, left);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = base + u * STEP;
        if (kk >= len) break;
        float b1[VEC], b3[VEC];
        unpack(v1[u], b1);
        unpack(v3[u], b3);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float a = xs[m * xcols + kk];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            acc1[m][j] = fmaf(a, b1[j], acc1[m][j]);
            acc3[m][j] = fmaf(a, b3[j], acc3[m][j]);
          }
        }
      }
    }
  }

  // the four lanes of a column group (sub = 0..3), then the warps
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float a = acc1[m][j], b = acc3[m][j];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      b += __shfl_xor_sync(0xffffffffu, b, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      b += __shfl_xor_sync(0xffffffffu, b, 16);
      if (sub == 0) {
        float* p = red + warp * PART + (m * BN + seg * VEC + j) * 2;
        p[0] = a;
        p[1] = b;
      }
    }
  __syncthreads();
  for (int e = tid; e < PART; e += kStreamThreads) {
    float s = red[e];
#pragma unroll
    for (int w = 1; w < kStreamWarps; ++w) s += red[w * PART + e];
    red[e] = s;
  }
  // the cluster's blocks sum each other's partials (distributed shared
  // memory); block `rank` gates and stores its quarter of the tile
  cluster.sync();
  constexpr int SHARE = (MT * BN + kCluster - 1) / kCluster;
  for (int i = tid; i < SHARE; i += kStreamThreads) {
    const int p = rank * SHARE + i;
    if (p >= MT * BN) break;
    const int m = p / BN, c = p - m * BN;
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float* q = cluster.map_shared_rank(red, r) + 2 * p;
      a += q[0];
      b += q[1];
    }
    if (m0 + m < M && n0 + c < F)
      out[(long long)(m0 + m) * F + n0 + c] = from_f32<T>(gate(a, b));
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <typename T, int MT, bool VECTOR>
int launch_stream_mt(const void* x, const void* w1, const void* w3, void* out,
                     int M, int D, int F, cudaStream_t s) {
  constexpr int BN = 8 * (16 / (int)sizeof(T));
  const int R = (M + MT - 1) / MT;
  const int kc = (D + kCluster - 1) / kCluster;
  const int xcols = kc < 1 ? 1 : (kc < kXChunk ? kc : kXChunk);
  // F < 2^31 and M <= 16 make at most 2^29 blocks
  const unsigned blocks = (unsigned)(((long long)F + BN - 1) / BN) * R *
                          kCluster;
  // at most 40 KB: inside the 48 KB a block gets without opting in
  static_assert(8 * kXChunk * 4 + kStreamWarps * 8 * 64 * 2 * 4 <= 48 * 1024,
                "stream route shared memory");
  const size_t bytes =
      (size_t)MT * xcols * 4 + (size_t)kStreamWarps * MT * BN * 2 * 4;
  fused_swiglu_stream_kernel<T, MT, VECTOR><<<blocks, kStreamThreads, bytes,
                                              s>>>(
      (const T*)x, (const T*)w1, (const T*)w3, (T*)out, M, D, F, R, kc,
      xcols);
  return (int)cudaGetLastError();
}

template <typename T, bool VECTOR>
int launch_stream_v(const void* x, const void* w1, const void* w3, void* out,
                    int M, int D, int F, cudaStream_t s) {
  if (M <= 1) return launch_stream_mt<T, 1, VECTOR>(x, w1, w3, out, M, D, F, s);
  if (M <= 2) return launch_stream_mt<T, 2, VECTOR>(x, w1, w3, out, M, D, F, s);
  if (M <= 4) return launch_stream_mt<T, 4, VECTOR>(x, w1, w3, out, M, D, F, s);
  return launch_stream_mt<T, 8, VECTOR>(x, w1, w3, out, M, D, F, s);
}

template <typename T>
int launch_stream(const void* x, const void* w1, const void* w3, void* out,
                  int M, int D, int F, cudaStream_t s) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool vector = F % VEC == 0 &&
      (((uintptr_t)w1 | (uintptr_t)w3) & 15) == 0;
  return vector ? launch_stream_v<T, true>(x, w1, w3, out, M, D, F, s)
                : launch_stream_v<T, false>(x, w1, w3, out, M, D, F, s);
}

// -------------------------------------------------------- tensor cores --

constexpr int kTcBM = 128;           // rows of x per block
constexpr int kTcBN = 128;           // columns of F per block (of each w)
constexpr int kTcBK = 64;            // D per stage: 128 bytes, one swizzle row
constexpr int kTcStages = 4;
constexpr int kTcThreads = 384;      // consumer warpgroups 0, 1; producer 2
constexpr uint32_t kTcABytes = kTcBM * kTcBK * 2;   // 16 KB
constexpr uint32_t kTcBoxBytes = kTcBK * 64 * 2;    // 8 KB: 64 rows x 64 cols
constexpr uint32_t kTcStageBytes = kTcABytes + 4 * kTcBoxBytes;  // 48 KB
constexpr size_t kTcSmem = kTcStages * kTcStageBytes + 2 * kTcStages * 8 +
                           1024;  // stages, mbarriers, alignment slack

// d (64 x 256 float32 per warpgroup) += A (64 x 16, K-major) * B (16 x 256,
// MN-major)
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kTcThreads, 1)
fused_swiglu_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w3,
                       __nv_bfloat16* __restrict__ out, int M, int D, int F) {
  // stages at a 1024-byte boundary (the 128-byte swizzle's period)
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t base = (smem_addr(tc_smem) + 1023u) & ~1023u;
  const uint32_t full = base + kTcStages * kTcStageBytes;  // mbarriers
  const uint32_t empty = full + kTcStages * 8;
  const int m0 = blockIdx.x * kTcBM, n0 = blockIdx.y * kTcBN;
  const int ktiles = (D + kTcBK - 1) / kTcBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx + the bytes
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps up to kTcStages stages of TMA loads in
    // flight; the other three warps leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kTcStages;
        const uint32_t round = (uint32_t)(kt / kTcStages) & 1u;
        mbar_wait(empty + 8 * s, round ^ 1u);
        const uint32_t a = base + s * kTcStageBytes, b = a + kTcABytes;
        const uint32_t bar = full + 8 * s;
        const int k0 = kt * kTcBK;
        mbar_expect_tx(bar, kTcStageBytes);
        tma_load(a, &map_x, bar, k0, m0);
        tma_load(b, &map_w1, bar, n0, k0);
        tma_load(b + kTcBoxBytes, &map_w1, bar, n0 + 64, k0);
        tma_load(b + 2 * kTcBoxBytes, &map_w3, bar, n0, k0);
        tma_load(b + 3 * kTcBoxBytes, &map_w3, bar, n0 + 64, k0);
      }
    }
  } else {
    // consumer warpgroup wg: rows m0 + 64 wg .. + 63, all 256 B columns
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kTcStages;
      mbar_wait(full + 8 * s, (uint32_t)(kt / kTcStages) & 1u);
      const uint32_t a = base + s * kTcStageBytes + wg * 64 * 128;
      const uint32_t b = base + s * kTcStageBytes + kTcABytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
        // A: +32 bytes per 16 columns inside the swizzled 128-byte rows,
        // 8-row groups 1024 bytes apart.  B: +16 rows of 128 bytes; 8-row
        // groups 1024 bytes apart, 64-column boxes kTcBoxBytes apart.
        wgmma_256(acc, wgmma_desc(a + 32 * kk, 16, 1024),
                  wgmma_desc(b + 2048 * kk, kTcBoxBytes, 1024));
      wgmma_commit();
      // the group before this one is done: free its stage
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty + 8 * ((kt - 1) % kTcStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // accumulator layout of m64nNk16: warp w of the group holds rows
    // 16 w + lane / 4 (+ 8); register 4 i + {0, 1} (+ {2, 3} for the row
    // + 8) holds columns 8 i + 2 (lane % 4) + {0, 1}.  Columns 0..127 are
    // w1's, 128..255 w3's: the same output column 64 registers on.
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = m0 + wg * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = n0 + 8 * i + 2 * (lane % 4);
      if (col >= F) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (m >= M) continue;
        const int r = 4 * i + 2 * h;
        __nv_bfloat162 v;
        v.x = __float2bfloat16(gate(acc[r], acc[r + 64]));
        v.y = __float2bfloat16(gate(acc[r + 1], acc[r + 65]));
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * F + col) = v;
      }
    }
  }
}

int launch_tc(const void* x, const void* w1, const void* w3, void* out, int M,
              int D, int F, cudaStream_t s) {
  CUtensorMap mx, m1, m3;
  if (!tensor_map(&mx, x, M, D, kTcBM) || !tensor_map(&m1, w1, D, F, 64) ||
      !tensor_map(&m3, w3, D, F, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fused_swiglu_tc_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kTcBM - 1) / kTcBM, (F + kTcBN - 1) / kTcBN);
  fused_swiglu_tc_kernel<<<grid, kTcThreads, kTcSmem, s>>>(
      mx, m1, m3, (__nv_bfloat16*)out, M, D, F);
  return (int)cudaGetLastError();
}

// Whether route `route` takes this call (see the note at the top).
bool route_fits(int route, int M, int D, int F, int dtype, const void* x,
                const void* w1, const void* w3, const void* out) {
  switch (route) {
    case 0:
      return M <= kStreamMaxRows;
    case 1:
      return dtype == 1 && D > 0 && D % 8 == 0 && F % 8 == 0 &&
             (F + kTcBN - 1) / kTcBN <= 65535 &&
             (((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w3 |
               (uintptr_t)out) & 15) == 0;
    case 2:
      return true;
    default:
      return false;
  }
}

// ------------------------------------------------------- gate backward --

__device__ __forceinline__ void gate_bwd(float a, float b, float g, float* da,
                                         float* db) {
  const float s = 1.0f / (1.0f + expf(-a));
  *da = g * b * (s * (1.0f + a * (1.0f - s)));
  *db = g * (a * s);
}

// VEC elements a step: a 16-byte vector (VEC = 16 / sizeof(T)) or one
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
swiglu_gate_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ dh, T* __restrict__ da,
                       T* __restrict__ db, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x * VEC;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
       i < n; i += stride) {
    if (VEC > 1 && i + VEC <= n) {
      const uint4 va = *reinterpret_cast<const uint4*>(a + i);
      const uint4 vb = *reinterpret_cast<const uint4*>(b + i);
      const uint4 vg = *reinterpret_cast<const uint4*>(dh + i);
      uint4 oa, ob;
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
      const T* eg = reinterpret_cast<const T*>(&vg);
      T* pa = reinterpret_cast<T*>(&oa);
      T* pb = reinterpret_cast<T*>(&ob);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float x, y;
        gate_bwd(to_f32(ea[e]), to_f32(eb[e]), to_f32(eg[e]), &x, &y);
        pa[e] = from_f32<T>(x);
        pb[e] = from_f32<T>(y);
      }
      *reinterpret_cast<uint4*>(da + i) = oa;
      *reinterpret_cast<uint4*>(db + i) = ob;
    } else {
      for (long long j = i; j < i + VEC && j < n; ++j) {
        float x, y;
        gate_bwd(to_f32(a[j]), to_f32(b[j]), to_f32(dh[j]), &x, &y);
        da[j] = from_f32<T>(x);
        db[j] = from_f32<T>(y);
      }
    }
  }
}

template <typename T>
int launch_gate_bwd(const void* a, const void* b, const void* dh, void* da,
                    void* db, long long n, cudaStream_t s) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const bool vec = (((uintptr_t)a | (uintptr_t)b | (uintptr_t)dh |
                     (uintptr_t)da | (uintptr_t)db) & 15) == 0;
  const int per = vec ? kVec : 1;
  long long blocks = (n + 256LL * per - 1) / (256LL * per);
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks an SM, then stride
  if (vec)
    swiglu_gate_bwd_kernel<T, kVec><<<(unsigned)blocks, 256, 0, s>>>(
        (const T*)a, (const T*)b, (const T*)dh, (T*)da, (T*)db, n);
  else
    swiglu_gate_bwd_kernel<T, 1><<<(unsigned)blocks, 256, 0, s>>>(
        (const T*)a, (const T*)b, (const T*)dh, (T*)da, (T*)db, n);
  return (int)cudaGetLastError();
}

}  // namespace

// The gate's backward over n elements of a, b, dh into da, db (see the note
// at the top).  Launches on `stream` with `device` current; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a dtype
// code other than 0 or 1.
extern "C" int swiglu_gate_bwd_launch(const void* a, const void* b,
                                      const void* dh, void* da, void* db,
                                      long long n, int dtype, int device,
                                      void* stream) {
  if (n <= 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    return dtype == 0
               ? launch_gate_bwd<float>(a, b, dh, da, db, n, s)
               : launch_gate_bwd<__nv_bfloat16>(a, b, dh, da, db, n, s);
  });
}

// Launches route `route` on `stream` with `device` current; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a dtype
// code other than 0 or 1, or a route this call cannot take.
extern "C" int fused_swiglu_launch(const void* x, const void* w1,
                                   const void* w3, void* out, int M, int D,
                                   int F, int dtype, int route, int device,
                                   void* stream) {
  if (M <= 0 || F <= 0) return 0;
  if ((dtype != 0 && dtype != 1) ||
      !route_fits(route, M, D, F, dtype, x, w1, w3, out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    if (route == 1) return launch_tc(x, w1, w3, out, M, D, F, s);
    if (route == 0)
      return dtype == 0
                 ? launch_stream<float>(x, w1, w3, out, M, D, F, s)
                 : launch_stream<__nv_bfloat16>(x, w1, w3, out, M, D, F, s);
    return dtype == 0
               ? launch_simt<float>(x, w1, w3, out, M, D, F, s)
               : launch_simt<__nv_bfloat16>(x, w1, w3, out, M, D, F, s);
  });
}

extern "C" const char* fused_swiglu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
