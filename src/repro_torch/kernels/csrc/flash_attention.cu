// Causal / sliding-window flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel): q (H, S, d), k and v (H / kv_group, S, d),
// out (H, S, d), row-major.  Query head h reads kv head h / kv_group, so
// grouped-query attention needs no repeated k/v; kv_group = 1 is the TPU
// kernel's function.  Scores are (q . k) / sqrt(d) in float32; masked ones
// (k > q when causal, q - k >= window when a window is set) are -1e30; the
// softmax runs online over key tiles (64 keys in float32, 32 in bfloat16)
// carrying (m, l, acc), a tile wholly outside the causal band or the window
// is skipped with the TPU kernel's own test, and the output is
// acc / max(l, 1e-30), cast to the input type.
// The result does not depend on the tile sizes.  The plain version is
// repro_torch.kernels.ref.flash_attention.
//
// Bound: bytes for short sequences.  At (96, 500, 128) bf16, causal, with
// kv_group 3, the inputs and output are 32.8 MB (9.8 us over 3.35 TB/s)
// against 6.2 GFLOP of live (q, k) pairs (6.3 us at the 989 TFLOP/s bf16
// tensor-core peak); at stablelm_12b's (128, 500, 160) with kv_group 4,
// 51.2 MB (15.3 us) against 10.3 GFLOP (10.4 us).  Head dims run up to 256.
//
// Two paths, chosen by dtype:
//
// * bfloat16: tensor cores.  One block of 4 warps per (head, 64-row q
//   tile); each warp owns 16 query rows.  The head dim is padded in shared
//   memory to DP in {32, 64, 128, 160, 256} with zero columns (scores and
//   outputs unchanged; columns >= d are never stored), and every row is
//   padded by 16 bytes so ldmatrix reads are free of bank conflicts.  The
//   q tile is copied once with 16-byte cp.async; k and v run in 32-key
//   tiles through two stages of cp.async, so tile j + 1 loads while tile j
//   computes.
//   S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products
//   accumulating in float32 (q and k fragments from ldmatrix, v from
//   ldmatrix.trans); the mask and the online softmax stay in registers (a
//   thread holds 2 of its warp's 16 rows, reduced over the 4-thread quad
//   with shuffles), and P turns into bf16 A fragments straight from the
//   score registers.  P is rounded to bf16 before P V (l sums the float32
//   p).  The q fragments are read again from shared memory for each k tile
//   rather than held, so the kernel fits 128 registers and 4 blocks (16
//   warps, 52 KB of shared memory each at DP = 128) share an SM: at these
//   short sequences the kernel is bound by latency, and more warps in
//   flight beat fewer, wider ones.  Above DP = 128 the output fragments
//   alone are DP / 2 floats a thread (128 at DP = 256), so the kernel asks
//   for 2 blocks per SM and up to 255 registers (99 KB of shared memory a
//   block at DP = 256).  Rows past S load as zeros and their scores as
//   -inf.  The q tiles with the most live k tiles are issued
//   first (the causal tail).  The output tile is staged in the q tile's
//   shared memory and stored with 16-byte writes.
// * float32: the SIMT kernel, no tensor cores (they would round float32
//   operands to TF32, about 3 decimal digits).  One block of 256 threads
//   per (head, 64-row q tile); q (transposed), k (transposed), v and the
//   probabilities live in dynamic shared memory as float32 (about 113 KB
//   at d = 128, 210 KB at d = 256); each thread owns 4 query rows x 4 key
//   columns of a score tile and 4 rows x DJ columns of the output (DJ = 8
//   up to d = 128, 16 up to d = 256: the kernel is instantiated for both,
//   so a short head keeps its registers), with columns interleaved
//   by 16 so shared-memory reads do not collide; a row's 16 threads sit in
//   one half-warp, so its max and sum reduce with shuffles.
//
// Both paths raise the block's dynamic shared-memory limit above the 48 KB
// default before the launch.  dtype code: 0 = float32, 1 = bfloat16 (q, k,
// v and out share it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int DMAX = 256;    // largest head dim
constexpr int kThreads = 256;
constexpr int RI = BQ / 16;  // rows per thread
constexpr int CJ = BK / 16;  // score columns per thread
constexpr float NEG = -1e30f;

// the SIMT kernel is instantiated for float32 only
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)d * (BQ + 1) + (size_t)d * (BK + 1) + (size_t)BK * d +
          (size_t)BQ * (BK + 1));
}

// DJ: output columns per thread, d <= 16 DJ
template <typename T, int DJ>
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

// ---- bfloat16 on tensor cores ----

constexpr int kTcWarps = 4;              // each owns 16 query rows
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;      // query rows per block
constexpr int kTcBK = 32;                 // keys per tile
// blocks per SM: 4 (<= 128 registers) up to DP = 128, else 2 (<= 255)
constexpr int tc_min_blocks(int dp) { return dp <= 128 ? 4 : 2; }
constexpr int kPad = 8;  // bf16 of padding per shared row: 16 bytes

// the q tile and two stages of k and of v, rows of DP + kPad bf16
constexpr size_t tc_smem_bytes(int dp) {
  return (size_t)(kTcBQ + 4 * kTcBK) * (dp + kPad) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) of a row-major (S, d) matrix into a ROWS x
// (DP + kPad) shared tile, 16 bytes (8 columns) per step: cp.async where
// `vec` (d a multiple of 8, 16-byte aligned pointers), element by element
// otherwise, zeros past d and past S.  Every chunk of the tile is written.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* g, int r0,
                                          int S, int d, bool vec) {
  constexpr int CH = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kTcThreads) {
    const int r = idx / CH, c = (idx % CH) * 8;
    __nv_bfloat16* dst = tile + r * (DP + kPad) + c;
    const long long src = (long long)(r0 + r) * d + c;
    if (r0 + r < S && vec && c < d) {
      cp_async16(dst, g + src);
    } else if (r0 + r < S && c < d) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = c + e < d ? g[src + e] : __float2bfloat16(0.0f);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(DP))
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, int S, int d,
                          int causal, int window, int kv_group, float scale,
                          int vec) {
  constexpr int LD = DP + kPad;  // shared row stride, in bf16
  constexpr int KD = DP / 16;    // 16-wide steps over the head dim
  constexpr int BQ = kTcBQ, BK = kTcBK;
  constexpr int NB = BK / 8;     // 8-key column blocks of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + BQ * LD;      // [2][BK][LD]
  __nv_bfloat16* sv = sk + 2 * BK * LD;  // [2][BK][LD]

  const int h = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;  // fragment row, quad thread
  const __nv_bfloat16* qh = q + (long long)h * S * d;
  const __nv_bfloat16* kh = k + (long long)(h / kv_group) * S * d;
  const __nv_bfloat16* vh = v + (long long)(h / kv_group) * S * d;
  // this lane's ldmatrix row of the warp's 16 q rows
  const __nv_bfloat16* qrow = sq + (warp * 16 + lane % 16) * LD +
                              (lane / 16) * 8;

  // the live k tiles [k_lo, k_hi): the SIMT kernel's break / continue
  const int n_k = (S + BK - 1) / BK;
  const int k_hi = causal ? min(n_k, (q0 + BQ - 1) / BK + 1) : n_k;
  int k_lo = 0;
  if (window)
    while (k_lo < k_hi && !(q0 < k_lo * BK + BK + window)) ++k_lo;

  // the q tile and the first live k/v tile
  load_tile<DP, BQ>(sq, qh, q0, S, d, vec);
  if (k_lo < k_hi) {
    load_tile<DP, BK>(sk, kh, k_lo * BK, S, d, vec);
    load_tile<DP, BK>(sv, vh, k_lo * BK, S, d, vec);
  }
  cp_async_commit();

  // rows (gr, gr + 8) of the warp's 16: running max, sum and output
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

  for (int ki = k_lo; ki < k_hi; ++ki) {
    const int st = (ki - k_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile ki landed; every warp is done with tile ki - 1
    if (ki + 1 < k_hi) {  // into the stage tile ki - 1 left
      load_tile<DP, BK>(sk + (st ^ 1) * BK * LD, kh, (ki + 1) * BK, S, d, vec);
      load_tile<DP, BK>(sv + (st ^ 1) * BK * LD, vh, (ki + 1) * BK, S, d, vec);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = sk + st * BK * LD;
    const __nv_bfloat16* vt = sv + st * BK * LD;

    // S = Q K^T: s[nb] is rows (gr, gr + 8) x keys nb * 8 + 2 tq + (0, 1);
    // the q fragments are read again from shared memory for every tile,
    // which keeps the kernel within 128 registers
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qf[4];
      ldmatrix_x4(qf, qrow + kd * 16);
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (nb2 * 16 + lane % 8 + (lane / 16) * 8) * LD +
                           kd * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * nb2], qf, b[0], b[1]);
        mma_bf16(s[2 * nb2 + 1], qf, b[2], b[3]);
      }
    }

    // mask and online softmax, one row at a time
    const int k0 = ki * BK;
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window && q0 + BQ - 1 - k0 >= window) || k0 + BK > S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = q0 + warp * 16 + gr + 8 * r;
      float mx = NEG;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[nb][2 * r + c] * scale;
          if (edge) {
            const int kp = k0 + nb * 8 + 2 * tq + c;
            if ((causal && qp < kp) || (window && qp - kp >= window)) x = NEG;
            if (kp >= S) x = -INFINITY;  // past the sequence: no weight
          }
          s[nb][2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.0f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[nb][2 * r + c] - m_new);
          s[nb][2 * r + c] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + rs;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the score registers of keys 16 kk .. 16 kk + 15 are the A
    // fragment; v comes transposed out of ldmatrix
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd2 = 0; nd2 < KD; ++nd2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                      LD +
                                  nd2 * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * nd2], pa, b[0], b[1]);
        mma_bf16(o[2 * nd2 + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every copy into the q tile has landed (no live tile)

  // the warp's 16 output rows into its own rows of the q tile, then out
  __nv_bfloat16* so = sq + warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<uint32_t*>(so + (gr + 8 * r) * LD + j * 8 + 2 * tq) =
          pack_bf16(o[j][2 * r] / den, o[j][2 * r + 1] / den);
  }
  __syncwarp();
  const int row0 = q0 + warp * 16;
  __nv_bfloat16* oh = out + (long long)h * S * d;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int r = idx / CH, c = (idx % CH) * 8;
      if (row0 + r < S && c < d)
        *reinterpret_cast<uint4*>(oh + (long long)(row0 + r) * d + c) =
            *reinterpret_cast<const uint4*>(so + r * LD + c);
    }
  } else {
    for (int idx = lane; idx < 16 * d; idx += 32) {
      const int r = idx / d, c = idx % d;
      if (row0 + r < S) oh[(long long)(row0 + r) * d + c] = so[r * LD + c];
    }
  }
}

template <typename T, int DJ>
int launch_simt(const void* q, const void* k, const void* v, void* out, int H,
                int S, int d, int causal, int window, int kv_group,
                float scale, cudaStream_t s) {
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)flash_attention_kernel<T, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, DJ><<<grid, kThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, d, causal, window,
      kv_group, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out, int H,
              int S, int d, int causal, int window, int kv_group, float scale,
              cudaStream_t s) {
  constexpr size_t bytes = tc_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)flash_attention_tc_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)out) % 16 == 0;
  const dim3 grid(H, (S + kTcBQ - 1) / kTcBQ);
  flash_attention_tc_kernel<DP><<<grid, kTcThreads, bytes, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, d, causal, window,
      kv_group, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` with `device` current; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a dtype code other than 0 or 1,
// d outside [1, 256], a kv_group that does not divide H, or a grid the card
// cannot take.  float32 runs the SIMT kernel (8 or 16 output columns a
// thread), bfloat16 the tensor-core kernel with the head dim padded to 32,
// 64, 128, 160 or 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int H, int S,
                                      int d, int causal, int window,
                                      int kv_group, float scale, int dtype,
                                      int device, void* stream) {
  if (H <= 0 || S <= 0) return 0;
  if (d < 1 || d > DMAX || kv_group < 1 || H % kv_group != 0 ||
      (S + BQ - 1) / BQ > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    if (dtype == 0)
      return d <= 128 ? launch_simt<float, 8>(q, k, v, out, H, S, d, causal,
                                              window, kv_group, scale, s)
                      : launch_simt<float, 16>(q, k, v, out, H, S, d, causal,
                                               window, kv_group, scale, s);
    if (d <= 32)
      return launch_tc<32>(q, k, v, out, H, S, d, causal, window, kv_group,
                           scale, s);
    if (d <= 64)
      return launch_tc<64>(q, k, v, out, H, S, d, causal, window, kv_group,
                           scale, s);
    if (d <= 128)
      return launch_tc<128>(q, k, v, out, H, S, d, causal, window, kv_group,
                            scale, s);
    if (d <= 160)
      return launch_tc<160>(q, k, v, out, H, S, d, causal, window, kv_group,
                            scale, s);
    return launch_tc<256>(q, k, v, out, H, S, d, causal, window, kv_group,
                          scale, s);
  });
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
