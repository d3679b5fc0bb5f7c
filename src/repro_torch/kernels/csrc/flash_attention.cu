// Causal / sliding-window flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel): q (H, S, d), k and v (H / kv_group, S, d),
// out (H, S, d), row-major.  Query head h reads kv head h / kv_group, so
// grouped-query attention needs no repeated k/v; kv_group = 1 is the TPU
// kernel's function.  Scores are (q . k) / sqrt(d) in float32; masked ones
// (k > q when causal, q - k >= window when a window is set) are -1e30; the
// softmax runs online over key tiles (64 keys in float32 and on wgmma, 32
// on mma.sync) carrying (m, l, acc), a tile wholly outside the causal band
// or the window is skipped with the TPU kernel's own test, and the output
// is acc / max(l, 1e-30), cast to the input type.
// The result does not depend on the tile sizes.  The plain version is
// repro_torch.kernels.ref.flash_attention.
//
// Bound: bytes for short sequences.  At (96, 500, 128) bf16, causal, with
// kv_group 3, the inputs and output are 32.8 MB (9.8 us over 3.35 TB/s)
// against 6.2 GFLOP of live (q, k) pairs (6.3 us at the 989 TFLOP/s bf16
// tensor-core peak); at stablelm_12b's (128, 500, 160) with kv_group 4,
// 51.2 MB (15.3 us) against 10.3 GFLOP (10.4 us).  Operations at training
// lengths: at (96, 4096, 128) the two products are 412 GFLOP (0.417 ms);
// the training form's P V runs twice (P and its remainder), so its design
// cannot go below 3 products, 0.625 ms.  Head dims run up to 256.
//
// Three routes, picked by the caller from the dtype, the head dim and the
// operands' 16-byte alignment (repro_torch/kernels/flash_attention.py::
// fwd_route; a route the call cannot take is refused with
// cudaErrorInvalidValue, never replaced by another):
//
// 0. wgmma + TMA: bfloat16 with d % 8 == 0 up to 160, q, k, v and out on
//    16-byte boundaries (flash_fwd_wgmma_kernel<DP, TRAIN>, "forward on
//    wgmma + TMA" below), instantiated at DP 64, 128 and 160, the next at
//    or above d.  What it does about each difficulty:
//    * Blocks of 128 queries in two warpgroups of 64, 256 threads; thread
//      0 issues the TMA loads (no producer warp: the backward's first
//      build with one was sized for 384 threads, spilled and lost).
//    * Ragged S and head boundaries: q, k, v are read through 3-D tensor
//      maps (d, S, heads) in 64 x 64 boxes under the 128-byte swizzle, so
//      a tile at a head's tail reads zeros, not the next head's rows, and
//      a head dim below DP (danube's 120 at DP 128) reads zero columns
//      up to DP, which add nothing to S or O; the
//      kv head is h / kv_group in the map's coordinate; keys past S take
//      -inf, the rest of the mask is the mma.sync kernel's (NEG), and
//      tiles wholly inside the band and the window skip it.
//    * K and V in 64-key tiles through 4 stages (the training form at d
//      128: 128-key tiles through 3, which its longer products pay for;
//      shorter sequences and d 64 lose with them), each completing on an
//      mbarrier and refilled once both warpgroups have released it.
//    * S = Q K^T as an SS wgmma (K-major); the accumulator's registers
//      8 kk .. 8 kk + 7 are the A fragment of k-step kk, so P goes into
//      bf16 fragments of the RS wgmma O += P V (V MN-major through the
//      descriptor's transpose bit) without shared memory.
//    * The softmax counts in base 2 (exp2f of the scores scaled by
//      log2(e), the scale folded into one FMA on unmasked tiles): expf's
//      longer sequence kept the warps from the tensor cores.
//    * Overlap: tile j's S product is issued before tile j - 1's P V, and
//      tile j's softmax runs while P V is on the tensor cores; the output
//      is rescaled once P V is done.
//    * The output is staged in the warpgroup's q tile under the box's
//      swizzle and stored by TMA, which clips rows past S and columns past
//      d.
//    * d 160 (stablelm_12b): a row is three 64-column slabs at the
//      128-byte swizzle, the third holding columns 128..159 and 32 zeros
//      from the map.  Chosen over a 32-column slab at the 64-byte swizzle:
//      one tensor map, one descriptor form and one set of box loops serve
//      every DP, and no product pays for the zeros: Q K^T steps over 160
//      columns (10 k16 steps, each 32 bytes of a 128-byte row), P V runs
//      m64n160 with V's third slab read for its first 32 columns.  The
//      cost is shared memory: 24 KB a 64-row tile where 20 would do, so 3
//      K/V stages in place of 4.  O is 80 floats a thread, one block an
//      SM, as at DP 128.
//    * No atomics: the same bits on every run.
// 1. mma.sync: bfloat16 head dims the wgmma route does not take (d % 8 !=
//    0, d past 160) and misaligned bfloat16 views
//    (flash_attention_tc_kernel<DP, TRAIN>).  One block of 4 warps per
//    (head, 64-row q tile); each warp owns 16 query rows.  The head dim is
//    padded in shared memory to DP in {32, 64, 128, 160, 256} with zero
//    columns (scores and outputs unchanged; columns >= d are never
//    stored), and every row is padded by 16 bytes so ldmatrix reads are
//    free of bank conflicts.  The q tile is copied once with 16-byte
//    cp.async; k and v run in 32-key tiles through two stages of
//    cp.async, so tile j + 1 loads while tile j computes.  S = Q K^T and
//    O += P V are mma.sync.m16n8k16 bf16 products accumulating in float32
//    (q and k fragments from ldmatrix, v from ldmatrix.trans); the mask
//    and the online softmax stay in registers (a thread holds 2 of its
//    warp's 16 rows, reduced over the 4-thread quad with shuffles), and P
//    turns into bf16 A fragments straight from the score registers.  P is
//    rounded to bf16 before P V (l sums the float32 p).  The q fragments
//    are read again from shared memory for each k tile rather than held,
//    so the kernel fits 128 registers and 4 blocks (16 warps, 52 KB of
//    shared memory each at DP = 128) share an SM.  Above DP = 128 the
//    output fragments alone are DP / 2 floats a thread (128 at DP = 256),
//    so the kernel asks for 2 blocks per SM and up to 255 registers (99
//    KB of shared memory a block at DP = 256).  Rows past S load as zeros
//    and their scores as -inf.  The q tiles with the most live k tiles
//    are issued first (the causal tail).  The output tile is staged in
//    the q tile's shared memory and stored with 16-byte writes.
// 2. SIMT: float32 (flash_attention_kernel<float, DJ>), no tensor cores
//   (they would round float32 operands to TF32, about 3 decimal digits).
//   One block of 256 threads per (head, 64-row q tile); q (transposed),
//   k (transposed), v and the probabilities live in dynamic shared memory
//   as float32 (about 113 KB at d = 128, 210 KB at d = 256); each thread
//   owns 4 query rows x 4 key columns of a score tile and 4 rows x DJ
//   columns of the output (DJ = 8 up to d = 128, 16 up to d = 256: the
//   kernel is instantiated for both, so a short head keeps its
//   registers), with columns interleaved by 16 so shared-memory reads do
//   not collide; a row's 16 threads sit in one half-warp, so its max and
//   sum reduce with shuffles.
//
// Every route raises the block's dynamic shared-memory limit above the 48
// KB default before the launch.  dtype code: 0 = float32, 1 = bfloat16
// (q, k, v and out share it).  Where the caller passes an `lse` buffer
// (float32, H x S; training), every route also writes each row's
// log-sum-exp of its scaled, masked scores, m + log(max(l, 1e-30));
// serving passes null.
//
// Backward (flash_attention_bwd_launch), which the TPU kernel never had
// (the JAX models differentiate an inline blockwise attention with XLA,
// repro/models/layers.py:155).  From q, k, v, the output o in float32
// (the training forward keeps it: P V in bf16 rounds P, so the training
// instantiation adds the product of P's bf16 remainder, and delta is taken
// from o before its cast), its gradient dO and lse: P = exp(s * scale -
// lse) on the live pairs (0 elsewhere), delta = rowsum(dO * o),
// dS = P * (dO v^T - delta), and
//   dq = scale * dS k,   dk = scale * dS^T q,   dv = P^T dO,
// summed over a kv head's kv_group query heads for dk and dv.  Three
// kernels, no atomics, so every run gives the same bits: delta, one warp a
// row; dk/dv, one block per (kv head, key tile) holding that tile's k and
// v and its dk and dv accumulators, looping over its query heads and the
// query tiles that meet the tile (the forward's causal / window test);
// dq, one block per (query head, query tile) looping over the key tiles
// it meets, causal tails first.  Each recomputes S and dO v^T for its tile
// pair.  Bound: operations at training shapes: at (96, 4096, 128) causal
// the five products over the live pairs are 1.03 TFLOP (1.04 ms at the
// bf16 tensor-core peak) against 0.25 GB of inputs and outputs.  The
// products of P and dS run twice in bf16 (the value and its remainder,
// see "backward on mma.sync" below), so the tensor-core designs do 10
// products where the function needs 5: their own floor is 2.08 ms there.
// Head dims up to 256.
//
// Three routes, picked by the caller from the dtype, the head dim and the
// operands' 16-byte alignment (repro_torch/kernels/flash_attention.py::
// bwd_route; a route the call cannot take is refused with
// cudaErrorInvalidValue, never replaced by another):
//
// 0. wgmma + TMA: bf16 with d % 8 == 0 up to 160, q, k, v, dout and the
//    gradients on 16-byte boundaries ("backward on wgmma + TMA" below), at
//    DP 64, 128 and 160 as the forward (head dims below DP read zero
//    columns from the tensor maps; dq, dk and dv are stored d wide).
//    Design and what it does about each difficulty:
//    * Blocks of 128 rows in two warpgroups of 64, 256 threads, and no
//      producer warp.  dk/dv holds 64 + 64 accumulators and the 32 + 32
//      of S^T and dP^T a thread.  A first build of this kernel with a
//      producer warpgroup and setmaxnreg (232 for the consumers) was
//      compiled to 168 registers a thread, the share of a 384-thread
//      block, spilled and had its wgmma serialized by ptxas, slower than
//      mma.sync; why setmaxnreg did not lift the consumers' allocation
//      there is not known.  At 256 threads ptxas takes up to 255 and
//      spills nothing.  Thread 0 issues the loads, refilling a stage one
//      tile after its use.
//    * Skipped tiles: a warpgroup releases every tile of the block's run
//      in order, computed or not, through its thread 0 alone, which waits
//      for the tile to land and arrives on the stage's `empty` barrier
//      (release_stage, shared with the forward); the threads that compute
//      a tile wait for it just before its products (stage_landed).  A
//      warpgroup skips the leading query tiles of each head's run in
//      causal dk/dv and the leading key tiles in windowed dq.  Both loops
//      walk every tile of the run and release it at the end (dk/dv
//      skipping by `continue`): a dq loop over its computed tiles between
//      release loops, and a dk/dv wait nested in its compute branch, were
//      each slower on the card with the same registers.
//    * Ragged S and head boundaries: q, k, v and dO are read through 3-D
//      tensor maps (d, S, heads) in 64 x 64 boxes, so a tile at a head's
//      ragged tail reads zeros, not the next head's rows; the live() mask
//      stays on P (zeros in K give S = 0, not -inf).  Tiles wholly inside
//      the causal band and the window skip the mask (tile_live).
//    * Swizzle: a 128-wide bf16 row is two 64-column boxes under the
//      128-byte swizzle; K-major operands step 32 bytes a k16 inside a
//      box and a box (8 KB) every 4 steps, MN-major ones 2048 bytes (16
//      rows) a step with the leading byte offset one box, the next 64
//      columns.
//    * Accumulator to A operand: the m64nNk16 accumulator's registers 8 kk
//      .. 8 kk + 7 are exactly the m16n8k16 A fragment of k-step kk, so P
//      and dS pack pairwise into bf16x2 (value, then remainder) as
//      mma_split packs them; the packed registers are fenced until the
//      products reading them are done.
//    * lse and delta: each warpgroup's threads load one row each a tile
//      ahead and share them through a double buffer behind one named
//      barrier a tile; dq keeps its two rows' in registers.
//    * dq overlaps the next tile's S and dP with this tile's dS.
//    * DP 160 (flash_bwd_dkdv_split_wgmma_kernel): a warpgroup holding
//      dK and dV for its 64 keys would need 160 accumulator floats beside
//      S^T and dP^T (64), past the 255 registers the d-128 build already
//      nearly fills.  So the block's two warpgroups share one 64-key
//      tile: warpgroup 0 forms S^T and P^T and accumulates dV, warpgroup
//      1 forms S^T, dP^T and dS^T and accumulates dK, each one 80-float
//      accumulator.  S^T is formed twice: 7 products a tile pair where
//      the d-128 partition does 6, 11 in the whole backward with dq's 4
//      where the function needs 5 (the design floor).  Splitting dK's and
//      dV's columns between the warpgroups instead would form S^T and
//      dP^T twice each, 8 products.  dq keeps its structure (80 + 32 + 32
//      floats) with 2 K/V stages, which is what 227 KB hold beside its
//      128 rows of Q and dO at 24 KB a tile.
// 1. mma.sync: bf16 up to d 160 that the wgmma route does not take (d %
//    8 != 0, misaligned views; "backward on mma.sync" below).
// 2. SIMT: float32, and bf16 past d 160: float32 from bf16 or float32
//    loads, all tiles in shared memory as float32 with rows padded to
//    16 DJ + 1 floats; a thread owns 4 query rows x RI keys of a score
//    tile and RI (dk/dv) or 4 (dq) rows x DJ columns of an accumulator
//    (DJ = 4, 8, 16 for d <= 64, 128, 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "hopper.cuh"

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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int S, int d, int causal,
                       int window, int kv_group, float scale) {
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
    if (lse != nullptr && tx == 0) lse[(long long)h * S + qp] = m[i] + logf(den);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
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
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// what rounding (lo, hi) to the bf16 pair `rounded` left out, as a bf16 pair
__device__ __forceinline__ uint32_t pack_rem(float lo, float hi,
                                             uint32_t rounded) {
  const float2 r =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rounded));
  return pack_bf16(lo - r.x, hi - r.y);
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

// TRAIN (the training forward, lse and out32 not null): P V runs as two
// products, P rounded to bf16 and its remainder p - bf16(p) also in bf16,
// so P carries about 16 bits into the float32 sum; each row's lse and the
// float32 output (out32) are written beside the bf16 one.  Serving's
// instantiation (TRAIN false) is the kernel as it was.
template <int DP, bool TRAIN>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(DP))
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, float* __restrict__ out32,
                          int S, int d, int causal, int window, int kv_group,
                          float scale, int vec) {
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
      uint32_t pr[4];
      if constexpr (TRAIN) {
        pr[0] = pack_rem(s[2 * kk][0], s[2 * kk][1], pa[0]);
        pr[1] = pack_rem(s[2 * kk][2], s[2 * kk][3], pa[1]);
        pr[2] = pack_rem(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2]);
        pr[3] = pack_rem(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3]);
      }
#pragma unroll
      for (int nd2 = 0; nd2 < KD; ++nd2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                      LD +
                                  nd2 * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * nd2], pa, b[0], b[1]);
        mma_bf16(o[2 * nd2 + 1], pa, b[2], b[3]);
        if constexpr (TRAIN) {
          mma_bf16(o[2 * nd2], pr, b[0], b[1]);
          mma_bf16(o[2 * nd2 + 1], pr, b[2], b[3]);
        }
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
    const int qp = q0 + warp * 16 + gr + 8 * r;
    if constexpr (TRAIN) {
      if (qp < S) {
        if (tq == 0) lse[(long long)h * S + qp] = m[r] + logf(den);
        float* orow = out32 + ((long long)h * S + qp) * d;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int c = j * 8 + 2 * tq;
          if (c < d) orow[c] = o[j][2 * r] / den;
          if (c + 1 < d) orow[c + 1] = o[j][2 * r + 1] / den;
        }
      }
    }
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
int launch_simt(const void* q, const void* k, const void* v, void* out,
                void* lse, int H, int S, int d, int causal, int window,
                int kv_group, float scale, cudaStream_t s) {
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)flash_attention_kernel<T, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (S + BQ - 1) / BQ);
  flash_attention_kernel<T, DJ><<<grid, kThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, S, d,
      causal, window, kv_group, scale);
  return (int)cudaGetLastError();
}

template <int DP, bool TRAIN>
int launch_tc_as(const void* q, const void* k, const void* v, void* out,
                 void* lse, void* out32, int H, int S, int d, int causal,
                 int window, int kv_group, float scale, cudaStream_t s) {
  constexpr size_t bytes = tc_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)flash_attention_tc_kernel<DP, TRAIN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)out) % 16 == 0;
  const dim3 grid(H, (S + kTcBQ - 1) / kTcBQ);
  flash_attention_tc_kernel<DP, TRAIN><<<grid, kTcThreads, bytes, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse,
      (float*)out32, S, d, causal, window, kv_group, scale, vec);
  return (int)cudaGetLastError();
}

// serving (lse null) or training (lse and out32 given)
template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, void* out32, int H, int S, int d, int causal,
              int window, int kv_group, float scale, cudaStream_t s) {
  return lse == nullptr
             ? launch_tc_as<DP, false>(q, k, v, out, lse, out32, H, S, d,
                                       causal, window, kv_group, scale, s)
             : launch_tc_as<DP, true>(q, k, v, out, lse, out32, H, S, d,
                                      causal, window, kv_group, scale, s);
}

// ---- backward (SIMT, float32 math) ----

constexpr int kBwdThreads = 256;
constexpr int BQB = 64;  // query rows of a backward tile

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// whether query qp attends to key kp (both inside the sequence)
__device__ __forceinline__ bool live(int qp, int kp, int S, int causal,
                                     int window) {
  return qp < S && kp < S && !(causal && kp > qp) &&
         !(window && qp - kp >= window);
}

// whether any pair of query tile [q0, q0 + nq) and key tile [k0, k0 + nk)
// is live (the forward's tile test; uniform over the block)
__device__ __forceinline__ bool tiles_meet(int q0, int nq, int k0, int nk,
                                           int causal, int window) {
  if (causal && q0 + nq - 1 < k0) return false;
  if (window && q0 - (k0 + nk - 1) >= window) return false;
  return true;
}

// rows [r0, r0 + ROWS) of a row-major (S, d) matrix into a ROWS x ld
// float32 tile: zeros past S and in columns [d, ld - 1)
template <typename T, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int S, int d, int ld) {
  const int w = ld - 1;
  for (int idx = threadIdx.x; idx < ROWS * w; idx += kBwdThreads) {
    const int r = idx / w, c = idx % w;
    dst[r * ld + c] = r0 + r < S && c < d
                          ? to_f32(src[(long long)(r0 + r) * d + c])
                          : 0.0f;
  }
}

// delta[row] = dO[row] . o[row] with o the float32 output, one warp a row
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_delta_kernel(const float* __restrict__ o,
                       const T* __restrict__ dout, float* __restrict__ delta,
                       long long rows, int d) {
  const long long row =
      (long long)blockIdx.x * (kBwdThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32)
    acc += o[row * d + c] * to_f32(dout[row * d + c]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// One query tile against one key tile: a thread's scores and dO v^T for
// query rows ty + 16 i (i < 4) and keys tx + 16 j (j < RI), then P and dS
// into shared memory (rows of BK + 1).
template <int RI>
__device__ __forceinline__ void tile_p_ds(const float* qs, const float* gs,
                                          const float* ks, const float* vs,
                                          const float* ls, const float* dl,
                                          float* ps, float* ds, int ld, int d,
                                          int q0, int k0, int S, int causal,
                                          int window, float scale) {
  constexpr int BK = 16 * RI;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sc[4][RI], dp[4][RI];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) sc[i][j] = dp[i][j] = 0.0f;
  for (int c = 0; c < d; ++c) {
    float qa[4], ga[4], kb[RI], vb[RI];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = qs[(ty + 16 * i) * ld + c];
      ga[i] = gs[(ty + 16 * i) * ld + c];
    }
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      kb[j] = ks[(tx + 16 * j) * ld + c];
      vb[j] = vs[(tx + 16 * j) * ld + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
        dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int c = tx + 16 * j;
      float p = 0.0f;
      if (live(q0 + r, k0 + c, S, causal, window))
        p = expf(sc[i][j] * scale - ls[r]);
      ps[r * (BK + 1) + c] = p;
      ds[r * (BK + 1) + c] = p * (dp[i][j] - dl[r]);
    }
  }
}

// query tile [q0, q0 + 64) of head h: q, dO, lse and delta into shared
template <typename T>
__device__ __forceinline__ void load_q_tile(float* qs, float* gs, float* ls,
                                            float* dl, const T* q,
                                            const T* dout, const float* lse,
                                            const float* delta, int h, int q0,
                                            int S, int d, int ld) {
  const long long base = (long long)h * S * d;
  load_rows<T, BQB>(qs, q + base, q0, S, d, ld);
  load_rows<T, BQB>(gs, dout + base, q0, S, d, ld);
  for (int r = threadIdx.x; r < BQB; r += kBwdThreads) {
    const bool in = q0 + r < S;
    ls[r] = in ? lse[(long long)h * S + q0 + r] : 0.0f;
    dl[r] = in ? delta[(long long)h * S + q0 + r] : 0.0f;
  }
}

// dk, dv: one block per (kv head, key tile of 16 RI)
template <typename T, int RI, int DJ>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int d, int causal,
                      int window, int kv_group, float scale) {
  constexpr int BK = 16 * RI;
  constexpr int ld = 16 * DJ + 1;
  extern __shared__ float smem[];
  float* ks = smem;                 // [BK][ld]
  float* vs = ks + BK * ld;         // [BK][ld]
  float* qs = vs + BK * ld;         // [BQB][ld]
  float* gs = qs + BQB * ld;        // [BQB][ld]  dO
  float* ps = gs + BQB * ld;        // [BQB][BK + 1]
  float* ds = ps + BQB * (BK + 1);  // [BQB][BK + 1]
  float* ls = ds + BQB * (BK + 1);  // [BQB]
  float* dl = ls + BQB;             // [BQB]

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long kbase = (long long)kvh * S * d;
  load_rows<T, BK>(ks, k + kbase, k0, S, d, ld);
  load_rows<T, BK>(vs, v + kbase, k0, S, d, ld);

  float dka[RI][DJ], dva[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.0f;

  const int n_q = (S + BQB - 1) / BQB;
  for (int g = 0; g < kv_group; ++g) {
    const int h = kvh * kv_group + g;
    for (int qi = 0; qi < n_q; ++qi) {
      const int q0 = qi * BQB;
      if (!tiles_meet(q0, BQB, k0, BK, causal, window)) continue;
      __syncthreads();  // the previous tile's readers are done
      load_q_tile<T>(qs, gs, ls, dl, q, dout, lse, delta, h, q0, S, d, ld);
      __syncthreads();
      tile_p_ds<RI>(qs, gs, ks, vs, ls, dl, ps, ds, ld, d, q0, k0, S, causal,
                    window, scale);
      __syncthreads();
      // keys ty + 16 i, columns tx + 16 j
      for (int r = 0; r < BQB; ++r) {
        float pa[RI], da[RI], gb[DJ], qb[DJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pa[i] = ps[r * (BK + 1) + ty + 16 * i];
          da[i] = ds[r * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gb[j] = gs[r * ld + tx + 16 * j];
          qb[j] = qs[r * ld + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dva[i][j] = fmaf(pa[i], gb[j], dva[i][j]);
            dka[i][j] = fmaf(da[i], qb[j], dka[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        dk[kbase + (long long)kp * d + c] = from_f32<T>(dka[i][j] * scale);
        dv[kbase + (long long)kp * d + c] = from_f32<T>(dva[i][j]);
      }
    }
  }
}

// dq: one block per (query head, 64-row tile), causal tails first
template <typename T, int RI, int DJ>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int d, int causal, int window, int kv_group,
                    float scale) {
  constexpr int BK = 16 * RI;
  constexpr int ld = 16 * DJ + 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQB][ld]
  float* gs = qs + BQB * ld;        // [BQB][ld]
  float* ks = gs + BQB * ld;        // [BK][ld]
  float* vs = ks + BK * ld;         // [BK][ld]
  float* ps = vs + BK * ld;         // [BQB][BK + 1] (P, unused here)
  float* ds = ps + BQB * (BK + 1);  // [BQB][BK + 1]
  float* ls = ds + BQB * (BK + 1);  // [BQB]
  float* dl = ls + BQB;             // [BQB]

  const int h = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long kbase = (long long)(h / kv_group) * S * d;
  load_q_tile<T>(qs, gs, ls, dl, q, dout, lse, delta, h, q0, S, d, ld);

  float dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.0f;

  const int n_k = (S + BK - 1) / BK;
  for (int ki = 0; ki < n_k; ++ki) {
    const int k0 = ki * BK;
    if (!tiles_meet(q0, BQB, k0, BK, causal, window)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, BK>(ks, k + kbase, k0, S, d, ld);
    load_rows<T, BK>(vs, v + kbase, k0, S, d, ld);
    __syncthreads();
    tile_p_ds<RI>(qs, gs, ks, vs, ls, dl, ps, ds, ld, d, q0, k0, S, causal,
                  window, scale);
    __syncthreads();
    // rows ty + 16 i, columns tx + 16 j
    for (int c = 0; c < BK; ++c) {
      float da[4], kb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = ds[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kb[j] = ks[c * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dqa[i][j] = fmaf(da[i], kb[j], dqa[i][j]);
    }
  }
  const long long qbase = (long long)h * S * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) dq[qbase + (long long)qp * d + c] = from_f32<T>(dqa[i][j] * scale);
    }
  }
}

constexpr size_t bwd_smem_bytes(int RI, int DJ) {
  return sizeof(float) * ((size_t)(2 * 16 * RI + 2 * BQB) * (16 * DJ + 1) +
                          (size_t)2 * BQB * (16 * RI + 1) + 2 * BQB);
}

template <typename T, int RI, int DJ>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* dq, void* dk,
               void* dv, void* delta, int H, int S, int d, int causal,
               int window, int kv_group, float scale, cudaStream_t s) {
  constexpr size_t bytes = bwd_smem_bytes(RI, DJ);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)flash_bwd_dkdv_kernel<T, RI, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute((const void*)flash_bwd_dq_kernel<T, RI, DJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)H * S;
  const long long blocks = (rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  flash_bwd_delta_kernel<T><<<(unsigned)blocks, kBwdThreads, 0, s>>>(
      (const float*)out, (const T*)dout, (float*)delta, rows, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 kv_grid(H / kv_group, (S + 16 * RI - 1) / (16 * RI));
  flash_bwd_dkdv_kernel<T, RI, DJ><<<kv_grid, kBwdThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, S, d, causal,
      window, kv_group, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 q_grid(H, (S + BQB - 1) / BQB);
  flash_bwd_dq_kernel<T, RI, DJ><<<q_grid, kBwdThreads, bytes, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, S, d, causal, window,
      kv_group, scale);
  return (int)cudaGetLastError();
}

// ---- backward on mma.sync (bf16, head dims up to 160) ----
//
// The same three passes as the SIMT backward (delta, then dk/dv, then dq;
// no atomics), with the five products as mma.sync.m16n8k16 bf16 products
// accumulating in float32, the fragments loaded as the forward loads them:
// S = Q K^T and dP = dO V^T (and their transposes in the dk/dv kernel)
// take bf16 inputs exactly; the products of P and dS each run
// twice, once with P (or dS) rounded to bf16 and once with its bf16
// remainder, so they carry about 16 bits of P and dS into the float32
// sums.  Built with -DFLASH_BWD_SPLIT=0 they run once, on P and dS
// rounded to bf16 (as cuDNN and FlashAttention-2 round them): at the
// train shape (96, 4096, 128) that form, like SDPA's backward, misses the
// plain gradient by more than the train path's tolerance in dk and dv,
// where the split stays inside it (scripts/flash_bwd_rounding.py holds
// both builds and SDPA against the plain gradient).  A block is 4 warps
// of 16 rows: 64 keys of a kv head for dk/dv,
// stepping over 32-query tiles of its kv_group query heads; 64 queries of
// a query head for dq, stepping over 32-key tiles.  Tiles come in with
// cp.async into shared rows padded by 16 bytes (the forward's load_tile);
// the accumulators (dk and dv, or dq) stay in registers.

constexpr int kTbStep = 32;  // queries (dk/dv) or keys (dq) a step

#ifndef FLASH_BWD_SPLIT
#define FLASH_BWD_SPLIT 1
#endif

template <int DP>
constexpr size_t tb_smem_bytes() {
  return (size_t)(2 * 64 + 2 * kTbStep) * (DP + kPad) *
             sizeof(__nv_bfloat16) +
         2 * 64 * sizeof(float);
}

// A fragment rows of a 16-row, DP-wide shared tile for this lane
__device__ __forceinline__ const __nv_bfloat16* a_rows(
    const __nv_bfloat16* tile, int ld, int row0) {
  const int lane = threadIdx.x % 32;
  return tile + (row0 + lane % 16) * ld + (lane / 16) * 8;
}

// B fragments of rows n0 .. n0 + 15 of a [n][k] shared tile at k0
__device__ __forceinline__ void b_rows(uint32_t (&b)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 +
                     ((lane / 8) % 2) * 8);
}

// B fragments of columns n0 .. n0 + 15 of a [k][n] shared tile at rows
// k0 .. k0 + 15 (transposed on load)
__device__ __forceinline__ void b_cols(uint32_t (&b)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld +
                           n0 + (lane / 16) * 8);
}

// acc[j] += (x rounded + its remainder) @ B over columns 16 nd2 .. + 15
// of a [k][n] tile, for the 16 k rows kk: x the C fragments c[2 kk],
// c[2 kk + 1] of a 16 x 16 block
template <int KD>
__device__ __forceinline__ void mma_split(float (&acc)[2 * KD][4],
                                          const float (&c0)[4],
                                          const float (&c1)[4],
                                          const __nv_bfloat16* tile, int ld,
                                          int kk) {
  const uint32_t hi[4] = {pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]),
                          pack_bf16(c1[0], c1[1]), pack_bf16(c1[2], c1[3])};
  const uint32_t lo[4] = {pack_rem(c0[0], c0[1], hi[0]),
                          pack_rem(c0[2], c0[3], hi[1]),
                          pack_rem(c1[0], c1[1], hi[2]),
                          pack_rem(c1[2], c1[3], hi[3])};
#pragma unroll
  for (int nd2 = 0; nd2 < KD; ++nd2) {
    uint32_t b[4];
    b_cols(b, tile, ld, kk * 16, nd2 * 16);
    mma_bf16(acc[2 * nd2], hi, b[0], b[1]);
    mma_bf16(acc[2 * nd2 + 1], hi, b[2], b[3]);
    if (FLASH_BWD_SPLIT) {
      mma_bf16(acc[2 * nd2], lo, b[0], b[1]);
      mma_bf16(acc[2 * nd2 + 1], lo, b[2], b[3]);
    }
  }
}

// rows r0 .. r0 + n of a float32 (S,) row of lse / delta into shared
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           int r0, int n, int S) {
  for (int r = threadIdx.x; r < n; r += kTcThreads)
    dst[r] = r0 + r < S ? src[r0 + r] : 0.0f;
}

// one thread's 16 x (DP / 8 x 8) accumulator rows (gr, gr + 8) of a warp's
// 16 rows starting at `row0` into a row-major (S, d) bf16 matrix, times mul
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* g,
                                           const float (&acc)[DP / 8][4],
                                           int row0, int S, int d,
                                           float mul) {
  const int lane = threadIdx.x % 32, gr = lane / 4, tq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * tq;
      if (c < d) g[(long long)row * d + c] = __float2bfloat16(acc[j][2 * r] * mul);
      if (c + 1 < d)
        g[(long long)row * d + c + 1] =
            __float2bfloat16(acc[j][2 * r + 1] * mul);
    }
  }
}

// dk, dv: one block per (kv head, 64 keys); warp w owns keys 16 w .. + 15
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int d,
                         int causal, int window, int kv_group, float scale,
                         int vec) {
  constexpr int LD = DP + kPad, KD = DP / 16, BQ = kTbStep, NB = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + 64 * LD;
  __nv_bfloat16* sq = sv + 64 * LD;
  __nv_bfloat16* sg = sq + BQ * LD;  // dO
  float* ls = reinterpret_cast<float*>(sg + BQ * LD);
  float* dl = ls + 64;

  const int kvh = blockIdx.x, k0 = blockIdx.y * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;
  const long long kbase = (long long)kvh * S * d;
  load_tile<DP, 64>(sk, k + kbase, k0, S, d, vec);
  load_tile<DP, 64>(sv, v + kbase, k0, S, d, vec);
  cp_async_commit();
  const __nv_bfloat16* krow = a_rows(sk, LD, warp * 16);
  const __nv_bfloat16* vrow = a_rows(sv, LD, warp * 16);

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.0f;

  const int n_q = (S + BQ - 1) / BQ;
  for (int g = 0; g < kv_group; ++g) {
    const int h = kvh * kv_group + g;
    const long long qbase = (long long)h * S * d;
    for (int qi = 0; qi < n_q; ++qi) {
      const int q0 = qi * BQ;
      if (!tiles_meet(q0, BQ, k0, 64, causal, window)) continue;
      __syncthreads();  // the previous tile's readers are done
      load_tile<DP, BQ>(sq, q + qbase, q0, S, d, vec);
      load_tile<DP, BQ>(sg, dout + qbase, q0, S, d, vec);
      load_stats(ls, lse + (long long)h * S, q0, BQ, S);
      load_stats(dl, delta + (long long)h * S, q0, BQ, S);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
      float st[NB][4], dpt[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, krow + kd * 16);
        ldmatrix_x4(vf, vrow + kd * 16);
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
          uint32_t b[4];
          b_rows(b, sq, LD, nb2 * 16, kd * 16);
          mma_bf16(st[2 * nb2], kf, b[0], b[1]);
          mma_bf16(st[2 * nb2 + 1], kf, b[2], b[3]);
          b_rows(b, sg, LD, nb2 * 16, kd * 16);
          mma_bf16(dpt[2 * nb2], vf, b[0], b[1]);
          mma_bf16(dpt[2 * nb2 + 1], vf, b[2], b[3]);
        }
      }
      // P^T into st, dS^T into dpt (rows keys, columns queries)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = k0 + warp * 16 + gr + 8 * r;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = nb * 8 + 2 * tq + c;
            float p = 0.0f;
            if (live(q0 + col, kp, S, causal, window))
              p = expf(st[nb][2 * r + c] * scale - ls[col]);
            st[nb][2 * r + c] = p;
            dpt[nb][2 * r + c] = p * (dpt[nb][2 * r + c] - dl[col]);
          }
      }
      // dV += P^T dO, dK += dS^T Q over the BQ queries
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        mma_split<KD>(dva, st[2 * kk], st[2 * kk + 1], sg, LD, kk);
        mma_split<KD>(dka, dpt[2 * kk], dpt[2 * kk + 1], sq, LD, kk);
      }
    }
  }
  cp_async_wait_all();
  store_rows<DP>(dk + kbase, dka, k0 + warp * 16, S, d, scale);
  store_rows<DP>(dv + kbase, dva, k0 + warp * 16, S, d, 1.0f);
}

// dq: one block per (query head, 64 queries), causal tails first; warp w
// owns queries 16 w .. + 15
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int S, int d,
                       int causal, int window, int kv_group, float scale,
                       int vec) {
  constexpr int LD = DP + kPad, KD = DP / 16, BK = kTbStep, NB = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sg = sq + 64 * LD;  // dO
  __nv_bfloat16* sk = sg + 64 * LD;
  __nv_bfloat16* sv = sk + BK * LD;
  float* ls = reinterpret_cast<float*>(sv + BK * LD);
  float* dl = ls + 64;

  const int h = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;
  const long long qbase = (long long)h * S * d;
  const long long kbase = (long long)(h / kv_group) * S * d;
  load_tile<DP, 64>(sq, q + qbase, q0, S, d, vec);
  load_tile<DP, 64>(sg, dout + qbase, q0, S, d, vec);
  load_stats(ls, lse + (long long)h * S, q0, 64, S);
  load_stats(dl, delta + (long long)h * S, q0, 64, S);
  cp_async_commit();
  const __nv_bfloat16* qrow = a_rows(sq, LD, warp * 16);
  const __nv_bfloat16* grow = a_rows(sg, LD, warp * 16);

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int n_k = (S + BK - 1) / BK;
  for (int ki = 0; ki < n_k; ++ki) {
    const int k0 = ki * BK;
    if (!tiles_meet(q0, 64, k0, BK, causal, window)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<DP, BK>(sk, k + kbase, k0, S, d, vec);
    load_tile<DP, BK>(sv, v + kbase, k0, S, d, vec);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x BK keys
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qf[4], gf[4];
      ldmatrix_x4(qf, qrow + kd * 16);
      ldmatrix_x4(gf, grow + kd * 16);
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t b[4];
        b_rows(b, sk, LD, nb2 * 16, kd * 16);
        mma_bf16(s[2 * nb2], qf, b[0], b[1]);
        mma_bf16(s[2 * nb2 + 1], qf, b[2], b[3]);
        b_rows(b, sv, LD, nb2 * 16, kd * 16);
        mma_bf16(dp[2 * nb2], gf, b[0], b[1]);
        mma_bf16(dp[2 * nb2 + 1], gf, b[2], b[3]);
      }
    }
    // dS into s
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + gr + 8 * r;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p = 0.0f;
          if (live(q0 + row, k0 + nb * 8 + 2 * tq + c, S, causal, window))
            p = expf(s[nb][2 * r + c] * scale - ls[row]);
          s[nb][2 * r + c] = p * (dp[nb][2 * r + c] - dl[row]);
        }
    }
    // dQ += dS K over the BK keys
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk)
      mma_split<KD>(acc, s[2 * kk], s[2 * kk + 1], sk, LD, kk);
  }
  cp_async_wait_all();
  store_rows<DP>(dq + qbase, acc, q0 + warp * 16, S, d, scale);
}

template <int DP>
int launch_bwd_tc(const void* q, const void* k, const void* v,
                  const void* out32, const void* dout, const void* lse,
                  void* dq, void* dk, void* dv, void* delta, int H, int S,
                  int d, int causal, int window, int kv_group, float scale,
                  cudaStream_t s) {
  constexpr size_t bytes = tb_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)flash_bwd_dkdv_tc_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute((const void*)flash_bwd_dq_tc_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)dout) % 16 == 0;
  const long long rows = (long long)H * S;
  const long long blocks = (rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  flash_bwd_delta_kernel<__nv_bfloat16><<<(unsigned)blocks, kBwdThreads, 0,
                                          s>>>(
      (const float*)out32, (const __nv_bfloat16*)dout, (float*)delta, rows,
      d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 kv_grid(H / kv_group, (S + 63) / 64);
  flash_bwd_dkdv_tc_kernel<DP><<<kv_grid, kTcThreads, bytes, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, S, d, causal, window, kv_group, scale, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 q_grid(H, (S + 63) / 64);
  flash_bwd_dq_tc_kernel<DP><<<q_grid, kTcThreads, bytes, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq, S, d,
      causal, window, kv_group, scale, vec);
  return (int)cudaGetLastError();
}

// ---- backward on wgmma + TMA (bf16, head dims to 160) ----
//
// The same three passes (delta, dk/dv, dq; no atomics), with blocks of two
// warpgroups.  A block holds 128 rows of its own operands (keys for dk/dv,
// queries for dq), loaded once by TMA, and streams 64-row tiles of the
// others (Q and dO for dk/dv, K and V for dq) through kWgStages stages of
// shared memory, each completing on an mbarrier; thread 0 issues every
// load (see "design" in the note at the top).  Warpgroup wg owns 64 of
// the block's rows and runs its products with wgmma: S^T = K Q^T and
// dP^T = V dO^T (dq: S = Q K^T, dP = dO V^T) with both operands in shared
// memory (K-major, 128-byte swizzle), then P and dS in registers, split
// into bf16 and remainder as mma_split does, as the register A operand of
// dV += P^T dO, dK += dS^T Q (dq: dQ += dS K), whose B operands are the
// stage's tiles read MN-major through the descriptor's transpose bit.
// The accumulators stay in float32 registers until the one store.

constexpr int kWgThreads = 256;  // two warpgroups; thread 0 also loads
constexpr int kWgRows = 128;      // keys (dk/dv) or queries (dq) a block
constexpr int kWgStep = 64;       // queries (dk/dv) or keys (dq) a stage
constexpr int kWgStages = 4;      // stages at most
constexpr uint32_t kWgBox = 64 * 128;  // a TMA box: 64 rows x 128 bytes
constexpr uint32_t kWgStats = 2 * 2 * 2 * kWgStep * 4;  // lse / delta rows

// the 64-column slabs (TMA boxes) of a DP-wide row: 1, 2, or 3 at DP 160,
// whose third slab holds columns 128..159 and 32 zeros
__host__ __device__ constexpr int wg_slabs(int dp) { return (dp + 63) / 64; }

// a 64-row tile, DP wide
template <int DP>
__host__ __device__ constexpr uint32_t wg_tile() {
  return wg_slabs(DP) * kWgBox;
}

// the stages of a backward kernel that holds FIXED tiles of its own rows:
// kWgStages, or as many as the block's 227 KB hold beside them (2 for dq
// and 3 for dk/dv at DP 160)
template <int DP, int FIXED>
__host__ __device__ constexpr int wg_stages() {
  return (int)((232448 - 1024 - kWgStats - 128 - FIXED * wg_tile<DP>()) /
               (2 * wg_tile<DP>())) < kWgStages
             ? (int)((232448 - 1024 - kWgStats - 128 - FIXED * wg_tile<DP>()) /
                     (2 * wg_tile<DP>()))
             : kWgStages;
}

// the block's FIXED tiles, the stages' 2 tiles, each warpgroup's two lse /
// delta rows, the mbarriers and the slack that puts the tiles on a
// 1024-byte boundary
template <int DP, int FIXED>
__host__ __device__ constexpr size_t wg_smem_bytes() {
  return FIXED * wg_tile<DP>() + wg_stages<DP, FIXED>() * 2 * wg_tile<DP>() +
         kWgStats + (2 * wg_stages<DP, FIXED>() + 1) * 8 + 1024;
}

// A warpgroup is done with tile j of a block's run, which streams through
// a ring of ST stages: release it, computed or skipped.  Its thread 0
// (`arrives`) waits for the tile to land, so that no arrival runs ahead of
// a skipped tile's load, and then arrives on the stage's `empty` barrier;
// the issuer refills the stage with tile j + ST once both warpgroups have
// arrived.  Only the arriving thread waits on `full` here: a warp that lagged behind it could
// otherwise wait on a stage that has been refilled since, whose barrier
// then shows the parity of two tiles on, and wait for a load that needs
// its own release first.  The threads that compute a tile wait for it with
// stage_landed.  A warpgroup releases every tile of its block's run in
// order.
template <int ST, typename Issue>
__device__ __forceinline__ void release_stage(int j, int tiles,
                                              uint32_t full, uint32_t empty,
                                              bool arrives, bool issuer,
                                              const Issue& issue) {
  const int s = j % ST;
  const uint32_t parity = (uint32_t)(j / ST) & 1u;
  if (arrives) {
    mbar_wait(full + 8 * s, parity);
    mbar_arrive(empty + 8 * s);
  }
  if (issuer && j + ST < tiles) {
    mbar_wait(empty + 8 * s, parity);
    issue(j + ST);
  }
}

// tile `it` of a ring of ST stages has landed
template <int ST>
__device__ __forceinline__ void stage_landed(uint32_t full, int it) {
  mbar_wait(full + 8 * (it % ST), (uint32_t)(it / ST) & 1u);
}

// [lo, hi): the tiles of `step` rows out of n that meet the block's rows
// [r0, r0 + rows) (keys when the tiles are queries, and back): the causal
// band and the window each bound the run on one side
__device__ __forceinline__ void meeting_tiles(int n, int step, int r0,
                                              int rows, bool tiles_are_q,
                                              int causal, int window,
                                              int* lo, int* hi) {
  *lo = 0;
  *hi = 0;
  for (int i = 0; i < n; ++i) {
    const bool meet =
        tiles_are_q ? tiles_meet(i * step, step, r0, rows, causal, window)
                    : tiles_meet(r0, rows, i * step, step, causal, window);
    if (meet) {
      if (*hi == 0) *lo = i;
      *hi = i + 1;
    }
  }
}

// d (64 x 64 float32 a warpgroup) {=, +=} A (64 x 16) B (16 x 64), both
// K-major in shared memory; `acc` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64 float32 a warpgroup) += A (64 x 16, bf16 pairs in registers,
// the m16n8k16 A fragment of each warp's 16 rows) B (16 x 64, MN-major in
// shared memory: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 float32 a warpgroup) += A (64 x 16, bf16 pairs in registers,
// the m16n8k16 A fragment of each warp's 16 rows) B (16 x 128, MN-major in
// shared memory: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 160 float32 a warpgroup) += A (64 x 16, bf16 pairs in registers)
// B (16 x 160, MN-major in shared memory: three 64-column slabs, the last
// read for its first 32 columns)
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
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
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n"
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
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (DP == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n160(d, a, db);
}

// whether every (query, key) pair of [qa, qa + 64) x [ka, ka + 64) is live
// (uniform over a warpgroup): such a tile needs no mask
__device__ __forceinline__ bool tile_live(int qa, int ka, int S, int causal,
                                          int window) {
  return qa + 64 <= S && ka + 64 <= S && !(causal && ka + 63 > qa) &&
         !(window && qa + 63 - ka >= window);
}

// P^T into st and dS^T into dpt for a warpgroup's 64 keys x 64 queries
// (the dk/dv kernel): this thread's keys kp0 (+ 8), queries q0 + 8 i +
// 2 tq (+ 1); ls and dl the tile's lse and delta rows.  MASK: the tile is
// not wholly live
template <bool MASK>
__device__ __forceinline__ void p_ds_t(float (&st)[32], float (&dpt)[32],
                                       const float* ls, const float* dl,
                                       int q0, int kp0, int S, int causal,
                                       int window, float scale) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * i + 2 * tq + c, e = 4 * i + 2 * r + c;
        float p = 0.0f;
        if (!MASK || live(q0 + col, kp0 + 8 * r, S, causal, window))
          p = expf(st[e] * scale - ls[col]);
        st[e] = p;
        dpt[e] = p * (dpt[e] - dl[col]);
      }
}

// P^T alone into st (the split dk/dv kernel's dV warpgroup), as p_ds_t
template <bool MASK>
__device__ __forceinline__ void p_t(float (&st)[32], const float* ls, int q0,
                                    int kp0, int S, int causal, int window,
                                    float scale) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * i + 2 * tq + c, e = 4 * i + 2 * r + c;
        float p = 0.0f;
        if (!MASK || live(q0 + col, kp0 + 8 * r, S, causal, window))
          p = expf(st[e] * scale - ls[col]);
        st[e] = p;
      }
}

// dS into sc for a warpgroup's 64 queries x 64 keys (the dq kernel): this
// thread's queries rows[r], keys k0 + 8 i + 2 tq (+ 1), with their lse and
// delta in ls and dl
template <bool MASK>
__device__ __forceinline__ void ds_rows(float (&sc)[32], const float (&dp)[32],
                                        const int (&rows)[2],
                                        const float (&ls)[2],
                                        const float (&dl)[2], int k0, int S,
                                        int causal, int window, float scale) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * i + 2 * r + c;
        float p = 0.0f;
        if (!MASK || live(rows[r], k0 + 8 * i + 2 * tq + c, S, causal, window))
          p = expf(sc[e] * scale - ls[r]);
        sc[e] = p * (dp[e] - dl[r]);
      }
}

// s (the 64 x 64 accumulator of a warpgroup) as the A fragments of its 4
// k16 steps: the bf16 value and its bf16 remainder (the pairs mma_split
// packs; fragment kk is registers 8 kk .. 8 kk + 7 of the accumulator)
__device__ __forceinline__ void split_a(const float (&s)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    hi[j / 4][j % 4] = pack_bf16(s[2 * j], s[2 * j + 1]);
    lo[j / 4][j % 4] = pack_rem(s[2 * j], s[2 * j + 1], hi[j / 4][j % 4]);
  }
}

template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) fence_regs(f[kk]);
}

// acc (64 x 64) = A (64 rows x DP, K-major at a) B^T (64 rows x DP,
// K-major at b): 16 columns a step, +32 bytes inside a swizzled 128-byte
// row, the next 64 columns a box on; 8-row groups 1024 bytes apart
template <int DP>
__device__ __forceinline__ void wgmma_abt(float (&acc)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * kWgBox + 32 * (kk % 4);
    wgmma_ss_n64(acc, wgmma_desc(a + off, 16, 1024),
                 wgmma_desc(b + off, 16, 1024), kk);
  }
}

// acc (64 x DP) += (hi + lo) (64 x 64, registers) B (64 rows x DP at b,
// MN-major: 16 rows, 2048 bytes, a step; 64-column boxes kWgBox apart)
template <int DP>
__device__ __forceinline__ void wgmma_split_b(float (&acc)[DP / 2],
                                              const uint32_t (&hi)[4][4],
                                              const uint32_t (&lo)[4][4],
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = wgmma_desc(b + 2048 * kk, kWgBox, 1024);
    wgmma_rs<DP>(acc, hi[kk], db);
    if (FLASH_BWD_SPLIT) wgmma_rs<DP>(acc, lo[kk], db);
  }
}

// a warpgroup's 64 x DP accumulator rows into a row-major (S, d) bf16
// matrix from row `row0`, times mul, columns past d (zero padding) left
// out: warp w holds rows 16 w + lane / 4 (+ 8), register 4 i + {0, 1}
// (+ {2, 3}) columns 8 i + 2 (lane % 4) + {0, 1}; d % 8 == 0
template <int DP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* g,
                                          const float (&acc)[DP / 2],
                                          int row0, int S, int d, float mul) {
  const int t = threadIdx.x % 128, lane = t % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (t / 32) * 16 + lane / 4 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
      if (8 * i < d)
        *reinterpret_cast<__nv_bfloat162*>(g + (long long)row * d + 8 * i +
                                           2 * (lane % 4)) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * mul,
                                  acc[4 * i + 2 * r + 1] * mul);
  }
}

// dk, dv: one block per (kv head, 128 keys); consumer warpgroup wg owns
// keys 64 wg .. + 63 and walks every 64-query tile of the kv head's
// kv_group query heads that meets the block: tile j is query tile
// qlo + j % per of query head kvh * kv_group + j / per
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int S, int d,
                            int causal, int window, int kv_group,
                            float scale) {
  constexpr uint32_t TILE = wg_tile<DP>();
  constexpr int ST = wg_stages<DP, 4>();
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + 2 * TILE;  // the block's keys
  const uint32_t stages = base + 4 * TILE;  // [stage] Q tile, dO tile
  // [wg][2][lse, delta] rows
  const uint32_t stats = stages + ST * 2 * TILE;
  const uint32_t full = stats + kWgStats;
  const uint32_t empty = full + ST * 8;
  const uint32_t fixed = empty + ST * 8;
  const int kvh = blockIdx.x, k0 = blockIdx.y * kWgRows;
  int qlo, qhi;
  meeting_tiles((S + kWgStep - 1) / kWgStep, kWgStep, k0, kWgRows, true,
                causal, window, &qlo, &qhi);
  const int per = qhi - qlo, tiles = per * kv_group;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);   // the issuer's expect_tx + the bytes
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init(fixed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // tile j's Q and dO into its stage
  auto issue = [&](int j) {
    const int s = j % ST;
    const uint32_t bar = full + 8 * s, tile = stages + s * 2 * TILE;
    const int h = kvh * kv_group + j / per, q0 = (qlo + j % per) * kWgStep;
    mbar_expect_tx(bar, 2 * TILE);
    for (int b = 0; b < wg_slabs(DP); ++b) {
      tma_load_3d(tile + b * kWgBox, &map_q, bar, 64 * b, q0, h);
      tma_load_3d(tile + TILE + b * kWgBox, &map_do, bar, 64 * b, q0, h);
    }
  };
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    mbar_expect_tx(fixed, 4 * TILE);
    for (int t = 0; t < 2; ++t)
      for (int b = 0; b < wg_slabs(DP); ++b) {
        tma_load_3d(sk + t * TILE + b * kWgBox, &map_k, fixed, 64 * b,
                    k0 + 64 * t, kvh);
        tma_load_3d(sv + t * TILE + b * kWgBox, &map_v, fixed, 64 * b,
                    k0 + 64 * t, kvh);
      }
    for (int j = 0; j < tiles && j < ST; ++j) issue(j);
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int gr = lane / 4;
  const int kw0 = k0 + 64 * wg;  // this warpgroup's 64 keys
  const uint32_t ka = sk + wg * TILE, va = sv + wg * TILE;
  float* stat_rows = reinterpret_cast<float*>(wg_smem + (stats - raw)) +
                     wg * 2 * 2 * kWgStep;
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.0f;
  // this thread's lse (t < 64) or delta row of tile j, 0 past S
  auto stat = [&](int j) {
    const int r = (qlo + j % per) * kWgStep + t % 64;
    return r < S ? (t < 64 ? lse : delta)[(long long)(kvh * kv_group +
                                                      j / per) * S + r]
                 : 0.0f;
  };
  float next = tiles > 0 ? stat(0) : 0.0f;
  mbar_wait(fixed, 0);
  int done = 0;  // tiles this warpgroup computed: its stat buffer's parity
  for (int it = 0; it < tiles; ++it) {
    const int s = it % ST, q0 = (qlo + it % per) * kWgStep;
    // the stats are loaded a tile ahead, so their latency hides
    const float mine = next;
    if (it + 1 < tiles) next = stat(it + 1);
    // every tile is released, computed or skipped (a skipped tile's stage
    // is waited on by thread 0 alone)
    if (!tiles_meet(q0, kWgStep, kw0, 64, causal, window)) {
      release_stage<ST>(it, tiles, full, empty, t == 0, issuer, issue);
      continue;
    }
    stage_landed<ST>(full, it);
    const uint32_t qs = stages + s * 2 * TILE, gs = qs + TILE;
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
    float st[32], dpt[32];
    wgmma_fence();
    wgmma_abt<DP>(st, ka, qs);
    wgmma_abt<DP>(dpt, va, gs);
    wgmma_commit();
    // the tile's lse and delta rows through the warpgroup's own buffer,
    // one of two by the parity of its computed tiles, so that one
    // barrier a tile keeps a write from overtaking the last reads of
    // that buffer
    float* ls = stat_rows + (done++ & 1) * 2 * kWgStep;
    ls[t] = mine;
    named_barrier(1 + wg, 128);
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const int kp0 = kw0 + (t / 32) * 16 + gr;
    if (tile_live(q0, kw0, S, causal, window))
      p_ds_t<false>(st, dpt, ls, ls + kWgStep, q0, kp0, S, causal, window,
                    scale);
    else
      p_ds_t<true>(st, dpt, ls, ls + kWgStep, q0, kp0, S, causal, window,
                   scale);
    uint32_t ph[4][4], pl[4][4], dh[4][4], dlo[4][4];
    split_a(st, ph, pl);
    split_a(dpt, dh, dlo);
    // dV += P^T dO, dK += dS^T Q over the 64 queries
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    wgmma_split_b<DP>(dva, ph, pl, gs);
    wgmma_split_b<DP>(dka, dh, dlo, qs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_frags(ph);
    fence_frags(pl);
    fence_frags(dh);
    fence_frags(dlo);
    release_stage<ST>(it, tiles, full, empty, t == 0, issuer, issue);
  }
  const long long kbase = (long long)kvh * S * d;
  store_acc<DP>(dk + kbase, dka, kw0, S, d, scale);
  store_acc<DP>(dv + kbase, dva, kw0, S, d, 1.0f);
}

// dk, dv past DP 128 (the split partition): one block per (kv head, 64
// keys), both warpgroups on the block's keys over every 64-query tile of
// its kv_group query heads that meets them (tile j: query tile qlo + j %
// per of query head kvh * kv_group + j / per).  Warpgroup 0 forms S^T and
// P^T and accumulates dV += P^T dO; warpgroup 1 forms S^T, dP^T and dS^T
// and accumulates dK += dS^T Q.  Each holds one 64 x DP accumulator (80
// floats a thread at DP 160) where a warpgroup holding both would need
// 160 and spill; S^T is formed twice, 7 products a tile pair where the
// d-128 partition does 6.  ROLE: the warpgroup's (0 dV, 1 dK).
template <int DP, int ST, int ROLE, typename Issue>
__device__ __forceinline__ void dkdv_split_role(
    uint32_t sk, uint32_t sv, uint32_t stages, float* stat_rows,
    uint32_t full, uint32_t empty, uint32_t fixed, const float* lse,
    const float* delta, __nv_bfloat16* out, int kvh, int k0, int qlo,
    int per, int tiles, int S, int d, int causal, int window, int kv_group,
    float scale, bool issuer, const Issue& issue) {
  constexpr uint32_t TILE = wg_tile<DP>();
  const int t = threadIdx.x % 128, lane = t % 32;
  const int kp0 = k0 + (t / 32) * 16 + lane / 4;  // this thread's keys
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  // this thread's lse (t < 64) or delta row of tile j, 0 past S
  auto stat = [&](int j) {
    const int r = (qlo + j % per) * kWgStep + t % 64;
    return r < S ? (t < 64 ? lse : delta)[(long long)(kvh * kv_group +
                                                      j / per) * S + r]
                 : 0.0f;
  };
  float next = tiles > 0 ? stat(0) : 0.0f;
  mbar_wait(fixed, 0);
  for (int it = 0; it < tiles; ++it) {
    const int q0 = (qlo + it % per) * kWgStep;
    const float mine = next;
    if (it + 1 < tiles) next = stat(it + 1);
    stage_landed<ST>(full, it);
    const uint32_t qs = stages + (it % ST) * 2 * TILE, gs = qs + TILE;
    // S^T = K Q^T (and dP^T = V dO^T): 64 keys x 64 queries
    float st[32], dpt[32];
    wgmma_fence();
    wgmma_abt<DP>(st, sk, qs);
    if constexpr (ROLE == 1) wgmma_abt<DP>(dpt, sv, gs);
    wgmma_commit();
    // the tile's lse and delta rows, double-buffered by the tile's parity
    float* ls = stat_rows + (it & 1) * 2 * kWgStep;
    ls[t] = mine;
    named_barrier(1 + ROLE, 128);
    wgmma_wait<0>();
    fence_regs(st);
    if constexpr (ROLE == 1) fence_regs(dpt);
    const bool whole = tile_live(q0, k0, S, causal, window);
    uint32_t hi[4][4], lo[4][4];
    if constexpr (ROLE == 0) {
      if (whole)
        p_t<false>(st, ls, q0, kp0, S, causal, window, scale);
      else
        p_t<true>(st, ls, q0, kp0, S, causal, window, scale);
      split_a(st, hi, lo);
    } else {
      if (whole)
        p_ds_t<false>(st, dpt, ls, ls + kWgStep, q0, kp0, S, causal, window,
                      scale);
      else
        p_ds_t<true>(st, dpt, ls, ls + kWgStep, q0, kp0, S, causal, window,
                     scale);
      split_a(dpt, hi, lo);
    }
    // dV += P^T dO, or dK += dS^T Q, over the 64 queries
    fence_regs(acc);
    wgmma_fence();
    wgmma_split_b<DP>(acc, hi, lo, ROLE == 0 ? gs : qs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(hi);
    fence_frags(lo);
    release_stage<ST>(it, tiles, full, empty, t == 0, issuer, issue);
  }
  store_acc<DP>(out + (long long)kvh * S * d, acc, k0, S, d,
                ROLE == 0 ? 1.0f : scale);
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_split_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap map_k,
                                  const __grid_constant__ CUtensorMap map_v,
                                  const __grid_constant__ CUtensorMap map_do,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int S,
                                  int d, int causal, int window, int kv_group,
                                  float scale) {
  constexpr uint32_t TILE = wg_tile<DP>();
  constexpr int ST = wg_stages<DP, 2>();
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + TILE;  // the block's 64 keys
  const uint32_t stages = base + 2 * TILE;     // [stage] Q tile, dO tile
  const uint32_t stats = stages + ST * 2 * TILE;  // [wg][2][lse, delta]
  const uint32_t full = stats + kWgStats;
  const uint32_t empty = full + ST * 8;
  const uint32_t fixed = empty + ST * 8;
  const int kvh = blockIdx.x, k0 = blockIdx.y * kWgStep;
  int qlo, qhi;
  meeting_tiles((S + kWgStep - 1) / kWgStep, kWgStep, k0, kWgStep, true,
                causal, window, &qlo, &qhi);
  const int per = qhi - qlo, tiles = per * kv_group;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);   // the issuer's expect_tx + the bytes
      mbar_init(empty + 8 * s, 2);  // one arrival per warpgroup
    }
    mbar_init(fixed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // tile j's Q and dO into its stage
  auto issue = [&](int j) {
    const int s = j % ST;
    const uint32_t bar = full + 8 * s, tile = stages + s * 2 * TILE;
    const int h = kvh * kv_group + j / per, q0 = (qlo + j % per) * kWgStep;
    mbar_expect_tx(bar, 2 * TILE);
    for (int b = 0; b < wg_slabs(DP); ++b) {
      tma_load_3d(tile + b * kWgBox, &map_q, bar, 64 * b, q0, h);
      tma_load_3d(tile + TILE + b * kWgBox, &map_do, bar, 64 * b, q0, h);
    }
  };
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    mbar_expect_tx(fixed, 2 * TILE);
    for (int b = 0; b < wg_slabs(DP); ++b) {
      tma_load_3d(sk + b * kWgBox, &map_k, fixed, 64 * b, k0, kvh);
      tma_load_3d(sv + b * kWgBox, &map_v, fixed, 64 * b, k0, kvh);
    }
    for (int j = 0; j < tiles && j < ST; ++j) issue(j);
  }

  const int wg = threadIdx.x / 128;
  float* stat_rows = reinterpret_cast<float*>(wg_smem + (stats - raw)) +
                     wg * 2 * 2 * kWgStep;
  if (wg == 0)
    dkdv_split_role<DP, ST, 0>(sk, sv, stages, stat_rows, full, empty, fixed,
                               lse, delta, dv, kvh, k0, qlo, per, tiles, S, d,
                               causal, window, kv_group, scale, issuer,
                               issue);
  else
    dkdv_split_role<DP, ST, 1>(sk, sv, stages, stat_rows, full, empty, fixed,
                               lse, delta, dk, kvh, k0, qlo, per, tiles, S, d,
                               causal, window, kv_group, scale, issuer,
                               issue);
}

// dq: one block per (query head, 128 queries), causal tails first;
// consumer warpgroup wg owns queries 64 wg .. + 63 and walks every 64-key
// tile that meets the block: tile j is key tile klo + j
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int S, int d,
                          int causal, int window, int kv_group, float scale) {
  constexpr uint32_t TILE = wg_tile<DP>();
  constexpr int ST = wg_stages<DP, 4>();
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t sq = base, sg = base + 2 * TILE;  // the block's queries
  const uint32_t stages = base + 4 * TILE;  // [stage] K tile, V tile
  const uint32_t full = stages + ST * 2 * TILE + kWgStats;
  const uint32_t empty = full + ST * 8;
  const uint32_t fixed = empty + ST * 8;
  const int h = blockIdx.x, kvh = h / kv_group;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kWgRows;
  int klo, khi;
  meeting_tiles((S + kWgStep - 1) / kWgStep, kWgStep, q0, kWgRows, false,
                causal, window, &klo, &khi);
  const int tiles = khi - klo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_init(fixed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int j) {
    const int s = j % ST, k0 = (klo + j) * kWgStep;
    const uint32_t bar = full + 8 * s, tile = stages + s * 2 * TILE;
    mbar_expect_tx(bar, 2 * TILE);
    for (int b = 0; b < wg_slabs(DP); ++b) {
      tma_load_3d(tile + b * kWgBox, &map_k, bar, 64 * b, k0, kvh);
      tma_load_3d(tile + TILE + b * kWgBox, &map_v, bar, 64 * b, k0, kvh);
    }
  };
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    mbar_expect_tx(fixed, 4 * TILE);
    for (int t = 0; t < 2; ++t)
      for (int b = 0; b < wg_slabs(DP); ++b) {
        tma_load_3d(sq + t * TILE + b * kWgBox, &map_q, fixed, 64 * b,
                    q0 + 64 * t, h);
        tma_load_3d(sg + t * TILE + b * kWgBox, &map_do, fixed, 64 * b,
                    q0 + 64 * t, h);
      }
    for (int j = 0; j < tiles && j < ST; ++j) issue(j);
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int gr = lane / 4;
  const int qw0 = q0 + 64 * wg;  // this warpgroup's 64 queries
  const uint32_t qa = sq + wg * TILE, ga = sg + wg * TILE;
  int rows[2];
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = qw0 + (t / 32) * 16 + gr + 8 * r;
    const bool in = rows[r] < S;
    ls[r] = in ? lse[(long long)h * S + rows[r]] : 0.0f;
    dl[r] = in ? delta[(long long)h * S + rows[r]] : 0.0f;
  }
  // [a, b): the block's tiles that meet this warpgroup's queries
  int a = 0, b = 0;
  for (int it = 0; it < tiles; ++it)
    if (tiles_meet(qw0, 64, (klo + it) * kWgStep, kWgStep, causal, window)) {
      if (b == 0) a = it;
      b = it + 1;
    }
  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.0f;
  // S = Q K^T and dP = dO V^T of tile `it` (64 queries x 64 keys) into
  // sc and dp, asynchronously
  float sc[32], dp[32];
  auto products = [&](int it) {
    const uint32_t ks = stages + (it % ST) * 2 * TILE;
    wgmma_fence();
    wgmma_abt<DP>(sc, qa, ks);
    wgmma_abt<DP>(dp, ga, ks + TILE);
    wgmma_commit();
  };
  mbar_wait(fixed, 0);
  // every tile of the block's run, computed ([a, b)) or skipped, in order
  for (int it = 0; it < tiles; ++it) {
    const int s = it % ST, k0 = (klo + it) * kWgStep;
    if (it >= a && it < b) {
      if (it == a) {
        stage_landed<ST>(full, it);
        products(it);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
      }
      // this tile's products out of the way of the next tile's, which run
      // while dS is formed
      float cs[32], cd[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        cs[e] = sc[e];
        cd[e] = dp[e];
      }
      if (it + 1 < b) {
        stage_landed<ST>(full, it + 1);
        products(it + 1);
      }
      if (tile_live(qw0, k0, S, causal, window))
        ds_rows<false>(cs, cd, rows, ls, dl, k0, S, causal, window, scale);
      else
        ds_rows<true>(cs, cd, rows, ls, dl, k0, S, causal, window, scale);
      uint32_t hi[4][4], lo[4][4];
      split_a(cs, hi, lo);
      // dQ += dS K over the 64 keys (waits for the next tile's products
      // too: wgmma groups complete in order)
      fence_regs(dqa);
      wgmma_fence();
      wgmma_split_b<DP>(dqa, hi, lo, stages + s * 2 * TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_regs(sc);
      fence_regs(dp);
      fence_frags(hi);
      fence_frags(lo);
    }
    release_stage<ST>(it, tiles, full, empty, t == 0, issuer, issue);
  }
  store_acc<DP>(dq + (long long)h * S * d, dqa, qw0, S, d, scale);
}

// a contiguous (heads, S, d) bf16 tensor as a 3-D map (d, S, heads) read
// in 64 x 64 boxes: rows past S read zeros, not the next head's, and so do
// the columns d .. DP - 1 of a kernel instantiated at DP > d (d % 8 == 0:
// a row is a multiple of 16 bytes, as the map's stride must be)
bool head_map(CUtensorMap* map, const void* ptr, int heads, int S, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  return bf16_tensor_map(map, ptr, 3, dims, strides, box);
}

// DP 64 and 128: dk/dv in blocks of 128 keys, a warpgroup's 64 holding
// both accumulators; DP 160: the split partition, 64 keys a block
template <int DP>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* out32, const void* dout, const void* lse,
                     void* dq, void* dk, void* dv, void* delta, int H, int S,
                     int d, int causal, int window, int kv_group, float scale,
                     cudaStream_t s) {
  constexpr bool split = DP > 128;
  CUtensorMap mq, mk, mv, mg;
  if (!head_map(&mq, q, H, S, d) || !head_map(&mk, k, H / kv_group, S, d) ||
      !head_map(&mv, v, H / kv_group, S, d) ||
      !head_map(&mg, dout, H, S, d))
    return (int)cudaErrorInvalidValue;
  const void* dkdv;  // only the partition of this DP is instantiated
  if constexpr (split)
    dkdv = (const void*)flash_bwd_dkdv_split_wgmma_kernel<DP>;
  else
    dkdv = (const void*)flash_bwd_dkdv_wgmma_kernel<DP>;
  constexpr size_t dkdv_bytes = wg_smem_bytes<DP, split ? 2 : 4>();
  constexpr size_t dq_bytes = wg_smem_bytes<DP, 4>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute((const void*)flash_bwd_dq_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)H * S;
  const long long blocks = (rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  flash_bwd_delta_kernel<__nv_bfloat16><<<(unsigned)blocks, kBwdThreads, 0,
                                          s>>>(
      (const float*)out32, (const __nv_bfloat16*)dout, (float*)delta, rows,
      d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (split)
    flash_bwd_dkdv_split_wgmma_kernel<DP><<<
        dim3(H / kv_group, (S + kWgStep - 1) / kWgStep), kWgThreads,
        dkdv_bytes, s>>>(mq, mk, mv, mg, (const float*)lse,
                         (const float*)delta, (__nv_bfloat16*)dk,
                         (__nv_bfloat16*)dv, S, d, causal, window, kv_group,
                         scale);
  else
    flash_bwd_dkdv_wgmma_kernel<DP><<<
        dim3(H / kv_group, (S + kWgRows - 1) / kWgRows), kWgThreads,
        dkdv_bytes, s>>>(mq, mk, mv, mg, (const float*)lse,
                         (const float*)delta, (__nv_bfloat16*)dk,
                         (__nv_bfloat16*)dv, S, d, causal, window, kv_group,
                         scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  flash_bwd_dq_wgmma_kernel<DP><<<dim3(H, (S + kWgRows - 1) / kWgRows),
                                  kWgThreads, dq_bytes, s>>>(
      mq, mk, mv, mg, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, S, d, causal, window, kv_group, scale);
  return (int)cudaGetLastError();
}

// ---- forward on wgmma + TMA (bf16, head dims to 160) ----
//
// One block per (query head, 128 queries), causal tails first, 256 threads
// in two warpgroups of 64 queries; thread 0 issues every TMA load (no
// producer warp, as in the backward).  The block's q rows are loaded once;
// tiles of K and V (fwd_keys: 64 keys, 128 in the training form at DP
// 128) stream through fwd_stages stages,
// each completing on an mbarrier and refilled once both warpgroups have
// released it.  A warpgroup walks the key tiles that meet its rows:
// S = Q K^T is an SS wgmma (both K-major); the online softmax runs on the
// accumulator in registers (a thread holds 2 rows x a quarter of the
// tile's keys, reduced over its quad); P turns into the bf16 A fragments
// of the RS wgmma O += P V (V MN-major through the transpose bit), TRAIN
// adding the product of P's bf16 remainder.  Tile j's S product is issued
// before tile j - 1's P V, and tile j's softmax runs while P V is on the
// tensor cores; the output takes its rescale once P V is done.  The
// output is staged in the warpgroup's q tile under the TMA box's swizzle
// and stored by TMA, which clips rows past S and columns past d.  Head
// dims below DP read zero columns from the tensor maps (head_map); at DP
// 160 a row is three 64-column slabs (the third holding 32 zeros), Q K^T
// takes 10 k16 steps (the zeros are never multiplied) and P V runs
// m64n160, the last slab read for its first 32 columns.

// K and V tiles in flight at most (fewer where a block's 227 KB would not
// hold them); 2 and 3 lost to 4 on the card (PERF.md)
constexpr int kFwdStages = 4;
// blocks an SM: at DP 128 the O accumulator (64 floats a thread; 80 at
// DP 160), S (32) and P's fragments need more than half of the 255
// registers, so one; DP 64 is built for two (128 registers a thread),
// which beat one
constexpr int fwd_min_blocks(int dp) { return dp <= 64 ? 2 : 1; }
// the softmax's exponentials run in base 2 (exp2f of the scores scaled by
// log2(e)); lse is converted back to natural units
constexpr float kFwdLog2e = 1.44269504088896341f;

// keys a K / V tile: 128 for the training form at DP 128 (whose products
// then run m64n128 and its barrier waits halve), 64 otherwise
template <int DP, bool TRAIN>
__host__ __device__ constexpr int fwd_keys() {
  return TRAIN && DP == 128 ? 128 : 64;
}
// a key tile's 64-column slab (its keys' rows of 128 bytes) and the whole
// tile, wg_slabs(DP) slabs
template <int DP, bool TRAIN>
__host__ __device__ constexpr uint32_t fwd_ktile() {
  return wg_slabs(DP) * fwd_keys<DP, TRAIN>() * 128;
}
// kFwdStages, or as many as the block's shared memory holds (3 for
// 128-key tiles at DP 128 and for DP 160)
template <int DP, bool TRAIN>
__host__ __device__ constexpr int fwd_stages() {
  return (int)((232448 - 2048 - 2 * wg_tile<DP>()) /
               (2 * fwd_ktile<DP, TRAIN>())) < kFwdStages
             ? (int)((232448 - 2048 - 2 * wg_tile<DP>()) /
                     (2 * fwd_ktile<DP, TRAIN>()))
             : kFwdStages;
}

// the block's 2 q tiles, the stages' K and V tiles, the mbarriers and the
// slack that puts the tiles on a 1024-byte boundary
template <int DP, bool TRAIN>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return 2 * wg_tile<DP>() +
         fwd_stages<DP, TRAIN>() * 2 * fwd_ktile<DP, TRAIN>() +
         (2 * fwd_stages<DP, TRAIN>() + 1) * 8 + 1024;
}

// d (64 x 128 float32 a warpgroup) {=, +=} A (64 x 16) B (16 x 128), both
// K-major in shared memory; `acc` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// s (64 queries x BK keys) = Q (64 rows x DP at q, 64-column boxes
// kWgBox apart) K^T (BK rows x DP at k, 64-column slabs BK x 128 bytes
// apart), both K-major: 16 columns a step, +32 bytes inside a swizzled
// 128-byte row
template <int DP, int BK>
__device__ __forceinline__ void fwd_scores(float (&s)[BK / 2], uint32_t q,
                                           uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t in = 32 * (kk % 4);
    const uint64_t da = wgmma_desc(q + (kk / 4) * kWgBox + in, 16, 1024);
    const uint64_t db = wgmma_desc(k + (kk / 4) * (BK * 128) + in, 16, 1024);
    if constexpr (BK == 64)
      wgmma_ss_n64(s, da, db, kk);
    else
      wgmma_ss_n128(s, da, db, kk);
  }
}

// whether every (query, key) pair of [qa, qa + 64) x [ka, ka + BK) is live
// (uniform over a warpgroup): such a tile needs no mask
template <int BK>
__device__ __forceinline__ bool fwd_tile_live(int qa, int ka, int S,
                                              int causal, int window) {
  return qa + 64 <= S && ka + BK <= S && !(causal && ka + BK - 1 > qa) &&
         !(window && qa + 63 - ka >= window);
}

// The online softmax of a warpgroup's 64 x BK score tile, in place, in
// base 2 (exp2f): this thread's rows qr0 and qr0 + 8, keys k0 + 8 i +
// 2 tq + c at s[4 i + 2 r + c].  Scores are scaled by sl2 = scale *
// log2(e) and (MASK: the tile is not wholly live) masked as the mma.sync
// kernel masks them (NEG, or -inf past S); p = 2^(x - m_new), which is
// exp of the scores in natural units; m (base 2) and l move on, and
// alpha[r] is what the row's output is multiplied by.  A wholly live tile
// scales inside the exponent's FMA (the max of the raw scores, scaled, is
// the max of the scaled ones).
template <int BK, bool MASK>
__device__ __forceinline__ void fwd_softmax(float (&s)[BK / 2], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            int qr0, int k0, int S,
                                            int causal, int window,
                                            float sl2) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qr0 + 8 * r;
    float mx = NEG;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * i + 2 * r + c;
        if (MASK) {
          float x = s[e] * sl2;
          const int kp = k0 + 8 * i + 2 * tq + c;
          if ((causal && qp < kp) || (window && qp - kp >= window)) x = NEG;
          if (kp >= S) x = -INFINITY;  // past the sequence: no weight
          s[e] = x;
        }
        mx = fmaxf(mx, s[e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], MASK ? mx : mx * sl2);
    float rs = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * i + 2 * r + c;
        const float p = exp2f(MASK ? s[e] - m_new : fmaf(s[e], sl2, -m_new));
        s[e] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    alpha[r] = exp2f(m[r] - m_new);
    l[r] = alpha[r] * l[r] + rs;
    m[r] = m_new;
  }
}

// p (the 64 x BK accumulator) as the A fragments of its BK / 16 k16 steps
// in bf16 and, TRAIN, their bf16 remainders
template <int BK, bool TRAIN>
__device__ __forceinline__ void pack_p(const float (&p)[BK / 2],
                                       uint32_t (&hi)[BK / 16][4],
                                       uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) {
    hi[j / 4][j % 4] = pack_bf16(p[2 * j], p[2 * j + 1]);
    if constexpr (TRAIN)
      lo[j / 4][j % 4] = pack_rem(p[2 * j], p[2 * j + 1], hi[j / 4][j % 4]);
  }
}

// o (64 x DP) += P V: P the fragments (TRAIN: and their remainders), V the
// BK x DP tile at b, MN-major: 16 keys (2048 bytes) a step, 64-column
// slabs BK x 128 bytes apart
template <int DP, int BK, bool TRAIN>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&hi)[BK / 16][4],
                                         const uint32_t (&lo)[BK / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = wgmma_desc(b + 2048 * kk, BK * 128, 1024);
    wgmma_rs<DP>(o, hi[kk], db);
    if constexpr (TRAIN) wgmma_rs<DP>(o, lo[kk], db);
  }
}

template <int DP, bool TRAIN>
__global__ void __launch_bounds__(kWgThreads, fwd_min_blocks(DP))
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o,
                       float* __restrict__ lse, float* __restrict__ out32,
                       int S, int d, int causal, int window, int kv_group,
                       float scale) {
  constexpr int ST = fwd_stages<DP, TRAIN>(), BK = fwd_keys<DP, TRAIN>();
  constexpr uint32_t TILE = wg_tile<DP>(), KT = fwd_ktile<DP, TRAIN>();
  constexpr uint32_t SLAB = BK * 128;  // a 64-column slab of a key tile
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t sq = base;                 // [wg] the block's q tiles
  const uint32_t stages = base + 2 * TILE;  // [stage] K tile, V tile
  const uint32_t full = stages + ST * 2 * KT;
  const uint32_t empty = full + ST * 8;
  const uint32_t fixed = empty + ST * 8;
  const int h = blockIdx.x, kvh = h / kv_group;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kWgRows;
  int klo, khi;
  meeting_tiles((S + BK - 1) / BK, BK, q0, kWgRows, false, causal, window,
                &klo, &khi);
  const int tiles = khi - klo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);   // the issuer's expect_tx + the bytes
      mbar_init(empty + 8 * s, 2);  // one arrival per warpgroup
    }
    mbar_init(fixed, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // tile j's K and V into its stage: 64 x 64 boxes, BK / 64 a slab
  auto issue = [&](int j) {
    const int s = j % ST, k0 = (klo + j) * BK;
    const uint32_t bar = full + 8 * s, tile = stages + s * 2 * KT;
    mbar_expect_tx(bar, 2 * KT);
    for (int b = 0; b < wg_slabs(DP); ++b)
      for (int r = 0; r < BK / 64; ++r) {
        const uint32_t at = tile + b * SLAB + r * kWgBox;
        tma_load_3d(at, &map_k, bar, 64 * b, k0 + 64 * r, kvh);
        tma_load_3d(at + KT, &map_v, bar, 64 * b, k0 + 64 * r, kvh);
      }
  };
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    mbar_expect_tx(fixed, 2 * TILE);
    for (int t = 0; t < 2; ++t)
      for (int b = 0; b < wg_slabs(DP); ++b)
        tma_load_3d(sq + t * TILE + b * kWgBox, &map_q, fixed, 64 * b,
                    q0 + 64 * t, h);
    for (int j = 0; j < tiles && j < ST; ++j) issue(j);
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int qw0 = q0 + 64 * wg;  // this warpgroup's 64 queries
  const int qr0 = qw0 + (t / 32) * 16 + lane / 4;  // this thread's rows
  const uint32_t qa = sq + wg * TILE;
  // [a, b): the block's tiles that meet this warpgroup's queries
  int a = 0, b = 0;
  for (int it = 0; it < tiles; ++it)
    if (tiles_meet(qw0, 64, (klo + it) * BK, BK, causal, window)) {
      if (b == 0) a = it;
      b = it + 1;
    }
  // this warpgroup is done with tiles [released, upto)
  int released = 0;
  auto release = [&](int upto) {
    for (; released < upto; ++released)
      release_stage<ST>(released, tiles, full, empty, t == 0, issuer, issue);
  };

  float o[DP / 2], s[BK / 2], m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  float alpha[2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
  const float sl2 = scale * kFwdLog2e;
  auto softmax = [&](int it) {
    const int k0 = (klo + it) * BK;
    if (fwd_tile_live<BK>(qw0, k0, S, causal, window))
      fwd_softmax<BK, false>(s, m, l, alpha, qr0, k0, S, causal, window,
                             sl2);
    else
      fwd_softmax<BK, true>(s, m, l, alpha, qr0, k0, S, causal, window,
                            sl2);
  };
  auto stage_of = [&](int it) { return stages + (it % ST) * 2 * KT; };
  auto landed = [&](int it) { stage_landed<ST>(full, it); };
  mbar_wait(fixed, 0);
  release(a);
  if (a < b) {
    landed(a);
    wgmma_fence();
    fwd_scores<DP, BK>(s, qa, stage_of(a));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(a);
    pack_p<BK, TRAIN>(s, ph, pl);
    for (int it = a + 1; it < b; ++it) {
      landed(it);
      // S of tile it, then P V of tile it - 1
      fence_regs(o);
      wgmma_fence();
      fwd_scores<DP, BK>(s, qa, stage_of(it));
      wgmma_commit();
      wgmma_pv<DP, BK, TRAIN>(o, ph, pl, stage_of(it - 1) + KT);
      wgmma_commit();
      wgmma_wait<1>();  // S is done (groups complete in order)
      fence_regs(s);
      softmax(it);
      wgmma_wait<0>();  // P V is done: rescale, new fragments
      fence_regs(o);
      fence_frags(ph);
      if constexpr (TRAIN) fence_frags(pl);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      pack_p<BK, TRAIN>(s, ph, pl);
      release(it);  // tile it - 1
    }
    fence_regs(o);
    wgmma_fence();
    wgmma_pv<DP, BK, TRAIN>(o, ph, pl, stage_of(b - 1) + KT);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_frags(ph);
    if constexpr (TRAIN) fence_frags(pl);
    release(b);
  }
  release(tiles);

  // every product reading the warpgroup's q tile is done: the output goes
  // there, 128-byte swizzled as the TMA box (16-byte chunk c of row r at
  // chunk c ^ (r % 8)), then out by TMA
  named_barrier(1 + wg, 128);
  const int tq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qr0 + 8 * r, row = qp - qw0;
    const float den = fmaxf(l[r], 1e-30f);
    float val[DP / 4];
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      val[2 * i] = o[4 * i + 2 * r] / den;
      val[2 * i + 1] = o[4 * i + 2 * r + 1] / den;
    }
    if constexpr (TRAIN) {
      if (qp < S) {
        // m is in base 2
        if (tq == 0)
          lse[(long long)h * S + qp] = m[r] / kFwdLog2e + logf(den);
        float* orow = out32 + ((long long)h * S + qp) * d + 2 * tq;
#pragma unroll
        for (int i = 0; i < DP / 8; ++i)
          if (8 * i < d)
            *reinterpret_cast<float2*>(orow + 8 * i) =
                make_float2(val[2 * i], val[2 * i + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
      st_shared_u32(qa + (i / 8) * kWgBox + row * 128 +
                        (((i % 8) ^ (row % 8)) * 16) + 4 * tq,
                    pack_bf16(val[2 * i], val[2 * i + 1]));
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (t == 0) {
    for (int bx = 0; bx < wg_slabs(DP); ++bx)
      tma_store_3d(&map_o, qa + bx * kWgBox, 64 * bx, qw0, h);
    tma_store_drain();
  }
}

template <int DP, bool TRAIN>
int launch_fwd_wgmma_as(const void* q, const void* k, const void* v,
                        void* out, void* lse, void* out32, int H, int S,
                        int d, int causal, int window, int kv_group,
                        float scale, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mo;
  if (!head_map(&mq, q, H, S, d) || !head_map(&mk, k, H / kv_group, S, d) ||
      !head_map(&mv, v, H / kv_group, S, d) || !head_map(&mo, out, H, S, d))
    return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = fwd_smem_bytes<DP, TRAIN>();
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)flash_fwd_wgmma_kernel<DP, TRAIN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, (S + kWgRows - 1) / kWgRows);
  flash_fwd_wgmma_kernel<DP, TRAIN><<<grid, kWgThreads, bytes, s>>>(
      mq, mk, mv, mo, (float*)lse, (float*)out32, S, d, causal, window,
      kv_group, scale);
  return (int)cudaGetLastError();
}

// serving (lse null) or training (lse and out32 given)
template <int DP>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     void* lse, void* out32, int H, int S, int d, int causal,
                     int window, int kv_group, float scale, cudaStream_t s) {
  return lse == nullptr
             ? launch_fwd_wgmma_as<DP, false>(q, k, v, out, lse, out32, H, S,
                                              d, causal, window, kv_group,
                                              scale, s)
             : launch_fwd_wgmma_as<DP, true>(q, k, v, out, lse, out32, H, S,
                                             d, causal, window, kv_group,
                                             scale, s);
}

// the wgmma kernels' padded head dim for d: 64, 128 or 160
constexpr int wgmma_dp(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 160; }

// Whether forward route `route` takes this call (see the note at the top):
// 0 wgmma + TMA (d % 8 == 0 up to 160; its tensor maps need q, k, v and
// out on 16-byte boundaries and rows of a multiple of 16 bytes, and
// out32's rows are written 8 bytes at a time), 1 mma.sync, 2 SIMT
bool fwd_route_fits(int route, int dtype, int d, const void* q, const void* k,
                    const void* v, const void* out, const void* out32) {
  switch (route) {
    case 0:
      return dtype == 1 && d % 8 == 0 && d <= 160 &&
             (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
               (uintptr_t)out32) & 15) == 0;
    case 1:
      return dtype == 1;
    case 2:
      return dtype == 0;
    default:
      return false;
  }
}

// Whether backward route `route` takes this call (see the note at the top):
// 0 wgmma + TMA (bf16, d % 8 == 0 up to 160, 16-byte boundaries), 1
// mma.sync (bf16 to 160), 2 SIMT (float32, bf16 past 160)
bool bwd_route_fits(int route, int dtype, int d, const void* q, const void* k,
                    const void* v, const void* dout, const void* dq,
                    const void* dk, const void* dv) {
  switch (route) {
    case 0:
      return dtype == 1 && d % 8 == 0 && d <= 160 &&
             (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
               (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) & 15) == 0;
    case 1:
      return dtype == 1 && d <= 160;
    case 2:
      return dtype == 0 || d > 160;
    default:
      return false;
  }
}

}  // namespace

// Launches on `stream` with `device` current, on route `route` (0 wgmma +
// TMA, 1 mma.sync, 2 SIMT; the caller's rule is repro_torch.kernels.
// flash_attention.fwd_route); returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a dtype code other than 0 or 1, d outside
// [1, 256], a kv_group that does not divide H, a grid the card cannot take
// or a route this call cannot take (fwd_route_fits; never replaced by
// another).  float32 runs the SIMT kernel (8 or 16 output columns a
// thread); bfloat16 the wgmma kernel (DP 64, 128 or 160, the next at or
// above d), or the mma.sync one with the head dim padded to 32, 64, 128,
// 160 or 256.  `lse` (float32, H
// x S) is written when not null; in bfloat16 it comes with `out32`
// (float32, H x S x d, the output before its cast; null in float32) and
// the training instantiation (see flash_attention_tc_kernel).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      void* out32, int H, int S, int d,
                                      int causal, int window, int kv_group,
                                      float scale, int dtype, int route,
                                      int device, void* stream) {
  if (H <= 0 || S <= 0) return 0;
  if (d < 1 || d > DMAX || kv_group < 1 || H % kv_group != 0 ||
      (S + BQ - 1) / BQ > 65535 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && (lse == nullptr) != (out32 == nullptr)) ||
      !fwd_route_fits(route, dtype, d, q, k, v, out, out32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    if (route == 0) {
      if (wgmma_dp(d) == 64)
        return launch_fwd_wgmma<64>(q, k, v, out, lse, out32, H, S, d, causal,
                                    window, kv_group, scale, s);
      if (wgmma_dp(d) == 128)
        return launch_fwd_wgmma<128>(q, k, v, out, lse, out32, H, S, d,
                                     causal, window, kv_group, scale, s);
      return launch_fwd_wgmma<160>(q, k, v, out, lse, out32, H, S, d, causal,
                                   window, kv_group, scale, s);
    }
    if (dtype == 0)
      return d <= 128 ? launch_simt<float, 8>(q, k, v, out, lse, H, S, d,
                                              causal, window, kv_group, scale,
                                              s)
                      : launch_simt<float, 16>(q, k, v, out, lse, H, S, d,
                                               causal, window, kv_group,
                                               scale, s);
    if (d <= 32)
      return launch_tc<32>(q, k, v, out, lse, out32, H, S, d, causal, window,
                           kv_group, scale, s);
    if (d <= 64)
      return launch_tc<64>(q, k, v, out, lse, out32, H, S, d, causal, window,
                           kv_group, scale, s);
    if (d <= 128)
      return launch_tc<128>(q, k, v, out, lse, out32, H, S, d, causal, window,
                            kv_group, scale, s);
    if (d <= 160)
      return launch_tc<160>(q, k, v, out, lse, out32, H, S, d, causal, window,
                            kv_group, scale, s);
    return launch_tc<256>(q, k, v, out, lse, out32, H, S, d, causal, window,
                          kv_group, scale, s);
  });
}

// The backward (see the note at the top): dq (H, S, d), dk and dv (H /
// kv_group, S, d) from q, k, v, out32 (the forward's output in float32:
// its out32, or its out in float32), dout (the gradient of out) and lse
// (float32, H x S, from the forward), with `delta` a float32 H x S scratch
// the caller allocates, on route `route` (0 wgmma + TMA, 1 mma.sync, 2
// SIMT; the caller's rule is repro_torch.kernels.flash_attention.
// bwd_route).  Same types, layouts, masks and returns as
// flash_attention_launch, and cudaErrorInvalidValue for a route this call
// cannot take.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out32,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int H, int S, int d, int causal, int window, int kv_group,
    float scale, int dtype, int route, int device, void* stream) {
  if (H <= 0 || S <= 0) return 0;
  if (d < 1 || d > DMAX || kv_group < 1 || H % kv_group != 0 ||
      (S + BQB - 1) / BQB > 65535 || (dtype != 0 && dtype != 1) ||
      !bwd_route_fits(route, dtype, d, q, k, v, dout, dq, dk, dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    if (route == 0) {
      if (wgmma_dp(d) == 64)
        return launch_bwd_wgmma<64>(q, k, v, out32, dout, lse, dq, dk, dv,
                                    delta, H, S, d, causal, window, kv_group,
                                    scale, s);
      if (wgmma_dp(d) == 128)
        return launch_bwd_wgmma<128>(q, k, v, out32, dout, lse, dq, dk, dv,
                                     delta, H, S, d, causal, window, kv_group,
                                     scale, s);
      return launch_bwd_wgmma<160>(q, k, v, out32, dout, lse, dq, dk, dv,
                                   delta, H, S, d, causal, window, kv_group,
                                   scale, s);
    }
    if (route == 1) {
      if (d <= 32)
        return launch_bwd_tc<32>(q, k, v, out32, dout, lse, dq, dk, dv,
                                 delta, H, S, d, causal, window, kv_group,
                                 scale, s);
      if (d <= 64)
        return launch_bwd_tc<64>(q, k, v, out32, dout, lse, dq, dk, dv,
                                 delta, H, S, d, causal, window, kv_group,
                                 scale, s);
      if (d <= 128)
        return launch_bwd_tc<128>(q, k, v, out32, dout, lse, dq, dk, dv,
                                  delta, H, S, d, causal, window, kv_group,
                                  scale, s);
      return launch_bwd_tc<160>(q, k, v, out32, dout, lse, dq, dk, dv, delta,
                                H, S, d, causal, window, kv_group, scale, s);
    }
    if (dtype == 1)
      return launch_bwd<__nv_bfloat16, 2, 16>(q, k, v, out32, dout, lse, dq,
                                              dk, dv, delta, H, S, d, causal,
                                              window, kv_group, scale, s);
    if (d <= 64)
      return launch_bwd<float, 4, 4>(q, k, v, out32, dout, lse, dq, dk, dv,
                                     delta, H, S, d, causal, window,
                                     kv_group, scale, s);
    if (d <= 128)
      return launch_bwd<float, 4, 8>(q, k, v, out32, dout, lse, dq, dk, dv,
                                     delta, H, S, d, causal, window,
                                     kv_group, scale, s);
    return launch_bwd<float, 2, 16>(q, k, v, out32, dout, lse, dq, dk, dv,
                                    delta, H, S, d, causal, window, kv_group,
                                    scale, s);
  });
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
