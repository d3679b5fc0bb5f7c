// The batched simulator's whole cycle loop for Hopper (sm_90a): one launch
// runs every cycle of every mapping of a bucket.
//
// Replaces, on the verify path, the Pallas kernel repro/kernels/sim_alu.py::
// sim_alu together with the loop around it (repro/sim/step.py::_jit_runner,
// whose eager port is repro_torch.sim.step.run_bucket_eager: about seventy
// small launches per simulated cycle plus sim_alu's one).  The plain version
// is that eager loop with repro_torch.kernels.ref.sim_alu as its ALU.
//
// The state of mapping b is the eager loop's, in its flat layout:
//   val   [B][N + 2][I] float32  produced values; row N is the read
//                                sentinel (always 0), row N + 1 unused;
//   done  [B][N + 2][I] byte     which (node, iteration) values exist;
//   avail [B][S + 2][I] byte     which route-step reservations hold a
//                                readable value; row S is the sentinel;
//   fail  [B] byte               sticky read failure.
// No dump rows are needed: a lane that is masked off simply does not write.
//
// Per cycle t < horizon[b], in the eager loop's order (repro_torch.sim.step.
// _cycle), with a block barrier wherever the eager loop has an implicit one:
// 1. phase 1: each node that issues at t (exec_mask, issue <= t, (t -
//    issue) % ii == 0, q = (t - issue) / ii < I) gathers every operand: a
//    routed one reads val[src][q - dist] and is present iff one of its M
//    matched route steps holds iteration q - dist; a missing routed read or
//    an exercised broken edge sets fail; a feed is op_feed + q in float32;
//    then the ALU (sim_alu.cuh) on the first three operands and leaf + q.
//    The results are staged, one slot per node;
// 2. barrier; the staged values go to val and done (each node writes its
//    own row, so no two lanes collide); barrier;
// 3. phase 2: each route step whose iteration kq = (t + 1 - step_abs) / ii
//    becomes readable at t + 1 sets avail[step][kq] iff its producer's
//    value exists; barrier.
// Mapping b never reads mapping b''s state, so one block owns one mapping
// and runs all its cycles; it stops at its own horizon.  C's / truncates
// where the eager loop floors, so both divisions are guarded by a
// non-negative dividend.  The values equal the eager loop's bit for bit:
// the same ALU, built with --fmad=false, and the same float32 adds.
//
// Where the state lives: in shared memory when one mapping's state and its
// staged results fit the card's opt-in limit ((N + 2) I 5 + (S + 2) I +
// 8 N bytes: about 3 KB at the corpus bucket (N, S, I) = (64, 512, 3)), with
// val and done copied out once at the end; otherwise in the block's own
// slice of the output buffers and of the scratch buffers `avail` and
// `stage`, the same code through other pointers.  Every bucket the eager
// loop runs is taken, up to 2^31 elements of val or avail per mapping.
//
// The statics (opcode, issue, op_kind, op_src, op_dist, op_feed, op_steps,
// step_src, step_abs, ...) are read through the read-only path; the kernel
// computes each mapping's offsets itself.
//
// Bound: the statics are read once and the outputs written once: about
// 4.7 MB at the corpus bucket (B = 203, K = 3, M = 17), 1.4 us at 3.35 TB/s.
// The real limit is latency: a chain of horizon dependent cycles, each with
// three block barriers and a few dependent loads from L1 and shared memory
// (chip_smoke.py times that chain alone on a one-node bucket).
// Design: one block of 256 threads per mapping, a thread per node in phase
// 1 and per route step in phase 2; at the corpus bucket all 203 blocks are
// resident at once.  A node's thread runs its K x M presence checks in
// series, and the statics are read again on every cycle.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "sim_alu.cuh"

namespace {

constexpr int kThreads = 256;
// operand kinds (repro_torch.sim.lower.K_*)
constexpr int kFeed = 1, kRouted = 2, kBroken = 3;

struct Statics {
  const int* ii;               // (B)
  const int* horizon;          // (B)
  const int* opcode;           // (B, N)
  const uint8_t* exec_mask;    // (B, N)
  const int* issue;            // (B, N)
  const float* leaf;           // (B, N)
  const int8_t* op_kind;       // (B, N, K)
  const int* op_src;           // (B, N, K), sentinel N
  const int* op_dist;          // (B, N, K)
  const float* op_feed;        // (B, N, K)
  const int* op_steps;         // (B, N, K, M), sentinel S
  const int* step_src;         // (B, S), sentinel N
  const int* step_abs;         // (B, S), padded with 2^30
};

// One mapping's state and staged results in shared memory, in bytes.
size_t state_bytes(int N, int S, int I) {
  return (size_t)(N + 2) * I * 5 + (size_t)N * 8 + (size_t)(S + 2) * I;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
sim_loop_kernel(Statics st, float* val_g, uint8_t* done_g,
                uint8_t* avail_g, uint8_t* fail_g, int* stage_g, int N, int K,
                int M, int S, int I) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int fail_s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int NI = (N + 2) * I, SI = (S + 2) * I;
  float* gval = val_g + (long long)b * NI;
  uint8_t* gdone = done_g + (long long)b * NI;

  float* val;
  uint8_t *done, *avail;
  int* slot;     // per node: n * I + q when it issued this cycle, else -1
  float* newv;   // per node: its staged result
  if (kShared) {
    val = reinterpret_cast<float*>(smem);
    slot = reinterpret_cast<int*>(val + NI);
    newv = reinterpret_cast<float*>(slot + N);
    done = reinterpret_cast<uint8_t*>(newv + N);
    avail = done + NI;
  } else {
    val = gval;
    done = gdone;
    avail = avail_g + (long long)b * SI;
    slot = stage_g + (long long)b * 2 * N;
    newv = reinterpret_cast<float*>(slot + N);
  }
  for (int i = tid; i < NI; i += kThreads) {
    val[i] = 0.0f;
    done[i] = 0;
  }
  for (int i = tid; i < SI; i += kThreads) avail[i] = 0;
  if (tid == 0) fail_s = 0;

  const long long nb = (long long)b * N;
  const int* opcode = st.opcode + nb;
  const uint8_t* exec_mask = st.exec_mask + nb;
  const int* issue = st.issue + nb;
  const float* leaf = st.leaf + nb;
  const int8_t* op_kind = st.op_kind + nb * K;
  const int* op_src = st.op_src + nb * K;
  const int* op_dist = st.op_dist + nb * K;
  const float* op_feed = st.op_feed + nb * K;
  const int* op_steps = st.op_steps + nb * K * M;
  const int* step_src = st.step_src + (long long)b * S;
  const int* step_abs = st.step_abs + (long long)b * S;
  const int ii = __ldg(st.ii + b), horizon = __ldg(st.horizon + b);
  bool fail = false;
  __syncthreads();

  for (int t = 0; t < horizon; ++t) {
    // phase 1: gather and execute; nothing is written before the barrier
    for (int n = tid; n < N; n += kThreads) {
      int s = -1;
      float r = 0.0f;
      const int d = t - __ldg(issue + n);
      if (__ldg(exec_mask + n) && d >= 0) {
        const int q = d / ii;  // d >= 0: truncation is the floor
        if (d - q * ii == 0 && q < I) {
          float opv0 = 0.0f, opv1 = 0.0f, opv2 = 0.0f;
          for (int k = 0; k < K; ++k) {
            const int j = n * K + k;
            const int kind = __ldg(op_kind + j);
            const int want = q - __ldg(op_dist + j);
            const bool needs = want >= 0, in_range = needs && want < I;
            const int wc = min(max(want, 0), I - 1);
            float v = 0.0f;
            if (kind == kRouted) {
              const int* steps = op_steps + (long long)j * M;
              bool present = false;
#pragma unroll 4
              for (int m = 0; m < M; ++m)
                present |= avail[__ldg(steps + m) * I + wc] != 0;
              if (needs && !(present && in_range)) fail = true;
              if (in_range) v = val[__ldg(op_src + j) * I + wc];
            } else if (kind == kBroken) {
              if (needs) fail = true;
            } else if (kind == kFeed) {
              v = __ldg(op_feed + j) + (float)q;
            }
            if (k == 0) opv0 = v;
            else if (k == 1) opv1 = v;
            else if (k == 2) opv2 = v;
          }
          r = sim_alu_op(__ldg(opcode + n), opv0, opv1, opv2,
                         __ldg(leaf + n) + (float)q);
          s = n * I + q;
        }
      }
      slot[n] = s;  // this thread's own node: read back by this thread
      newv[n] = r;
    }
    __syncthreads();  // every gather of the cycle precedes every write
    for (int n = tid; n < N; n += kThreads) {
      const int s = slot[n];
      if (s >= 0) {
        val[s] = newv[n];
        done[s] = 1;
      }
    }
    __syncthreads();  // phase 2 sees phase 1's values
    // phase 2: route-step writes readable at t + 1
    for (int s = tid; s < S; s += kThreads) {
      const int kd = t + 1 - __ldg(step_abs + s);  // padding: far below 0
      if (kd >= 0) {
        const int kq = kd / ii;
        if (kd - kq * ii == 0 && kq < I && done[__ldg(step_src + s) * I + kq])
          avail[s * I + kq] = 1;
      }
    }
    __syncthreads();  // the next cycle's gathers see this cycle's avail
  }

  if (fail) fail_s = 1;
  __syncthreads();
  if (tid == 0) fail_g[b] = (uint8_t)(fail_s != 0);
  if (kShared) {
    for (int i = tid; i < NI; i += kThreads) {
      gval[i] = val[i];
      gdone[i] = done[i];
    }
  }
}

}  // namespace

// 1 when one mapping's state fits `device`'s opt-in shared memory (the
// static fail flag takes a few bytes of the same limit), 0 when it takes
// the global-memory variant, minus a CUDA error code when the limit cannot
// be read.
extern "C" int sim_loop_state_in_shared(int N, int S, int I, int device) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  return state_bytes(N, S, I) + 16 <= (size_t)optin ? 1 : 0;
}

// Runs every cycle of a bucket of B mappings on `stream` with `device`
// current; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape no bucket has (N < 1, K < 3, M < 0,
// S < 1, I < 1), one mapping's val or avail past 2^31 elements, or a
// missing scratch buffer.  val, done and fail are written in full; none
// needs zeroing.  avail (B x (S + 2) x I bytes) and stage (B x 2N int32)
// are the global-memory variant's scratch: null when the state fits
// shared memory (sim_loop_state_in_shared), never read back.
extern "C" int sim_loop_launch(
    const void* ii, const void* horizon, const void* opcode,
    const void* exec_mask, const void* issue, const void* leaf,
    const void* op_kind, const void* op_src, const void* op_dist,
    const void* op_feed, const void* op_steps, const void* step_src,
    const void* step_abs, void* val, void* done, void* avail, void* fail,
    void* stage, int B, int N, int K, int M, int S, int I, int device,
    void* stream) {
  if (B <= 0) return 0;
  if (N < 1 || K < 3 || M < 0 || S < 1 || I < 1 ||
      (long long)(N + 2) * I > INT_MAX || (long long)(S + 2) * I > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Statics st{(const int*)ii,       (const int*)horizon,
                   (const int*)opcode,   (const uint8_t*)exec_mask,
                   (const int*)issue,    (const float*)leaf,
                   (const int8_t*)op_kind, (const int*)op_src,
                   (const int*)op_dist,  (const float*)op_feed,
                   (const int*)op_steps, (const int*)step_src,
                   (const int*)step_abs};
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    const int in_shared = sim_loop_state_in_shared(N, S, I, device);
    if (in_shared < 0) return -in_shared;
    if (in_shared) {
      const size_t bytes = state_bytes(N, S, I);
      if (bytes > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            (const void*)sim_loop_kernel<true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
      }
      sim_loop_kernel<true><<<B, kThreads, bytes, s>>>(
          st, (float*)val, (uint8_t*)done, nullptr, (uint8_t*)fail, nullptr,
          N, K, M, S, I);
    } else {
      if (avail == nullptr || stage == nullptr)
        return (int)cudaErrorInvalidValue;
      sim_loop_kernel<false><<<B, kThreads, 0, s>>>(
          st, (float*)val, (uint8_t*)done, (uint8_t*)avail, (uint8_t*)fail,
          (int*)stage, N, K, M, S, I);
    }
    return (int)cudaGetLastError();
  });
}

extern "C" const char* sim_loop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
