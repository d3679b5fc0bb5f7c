// The Plaid PCU running a motif schedule, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/motif_pcu.py::motif_pcu (body
// _kernel): inputs (n_inputs, N) row-major, the N loop iterations side by
// side; a schedule of steps (dst, op, a, b) runs over a float32 value table
// of n_slots = n_inputs + steps slots per iteration, table[dst] =
// op(table[a], table[b]); out (n_slots, N) is the whole table, cast to the
// inputs' type once.  Slots start at zero, so a slot read before it is
// written gives 0 (the TPU kernel leaves whatever VMEM held).  The plain
// version is repro_torch.kernels.ref.motif_pcu.
//
// Bound: bytes.  Each iteration reads its n_inputs inputs and writes its
// n_slots slots, (n_inputs + n_slots) x 4 bytes in float32, for one
// operation per step; at (3, 2^24) with a 3-step schedule that is 603,979,776
// bytes, 0.180 ms over 3.35 TB/s.
// Design: one thread per iteration n, in a grid-stride loop, so the loads of
// in[i*N + n] and the stores of out[s*N + n] coalesce across the warp; the
// ragged tail is masked, any N >= 1 runs.  The value table stays on chip, as
// the TPU kernel keeps it in VMEM: each block holds it in dynamic shared
// memory laid out [slot][thread] (neighbouring threads in neighbouring
// banks, no conflicts), and every slot goes to device memory exactly once,
// at the end, so the kernel moves only the bytes of the bound.  The schedule
// is data: an int32 (steps, 4) array of rows (dst, opcode, a, b), which each
// block copies into shared memory once; the switch on the opcode is uniform
// across the block, so warps do not diverge.  Specialising the kernel per
// schedule (a template, or the table in registers) is left to a later
// change.  Shared memory per block is steps x 16 + n_slots x 256 x 4 bytes:
// at most 223 slots fit the 232,448 bytes a block can have, and above
// 48 KB the launch raises the kernel's dynamic limit first.  The indices are
// trusted: the wrapper (repro_torch.kernels.motif_pcu) checks 0 <= a, b <
// dst < n_slots and the opcodes.
//
// Ops, numbered in the order of repro_torch.kernels.ref.PCU_OPS; the ALU
// cases are copied from csrc/sim_alu.cu (this file stays self-contained,
// since the build hashes only <name>.cu):
// * add, sub, mul in IEEE float32, no contraction (built with --fmad=false,
//   never with fast math);
// * max/min return a NaN operand as it is (the first if both are), as
//   torch.maximum does; fmaxf alone would drop it;
// * and/or/xor truncate to int32 toward zero (__float2int_rz) and convert
//   back; values outside int32 or NaN convert differently on each platform,
//   so callers keep them in range;
// * shl is a*2, shr is a/2.
//
// dtype code: 0 = float32, 1 = bfloat16 (inputs and out share it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 223;
constexpr long long kMaxBlocks = 132LL * 8;  // 8 resident blocks per SM
constexpr size_t kStaticSmem = 48 * 1024;

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

__device__ __forceinline__ float pcu_op(int op, float x, float y) {
  switch (op) {
    case 0: return x + y;                                         // add
    case 1: return x - y;                                         // sub
    case 2: return x * y;                                         // mul
    case 3: return x != x ? x : (y != y ? y : fmaxf(x, y));       // max
    case 4: return x != x ? x : (y != y ? y : fminf(x, y));       // min
    case 5: return (float)(__float2int_rz(x) & __float2int_rz(y));  // and
    case 6: return (float)(__float2int_rz(x) | __float2int_rz(y));  // or
    case 7: return (float)(__float2int_rz(x) ^ __float2int_rz(y));  // xor
    case 8: return x * 2.0f;                                      // shl
    case 9: return x / 2.0f;                                      // shr
    default: return 0.0f;
  }
}

size_t smem_bytes(int steps, int n_slots) {
  return sizeof(int4) * (size_t)steps +
         sizeof(float) * (size_t)n_slots * kThreads;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
motif_pcu_kernel(const T* __restrict__ in, const int4* __restrict__ sched,
                 T* __restrict__ out, int steps, int n_inputs, int n_slots,
                 long long N) {
  extern __shared__ int4 smem[];
  int4* s_sched = smem;                                   // [steps]
  float* col = reinterpret_cast<float*>(smem + steps) + threadIdx.x;
  // this thread's slot s is col[s * kThreads]

  for (int k = threadIdx.x; k < steps; k += kThreads) s_sched[k] = sched[k];
  __syncthreads();

  const long long stride = (long long)kThreads * gridDim.x;
  for (long long n = (long long)blockIdx.x * kThreads + threadIdx.x; n < N;
       n += stride) {
    for (int s = 0; s < n_inputs; ++s) col[s * kThreads] = to_f32(in[s * N + n]);
    for (int s = n_inputs; s < n_slots; ++s) col[s * kThreads] = 0.0f;
    for (int k = 0; k < steps; ++k) {
      const int4 st = s_sched[k];  // (dst, opcode, a, b)
      col[st.x * kThreads] =
          pcu_op(st.y, col[st.z * kThreads], col[st.w * kThreads]);
    }
    for (int s = 0; s < n_slots; ++s)
      out[s * N + n] = from_f32<T>(col[s * kThreads]);
  }
}

template <typename T>
int launch(const void* in, const void* sched, void* out, int steps,
           int n_inputs, long long N, cudaStream_t s) {
  const int n_slots = n_inputs + steps;
  const size_t bytes = smem_bytes(steps, n_slots);
  if (bytes > kStaticSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)motif_pcu_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  motif_pcu_kernel<T><<<(unsigned)blocks, kThreads, bytes, s>>>(
      (const T*)in, (const int4*)sched, (T*)out, steps, n_inputs, n_slots, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` with `device` current; `sched` is a device array of
// `steps` int32 rows (dst, opcode, a, b).  Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a dtype code other than 0 or 1,
// negative counts, or more than 223 slots.
extern "C" int motif_pcu_launch(const void* in, const void* sched, void* out,
                                int steps, int n_inputs, long long N,
                                int dtype, int device, void* stream) {
  if (steps < 0 || n_inputs < 0 || n_inputs + steps > kMaxSlots ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return on_device(device, [&] {
    return dtype == 0
               ? launch<float>(in, sched, out, steps, n_inputs, N, s)
               : launch<__nv_bfloat16>(in, sched, out, steps, n_inputs, N, s);
  });
}

extern "C" const char* motif_pcu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
