// ALU stage of the batched simulator's cycle loop, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/sim_alu.py::sim_alu (body
// _kernel): out[i] = OPS[opcode[i]](a[i], b[i], c[i], leaf[i]) over every
// (mapping, node) lane of one simulated cycle.  The opcode numbering is
// repro_torch.sim.lower.OPS; the plain version is
// repro_torch.kernels.ref.sim_alu.
//
// Bound: memory.  Each element reads one int32 opcode and four float32
// operands and writes one float32 result (24 bytes) for about one
// arithmetic operation, far below the card's operations-per-byte balance.
// Design: one thread per element in a grid-stride loop, neighbouring
// threads on neighbouring addresses so every load and store coalesces;
// the opcode selects one case of a switch.  Lanes of one warp that hold
// different opcodes diverge, which costs issue slots but no extra memory
// traffic, and memory is the bound.  The TPU version's 8x128 padding is
// gone: the kernel takes any element count.
//
// Semantics: sim_alu.cuh, shared with the whole-loop kernel sim_loop.cu.

#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "sim_alu.cuh"

namespace {

__global__ void sim_alu_kernel(const int* __restrict__ opcode,
                               const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ c,
                               const float* __restrict__ leaf,
                               float* __restrict__ out, long long n) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = sim_alu_op(opcode[i], a[i], b[i], c[i], leaf[i]);
  }
}

}  // namespace

// Launches on `stream` with `device` current and returns
// cudaGetLastError() (0 on success).
extern "C" int sim_alu_launch(const void* opcode, const void* a, const void* b,
                              const void* c, const void* leaf, void* out,
                              long long n, int device, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  return on_device(device, [&] {
    sim_alu_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)opcode, (const float*)a, (const float*)b, (const float*)c,
        (const float*)leaf, (float*)out, n);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* sim_alu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
