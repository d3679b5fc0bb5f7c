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
// Semantics:
// * opcodes outside [0, 20) give 0.0, as the where-ladder does;
// * and/or/xor/not truncate to int32 with __float2int_rz (toward zero);
//   not is ~a & 0xFFFF; shl/shr are a*2 and a/2; cmp is (float)(a > b);
//   select is a != 0 ? b : c;
// * mac is a*b + c with two roundings: the library is built with
//   --fmad=false so nvcc does not contract it into an FMA, and the result
//   equals the plain PyTorch version bit for bit.
// Float-to-int conversion of NaN or of values outside int32 differs
// between XLA, PyTorch on the CPU and CUDA; simulated values stay far
// inside int32 (up to ~1e5), and the tests use in-range inputs.

#include <cuda_runtime.h>

#include "device_guard.cuh"

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
    const float x = a[i];
    const float y = b[i];
    const float z = c[i];
    const float l = leaf[i];
    float r;
    switch (opcode[i]) {
      case 0:   // const
      case 1:   // input
      case 2:   // load
        r = l;
        break;
      case 3:   // store
      case 4:   // output
        r = x;
        break;
      case 5: r = x + y; break;                                   // add
      case 6: r = x - y; break;                                   // sub
      case 7: r = x * y; break;                                   // mul
      case 8: r = x * y + z; break;                               // mac
      case 9: r = x * 2.0f; break;                                // shl
      case 10: r = x / 2.0f; break;                               // shr
      case 11: r = (float)(__float2int_rz(x) & __float2int_rz(y)); break;
      case 12: r = (float)(__float2int_rz(x) | __float2int_rz(y)); break;
      case 13: r = (float)(__float2int_rz(x) ^ __float2int_rz(y)); break;
      case 14: r = (float)(~__float2int_rz(x) & 0xFFFF); break;   // not
      // min/max propagate NaN like torch.minimum/jnp.minimum (fminf would not)
      case 15: r = (x != x || y != y) ? x + y : fminf(x, y); break;
      case 16: r = (x != x || y != y) ? x + y : fmaxf(x, y); break;
      case 17: r = fabsf(x); break;                               // abs
      case 18: r = x > y ? 1.0f : 0.0f; break;                    // cmp
      case 19: r = x != 0.0f ? y : z; break;                      // select
      default: r = 0.0f; break;
    }
    out[i] = r;
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
