// The batched simulator's ALU: one opcode applied to one lane's three
// gathered operands and its leaf value.  The one copy of these semantics,
// shared by sim_alu.cu (the ALU stage alone) and sim_loop.cu (the whole
// cycle loop); the library's build hash covers this header
// (repro_torch/kernels/_build.py).
//
// The opcode numbering is repro_torch.sim.lower.OPS; the plain version is
// repro_torch.kernels.ref.sim_alu.
// * opcodes outside [0, 20) give 0.0, as the where-ladder does;
// * and/or/xor/not truncate to int32 with __float2int_rz (toward zero);
//   not is ~a & 0xFFFF; shl/shr are a*2 and a/2; cmp is (float)(a > b);
//   select is a != 0 ? b : c;
// * mac is a*b + c with two roundings: every library is built with
//   --fmad=false so nvcc does not contract it into an FMA, and the result
//   equals the plain PyTorch version bit for bit.
// Float-to-int conversion of NaN or of values outside int32 differs
// between XLA, PyTorch on the CPU and CUDA; simulated values stay far
// inside int32 (up to ~1e5), and the tests use in-range inputs.
#pragma once

#include <math.h>

__device__ __forceinline__ float sim_alu_op(int opcode, float x, float y,
                                            float z, float l) {
  switch (opcode) {
    case 0:   // const
    case 1:   // input
    case 2:   // load
      return l;
    case 3:   // store
    case 4:   // output
      return x;
    case 5: return x + y;                                          // add
    case 6: return x - y;                                          // sub
    case 7: return x * y;                                          // mul
    case 8: return x * y + z;                                      // mac
    case 9: return x * 2.0f;                                       // shl
    case 10: return x / 2.0f;                                      // shr
    case 11: return (float)(__float2int_rz(x) & __float2int_rz(y));
    case 12: return (float)(__float2int_rz(x) | __float2int_rz(y));
    case 13: return (float)(__float2int_rz(x) ^ __float2int_rz(y));
    case 14: return (float)(~__float2int_rz(x) & 0xFFFF);          // not
    // min/max propagate NaN like torch.minimum/jnp.minimum (fminf would not)
    case 15: return (x != x || y != y) ? x + y : fminf(x, y);
    case 16: return (x != x || y != y) ? x + y : fmaxf(x, y);
    case 17: return fabsf(x);                                      // abs
    case 18: return x > y ? 1.0f : 0.0f;                           // cmp
    case 19: return x != 0.0f ? y : z;                             // select
    default: return 0.0f;
  }
}
