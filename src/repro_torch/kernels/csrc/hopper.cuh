// Hopper's TMA, mbarrier and wgmma plumbing, shared by fused_swiglu.cu
// (the tensor-core route of the gate) and flash_attention.cu (the bf16
// forward and backward on wgmma); rmsnorm.cu takes its named barrier.  The
// library's build hash covers this header (repro_torch/kernels/_build.py).
//
// * a named barrier over some of a block's warps;
// * mbarriers: init, expect_tx, arrive, and a parity wait that traps (a
//   launch failure) after kMbarMaxSpins polls instead of hanging the card
//   when a pipeline deadlocks;
// * TMA tile loads (cp.async.bulk.tensor, 2-D and 3-D) completing on an
//   mbarrier, 3-D TMA stores from shared memory (with the proxy fence
//   that must precede them), and tensor maps of row-major bf16 encoded per
//   call through cuTensorMapEncodeTiled, which is looked up at run time
//   (cudaGetDriverEntryPoint): the libraries are not linked against
//   libcuda;
// * the wgmma shared-memory descriptor under the 128-byte swizzle, the
//   fence / commit / wait of a warpgroup's products, and a register fence
//   that keeps the compiler from moving reads or writes of registers that
//   an asynchronous product still uses.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a deadlocked pipeline traps (a launch failure) instead of hanging the card
constexpr uint32_t kMbarMaxSpins = 1u << 26;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == kMbarMaxSpins) __trap();
  }
}

// the box of `map` at (c0, c1) into shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1) : "memory");
}

// the same at (c0, c1, c2) of a 3-D map
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// the box of a 3-D `map` at (c0, c1, c2) from shared memory at src; boxes
// past the map's bounds are clipped.  Commit and wait (tma_store_drain)
// before the shared memory is reused or the block exits.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// commit this thread's TMA stores and wait until they have read their
// shared memory
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// this thread's ordinary writes to shared memory, made visible to the TMA
// (the async proxy): before the barrier that precedes a TMA store
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// bar.sync on barrier `id` (1..15; 0 is __syncthreads') for `threads`
// threads, a multiple of 32
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed product groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of these registers across
// the asynchronous products (accumulators, and A operands held in
// registers until the products reading them are done)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once at run time: the library is not
// linked against libcuda
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? (EncodeTiled)p : (EncodeTiled) nullptr;
  }();
  return fn;
}

// A row-major bf16 array of `rank` dimensions (dims innermost first, byte
// strides of the outer ones) read in boxes of `box`, 128-byte swizzle; reads
// outside it give zeros.
inline bool bf16_tensor_map(CUtensorMap* map, const void* ptr, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (rows, cols) bf16 matrix read in boxes of box_rows x 64
// columns (128 bytes, the swizzle's width).
inline bool tensor_map(CUtensorMap* map, const void* ptr, int rows,
                       int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return bf16_tensor_map(map, ptr, 2, dims, strides, box);
}

}  // namespace
