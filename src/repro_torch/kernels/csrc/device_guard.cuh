// The device guard of every kernel's C entry.
//
// Each `<name>_launch` takes the CUDA device index of its tensors and runs
// its launch with that device current on the calling thread, then makes
// the caller's device current again.  On a card that is already current
// this is one cudaGetDevice call.  The library's build hash covers this
// header (repro_torch/kernels/_build.py).
#pragma once

#include <cuda_runtime.h>

// Runs `launch()` (a cudaError_t as int) on `device`; the first failure
// wins.
template <typename F>
inline int on_device(int device, F&& launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const int rc = launch();
  if (prev != device && (err = cudaSetDevice(prev)) != cudaSuccess && rc == 0)
    return (int)err;
  return rc;
}
