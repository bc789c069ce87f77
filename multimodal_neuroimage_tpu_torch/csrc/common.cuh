// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function (no PyTorch headers): the Python
// side loads the shared library with ctypes, allocates every output and
// scratch buffer with torch.empty, passes raw device pointers and the
// current stream, and raises when the returned cudaError_t is not 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define MNT_FULL_MASK 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(MNT_FULL_MASK, v, off);
  return v;
}

// Exact (erf) GELU, torch.nn.GELU's default. CUDA has erff, so the
// Abramowitz-Stegun erf the TPU kernels needed (Mosaic has none) is gone.
__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
