// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function (no PyTorch headers): the Python
// side loads the shared library with ctypes, allocates every output and
// scratch buffer with torch.empty, passes raw device pointers and the
// current stream, and raises when the returned cudaError_t is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MNT_FULL_MASK 0xffffffffu

// One dropout draw of the JAX package's coordinate hash
// (ops/fusion_block.py _mix_keep): murmur3 fmix32 of
//   seed * 0x9E3779B9 ^ (draw + 1) * 0xCC9E2D51 ^ r * 461845907 ^ c * 668265261
// in wrapping 32-bit arithmetic (the JAX int32 products bit for bit); an
// element is kept iff the hash >= thr = min(int(rate * 2^32), 2^32 - 1) and
// then scaled by 1 / (1 - rate). Off (rate 0 or not training): factor 1.
struct Dropout {
  uint32_t base;   // seed and draw part of the hash
  uint32_t thr;
  float scale;
  int on;
};

static inline Dropout make_dropout(int seed, int draw, double rate) {
  Dropout d;
  d.base = (uint32_t)seed * 0x9E3779B9u ^ (uint32_t)(draw + 1) * 0xCC9E2D51u;
  const double t = rate * 4294967296.0;
  d.thr = t >= 4294967295.0 ? 0xFFFFFFFFu : (uint32_t)t;
  d.scale = (float)(1.0 / (1.0 - rate));
  d.on = rate > 0.0;
  return d;
}

// The hash in two parts, for a kernel that hoists a row's part out of its
// loop over columns: keep_at(d, keep_row(d, r), c) is keep(d, r, c) with
// dropout on.
__device__ __forceinline__ uint32_t keep_row(const Dropout& d, uint32_t r) {
  return d.base ^ (r * 461845907u);
}

__device__ __forceinline__ float keep_at(const Dropout& d, uint32_t row, uint32_t c) {
  uint32_t u = row ^ (c * 668265261u);
  u ^= u >> 16;
  u *= 0x85EBCA6Bu;
  u ^= u >> 13;
  u *= 0xC2B2AE35u;
  u ^= u >> 16;
  return u >= d.thr ? d.scale : 0.f;
}

__device__ __forceinline__ float keep(const Dropout& d, uint32_t r, uint32_t c) {
  if (!d.on) return 1.f;
  return keep_at(d, keep_row(d, r), c);
}

// out[e] = (add ? add[e] : 0) + sum_s part[s * n + e], s in order: the second
// pass of every cross-block reduction, so that gradients are bitwise the same
// from run to run (no float atomics anywhere in the port).
static __global__ void reduce_partials_kernel(const float* __restrict__ part, int S, long long n,
                                              const float* __restrict__ add,
                                              float* __restrict__ out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = add ? add[e] : 0.f;
    for (int i = 0; i < S; ++i) s += part[(long long)i * n + e];
    out[e] = s;
  }
}

static inline cudaError_t reduce_partials(const float* part, int S, long long n, const float* add,
                                          float* out, cudaStream_t stream) {
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  reduce_partials_kernel<<<(int)blocks, 256, 0, stream>>>(part, S, n, add, out);
  return cudaGetLastError();
}

// Derivative of the exact GELU.
__device__ __forceinline__ float gelu_erf_grad(float u) {
  return 0.5f * (1.0f + erff(u * 0.70710678118654752f)) +
         u * expf(-0.5f * u * u) * 0.39894228040143268f;
}

// x rounded to bfloat16 (to nearest, ties to even, as jnp's astype and
// torch's .to(torch.bfloat16)) and widened back: the operand rounding of the
// bf16 policy's products (mm16), whose products of two such values are
// exact in float32.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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
