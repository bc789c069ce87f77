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

// The keep decision of keep_at with the column's product cm = c * 668265261
// given (a loop over consecutive columns adds 668265261 a step).
__device__ __forceinline__ bool kept(const Dropout& d, uint32_t row, uint32_t cm) {
  uint32_t u = row ^ cm;
  u ^= u >> 16;
  u *= 0x85EBCA6Bu;
  u ^= u >> 13;
  u *= 0xC2B2AE35u;
  u ^= u >> 16;
  return u >= d.thr;
}

__device__ __forceinline__ float keep_at(const Dropout& d, uint32_t row, uint32_t c) {
  return kept(d, row, c * 668265261u) ? d.scale : 0.f;
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

// ---- bf16 tensor-core helpers (warp-level mma.sync m16n8k16 and ldmatrix),
// shared by K6's and K1's bf16 forms -----------------------------------------

__device__ __forceinline__ uint32_t tc_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lanes 8m .. 8m + 7 give the row addresses of matrix
// m. Lane l receives row l / 4, columns 2 (l % 4) and + 1 of each (.trans:
// column l / 4, rows 2 (l % 4) and + 1).
__device__ __forceinline__ void tc_ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc_smem(p))
               : "memory");
}

__device__ __forceinline__ void tc_ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc_smem(p))
               : "memory");
}

// c += a b: m16n8k16, bf16 operands, f32 accumulators. Fragments (g = lane
// / 4, t = lane % 4): a[e] holds row g + 8 (e & 1), columns 16-step + 8 (e >>
// 1) + 2t, + 1; b0 / b1 rows (k) 2t, + 1 / 2t + 8, + 9 of column g; c[e] row
// g + 8 (e >> 1), column 2t + (e & 1).
__device__ __forceinline__ void tc_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, one MUFU op (.ftz: a result below 2^-126 is 0, where the float32
// reference keeps a subnormal that adds nothing a bf16 output can hold)
__device__ __forceinline__ float tc_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
