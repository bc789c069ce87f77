// K8: a batched matrix product, C[b] = alpha * A[b] B[b], float32
// accumulation, operands float32 or rounded once to bfloat16.
//
// Replaces scripts/bench_dot_shapes.py _mk.run: the micro-benchmark that
// chains scores + context batched products of the fusion window attention in
// five formulations (cur, sm, st, ffold, flat) at the flagship's G = 8
// geometry. The TPU kernel kept a cell's whole chain in VMEM; on the card the
// cur operands alone are 737 KB a window, far past a block's 227 KB of shared
// memory, so a chain of `reps` pairs is 2 * reps launches of this kernel
// (ops/dot_shapes.py) with the scores going through device memory.
//
// Batch: two levels (outer, inner) with a stride each for A and B, so that a
// stride of 0 broadcasts an operand (the TPU kernel read block 0 of every
// input in every grid cell); C is contiguous. bf16: each operand element is
// scaled by its alpha and rounded to bfloat16 as it is loaded (the script's
// cast(S * 1e-3)); products of two bf16 values are exact in float32, so the
// f32 FMA accumulation gives the tensor-core result up to summation order.
//
// What bounds it on the H100: float32 operations (5.78 GFLOP a cur pair over
// 196 windows; 0.086 ms at 67 TFLOP/s). Design (a first, plain version):
// 64 x 64 output tiles, K in steps of 16 through shared memory, 256 threads
// each holding a 4 x 4 register tile; ragged M, N and K are masked at load.
// No tensor cores: the bf16 variants run at the f32 rate, so their bound
// (989 TFLOP/s bf16) is far off.
#include <cuda_bf16.h>

#include "common.cuh"

#define DOT_BM 64
#define DOT_BN 64
#define DOT_BK 16
#define DOT_THREADS 256

template <bool BF16>
__device__ __forceinline__ float dot_load(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool BF16>
__global__ void __launch_bounds__(DOT_THREADS)
batched_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int N, int K, int inner, long long sa0,
                      long long sa1, long long sb0, long long sb1, float alpha) {
  __shared__ float As[DOT_BK][DOT_BM + 4];   // A tile, k-major
  __shared__ float Bs[DOT_BK][DOT_BN + 4];
  const int b = blockIdx.z, bo = b / inner, bi = b % inner;
  A += bo * sa0 + bi * sa1;
  B += bo * sb0 + bi * sb1;
  C += (long long)b * M * N;
  const int m0 = blockIdx.y * DOT_BM, n0 = blockIdx.x * DOT_BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += DOT_BK) {
#pragma unroll
    for (int e = threadIdx.x; e < DOT_BM * DOT_BK; e += DOT_THREADS) {
      const int r = e / DOT_BK, c = e % DOT_BK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? dot_load<BF16>(alpha * A[(long long)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int e = threadIdx.x; e < DOT_BK * DOT_BN; e += DOT_THREADS) {
      const int r = e / DOT_BN, c = e % DOT_BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? dot_load<BF16>(B[(long long)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DOT_BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[(long long)m * N + n] = acc[i][j];
    }
  }
}

// A: rows of K floats, B: rows of N floats (each matrix row-major and
// contiguous); batch b = bo * inner + bi of outer * inner starts at
// A + bo * sa0 + bi * sa1 and B + bo * sb0 + bi * sb1 (strides in floats, 0
// broadcasts); C (outer * inner, M, N) contiguous. bf16 != 0 rounds every
// operand to bfloat16 at load, after alpha. Returns the cudaError_t of the
// launch.
extern "C" int batched_matmul(const float* A, const float* B, float* C, int outer, int inner,
                              int M, int N, int K, long long sa0, long long sa1, long long sb0,
                              long long sb1, float alpha, int bf16, cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1 || outer < 1 || inner < 1 || outer * inner > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + DOT_BN - 1) / DOT_BN, (M + DOT_BM - 1) / DOT_BM, outer * inner);
  if (bf16)
    batched_matmul_kernel<true><<<grid, DOT_THREADS, 0, stream>>>(A, B, C, M, N, K, inner, sa0,
                                                                  sa1, sb0, sb1, alpha);
  else
    batched_matmul_kernel<false><<<grid, DOT_THREADS, 0, stream>>>(A, B, C, M, N, K, inner, sa0,
                                                                   sa1, sb0, sb1, alpha);
  return (int)cudaGetLastError();
}
