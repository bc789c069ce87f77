// K4: bias-and-mask window attention, forward.
//
// Replaces multimodal_neuroimage_tpu/ops/attention.py fused_window_attention
// (_fused_attention_bias -> _fab_fwd -> _make_fab_kernels forward body): per
// (batch*window, head), softmax(q k^T + bias[h] + mask[w]) v with q already
// scaled by the caller (SwinV2 folds its clamped logit scale into q).
//
// What bounds it on the H100: nothing but launch latency and occupancy. The
// flagship SwinV2 head calls it with N = 36 (nW 4, 3 heads; nW 1, 6 heads)
// and N = 9 (12 heads) at head dim 4: a few hundred thousand FLOPs per call.
// Design: one thread block per (batch*window, head); the block stages K and
// V of that head in shared memory and each thread owns one query row, so
// the (N, N) probabilities live in registers and never reach device memory
// (what the TPU kernel kept in VMEM). The softmax subtracts the row max, as
// the TPU kernel does.
#include "common.cuh"

template <int MAXD>
__global__ void window_attention_kernel(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask,
                                        float* __restrict__ out, int nW, int H,
                                        int N, int D) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + N * D;
  const int bh = blockIdx.x;  // ((b * nW + w) * H + h)
  const int h = bh % H;
  const int w = (bh / H) % nW;
  const size_t base = (size_t)bh * N * D;
  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    ks[i] = k[base + i];
    vs[i] = v[base + i];
  }
  __syncthreads();

  const float* bias_h = bias + (size_t)h * N * N;
  const float* mask_w = mask ? mask + (size_t)w * N * N : nullptr;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float qi[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) qi[d] = d < D ? q[base + (size_t)i * D + d] : 0.f;
    const float* brow = bias_h + (size_t)i * N;
    const float* mrow = mask_w ? mask_w + (size_t)i * N : nullptr;

    float m = -INFINITY;
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        if (d < D) s = fmaf(qi[d], ks[j * D + d], s);
      s += brow[j];
      if (mrow) s += mrow[j];
      m = fmaxf(m, s);
    }
    float l = 0.f;
    float acc[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) acc[d] = 0.f;
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        if (d < D) s = fmaf(qi[d], ks[j * D + d], s);
      s += brow[j];
      if (mrow) s += mrow[j];
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        if (d < D) acc[d] = fmaf(p, vs[j * D + d], acc[d]);
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) out[base + (size_t)i * D + d] = acc[d] * inv;
  }
}

// q, k, v, out: (B, nW, H, N, D) contiguous f32; bias (H, N, N); mask
// (nW, N, N) or NULL. Returns the cudaError_t of the launch.
extern "C" int window_attention_forward(const float* q, const float* k,
                                        const float* v, const float* bias,
                                        const float* mask, float* out, int B,
                                        int nW, int H, int N, int D,
                                        cudaStream_t stream) {
  if (D < 1 || D > 32 || N < 1) return (int)cudaErrorInvalidValue;
  int threads = ((N + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = 2 * (size_t)N * D * sizeof(float);
  const dim3 grid((unsigned)(B * nW * H));
  cudaError_t err;
  if (D <= 8) {
    err = allow_smem(window_attention_kernel<8>, smem);
    if (err != cudaSuccess) return (int)err;
    window_attention_kernel<8><<<grid, threads, smem, stream>>>(q, k, v, bias, mask, out,
                                                                nW, H, N, D);
  } else if (D <= 16) {
    err = allow_smem(window_attention_kernel<16>, smem);
    if (err != cudaSuccess) return (int)err;
    window_attention_kernel<16><<<grid, threads, smem, stream>>>(q, k, v, bias, mask, out,
                                                                 nW, H, N, D);
  } else {
    err = allow_smem(window_attention_kernel<32>, smem);
    if (err != cudaSuccess) return (int)err;
    window_attention_kernel<32><<<grid, threads, smem, stream>>>(q, k, v, bias, mask, out,
                                                                 nW, H, N, D);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
