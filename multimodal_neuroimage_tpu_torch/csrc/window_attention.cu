// K4: bias-and-mask window attention, forward.
//
// Replaces multimodal_neuroimage_tpu/ops/attention.py fused_window_attention
// (_fused_attention_bias -> _fab_fwd -> _make_fab_kernels forward body): per
// (batch*window, head), softmax(q k^T + bias[h] + mask[w]) v with q already
// scaled by the caller (SwinV2 folds its clamped logit scale into q), and in
// training the normalised probabilities dropped at `rate`:
// out = (p o keep / (1 - rate)) v. The mask is the port's coordinate hash
// (common.cuh keep) at row ((b * nW + w) * H + h) * N + i, column j, draw
// WINDOW_ATTN_DRAW; forward and backward regenerate it, nothing stores it.
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

// hash draw of K4's dropout (ops/attention.py WINDOW_ATTN_DRAW; K6 is 4)
#define WINDOW_ATTN_DRAW 5

template <int MAXD>
__global__ void window_attention_kernel(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask,
                                        float* __restrict__ out, int nW, int H,
                                        int N, int D, Dropout drop) {
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
  const uint32_t row0 = (uint32_t)bh * N;   // dropout row of query 0
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
      // the sum takes every probability; only the accumulator drops
      const float pk = p * keep(drop, row0 + i, (uint32_t)j);
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        if (d < D) acc[d] = fmaf(pk, vs[j * D + d], acc[d]);
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) out[base + (size_t)i * D + d] = acc[d] * inv;
  }
}

// q, k, v, out: (B, nW, H, N, D) contiguous f32; bias (H, N, N); mask
// (nW, N, N) or NULL; dropout seed and rate (0: off). Returns the
// cudaError_t of the launch.
extern "C" int window_attention_forward(const float* q, const float* k,
                                        const float* v, const float* bias,
                                        const float* mask, float* out, int B,
                                        int nW, int H, int N, int D, int seed,
                                        double rate, cudaStream_t stream) {
  if (D < 1 || D > 32 || N < 1) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, WINDOW_ATTN_DRAW, rate);
  int threads = ((N + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = 2 * (size_t)N * D * sizeof(float);
  const dim3 grid((unsigned)(B * nW * H));
  cudaError_t err;
  if (D <= 8) {
    err = allow_smem(window_attention_kernel<8>, smem);
    if (err != cudaSuccess) return (int)err;
    window_attention_kernel<8><<<grid, threads, smem, stream>>>(q, k, v, bias, mask, out,
                                                                nW, H, N, D, drop);
  } else if (D <= 16) {
    err = allow_smem(window_attention_kernel<16>, smem);
    if (err != cudaSuccess) return (int)err;
    window_attention_kernel<16><<<grid, threads, smem, stream>>>(q, k, v, bias, mask, out,
                                                                 nW, H, N, D, drop);
  } else {
    err = allow_smem(window_attention_kernel<32>, smem);
    if (err != cudaSuccess) return (int)err;
    window_attention_kernel<32><<<grid, threads, smem, stream>>>(q, k, v, bias, mask, out,
                                                                 nW, H, N, D, drop);
  }
  return (int)cudaGetLastError();
}

// K4 backward. Replaces attention.py _fab_bwd (the backward body of
// _make_fab_kernels, :258-297): with p = softmax(s) recomputed from q, k,
// bias and mask, the forward's keep factors regenerated (keep' = keep /
// (1 - rate), 1 when off), D_i = dout_i . out_i (the forward's output, which
// already carries the dropout), dP = keep' o (dout v^T), ds = p (dP - D),
//   dq = ds k,  dk = ds^T q,  dv = (p o keep')^T dout,
//   dbias[h] = sum over (b, w) of ds.
// One block per (batch*window, head), as the forward. The TPU kernel carried
// dbias[h] across its sequential batch axis in a resident output block; here
// each block writes its ds (N x N) to a partial buffer and a second kernel
// adds the B*nW partials in order, so the sum is the same on every run.
// Bounded, like the forward, by launch latency: N <= 36 and D = 4 at the
// flagship. P and dS of the block's head sit in shared memory (2 N^2 floats);
// one thread per query row, then one per key row.
template <int MAXD>
__global__ void window_attention_backward_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const float* __restrict__ out, const float* __restrict__ dout, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dbias_part, int nW,
    int H, int N, int D, Dropout drop) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + N * D;
  float* vs = ks + N * D;
  float* gs = vs + N * D;
  float* P = gs + N * D;
  float* dS = P + N * N;
  const int bh = blockIdx.x;  // ((b * nW + w) * H + h)
  const int h = bh % H;
  const int w = (bh / H) % nW;
  const size_t base = (size_t)bh * N * D;
  for (int i = threadIdx.x; i < N * D; i += blockDim.x) {
    qs[i] = q[base + i];
    ks[i] = k[base + i];
    vs[i] = v[base + i];
    gs[i] = dout[base + i];
  }
  __syncthreads();

  const float* bias_h = bias + (size_t)h * N * N;
  const float* mask_w = mask ? mask + (size_t)w * N * N : nullptr;
  float* db = dbias_part + (size_t)bh * N * N;
  const uint32_t row0 = (uint32_t)bh * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float qi[MAXD], gi[MAXD];
    float Di = 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      qi[d] = d < D ? qs[i * D + d] : 0.f;
      gi[d] = d < D ? gs[i * D + d] : 0.f;
      if (d < D) Di = fmaf(gi[d], out[base + (size_t)i * D + d], Di);
    }
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
      P[i * N + j] = s;
      m = fmaxf(m, s);
    }
    float l = 0.f;
    for (int j = 0; j < N; ++j) {
      const float e = expf(P[i * N + j] - m);
      P[i * N + j] = e;
      l += e;
    }
    const float inv = 1.f / l;
    float acc[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) acc[d] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float p = P[i * N + j] * inv;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        if (d < D) dp = fmaf(gi[d], vs[j * D + d], dp);
      const float kp = keep(drop, row0 + i, (uint32_t)j);
      const float ds = p * (dp * kp - Di);
      P[i * N + j] = p * kp;   // the dropped probability, for dv
      dS[i * N + j] = ds;
      db[(size_t)i * N + j] = ds;
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        if (d < D) acc[d] = fmaf(ds, ks[j * D + d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) dq[base + (size_t)i * D + d] = acc[d];
  }
  __syncthreads();

  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float ak[MAXD], av[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) ak[d] = av[d] = 0.f;
    for (int i = 0; i < N; ++i) {
      const float ds = dS[i * N + j], p = P[i * N + j];
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        if (d < D) {
          ak[d] = fmaf(ds, qs[i * D + d], ak[d]);
          av[d] = fmaf(p, gs[i * D + d], av[d]);
        }
    }
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) {
        dk[base + (size_t)j * D + d] = ak[d];
        dv[base + (size_t)j * D + d] = av[d];
      }
  }
}

// Floats of device scratch window_attention_backward needs: the per-block
// dbias partials.
extern "C" long long window_attention_backward_scratch_floats(int B, int nW, int H, int N) {
  return (long long)B * nW * H * N * N;
}

// q, k, v, out, dout, dq, dk, dv: (B, nW, H, N, D) contiguous f32 (out is the
// forward's output); bias (H, N, N); mask (nW, N, N) or NULL; the forward's
// dropout seed and rate; dbias (H, N, N) is written (not accumulated). Needs
// N <= 64 and D <= 32. Returns the cudaError_t of the first launch that
// fails, or of the last.
extern "C" int window_attention_backward(const float* q, const float* k, const float* v,
                                         const float* bias, const float* mask,
                                         const float* out, const float* dout, float* dq,
                                         float* dk, float* dv, float* dbias, float* scratch,
                                         int B, int nW, int H, int N, int D, int seed,
                                         double rate, cudaStream_t stream) {
  if (D < 1 || D > 32 || N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, WINDOW_ATTN_DRAW, rate);
  const int threads = ((N + 31) / 32) * 32;
  const size_t smem = (4 * (size_t)N * D + 2 * (size_t)N * N) * sizeof(float);
  const dim3 grid((unsigned)(B * nW * H));
  cudaError_t err;
  if (D <= 8) {
    if ((err = allow_smem(window_attention_backward_kernel<8>, smem)) != cudaSuccess)
      return (int)err;
    window_attention_backward_kernel<8><<<grid, threads, smem, stream>>>(
        q, k, v, bias, mask, out, dout, dq, dk, dv, scratch, nW, H, N, D, drop);
  } else {
    if ((err = allow_smem(window_attention_backward_kernel<32>, smem)) != cudaSuccess)
      return (int)err;
    window_attention_backward_kernel<32><<<grid, threads, smem, stream>>>(
        q, k, v, bias, mask, out, dout, dq, dk, dv, scratch, nW, H, N, D, drop);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dbias[h] = sum over the B * nW (batch, window) blocks of head h: the
  // partials are laid out [(b * nW + w)][h][N][N], i.e. S = B * nW slices
  // of H * N * N floats
  return (int)reduce_partials(scratch, B * nW, (long long)H * N * N, nullptr, dbias, stream);
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
