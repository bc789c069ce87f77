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
// Design: one thread block per (batch*window, group of heads), one thread
// per (head, query row): 108, 216 and 108 threads at the flagship's three
// stages. The block stages K and V of its heads in shared memory (16-byte
// loads, rows padded to MAXD floats so that a key is MAXD / 4 float4 reads),
// and, where they fit in 48 KB beside them, the heads' bias planes and the
// window's mask plane (rows padded to N + 1 floats, so that the threads of
// a warp, one row each, read distinct banks); otherwise bias and mask are
// read from device memory. The number of heads a block takes is the most
// that fits. Each score is computed once: an online softmax keeps a running
// max and rescales the sum and the (dropped) accumulator when it grows. The
// (N, N) probabilities live in registers and never reach device memory
// (what the TPU kernel kept in VMEM).
#include <float.h>

#include "common.cuh"

// hash draw of K4's dropout (ops/attention.py WINDOW_ATTN_DRAW; K6 is 4)
#define WINDOW_ATTN_DRAW 5
#define WINDOW_ATTN_SMEM (48 * 1024)
#define WINDOW_ATTN_THREADS 1024

// rows x D floats from src (contiguous) into rows x MAXD at dst, zero-padded
template <int MAXD>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int rows,
                                           int D) {
  for (int c = threadIdx.x; c < rows * (MAXD / 4); c += blockDim.x) {
    const int r = c / (MAXD / 4), d = (c % (MAXD / 4)) * 4;
    float4 x;
    if (D % 4 == 0) {
      x = d < D ? *reinterpret_cast<const float4*>(src + (size_t)r * D + d)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const float* s = src + (size_t)r * D;
      x.x = d < D ? s[d] : 0.f;
      x.y = d + 1 < D ? s[d + 1] : 0.f;
      x.z = d + 2 < D ? s[d + 2] : 0.f;
      x.w = d + 3 < D ? s[d + 3] : 0.f;
    }
    *reinterpret_cast<float4*>(dst + r * MAXD + d) = x;
  }
}

// rows x N floats from src into rows x (N + 1) at dst
__device__ __forceinline__ void stage_plane(float* dst, const float* __restrict__ src, int rows,
                                            int N) {
  const int n = rows * N;
  if (N % 4 == 0) {
    for (int c = threadIdx.x * 4; c < n; c += blockDim.x * 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + c);
      const int r = c / N, j = c % N;   // N % 4 == 0: the four share a row
      float* o = dst + r * (N + 1) + j;
      o[0] = x.x;
      o[1] = x.y;
      o[2] = x.z;
      o[3] = x.w;
    }
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x) dst[(c / N) * (N + 1) + c % N] = src[c];
  }
}

template <int MAXD>
__global__ void window_attention_kernel(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ mask,
                                        float* __restrict__ out, int nW, int H,
                                        int N, int D, int hb, int staged, Dropout drop) {
  extern __shared__ float4 wa_smem4[];
  float* ks = reinterpret_cast<float*>(wa_smem4);
  float* vs = ks + hb * N * MAXD;
  float* bs = vs + hb * N * MAXD;         // staged bias planes, then the mask plane
  float* ms = bs + hb * N * (N + 1);
  const int bw = blockIdx.x;              // b * nW + w
  const int h0 = blockIdx.y * hb, nh = min(hb, H - h0);
  const int w = bw % nW;
  const size_t base = ((size_t)bw * H + h0) * N * D;   // (b, w, h0, 0, 0)
  stage_rows<MAXD>(ks, k + base, nh * N, D);
  stage_rows<MAXD>(vs, v + base, nh * N, D);
  if (staged) {
    stage_plane(bs, bias + (size_t)h0 * N * N, nh * N, N);
    if (mask) stage_plane(ms, mask + (size_t)w * N * N, N, N);
  }
  __syncthreads();

  const int pst = staged ? N + 1 : N;   // row stride of the bias and mask planes
  const float* bias_p = staged ? bs : bias + (size_t)h0 * N * N;
  const float* mask_p = mask ? (staged ? ms : mask + (size_t)w * N * N) : nullptr;
  for (int r = threadIdx.x; r < nh * N; r += blockDim.x) {   // r = hl * N + i
    const int hl = r / N, i = r % N;
    float qi[MAXD];
    const float* qrow = q + base + (size_t)r * D;
#pragma unroll
    for (int d = 0; d < MAXD; d += 4) {
      if (D % 4 == 0 && d < D) {
        const float4 x = *reinterpret_cast<const float4*>(qrow + d);
        qi[d] = x.x;
        qi[d + 1] = x.y;
        qi[d + 2] = x.z;
        qi[d + 3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qi[d + e] = d + e < D ? qrow[d + e] : 0.f;
      }
    }
    const float* kh = ks + hl * N * MAXD;
    const float* vh = vs + hl * N * MAXD;
    const float* brow = bias_p + (size_t)r * pst;   // plane hl, row i
    const float* mrow = mask_p ? mask_p + (size_t)i * pst : nullptr;
    const uint32_t row = (uint32_t)((((size_t)bw * H + h0) * N) + r);   // dropout row

    float m = -FLT_MAX, l = 0.f;
    float acc[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) acc[d] = 0.f;
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < MAXD; d += 4) {
        const float4 kj = *reinterpret_cast<const float4*>(kh + j * MAXD + d);
        s = fmaf(qi[d], kj.x, s);
        s = fmaf(qi[d + 1], kj.y, s);
        s = fmaf(qi[d + 2], kj.z, s);
        s = fmaf(qi[d + 3], kj.w, s);
      }
      s += brow[j];
      if (mrow) s += mrow[j];
      if (s > m) {   // a new running max: rescale what was summed so far
        const float c = expf(m - s);
        l *= c;
#pragma unroll
        for (int d = 0; d < MAXD; ++d) acc[d] *= c;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      // the sum takes every probability; only the accumulator drops
      const float pk = p * keep(drop, row, (uint32_t)j);
#pragma unroll
      for (int d = 0; d < MAXD; d += 4) {
        const float4 vj = *reinterpret_cast<const float4*>(vh + j * MAXD + d);
        acc[d] = fmaf(pk, vj.x, acc[d]);
        acc[d + 1] = fmaf(pk, vj.y, acc[d + 1]);
        acc[d + 2] = fmaf(pk, vj.z, acc[d + 2]);
        acc[d + 3] = fmaf(pk, vj.w, acc[d + 3]);
      }
    }
    const float inv = 1.f / l;
    float* orow = out + base + (size_t)r * D;
#pragma unroll
    for (int d = 0; d < MAXD; d += 4) {
      if (D % 4 == 0 && d < D) {
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < D) orow[d + e] = acc[d + e] * inv;
      }
    }
  }
}

template <int MAXD>
static cudaError_t window_attention_launch(const float* q, const float* k, const float* v,
                                           const float* bias, const float* mask, float* out,
                                           int B, int nW, int H, int N, int D, Dropout drop,
                                           cudaStream_t stream) {
  // shared bytes of hb heads: K and V, and with `staged` the bias planes and
  // the mask plane
  auto bytes = [&](int hb, bool staged) {
    size_t f = 2 * (size_t)hb * N * MAXD;
    if (staged) f += ((size_t)hb + (mask ? 1 : 0)) * N * (N + 1);
    return f * sizeof(float);
  };
  const int cap = N >= WINDOW_ATTN_THREADS ? 1 : WINDOW_ATTN_THREADS / N;
  const int hmax = H < cap ? H : cap;
  int hb = hmax;
  while (hb > 1 && bytes(hb, true) > WINDOW_ATTN_SMEM) --hb;
  const bool staged = bytes(hb, true) <= WINDOW_ATTN_SMEM;
  if (!staged) {
    hb = hmax;
    while (hb > 1 && bytes(hb, false) > WINDOW_ATTN_SMEM) --hb;
  }
  // one head's K and V may pass 48 KB where MAXD pads D (N * D <= 6144)
  const size_t smem = bytes(hb, staged);
  const cudaError_t err = allow_smem(window_attention_kernel<MAXD>, smem);
  if (err != cudaSuccess) return err;
  int threads = ((hb * N + 31) / 32) * 32;
  if (threads > WINDOW_ATTN_THREADS) threads = WINDOW_ATTN_THREADS;
  const dim3 grid((unsigned)(B * nW), (unsigned)((H + hb - 1) / hb));
  window_attention_kernel<MAXD><<<grid, threads, smem, stream>>>(q, k, v, bias, mask, out, nW, H,
                                                                 N, D, hb, staged, drop);
  return cudaGetLastError();
}

// q, k, v, out: (B, nW, H, N, D) contiguous f32; bias (H, N, N); mask
// (nW, N, N) or NULL; dropout seed and rate (0: off). Needs D <= 32 and
// N * D <= 6144. Returns the cudaError_t of the launch.
extern "C" int window_attention_forward(const float* q, const float* k,
                                        const float* v, const float* bias,
                                        const float* mask, float* out, int B,
                                        int nW, int H, int N, int D, int seed,
                                        double rate, cudaStream_t stream) {
  if (D < 1 || D > 32 || N < 1 || N * D > 6144) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, WINDOW_ATTN_DRAW, rate);
  cudaError_t err;
  if (D <= 4)
    err = window_attention_launch<4>(q, k, v, bias, mask, out, B, nW, H, N, D, drop, stream);
  else if (D <= 8)
    err = window_attention_launch<8>(q, k, v, bias, mask, out, B, nW, H, N, D, drop, stream);
  else if (D <= 16)
    err = window_attention_launch<16>(q, k, v, bias, mask, out, B, nW, H, N, D, drop, stream);
  else
    err = window_attention_launch<32>(q, k, v, bias, mask, out, B, nW, H, N, D, drop, stream);
  return (int)err;
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
