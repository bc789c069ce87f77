// K4: bias-and-mask window attention, forward and (further down) backward.
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
// The TPU kernel carried dbias[h] across its sequential batch axis in a
// resident output block. Here, in one launch: a block per (batch*window,
// head), WAB_L lanes per row of the window (each row's keys split over the
// lanes, max, sum and products merged by shuffles). Pass 1 (the lanes of a
// query row) rebuilds p, writes dq and keeps p keep' and ds in shared
// memory; pass 2 (the lanes of a key row) writes dk and dv from them.
// dbias is summed in the same launch, in float32 and in a fixed order, so
// that it is bitwise the same from run to run: each block writes its ds to
// its own slot of a partial buffer; the last block of a group of WAB_G
// consecutive windows to finish (a counter a group, __threadfence) adds the
// group's partials in window order, and the last group of a head to finish
// (a counter a head) adds the groups' sums in group order into dbias (with
// one group, its sum is dbias). The last blocks zero their counters for the
// next call. Bounded by latency: N <= 36 and D = 4 at the flagship, a few
// microseconds of serial work a window, which the lanes of a row share.
#define WAB_L 4                      // lanes a row
#define WAB_G 16                     // windows a group of dbias's sum

__host__ __device__ inline int wab_groups(int BW) { return (BW + WAB_G - 1) / WAB_G; }

__host__ __device__ inline int wab_round4(int n) { return (n + 3) & ~3; }

// Threads of a block: WAB_L a row of the window, in whole warps.
__host__ __device__ inline int wab_threads(int N) { return (N * WAB_L + 31) / 32 * 32; }

// Elements of a partial a thread adds in a last block: ceil(N N / threads)
// (at most 16: threads >= 4 N and N <= 64), rounded up to a compiled form.
__host__ __device__ inline int wab_elems(int N) {
  const int e = (N * N + wab_threads(N) - 1) / wab_threads(N);
  return e <= 1 ? 1 : e <= 2 ? 2 : e <= 4 ? 4 : e <= 9 ? 9 : 16;
}

// Floats of a partial's slot: N N, padded so that every thread's E elements
// lie inside it.
__host__ __device__ inline int wab_slot(int N) { return wab_elems(N) * wab_threads(N); }

// dst[c] = the n partials src[b * slot + c] added in order b = 0, 1, ..., for
// this thread's E elements: warp w owns the run [32 E w, 32 E (w + 1)), its
// lane l the elements c = 32 E w + l + 32 e (c < NN), so that each load of a
// warp reads 128 contiguous bytes and a thread reaches its E elements of a
// partial from one address at immediate offsets (the padding keeps them
// inside the slot; what lies past NN is never stored). The loads of P
// partials are in flight together: a last block's sum is a few L2 round
// trips at a register cost near that of the windows' work, which sets the
// kernel's occupancy.
template <int E, int P>
__device__ inline void wab_sum_e(const float* __restrict__ src, int n, int slot,
                                 float* __restrict__ dst, int NN, int tid) {
  const int c0 = (tid & ~31) * E + (tid & 31);
  src += c0;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = __ldcg(src + 32 * e);
  int b = 1;
  for (; b + P <= n; b += P) {
    float x[P][E];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float* pj = src + (size_t)(b + j) * slot;
#pragma unroll
      for (int e = 0; e < E; ++e) x[j][e] = __ldcg(pj + 32 * e);
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += x[j][e];
  }
  for (; b < n; ++b) {
    const float* pb = src + (size_t)b * slot;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += __ldcg(pb + 32 * e);
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (c0 + 32 * e < NN) dst[c0 + 32 * e] = acc[e];
}

__device__ inline void wab_sum(const float* __restrict__ src, int n, int slot,
                               float* __restrict__ dst, int N, int tid) {
  const int NN = N * N;
  switch (wab_elems(N)) {
    case 1: wab_sum_e<1, 8>(src, n, slot, dst, NN, tid); break;
    case 2: wab_sum_e<2, 8>(src, n, slot, dst, NN, tid); break;
    case 4: wab_sum_e<4, 8>(src, n, slot, dst, NN, tid); break;
    case 9: wab_sum_e<9, 4>(src, n, slot, dst, NN, tid); break;
    default: wab_sum_e<16, 2>(src, n, slot, dst, NN, tid); break;
  }
}

// Shared floats of one (window, head): q, k, v, dout (rows padded to MAXD),
// p keep' and ds (rows padded to N + 1).
static size_t wab_smem(int N, int MAXD) {
  return (4 * (size_t)N * MAXD + 2 * (size_t)wab_round4(N * (N + 1))) * sizeof(float);
}

template <int MAXD>
__global__ void __launch_bounds__(64 * WAB_L)
window_attention_backward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ bias,
                                 const float* __restrict__ mask, const float* __restrict__ out,
                                 const float* __restrict__ dout, float* __restrict__ dq,
                                 float* __restrict__ dk, float* __restrict__ dv,
                                 float* __restrict__ dbias, float* __restrict__ part,
                                 unsigned* __restrict__ count, int nW, int H, int N, int D,
                                 Dropout drop) {
  extern __shared__ float4 wab_smem4[];
  const int NP = N + 1;
  float* qs = reinterpret_cast<float*>(wab_smem4);
  float *ks = qs + N * MAXD, *vs = ks + N * MAXD, *gs = vs + N * MAXD;
  float* Ps = gs + N * MAXD;   // p keep', rows of NP
  float* dS = Ps + wab_round4(N * NP);
  const int bw = blockIdx.x, h = blockIdx.y, w = bw % nW;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int sub = tid % WAB_L, i = tid / WAB_L;   // lane of the row, row of the window
  const size_t base = ((size_t)bw * H + h) * N * D;   // (b, w, h, 0, 0)
  for (int c = tid; c < N * (MAXD / 4); c += nt) {
    const int r = c / (MAXD / 4), d = (c % (MAXD / 4)) * 4;
    float4 x[4] = {};
    if (d < D) {
      const float* src[4] = {q + base, k + base, v + base, dout + base};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float* s = src[a] + (size_t)r * D;
        if (D % 4 == 0) {
          x[a] = *reinterpret_cast<const float4*>(s + d);
        } else {
          x[a].x = s[d];
          x[a].y = d + 1 < D ? s[d + 1] : 0.f;
          x[a].z = d + 2 < D ? s[d + 2] : 0.f;
          x[a].w = d + 3 < D ? s[d + 3] : 0.f;
        }
      }
    }
    float* dst[4] = {qs, ks, vs, gs};
#pragma unroll
    for (int a = 0; a < 4; ++a) *reinterpret_cast<float4*>(dst[a] + r * MAXD + d) = x[a];
  }
  __syncthreads();
  const bool live = i < N;
  // the lanes of live rows: whole groups of WAB_L, the only lanes that
  // shuffle (with partners in their own group)
  const unsigned lm = __ballot_sync(MNT_FULL_MASK, live);
  if (live) {
    // pass 1: query row i
    float qi[MAXD], gi[MAXD];
    float Di = 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      qi[d] = qs[i * MAXD + d];
      gi[d] = gs[i * MAXD + d];
      if (d < D) Di = fmaf(gi[d], __ldg(out + base + (size_t)i * D + d), Di);
    }
    const float* brow = bias + ((size_t)h * N + i) * N;
    const float* mrow = mask ? mask + ((size_t)w * N + i) * N : nullptr;
    float* prow = Ps + i * NP;
    float* srow = dS + i * NP;
    float mx = -INFINITY;
    for (int j = sub; j < N; j += WAB_L) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < MAXD; d += 4) {
        const float4 kj = *reinterpret_cast<const float4*>(ks + j * MAXD + d);
        s = fmaf(qi[d], kj.x, s);
        s = fmaf(qi[d + 1], kj.y, s);
        s = fmaf(qi[d + 2], kj.z, s);
        s = fmaf(qi[d + 3], kj.w, s);
      }
      s += __ldg(brow + j);
      if (mrow) s += __ldg(mrow + j);
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int off = 1; off < WAB_L; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(lm, mx, off));
    float l = 0.f;
    for (int j = sub; j < N; j += WAB_L) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      l += e;
    }
#pragma unroll
    for (int off = 1; off < WAB_L; off <<= 1) l += __shfl_xor_sync(lm, l, off);
    const float inv = 1.f / l;
    const uint32_t row = (uint32_t)(((size_t)bw * H + h) * N + i);   // dropout row
    float acc[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) acc[d] = 0.f;
    for (int j = sub; j < N; j += WAB_L) {
      const float p = prow[j] * inv;
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < MAXD; d += 4) {
        const float4 vj = *reinterpret_cast<const float4*>(vs + j * MAXD + d);
        dp = fmaf(gi[d], vj.x, dp);
        dp = fmaf(gi[d + 1], vj.y, dp);
        dp = fmaf(gi[d + 2], vj.z, dp);
        dp = fmaf(gi[d + 3], vj.w, dp);
      }
      const float kp = keep(drop, row, (uint32_t)j);
      const float ds = p * (dp * kp - Di);
      prow[j] = p * kp;   // the dropped probability, for dv
      srow[j] = ds;
#pragma unroll
      for (int d = 0; d < MAXD; d += 4) {
        const float4 kj = *reinterpret_cast<const float4*>(ks + j * MAXD + d);
        acc[d] = fmaf(ds, kj.x, acc[d]);
        acc[d + 1] = fmaf(ds, kj.y, acc[d + 1]);
        acc[d + 2] = fmaf(ds, kj.z, acc[d + 2]);
        acc[d + 3] = fmaf(ds, kj.w, acc[d + 3]);
      }
    }
#pragma unroll
    for (int off = 1; off < WAB_L; off <<= 1)
#pragma unroll
      for (int d = 0; d < MAXD; ++d) acc[d] += __shfl_xor_sync(lm, acc[d], off);
    if (sub == 0)
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        if (d < D) dq[base + (size_t)i * D + d] = acc[d];
  }
  __syncthreads();
  if (live) {
    // pass 2: key row j = i
    const int j = i;
    float ak[MAXD], av[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) ak[d] = av[d] = 0.f;
    for (int r = sub; r < N; r += WAB_L) {
      const float ds = dS[r * NP + j], p = Ps[r * NP + j];
#pragma unroll
      for (int d = 0; d < MAXD; d += 4) {
        const float4 qr = *reinterpret_cast<const float4*>(qs + r * MAXD + d);
        const float4 gr = *reinterpret_cast<const float4*>(gs + r * MAXD + d);
        ak[d] = fmaf(ds, qr.x, ak[d]);
        ak[d + 1] = fmaf(ds, qr.y, ak[d + 1]);
        ak[d + 2] = fmaf(ds, qr.z, ak[d + 2]);
        ak[d + 3] = fmaf(ds, qr.w, ak[d + 3]);
        av[d] = fmaf(p, gr.x, av[d]);
        av[d + 1] = fmaf(p, gr.y, av[d + 1]);
        av[d + 2] = fmaf(p, gr.z, av[d + 2]);
        av[d + 3] = fmaf(p, gr.w, av[d + 3]);
      }
    }
#pragma unroll
    for (int off = 1; off < WAB_L; off <<= 1)
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        ak[d] += __shfl_xor_sync(lm, ak[d], off);
        av[d] += __shfl_xor_sync(lm, av[d], off);
      }
    if (sub == 0)
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
        if (d < D) {
          dk[base + (size_t)j * D + d] = ak[d];
          dv[base + (size_t)j * D + d] = av[d];
        }
  }
  // dbias: this window's ds into its slot, (h, bw), of the partials
  const int BW = gridDim.x, NN = N * N, NG = wab_groups(BW), slot = wab_slot(N);
  const int grp = bw / WAB_G, g0 = grp * WAB_G, gn = min(WAB_G, BW - g0);
  float* hpart = part + (size_t)h * BW * slot;
  float* gsum = part + ((size_t)H * BW + (size_t)h * NG) * slot;   // the groups' sums
  for (int c = tid; c < NN; c += nt) hpart[(size_t)bw * slot + c] = dS[(c / N) * NP + c % N];
  __threadfence();
  __syncthreads();
  __shared__ int last;
  unsigned* gcount = count + (size_t)h * (NG + 1) + grp;
  if (tid == 0) last = atomicAdd(gcount, 1u) == (unsigned)gn - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block of the group: its windows' partials in window order
  wab_sum(hpart + (size_t)g0 * slot, gn, slot,
          NG == 1 ? dbias + (size_t)h * NN : gsum + (size_t)grp * slot, N, tid);
  if (tid == 0) *gcount = 0u;
  if (NG == 1) return;
  __threadfence();
  __syncthreads();
  unsigned* hcount = count + (size_t)h * (NG + 1) + NG;
  if (tid == 0) last = atomicAdd(hcount, 1u) == (unsigned)NG - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last group of the head: the groups' sums in group order
  wab_sum(gsum, NG, slot, dbias + (size_t)h * NN, N, tid);
  if (tid == 0) *hcount = 0u;
}

template <int MAXD>
static cudaError_t wab_launch(const float* q, const float* k, const float* v, const float* bias,
                              const float* mask, const float* out, const float* dout, float* dq,
                              float* dk, float* dv, float* dbias, float* part,
                              unsigned* count, int B, int nW, int H, int N, int D, Dropout drop,
                              cudaStream_t stream) {
  const size_t smem = wab_smem(N, MAXD);
  const cudaError_t err = allow_smem(window_attention_backward_kernel<MAXD>, smem);
  if (err != cudaSuccess) return err;
  const int threads = wab_threads(N);
  window_attention_backward_kernel<MAXD>
      <<<dim3((unsigned)(B * nW), (unsigned)H), threads, smem, stream>>>(
          q, k, v, bias, mask, out, dout, dq, dk, dv, dbias, part, count, nW, H, N, D, drop);
  return cudaGetLastError();
}

// Scratch of window_attention_backward: its float partials of dbias, and
// its counters (zeroed before the first call, left zeroed by every call).
extern "C" long long window_attention_backward_scratch_floats(int B, int nW, int H, int N) {
  const long long BW = (long long)B * nW;
  return (BW + wab_groups((int)BW)) * H * wab_slot(N);
}

extern "C" long long window_attention_backward_counters(int B, int nW, int H) {
  return (long long)(wab_groups(B * nW) + 1) * H;
}

// q, k, v, out, dout, dq, dk, dv: (B, nW, H, N, D) contiguous f32 (out is the
// forward's output); bias (H, N, N); mask (nW, N, N) or NULL; the forward's
// dropout seed and rate; dbias (H, N, N) is written (not accumulated); part
// and count: the scratch above (calls that share it must not overlap).
// Needs N <= 64 and D <= 32. One launch; returns its cudaError_t.
extern "C" int window_attention_backward(const float* q, const float* k, const float* v,
                                         const float* bias, const float* mask,
                                         const float* out, const float* dout, float* dq,
                                         float* dk, float* dv, float* dbias, float* part,
                                         unsigned* count, int B, int nW, int H, int N, int D,
                                         int seed, double rate, cudaStream_t stream) {
  if (D < 1 || D > 32 || N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, WINDOW_ATTN_DRAW, rate);
  cudaError_t err;
#define WAB_CALL(MAXD)                                                                     \
  wab_launch<MAXD>(q, k, v, bias, mask, out, dout, dq, dk, dv, dbias, part, count, B, nW, H, N, \
                   D, drop, stream)
  if (D <= 4) err = WAB_CALL(4);
  else if (D <= 8) err = WAB_CALL(8);
  else if (D <= 16) err = WAB_CALL(16);
  else err = WAB_CALL(32);
#undef WAB_CALL
  return (int)err;
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
