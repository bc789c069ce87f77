// The SwinFusion block's device code, shared by K2/K3 (fusion_block.cu:
// windows (B, nW, N, C), one subject's window at a time) and K7
// (fusion_block_bp.cu: group-major windows (ngroups, nW, N, G*C), one
// (group, window) at a time, walking its G subjects).
//
// The bodies are the same in both: fusion_forward_window runs the whole
// block on one subject's window, fusion_backward_windows its backward on up
// to FUSION_BWD_WINDOWS subjects' windows at one window position at once,
// each read at a given row stride (C in the std layout, G*C in the
// group-major one) with the dropout coordinates the caller gives
// (FusionWindow). Everything else (weights, bias, the window's shift mask)
// is staged by the kernel in shared memory before it calls them. See
// fusion_block.cu for the design notes of the forward and of the backward.
//
// Both bodies are templated on the streams' element type S (float, or
// __nv_bfloat16 for K7's bf16 form) and on MM16, the bf16 policy's products
// (JAX _mm_bp with mm16): every product of bf16-rounded operands with float32
// sums, and the packed mm16 softmax (logits capped at 80, no max
// subtraction, denominators summed from bf16(e), p = e * bf16(1 / den)).
// The body computes in float32 either way; <false, float> is the float32
// body of K2/K3 and K7, unchanged.
#pragma once

#include "common.cuh"

#define FUSION_MAXHD 16
#define FUSION_THREADS 256
#define FUSION_ACC 8
#define FUSION_LOGIT_CAP 80.f   // the mm16 softmax's cap (JAX fusion_block._LOGIT_CAP)

struct FusionParams {
  const float *g1, *b1;      // LN1 of the query stream, (C)
  const float *g1y, *b1y;    // cross: LN1 of the key/value stream, (C)
  const float *wq, *bq;      // self: qkv (3C, C), (3C); cross: q (C, C), (C)
  const float *wkv, *bkv;    // cross: kv (2C, C), (2C)
  const float *wp, *bp;      // proj (C, C), (C)
  const float *g2, *b2;      // LN2 (C)
  const float *w1, *b1m;     // fc1 (Ch, C), (Ch)
  const float *w2, *b2m;     // fc2 (C, Ch), (C)
};

// Training-only inputs: DropPath factors, the four dropout draws, the padded
// window length the dropout coordinates use, and where x2r is saved.
struct FusionTrain {
  const float* dp;           // (B, 2) or NULL (factor 1)
  Dropout attn, proj, mlp1, mlp2;
  int NP;
  float* x2r;                // the stream's shape, or NULL
};

// A stream element widened to float32, and a float32 value stored in the
// stream's type (rounded to nearest even for bf16).
__device__ __forceinline__ float ld_stream(const float* p) { return *p; }
__device__ __forceinline__ float ld_stream(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_stream(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_stream(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One subject's window as a window body sees it: token n, channel c of a
// stream lives at [n * stride + c] from the window's pointer; its dropout
// draws are keyed (row0 + n, colC + c) for proj and fc2, (row0 + n,
// colH + f) for fc1 and (row0 + n, colA + h * NP + key) for the attention.
template <typename S>
struct FusionWindowT {
  const S* x;                // query stream
  const S* y;                // cross: key/value stream
  S* x2r;                    // forward: written if not NULL; backward: read
  S* out;                    // forward output
  const S* g;                // backward: dL/dout
  S* dx;                     // backward outputs
  S* dy;
  int stride;
  uint32_t row0, colC, colH, colA;
  float dp1, dp2;            // DropPath factors of the two residual branches
};
using FusionWindow = FusionWindowT<float>;

// Offsets (in floats) of everything a block keeps in shared memory.
struct FusionLayout {
  int CS, HS, BS;                        // padded row strides: C+1, Ch+1, N+1
  int xs, hs, qs, ks, vs, ys, x2, us;    // activations
  int g1, b1, g1y, b1y, wq, bq, wkv, bkv, wp, bp, g2, b2, w1, b1m, w2, b2m;
  int bias, mask;                        // bias H x N x BS, mask[w] N x BS
  int total;

  __host__ __device__ FusionLayout(bool cross, int N, int C, int H, int Ch) {
    CS = C + 1; HS = Ch + 1; BS = N + 1;
    int off = 0;
    xs = off; off += N * CS;
    hs = off; off += N * CS;
    qs = off; off += N * CS;
    ks = off; off += N * CS;
    vs = off; off += N * CS;
    ys = off; off += cross ? N * CS : 0;
    x2 = off; off += N * CS;
    us = off; off += N * HS;
    g1 = off; off += C;
    b1 = off; off += C;
    g1y = off; off += cross ? C : 0;
    b1y = off; off += cross ? C : 0;
    const int nq = cross ? C : 3 * C;    // rows of the q (or qkv) weight
    wq = off; off += nq * CS;
    bq = off; off += nq;
    wkv = off; off += cross ? 2 * C * CS : 0;
    bkv = off; off += cross ? 2 * C : 0;
    wp = off; off += C * CS;
    bp = off; off += C;
    g2 = off; off += C;
    b2 = off; off += C;
    w1 = off; off += Ch * CS;
    b1m = off; off += Ch;
    w2 = off; off += C * HS;
    b2m = off; off += C;
    bias = off; off += H * N * BS;
    mask = off; off += N * BS;
    total = off;
  }
};

// Global (rows x cols, row-major) -> shared with a padded row stride, by a
// block of NT threads.
// RND: each value rounded to bf16 (a weight matrix of the mm16 body, which
// only ever enters products).
template <int NT = FUSION_THREADS, bool RND = false>
__device__ __forceinline__ void stage(float* dst, int stride, const float* __restrict__ src,
                                      int rows, int cols) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * cols; i += NT)
    dst[(i / cols) * stride + i % cols] = RND ? bf16r(src[i]) : src[i];
}

// As stage, for a window of a stream of type S whose rows lie src_stride
// elements apart.
template <typename S>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const S* __restrict__ src,
                                           int src_stride, int rows, int cols) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * cols; i += FUSION_THREADS)
    dst[(i / cols) * stride + i % cols] =
        ld_stream(src + (size_t)(i / cols) * src_stride + i % cols);
}

// The weights and the bias table at the offsets of F from w (the same for
// every window: a kernel stages them once).
// MM16: the weight matrices rounded to bf16.
template <int NT = FUSION_THREADS, bool MM16 = false>
__device__ __forceinline__ void stage_weights(float* w, const FusionLayout& F, bool cross,
                                              const FusionParams& P, const float* bias, int N,
                                              int C, int H, int Ch) {
  const int CS = F.CS, HS = F.HS, BS = F.BS;
  stage<NT>(w + F.g1, C, P.g1, 1, C);
  stage<NT>(w + F.b1, C, P.b1, 1, C);
  if (cross) {
    stage<NT>(w + F.g1y, C, P.g1y, 1, C);
    stage<NT>(w + F.b1y, C, P.b1y, 1, C);
    stage<NT, MM16>(w + F.wq, CS, P.wq, C, C);
    stage<NT>(w + F.bq, C, P.bq, 1, C);
    stage<NT, MM16>(w + F.wkv, CS, P.wkv, 2 * C, C);
    stage<NT>(w + F.bkv, 2 * C, P.bkv, 1, 2 * C);
  } else {
    stage<NT, MM16>(w + F.wq, CS, P.wq, 3 * C, C);
    stage<NT>(w + F.bq, 3 * C, P.bq, 1, 3 * C);
  }
  stage<NT, MM16>(w + F.wp, CS, P.wp, C, C);
  stage<NT>(w + F.bp, C, P.bp, 1, C);
  stage<NT>(w + F.g2, C, P.g2, 1, C);
  stage<NT>(w + F.b2, C, P.b2, 1, C);
  stage<NT, MM16>(w + F.w1, CS, P.w1, Ch, C);
  stage<NT>(w + F.b1m, Ch, P.b1m, 1, Ch);
  stage<NT, MM16>(w + F.w2, HS, P.w2, C, Ch);
  stage<NT>(w + F.b2m, C, P.b2m, 1, C);
  stage<NT>(w + F.bias, BS, bias, H * N, N);
}

// Two-pass LayerNorm of one C-wide row (nn/common.py semantics, eps 1e-5);
// RND: the output rounded to bf16 (an mm16 product's operand).
template <bool RND = false>
__device__ __forceinline__ void ln_row(const float* src, float* dst, const float* g,
                                       const float* b, int C) {
  float mu = 0.f;
  for (int c = 0; c < C; ++c) mu += src[c];
  mu /= C;
  float var = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d = src[c] - mu;
    var = fmaf(d, d, var);
  }
  var /= C;
  const float r = 1.f / sqrtf(var + 1e-5f);
  for (int c = 0; c < C; ++c) {
    const float h = (src[c] - mu) * r * g[c] + b[c];
    dst[c] = RND ? bf16r(h) : h;
  }
}

// s(n, o) = b[o] + sum_c in[n][c] W[o][c] for all N rows and O outputs, all
// operands in shared memory (W rows padded to K + 1). Thread (n, g) takes
// row n and outputs g, g + G, ... (G = threads / N groups), ACC of them at a
// time in registers; store(n, o, s) consumes each result.
template <int ACC, typename Store>
__device__ __forceinline__ void dense_acc(const float* in, int in_stride, int K,
                                          const float* W, const float* b, int O, int N,
                                          Store store) {
  const int G = FUSION_THREADS / N;
  const int n = threadIdx.x % N, g = threadIdx.x / N;
  if (g >= G) return;
  const float* row = in + n * in_stride;
  for (int o0 = g; o0 < O; o0 += G * ACC) {
    float acc[ACC];
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int o = o0 + a * G;
      acc[a] = o < O ? b[o] : 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < K; ++c) {
      const float xv = row[c];
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int o = o0 + a * G;
        if (o < O) acc[a] = fmaf(xv, W[o * (K + 1) + c], acc[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int o = o0 + a * G;
      if (o < O) store(n, o, acc[a]);
    }
  }
}

// As dense_acc, with ACC the least of 2, 4, 8 that covers the outputs a
// thread owns: the flagship's projections need 2 (C = 12) to 7 (Ch = 48),
// and predicated-off accumulators still cost issue slots.
template <typename Store>
__device__ __forceinline__ void dense(const float* in, int in_stride, int K, const float* W,
                                      const float* b, int O, int N, Store store) {
  const int per_thread = (O + FUSION_THREADS / N - 1) / (FUSION_THREADS / N);
  if (per_thread <= 2) dense_acc<2>(in, in_stride, K, W, b, O, N, store);
  else if (per_thread <= 4) dense_acc<4>(in, in_stride, K, W, b, O, N, store);
  else dense_acc<FUSION_ACC>(in, in_stride, K, W, b, O, N, store);
}

// The forward of one subject's window. The weights and bias are staged at
// L's offsets from smem (MM16: the weight matrices rounded to bf16) and, if
// masked, the window's shift mask at L.mask; the body stages the window's
// streams itself and ends on a barrier, so the caller may then restage
// anything. Under MM16 every buffer that feeds a product (LN outputs, q
// pre-scaled, k, v, the attention output, GELU(u) * m1) is stored rounded to
// bf16, so the products below are those of JAX's mm16 body.
template <bool CROSS, int MAXHD, bool MM16 = false, typename S = float>
__device__ __forceinline__ void fusion_forward_window(float* smem, const FusionLayout& L,
                                                      bool masked, int N, int C, int H, int Ch,
                                                      const FusionTrain& T,
                                                      const FusionWindowT<S>& W) {
  const int CS = L.CS, HS = L.HS, BS = L.BS;
  float* xs = smem + L.xs;
  float* hs = smem + L.hs;    // LN1(x), later the attention output o
  float* qs = smem + L.qs;    // q (pre-scaled), later LN2(x2)
  float* ks = smem + L.ks;
  float* vs = smem + L.vs;
  float* ys = smem + L.ys;    // cross: y window, normalised in place by LN1_y
  float* x2 = smem + L.x2;    // x + proj(o)
  float* us = smem + L.us;    // GELU(fc1(LN2(x2)))
  float* bs = smem + L.bias;  // bias[h], H x N x BS
  float* ms = smem + L.mask;  // mask[w], N x BS
  auto rnd = [](float v) { return MM16 ? bf16r(v) : v; };

  const int tid = threadIdx.x;
  const int hd = C / H;
  const float scale = 1.f / sqrtf((float)hd);
  const int Sd = W.stride;
  const uint32_t row0 = W.row0;
  const float dp1 = W.dp1, dp2 = W.dp2;

  stage_rows(xs, CS, W.x, Sd, N, C);
  if (CROSS) stage_rows(ys, CS, W.y, Sd, N, C);
  __syncthreads();

  for (int n = tid; n < N; n += FUSION_THREADS) {
    ln_row<MM16>(xs + n * CS, hs + n * CS, smem + L.g1, smem + L.b1, C);
    if (CROSS) ln_row<MM16>(ys + n * CS, ys + n * CS, smem + L.g1y, smem + L.b1y, C);
  }
  __syncthreads();

  if (CROSS) {
    dense(hs, CS, C, smem + L.wq, smem + L.bq, C, N,
          [&](int n, int o, float s) { qs[n * CS + o] = rnd(s * scale); });
    dense(ys, CS, C, smem + L.wkv, smem + L.bkv, 2 * C, N, [&](int n, int o, float s) {
      if (o < C) ks[n * CS + o] = rnd(s);
      else vs[n * CS + o - C] = rnd(s);
    });
  } else {
    dense(hs, CS, C, smem + L.wq, smem + L.bq, 3 * C, N, [&](int n, int o, float s) {
      if (o < C) qs[n * CS + o] = rnd(s * scale);
      else if (o < 2 * C) ks[n * CS + o - C] = rnd(s);
      else vs[n * CS + o - 2 * C] = rnd(s);
    });
  }
  __syncthreads();

  // attention: one (head, query row) per thread, probabilities in
  // registers; the key loops are unrolled so that four keys' loads and
  // dot products are in flight at once
  for (int i = tid; i < H * N; i += FUSION_THREADS) {
    const int h = i / N, n = i % N;
    const int c0 = h * hd;
    float qi[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) qi[d] = d < hd ? qs[n * CS + c0 + d] : 0.f;
    const float* brow = bs + i * BS;
    const float* mrow = masked ? ms + n * BS : nullptr;
    float acc[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) acc[d] = 0.f;
    if constexpr (MM16) {
      // e = exp(min(s, 80)); den = sum bf16(e); p = e * bf16(1 / den); the
      // context sums bf16(p * keep) v
      float den = 0.f;
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) s = fmaf(qi[d], ks[j * CS + c0 + d], s);
        den += bf16r(expf(fminf(s, FUSION_LOGIT_CAP)));
      }
      const float rd = bf16r(1.f / fmaxf(den, 1e-38f));
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) s = fmaf(qi[d], ks[j * CS + c0 + d], s);
        const float pb = bf16r(expf(fminf(s, FUSION_LOGIT_CAP)) * rd *
                               keep(T.attn, row0 + n, W.colA + (uint32_t)(h * T.NP + j)));
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) acc[d] = fmaf(pb, vs[j * CS + c0 + d], acc[d]);
      }
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) hs[n * CS + c0 + d] = bf16r(acc[d]);
    } else {
      float m = -INFINITY;
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) s = fmaf(qi[d], ks[j * CS + c0 + d], s);
        m = fmaxf(m, s);
      }
      float l = 0.f;
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) s = fmaf(qi[d], ks[j * CS + c0 + d], s);
        const float p = expf(s - m);
        l += p;
        // dropout of the normalised probability: keep/(1-rate) factors the
        // same way out of the 1/l below
        const float pk = p * keep(T.attn, row0 + n, W.colA + (uint32_t)(h * T.NP + j));
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) acc[d] = fmaf(pk, vs[j * CS + c0 + d], acc[d]);
      }
      const float inv = 1.f / l;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) hs[n * CS + c0 + d] = acc[d] * inv;
    }
  }
  __syncthreads();

  dense(hs, CS, C, smem + L.wp, smem + L.bp, C, N, [&](int n, int o, float s) {
    const float r = xs[n * CS + o] + dp1 * (s * keep(T.proj, row0 + n, W.colC + o));
    x2[n * CS + o] = r;
    if (W.x2r) st_stream(W.x2r + (size_t)n * Sd + o, r);
  });
  __syncthreads();

  for (int n = tid; n < N; n += FUSION_THREADS)
    ln_row<MM16>(x2 + n * CS, qs + n * CS, smem + L.g2, smem + L.b2, C);
  __syncthreads();

  dense(qs, CS, C, smem + L.w1, smem + L.b1m, Ch, N, [&](int n, int o, float s) {
    us[n * HS + o] = rnd(gelu_erf(s) * keep(T.mlp1, row0 + n, W.colH + o));
  });
  __syncthreads();

  dense(us, HS, Ch, smem + L.w2, smem + L.b2m, C, N, [&](int n, int o, float s) {
    st_stream(W.out + (size_t)n * Sd + o,
              x2[n * CS + o] + dp2 * (s * keep(T.mlp2, row0 + n, W.colC + o)));
  });
  __syncthreads();  // the next window overwrites xs, ys and ms
}

// ---------------------------------------------------------------------------
// Backward (design notes in fusion_block.cu): a block runs the backward of
// up to FUSION_BWD_WINDOWS windows at once, in lockstep, every phase's
// loop spanning all of them.
// ---------------------------------------------------------------------------

#define FUSION_BWD_THREADS 512
#define FUSION_BWD_WINDOWS 4

// Offsets of the flat gradient vector: the parameters in the kernels' order
// (self: wq/bq hold wqkv/bqkv), then dbias (H, N, N).
struct FusionGrads {
  int g1, b1, g1y, b1y, wq, bq, wkv, bkv, wp, bp, g2, b2, w1, b1m, w2, b2m, bias, total;

  __host__ __device__ FusionGrads(bool cross, int N, int C, int H, int Ch) {
    int off = 0;
    g1 = off; off += C;
    b1 = off; off += C;
    g1y = off; off += cross ? C : 0;
    b1y = off; off += cross ? C : 0;
    const int nq = cross ? C : 3 * C;
    wq = off; off += nq * C;
    bq = off; off += nq;
    wkv = off; off += cross ? 2 * C * C : 0;
    bkv = off; off += cross ? 2 * C : 0;
    wp = off; off += C * C;
    bp = off; off += C;
    g2 = off; off += C;
    b2 = off; off += C;
    w1 = off; off += Ch * C;
    b1m = off; off += Ch;
    w2 = off; off += C * Ch;
    b2m = off; off += C;
    bias = off; off += H * N * N;
    total = off;
  }
};

// Shared-memory offsets (floats) of the backward kernels. Once a block: the
// accumulators (FusionGrads), then the forward's weights, bias and mask
// (FusionLayout's tail, at fwd + its offsets). Then one arena a window in
// flight, `arena` floats each; inside an arena the buffers are laid out by
// liveness (S = N (C+1), U = N (Ch+1), Q = N (3C+1) floats):
//   p0  g, then dx2r = dL/dx2 (in place)                      whole window
//   p1  x2r -> xh2 (LN2 in place); then x -> xh1 (LN1 in place)
//   p2  h2 = LN2(x2r); then da = dL/d(proj out)
//   p3  dz; dh2; dO = dL/d(attention out); dh1
//   p6  cross: y -> xh1y (LN1_y in place)
//   R   MLP phase: u -> du (in place) at R, GELU(u) at R + U;
//       attention phase: h1, q, k, v, o at R + {0..4} S, dqkv (q | k | v
//       columns) at R + 5S, cross h1y at R + 5S + Q; dh1y over q
// and r1, r2, r1y (row rsqrt) and lse, D (H x N) after R.
struct FusionBwdLayout {
  int CS, HS, BS, QS;
  int p0, p1, p2, p3, p6, us, gus, h1, qs, ks, vs, os, dqkv, h1y, dh1y;
  int r1, r2, r1y, lse, Dd, arena;
  int acc, fwd, win, total;

  __host__ __device__ FusionBwdLayout(bool cross, int N, int C, int H, int Ch, int windows) {
    CS = C + 1; HS = Ch + 1; BS = N + 1; QS = 3 * C + 1;
    const int S = N * CS, U = N * HS, Q = N * QS;
    p0 = 0; p1 = S; p2 = 2 * S; p3 = 3 * S;
    int off = 4 * S;
    p6 = off; off += cross ? S : 0;
    const int R = off;
    us = R; gus = R + U;
    h1 = R; qs = R + S; ks = R + 2 * S; vs = R + 3 * S; os = R + 4 * S; dqkv = R + 5 * S;
    h1y = dqkv + Q;
    dh1y = qs;
    const int attn = 5 * S + Q + (cross ? S : 0);
    off = R + (2 * U > attn ? 2 * U : attn);
    r1 = off; off += N;
    r2 = off; off += N;
    r1y = off; off += cross ? N : 0;
    lse = off; off += H * N;
    Dd = off; off += H * N;
    arena = off;
    const FusionLayout F(cross, N, C, H, Ch);
    acc = 0;
    off = FusionGrads(cross, N, C, H, Ch).total;
    fwd = off - F.g1;   // FusionLayout offsets are relative to fwd
    off += F.total - F.g1;
    win = off;
    total = off + windows * arena;
  }
};

// s(k, n, o) = (b ? b[o] : 0) + sum_c in_k[n][c] W(o, c) over the rows n of
// every window k in flight, W(o, c) = W[o * wo + c * wk] (a weight read
// row-wise or transposed); `in` at offset in_off of each window's arena.
// A thread owns OT consecutive outputs of one row: one load of the row's
// element feeds OT FMAs, lanes on consecutive rows, so each weight element
// is a broadcast. Each sum runs in the order c = 0, 1, ... RND: the input
// element rounded to bf16 (the mm16 body, whose staged weights are rounded).
template <bool RND = false, typename Store>
__device__ __forceinline__ void dense_w(const float* win, int arena, int in_off, int in_stride,
                                        int K, const float* W, int wo, int wk, const float* b,
                                        int O, int N, int kw, Store store) {
  constexpr int OT = 4;
  const int rows = kw * N, groups = (O + OT - 1) / OT;
  for (int e = threadIdx.x; e < rows * groups; e += FUSION_BWD_THREADS) {
    const int r = e % rows, o0 = (e / rows) * OT;
    const int k = r / N, n = r % N;
    const float* row = win + k * arena + in_off + n * in_stride;
    const float* wr[OT];
    float s[OT];
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      const int o = min(o0 + t, O - 1);   // past O: a valid row, never stored
      wr[t] = W + o * wo;
      s[t] = b ? b[o] : 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < K; ++c) {
      const float xv = RND ? bf16r(row[c]) : row[c];
#pragma unroll
      for (int t = 0; t < OT; ++t) s[t] = fmaf(xv, wr[t][c * wk], s[t]);
    }
#pragma unroll
    for (int t = 0; t < OT; ++t)
      if (o0 + t < O) store(k, n, o0 + t, s[t]);
  }
}

// One weight-gradient element, acc[e] += sum_k sum_n A_k[n][o] B_k[n][j]
// (e = o * J + j) over the windows in flight, in the order k, then n (two
// chains, even and odd n, added at the end): the same order every run.
// RND: both factors rounded to bf16 (the mm16 body).
template <bool RND = false>
__device__ __forceinline__ void outer_elem(float* acc, int e, const float* win, int arena,
                                           int a_off, int as, int b_off, int bs, int J,
                                           int N, int kw) {
  const int o = e / J, j = e % J;
  float s0 = 0.f, s1 = 0.f;
  for (int k = 0; k < kw; ++k) {
    const float* A = win + k * arena + a_off + o;
    const float* B = win + k * arena + b_off + j;
    int n = 0;
    auto r = [](float v) { return RND ? bf16r(v) : v; };
    for (; n + 1 < N; n += 2) {
      s0 = fmaf(r(A[n * as]), r(B[n * bs]), s0);
      s1 = fmaf(r(A[(n + 1) * as]), r(B[(n + 1) * bs]), s1);
    }
    if (n < N) s0 = fmaf(r(A[n * as]), r(B[n * bs]), s0);
  }
  acc[e] += s0 + s1;
}

// One column-sum element, acc[o] += sum_k sum_n A_k[n][o] (B_k[n][o] if
// b_off >= 0): bias and LayerNorm-scale gradients.
__device__ __forceinline__ void cols_elem(float* acc, int o, const float* win, int arena,
                                          int a_off, int as, int b_off, int bs, int N, int kw) {
  float s = 0.f;
  for (int k = 0; k < kw; ++k) {
    const float* A = win + k * arena + a_off + o;
    const float* B = win + k * arena + b_off + o;
    for (int n = 0; n < N; ++n) s += b_off >= 0 ? A[n * as] * B[n * bs] : A[n * as];
  }
  acc[o] += s;
}

// Block-wide (threads t0, t0 + 1, ... of a team of nt): every element of an
// O x J weight gradient / an O-wide column sum has one owner thread.
template <bool RND = false>
__device__ __forceinline__ void acc_outer_w(float* acc, const float* win, int arena, int a_off,
                                            int as, int O, int b_off, int bs, int J, int N,
                                            int kw, int t0 = 0,
                                            int nt = FUSION_BWD_THREADS) {
  for (int e = threadIdx.x - t0; e < O * J; e += nt)
    outer_elem<RND>(acc, e, win, arena, a_off, as, b_off, bs, J, N, kw);
}

__device__ __forceinline__ void acc_cols_w(float* acc, const float* win, int arena, int a_off,
                                           int as, int b_off, int bs, int O, int N, int kw,
                                           int t0 = 0, int nt = FUSION_BWD_THREADS) {
  for (int o = threadIdx.x - t0; o < O; o += nt)
    cols_elem(acc, o, win, arena, a_off, as, b_off, bs, N, kw);
}

// Two-pass LayerNorm of one row keeping the normalised row xh (xh may be
// src: each element is read before it is overwritten); returns rsqrt.
__device__ __forceinline__ float ln_fwd_row(const float* src, float* xh, float* h,
                                            const float* g, const float* b, int C) {
  float mu = 0.f;
  for (int c = 0; c < C; ++c) mu += src[c];
  mu /= C;
  float var = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d = src[c] - mu;
    var = fmaf(d, d, var);
  }
  var /= C;
  const float r = 1.f / sqrtf(var + 1e-5f);
  for (int c = 0; c < C; ++c) {
    xh[c] = (src[c] - mu) * r;
    h[c] = xh[c] * g[c] + b[c];
  }
  return r;
}

// dst[c] = (add ? add[c] : 0) + r (dh g - mean(dh g) - xh mean(dh g xh)):
// fusion_block.py _ln_bwd (dst may be add; a stream row of float or bf16).
template <typename D>
__device__ __forceinline__ void ln_bwd_row(const float* dh, const float* xh, float r,
                                           const float* g, const float* add, D* dst,
                                           int C) {
  float m1 = 0.f, m2 = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d = dh[c] * g[c];
    m1 += d;
    m2 = fmaf(d, xh[c], m2);
  }
  m1 /= C;
  m2 /= C;
  for (int c = 0; c < C; ++c)
    st_stream(dst + c, (add ? add[c] : 0.f) + r * (dh[c] * g[c] - m1 - xh[c] * m2));
}

// The backward of kw <= FUSION_BWD_WINDOWS windows at once (wins[k] for
// window k, all sharing the shift mask staged at L.fwd + F.mask): adds
// their share of every parameter gradient and of dbias to the block's
// accumulators at L.acc, in window order, and writes dx (and dy). Weights
// and bias are staged at L.fwd + the FusionLayout offsets; the caller has
// synchronised after staging wins and the mask; ends on a barrier.
// MM16 (JAX's mm16 backward): weights staged rounded to bf16, every product
// reads its activations rounded (dense_w / outer_elem with RND), q, k, v and
// dL/do stored rounded for the attention, whose backward rebuilds the mm16
// softmax: p = e * rden, seg = bf16(sum_j bf16(dp p)), ds = p (dp - seg),
// with rden and seg kept where the float32 body keeps lse and D.
template <bool CROSS, int MAXHD, bool MM16 = false, typename S = float>
__device__ __forceinline__ void fusion_backward_windows(float* smem, const FusionBwdLayout& L,
                                                        const FusionLayout& F,
                                                        const FusionGrads& G, bool masked,
                                                        int N, int C, int H, int Ch,
                                                        const FusionTrain& T,
                                                        const FusionWindowT<S>* wins, int kw) {
  constexpr int NT = FUSION_BWD_THREADS;
  const int CS = L.CS, HS = L.HS, BS = L.BS, QS = L.QS, AR = L.arena;
  const float* w = smem + L.fwd;    // + FusionLayout offset -> staged weight
  float* acc = smem + L.acc;
  float* win = smem + L.win;
  const float* bs = w + F.bias;
  const float* ms = w + F.mask;
  const int tid = threadIdx.x;
  const int hd = C / H;
  const float scale = 1.f / sqrtf((float)hd);
  const int rows = kw * N, HN = H * N;
  auto rnd = [](float v) { return MM16 ? bf16r(v) : v; };

  // ---- MLP / LN2 side over the saved x2r ------------------------------------
  for (int e = tid; e < rows * C; e += NT) {
    const int r = e / C, c = e % C, k = r / N, n = r % N;
    const FusionWindowT<S>& W = wins[k];
    float* a = win + k * AR + n * CS + c;
    const size_t src = (size_t)n * W.stride + c;
    a[L.p0] = ld_stream(W.g + src);
    a[L.p1] = ld_stream(W.x2r + src);
  }
  __syncthreads();
  for (int r = tid; r < rows; r += NT) {
    float* a = win + (r / N) * AR + (r % N) * CS;
    win[(r / N) * AR + L.r2 + r % N] =
        ln_fwd_row(a + L.p1, a + L.p1, a + L.p2, w + F.g2, w + F.b2, C);
  }
  for (int e = tid; e < rows * C; e += NT) {
    const int r = e / C, c = e % C, k = r / N, n = r % N;
    const FusionWindowT<S>& W = wins[k];
    float* a = win + k * AR + n * CS + c;
    a[L.p3] = W.dp2 * a[L.p0] * keep(T.mlp2, W.row0 + n, W.colC + c);   // dz
  }
  __syncthreads();
  // u = fc1(h2) and GELU(u) * m1
  dense_w<MM16>(win, AR, L.p2, CS, C, w + F.w1, CS, 1, w + F.b1m, Ch, N, kw,
          [&](int k, int n, int o, float s) {
            float* a = win + k * AR + n * HS + o;
            a[L.us] = s;
            a[L.gus] = gelu_erf(s) * keep(T.mlp1, wins[k].row0 + n, wins[k].colH + o);
             });
  __syncthreads();
  // du = (dz W2) * m1 * GELU'(u), written over u
  dense_w<MM16>(win, AR, L.p3, CS, C, w + F.w2, 1, HS, nullptr, Ch, N, kw,
          [&](int k, int n, int j, float s) {
            float* u = win + k * AR + L.us + n * HS + j;
            *u = s * keep(T.mlp1, wins[k].row0 + n, wins[k].colH + j) * gelu_erf_grad(*u);
             });
  acc_outer_w<MM16>(acc + G.w2, win, AR, L.p3, CS, C, L.gus, HS, Ch, N, kw);
  acc_cols_w(acc + G.b2m, win, AR, L.p3, CS, -1, 0, C, N, kw);
  __syncthreads();
  acc_outer_w<MM16>(acc + G.w1, win, AR, L.us, HS, Ch, L.p2, CS, C, N, kw);
  acc_cols_w(acc + G.b1m, win, AR, L.us, HS, -1, 0, Ch, N, kw);
  dense_w<MM16>(win, AR, L.us, HS, Ch, w + F.w1, 1, CS, nullptr, C, N, kw,
          [&](int k, int n, int c, float s) { win[k * AR + L.p3 + n * CS + c] = s; });  // dh2
  __syncthreads();
  acc_cols_w(acc + G.g2, win, AR, L.p3, CS, L.p1, CS, C, N, kw);
  acc_cols_w(acc + G.b2, win, AR, L.p3, CS, -1, 0, C, N, kw);
  for (int r = tid; r < rows; r += NT) {
    float* a = win + (r / N) * AR + (r % N) * CS;
    ln_bwd_row(a + L.p3, a + L.p1, win[(r / N) * AR + L.r2 + r % N], w + F.g2, a + L.p0,
               a + L.p0, C);   // dx2r over g
  }
  __syncthreads();
  for (int e = tid; e < rows * C; e += NT) {
    const int r = e / C, c = e % C, k = r / N, n = r % N;
    const FusionWindowT<S>& W = wins[k];
    float* a = win + k * AR + n * CS + c;
    const size_t src = (size_t)n * W.stride + c;
    a[L.p2] = W.dp1 * a[L.p0] * keep(T.proj, W.row0 + n, W.colC + c);   // da
    a[L.p1] = ld_stream(W.x + src);
    if (CROSS) a[L.p6] = ld_stream(W.y + src);
  }
  __syncthreads();

  // ---- proj backward, LN1 and q/k/v recompute --------------------------------
  dense_w<MM16>(win, AR, L.p2, CS, C, w + F.wp, 1, CS, nullptr, C, N, kw,
                [&](int k, int n, int c, float s) {
                  win[k * AR + L.p3 + n * CS + c] = rnd(s);   // dO
                });
  acc_cols_w(acc + G.bp, win, AR, L.p2, CS, -1, 0, C, N, kw);
  for (int r = tid; r < rows; r += NT) {
    const int k = r / N, n = r % N;
    float* a = win + k * AR;
    a[L.r1 + n] = ln_fwd_row(a + L.p1 + n * CS, a + L.p1 + n * CS, a + L.h1 + n * CS, w + F.g1,
                             w + F.b1, C);
    if (CROSS)
      a[L.r1y + n] = ln_fwd_row(a + L.p6 + n * CS, a + L.p6 + n * CS, a + L.h1y + n * CS,
                                w + F.g1y, w + F.b1y, C);
  }
  __syncthreads();
  if (CROSS) {
    dense_w<MM16>(win, AR, L.h1, CS, C, w + F.wq, CS, 1, w + F.bq, C, N, kw,
                  [&](int k, int n, int o, float s) {
                    win[k * AR + L.qs + n * CS + o] = rnd(s * scale);
                  });
    dense_w<MM16>(win, AR, L.h1y, CS, C, w + F.wkv, CS, 1, w + F.bkv, 2 * C, N, kw,
                  [&](int k, int n, int o, float s) {
                    float* a = win + k * AR + n * CS;
                    if (o < C) a[L.ks + o] = rnd(s);
                    else a[L.vs + o - C] = rnd(s);
                  });
  } else {
    dense_w<MM16>(win, AR, L.h1, CS, C, w + F.wq, CS, 1, w + F.bq, 3 * C, N, kw,
                  [&](int k, int n, int o, float s) {
                    float* a = win + k * AR + n * CS;
                    if (o < C) a[L.qs + o] = rnd(s * scale);
                    else if (o < 2 * C) a[L.ks + o - C] = rnd(s);
                    else a[L.vs + o - 2 * C] = rnd(s);
                  });
  }
  __syncthreads();

  // ---- attention, row pass: one (window, head, query) per thread -------------
  for (int i = tid; i < kw * HN; i += NT) {
    const int k = i / HN, hi = i % HN, h = hi / N, n = hi % N, c0 = h * hd;
    const FusionWindowT<S>& W = wins[k];
    float* a = win + k * AR;
    const float *ks = a + L.ks, *vs = a + L.vs;
    float qi[MAXHD], gi[MAXHD], oa[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) {
      qi[d] = d < hd ? a[L.qs + n * CS + c0 + d] : 0.f;
      gi[d] = d < hd ? a[L.p3 + n * CS + c0 + d] : 0.f;
      oa[d] = 0.f;
    }
    const float* brow = bs + hi * BS;
    const float* mrow = masked ? ms + n * BS : nullptr;
    const uint32_t rr = W.row0 + n, ca = W.colA + (uint32_t)(h * T.NP);
    float dq[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) dq[d] = 0.f;
    if constexpr (MM16) {
      // p = e * rden; o = sum bf16(p keep) v; seg = bf16(sum bf16(dp p));
      // dq = scale sum bf16(p (dp - seg)) k
      float den = 0.f;
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) s = fmaf(qi[d], ks[j * CS + c0 + d], s);
        den += bf16r(expf(fminf(s, FUSION_LOGIT_CAP)));
      }
      const float rd = bf16r(1.f / fmaxf(den, 1e-38f));
      float sacc = 0.f;
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f), dpd = 0.f;
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) {
            s = fmaf(qi[d], ks[j * CS + c0 + d], s);
            dpd = fmaf(gi[d], vs[j * CS + c0 + d], dpd);
          }
        const float p = expf(fminf(s, FUSION_LOGIT_CAP)) * rd;
        const float kp = keep(T.attn, rr, ca + j);
        const float pb = bf16r(p * kp);
        sacc += bf16r(dpd * kp * p);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) oa[d] = fmaf(pb, vs[j * CS + c0 + d], oa[d]);
      }
      const float seg = bf16r(sacc);
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f), dpd = 0.f;
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) {
            s = fmaf(qi[d], ks[j * CS + c0 + d], s);
            dpd = fmaf(gi[d], vs[j * CS + c0 + d], dpd);
          }
        const float p = expf(fminf(s, FUSION_LOGIT_CAP)) * rd;
        const float ds = bf16r(p * (dpd * keep(T.attn, rr, ca + j) - seg));
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) dq[d] = fmaf(ds, ks[j * CS + c0 + d], dq[d]);
      }
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) a[L.os + n * CS + c0 + d] = oa[d];
      a[L.lse + hi] = rd;
      a[L.Dd + hi] = seg;
    } else {
      float m = -INFINITY;
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) s = fmaf(qi[d], ks[j * CS + c0 + d], s);
        m = fmaxf(m, s);
      }
      float l = 0.f;
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) s = fmaf(qi[d], ks[j * CS + c0 + d], s);
        const float p = expf(s - m);
        l += p;
        const float pk = p * keep(T.attn, rr, ca + j);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) oa[d] = fmaf(pk, vs[j * CS + c0 + d], oa[d]);
      }
      const float inv = 1.f / l;
      float Di = 0.f;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          oa[d] *= inv;
          a[L.os + n * CS + c0 + d] = oa[d];
          Di = fmaf(gi[d], oa[d], Di);
        }
      a[L.lse + hi] = m + logf(l);
      a[L.Dd + hi] = Di;
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f), dp = 0.f;
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) {
            s = fmaf(qi[d], ks[j * CS + c0 + d], s);
            dp = fmaf(gi[d], vs[j * CS + c0 + d], dp);
          }
        const float p = expf(s - m) * inv;
        const float ds = p * (dp * keep(T.attn, rr, ca + j) - Di);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) dq[d] = fmaf(ds, ks[j * CS + c0 + d], dq[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) a[L.dqkv + n * QS + c0 + d] = dq[d] * scale;
  }
  __syncthreads();

  // ---- attention, column pass: one (head, key) per thread over the windows
  // in order (the thread owns dbias[h][:, key]); beside it, threads the pass
  // leaves free add the gradients that need no dk/dv: proj (da, o) and the
  // q rows of the q (qkv) weight and bias.
  const int side_n = 2 * C * C + C;
  auto side = [&](int u) {
    if (u < C * C) outer_elem<MM16>(acc + G.wp, u, win, AR, L.p2, CS, L.os, CS, C, N, kw);
    else if (u < 2 * C * C)
      outer_elem<MM16>(acc + G.wq, u - C * C, win, AR, L.dqkv, QS, L.h1, CS, C, N, kw);
    else cols_elem(acc + G.bq, u - 2 * C * C, win, AR, L.dqkv, QS, -1, 0, N, kw);
  };
  const bool beside = NT - HN >= 64;
  for (int i = tid; i < HN; i += NT) {
    const int h = i / N, j = i % N, c0 = h * hd;
    float* db = acc + G.bias + (size_t)h * N * N + j;
    for (int k = 0; k < kw; ++k) {
      const FusionWindowT<S>& W = wins[k];
      float* a = win + k * AR;
      const float *qs = a + L.qs, *dO = a + L.p3, *lse = a + L.lse + h * N,
                  *Dd = a + L.Dd + h * N;
      float kj[MAXHD], vj[MAXHD], dk[MAXHD], dv[MAXHD];
#pragma unroll
      for (int d = 0; d < MAXHD; ++d) {
        kj[d] = d < hd ? a[L.ks + j * CS + c0 + d] : 0.f;
        vj[d] = d < hd ? a[L.vs + j * CS + c0 + d] : 0.f;
        dk[d] = dv[d] = 0.f;
      }
      const uint32_t ca = W.colA + (uint32_t)(h * T.NP + j);
      for (int n = 0; n < N; ++n) {
        float s = bs[(h * N + n) * BS + j] + (masked ? ms[n * BS + j] : 0.f), dp = 0.f;
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) {
            s = fmaf(qs[n * CS + c0 + d], kj[d], s);
            dp = fmaf(dO[n * CS + c0 + d], vj[d], dp);
          }
        // lse / Dd hold rden / seg under MM16
        const float p = MM16 ? expf(fminf(s, FUSION_LOGIT_CAP)) * lse[n] : expf(s - lse[n]);
        const float kp = keep(T.attn, W.row0 + n, ca);
        const float ds = p * (dp * kp - Dd[n]);
        db[n * N] += ds;
        const float dsr = rnd(ds), pkr = rnd(p * kp);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) {
            dk[d] = fmaf(dsr, qs[n * CS + c0 + d], dk[d]);
            dv[d] = fmaf(pkr, dO[n * CS + c0 + d], dv[d]);
          }
      }
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          a[L.dqkv + j * QS + C + c0 + d] = dk[d];
          a[L.dqkv + j * QS + 2 * C + c0 + d] = dv[d];
        }
    }
  }
  if (beside && tid >= HN)
    for (int u = tid - HN; u < side_n; u += NT - HN) side(u);
  __syncthreads();
  if (!beside)
    for (int u = tid; u < side_n; u += NT) side(u);

  // ---- k/v parameter gradients, dh1 (dh1y), LN1 backward ---------------------
  if (CROSS) {
    acc_outer_w<MM16>(acc + G.wkv, win, AR, L.dqkv + C, QS, 2 * C, L.h1y, CS, C, N, kw);
    acc_cols_w(acc + G.bkv, win, AR, L.dqkv + C, QS, -1, 0, 2 * C, N, kw);
    dense_w<MM16>(win, AR, L.dqkv, QS, C, w + F.wq, 1, CS, nullptr, C, N, kw,
                  [&](int k, int n, int c, float s) { win[k * AR + L.p3 + n * CS + c] = s; });
    dense_w<MM16>(win, AR, L.dqkv + C, QS, 2 * C, w + F.wkv, 1, CS, nullptr, C, N, kw,
                  [&](int k, int n, int c, float s) {
                    win[k * AR + L.dh1y + n * CS + c] = s;
                  });
  } else {
    acc_outer_w<MM16>(acc + G.wq + C * C, win, AR, L.dqkv + C, QS, 2 * C, L.h1, CS, C, N, kw);
    acc_cols_w(acc + G.bq + C, win, AR, L.dqkv + C, QS, -1, 0, 2 * C, N, kw);
    dense_w<MM16>(win, AR, L.dqkv, QS, 3 * C, w + F.wq, 1, CS, nullptr, C, N, kw,
                  [&](int k, int n, int c, float s) { win[k * AR + L.p3 + n * CS + c] = s; });
  }
  __syncthreads();
  acc_cols_w(acc + G.g1, win, AR, L.p3, CS, L.p1, CS, C, N, kw);
  acc_cols_w(acc + G.b1, win, AR, L.p3, CS, -1, 0, C, N, kw);
  if (CROSS) {
    acc_cols_w(acc + G.g1y, win, AR, L.dh1y, CS, L.p6, CS, C, N, kw);
    acc_cols_w(acc + G.b1y, win, AR, L.dh1y, CS, -1, 0, C, N, kw);
  }
  for (int r = tid; r < rows; r += NT) {
    const int k = r / N, n = r % N;
    const FusionWindowT<S>& W = wins[k];
    float* a = win + k * AR;
    ln_bwd_row(a + L.p3 + n * CS, a + L.p1 + n * CS, a[L.r1 + n], w + F.g1, a + L.p0 + n * CS,
               W.dx + (size_t)n * W.stride, C);
    if (CROSS)
      ln_bwd_row(a + L.dh1y + n * CS, a + L.p6 + n * CS, a[L.r1y + n], w + F.g1y, nullptr,
                 W.dy + (size_t)n * W.stride, C);
  }
  __syncthreads();  // the next windows overwrite the arenas, wins and the mask
}

// ---------------------------------------------------------------------------
// Launch plumbing shared by K2/K3 and K7.
// ---------------------------------------------------------------------------

// A grid that fills the card once (blocks of `threads` then walk their work
// items); per_sm_out, if given, receives the resident blocks an SM takes.
template <typename Kernel>
static cudaError_t persistent_grid(Kernel kernel, size_t smem, int items, int* blocks,
                                   int threads = FUSION_THREADS, int* per_sm_out = nullptr) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm_out) *per_sm_out = per_sm;
  *blocks = items < sms * per_sm ? items : sms * per_sm;
  return cudaSuccess;
}

// Windows in flight a backward block (at most FUSION_BWD_WINDOWS and
// `limit`, the subjects that share a window position) and its dynamic
// shared memory: as many windows as fit in what a block may opt into.
static cudaError_t backward_windows(bool cross, int N, int C, int H, int Ch, int limit,
                                    int* windows, size_t* smem) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  const size_t fixed = sizeof(FusionWindow) * FUSION_BWD_WINDOWS;   // static: wins[]
  for (int kw = limit < FUSION_BWD_WINDOWS ? limit : FUSION_BWD_WINDOWS; kw >= 1; --kw) {
    const size_t bytes = (size_t)FusionBwdLayout(cross, N, C, H, Ch, kw).total * sizeof(float);
    if (bytes + fixed <= (size_t)optin) {
      *windows = kw;
      *smem = bytes;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

static FusionParams unpack_params(int cross, const void* const* params) {
  const float* const* p = reinterpret_cast<const float* const*>(params);
  FusionParams P = {};
  if (cross) {
    P.g1 = p[0]; P.b1 = p[1]; P.g1y = p[2]; P.b1y = p[3];
    P.wq = p[4]; P.bq = p[5]; P.wkv = p[6]; P.bkv = p[7];
    p += 8;
  } else {
    P.g1 = p[0]; P.b1 = p[1]; P.wq = p[2]; P.bq = p[3];
    p += 4;
  }
  P.wp = p[0]; P.bp = p[1]; P.g2 = p[2]; P.b2 = p[3];
  P.w1 = p[4]; P.b1m = p[5]; P.w2 = p[6]; P.b2m = p[7];
  return P;
}

static FusionTrain make_train(const float* dp, int seed, double attn_rate, double drop_rate,
                              int NP, float* x2r) {
  FusionTrain T;
  T.dp = dp;
  T.attn = make_dropout(seed, 3, attn_rate);
  T.proj = make_dropout(seed, 0, drop_rate);
  T.mlp1 = make_dropout(seed, 1, drop_rate);
  T.mlp2 = make_dropout(seed, 2, drop_rate);
  T.NP = NP;
  T.x2r = x2r;
  return T;
}

static bool bad_dims(int N, int C, int H) {
  return H < 1 || C % H != 0 || C / H > FUSION_MAXHD || N < 1 || N > FUSION_THREADS;
}

// The flagship's head dim is 2; anything wider takes the general bound. Two
// instantiations per direction keep nvcc's time small.
#define FUSION_DISPATCH(cross, hd, F)                        \
  ((cross) ? ((hd) <= 2 ? F(true, 2) : F(true, FUSION_MAXHD)) \
           : ((hd) <= 2 ? F(false, 2) : F(false, FUSION_MAXHD)))
