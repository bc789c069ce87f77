// The SwinFusion block's device code, shared by K2/K3 (fusion_block.cu:
// windows (B, nW, N, C), one subject's window at a time) and K7
// (fusion_block_bp.cu: group-major windows (ngroups, nW, N, G*C), one
// (group, window) at a time, walking its G subjects).
//
// A window's body is the same in both: fusion_forward_window and
// fusion_backward_window run the whole block on one subject's window, read
// at a given row stride (C in the std layout, G*C in the group-major one)
// with the dropout coordinates the caller gives (FusionWindow). Everything
// else (weights, bias, the window's shift mask) is staged by the kernel in
// shared memory before it calls them. See fusion_block.cu for the design
// notes of the forward and of the backward.
#pragma once

#include "common.cuh"

#define FUSION_MAXHD 16
#define FUSION_THREADS 256
#define FUSION_ACC 8

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

// One subject's window as a window body sees it: token n, channel c of a
// stream lives at [n * stride + c] from the window's pointer; its dropout
// draws are keyed (row0 + n, colC + c) for proj and fc2, (row0 + n,
// colH + f) for fc1 and (row0 + n, colA + h * NP + key) for the attention.
struct FusionWindow {
  const float* x;            // query stream
  const float* y;            // cross: key/value stream
  float* x2r;                // forward: written if not NULL; backward: read
  float* out;                // forward output
  const float* g;            // backward: dL/dout
  float* dx;                 // backward outputs
  float* dy;
  int stride;
  uint32_t row0, colC, colH, colA;
  float dp1, dp2;            // DropPath factors of the two residual branches
};

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

// Global (rows x cols, row-major) -> shared with a padded row stride.
__device__ __forceinline__ void stage(float* dst, int stride, const float* __restrict__ src,
                                      int rows, int cols) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * cols; i += FUSION_THREADS)
    dst[(i / cols) * stride + i % cols] = src[i];
}

// As stage, for a window whose rows lie src_stride floats apart.
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* __restrict__ src,
                                           int src_stride, int rows, int cols) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * cols; i += FUSION_THREADS)
    dst[(i / cols) * stride + i % cols] = src[(size_t)(i / cols) * src_stride + i % cols];
}

// The weights and the bias table at the offsets of F from w (the same for
// every window: a kernel stages them once).
__device__ __forceinline__ void stage_weights(float* w, const FusionLayout& F, bool cross,
                                              const FusionParams& P, const float* bias, int N,
                                              int C, int H, int Ch) {
  const int CS = F.CS, HS = F.HS, BS = F.BS;
  stage(w + F.g1, C, P.g1, 1, C);
  stage(w + F.b1, C, P.b1, 1, C);
  if (cross) {
    stage(w + F.g1y, C, P.g1y, 1, C);
    stage(w + F.b1y, C, P.b1y, 1, C);
    stage(w + F.wq, CS, P.wq, C, C);
    stage(w + F.bq, C, P.bq, 1, C);
    stage(w + F.wkv, CS, P.wkv, 2 * C, C);
    stage(w + F.bkv, 2 * C, P.bkv, 1, 2 * C);
  } else {
    stage(w + F.wq, CS, P.wq, 3 * C, C);
    stage(w + F.bq, 3 * C, P.bq, 1, 3 * C);
  }
  stage(w + F.wp, CS, P.wp, C, C);
  stage(w + F.bp, C, P.bp, 1, C);
  stage(w + F.g2, C, P.g2, 1, C);
  stage(w + F.b2, C, P.b2, 1, C);
  stage(w + F.w1, CS, P.w1, Ch, C);
  stage(w + F.b1m, Ch, P.b1m, 1, Ch);
  stage(w + F.w2, HS, P.w2, C, Ch);
  stage(w + F.b2m, C, P.b2m, 1, C);
  stage(w + F.bias, BS, bias, H * N, N);
}

// Two-pass LayerNorm of one C-wide row (nn/common.py semantics, eps 1e-5).
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
  for (int c = 0; c < C; ++c) dst[c] = (src[c] - mu) * r * g[c] + b[c];
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
// L's offsets from smem and, if masked, the window's shift mask at L.mask;
// the body stages the window's streams itself and ends on a barrier, so
// the caller may then restage anything.
template <bool CROSS, int MAXHD>
__device__ __forceinline__ void fusion_forward_window(float* smem, const FusionLayout& L,
                                                      bool masked, int N, int C, int H, int Ch,
                                                      const FusionTrain& T,
                                                      const FusionWindow& W) {
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

  const int tid = threadIdx.x;
  const int hd = C / H;
  const float scale = 1.f / sqrtf((float)hd);
  const int S = W.stride;
  const uint32_t row0 = W.row0;
  const float dp1 = W.dp1, dp2 = W.dp2;

  stage_rows(xs, CS, W.x, S, N, C);
  if (CROSS) stage_rows(ys, CS, W.y, S, N, C);
  __syncthreads();

  for (int n = tid; n < N; n += FUSION_THREADS) {
    ln_row(xs + n * CS, hs + n * CS, smem + L.g1, smem + L.b1, C);
    if (CROSS) ln_row(ys + n * CS, ys + n * CS, smem + L.g1y, smem + L.b1y, C);
  }
  __syncthreads();

  if (CROSS) {
    dense(hs, CS, C, smem + L.wq, smem + L.bq, C, N,
          [&](int n, int o, float s) { qs[n * CS + o] = s * scale; });
    dense(ys, CS, C, smem + L.wkv, smem + L.bkv, 2 * C, N, [&](int n, int o, float s) {
      if (o < C) ks[n * CS + o] = s;
      else vs[n * CS + o - C] = s;
    });
  } else {
    dense(hs, CS, C, smem + L.wq, smem + L.bq, 3 * C, N, [&](int n, int o, float s) {
      if (o < C) qs[n * CS + o] = s * scale;
      else if (o < 2 * C) ks[n * CS + o - C] = s;
      else vs[n * CS + o - 2 * C] = s;
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
    float acc[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) acc[d] = 0.f;
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
  __syncthreads();

  dense(hs, CS, C, smem + L.wp, smem + L.bp, C, N, [&](int n, int o, float s) {
    const float r = xs[n * CS + o] + dp1 * (s * keep(T.proj, row0 + n, W.colC + o));
    x2[n * CS + o] = r;
    if (W.x2r) W.x2r[(size_t)n * S + o] = r;
  });
  __syncthreads();

  for (int n = tid; n < N; n += FUSION_THREADS)
    ln_row(x2 + n * CS, qs + n * CS, smem + L.g2, smem + L.b2, C);
  __syncthreads();

  dense(qs, CS, C, smem + L.w1, smem + L.b1m, Ch, N, [&](int n, int o, float s) {
    us[n * HS + o] = gelu_erf(s) * keep(T.mlp1, row0 + n, W.colH + o);
  });
  __syncthreads();

  dense(us, HS, Ch, smem + L.w2, smem + L.b2m, C, N, [&](int n, int o, float s) {
    W.out[(size_t)n * S + o] =
        x2[n * CS + o] + dp2 * (s * keep(T.mlp2, row0 + n, W.colC + o));
  });
  __syncthreads();  // the next window overwrites xs, ys and ms
}

// ---------------------------------------------------------------------------
// Backward (design notes in fusion_block.cu).
// ---------------------------------------------------------------------------

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

// Shared-memory offsets (floats) of the backward kernel: the forward's
// weights, bias and mask (FusionLayout's tail) after the activations,
// their gradients and the accumulators.
struct FusionBwdLayout {
  int CS, HS, BS, QS;
  int xs, ys, gs, x2s, h2, xh2, dz, dh2, dx2r, da, dO, h1, xh1, h1y, xh1y;
  int qs, ks, vs, os, dh1, dh1y, dqkv, us, gus, r1, r2, r1y, lse, Dd, acc, fwd;
  int total;

  __host__ __device__ FusionBwdLayout(bool cross, int N, int C, int H, int Ch) {
    CS = C + 1; HS = Ch + 1; BS = N + 1; QS = 3 * C + 1;
    const int S = N * CS;
    int off = 0;
    xs = off; off += S;
    ys = off; off += cross ? S : 0;
    gs = off; off += S;
    x2s = off; off += S;
    h2 = off; off += S;
    xh2 = off; off += S;
    dz = off; off += S;
    dh2 = off; off += S;
    dx2r = off; off += S;
    da = off; off += S;
    dO = off; off += S;
    h1 = off; off += S;
    xh1 = off; off += S;
    h1y = off; off += cross ? S : 0;
    xh1y = off; off += cross ? S : 0;
    qs = off; off += S;
    ks = off; off += S;
    vs = off; off += S;
    os = off; off += S;
    dh1 = off; off += S;
    dh1y = off; off += cross ? S : 0;
    dqkv = off; off += N * QS;
    us = off; off += N * HS;
    gus = off; off += N * HS;
    r1 = off; off += N;
    r2 = off; off += N;
    r1y = off; off += N;
    lse = off; off += H * N;
    Dd = off; off += H * N;
    acc = off; off += FusionGrads(cross, N, C, H, Ch).total;
    fwd = off;  // FusionLayout offsets are relative to here
    // only the weights/bias/mask tail of the forward layout is used
    const FusionLayout F(cross, N, C, H, Ch);
    off += F.total - F.g1;
    fwd -= F.g1;
    total = off;
  }
};

// s(n, o) = (b ? b[o] : 0) + sum_k in[n][k] W(o, k) with W(o, k) = W[o * wo + k * wk]
// (a weight read row-wise or transposed); one output per thread, lanes on
// consecutive rows n so that the weight element is a broadcast.
template <typename Store>
__device__ __forceinline__ void dense_any(const float* in, int in_stride, int K, const float* W,
                                          int wo, int wk, const float* b, int O, int N,
                                          Store store) {
  for (int e = threadIdx.x; e < N * O; e += FUSION_THREADS) {
    const int n = e % N, o = e / N;
    const float* row = in + n * in_stride;
    const float* wr = W + o * wo;
    float s = b ? b[o] : 0.f;
    for (int k = 0; k < K; ++k) s = fmaf(row[k], wr[k * wk], s);
    store(n, o, s);
  }
}

// acc[o * K + k] += sum_n A[n][o] B[n][k] (a weight gradient over the window's
// rows); each element is owned by one thread for the whole kernel.
__device__ __forceinline__ void acc_outer(float* acc, const float* A, int as, int O,
                                          const float* B, int bs, int K, int N) {
  for (int e = threadIdx.x; e < O * K; e += FUSION_THREADS) {
    const int o = e / K, k = e % K;
    float s = 0.f;
    for (int n = 0; n < N; ++n) s = fmaf(A[n * as + o], B[n * bs + k], s);
    acc[e] += s;
  }
}

// acc[o] += sum_n A[n][o] (B ? B[n][o] : 1): bias and LayerNorm-scale gradients.
__device__ __forceinline__ void acc_cols(float* acc, const float* A, int as, const float* B,
                                         int bs, int O, int N) {
  for (int o = threadIdx.x; o < O; o += FUSION_THREADS) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += B ? A[n * as + o] * B[n * bs + o] : A[n * as + o];
    acc[o] += s;
  }
}

// Two-pass LayerNorm of one row keeping the normalised row xh; returns rsqrt.
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
// fusion_block.py _ln_bwd.
__device__ __forceinline__ void ln_bwd_row(const float* dh, const float* xh, float r,
                                           const float* g, const float* add, float* dst,
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
    dst[c] = (add ? add[c] : 0.f) + r * (dh[c] * g[c] - m1 - xh[c] * m2);
}

// The backward of one subject's window: adds the window's share of every
// parameter gradient and of dbias to the block's accumulators at L.acc and
// writes dx (and dy). Weights, bias and (if masked) the shift mask are
// staged at L.fwd + the FusionLayout offsets; ends on a barrier.
template <bool CROSS, int MAXHD>
__device__ __forceinline__ void fusion_backward_window(float* smem, const FusionBwdLayout& L,
                                                       const FusionLayout& F,
                                                       const FusionGrads& G, bool masked, int N,
                                                       int C, int H, int Ch,
                                                       const FusionTrain& T,
                                                       const FusionWindow& W) {
  const int CS = L.CS, HS = L.HS, BS = L.BS, QS = L.QS;
  float* w = smem + L.fwd;    // + FusionLayout offset -> staged weight
  float *xs = smem + L.xs, *ys = smem + L.ys, *gs = smem + L.gs, *x2s = smem + L.x2s;
  float *h2 = smem + L.h2, *xh2 = smem + L.xh2, *dz = smem + L.dz, *dh2 = smem + L.dh2;
  float *dx2r = smem + L.dx2r, *da = smem + L.da, *dO = smem + L.dO;
  float *h1 = smem + L.h1, *xh1 = smem + L.xh1, *h1y = smem + L.h1y, *xh1y = smem + L.xh1y;
  float *qs = smem + L.qs, *ks = smem + L.ks, *vs = smem + L.vs, *os = smem + L.os;
  float *dh1 = smem + L.dh1, *dh1y = smem + L.dh1y, *dqkv = smem + L.dqkv;
  float *us = smem + L.us, *gus = smem + L.gus;
  float *r1 = smem + L.r1, *r2 = smem + L.r2, *r1y = smem + L.r1y;
  float *lse = smem + L.lse, *Dd = smem + L.Dd, *acc = smem + L.acc;
  float* bs = w + F.bias;
  float* ms = w + F.mask;
  const int tid = threadIdx.x;
  const int hd = C / H;
  const float scale = 1.f / sqrtf((float)hd);
  const int S = W.stride;
  const uint32_t row0 = W.row0;
  const float dp1 = W.dp1, dp2 = W.dp2;

  stage_rows(xs, CS, W.x, S, N, C);
  if (CROSS) stage_rows(ys, CS, W.y, S, N, C);
  stage_rows(gs, CS, W.g, S, N, C);
  stage_rows(x2s, CS, W.x2r, S, N, C);
  __syncthreads();

  // ---- MLP / LN2 side over the saved x2r ------------------------------------
  for (int n = tid; n < N; n += FUSION_THREADS)
    r2[n] = ln_fwd_row(x2s + n * CS, xh2 + n * CS, h2 + n * CS, w + F.g2, w + F.b2, C);
  for (int e = tid; e < N * C; e += FUSION_THREADS) {
    const int n = e / C, c = e % C;
    dz[n * CS + c] = dp2 * gs[n * CS + c] * keep(T.mlp2, row0 + n, W.colC + c);
  }
  __syncthreads();
  dense_any(h2, CS, C, w + F.w1, CS, 1, w + F.b1m, Ch, N,
            [&](int n, int o, float s) { us[n * HS + o] = s; });
  __syncthreads();
  for (int e = tid; e < N * Ch; e += FUSION_THREADS) {
    const int n = e / Ch, j = e % Ch;
    gus[n * HS + j] = gelu_erf(us[n * HS + j]) * keep(T.mlp1, row0 + n, W.colH + j);
  }
  __syncthreads();
  // du = (dz W2) * m1 * GELU'(u), written over u
  dense_any(dz, CS, C, w + F.w2, 1, HS, nullptr, Ch, N, [&](int n, int j, float s) {
    us[n * HS + j] = s * keep(T.mlp1, row0 + n, W.colH + j) * gelu_erf_grad(us[n * HS + j]);
  });
  acc_outer(acc + G.w2, dz, CS, C, gus, HS, Ch, N);
  acc_cols(acc + G.b2m, dz, CS, nullptr, 0, C, N);
  __syncthreads();
  acc_outer(acc + G.w1, us, HS, Ch, h2, CS, C, N);
  acc_cols(acc + G.b1m, us, HS, nullptr, 0, Ch, N);
  dense_any(us, HS, Ch, w + F.w1, 1, CS, nullptr, C, N,
            [&](int n, int c, float s) { dh2[n * CS + c] = s; });
  __syncthreads();
  acc_cols(acc + G.g2, dh2, CS, xh2, CS, C, N);
  acc_cols(acc + G.b2, dh2, CS, nullptr, 0, C, N);
  for (int n = tid; n < N; n += FUSION_THREADS)
    ln_bwd_row(dh2 + n * CS, xh2 + n * CS, r2[n], w + F.g2, gs + n * CS, dx2r + n * CS, C);
  __syncthreads();
  for (int e = tid; e < N * C; e += FUSION_THREADS) {
    const int n = e / C, c = e % C;
    da[n * CS + c] = dp1 * dx2r[n * CS + c] * keep(T.proj, row0 + n, W.colC + c);
  }
  __syncthreads();

  // ---- proj backward, LN1 and q/k/v recompute --------------------------------
  dense_any(da, CS, C, w + F.wp, 1, CS, nullptr, C, N,
            [&](int n, int c, float s) { dO[n * CS + c] = s; });
  acc_cols(acc + G.bp, da, CS, nullptr, 0, C, N);
  for (int n = tid; n < N; n += FUSION_THREADS) {
    r1[n] = ln_fwd_row(xs + n * CS, xh1 + n * CS, h1 + n * CS, w + F.g1, w + F.b1, C);
    if (CROSS)
      r1y[n] = ln_fwd_row(ys + n * CS, xh1y + n * CS, h1y + n * CS, w + F.g1y, w + F.b1y, C);
  }
  __syncthreads();
  if (CROSS) {
    dense_any(h1, CS, C, w + F.wq, CS, 1, w + F.bq, C, N,
              [&](int n, int o, float s) { qs[n * CS + o] = s * scale; });
    dense_any(h1y, CS, C, w + F.wkv, CS, 1, w + F.bkv, 2 * C, N, [&](int n, int o, float s) {
      if (o < C) ks[n * CS + o] = s;
      else vs[n * CS + o - C] = s;
    });
  } else {
    dense_any(h1, CS, C, w + F.wq, CS, 1, w + F.bq, 3 * C, N, [&](int n, int o, float s) {
      if (o < C) qs[n * CS + o] = s * scale;
      else if (o < 2 * C) ks[n * CS + o - C] = s;
      else vs[n * CS + o - 2 * C] = s;
    });
  }
  __syncthreads();

  // ---- attention, row pass: one (head, query) per thread -------------------
  for (int i = tid; i < H * N; i += FUSION_THREADS) {
    const int h = i / N, n = i % N, c0 = h * hd;
    float qi[MAXHD], gi[MAXHD], oa[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) {
      qi[d] = d < hd ? qs[n * CS + c0 + d] : 0.f;
      gi[d] = d < hd ? dO[n * CS + c0 + d] : 0.f;
      oa[d] = 0.f;
    }
    const float* brow = bs + i * BS;
    const float* mrow = masked ? ms + n * BS : nullptr;
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
      const float pk = p * keep(T.attn, row0 + n, W.colA + (uint32_t)(h * T.NP + j));
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
        os[n * CS + c0 + d] = oa[d];
        Di = fmaf(gi[d], oa[d], Di);
      }
    lse[i] = m + logf(l);
    Dd[i] = Di;
    float dq[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) dq[d] = 0.f;
    for (int j = 0; j < N; ++j) {
      float s = brow[j] + (mrow ? mrow[j] : 0.f), dp = 0.f;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          s = fmaf(qi[d], ks[j * CS + c0 + d], s);
          dp = fmaf(gi[d], vs[j * CS + c0 + d], dp);
        }
      const float p = expf(s - m) * inv;
      const float ds =
          p * (dp * keep(T.attn, row0 + n, W.colA + (uint32_t)(h * T.NP + j)) - Di);
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) dq[d] = fmaf(ds, ks[j * CS + c0 + d], dq[d]);
    }
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) dqkv[n * QS + c0 + d] = dq[d] * scale;
  }
  __syncthreads();

  // ---- attention, column pass: one (head, key) per thread -------------------
  for (int i = tid; i < H * N; i += FUSION_THREADS) {
    const int h = i / N, j = i % N, c0 = h * hd;
    float kj[MAXHD], vj[MAXHD], dk[MAXHD], dv[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) {
      kj[d] = d < hd ? ks[j * CS + c0 + d] : 0.f;
      vj[d] = d < hd ? vs[j * CS + c0 + d] : 0.f;
      dk[d] = dv[d] = 0.f;
    }
    float* db = acc + G.bias + (size_t)h * N * N + j;
    for (int n = 0; n < N; ++n) {
      float s = bs[(h * N + n) * BS + j] + (masked ? ms[n * BS + j] : 0.f), dp = 0.f;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          s = fmaf(qs[n * CS + c0 + d], kj[d], s);
          dp = fmaf(dO[n * CS + c0 + d], vj[d], dp);
        }
      const float p = expf(s - lse[h * N + n]);
      const float kp = keep(T.attn, row0 + n, W.colA + (uint32_t)(h * T.NP + j));
      const float ds = p * (dp * kp - Dd[h * N + n]);
      db[n * N] += ds;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          dk[d] = fmaf(ds, qs[n * CS + c0 + d], dk[d]);
          dv[d] = fmaf(p * kp, dO[n * CS + c0 + d], dv[d]);
        }
    }
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) {
        dqkv[j * QS + C + c0 + d] = dk[d];
        dqkv[j * QS + 2 * C + c0 + d] = dv[d];
      }
  }
  __syncthreads();

  // ---- projection and q/k/v parameter gradients, LN1 backward ----------------
  acc_outer(acc + G.wp, da, CS, C, os, CS, C, N);
  if (CROSS) {
    acc_outer(acc + G.wq, dqkv, QS, C, h1, CS, C, N);
    acc_cols(acc + G.bq, dqkv, QS, nullptr, 0, C, N);
    acc_outer(acc + G.wkv, dqkv + C, QS, 2 * C, h1y, CS, C, N);
    acc_cols(acc + G.bkv, dqkv + C, QS, nullptr, 0, 2 * C, N);
    dense_any(dqkv, QS, C, w + F.wq, 1, CS, nullptr, C, N,
              [&](int n, int c, float s) { dh1[n * CS + c] = s; });
    dense_any(dqkv + C, QS, 2 * C, w + F.wkv, 1, CS, nullptr, C, N,
              [&](int n, int c, float s) { dh1y[n * CS + c] = s; });
  } else {
    acc_outer(acc + G.wq, dqkv, QS, 3 * C, h1, CS, C, N);
    acc_cols(acc + G.bq, dqkv, QS, nullptr, 0, 3 * C, N);
    dense_any(dqkv, QS, 3 * C, w + F.wq, 1, CS, nullptr, C, N,
              [&](int n, int c, float s) { dh1[n * CS + c] = s; });
  }
  __syncthreads();
  acc_cols(acc + G.g1, dh1, CS, xh1, CS, C, N);
  acc_cols(acc + G.b1, dh1, CS, nullptr, 0, C, N);
  if (CROSS) {
    acc_cols(acc + G.g1y, dh1y, CS, xh1y, CS, C, N);
    acc_cols(acc + G.b1y, dh1y, CS, nullptr, 0, C, N);
  }
  for (int n = tid; n < N; n += FUSION_THREADS) {
    ln_bwd_row(dh1 + n * CS, xh1 + n * CS, r1[n], w + F.g1, dx2r + n * CS,
               W.dx + (size_t)n * S, C);
    if (CROSS)
      ln_bwd_row(dh1y + n * CS, xh1y + n * CS, r1y[n], w + F.g1y, nullptr,
                 W.dy + (size_t)n * S, C);
  }
  __syncthreads();  // the next window overwrites the staged streams
}

// ---------------------------------------------------------------------------
// Launch plumbing shared by K2/K3 and K7.
// ---------------------------------------------------------------------------

// A grid that fills the card once (blocks then walk their work items).
template <typename Kernel>
static cudaError_t persistent_grid(Kernel kernel, size_t smem, int items, int* blocks) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FUSION_THREADS,
                                                          smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = items < sms * per_sm ? items : sms * per_sm;
  return cudaSuccess;
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
