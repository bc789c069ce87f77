// K2/K3: the SwinFusion self and cross blocks, forward, one kernel templated
// on CROSS.
//
// Replaces multimodal_neuroimage_tpu/ops/fusion_block.py fused_fusion_block
// and fused_cross_fusion_block (_fwd_impl -> _make_fwd_kernel ->
// _forward_compute): the whole pre-norm Swin-V1 block
//
//   LN1 -> q/k/v (cross: q from LN1_x(x), k/v from LN1_y(y)) -> per-head
//   softmax(q k^T / sqrt(hd) + bias[h] + mask[w]) v -> proj -> residual ->
//   LN2 -> fc1 -> erf-GELU -> fc2 -> residual
//
// In training the kernel also applies the JAX kernels' dropout draws
// (attention probabilities 3, proj 0, fc1 1, fc2 2, keyed by the padded
// coordinates r = (b * nW + w) * NP + n and c = channel, or h * NP + key for
// the attention draw), scales the two residual branches by the per-subject
// DropPath factors dp (B, 2), and saves the post-attention residual x2r for
// the backward. At inference every factor is 1.
//
// What bounds it on the H100: latency, not bytes or FLOPs. A flagship
// forward runs 48 self and 12 directed cross calls over 196 windows of 36
// tokens at C = 12 (6 heads of dim 2): about 0.2 GFLOP and 5 MB of stream
// traffic per call at B = 4. Unfused, each block is ~20 small kernels with
// every intermediate (qkv, the (H, 36, 36) scores, the MLP hidden)
// round-tripping device memory.
// Design: a grid that fills the card once, each block walking windows
// (subject, window) with a grid stride. The 36 x 12 window (and the y
// window), q/k/v, the attention output, the post-attention residual and the
// 36 x 48 MLP hidden live in shared memory; only x (and y) are read and only
// the block output is written. Each block stages the weights (~2K floats)
// and the (H, N, N) bias once, and a window's shift mask per window. Every
// shared row is padded to an odd stride (C + 1, Ch + 1, N + 1), so lanes
// that read one row each hit distinct banks. Dense layers put one token row
// per lane and share each weight element across the lanes of a warp (a
// broadcast); each thread keeps its output columns (2, 4 or 8 at a time)
// in registers. The attention gives each thread one (head, query row) and
// keeps its scores in registers, with the key loop unrolled by 4. A clock64
// probe of the first
// version (one block per window, weights and bias read from global memory in
// the loops) found the block latency-bound, not bandwidth-bound: half its
// cycles in the attention's chain of one dependent key at a time, a fifth
// in ~60 serial global loads of staging. Windows are unpadded (N = 36) and
// the bias is a plain (H, N, N) tensor: the NP = 40 pad and the head-packed
// bias layout were TPU tiling choices. The softmax subtracts the row max
// where the TPU kernel clamped logits at 80; the two agree for all scores
// below 80 (ops/fusion_block.py _LOGIT_CAP).
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
  float* x2r;                // (B, nW, N, C) or NULL
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

template <bool CROSS, int MAXHD>
__global__ void __launch_bounds__(FUSION_THREADS)
fusion_block_kernel(const float* __restrict__ x, const float* __restrict__ y, FusionParams P,
                    const float* __restrict__ bias, const float* __restrict__ mask,
                    float* __restrict__ out, int windows, int nW, int N, int C, int H, int Ch,
                    FusionTrain T) {
  extern __shared__ float smem[];
  const FusionLayout L(CROSS, N, C, H, Ch);
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

  // weights and the bias are the same for every window: stage them once
  stage(smem + L.g1, C, P.g1, 1, C);
  stage(smem + L.b1, C, P.b1, 1, C);
  if (CROSS) {
    stage(smem + L.g1y, C, P.g1y, 1, C);
    stage(smem + L.b1y, C, P.b1y, 1, C);
    stage(smem + L.wq, CS, P.wq, C, C);
    stage(smem + L.bq, C, P.bq, 1, C);
    stage(smem + L.wkv, CS, P.wkv, 2 * C, C);
    stage(smem + L.bkv, 2 * C, P.bkv, 1, 2 * C);
  } else {
    stage(smem + L.wq, CS, P.wq, 3 * C, C);
    stage(smem + L.bq, 3 * C, P.bq, 1, 3 * C);
  }
  stage(smem + L.wp, CS, P.wp, C, C);
  stage(smem + L.bp, C, P.bp, 1, C);
  stage(smem + L.g2, C, P.g2, 1, C);
  stage(smem + L.b2, C, P.b2, 1, C);
  stage(smem + L.w1, CS, P.w1, Ch, C);
  stage(smem + L.b1m, Ch, P.b1m, 1, Ch);
  stage(smem + L.w2, HS, P.w2, C, Ch);
  stage(smem + L.b2m, C, P.b2m, 1, C);
  stage(bs, BS, bias, H * N, N);

  // each block walks windows b * nW + w with a grid stride
  for (int bw = blockIdx.x; bw < windows; bw += gridDim.x) {
    const size_t base = (size_t)bw * N * C;
    const uint32_t row0 = (uint32_t)bw * T.NP;   // padded dropout row of token 0
    const float dp1 = T.dp ? T.dp[(bw / nW) * 2] : 1.f;
    const float dp2 = T.dp ? T.dp[(bw / nW) * 2 + 1] : 1.f;
    stage(xs, CS, x + base, N, C);
    if (CROSS) stage(ys, CS, y + base, N, C);
    if (mask) stage(ms, BS, mask + (size_t)(bw % nW) * N * N, N, N);
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
      const float* mrow = mask ? ms + n * BS : nullptr;
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
        const float pk = p * keep(T.attn, row0 + n, (uint32_t)(h * T.NP + j));
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
      const float r = xs[n * CS + o] + dp1 * (s * keep(T.proj, row0 + n, o));
      x2[n * CS + o] = r;
      if (T.x2r) T.x2r[base + (size_t)n * C + o] = r;
    });
    __syncthreads();

    for (int n = tid; n < N; n += FUSION_THREADS)
      ln_row(x2 + n * CS, qs + n * CS, smem + L.g2, smem + L.b2, C);
    __syncthreads();

    dense(qs, CS, C, smem + L.w1, smem + L.b1m, Ch, N, [&](int n, int o, float s) {
      us[n * HS + o] = gelu_erf(s) * keep(T.mlp1, row0 + n, o);
    });
    __syncthreads();

    dense(us, HS, Ch, smem + L.w2, smem + L.b2m, C, N, [&](int n, int o, float s) {
      out[base + (size_t)n * C + o] = x2[n * CS + o] + dp2 * (s * keep(T.mlp2, row0 + n, o));
    });
    __syncthreads();  // the next window overwrites xs, ys and ms
  }
}


// ---------------------------------------------------------------------------
// Backward. Replaces fusion_block.py _bwd_impl (_make_bwd_kernel, :547-713):
// per window, the MLP/LN2 backward over the saved x2r, then LN1 and q/k/v
// recomputed and the attention backward, giving dx (and dy for cross) and
// the window's share of dbias and of the 12 (self) or 16 (cross) parameter
// gradients.
//
// The TPU kernel summed the parameter gradients over its sequential grid in
// resident output blocks. Blocks of the H100 run in parallel, so each block
// here walks its windows with a grid stride, accumulates its share in shared
// memory (every accumulator element is owned by one thread, so the order of
// the sum is fixed), writes it to a per-block partial, and a second kernel
// adds the partials in block order: two runs give bitwise the same
// gradients. Like the forward, the block is latency-bound, not FLOP- or
// byte-bound (0.3 GFLOP for a flagship call at B = 4): everything a window
// needs lives in ~140 KB of shared memory, one block per SM. The attention
// recompute never stores the (H, N, N) probabilities: a row pass (one
// thread per (head, query)) rebuilds the softmax, the attention output, its
// log-sum-exp and D = dO . O, and dq; a column pass (one thread per
// (head, key)) rebuilds p from the log-sum-exp and gives dk, dv and dbias.
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

template <bool CROSS, int MAXHD>
__global__ void __launch_bounds__(FUSION_THREADS)
fusion_block_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                             const float* __restrict__ x2r, const float* __restrict__ g,
                             FusionParams P, const float* __restrict__ bias,
                             const float* __restrict__ mask, FusionTrain T,
                             float* __restrict__ dx, float* __restrict__ dy,
                             float* __restrict__ part, int windows, int nW, int N, int C, int H,
                             int Ch) {
  extern __shared__ float smem[];
  const FusionBwdLayout L(CROSS, N, C, H, Ch);
  const FusionLayout F(CROSS, N, C, H, Ch);
  const FusionGrads G(CROSS, N, C, H, Ch);
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

  for (int e = tid; e < G.total; e += FUSION_THREADS) acc[e] = 0.f;
  stage(w + F.g1, C, P.g1, 1, C);
  stage(w + F.b1, C, P.b1, 1, C);
  if (CROSS) {
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
  stage(bs, BS, bias, H * N, N);

  for (int bw = blockIdx.x; bw < windows; bw += gridDim.x) {
    const size_t base = (size_t)bw * N * C;
    const uint32_t row0 = (uint32_t)bw * T.NP;
    const float dp1 = T.dp ? T.dp[(bw / nW) * 2] : 1.f;
    const float dp2 = T.dp ? T.dp[(bw / nW) * 2 + 1] : 1.f;
    stage(xs, CS, x + base, N, C);
    if (CROSS) stage(ys, CS, y + base, N, C);
    stage(gs, CS, g + base, N, C);
    stage(x2s, CS, x2r + base, N, C);
    if (mask) stage(ms, BS, mask + (size_t)(bw % nW) * N * N, N, N);
    __syncthreads();

    // ---- MLP / LN2 side over the saved x2r ----------------------------------
    for (int n = tid; n < N; n += FUSION_THREADS)
      r2[n] = ln_fwd_row(x2s + n * CS, xh2 + n * CS, h2 + n * CS, w + F.g2, w + F.b2, C);
    for (int e = tid; e < N * C; e += FUSION_THREADS) {
      const int n = e / C, c = e % C;
      dz[n * CS + c] = dp2 * gs[n * CS + c] * keep(T.mlp2, row0 + n, c);
    }
    __syncthreads();
    dense_any(h2, CS, C, w + F.w1, CS, 1, w + F.b1m, Ch, N,
              [&](int n, int o, float s) { us[n * HS + o] = s; });
    __syncthreads();
    for (int e = tid; e < N * Ch; e += FUSION_THREADS) {
      const int n = e / Ch, j = e % Ch;
      gus[n * HS + j] = gelu_erf(us[n * HS + j]) * keep(T.mlp1, row0 + n, j);
    }
    __syncthreads();
    // du = (dz W2) * m1 * GELU'(u), written over u
    dense_any(dz, CS, C, w + F.w2, 1, HS, nullptr, Ch, N, [&](int n, int j, float s) {
      us[n * HS + j] = s * keep(T.mlp1, row0 + n, j) * gelu_erf_grad(us[n * HS + j]);
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
      da[n * CS + c] = dp1 * dx2r[n * CS + c] * keep(T.proj, row0 + n, c);
    }
    __syncthreads();

    // ---- proj backward, LN1 and q/k/v recompute ------------------------------
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

    // ---- attention, row pass: one (head, query) per thread -----------------
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
      const float* mrow = mask ? ms + n * BS : nullptr;
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
        const float pk = p * keep(T.attn, row0 + n, (uint32_t)(h * T.NP + j));
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
        const float ds = p * (dp * keep(T.attn, row0 + n, (uint32_t)(h * T.NP + j)) - Di);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) dq[d] = fmaf(ds, ks[j * CS + c0 + d], dq[d]);
      }
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) dqkv[n * QS + c0 + d] = dq[d] * scale;
    }
    __syncthreads();

    // ---- attention, column pass: one (head, key) per thread -----------------
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
        float s = bs[(h * N + n) * BS + j] + (mask ? ms[n * BS + j] : 0.f), dp = 0.f;
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) {
            s = fmaf(qs[n * CS + c0 + d], kj[d], s);
            dp = fmaf(dO[n * CS + c0 + d], vj[d], dp);
          }
        const float p = expf(s - lse[h * N + n]);
        const float kp = keep(T.attn, row0 + n, (uint32_t)(h * T.NP + j));
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

    // ---- projection and q/k/v parameter gradients, LN1 backward --------------
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
                 dx + base + (size_t)n * C, C);
      if (CROSS)
        ln_bwd_row(dh1y + n * CS, xh1y + n * CS, r1y[n], w + F.g1y, nullptr,
                   dy + base + (size_t)n * C, C);
    }
    __syncthreads();  // the next window overwrites the staged streams
  }
  float* mine = part + (size_t)blockIdx.x * G.total;
  for (int e = tid; e < G.total; e += FUSION_THREADS) mine[e] = acc[e];
}

// ---------------------------------------------------------------------------
// Launch plumbing shared by forward and backward.
// ---------------------------------------------------------------------------

// A grid that fills the card once (blocks then walk the windows).
template <typename Kernel>
static cudaError_t persistent_grid(Kernel kernel, size_t smem, int windows, int* blocks) {
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
  *blocks = windows < sms * per_sm ? windows : sms * per_sm;
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

template <bool CROSS, int MAXHD>
static cudaError_t launch_forward(const float* x, const float* y, const FusionParams& P,
                                  const float* bias, const float* mask, float* out,
                                  int windows, int nW, int N, int C, int H, int Ch,
                                  const FusionTrain& T, cudaStream_t stream) {
  const size_t smem = (size_t)FusionLayout(CROSS, N, C, H, Ch).total * sizeof(float);
  auto kernel = fusion_block_kernel<CROSS, MAXHD>;
  int blocks = 0;
  cudaError_t err = persistent_grid(kernel, smem, windows, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, FUSION_THREADS, smem, stream>>>(x, y, P, bias, mask, out, windows, nW, N, C,
                                                  H, Ch, T);
  return cudaGetLastError();
}

// x, y, out: (B, nW, N, C) windows, f32 contiguous (y unused unless cross).
// params: host array of device pointers in the JAX kernels' order
//   self  (12): g1 b1 wqkv bqkv wp bp g2 b2 w1 b1m w2 b2m
//   cross (16): g1 b1 g1y b1y wq bq wkv bkv wp bp g2 b2 w1 b1m w2 b2m
// with weights in torch (out, in) layout. bias (H, N, N); mask (nW, N, N) or
// NULL. Training: dp (B, 2) DropPath factors or NULL, the dropout seed and
// rates (attention, and proj/MLP), NP the padded window length of the
// dropout coordinates, x2r (B, nW, N, C) written when not NULL. Needs
// N <= 256 and C / H <= 16. Returns the cudaError_t of the launch.
extern "C" int fusion_block_forward(int cross, const float* x, const float* y,
                                    const void* const* params, const float* bias,
                                    const float* mask, float* out, int B, int nW, int N,
                                    int C, int H, int Ch, const float* dp, int seed,
                                    double attn_rate, double drop_rate, int NP, float* x2r,
                                    cudaStream_t stream) {
  if (bad_dims(N, C, H)) return (int)cudaErrorInvalidValue;
  const FusionParams P = unpack_params(cross, params);
  const FusionTrain T = make_train(dp, seed, attn_rate, drop_rate, NP, x2r);
#define FWD(c, h) launch_forward<c, h>(x, y, P, bias, mask, out, B * nW, nW, N, C, H, Ch, T, stream)
  return (int)FUSION_DISPATCH(cross, C / H, FWD);
#undef FWD
}

template <bool CROSS, int MAXHD>
static cudaError_t backward_grid(int windows, int N, int C, int H, int Ch, int* blocks,
                                 size_t* smem) {
  *smem = (size_t)FusionBwdLayout(CROSS, N, C, H, Ch).total * sizeof(float);
  return persistent_grid(fusion_block_backward_kernel<CROSS, MAXHD>, *smem, windows, blocks);
}

// Floats of the flat gradient vector fusion_block_backward writes: the
// parameters in the order of fusion_block_forward, then dbias (H, N, N).
extern "C" long long fusion_block_grad_floats(int cross, int N, int C, int H, int Ch) {
  return FusionGrads(cross != 0, N, C, H, Ch).total;
}

// Floats of device scratch fusion_block_backward needs (per-block partials),
// or -1 if the kernel cannot be configured.
extern "C" long long fusion_block_backward_scratch_floats(int cross, int B, int nW, int N,
                                                          int C, int H, int Ch) {
  if (bad_dims(N, C, H)) return -1;
  int blocks = 0;
  size_t smem = 0;
#define GRID(c, h) backward_grid<c, h>(B * nW, N, C, H, Ch, &blocks, &smem)
  if (FUSION_DISPATCH(cross, C / H, GRID) != cudaSuccess) return -1;
#undef GRID
  return (long long)blocks * FusionGrads(cross != 0, N, C, H, Ch).total;
}

template <bool CROSS, int MAXHD>
static cudaError_t launch_backward(const float* x, const float* y, const float* x2r,
                                   const float* g, const FusionParams& P, const float* bias,
                                   const float* mask, const FusionTrain& T, float* dx,
                                   float* dy, float* grads, float* scratch, int windows, int nW,
                                   int N, int C, int H, int Ch, cudaStream_t stream) {
  int blocks = 0;
  size_t smem = 0;
  cudaError_t err = backward_grid<CROSS, MAXHD>(windows, N, C, H, Ch, &blocks, &smem);
  if (err != cudaSuccess) return err;
  fusion_block_backward_kernel<CROSS, MAXHD><<<blocks, FUSION_THREADS, smem, stream>>>(
      x, y, x2r, g, P, bias, mask, T, dx, dy, scratch, windows, nW, N, C, H, Ch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(scratch, blocks, FusionGrads(CROSS, N, C, H, Ch).total, nullptr, grads,
                         stream);
}

// Backward of fusion_block_forward with the same inputs plus x2r (saved by
// the training forward) and g = dL/dout (B, nW, N, C). Writes dx (and dy
// for cross) and grads: fusion_block_grad_floats() floats, the parameter
// gradients in parameter order, then dbias. scratch:
// fusion_block_backward_scratch_floats() floats. Returns the cudaError_t of
// the first launch that fails, or of the last.
extern "C" int fusion_block_backward(int cross, const float* x, const float* y,
                                     const void* const* params, const float* bias,
                                     const float* mask, const float* x2r, const float* g,
                                     float* dx, float* dy, float* grads, float* scratch, int B,
                                     int nW, int N, int C, int H, int Ch, const float* dp,
                                     int seed, double attn_rate, double drop_rate, int NP,
                                     cudaStream_t stream) {
  if (bad_dims(N, C, H)) return (int)cudaErrorInvalidValue;
  const FusionParams P = unpack_params(cross, params);
  const FusionTrain T = make_train(dp, seed, attn_rate, drop_rate, NP, nullptr);
#define BWD(c, h)                                                                        \
  launch_backward<c, h>(x, y, x2r, g, P, bias, mask, T, dx, dy, grads, scratch, B * nW, nW, \
                        N, C, H, Ch, stream)
  return (int)FUSION_DISPATCH(cross, C / H, BWD);
#undef BWD
}
