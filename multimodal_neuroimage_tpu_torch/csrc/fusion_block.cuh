// The SwinFusion block's device code, shared by K2/K3 (fusion_block.cu:
// windows (B, nW, N, C)) and K7 (fusion_block_bp.cuh: group-major windows
// (ngroups, nW, N, G*C)).
//
// Both directions run several subjects' windows at one window position at
// once: fusion_forward_items walks a kernel's work items, each up to
// FUSION_FWD_WINDOWS windows, and fusion_backward_windows runs the backward
// of up to FUSION_BWD_WINDOWS. A window is read at a given row stride (C in
// the std layout, G*C in the group-major one) with the dropout coordinates
// the caller gives (FusionWindow). The weights, the bias table and the
// window position's shift mask are staged once for the windows in flight.
// See fusion_block.cu for the design notes of the forward and of the
// backward.
//
// The forward is templated on the streams' element type S (float, or
// __nv_bfloat16 for K7's bf16 form) and on MM16, the bf16 policy's products
// (JAX _mm_bp with mm16): every product of bf16-rounded operands with float32
// sums, and the packed mm16 softmax (logits capped at 80, no max
// subtraction, denominators summed from bf16(e), p = e * bf16(1 / den)).
// It computes in float32 either way; <false, float> is the float32 forward
// of K2/K3 and K7. The backward here is the float32 one of K2/K3 and K7;
// K7's bf16 form has its own (fusion_block_bp16.cuh).
#pragma once

#include <float.h>

#include "common.cuh"

#define FUSION_MAXHD 16
#define FUSION_MAXN 256         // the largest window (N) the kernels take
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
  void* x2r;                 // the stream's shape and type, or NULL
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

// Offsets (in floats) of the weights, bias table and shift mask the
// backward stages in shared memory, rows padded to C + 1, Ch + 1, N + 1.
struct FusionLayout {
  int CS, HS, BS;                        // padded row strides: C+1, Ch+1, N+1
  int g1, b1, g1y, b1y, wq, bq, wkv, bkv, wp, bp, g2, b2, w1, b1m, w2, b2m;
  int bias, mask;                        // bias H x N x BS, mask[w] N x BS
  int total;

  __host__ __device__ FusionLayout(bool cross, int N, int C, int H, int Ch) {
    CS = C + 1; HS = Ch + 1; BS = N + 1;
    int off = 0;
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
template <int NT>
__device__ __forceinline__ void stage(float* dst, int stride, const float* __restrict__ src,
                                      int rows, int cols) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * cols; i += NT)
    dst[(i / cols) * stride + i % cols] = src[i];
}

// The weights and the bias table at the offsets of F from w (the same for
// every window: a kernel stages them once).
template <int NT>
__device__ __forceinline__ void stage_weights(float* w, const FusionLayout& F, bool cross,
                                              const FusionParams& P, const float* bias, int N,
                                              int C, int H, int Ch) {
  const int CS = F.CS, HS = F.HS, BS = F.BS;
  stage<NT>(w + F.g1, C, P.g1, 1, C);
  stage<NT>(w + F.b1, C, P.b1, 1, C);
  if (cross) {
    stage<NT>(w + F.g1y, C, P.g1y, 1, C);
    stage<NT>(w + F.b1y, C, P.b1y, 1, C);
    stage<NT>(w + F.wq, CS, P.wq, C, C);
    stage<NT>(w + F.bq, C, P.bq, 1, C);
    stage<NT>(w + F.wkv, CS, P.wkv, 2 * C, C);
    stage<NT>(w + F.bkv, 2 * C, P.bkv, 1, 2 * C);
  } else {
    stage<NT>(w + F.wq, CS, P.wq, 3 * C, C);
    stage<NT>(w + F.bq, 3 * C, P.bq, 1, 3 * C);
  }
  stage<NT>(w + F.wp, CS, P.wp, C, C);
  stage<NT>(w + F.bp, C, P.bp, 1, C);
  stage<NT>(w + F.g2, C, P.g2, 1, C);
  stage<NT>(w + F.b2, C, P.b2, 1, C);
  stage<NT>(w + F.w1, CS, P.w1, Ch, C);
  stage<NT>(w + F.b1m, Ch, P.b1m, 1, Ch);
  stage<NT>(w + F.w2, HS, P.w2, C, Ch);
  stage<NT>(w + F.b2m, C, P.b2m, 1, C);
  stage<NT>(w + F.bias, BS, bias, H * N, N);
}

// ---------------------------------------------------------------------------
// Forward (design notes in fusion_block.cu): a block of FUSION_FWD_THREADS
// runs the whole block on up to FUSION_FWD_WINDOWS windows of one window
// position at once, every phase's loop spanning all of them, while the next
// work item's streams and mask land in shared memory.
// ---------------------------------------------------------------------------

// Threads a block, the most windows in flight a block, resident blocks an
// SM the register budget is cut for, windows an attention task walks at
// head dim 2, keys a step of the online softmax (ops/fusion_block.py
// ONLINE_STEP is its plain model's copy; a test holds the two equal).
#define FUSION_FWD_THREADS 256
#define FUSION_FWD_WINDOWS 4
#define FUSION_FWD_MIN_BLOCKS 2
#define FUSION_FWD_AW 4
#define FUSION_FWD_KEYS 4
#define FUSION_LOG2E 1.44269504088896341f

// Probe hooks: a build that defines FUSION_FWD_MARK (bench/fusion_probe.py)
// reads the cycles between the forward's barriers; otherwise they are empty.
#ifndef FUSION_FWD_MARK
#define FUSION_FWD_MARK(i)
#define FUSION_FWD_MARK_SYNC(i)
#endif

__host__ __device__ inline int fusion_round4(int x) { return (x + 3) & ~3; }

// A row stride of at least x floats that is a multiple of 4 and holds an
// odd number of float4s: lanes reading float4s of consecutive rows then hit
// distinct banks.
__host__ __device__ inline int fusion_odd4(int x) {
  const int s = fusion_round4(x);
  return (s / 4) % 2 ? s : s + 4;
}

// Offsets (floats, each a multiple of 4) of the forward's shared memory.
// Once a block: the LayerNorm vectors and biases padded with zeros to a
// multiple of 4; the weight matrices transposed, W^T[c][o] with c and o
// padded with zeros to multiples of 4 (a float4 holds four outputs of one
// input channel); the bias table and the shift mask, rows N + 1 apart; the q/k/v column map (ints); and the
// next work item's x (and y) windows as they lie in device memory
// (prefetch). Then one arena a window in flight, laid out by liveness
// (S = N CS, Q = N QS floats):
//   xs   [0, S)            x, then x2 = x + proj(o) in place
//   qkv  [S, S + Q)        q (scaled) at columns [0, C), k and v of head h
//                          at C4 + 2 h hd (hd k, then hd v); then
//                          h2 = LN2(x2) at [S, 2S)
//   a    [S + Q, 2S + Q)   h1 = LN1(x), then the attention output o
//   ys   cross: after a    LN1_y(y)
//   u    [2S, 2S + N HS)   GELU(fc1(h2)) * m1, over the dead q/k/v, o, y
struct FusionFwdLayout {
  int C4, H4, Q4, KV4, CS, QS, HS, BS;
  int g1, b1, g1y, b1y, wq, bq, wkv, bkv, wp, bp, g2, b2, w1, b1m, w2, b2m;
  int bias, mask, cols, pf, pfy;
  int qkv, a, ys, u, arena, win, total;

  __host__ __device__ FusionFwdLayout(bool cross, int N, int C, int H, int Ch, int windows,
                                      int sbytes) {
    C4 = fusion_round4(C); H4 = fusion_round4(Ch);
    Q4 = fusion_round4(cross ? C : 3 * C); KV4 = fusion_round4(2 * C);
    CS = fusion_odd4(C); QS = fusion_odd4(C4 + 2 * C); HS = fusion_odd4(Ch); BS = N + 1;
    int off = 0;
    g1 = off; off += C4;
    b1 = off; off += C4;
    g1y = off; off += cross ? C4 : 0;
    b1y = off; off += cross ? C4 : 0;
    wq = off; off += C4 * Q4;
    bq = off; off += Q4;
    wkv = off; off += cross ? C4 * KV4 : 0;
    bkv = off; off += cross ? KV4 : 0;
    wp = off; off += C4 * C4;
    bp = off; off += C4;
    g2 = off; off += C4;
    b2 = off; off += C4;
    w1 = off; off += C4 * H4;
    b1m = off; off += H4;
    w2 = off; off += H4 * C4;
    b2m = off; off += C4;
    bias = off; off += fusion_round4(H * N * BS);
    mask = off; off += fusion_round4(N * BS);
    cols = off; off += fusion_round4(3 * C);
    const int pfn = fusion_round4((windows * N * C * sbytes + 3) / 4);
    pf = off; off += pfn;
    pfy = off; off += cross ? pfn : 0;
    const int S = N * CS, Q = N * QS;
    qkv = S; a = S + Q; ys = a + S; u = 2 * S;
    const int attn = ys + (cross ? S : 0), mlp = u + N * HS;
    arena = fusion_round4(attn > mlp ? attn : mlp);
    win = off;
    total = off + windows * arena;
  }
};

// Global (O x K, row-major) -> W^T (K4 x O4) in shared memory, zero-padded.
template <bool RND>
__device__ __forceinline__ void stage_t(float* dst, const float* __restrict__ src, int O, int K,
                                        int O4, int K4) {
#pragma unroll 4
  for (int i = threadIdx.x; i < K4 * O4; i += FUSION_FWD_THREADS) {
    const int c = i / O4, o = i % O4;
    const float v = c < K && o < O ? src[o * K + c] : 0.f;
    dst[i] = RND ? bf16r(v) : v;
  }
}

__device__ __forceinline__ void stage_v(float* dst, const float* __restrict__ src, int n, int n4) {
#pragma unroll 2
  for (int i = threadIdx.x; i < n4; i += FUSION_FWD_THREADS) dst[i] = i < n ? src[i] : 0.f;
}

// The weights and the q/k/v column map, staged once a block (MM16: the
// weight matrices rounded to bf16); the bias table comes by cp.async with
// the first work item.
template <bool MM16>
__device__ __forceinline__ void stage_forward(float* smem, const FusionFwdLayout& L, bool cross,
                                              const FusionParams& P, int C, int H, int Ch) {
  const int C4 = L.C4, H4 = L.H4;
  stage_v(smem + L.g1, P.g1, C, C4);
  stage_v(smem + L.b1, P.b1, C, C4);
  if (cross) {
    stage_v(smem + L.g1y, P.g1y, C, C4);
    stage_v(smem + L.b1y, P.b1y, C, C4);
    stage_t<MM16>(smem + L.wkv, P.wkv, 2 * C, C, L.KV4, C4);
    stage_v(smem + L.bkv, P.bkv, 2 * C, L.KV4);
  }
  stage_t<MM16>(smem + L.wq, P.wq, cross ? C : 3 * C, C, L.Q4, C4);
  stage_v(smem + L.bq, P.bq, cross ? C : 3 * C, L.Q4);
  stage_t<MM16>(smem + L.wp, P.wp, C, C, C4, C4);
  stage_v(smem + L.bp, P.bp, C, C4);
  stage_v(smem + L.g2, P.g2, C, C4);
  stage_v(smem + L.b2, P.b2, C, C4);
  stage_t<MM16>(smem + L.w1, P.w1, Ch, C, H4, C4);
  stage_v(smem + L.b1m, P.b1m, Ch, H4);
  stage_t<MM16>(smem + L.w2, P.w2, C, Ch, C4, H4);
  stage_v(smem + L.b2m, P.b2m, C, C4);
  // output o of the self qkv layer (cross: q, then kv at C + o) -> its
  // column in the qkv arena
  int* cols = reinterpret_cast<int*>(smem + L.cols);
  const int hd = C / H;
  for (int o = threadIdx.x; o < 3 * C; o += FUSION_FWD_THREADS) {
    const int kv = o - C, which = kv / C, c = kv % C;
    cols[o] = o < C ? o : C4 + (c / hd) * 2 * hd + which * hd + c % hd;
  }
}

// ---- asynchronous copies (cp.async) into shared memory ----------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(tc_smem(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(tc_smem(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int CH, typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, int dstride, const T* src, int sstride,
                                                int rows, int cols) {
  const int per = cols * (int)sizeof(T) / CH;
  for (int i = threadIdx.x; i < rows * per; i += FUSION_FWD_THREADS) {
    const int r = i / per, c = i % per;
    cp_async<CH>(reinterpret_cast<char*>(dst + (size_t)r * dstride) + c * CH,
                 reinterpret_cast<const char*>(src + (size_t)r * sstride) + c * CH);
  }
}

// rows x cols elements of src (rows sstride elements apart) to dst (rows
// dstride apart) by cp.async, in the widest chunks that every address and
// stride allows (plain loads and stores where none does). The caller
// commits and later waits.
template <typename T>
__device__ __forceinline__ void prefetch_rows(T* dst, int dstride, const T* src, int sstride,
                                              int rows, int cols) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                      (uintptr_t)(cols * sizeof(T)) | (uintptr_t)(dstride * sizeof(T)) |
                      (uintptr_t)(sstride * sizeof(T));
  if (a % 16 == 0) copy_rows_async<16>(dst, dstride, src, sstride, rows, cols);
  else if (a % 8 == 0) copy_rows_async<8>(dst, dstride, src, sstride, rows, cols);
  else if (a % 4 == 0) copy_rows_async<4>(dst, dstride, src, sstride, rows, cols);
  else
    for (int i = threadIdx.x; i < rows * cols; i += FUSION_FWD_THREADS)
      dst[(size_t)(i / cols) * dstride + i % cols] = src[(size_t)(i / cols) * sstride + i % cols];
}

// ---- the phases ---------------------------------------------------------------

// r / N for a row r = k N + n of the windows in flight (r < 2^11, N <= 256):
// (r + 0.5) / N lies at least 0.5 / N from an integer, far beyond the
// float product's rounding error. inv = 1 / N.
__device__ __forceinline__ int fusion_div(int r, float inv) { return (int)((r + 0.5f) * inv); }

// One LayerNorm row: channels at src (a stream's type or float), copy (if
// not NULL) receives them as float, the normalised row goes to dst.
template <typename T>
struct FusionLnRow {
  const T* src;
  float* copy;
  float* dst;
  const float *g, *b;
};

// Two-pass LayerNorm (nn/common.py semantics, eps 1e-5) of `rows` rows,
// four lanes a row: lane q holds channels q, q + 4, ... (E of them in
// registers; E = 0: C is known at run time only and they are read again
// each pass) and two shuffles add the lanes. row(r) gives the row's
// FusionLnRow; dst's channels C .. C4 - 1 are set to 0 (the dense products
// read rows as float4s). RND: the output rounded to bf16 (an mm16
// product's operand).
template <int E, bool RND, typename Row>
__device__ __forceinline__ void ln_rows(int rows, int C, int C4, Row row) {
  constexpr int LPR = 4;
  const int lane = threadIdx.x & 31, q = lane % LPR;
  for (int t0 = threadIdx.x - lane; t0 < rows * LPR; t0 += FUSION_FWD_THREADS) {
    const int t = t0 + lane;
    const bool live = t < rows * LPR;
    const auto R = row(live ? t / LPR : 0);
    // each(f): f(c, x) for the lane's channels c and their values x
    float x[E > 0 ? E : 1];
    if constexpr (E > 0) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        x[e] = q + LPR * e < C ? ld_stream(R.src + q + LPR * e) : 0.f;
    }
    auto each = [&](auto f) {
      if constexpr (E > 0) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (q + LPR * e < C) f(q + LPR * e, x[e]);
      } else {
        for (int c = q; c < C; c += LPR) f(c, ld_stream(R.src + c));
      }
    };
    float s = 0.f;
    each([&](int, float xc) { s += xc; });
    s += __shfl_xor_sync(MNT_FULL_MASK, s, 1);
    s += __shfl_xor_sync(MNT_FULL_MASK, s, 2);
    const float mu = s / C;
    float v = 0.f;
    each([&](int, float xc) {
      const float d = xc - mu;
      v = fmaf(d, d, v);
    });
    v += __shfl_xor_sync(MNT_FULL_MASK, v, 1);
    v += __shfl_xor_sync(MNT_FULL_MASK, v, 2);
    const float r = 1.f / sqrtf(v / C + 1e-5f);
    if (live) {
      each([&](int c, float xc) {
        if (R.copy) R.copy[c] = xc;
        const float h = (xc - mu) * r * R.g[c] + R.b[c];
        R.dst[c] = RND ? bf16r(h) : h;
      });
      for (int c = C + q; c < C4; c += LPR) R.dst[c] = 0.f;
    }
  }
}

// One task of a dense phase: s(r, o) = b[o] + sum_c in_r[c] W[o][c] for RT
// rows r = k N + n = rt, rt + n_rt, ... (< rows) and the four outputs
// o = 4 og .. 4 og + 3. in_r = row(k, n) is float4-aligned and zero past
// the K inputs; W^T at wt has rows O4 apart, b is padded to O4. Each sum is
// one fmaf chain from b[o] over c = 0, 1, ... (the order of the plain
// loop). A task keeps RT x 4 sums in registers; lanes of a warp take
// consecutive og, so a row's float4 is a broadcast and a weight float4 one
// of consecutive addresses. store(k, n, o0, s) consumes the four sums of a
// row.
template <int RT, typename Row, typename Store>
__device__ __forceinline__ void dense_task(int rt, int og, int n_rt, int rows, int N, float invN,
                                           int K4, const float* wt, int O4, const float* b,
                                           Row row, Store store) {
  const float* in[RT];
  int kk[RT];
  float s[RT][4];
  const float4 bb = *reinterpret_cast<const float4*>(b + 4 * og);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = min(rt + i * n_rt, rows - 1);
    kk[i] = fusion_div(r, invN);
    in[i] = row(kk[i], r - kk[i] * N);
    s[i][0] = bb.x;
    s[i][1] = bb.y;
    s[i][2] = bb.z;
    s[i][3] = bb.w;
  }
  const float* w = wt + 4 * og;
#pragma unroll
  for (int c4 = 0; c4 < K4; ++c4) {
    float4 wv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) wv[e] = *reinterpret_cast<const float4*>(w + (4 * c4 + e) * O4);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(in[i] + 4 * c4);
      const float xe[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][0] = fmaf(xe[e], wv[e].x, s[i][0]);
        s[i][1] = fmaf(xe[e], wv[e].y, s[i][1]);
        s[i][2] = fmaf(xe[e], wv[e].z, s[i][2]);
        s[i][3] = fmaf(xe[e], wv[e].w, s[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (rt + i * n_rt < rows) store(kk[i], rt + i * n_rt - kk[i] * N, 4 * og, s[i]);
}

// A whole dense phase over `rows` rows and O4 outputs, a task a thread in
// turn.
template <int RT, typename Row, typename Store>
__device__ __forceinline__ void dense_rows(int rows, int N, float invN, int K4, const float* wt,
                                           int O4, const float* b, Row row, Store store) {
  const int n_og = O4 / 4, n_rt = (rows + RT - 1) / RT;
  for (int t = threadIdx.x; t < n_og * n_rt; t += FUSION_FWD_THREADS)
    dense_task<RT>(t / n_og, t % n_og, n_rt, rows, N, invN, K4, wt, O4, b, row, store);
}

// The forward over the work items of I. A block walks items blockIdx.x,
// blockIdx.x + gridDim.x, ...; item i holds I.windows(i) (at most L's
// windows) subjects' windows at window position I.position(i), which share
// the shift mask; I.window(i, k) describes window k (FusionWindowT). wins:
// 2 * FUSION_FWD_WINDOWS descriptors in shared memory (double-buffered by
// item). TRAIN: the dropout draws, DropPath factors and x2r are applied;
// otherwise none is, and the body computes no hash.
//
// The float32 body runs the softmax online in base 2: q is scaled by
// log2(e) / sqrt(hd) and a key's bias + mask by log2 e, so 2^(s - m) is
// e^(s' - m') of the natural-unit scores; keys in steps of
// FUSION_FWD_KEYS, the running max and the sums rescaled once a step; the
// dropout scale 1 / (1 - rate) multiplies the output with 1 / l. MM16 keeps
// the mm16 softmax of the JAX kernel (two passes: the denominator, then the
// rounded probabilities).
//
// FLAG: the flagship's shape (N 36, C 12, 6 heads of dim 2, Ch 48) as
// compile-time constants, every loop bound and offset folded, four windows
// an attention task with a head's key and value in one float4; otherwise
// any shape the kernels take (head dim up to FUSION_MAXHD, one window an
// attention task).
template <bool CROSS, bool FLAG, bool MM16, bool TRAIN, typename S, typename Items>
__device__ __forceinline__ void fusion_forward_items(float* smem, FusionWindowT<S>* wins,
                                                     int windows, const Items& I,
                                                     const FusionParams& P,
                                                     const float* __restrict__ bias,
                                                     const float* __restrict__ mask, int N, int C,
                                                     int H, int Ch, const FusionTrain& T) {
  constexpr int FW = FUSION_FWD_WINDOWS, KC = FUSION_FWD_KEYS;
  constexpr int MAXHD = FLAG ? 2 : FUSION_MAXHD;
  constexpr int AW = FLAG ? FUSION_FWD_AW : 1;   // windows an attention task walks
  constexpr int LE = FLAG ? 3 : 0;               // channels a LayerNorm lane keeps
  if constexpr (FLAG) {
    N = 36;
    C = 12;
    H = 6;
    Ch = 48;
  }
  const FusionFwdLayout L(CROSS, N, C, H, Ch, windows, sizeof(S));
  const int tid = threadIdx.x;
  const int hd = C / H, CS = L.CS, QS = L.QS, HS = L.HS, BS = L.BS, AR = L.arena, C4 = L.C4;
  const float scale = 1.f / sqrtf((float)hd);
  const float qscale = MM16 ? scale : scale * FUSION_LOG2E;
  const float invN = 1.f / N;
  float* win = smem + L.win;
  const float* bs = smem + L.bias;
  const float* ms = smem + L.mask;
  const int* cols = reinterpret_cast<const int*>(smem + L.cols);
  S* pfx = reinterpret_cast<S*>(smem + L.pf);
  S* pfy = reinterpret_cast<S*>(smem + L.pfy);
  const int WN = N * C;   // elements of one prefetched window
  auto rnd = [](float v) { return MM16 ? bf16r(v) : v; };

  auto prefetch_streams = [&](int item) {
    for (int k = 0; k < I.windows(item); ++k) {
      const FusionWindowT<S> W = I.window(item, k);
      prefetch_rows(pfx + (size_t)k * WN, C, W.x, W.stride, N, C);
      if (CROSS) prefetch_rows(pfy + (size_t)k * WN, C, W.y, W.stride, N, C);
    }
  };
  auto prefetch_mask = [&](int item) {
    if (mask)
      prefetch_rows(smem + L.mask, BS, mask + (size_t)I.position(item) * N * N, N, N, N);
  };
  const int items = I.count();
  prefetch_rows(smem + L.bias, BS, bias, N, H * N, N);
  if ((int)blockIdx.x < items) {
    prefetch_streams(blockIdx.x);
    prefetch_mask(blockIdx.x);
  }
  cp_async_commit();
  stage_forward<MM16>(smem, L, CROSS, P, C, H, Ch);

  int parity = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, parity ^= 1) {
    FUSION_FWD_MARK(0);
    const int kw = I.windows(item), rows = kw * N, next = item + gridDim.x;
    FusionWindowT<S>* W = wins + parity * FW;
    if (tid < kw) W[tid] = I.window(item, tid);
    cp_async_wait();
    __syncthreads();   // this item's streams, mask and descriptors are in
    FUSION_FWD_MARK(1);

    // ---- LN1 (x -> xs, a; cross: y -> ys) ------------------------------------
    ln_rows<LE, MM16>(CROSS ? 2 * rows : rows, C, C4, [&](int r) {
      const bool yrow = CROSS && r >= rows;
      const int rr = yrow ? r - rows : r, k = fusion_div(rr, invN);
      float* A = win + k * AR + (rr - k * N) * CS;
      return yrow ? FusionLnRow<S>{pfy + (size_t)rr * C, nullptr, A + L.ys, smem + L.g1y,
                                   smem + L.b1y}
                  : FusionLnRow<S>{pfx + (size_t)rr * C, A, A + L.a, smem + L.g1, smem + L.b1};
    });
    __syncthreads();
    FUSION_FWD_MARK(2);
    if (next < items) {   // the prefetch buffer is free: the next item's streams
      prefetch_streams(next);
      cp_async_commit();
    }

    // ---- q, k, v ---------------------------------------------------------------
    {
      auto put = [&](int k, int n, int o, float s) {   // output o of the self qkv layer
        float* A = win + k * AR + L.qkv + n * QS;
        if (o < C) A[o] = rnd(s * qscale);
        else A[cols[o]] = rnd(s);
      };
      auto h1 = [&](int k, int n) { return win + k * AR + L.a + n * CS; };
      constexpr int RT = 2;
      const int n_rt = (rows + RT - 1) / RT;
      if (CROSS) {
        auto hy = [&](int k, int n) { return win + k * AR + L.ys + n * CS; };
        const int nq = L.Q4 / 4 * n_rt, nkv = L.KV4 / 4 * n_rt;
        for (int t = tid; t < nq + nkv; t += FUSION_FWD_THREADS) {
          if (t < nq)
            dense_task<RT>(t / (L.Q4 / 4), t % (L.Q4 / 4), n_rt, rows, N, invN, C4 / 4,
                           smem + L.wq, L.Q4, smem + L.bq, h1,
                           [&](int k, int n, int o0, const float(&s)[4]) {
#pragma unroll
                             for (int e = 0; e < 4; ++e)
                               if (o0 + e < C) put(k, n, o0 + e, s[e]);
                           });
          else
            dense_task<RT>((t - nq) / (L.KV4 / 4), (t - nq) % (L.KV4 / 4), n_rt, rows, N, invN,
                           C4 / 4, smem + L.wkv, L.KV4, smem + L.bkv, hy,
                           [&](int k, int n, int o0, const float(&s)[4]) {
#pragma unroll
                             for (int e = 0; e < 4; ++e)
                               if (o0 + e < 2 * C) put(k, n, C + o0 + e, s[e]);
                           });
        }
      } else {
        dense_rows<RT>(rows, N, invN, C4 / 4, smem + L.wq, L.Q4, smem + L.bq, h1,
                       [&](int k, int n, int o0, const float(&s)[4]) {
#pragma unroll
                         for (int e = 0; e < 4; ++e)
                           if (o0 + e < 3 * C) put(k, n, o0 + e, s[e]);
                       });
      }
    }
    __syncthreads();
    FUSION_FWD_MARK(3);

    // ---- attention: one (head, query) a task over AW windows -------------------
    {
      const int HN = H * N, groups = (kw + AW - 1) / AW;
      for (int t = tid; t < groups * HN; t += FUSION_FWD_THREADS) {
        const int hn = t % HN, k0 = (t / HN) * AW, h = hn / N, n = hn % N;
        const int nk = min(AW, kw - k0);
        const float* brow = bs + hn * BS;
        const float* mrow = mask ? ms + n * BS : nullptr;
        const float* kv[AW];
        float q[AW][MAXHD], o[AW][MAXHD];
#pragma unroll
        for (int a = 0; a < AW; ++a) {
          const float* A = win + (k0 + min(a, nk - 1)) * AR + L.qkv;
          kv[a] = A + C4 + h * 2 * hd;
#pragma unroll
          for (int d = 0; d < MAXHD; ++d) {
            q[a][d] = d < hd ? A[n * QS + h * hd + d] : 0.f;
            o[a][d] = 0.f;
          }
        }
        // s(a, j) = bm(j) + q_a . k_a(j): the bias and mask terms are the
        // same for every window of the item
        constexpr bool FULL = FLAG && 36 % KC == 0;   // no key step runs past N
        auto bm_at = [&](int j) {
          if (!FULL && j >= N) return -INFINITY;
          const float b = mrow ? brow[j] + mrow[j] : brow[j];
          return MM16 ? b : b * FUSION_LOG2E;
        };
        auto score = [&](int a, int j, float bm, float (&v)[MAXHD]) {
          const float* e = kv[a] + (FULL ? j : min(j, N - 1)) * QS;
          float s = bm;
          if constexpr (MAXHD == 2) {
            const float4 x = *reinterpret_cast<const float4*>(e);
            s = fmaf(q[a][1], x.y, fmaf(q[a][0], x.x, s));
            v[0] = x.z;
            v[1] = x.w;
          } else {
#pragma unroll
            for (int d = 0; d < MAXHD; ++d)
              if (d < hd) {
                s = fmaf(q[a][d], e[d], s);
                v[d] = e[hd + d];
              }
          }
          return s;
        };
        if constexpr (MM16) {
          // e = exp(min(s, 80)); den = sum bf16(e); p = e * bf16(1 / den);
          // the context sums bf16(p * keep) v
          float den[AW], rd[AW];
#pragma unroll
          for (int a = 0; a < AW; ++a) den[a] = 0.f;
          for (int j = 0; j < N; ++j) {
            const float bm = bm_at(j);
#pragma unroll
            for (int a = 0; a < AW; ++a) {
              float v[MAXHD];
              den[a] += bf16r(expf(fminf(score(a, j, bm, v), FUSION_LOGIT_CAP)));
            }
          }
#pragma unroll
          for (int a = 0; a < AW; ++a) rd[a] = bf16r(1.f / fmaxf(den[a], 1e-38f));
          for (int j = 0; j < N; ++j) {
            const float bm = bm_at(j);
#pragma unroll
            for (int a = 0; a < AW; ++a) {
              float v[MAXHD];
              const float e = expf(fminf(score(a, j, bm, v), FUSION_LOGIT_CAP));
              float kp = 1.f;
              if (TRAIN) {
                const FusionWindowT<S>& Wa = W[k0 + min(a, nk - 1)];
                kp = keep(T.attn, Wa.row0 + n, Wa.colA + (uint32_t)(h * T.NP + j));
              }
              const float pb = bf16r(e * rd[a] * kp);
#pragma unroll
              for (int d = 0; d < MAXHD; ++d)
                if (d < hd) o[a][d] = fmaf(pb, v[d], o[a][d]);
            }
          }
#pragma unroll
          for (int a = 0; a < AW; ++a)
            if (a < nk) {
              float* dst = win + (k0 + a) * AR + L.a + n * CS + h * hd;
#pragma unroll
              for (int d = 0; d < MAXHD; ++d)
                if (d < hd) dst[d] = bf16r(o[a][d]);
            }
        } else {
          float m[AW], l[AW];
          uint32_t rk[AW], ck[AW];
#pragma unroll
          for (int a = 0; a < AW; ++a) {
            m[a] = -FLT_MAX;
            l[a] = 0.f;
            if (TRAIN) {
              const FusionWindowT<S>& Wa = W[k0 + min(a, nk - 1)];
              rk[a] = keep_row(T.attn, Wa.row0 + n);
              ck[a] = (Wa.colA + (uint32_t)(h * T.NP)) * 668265261u;
            }
          }
          const bool drop = TRAIN && T.attn.on;
          for (int j0 = 0; j0 < N; j0 += KC) {
            float bm[KC];
#pragma unroll
            for (int jj = 0; jj < KC; ++jj) bm[jj] = bm_at(j0 + jj);
#pragma unroll
            for (int a = 0; a < AW; ++a) {
              float s[KC], v[KC][MAXHD];
#pragma unroll
              for (int jj = 0; jj < KC; ++jj) s[jj] = score(a, j0 + jj, bm[jj], v[jj]);
              float mx = s[0];
#pragma unroll
              for (int jj = 1; jj < KC; ++jj) mx = fmaxf(mx, s[jj]);
              const float mn = fmaxf(m[a], mx), corr = tc_ex2(m[a] - mn);
              m[a] = mn;
              l[a] *= corr;
#pragma unroll
              for (int d = 0; d < MAXHD; ++d) o[a][d] *= corr;
#pragma unroll
              for (int jj = 0; jj < KC; ++jj) {
                float p = tc_ex2(s[jj] - mn);
                l[a] += p;   // the sum takes every probability; o only the kept
                if (drop && !kept(T.attn, rk[a], ck[a] + (uint32_t)(j0 + jj) * 668265261u))
                  p = 0.f;
#pragma unroll
                for (int d = 0; d < MAXHD; ++d)
                  if (d < hd) o[a][d] = fmaf(p, v[jj][d], o[a][d]);
              }
            }
          }
          const float dscale = drop ? T.attn.scale : 1.f;
#pragma unroll
          for (int a = 0; a < AW; ++a)
            if (a < nk) {
              float* dst = win + (k0 + a) * AR + L.a + n * CS + h * hd;
              const float inv = dscale / l[a];
#pragma unroll
              for (int d = 0; d < MAXHD; ++d)
                if (d < hd) dst[d] = o[a][d] * inv;
            }
        }
      }
    }
    __syncthreads();
    FUSION_FWD_MARK(4);
    if (next < items) {   // the mask is free: the next item's
      prefetch_mask(next);
      cp_async_commit();
    }

    // ---- proj and the first residual: x2 = x + dp1 (proj(o) * m_proj) --------
    dense_rows<2>(
        rows, N, invN, C4 / 4, smem + L.wp, C4, smem + L.bp,
        [&](int k, int n) { return win + k * AR + L.a + n * CS; },
        [&](int k, int n, int o0, const float(&s)[4]) {
          const FusionWindowT<S>& Wk = W[k];
          float* xr = win + k * AR + n * CS;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = o0 + e;
            if (o >= C) break;
            float x2;
            if (TRAIN) {
              x2 = xr[o] + Wk.dp1 * (s[e] * keep(T.proj, Wk.row0 + n, Wk.colC + o));
              if (Wk.x2r) st_stream(Wk.x2r + (size_t)n * Wk.stride + o, x2);
            } else {
              x2 = xr[o] + s[e];
            }
            xr[o] = x2;
          }
        });
    __syncthreads();
    FUSION_FWD_MARK(5);

    // ---- LN2 (xs -> h2) ----------------------------------------------------------
    ln_rows<LE, MM16>(rows, C, C4, [&](int r) {
      const int k = fusion_div(r, invN);
      float* A = win + k * AR + (r - k * N) * CS;
      return FusionLnRow<float>{A, nullptr, A + L.qkv, smem + L.g2, smem + L.b2};
    });
    __syncthreads();
    FUSION_FWD_MARK(6);

    // ---- fc1, GELU, m1 (h2 -> u) ---------------------------------------------
    dense_rows<4>(
        rows, N, invN, C4 / 4, smem + L.w1, L.H4, smem + L.b1m,
        [&](int k, int n) { return win + k * AR + L.qkv + n * CS; },
        [&](int k, int n, int o0, const float(&s)[4]) {
          float* ur = win + k * AR + L.u + n * HS;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = o0 + e;
            float g = 0.f;   // padding columns: 0
            if (o < Ch) {
              g = gelu_erf(s[e]);
              if (TRAIN) g *= keep(T.mlp1, W[k].row0 + n, W[k].colH + o);
            }
            ur[o] = rnd(g);
          }
        });
    __syncthreads();
    FUSION_FWD_MARK(7);

    // ---- fc2 and the second residual: out = x2 + dp2 (fc2(u) * m2) ------------
    dense_rows<2>(
        rows, N, invN, L.H4 / 4, smem + L.w2, C4, smem + L.b2m,
        [&](int k, int n) { return win + k * AR + L.u + n * HS; },
        [&](int k, int n, int o0, const float(&s)[4]) {
          const FusionWindowT<S>& Wk = W[k];
          const float* xr = win + k * AR + n * CS;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = o0 + e;
            if (o >= C) break;
            const float z = TRAIN ? Wk.dp2 * (s[e] * keep(T.mlp2, Wk.row0 + n, Wk.colC + o))
                                  : s[e];
            st_stream(Wk.out + (size_t)n * Wk.stride + o, xr[o] + z);
          }
        });
    FUSION_FWD_MARK_SYNC(8);
    // the next item's first barrier keeps its LN1 off xs and u until every
    // thread is done here
  }
}

template <bool CROSS, bool FLAG, bool MM16, bool TRAIN, typename S, typename Items>
__global__ void __launch_bounds__(FUSION_FWD_THREADS, FUSION_FWD_MIN_BLOCKS)
fusion_forward_kernel(Items I, FusionParams P, const float* __restrict__ bias,
                      const float* __restrict__ mask, int windows, int N, int C, int H, int Ch,
                      FusionTrain T) {
  extern __shared__ float4 fusion_fwd_smem[];
  __shared__ FusionWindowT<S> wins[2 * FUSION_FWD_WINDOWS];
  fusion_forward_items<CROSS, FLAG, MM16, TRAIN, S>(reinterpret_cast<float*>(fusion_fwd_smem),
                                                    wins, windows, I, P, bias, mask, N, C, H, Ch,
                                                    T);
}

// How a forward launch runs on this card: `windows` in flight a block (the
// most that fit, at most FUSION_FWD_WINDOWS and `limit`, the subjects that
// share a window position), `per` subjects a work item (at most
// `windows`), the items, dynamic shared bytes, blocks an SM and blocks in
// the grid.
struct FusionFwdPlan {
  int windows, per, items, per_sm, blocks;
  size_t smem;
};

template <typename Kernel>
static cudaError_t forward_plan(Kernel kernel, bool cross, int N, int C, int H, int Ch,
                                int sbytes, int limit, int positions, FusionFwdPlan* plan) {
  int device = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  int fw = limit < FUSION_FWD_WINDOWS ? limit : FUSION_FWD_WINDOWS;
  size_t bytes = 0;
  for (; fw >= 1; --fw) {
    bytes = (size_t)FusionFwdLayout(cross, N, C, H, Ch, fw, sbytes).total * sizeof(float);
    if (bytes + attr.sharedSizeBytes <= (size_t)optin) break;
  }
  if (fw < 1) return cudaErrorInvalidConfiguration;
  // opt in whatever the size: the static descriptors may carry the total
  // past 48 KB when the dynamic part alone is not
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)) != cudaSuccess)
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FUSION_FWD_THREADS,
                                                           bytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // An item of k windows takes about a + b k with a = 2.5 b (kernel_ab's
  // times at batch 4 and 16): take the k that makes rounds of items x
  // (a + b k) least.
  const int slots = sms * per_sm;
  int per = 1;
  long long best = -1;
  for (int k = 1; k <= fw; ++k) {
    const long long items = (long long)(limit + k - 1) / k * positions;
    const long long cost = (items + slots - 1) / slots * (5 + 2 * k);
    if (best < 0 || cost <= best) {
      best = cost;
      per = k;
    }
  }
  plan->windows = fw;
  plan->per = per;
  plan->items = (limit + per - 1) / per * positions;
  plan->per_sm = per_sm;
  plan->blocks = plan->items < slots ? plan->items : slots;
  plan->smem = bytes;
  return cudaSuccess;
}

// Launch the forward over the items make_items(per) describes (I.per
// subjects an item, `limit` subjects and `positions` window positions in
// all); training or inference body by what T asks for. With out_plan, the
// plan goes there and nothing is launched.
template <bool CROSS, bool FLAG, bool MM16, typename S, typename MakeItems>
static cudaError_t launch_fusion_forward(MakeItems make_items, int limit, int positions,
                                         const FusionParams& P, const float* bias,
                                         const float* mask, int N, int C, int H, int Ch,
                                         const FusionTrain& T, cudaStream_t stream,
                                         FusionFwdPlan* out_plan = nullptr) {
  using Items = decltype(make_items(1));
  const bool train =
      T.dp || T.x2r || T.attn.on || T.proj.on || T.mlp1.on || T.mlp2.on;
  auto kernel = train ? fusion_forward_kernel<CROSS, FLAG, MM16, true, S, Items>
                      : fusion_forward_kernel<CROSS, FLAG, MM16, false, S, Items>;
  FusionFwdPlan plan;
  cudaError_t err =
      forward_plan(kernel, CROSS, N, C, H, Ch, (int)sizeof(S), limit, positions, &plan);
  if (err != cudaSuccess) return err;
  if (out_plan) {
    *out_plan = plan;
    return cudaSuccess;
  }
  kernel<<<plan.blocks, FUSION_FWD_THREADS, plan.smem, stream>>>(
      make_items(plan.per), P, bias, mask, plan.windows, N, C, H, Ch, T);
  return cudaGetLastError();
}

// The forward's shape dispatch: the flagship's (N 36, C 12, 6 heads, Ch 48)
// compiled for, any other at run time.
#define FUSION_FWD_DISPATCH(cross, N, C, H, Ch, F)                         \
  ([&] {                                                                  \
    const bool flag_ = (N) == 36 && (C) == 12 && (H) == 6 && (Ch) == 48; \
    return (cross) ? (flag_ ? F(true, true) : F(true, false))             \
                   : (flag_ ? F(false, true) : F(false, false));          \
  }())

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
// accumulators (FusionGrads), then the weights, bias and mask (FusionLayout,
// at fwd + its offsets). Then one arena a window in
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
    fwd = off;   // FusionLayout offsets are relative to fwd
    off += F.total;
    win = off;
    total = off + windows * arena;
  }
};

// s(k, n, o) = (b ? b[o] : 0) + sum_c in_k[n][c] W(o, c) over the rows n of
// every window k in flight, W(o, c) = W[o * wo + c * wk] (a weight read
// row-wise or transposed); `in` at offset in_off of each window's arena.
// A thread owns OT consecutive outputs of one row: one load of the row's
// element feeds OT FMAs, lanes on consecutive rows, so each weight element
// is a broadcast. Each sum runs in the order c = 0, 1, ...
template <typename Store>
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
      const float xv = row[c];
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
__device__ __forceinline__ void outer_elem(float* acc, int e, const float* win, int arena,
                                           int a_off, int as, int b_off, int bs, int J,
                                           int N, int kw) {
  const int o = e / J, j = e % J;
  float s0 = 0.f, s1 = 0.f;
  for (int k = 0; k < kw; ++k) {
    const float* A = win + k * arena + a_off + o;
    const float* B = win + k * arena + b_off + j;
    int n = 0;
    for (; n + 1 < N; n += 2) {
      s0 = fmaf(A[n * as], B[n * bs], s0);
      s1 = fmaf(A[(n + 1) * as], B[(n + 1) * bs], s1);
    }
    if (n < N) s0 = fmaf(A[n * as], B[n * bs], s0);
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
__device__ __forceinline__ void acc_outer_w(float* acc, const float* win, int arena, int a_off,
                                            int as, int O, int b_off, int bs, int J, int N,
                                            int kw, int t0 = 0,
                                            int nt = FUSION_BWD_THREADS) {
  for (int e = threadIdx.x - t0; e < O * J; e += nt)
    outer_elem(acc, e, win, arena, a_off, as, b_off, bs, J, N, kw);
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
template <bool CROSS, int MAXHD>
__device__ __forceinline__ void fusion_backward_windows(float* smem, const FusionBwdLayout& L,
                                                        const FusionLayout& F,
                                                        const FusionGrads& G, bool masked,
                                                        int N, int C, int H, int Ch,
                                                        const FusionTrain& T,
                                                        const FusionWindow* wins, int kw) {
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

  // ---- MLP / LN2 side over the saved x2r ------------------------------------
  for (int e = tid; e < rows * C; e += NT) {
    const int r = e / C, c = e % C, k = r / N, n = r % N;
    const FusionWindow& W = wins[k];
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
    const FusionWindow& W = wins[k];
    float* a = win + k * AR + n * CS + c;
    a[L.p3] = W.dp2 * a[L.p0] * keep(T.mlp2, W.row0 + n, W.colC + c);   // dz
  }
  __syncthreads();
  // u = fc1(h2) and GELU(u) * m1
  dense_w(win, AR, L.p2, CS, C, w + F.w1, CS, 1, w + F.b1m, Ch, N, kw,
          [&](int k, int n, int o, float s) {
            float* a = win + k * AR + n * HS + o;
            a[L.us] = s;
            a[L.gus] = gelu_erf(s) * keep(T.mlp1, wins[k].row0 + n, wins[k].colH + o);
             });
  __syncthreads();
  // du = (dz W2) * m1 * GELU'(u), written over u
  dense_w(win, AR, L.p3, CS, C, w + F.w2, 1, HS, nullptr, Ch, N, kw,
          [&](int k, int n, int j, float s) {
            float* u = win + k * AR + L.us + n * HS + j;
            *u = s * keep(T.mlp1, wins[k].row0 + n, wins[k].colH + j) * gelu_erf_grad(*u);
             });
  acc_outer_w(acc + G.w2, win, AR, L.p3, CS, C, L.gus, HS, Ch, N, kw);
  acc_cols_w(acc + G.b2m, win, AR, L.p3, CS, -1, 0, C, N, kw);
  __syncthreads();
  acc_outer_w(acc + G.w1, win, AR, L.us, HS, Ch, L.p2, CS, C, N, kw);
  acc_cols_w(acc + G.b1m, win, AR, L.us, HS, -1, 0, Ch, N, kw);
  dense_w(win, AR, L.us, HS, Ch, w + F.w1, 1, CS, nullptr, C, N, kw,
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
    const FusionWindow& W = wins[k];
    float* a = win + k * AR + n * CS + c;
    const size_t src = (size_t)n * W.stride + c;
    a[L.p2] = W.dp1 * a[L.p0] * keep(T.proj, W.row0 + n, W.colC + c);   // da
    a[L.p1] = ld_stream(W.x + src);
    if (CROSS) a[L.p6] = ld_stream(W.y + src);
  }
  __syncthreads();

  // ---- proj backward, LN1 and q/k/v recompute --------------------------------
  dense_w(win, AR, L.p2, CS, C, w + F.wp, 1, CS, nullptr, C, N, kw,
                [&](int k, int n, int c, float s) {
                  win[k * AR + L.p3 + n * CS + c] = s;   // dO
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
    dense_w(win, AR, L.h1, CS, C, w + F.wq, CS, 1, w + F.bq, C, N, kw,
                  [&](int k, int n, int o, float s) {
                    win[k * AR + L.qs + n * CS + o] = s * scale;
                  });
    dense_w(win, AR, L.h1y, CS, C, w + F.wkv, CS, 1, w + F.bkv, 2 * C, N, kw,
                  [&](int k, int n, int o, float s) {
                    float* a = win + k * AR + n * CS;
                    if (o < C) a[L.ks + o] = s;
                    else a[L.vs + o - C] = s;
                  });
  } else {
    dense_w(win, AR, L.h1, CS, C, w + F.wq, CS, 1, w + F.bq, 3 * C, N, kw,
                  [&](int k, int n, int o, float s) {
                    float* a = win + k * AR + n * CS;
                    if (o < C) a[L.qs + o] = s * scale;
                    else if (o < 2 * C) a[L.ks + o - C] = s;
                    else a[L.vs + o - 2 * C] = s;
                  });
  }
  __syncthreads();

  // ---- attention, row pass: one (window, head, query) per thread -------------
  for (int i = tid; i < kw * HN; i += NT) {
    const int k = i / HN, hi = i % HN, h = hi / N, n = hi % N, c0 = h * hd;
    const FusionWindow& W = wins[k];
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
    if (u < C * C) outer_elem(acc + G.wp, u, win, AR, L.p2, CS, L.os, CS, C, N, kw);
    else if (u < 2 * C * C)
      outer_elem(acc + G.wq, u - C * C, win, AR, L.dqkv, QS, L.h1, CS, C, N, kw);
    else cols_elem(acc + G.bq, u - 2 * C * C, win, AR, L.dqkv, QS, -1, 0, N, kw);
  };
  const bool beside = NT - HN >= 64;
  for (int i = tid; i < HN; i += NT) {
    const int h = i / N, j = i % N, c0 = h * hd;
    float* db = acc + G.bias + (size_t)h * N * N + j;
    for (int k = 0; k < kw; ++k) {
      const FusionWindow& W = wins[k];
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
        const float p = expf(s - lse[n]);
        const float kp = keep(T.attn, W.row0 + n, ca);
        const float ds = p * (dp * kp - Dd[n]);
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
    acc_outer_w(acc + G.wkv, win, AR, L.dqkv + C, QS, 2 * C, L.h1y, CS, C, N, kw);
    acc_cols_w(acc + G.bkv, win, AR, L.dqkv + C, QS, -1, 0, 2 * C, N, kw);
    dense_w(win, AR, L.dqkv, QS, C, w + F.wq, 1, CS, nullptr, C, N, kw,
                  [&](int k, int n, int c, float s) { win[k * AR + L.p3 + n * CS + c] = s; });
    dense_w(win, AR, L.dqkv + C, QS, 2 * C, w + F.wkv, 1, CS, nullptr, C, N, kw,
                  [&](int k, int n, int c, float s) {
                    win[k * AR + L.dh1y + n * CS + c] = s;
                  });
  } else {
    acc_outer_w(acc + G.wq + C * C, win, AR, L.dqkv + C, QS, 2 * C, L.h1, CS, C, N, kw);
    acc_cols_w(acc + G.bq + C, win, AR, L.dqkv + C, QS, -1, 0, 2 * C, N, kw);
    dense_w(win, AR, L.dqkv, QS, 3 * C, w + F.wq, 1, CS, nullptr, C, N, kw,
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
    const FusionWindow& W = wins[k];
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
                                   int threads, int* per_sm_out = nullptr) {
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
                              int NP, void* x2r) {
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
  return H < 1 || C % H != 0 || C / H > FUSION_MAXHD || N < 1 || N > FUSION_MAXN;
}

// The flagship's head dim is 2; anything wider takes the general bound. Two
// instantiations per direction keep nvcc's time small.
#define FUSION_DISPATCH(cross, hd, F)                        \
  ((cross) ? ((hd) <= 2 ? F(true, 2) : F(true, FUSION_MAXHD)) \
           : ((hd) <= 2 ? F(false, 2) : F(false, FUSION_MAXHD)))
