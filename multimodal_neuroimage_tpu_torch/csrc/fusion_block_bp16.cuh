// K7's backward on bf16 streams (the bf16 policy's bp stacks): the body of
// fusion_block_bp_backward16, written for Hopper's bf16 tensor cores.
//
// Replaces multimodal_neuroimage_tpu/ops/fusion_block_bp.py _bwd_impl_bp
// (its pallas_call at :808) under mm16 (:773): JAX's mm16 backward of the
// SwinFusion self and cross blocks on group-major bf16 streams, written out
// in PyTorch as fusion_block_bp_reference_backward16. Every product there
// takes bf16-rounded operands and sums in float32, which is what a bf16
// mma.sync computes; LayerNorms, GELU, residuals, dropout and every column
// sum (biases, LayerNorm scales, dbias) stay float32.
//
// What bounds it on the H100: neither bytes nor operations. A call at the
// bp flagship's B 16 reads and writes about 8 MB (0.0025-0.0044 ms at 3.35
// TB/s) and multiplies about 1.2 GFLOP; one work item (up to
// FUSION_BWD16_WINDOWS of a group's windows at one window position) runs
// ten phases, each ended by a block barrier, and the card's time is the
// latency of that chain times the items a block walks. The body this one
// replaced (the float32-stream body of fusion_block.cuh instantiated with
// mm16) ran every product as a float32 FMA chain with one owner thread an
// output element (a weight-gradient element a serial chain over rows x
// windows), rounded each operand to bf16 as it read it, and held four
// windows in flight a block.
//
// What the design does about that:
// - Dense products on bf16 mma.sync.m16n8k16 with float32 accumulators,
//   one warp a 16 x 8 output tile, all sixteen warps of the block on a
//   phase's tiles: the recomputed forward (QKV C -> 3C, fc1 C -> Ch; proj
//   is not recomputed: x2r is saved), the input gradients dX = dY W (fc2,
//   fc1, proj, QKV) and the weight gradients dW = dY^T X with the windows
//   in flight stacked along K (their rows, windows * N of them, in k16
//   steps; a weight-gradient tile is one warp's chain of mma, so its sum
//   has one fixed order). C = 12 is padded to k16 with zeros by the
//   fragment loads. mma.sync rather than wgmma: the stacked rows (8 x 36 =
//   288) would give wgmma 64-row tiles, but every product's N is 8-48 and
//   its K 16-48, so a wgmma would wait on its smem descriptors and
//   swizzled staging for a handful of k steps; mma.sync takes fragments
//   straight from the row buffers.
// - Operands staged once as bf16 in shared memory: the weights rounded at
//   staging, each activation rounded once where it is produced (h1, h2,
//   dz, GELU(u) m1, du, da, dO, q k v, o); values that a column sum or a
//   LayerNorm needs in float32 (dh2, dx2r, dq dk dv, dh1) stay float32 and
//   are rounded by the fragment load that reads them. The row buffers of
//   the MLP phase and of the attention phase share one region by
//   liveness, and x and y are read from device memory where LN1 and its
//   backward need them: eight windows of a group fit a block's shared
//   memory, self and cross alike, one block an SM.
// - The bias table (once a block) and each work item's shift mask come by
//   cp.async, the next item's mask issued as soon as the attention is done
//   with the current one.
// - The head-dim-2 attention (q k^T, p v and their backward) stays on the
//   CUDA cores: at hd 2 a k16 step would be 7/8 zeros. It keeps the mm16
//   softmax of the float32-stream form: e = exp(min(s, 80)), den = sum
//   bf16(e), p = e * rden with rden = bf16(1 / den), seg = bf16(sum_j
//   bf16(dp p)), ds = p (dp keep - seg); a row pass a (window, head, query)
//   (o, dq, rden, seg) and a column pass a (head, key) over the windows in
//   order (dk, dv, and dbias[h][:, key], which that thread owns).
// - What makes the gradients trustworthy is kept: every parameter and
//   dbias element has one owner a phase (a warp's tile, a warp's column
//   sum over rows, the column pass's thread), a block adds its items in
//   order into one partial, reduce_partials adds the partials in order:
//   no float atomics, bitwise-repeatable gradients; the dropout hash
//   coordinates are bp_window's (JAX's MLP1 lane offset included).
#pragma once

#include "fusion_block_bp.cuh"

#define FUSION_BWD16_THREADS 512
#define FUSION_BWD16_WARPS (FUSION_BWD16_THREADS / 32)
#define FUSION_BWD16_WINDOWS 8   // the most windows in flight a block

typedef __nv_bfloat16 bw16_t;

// Row pitches (elements) of the row buffers: a bf16 row holds an odd number
// of 32-bit words and a float32 row an odd number of floats, so threads on
// consecutive rows read distinct banks.
__host__ __device__ inline int bwd16_bpitch(int w) {
  const int p = (w + 1) & ~1;
  return (p / 2) % 2 ? p : p + 2;
}

__host__ __device__ inline int bwd16_fpitch(int w) { return w | 1; }

// Byte offsets of the backward's shared memory (each a multiple of 16).
// Once a block: the gradient accumulators (FusionGrads), the float32
// LayerNorm vectors and biases, the bf16 weights (row-major as the
// parameters), the bias table and shift mask (rows N + 1 apart) and the
// db1m partials. Then the row buffers of the R = windows * N stacked rows
// (row r = k N + n: token n of window k): dx2r and LN1's statistics for
// the whole item (x and y are read from device memory where LN1 needs
// them), and one region used twice by liveness, each view in two parts:
//   MLP view        x2r, g, dh2, LN2's statistics | h2, dz, GELU(u) m1, du
//   attention view  dO, qkv                        | da, h1, h1y, o, dqkv,
//                                                    (rden, seg)
// The first part of the MLP view lives until the LayerNorm-2 backward; dO
// and qkv, written after it, take its space. The second lives until the
// weight-gradient products; da, h1, h1y, written beside the LayerNorm-2
// backward, take its space. dh1 takes the space of dO and qkv and dh1y
// that of da and h1 (each dead once the attention's column pass is done).
struct Bwd16Layout {
  int PB, PH, PQ, PF, PQF, PRS, BS;
  size_t acc, g1, b1, g1y, b1y, bq, bkv, bp, g2, b2, b1m, b2m;
  size_t wq, wkv, wp, w1, w2, bias, mask, colpart;
  size_t dx2r, mu1, r1, mu1y, r1y, mu2, r2;
  size_t sx2r, sg, dh2, h2, dz, gu, du;
  size_t dO, o, dh1, da, h1, h1y, qkv, dqkv, dh1y, rs;
  size_t total;

  __host__ __device__ Bwd16Layout(bool cross, int N, int C, int H, int Ch, int windows) {
    const int R = windows * N, nq = cross ? C : 3 * C;
    PB = bwd16_bpitch(C); PH = bwd16_bpitch(Ch); PQ = bwd16_bpitch(3 * C);
    PF = bwd16_fpitch(C); PQF = bwd16_fpitch(3 * C); PRS = bwd16_bpitch(2 * H);
    BS = N + 1;
    const size_t F4 = 4, B2 = 2, X = cross ? 1 : 0;
    size_t off = 0;
    auto take = [&](size_t bytes) {
      const size_t at = off;
      off += (bytes + 15) & ~(size_t)15;
      return at;
    };
    acc = take(F4 * FusionGrads(cross, N, C, H, Ch).total);
    g1 = take(F4 * C); b1 = take(F4 * C);
    g1y = take(X * F4 * C); b1y = take(X * F4 * C);
    bq = take(F4 * nq); bkv = take(X * F4 * 2 * C);
    bp = take(F4 * C); g2 = take(F4 * C); b2 = take(F4 * C);
    b1m = take(F4 * Ch); b2m = take(F4 * C);
    wq = take(B2 * nq * C); wkv = take(X * B2 * 2 * C * C); wp = take(B2 * C * C);
    w1 = take(B2 * Ch * C); w2 = take(B2 * C * Ch);
    bias = take(F4 * H * N * BS); mask = take(F4 * N * BS);
    colpart = take(F4 * ((R + 15) / 16) * Ch);
    dx2r = take(F4 * R * PF);
    mu1 = take(F4 * R); r1 = take(F4 * R); mu1y = take(X * F4 * R); r1y = take(X * F4 * R);
    const size_t u0 = off;
    sx2r = take(B2 * R * PB); sg = take(B2 * R * PB); dh2 = take(F4 * R * PF);
    mu2 = take(F4 * R); r2 = take(F4 * R);
    const size_t u1 = off;
    h2 = take(B2 * R * PB); dz = take(B2 * R * PB);
    gu = take(B2 * R * PH); du = take(B2 * R * PH);
    const size_t mlp = off;
    off = u0;
    dO = take(B2 * R * PB); qkv = take(B2 * R * PQ);
    off = off > u1 ? off : u1;
    da = take(B2 * R * PB); h1 = take(B2 * R * PB); h1y = take(X * B2 * R * PB);
    o = take(B2 * R * PB); dqkv = take(F4 * R * PQF); rs = take(B2 * R * PRS);
    dh1 = dO;    // needs R PF floats: dO and qkv hold more
    dh1y = da;   // cross: da and h1
    total = off > mlp ? off : mlp;
  }
};

__device__ __forceinline__ float b2f(bw16_t v) { return __bfloat162float(v); }
__device__ __forceinline__ bw16_t f2b(float v) { return __float2bfloat16_rn(v); }

// Two values rounded to bf16 and packed as an mma operand register (lo in
// the low half). Exact for values that are bf16 already.
__device__ __forceinline__ uint32_t bwd16_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += one warp's 16 x 8 tile of sum_k A(m, k) B(k, n) over `ksteps` k16
// steps from k = 0, on bf16 mma.sync with float32 accumulators: rows m0 ..
// m0 + 15, columns n0 .. n0 + 7, lane l holding c[e] at row m0 + l / 4 +
// 8 (e / 2), column n0 + 2 (l % 4) + e % 2. A(m, k) and B(k, n) give the
// operands (0 outside the product: the k16 padding, rows past the windows
// in flight).
template <typename FA, typename FB>
__device__ __forceinline__ void bwd16_mma(float (&c)[4], int m0, int n0, int ksteps, FA A, FB B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = 16 * ks + t2;
    const uint32_t a[4] = {bwd16_pack(A(m0 + g, k), A(m0 + g, k + 1)),
                           bwd16_pack(A(m0 + g + 8, k), A(m0 + g + 8, k + 1)),
                           bwd16_pack(A(m0 + g, k + 8), A(m0 + g, k + 9)),
                           bwd16_pack(A(m0 + g + 8, k + 8), A(m0 + g + 8, k + 9))};
    tc_mma(c, a, bwd16_pack(B(k, n0 + g), B(k + 1, n0 + g)),
           bwd16_pack(B(k + 8, n0 + g), B(k + 9, n0 + g)));
  }
}

// The tile from zero; out(m, n, v) receives its elements (the caller drops
// those outside its output).
template <typename FA, typename FB, typename Out>
__device__ __forceinline__ void bwd16_tile(int m0, int n0, int ksteps, FA A, FB B, Out out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  bwd16_mma(c, m0, n0, ksteps, A, B);
#pragma unroll
  for (int e = 0; e < 4; ++e) out(m0 + g + 8 * (e >> 1), n0 + t2 + (e & 1), c[e]);
}

// acc[o] += sum over rows r < R of f(r, o), one warp (lanes on rows, then
// the warp's butterfly): the same order every run.
template <typename F>
__device__ __forceinline__ void bwd16_colsum(float* acc, int o, int R, F f) {
  float s = 0.f;
  for (int r = threadIdx.x & 31; r < R; r += 32) s += f(r, o);
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) acc[o] += s;
}

// LayerNorm statistics of one row (fusion_block.cuh ln_fwd_row's
// arithmetic): mean and 1 / sqrt(var + 1e-5); xh = (x - mu) r.
__device__ __forceinline__ void bwd16_ln_stats(const bw16_t* x, int C, float& mu, float& r) {
  float m = 0.f;
  for (int c = 0; c < C; ++c) m += b2f(x[c]);
  m /= C;
  float v = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d = b2f(x[c]) - m;
    v = fmaf(d, d, v);
  }
  v /= C;
  mu = m;
  r = 1.f / sqrtf(v + 1e-5f);
}

// h = bf16(LN(x) g + b) of one row.
__device__ __forceinline__ void bwd16_ln_out(const bw16_t* x, float mu, float r, const float* g,
                                             const float* b, bw16_t* h, int C) {
  for (int c = 0; c < C; ++c) h[c] = f2b((b2f(x[c]) - mu) * r * g[c] + b[c]);
}

// dst[c] = add[c] + r (dh g - mean(dh g) - xh mean(dh g xh)) of one row
// (fusion_block.cuh ln_bwd_row), xh recomputed from the bf16 input.
template <typename D>
__device__ __forceinline__ void bwd16_ln_bwd(const float* dh, const bw16_t* x, float mu, float r,
                                             const float* g, const float* add, D* dst, int C) {
  float m1 = 0.f, m2 = 0.f;
  for (int c = 0; c < C; ++c) {
    const float d = dh[c] * g[c];
    m1 += d;
    m2 = fmaf(d, (b2f(x[c]) - mu) * r, m2);
  }
  m1 /= C;
  m2 /= C;
  for (int c = 0; c < C; ++c)
    st_stream(dst + c,
              (add ? add[c] : 0.f) + r * (dh[c] * g[c] - m1 - (b2f(x[c]) - mu) * r * m2));
}

template <bool CROSS, int MAXHD>
__global__ void __launch_bounds__(FUSION_BWD16_THREADS, 1)
fusion_block_bp_backward16_kernel(const bw16_t* __restrict__ x, const bw16_t* __restrict__ y,
                                  const bw16_t* __restrict__ x2r, const bw16_t* __restrict__ g,
                                  FusionParams P, const float* __restrict__ bias,
                                  const float* __restrict__ mask, FusionTrain T,
                                  bw16_t* __restrict__ dx, bw16_t* __restrict__ dy,
                                  float* __restrict__ part, int ngroups, int G, int nW, int N,
                                  int C, int H, int Ch, int windows) {
  constexpr int NT = FUSION_BWD16_THREADS, NW = FUSION_BWD16_WARPS;
  extern __shared__ float4 bwd16_smem[];
  __shared__ FusionWindowT<bw16_t> wins[FUSION_BWD16_WINDOWS];
  char* sm = reinterpret_cast<char*>(bwd16_smem);
  const Bwd16Layout L(CROSS, N, C, H, Ch, windows);
  const FusionGrads Gr(CROSS, N, C, H, Ch);
  auto F32 = [&](size_t off) { return reinterpret_cast<float*>(sm + off); };
  auto B16 = [&](size_t off) { return reinterpret_cast<bw16_t*>(sm + off); };
  float *acc = F32(L.acc), *g1 = F32(L.g1), *b1 = F32(L.b1), *g1y = F32(L.g1y),
        *b1y = F32(L.b1y), *bq = F32(L.bq), *bkv = F32(L.bkv), *bp = F32(L.bp),
        *g2 = F32(L.g2), *b2 = F32(L.b2), *b1m = F32(L.b1m), *b2m = F32(L.b2m);
  float *bs = F32(L.bias), *ms = F32(L.mask), *colpart = F32(L.colpart);
  bw16_t *wq = B16(L.wq), *wkv = B16(L.wkv), *wp = B16(L.wp), *w1 = B16(L.w1),
         *w2 = B16(L.w2);
  bw16_t *sx2r = B16(L.sx2r), *sg = B16(L.sg);
  bw16_t *h2 = B16(L.h2), *dzb = B16(L.dz), *gu = B16(L.gu), *du = B16(L.du);
  bw16_t *dOb = B16(L.dO), *ob = B16(L.o), *da = B16(L.da), *h1 = B16(L.h1),
         *h1y = B16(L.h1y), *qkv = B16(L.qkv), *rs = B16(L.rs);
  float *dx2r = F32(L.dx2r), *mu1 = F32(L.mu1), *r1 = F32(L.r1), *mu1y = F32(L.mu1y),
        *r1y = F32(L.r1y), *mu2 = F32(L.mu2), *r2 = F32(L.r2), *dh2 = F32(L.dh2),
        *dh1 = F32(L.dh1), *dqkv = F32(L.dqkv), *dh1y = F32(L.dh1y);
  const int PB = L.PB, PH = L.PH, PQ = L.PQ, PF = L.PF, PQF = L.PQF, PRS = L.PRS, BS = L.BS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = CROSS ? C : 3 * C, hd = C / H, HN = H * N;
  const float scale = 1.f / sqrtf((float)hd);
  const bool masked = mask != nullptr;
  // tiles: k16 steps over C, Ch and the q (qkv) width; n8 tiles over C, Ch
  const int KC = (C + 15) / 16, KH = (Ch + 15) / 16, KQ = (3 * C + 15) / 16;
  const int NC = (C + 7) / 8, NH = (Ch + 7) / 8;

  // ---- once a block: accumulators, vectors, bf16 weights, bias table -------
  for (int e = tid; e < Gr.total; e += NT) acc[e] = 0.f;
  for (int i = tid; i < H * N * N; i += NT) cp_async<4>(bs + (i / N) * BS + i % N, bias + i);
  const int chunks = (G + windows - 1) / windows, items = ngroups * nW * chunks;
  auto prefetch_mask = [&](int item) {
    const float* src = mask + (size_t)(item / chunks % nW) * N * N;
    for (int i = tid; i < N * N; i += NT) cp_async<4>(ms + (i / N) * BS + i % N, src + i);
  };
  if (masked && (int)blockIdx.x < items) prefetch_mask(blockIdx.x);
  cp_async_commit();
  auto vec = [&](float* dst, const float* src, int n) {
    for (int i = tid; i < n; i += NT) dst[i] = src[i];
  };
  auto wts = [&](bw16_t* dst, const float* src, int n) {
    for (int i = tid; i < n; i += NT) dst[i] = f2b(src[i]);
  };
  vec(g1, P.g1, C); vec(b1, P.b1, C);
  if (CROSS) {
    vec(g1y, P.g1y, C); vec(b1y, P.b1y, C); vec(bkv, P.bkv, 2 * C);
    wts(wkv, P.wkv, 2 * C * C);
  }
  vec(bq, P.bq, nq); vec(bp, P.bp, C); vec(g2, P.g2, C); vec(b2, P.b2, C);
  vec(b1m, P.b1m, Ch); vec(b2m, P.b2m, C);
  wts(wq, P.wq, nq * C); wts(wp, P.wp, C * C); wts(w1, P.w1, Ch * C); wts(w2, P.w2, C * Ch);

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int gw = item / chunks, j0 = (item % chunks) * windows;
    const int grp = gw / nW, w = gw % nW;
    const int kw = min(windows, G - j0), R = kw * N, RT = (R + 15) / 16;
    if (tid < kw) {
      const int j = j0 + tid;
      FusionWindowT<bw16_t> W = bp_window<bw16_t>(grp, w, j, G, C, H, Ch, T);
      const size_t off = (size_t)gw * N * G * C + (size_t)j * C;
      W.x = x + off;
      W.y = CROSS ? y + off : nullptr;
      W.x2r = const_cast<bw16_t*>(x2r) + off;
      W.g = g + off;
      W.dx = dx + off;
      W.dy = CROSS ? dy + off : nullptr;
      wins[tid] = W;
    }
    __syncthreads();

    // ---- the item's streams -------------------------------------------------
    for (int e = tid; e < R * C; e += NT) {
      const int r = e / C, c = e % C;
      const FusionWindowT<bw16_t>& W = wins[r / N];
      const size_t src = (size_t)(r % N) * W.stride + c;
      sx2r[r * PB + c] = W.x2r[src];
      sg[r * PB + c] = W.g[src];
    }
    cp_async_wait();
    __syncthreads();   // streams, this item's mask (and the bias table) in

    // ---- LN2 over the saved x2r: h2; dz = dp2 g m2 --------------------------
    for (int r = tid; r < R; r += NT) {
      const FusionWindowT<bw16_t>& W = wins[r / N];
      const int n = r % N;
      float mu, rr;
      bwd16_ln_stats(sx2r + r * PB, C, mu, rr);
      mu2[r] = mu;
      r2[r] = rr;
      bwd16_ln_out(sx2r + r * PB, mu, rr, g2, b2, h2 + r * PB, C);
      for (int c = 0; c < C; ++c)
        dzb[r * PB + c] = f2b(W.dp2 * b2f(sg[r * PB + c]) * keep(T.mlp2, W.row0 + n, W.colC + c));
    }
    __syncthreads();

    // ---- u = fc1(h2) and dz W2 on the same tile: GELU(u) m1, du -------------
    for (int job = warp; job < RT * NH; job += NW) {
      const int m0 = job / NH * 16, n0 = job % NH * 8;
      const int gq = lane >> 2, t2 = 2 * (lane & 3);
      float cu[4] = {0.f, 0.f, 0.f, 0.f}, ct[4] = {0.f, 0.f, 0.f, 0.f};
      bwd16_mma(cu, m0, n0, KC,
                [&](int m, int k) { return m < R && k < C ? b2f(h2[m * PB + k]) : 0.f; },
                [&](int k, int n) { return k < C && n < Ch ? b2f(w1[n * C + k]) : 0.f; });
      bwd16_mma(ct, m0, n0, KC,
                [&](int m, int k) { return m < R && k < C ? b2f(dzb[m * PB + k]) : 0.f; },
                [&](int k, int n) { return k < C && n < Ch ? b2f(w2[k * Ch + n]) : 0.f; });
      float cs[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + gq + 8 * (e >> 1), j = n0 + t2 + (e & 1);
        float dv = 0.f;
        if (m < R && j < Ch) {
          const FusionWindowT<bw16_t>& W = wins[m / N];
          const float u = cu[e] + b1m[j];
          const float kp = keep(T.mlp1, W.row0 + m % N, W.colH + j);
          dv = ct[e] * kp * gelu_erf_grad(u);
          gu[m * PH + j] = f2b(gelu_erf(u) * kp);
          du[m * PH + j] = f2b(dv);
        }
        cs[e & 1] += dv;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs[0] += __shfl_xor_sync(MNT_FULL_MASK, cs[0], off);
        cs[1] += __shfl_xor_sync(MNT_FULL_MASK, cs[1], off);
      }
      if (gq == 0)
        for (int e = 0; e < 2; ++e)
          if (n0 + t2 + e < Ch) colpart[m0 / 16 * Ch + n0 + t2 + e] = cs[e];
    }
    __syncthreads();

    // ---- dW2 = dz^T GELU(u) m1, dW1 = du^T h2, dh2 = du W1; db2m, db1m -------
    {
      const int MC = (C + 15) / 16, MH = (Ch + 15) / 16;
      const int jw2 = MC * NH, jw1 = jw2 + MH * NC, jdh = jw1 + RT * NC, jb2 = jdh + C;
      const int jobs = jb2 + (Ch + 31) / 32;
      for (int job = warp; job < jobs; job += NW) {
        if (job < jw2) {
          bwd16_tile(job / NH * 16, job % NH * 8, RT,
                     [&](int m, int k) { return m < C && k < R ? b2f(dzb[k * PB + m]) : 0.f; },
                     [&](int k, int n) { return k < R && n < Ch ? b2f(gu[k * PH + n]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < C && n < Ch) acc[Gr.w2 + m * Ch + n] += v;
                     });
        } else if (job < jw1) {
          const int t = job - jw2;
          bwd16_tile(t / NC * 16, t % NC * 8, RT,
                     [&](int m, int k) { return m < Ch && k < R ? b2f(du[k * PH + m]) : 0.f; },
                     [&](int k, int n) { return k < R && n < C ? b2f(h2[k * PB + n]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < Ch && n < C) acc[Gr.w1 + m * C + n] += v;
                     });
        } else if (job < jdh) {
          const int t = job - jw1;
          bwd16_tile(t / NC * 16, t % NC * 8, KH,
                     [&](int m, int k) { return m < R && k < Ch ? b2f(du[m * PH + k]) : 0.f; },
                     [&](int k, int n) { return k < Ch && n < C ? b2f(w1[k * C + n]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < R && n < C) dh2[m * PF + n] = v;
                     });
        } else if (job < jb2) {
          bwd16_colsum(acc + Gr.b2m, job - jdh, R, [&](int r, int c) {
            const FusionWindowT<bw16_t>& W = wins[r / N];
            return W.dp2 * b2f(sg[r * PB + c]) * keep(T.mlp2, W.row0 + r % N, W.colC + c);
          });
        } else {
          const int j = (job - jb2) * 32 + lane;
          if (j < Ch) {
            float s = 0.f;
            for (int t = 0; t < RT; ++t) s += colpart[t * Ch + j];
            acc[Gr.b1m + j] += s;
          }
        }
      }
    }
    __syncthreads();

    // ---- LN2 backward: dx2r; da = dp1 dx2r m_proj; LN1 (h1, h1y); beside
    // it (warps from the last): dg2, db2 ------------------------------------
    for (int r = tid; r < R; r += NT) {
      const FusionWindowT<bw16_t>& W = wins[r / N];
      const int n = r % N;
      float* d = dx2r + r * PF;
      // dx2r = g + LN2'(dh2)
      {
        float m1 = 0.f, m2 = 0.f;
        const float mu = mu2[r], rr = r2[r];
        for (int c = 0; c < C; ++c) {
          const float dd = dh2[r * PF + c] * g2[c];
          m1 += dd;
          m2 = fmaf(dd, (b2f(sx2r[r * PB + c]) - mu) * rr, m2);
        }
        m1 /= C;
        m2 /= C;
        for (int c = 0; c < C; ++c) {
          const float xh = (b2f(sx2r[r * PB + c]) - mu) * rr;
          d[c] = b2f(sg[r * PB + c]) + rr * (dh2[r * PF + c] * g2[c] - m1 - xh * m2);
          da[r * PB + c] = f2b(W.dp1 * d[c] * keep(T.proj, W.row0 + n, W.colC + c));
        }
      }
      float mu, rr;
      const bw16_t* xr = W.x + (size_t)n * W.stride;
      bwd16_ln_stats(xr, C, mu, rr);
      mu1[r] = mu;
      r1[r] = rr;
      bwd16_ln_out(xr, mu, rr, g1, b1, h1 + r * PB, C);
      if (CROSS) {
        const bw16_t* yr = W.y + (size_t)n * W.stride;
        bwd16_ln_stats(yr, C, mu, rr);
        mu1y[r] = mu;
        r1y[r] = rr;
        bwd16_ln_out(yr, mu, rr, g1y, b1y, h1y + r * PB, C);
      }
    }
    for (int job = NW - 1 - warp; job < 2 * C; job += NW) {
      if (job < C)
        bwd16_colsum(acc + Gr.g2, job, R, [&](int r, int c) {
          return dh2[r * PF + c] * ((b2f(sx2r[r * PB + c]) - mu2[r]) * r2[r]);
        });
      else
        bwd16_colsum(acc + Gr.b2, job - C, R, [&](int r, int c) { return dh2[r * PF + c]; });
    }
    __syncthreads();

    // ---- dO = da Wp; q, k, v (q scaled); dbp -------------------------------
    {
      const int jdo = RT * NC, nqt = (nq + 7) / 8, jq = jdo + RT * nqt;
      const int jobs = jq + (CROSS ? RT * ((2 * C + 7) / 8) : 0);
      for (int job = warp; job < jobs; job += NW) {
        if (job < jdo) {
          bwd16_tile(job / NC * 16, job % NC * 8, KC,
                     [&](int m, int k) { return m < R && k < C ? b2f(da[m * PB + k]) : 0.f; },
                     [&](int k, int n) { return k < C && n < C ? b2f(wp[k * C + n]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < R && n < C) dOb[m * PB + n] = f2b(v);
                     });
        } else if (job < jq) {
          const int t = job - jdo;
          bwd16_tile(t / nqt * 16, t % nqt * 8, KC,
                     [&](int m, int k) { return m < R && k < C ? b2f(h1[m * PB + k]) : 0.f; },
                     [&](int k, int n) { return k < C && n < nq ? b2f(wq[n * C + k]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < R && n < nq) {
                         const float s = v + bq[n];
                         qkv[m * PQ + n] = f2b(n < C ? s * scale : s);
                       }
                     });
        } else {
          const int t = job - jq, nkv = (2 * C + 7) / 8;
          bwd16_tile(t / nkv * 16, t % nkv * 8, KC,
                     [&](int m, int k) { return m < R && k < C ? b2f(h1y[m * PB + k]) : 0.f; },
                     [&](int k, int n) { return k < C && n < 2 * C ? b2f(wkv[n * C + k]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < R && n < 2 * C) qkv[m * PQ + C + n] = f2b(v + bkv[n]);
                     });
        }
      }
      for (int job = NW - 1 - warp; job < C; job += NW)
        bwd16_colsum(acc + Gr.bp, job, R, [&](int r, int c) {
          const FusionWindowT<bw16_t>& W = wins[r / N];
          return W.dp1 * dx2r[r * PF + c] * keep(T.proj, W.row0 + r % N, W.colC + c);
        });
    }
    __syncthreads();

    // ---- attention, row pass: one (window, head, query) a thread -----------
    for (int i = tid; i < kw * HN; i += NT) {
      const int k = i / HN, hi = i % HN, h = hi / N, n = hi % N, c0 = h * hd;
      const int r = k * N + n;
      const FusionWindowT<bw16_t>& W = wins[k];
      const bw16_t* kb = qkv + (size_t)k * N * PQ + C + c0;   // key j: kb[j PQ + d]
      const bw16_t* vb = kb + C;
      float qi[MAXHD], gi[MAXHD], oa[MAXHD], dq[MAXHD];
#pragma unroll
      for (int d = 0; d < MAXHD; ++d) {
        qi[d] = d < hd ? b2f(qkv[r * PQ + c0 + d]) : 0.f;
        gi[d] = d < hd ? b2f(dOb[r * PB + c0 + d]) : 0.f;
        oa[d] = dq[d] = 0.f;
      }
      const float* brow = bs + hi * BS;
      const float* mrow = masked ? ms + n * BS : nullptr;
      const uint32_t rr = W.row0 + n, ca = W.colA + (uint32_t)(h * T.NP);
      float den = 0.f;
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) s = fmaf(qi[d], b2f(kb[j * PQ + d]), s);
        den += bf16r(expf(fminf(s, FUSION_LOGIT_CAP)));
      }
      const float rd = bf16r(1.f / fmaxf(den, 1e-38f));
      float sacc = 0.f;
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f), dpd = 0.f;
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) {
            s = fmaf(qi[d], b2f(kb[j * PQ + d]), s);
            dpd = fmaf(gi[d], b2f(vb[j * PQ + d]), dpd);
          }
        const float p = expf(fminf(s, FUSION_LOGIT_CAP)) * rd;
        const float kp = keep(T.attn, rr, ca + j);
        const float pb = bf16r(p * kp);
        sacc += bf16r(dpd * kp * p);
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) oa[d] = fmaf(pb, b2f(vb[j * PQ + d]), oa[d]);
      }
      const float seg = bf16r(sacc);
      for (int j = 0; j < N; ++j) {
        float s = brow[j] + (mrow ? mrow[j] : 0.f), dpd = 0.f;
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) {
            s = fmaf(qi[d], b2f(kb[j * PQ + d]), s);
            dpd = fmaf(gi[d], b2f(vb[j * PQ + d]), dpd);
          }
        const float p = expf(fminf(s, FUSION_LOGIT_CAP)) * rd;
        const float ds = bf16r(p * (dpd * keep(T.attn, rr, ca + j) - seg));
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) dq[d] = fmaf(ds, b2f(kb[j * PQ + d]), dq[d]);
      }
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          ob[r * PB + c0 + d] = f2b(oa[d]);
          dqkv[r * PQF + c0 + d] = dq[d] * scale;
        }
      rs[r * PRS + h] = f2b(rd);   // both bf16 values: stored exactly
      rs[r * PRS + H + h] = f2b(seg);
    }
    __syncthreads();

    // ---- attention, column pass: one (head, key) a thread over the windows in
    // order (it owns dbias[h][:, key]); beside it, on the warps the pass leaves
    // free (else after it): dWp = da^T o, the q rows of dWq (dWqkv), dbq --------
    {
      const int jwp = NC * NC, jwq = jwp + ((C + 15) / 16) * NC, jobs = jwq + C;
      auto side = [&](int job) {
        if (job < jwp) {
          bwd16_tile(job / NC * 16, job % NC * 8, RT,
                     [&](int m, int k) { return m < C && k < R ? b2f(da[k * PB + m]) : 0.f; },
                     [&](int k, int n) { return k < R && n < C ? b2f(ob[k * PB + n]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < C && n < C) acc[Gr.wp + m * C + n] += v;
                     });
        } else if (job < jwq) {
          const int t = job - jwp;
          bwd16_tile(t / NC * 16, t % NC * 8, RT,
                     [&](int m, int k) { return m < C && k < R ? dqkv[k * PQF + m] : 0.f; },
                     [&](int k, int n) { return k < R && n < C ? b2f(h1[k * PB + n]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < C && n < C) acc[Gr.wq + m * C + n] += v;
                     });
        } else {
          bwd16_colsum(acc + Gr.bq, job - jwq, R,
                       [&](int r, int c) { return dqkv[r * PQF + c]; });
        }
      };
      const int busy = (HN + 31) / 32;   // warps of the column pass
      for (int i = tid; i < HN; i += NT) {
        const int h = i / N, j = i % N, c0 = h * hd;
        float* db = acc + Gr.bias + (size_t)h * N * N + j;
        for (int k = 0; k < kw; ++k) {
          const FusionWindowT<bw16_t>& W = wins[k];
          const int rk = k * N;
          float kj[MAXHD], vj[MAXHD], dk[MAXHD], dv[MAXHD];
#pragma unroll
          for (int d = 0; d < MAXHD; ++d) {
            kj[d] = d < hd ? b2f(qkv[(rk + j) * PQ + C + c0 + d]) : 0.f;
            vj[d] = d < hd ? b2f(qkv[(rk + j) * PQ + 2 * C + c0 + d]) : 0.f;
            dk[d] = dv[d] = 0.f;
          }
          const uint32_t ca = W.colA + (uint32_t)(h * T.NP + j);
          for (int n = 0; n < N; ++n) {
            const int r = rk + n;
            float s = bs[(h * N + n) * BS + j] + (masked ? ms[n * BS + j] : 0.f), dp = 0.f;
            float qn[MAXHD], gn[MAXHD];
#pragma unroll
            for (int d = 0; d < MAXHD; ++d)
              if (d < hd) {
                qn[d] = b2f(qkv[r * PQ + c0 + d]);
                gn[d] = b2f(dOb[r * PB + c0 + d]);
                s = fmaf(qn[d], kj[d], s);
                dp = fmaf(gn[d], vj[d], dp);
              }
            const float p = expf(fminf(s, FUSION_LOGIT_CAP)) * b2f(rs[r * PRS + h]);
            const float kp = keep(T.attn, W.row0 + n, ca);
            const float ds = p * (dp * kp - b2f(rs[r * PRS + H + h]));
            db[n * N] += ds;
            const float dsr = bf16r(ds), pkr = bf16r(p * kp);
#pragma unroll
            for (int d = 0; d < MAXHD; ++d)
              if (d < hd) {
                dk[d] = fmaf(dsr, qn[d], dk[d]);
                dv[d] = fmaf(pkr, gn[d], dv[d]);
              }
          }
#pragma unroll
          for (int d = 0; d < MAXHD; ++d)
            if (d < hd) {
              dqkv[(rk + j) * PQF + C + c0 + d] = dk[d];
              dqkv[(rk + j) * PQF + 2 * C + c0 + d] = dv[d];
            }
        }
      }
      if (busy < NW && warp >= busy)
        for (int job = warp - busy; job < jobs; job += NW - busy) side(job);
      __syncthreads();
      if (busy >= NW) {
        for (int job = warp; job < jobs; job += NW) side(job);
        __syncthreads();   // dh1 (dh1y) take the space side() reads
      }
    }
    // the mask is free: the next item's
    if (masked && item + (int)gridDim.x < items) prefetch_mask(item + gridDim.x);
    cp_async_commit();

    // ---- k/v rows of the q (qkv) weight gradient, dbkv, dh1 (dh1y) ----------
    {
      const int MK = (2 * C + 15) / 16, jw = MK * NC, jb = jw + 2 * C, jh = jb + RT * NC;
      const int jobs = jh + (CROSS ? RT * NC : 0);
      for (int job = warp; job < jobs; job += NW) {
        if (job < jw) {
          const bw16_t* hk = CROSS ? h1y : h1;
          bwd16_tile(job / NC * 16, job % NC * 8, RT,
                     [&](int m, int k) { return m < 2 * C && k < R ? dqkv[k * PQF + C + m] : 0.f; },
                     [&](int k, int n) { return k < R && n < C ? b2f(hk[k * PB + n]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < 2 * C && n < C)
                         acc[(CROSS ? Gr.wkv : Gr.wq + C * C) + m * C + n] += v;
                     });
        } else if (job < jb) {
          bwd16_colsum(acc + (CROSS ? Gr.bkv : Gr.bq + C), job - jw, R,
                       [&](int r, int c) { return dqkv[r * PQF + C + c]; });
        } else if (job < jh) {
          // dh1 = dqkv Wqkv (cross: dq Wq)
          const int t = job - jb, K = CROSS ? C : 3 * C;
          bwd16_tile(t / NC * 16, t % NC * 8, CROSS ? KC : KQ,
                     [&](int m, int k) { return m < R && k < K ? dqkv[m * PQF + k] : 0.f; },
                     [&](int k, int n) { return k < K && n < C ? b2f(wq[k * C + n]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < R && n < C) dh1[m * PF + n] = v;
                     });
        } else {
          // cross: dh1y = dkv Wkv
          const int t = job - jh;
          bwd16_tile(t / NC * 16, t % NC * 8, (2 * C + 15) / 16,
                     [&](int m, int k) {
                       return m < R && k < 2 * C ? dqkv[m * PQF + C + k] : 0.f;
                     },
                     [&](int k, int n) { return k < 2 * C && n < C ? b2f(wkv[k * C + n]) : 0.f; },
                     [&](int m, int n, float v) {
                       if (m < R && n < C) dh1y[m * PF + n] = v;
                     });
        }
      }
    }
    __syncthreads();

    // ---- LN1 backward: dx = dx2r + LN1'(dh1) (dy = LN1y'(dh1y)); beside it
    // (warps from the last): dg1, db1 (dg1y, db1y) ----------------------------
    for (int r = tid; r < R; r += NT) {
      const FusionWindowT<bw16_t>& W = wins[r / N];
      const size_t n = r % N;
      bwd16_ln_bwd(dh1 + r * PF, W.x + n * W.stride, mu1[r], r1[r], g1, dx2r + r * PF,
                   W.dx + n * W.stride, C);
      if (CROSS)
        bwd16_ln_bwd(dh1y + r * PF, W.y + n * W.stride, mu1y[r], r1y[r], g1y,
                     (const float*)nullptr, W.dy + n * W.stride, C);
    }
    for (int job = NW - 1 - warp; job < (CROSS ? 4 : 2) * C; job += NW) {
      const int c = job % C, which = job / C;
      const float* dh = which < 2 ? dh1 : dh1y;
      const bool ys = which >= 2;
      const float* mu = which < 2 ? mu1 : mu1y;
      const float* rr = which < 2 ? r1 : r1y;
      float* a = acc + (which == 0 ? Gr.g1 : which == 1 ? Gr.b1 : which == 2 ? Gr.g1y : Gr.b1y);
      if (which % 2 == 0)
        bwd16_colsum(a, c, R, [&](int r, int cc) {
          const FusionWindowT<bw16_t>& W = wins[r / N];
          const bw16_t* xr = (ys ? W.y : W.x) + (size_t)(r % N) * W.stride;
          return dh[r * PF + cc] * ((b2f(xr[cc]) - mu[r]) * rr[r]);
        });
      else
        bwd16_colsum(a, c, R, [&](int r, int cc) { return dh[r * PF + cc]; });
    }
    __syncthreads();   // the next item overwrites the row buffers and wins
  }
  cp_async_wait();
  float* mine = part + (size_t)blockIdx.x * Gr.total;
  for (int e = tid; e < Gr.total; e += NT) mine[e] = acc[e];
}

// How a backward launch runs on this card: the most windows in flight that
// fit (at most FUSION_BWD16_WINDOWS and G), then as few as give the same
// number of work items a window position (chunks of a group as even as can
// be), its dynamic shared bytes, blocks in the grid, resident blocks an SM.
template <bool CROSS, int MAXHD>
static cudaError_t bp16_backward_grid(int ngroups, int G, int nW, int N, int C, int H, int Ch,
                                      int* blocks, size_t* smem, int* windows,
                                      int* per_sm = nullptr) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  const size_t fixed = sizeof(FusionWindowT<bw16_t>) * FUSION_BWD16_WINDOWS;
  int most = 0;
  for (int kw = G < FUSION_BWD16_WINDOWS ? G : FUSION_BWD16_WINDOWS; kw >= 1 && !most; --kw)
    if (Bwd16Layout(CROSS, N, C, H, Ch, kw).total + fixed <= (size_t)optin) most = kw;
  if (!most) return cudaErrorInvalidConfiguration;
  const int chunks = (G + most - 1) / most;
  *windows = (G + chunks - 1) / chunks;
  *smem = Bwd16Layout(CROSS, N, C, H, Ch, *windows).total;
  return persistent_grid(fusion_block_bp_backward16_kernel<CROSS, MAXHD>, *smem,
                         ngroups * nW * chunks, blocks, FUSION_BWD16_THREADS, per_sm);
}

template <bool CROSS, int MAXHD>
static cudaError_t launch_bp_backward16(const bw16_t* x, const bw16_t* y, const bw16_t* x2r,
                                        const bw16_t* g, const FusionParams& P,
                                        const float* bias, const float* mask,
                                        const FusionTrain& T, bw16_t* dx, bw16_t* dy,
                                        float* grads, float* scratch, int ngroups, int G,
                                        int nW, int N, int C, int H, int Ch,
                                        cudaStream_t stream) {
  int blocks = 0, windows = 0;
  size_t smem = 0;
  cudaError_t err = bp16_backward_grid<CROSS, MAXHD>(ngroups, G, nW, N, C, H, Ch, &blocks,
                                                     &smem, &windows);
  if (err != cudaSuccess) return err;
  fusion_block_bp_backward16_kernel<CROSS, MAXHD>
      <<<blocks, FUSION_BWD16_THREADS, smem, stream>>>(x, y, x2r, g, P, bias, mask, T, dx, dy,
                                                       scratch, ngroups, G, nW, N, C, H, Ch,
                                                       windows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(scratch, blocks, FusionGrads(CROSS, N, C, H, Ch).total, nullptr, grads,
                         stream);
}
