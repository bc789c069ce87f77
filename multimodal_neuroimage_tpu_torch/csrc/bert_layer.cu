// K1: one HF post-LN BERT layer, forward and (further down) backward.
//
// The forward replaces multimodal_neuroimage_tpu/ops/bert_layer.py
// bert_layer_call (_fbl_fwd over _make_fwd_kernel / _fwd_parts, and its
// batched-grid twin _make_fwd_kernel_batched, which computes the same layer):
//
//   q, k, v = x Wq, x Wk, x Wv; per head softmax(q k^T / sqrt(hd)) with keys
//   >= t_valid masked out; context; x1 = LN(ctx Wo + bo + x); out =
//   LN(GELU(x1 W1 + b1) W2 + b2 + x1); LN eps 1e-12, two-pass variance.
//
// In training it applies the JAX kernel's dropout draws (attention
// probabilities 3, attention output 0, FFN output 1, keyed by the padded
// coordinates r = b * TP + t, c = channel or h * TP + key) and saves q, k, v,
// ctx, the two pre-LN sums and the attention's log-sum-exp for the backward.
//
// What bounds it on the H100: the FFN, H = 84 -> F = 3072 -> 84, which is
// ~90% of the layer's 1.8 GFLOP at B = 4, T = 369, and its (T, 3072)
// intermediate, 18 MB a subject-layer if written out. bert_layer_forward
// (the section "the float32 forward on tensor cores" at the end of this
// file) runs every dense product on 3xTF32 mma.sync with GELU(u) kept in
// registers. The first forward, float32 FMAs on the CUDA cores, stays below
// as bert_layer_forward_simt: the precision yardstick of the tensor-core
// route (ops/bert_layer.py _GEMM_SIMT), as the backward's SIMT GEMM is.
// Its design, four kernels launched back to back on one stream:
//   1. bert_qkv_kernel: 32-row tiles x {q, k, v}; the tile and the 84 x 84
//      weight sit in shared memory (rows padded to 85 floats, which keeps
//      the 32 lanes of a warp on 32 distinct banks).
//   2. bert_attention_kernel: one block per (subject, head, 32 queries); K
//      and V of the head for all valid keys in shared memory (369 x 7 x 2
//      floats = 21 KB). Four lanes share a query, each taking every fourth
//      key, and merge their max, sum and context with warp shuffles: with
//      one query per lane a B = 4 call had ~4 warps per SM to hide its
//      chain of dependent keys. Max-subtracted softmax in registers. hd = 7
//      is odd, so K/V are stored (t, d). T is not padded: the TPU's
//      TP = 376 was a sublane pad; keys >= t_valid are skipped, which is
//      exact (their -1e9 logits underflow to 0).
//   3. bert_out_ln_kernel: out-projection + residual + LN1, one row per warp,
//      the LN reductions as warp shuffles.
//   4. bert_ffn_partial_kernel + bert_ffn_reduce_ln_kernel: 64-row tiles
//      times 16 slices of F (~380 blocks at B = 4). Each slice walks its F
//      columns in chunks of 32: GELU(u) of a chunk lives only in shared
//      memory, so the (T, 3072) intermediate never reaches device memory (as
//      in the TPU kernel, bert_layer.py:22-24), and both products run as
//      register tiles (4 x 2 and 4 x 6 per thread) so that one shared-memory
//      load feeds 3-4 FMAs. The slices' partial sums (16 x B x T x 84
//      floats, L2-resident) are added up with b2 and the x1 residual by the
//      second kernel, which then applies LN2.
#include "common.cuh"

#define BERT_THREADS 256
#define BERT_QKV_ROWS 32
#define BERT_LN_ROWS 16
#define BERT_MAXHD 16
#define BERT_ATTN_THREADS 128
#define BERT_ATTN_SPLIT 4      // lanes per query
#define BERT_ATTN_QUERIES (BERT_ATTN_THREADS / BERT_ATTN_SPLIT)

struct BertParams {
  const float *wq, *bq, *wk, *bk, *wv, *bv;  // (H, H), (H)
  const float *wo, *bo, *g1, *b1;            // (H, H), (H)
  const float *w1, *b1m;                     // (F, H), (F)
  const float *w2, *b2m, *g2, *b2;           // (H, F), (H)
};

__global__ void __launch_bounds__(BERT_THREADS)
bert_qkv_kernel(const float* __restrict__ x, BertParams P, float* __restrict__ q,
                float* __restrict__ k, float* __restrict__ v, int M, int H) {
  extern __shared__ float smem[];
  const int HP = H + 1;
  float* xs = smem;
  float* ws = smem + BERT_QKV_ROWS * HP;
  const int which = blockIdx.y;
  const float* W = which == 0 ? P.wq : (which == 1 ? P.wk : P.wv);
  const float* bb = which == 0 ? P.bq : (which == 1 ? P.bk : P.bv);
  float* dst = which == 0 ? q : (which == 1 ? k : v);
  const int r0 = blockIdx.x * BERT_QKV_ROWS;
  const int rows = min(BERT_QKV_ROWS, M - r0);
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * H; i += BERT_THREADS)
    xs[(i / H) * HP + i % H] = x[(size_t)r0 * H + i];
  for (int i = tid; i < H * H; i += BERT_THREADS) ws[(i / H) * HP + i % H] = W[i];
  __syncthreads();
  for (int i = tid; i < rows * H; i += BERT_THREADS) {
    const int r = i / H, o = i % H;
    const float* xr = xs + r * HP;
    const float* wr = ws + o * HP;
    float s = __ldg(bb + o);
    for (int c = 0; c < H; ++c) s = fmaf(xr[c], wr[c], s);
    dst[(size_t)r0 * H + i] = s;
  }
}

// QPL queries a lane group (the tensor-core forward's register blocking at
// larger batches: each key read from shared memory feeds QPL queries) and
// HDX the head dim where it is compiled in (0: hd at run time); every
// query's arithmetic, and so its result, is the same at any QPL and HDX.
template <int MAXHD, int QPL, int HDX>
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ ctx,
                      float* __restrict__ lse, Dropout drop, int T, int TP, int H, int hd_,
                      int t_valid, float scale) {
  const int hd = HDX ? HDX : hd_;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + (size_t)t_valid * hd;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t row0 = (size_t)b * T;
  for (int i = threadIdx.x; i < t_valid * hd; i += BERT_ATTN_THREADS) {
    const int t = i / hd, d = i % hd;
    const size_t g = (row0 + t) * H + h * hd + d;
    ks[i] = k[g];
    vs[i] = v[g];
  }
  __syncthreads();
  // BERT_ATTN_SPLIT consecutive lanes share QPL queries and take every
  // BERT_ATTN_SPLIT-th key; all lanes stay live for the shuffles
  const int part = threadIdx.x % BERT_ATTN_SPLIT;
  float qi[QPL][MAXHD];
  int iq[QPL];
#pragma unroll
  for (int qq = 0; qq < QPL; ++qq) {
    iq[qq] = (blockIdx.x * QPL + qq) * BERT_ATTN_QUERIES + threadIdx.x / BERT_ATTN_SPLIT;
    const bool live = iq[qq] < T;
    const size_t qrow = (row0 + (live ? iq[qq] : 0)) * H + h * hd;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) qi[qq][d] = live && d < hd ? q[qrow + d] * scale : 0.f;
  }

  float m[QPL];
#pragma unroll
  for (int qq = 0; qq < QPL; ++qq) m[qq] = -INFINITY;
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float kj[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) kj[d] = d < hd ? ks[j * hd + d] : 0.f;
#pragma unroll
    for (int qq = 0; qq < QPL; ++qq) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) s = fmaf(qi[qq][d], kj[d], s);
      m[qq] = fmaxf(m[qq], s);
    }
  }
#pragma unroll
  for (int qq = 0; qq < QPL; ++qq)
#pragma unroll
    for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
      m[qq] = fmaxf(m[qq], __shfl_xor_sync(MNT_FULL_MASK, m[qq], off));
  float l[QPL], acc[QPL][MAXHD];
  uint32_t rk[QPL];
#pragma unroll
  for (int qq = 0; qq < QPL; ++qq) {
    l[qq] = 0.f;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) acc[qq][d] = 0.f;
    // dropout of the normalised probabilities (draw 3, padded coordinates
    // r = b * TP + i, c = h * TP + key): the keep factor multiplies e^(s - m)
    // and the 1/l of the softmax factors out unchanged
    rk[qq] = keep_row(drop, (uint32_t)(b * TP + iq[qq]));
  }
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float kj[MAXHD], vj[MAXHD];
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) {
      kj[d] = d < hd ? ks[j * hd + d] : 0.f;
      vj[d] = d < hd ? vs[j * hd + d] : 0.f;
    }
    const uint32_t cm = (uint32_t)(h * TP + j) * 668265261u;
#pragma unroll
    for (int qq = 0; qq < QPL; ++qq) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) s = fmaf(qi[qq][d], kj[d], s);
      const float p = expf(s - m[qq]);
      l[qq] += p;
      const float pk = drop.on ? (kept(drop, rk[qq], cm) ? p * drop.scale : 0.f) : p;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) acc[qq][d] = fmaf(pk, vj[d], acc[qq][d]);
    }
  }
#pragma unroll
  for (int qq = 0; qq < QPL; ++qq)
#pragma unroll
    for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1) {
      l[qq] += __shfl_xor_sync(MNT_FULL_MASK, l[qq], off);
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        acc[qq][d] += __shfl_xor_sync(MNT_FULL_MASK, acc[qq][d], off);
    }
  if (part != 0) return;
#pragma unroll
  for (int qq = 0; qq < QPL; ++qq) {
    const int i = iq[qq];
    if (i >= T) continue;
    if (lse) lse[((size_t)b * gridDim.y + h) * T + i] = m[qq] + logf(l[qq]);
    const float inv = 1.f / l[qq];
    const size_t qrow = (row0 + i) * H + h * hd;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) ctx[qrow + d] = acc[qq][d] * inv;
  }
}

// ---- head dims above BERT_MAXHD (H / heads up to 96) --------------------------
//
// The kernels above hold a query's (or key's) head-dim vectors in registers
// and a head's K and V for every key in shared memory: at hd 84 that is
// 2 x 84 accumulators a lane and 2 x 369 x 84 floats (248 KB) a block. The
// wide kernels below keep the lane layout (four lanes a query, each taking
// every fourth key in order, merged by the same shuffles) and the float32
// arithmetic of every score (a fmaf chain over d = 0 .. hd - 1 of q * scale
// and k) and every sum, but hold the block's 32 query (or key) rows in
// shared memory, stream the other side through BERT_WIDE_KT-row tiles, and
// accumulate the outputs BERT_WIDE_CH head dims at a time, rebuilding the
// scores once a chunk: ceil(hd / 32) + 1 passes over the keys forward,
// ceil(hd / 32) backward. Bound, as the narrow kernels: shared-memory loads
// feeding the CUDA cores (two a score term here, q no longer in registers).
#define BERT_WIDE_CH 32   // output head dims a pass
#define BERT_WIDE_KT 32   // rows of the streamed side a shared tile
static_assert(BERT_WIDE_KT == BERT_ATTN_QUERIES && BERT_WIDE_KT % BERT_ATTN_SPLIT == 0,
              "a tile is the block's rows, and every lane keeps its key residue");

// Rows [r0, r0 + BERT_WIDE_KT) of one head of a (B T, H) matrix (b's rows
// from row0) into a [BERT_WIDE_KT][hd] tile, zero past `rows`, times `mul`.
__device__ __forceinline__ void bert_wide_tile(float* tile, const float* __restrict__ src,
                                               size_t row0, int r0, int rows, int H, int col,
                                               int hd, float mul) {
  for (int e = threadIdx.x; e < BERT_WIDE_KT * hd; e += BERT_ATTN_THREADS) {
    const int r = r0 + e / hd;
    tile[e] = r < rows ? src[(row0 + r) * H + col + e % hd] * mul : 0.f;
  }
}

// a . b over d < hd as one fmaf chain from 0 (the narrow kernels' order)
__device__ __forceinline__ float bert_wide_dot(const float* a, const float* b, int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// bert_attention_kernel for any hd: grid (ceil(T / 32), heads, B); shared
// memory (32 + 2 BERT_WIDE_KT) hd floats. Pass 1 the row max; then a pass a
// chunk of 32 output dims (the first also sums l).
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attention_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ ctx,
                           float* __restrict__ lse, Dropout drop, int T, int TP, int H, int hd,
                           int t_valid, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BERT_ATTN_QUERIES * hd;
  float* vs = ks + BERT_WIDE_KT * hd;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BERT_ATTN_QUERIES;
  const size_t row0 = (size_t)b * T;
  const int part = threadIdx.x % BERT_ATTN_SPLIT, qi = threadIdx.x / BERT_ATTN_SPLIT;
  const int i = i0 + qi;
  for (int e = threadIdx.x; e < BERT_ATTN_QUERIES * hd; e += BERT_ATTN_THREADS) {
    const int r = i0 + e / hd;
    qs[e] = r < T ? q[(row0 + r) * H + h * hd + e % hd] * scale : 0.f;
  }
  const float* qr = qs + qi * hd;
  float m = -INFINITY;
  for (int j0 = 0; j0 < t_valid; j0 += BERT_WIDE_KT) {
    __syncthreads();
    bert_wide_tile(ks, k, row0, j0, t_valid, H, h * hd, hd, 1.f);
    __syncthreads();
    for (int jl = part; jl < BERT_WIDE_KT && j0 + jl < t_valid; jl += BERT_ATTN_SPLIT)
      m = fmaxf(m, bert_wide_dot(qr, ks + jl * hd, hd));
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(MNT_FULL_MASK, m, off));
  const uint32_t rk = keep_row(drop, (uint32_t)(b * TP + i));
  float l = 0.f, inv = 0.f;
  for (int c0 = 0; c0 < hd; c0 += BERT_WIDE_CH) {
    float acc[BERT_WIDE_CH];
#pragma unroll
    for (int d = 0; d < BERT_WIDE_CH; ++d) acc[d] = 0.f;
    for (int j0 = 0; j0 < t_valid; j0 += BERT_WIDE_KT) {
      __syncthreads();
      bert_wide_tile(ks, k, row0, j0, t_valid, H, h * hd, hd, 1.f);
      bert_wide_tile(vs, v, row0, j0, t_valid, H, h * hd, hd, 1.f);
      __syncthreads();
      for (int jl = part; jl < BERT_WIDE_KT && j0 + jl < t_valid; jl += BERT_ATTN_SPLIT) {
        const int j = j0 + jl;
        const float p = expf(bert_wide_dot(qr, ks + jl * hd, hd) - m);
        if (c0 == 0) l += p;
        const float pk = drop.on ? (kept(drop, rk, (uint32_t)(h * TP + j) * 668265261u)
                                        ? p * drop.scale : 0.f)
                                 : p;
        const float* vj = vs + jl * hd + c0;
#pragma unroll
        for (int d = 0; d < BERT_WIDE_CH; ++d)
          if (c0 + d < hd) acc[d] = fmaf(pk, vj[d], acc[d]);
      }
    }
    if (c0 == 0) {
#pragma unroll
      for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
        l += __shfl_xor_sync(MNT_FULL_MASK, l, off);
      inv = 1.f / l;
    }
#pragma unroll
    for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
#pragma unroll
      for (int d = 0; d < BERT_WIDE_CH; ++d)
        acc[d] += __shfl_xor_sync(MNT_FULL_MASK, acc[d], off);
    if (part == 0 && i < T) {
      const size_t qrow = (row0 + i) * H + h * hd + c0;
#pragma unroll
      for (int d = 0; d < BERT_WIDE_CH; ++d)
        if (c0 + d < hd) ctx[qrow + d] = acc[d] * inv;
    }
  }
  if (lse && part == 0 && i < T) lse[((size_t)b * gridDim.y + h) * T + i] = m + logf(l);
}

static size_t bert_wide_smem(int hd) {
  return (size_t)(BERT_ATTN_QUERIES + 2 * BERT_WIDE_KT) * hd * sizeof(float);
}

// Launch bert_attention_kernel with QPL queries a lane group; HD7: the
// flagship's head dim 7 compiled in. Head dims above BERT_MAXHD take the
// wide kernel (QPL 1).
template <int QPL, bool HD7>
static cudaError_t bert_attention(const float* q, const float* k, const float* v, float* ctx,
                                  float* lse, const Dropout& drop, int B, int T, int TP, int H,
                                  int heads, int t_valid, cudaStream_t stream) {
  const int hd = H / heads;
  const float scale = 1.f / sqrtf((float)hd);
  cudaError_t err;
  if (hd > BERT_MAXHD) {
    const size_t smem = bert_wide_smem(hd);
    if ((err = allow_smem(bert_attention_wide_kernel, smem)) != cudaSuccess) return err;
    const dim3 grid((T + BERT_ATTN_QUERIES - 1) / BERT_ATTN_QUERIES, heads, B);
    bert_attention_wide_kernel<<<grid, BERT_ATTN_THREADS, smem, stream>>>(
        q, k, v, ctx, lse, drop, T, TP, H, hd, t_valid, scale);
    return cudaGetLastError();
  }
  const size_t smem = 2 * (size_t)t_valid * hd * sizeof(float);
  const dim3 grid((T + QPL * BERT_ATTN_QUERIES - 1) / (QPL * BERT_ATTN_QUERIES), heads, B);
#define BERT_ATTN_LAUNCH(MAXHD, HDX)                                                        \
  do {                                                                                      \
    if ((err = allow_smem(bert_attention_kernel<MAXHD, QPL, HDX>, smem)) != cudaSuccess)    \
      return err;                                                                           \
    bert_attention_kernel<MAXHD, QPL, HDX><<<grid, BERT_ATTN_THREADS, smem, stream>>>(       \
        q, k, v, ctx, lse, drop, T, TP, H, hd, t_valid, scale);                             \
  } while (0)
  if (HD7 && hd == 7) BERT_ATTN_LAUNCH(8, 7);
  else if (hd <= 8) BERT_ATTN_LAUNCH(8, 0);
  else BERT_ATTN_LAUNCH(16, 0);
#undef BERT_ATTN_LAUNCH
  return cudaGetLastError();
}

// One H-wide row held four values per lane (H <= 128): two-pass LayerNorm
// with warp-shuffle reductions, written to dst.
__device__ __forceinline__ void warp_ln_store(const float (&vals)[4], int lane, int H,
                                              const float* __restrict__ g,
                                              const float* __restrict__ b, float eps,
                                              float* __restrict__ dst) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (lane + 32 * t < H) s += vals[t];
  const float mu = warp_sum(s) / H;
  float ss = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (lane + 32 * t < H) {
      const float d = vals[t] - mu;
      ss = fmaf(d, d, ss);
    }
  const float r = 1.f / sqrtf(warp_sum(ss) / H + eps);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int o = lane + 32 * t;
    if (o < H) dst[o] = (vals[t] - mu) * r * __ldg(g + o) + __ldg(b + o);
  }
}

__global__ void __launch_bounds__(BERT_THREADS)
bert_out_ln_kernel(const float* __restrict__ ctx, const float* __restrict__ x, BertParams P,
                   float* __restrict__ x1, float* __restrict__ a1, Dropout drop, int T, int TP,
                   int M, int H, float eps) {
  extern __shared__ float smem[];
  const int HP = H + 1;
  float* ws = smem;             // Wo, H x HP
  float* cs = smem + H * HP;    // ctx rows, BERT_LN_ROWS x HP
  const int r0 = blockIdx.x * BERT_LN_ROWS;
  const int rows = min(BERT_LN_ROWS, M - r0);
  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += BERT_THREADS) ws[(i / H) * HP + i % H] = P.wo[i];
  for (int i = tid; i < rows * H; i += BERT_THREADS)
    cs[(i / H) * HP + i % H] = ctx[(size_t)r0 * H + i];
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += BERT_THREADS / 32) {
    const size_t row = (size_t)(r0 + r) * H;
    const uint32_t rr = (uint32_t)((r0 + r) / T * TP + (r0 + r) % T);  // padded row
    float vals[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = lane + 32 * t;
      vals[t] = 0.f;
      if (o < H) {
        const float* cr = cs + r * HP;
        const float* wr = ws + o * HP;
        float a = __ldg(P.bo + o);
        for (int c = 0; c < H; ++c) a = fmaf(cr[c], wr[c], a);
        vals[t] = a * keep(drop, rr, o) + x[row + o];   // hidden dropout, draw 0
        if (a1) a1[row + o] = vals[t];
      }
    }
    warp_ln_store(vals, lane, H, P.g1, P.b1, eps, x1 + row);
  }
}

// FFN, pass 1: a 64-row tile times one slice of F. Per 32-column chunk of
// the slice: u = x1 W1c^T + b1 (each thread a 4 x 2 register tile), GELU(u)
// into shared memory only, then z += GELU(u) W2c^T (each thread a 4 x 6
// register tile of the tile's 64 x 96 outputs, columns >= H padded with
// zero weights). The slice's partial z goes to a scratch buffer; splitting
// F over blocks gives ~400 blocks at B = 4 instead of ~24 row tiles.
#define FFN_BM 64        // rows per block
#define FFN_BF 32        // F columns per chunk
#define FFN_XS 68        // row stride of the transposed x1 tile and GELU tile
#define FFN_W1S 33       // row stride of the transposed W1 chunk (odd: no bank conflicts)
#define FFN_W2S 97       // row stride of the transposed W2 chunk (odd: no bank conflicts)
#define FFN_CPT 6        // output columns per thread: 16 x 6 = 96 >= H
#define FFN_MAXH (16 * FFN_CPT)
#define FFN_MAXSPLIT 16

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

__global__ void __launch_bounds__(BERT_THREADS)
bert_ffn_partial_kernel(const float* __restrict__ x1, BertParams P, float* __restrict__ part,
                        int M, int H, int F, int chunks_per_split) {
  extern __shared__ float smem[];
  float* xT = smem;                              // H x FFN_XS: x1 tile, (k, row)
  float* w1T = xT + H * FFN_XS;                  // H x FFN_W1S: W1 chunk, (k, j)
  float* gT = w1T + align4(H * FFN_W1S);         // FFN_BF x FFN_XS: GELU(u), (j, row)
  float* w2T = gT + FFN_BF * FFN_XS;             // FFN_BF x FFN_W2S: W2 chunk, (j, o)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * FFN_BM;
  const int split = blockIdx.y;
  for (int i = tid; i < FFN_BM * H; i += BERT_THREADS) {
    const int k = i / FFN_BM, r = i % FFN_BM;
    xT[k * FFN_XS + r] = r0 + r < M ? x1[(size_t)(r0 + r) * H + k] : 0.f;
  }
  float z[4][FFN_CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < FFN_CPT; ++c) z[i][c] = 0.f;

  for (int chunk = 0; chunk < chunks_per_split; ++chunk) {
    const int f0 = (split * chunks_per_split + chunk) * FFN_BF;
    __syncthreads();  // the previous chunk's readers are done; xT is loaded
    for (int i = tid; i < FFN_BF * H; i += BERT_THREADS) {
      const int j = i / H, k = i % H;
      w1T[k * FFN_W1S + j] = P.w1[(size_t)(f0 + j) * H + k];
    }
    for (int i = tid; i < FFN_BF * FFN_MAXH; i += BERT_THREADS) {
      const int o = i / FFN_BF, j = i % FFN_BF;
      w2T[j * FFN_W2S + o] = o < H ? P.w2[(size_t)o * F + f0 + j] : 0.f;
    }
    __syncthreads();
    float u[4][2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float b = __ldg(P.b1m + f0 + tx * 2 + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i][c] = b;
    }
    for (int k = 0; k < H; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(xT + k * FFN_XS + ty * 4);
      const float b0 = w1T[k * FFN_W1S + tx * 2];
      const float b1 = w1T[k * FFN_W1S + tx * 2 + 1];
      u[0][0] = fmaf(a.x, b0, u[0][0]); u[0][1] = fmaf(a.x, b1, u[0][1]);
      u[1][0] = fmaf(a.y, b0, u[1][0]); u[1][1] = fmaf(a.y, b1, u[1][1]);
      u[2][0] = fmaf(a.z, b0, u[2][0]); u[2][1] = fmaf(a.z, b1, u[2][1]);
      u[3][0] = fmaf(a.w, b0, u[3][0]); u[3][1] = fmaf(a.w, b1, u[3][1]);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
      *reinterpret_cast<float4*>(gT + (tx * 2 + c) * FFN_XS + ty * 4) =
          make_float4(gelu_erf(u[0][c]), gelu_erf(u[1][c]), gelu_erf(u[2][c]),
                      gelu_erf(u[3][c]));
    __syncthreads();
    for (int j = 0; j < FFN_BF; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(gT + j * FFN_XS + ty * 4);
      const float* wr = w2T + j * FFN_W2S + tx * FFN_CPT;
#pragma unroll
      for (int c = 0; c < FFN_CPT; ++c) {
        const float b = wr[c];
        z[0][c] = fmaf(a.x, b, z[0][c]);
        z[1][c] = fmaf(a.y, b, z[1][c]);
        z[2][c] = fmaf(a.z, b, z[2][c]);
        z[3][c] = fmaf(a.w, b, z[3][c]);
      }
    }
  }
  float* dst = part + (size_t)split * M * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int c = 0; c < FFN_CPT; ++c) {
      const int o = tx * FFN_CPT + c;
      if (o < H) dst[(size_t)r * H + o] = z[i][c];
    }
  }
}

// FFN, pass 2: sum the F slices' partials + b2 + the x1 residual, then LN2;
// one row per warp.
__global__ void __launch_bounds__(BERT_THREADS)
bert_ffn_reduce_ln_kernel(const float* __restrict__ part, int splits,
                          const float* __restrict__ x1, BertParams P, float* __restrict__ out,
                          float* __restrict__ a2, Dropout drop, int T, int TP, int M, int H,
                          float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (BERT_THREADS / 32) + warp;
  if (row >= M) return;
  const uint32_t rr = (uint32_t)(row / T * TP + row % T);   // padded row
  float vals[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int o = lane + 32 * t;
    vals[t] = 0.f;
    if (o < H) {
      float z = __ldg(P.b2m + o);
      for (int sp = 0; sp < splits; ++sp) z += part[((size_t)sp * M + row) * H + o];
      vals[t] = z * keep(drop, rr, o) + x1[(size_t)row * H + o];   // hidden dropout, draw 1
      if (a2) a2[(size_t)row * H + o] = vals[t];
    }
  }
  warp_ln_store(vals, lane, H, P.g2, P.b2, eps, out + (size_t)row * H);
}

static int ffn_splits(int F) {
  const int chunks = F / FFN_BF;
  int splits = chunks < FFN_MAXSPLIT ? chunks : FFN_MAXSPLIT;
  while (chunks % splits) --splits;
  return splits;
}

// Floats of device scratch bert_layer_forward_simt needs: q, k, v, ctx, x1
// and the FFN's per-slice partial sums.
extern "C" long long bert_layer_scratch_simt_floats(int B, int T, int H, int F) {
  return (long long)B * T * H * (5 + ffn_splits(F));
}

// Floats of the training forward's saved residuals: q, k, v, ctx, a1 (the
// pre-LN1 sum), x1, a2 (the pre-LN2 sum), (B, T, H) each, then the
// per-(subject, head, query) log-sum-exp of the attention, (B, heads, T).
extern "C" long long bert_layer_resid_floats(int B, int T, int H, int heads) {
  return 7LL * B * T * H + (long long)B * heads * T;
}

static bool bert_bad_dims(int T, int H, int F, int heads, int t_valid, int TP) {
  return H > FFN_MAXH || heads < 1 || H % heads != 0 || F % FFN_BF != 0 || t_valid < 1 || t_valid > T || TP < T;
}

// The SIMT forward (the precision yardstick of bert_layer_forward, same
// arguments). x, out: (B, T, H) f32 contiguous; scratch:
// bert_layer_scratch_simt_floats() floats of device memory. params: host
// array of 16 device pointers in the JAX kernel's order
//   wq bq wk bk wv bv wo bo g1 b1 w1 b1m w2 b2m g2 b2
// with weights in torch (out, in) layout. Keys >= t_valid are masked out.
// Training: resid (bert_layer_resid_floats() floats) receives the residuals
// the backward consumes, and the dropout draws (attention 3 at attn_rate,
// hidden 0 and 1 at hidden_rate, from seed) use the JAX kernel's padded
// coordinates with TP = round_up(T, 8) rows a subject. Inference: resid
// NULL and both rates 0. Needs H <= 96, heads dividing H and F % 32 == 0.
// Returns the cudaError_t of the first launch that fails, or of the last.
extern "C" int bert_layer_forward_simt(const float* x, const void* const* params,
                                       float* scratch, float* resid, float* out, int B, int T,
                                       int H, int F, int heads, int t_valid, int TP, int seed,
                                       double attn_rate, double hidden_rate,
                                       cudaStream_t stream) {
  if (bert_bad_dims(T, H, F, heads, t_valid, TP)) return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(params);
  const BertParams P = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                        p[8], p[9], p[10], p[11], p[12], p[13], p[14], p[15]};
  const int M = B * T;
  const size_t MH = (size_t)M * H;
  float* base = resid ? resid : scratch;
  float *q = base, *k = q + MH, *v = k + MH, *ctx = v + MH;
  float *a1 = nullptr, *x1, *a2 = nullptr, *lse = nullptr;
  if (resid) {
    a1 = ctx + MH;
    x1 = a1 + MH;
    a2 = x1 + MH;
    lse = a2 + MH;
  } else {
    x1 = ctx + MH;
  }
  float* part = scratch + 5 * MH;
  const int HP = H + 1;
  const int hd = H / heads;
  const float eps = 1e-12f;
  const Dropout d_attn = make_dropout(seed, 3, attn_rate);
  const Dropout d0 = make_dropout(seed, 0, hidden_rate);
  const Dropout d1 = make_dropout(seed, 1, hidden_rate);
  cudaError_t err;

  const size_t smem_qkv = (size_t)(BERT_QKV_ROWS + H) * HP * sizeof(float);
  if ((err = allow_smem(bert_qkv_kernel, smem_qkv)) != cudaSuccess) return (int)err;
  bert_qkv_kernel<<<dim3((M + BERT_QKV_ROWS - 1) / BERT_QKV_ROWS, 3), BERT_THREADS, smem_qkv,
                    stream>>>(x, P, q, k, v, M, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = bert_attention<1, false>(q, k, v, ctx, lse, d_attn, B, T, TP, H, heads, t_valid,
                                      stream)) != cudaSuccess)
    return (int)err;

  const size_t smem_ln = (size_t)(H + BERT_LN_ROWS) * HP * sizeof(float);
  if ((err = allow_smem(bert_out_ln_kernel, smem_ln)) != cudaSuccess) return (int)err;
  bert_out_ln_kernel<<<(M + BERT_LN_ROWS - 1) / BERT_LN_ROWS, BERT_THREADS, smem_ln, stream>>>(
      ctx, x, P, x1, a1, d0, T, TP, M, H, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int splits = ffn_splits(F);
  const size_t smem_ffn = (size_t)(H * FFN_XS + align4(H * FFN_W1S) + FFN_BF * FFN_XS +
                                   FFN_BF * FFN_W2S) * sizeof(float);
  if ((err = allow_smem(bert_ffn_partial_kernel, smem_ffn)) != cudaSuccess) return (int)err;
  bert_ffn_partial_kernel<<<dim3((M + FFN_BM - 1) / FFN_BM, splits), BERT_THREADS, smem_ffn,
                            stream>>>(x1, P, part, M, H, F, F / FFN_BF / splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int rows_per_block = BERT_THREADS / 32;
  bert_ffn_reduce_ln_kernel<<<(M + rows_per_block - 1) / rows_per_block, BERT_THREADS, 0,
                              stream>>>(part, splits, x1, P, out, a2, d1, T, TP, M, H, eps);
  return (int)cudaGetLastError();
}

// ===========================================================================
// Backward. Replaces bert_layer.py _fbl_bwd with the split formulation
// (_ffn_bwd_body :625-679, then _attn_bwd_body :682-763), which the merged
// and batched TPU plans (_make_merged_bwd_kernel, _make_merged_bwd_kernel_
// batched) compute the same way; like BERT_BWD_RESID=1 it consumes the
// forward's saved residuals instead of recomputing the FFN forward. With
// M = B * T rows:
//
//   FFN side:  LN2 backward over the saved a2 -> dy2, dz = dy2 * m1; the
//              FFN pre-activation U = x1 W1^T + b1 recomputed; dGU = dz W2;
//              DU = dGU * GELU'(U); dW2 = dz^T GELU(U), dW1 = DU^T x1,
//              db1 = colsum(DU); dx1 = dy2 + DU W1
//   attention: LN1 backward over the saved a1 -> dy1, da = dy1 * m0;
//              dWo = da^T ctx; dctx = da Wo; the per-head softmax rebuilt
//              from q, k and the saved log-sum-exp (the (T, T) scores are
//              never stored) -> dq, dk, dv; dWq/k/v = d{q,k,v}^T x;
//              dx = dy1 + dq Wq + dk Wk + dv Wv
//
// What bounds it on the H100: the five FFN products, ~3.8 GFLOP a layer at
// B = 4, T = 369 (84 x 3072 over 1,476 rows). They run on the tensor cores
// in 3xTF32 form (tc_gemm_kernel below), which keeps the port's float32
// products where single-pass TF32 would not. U (and, in the same pass as
// DU, GELU(U)) is materialised, 1,476 x 3072 floats a layer at B = 4, where
// the TPU kernel kept 768-column chunks in VMEM.
//
// The trap of the TPU version: it accumulated every parameter gradient over
// its sequential grid in resident output blocks. Here every sum over rows
// that spans blocks (the weight gradients, split over K; the column sums
// of the bias and LayerNorm gradients) writes per-block partials that a
// second kernel adds in a fixed order, so the gradients are bitwise the same
// from run to run; there are no float atomics.
// ===========================================================================

// C (M x N) = op(A) op(B) over K, op(A)[m][k] = ta ? A[k lda + m] : A[m lda + k],
// op(B)[k][n] = tb ? B[n ldb + k] : B[k ldb + n]. With splits > 1 block z
// covers K range [z kchunk, (z + 1) kchunk) and writes slice z of a partial
// buffer (M x N each), which reduce_partials adds up; with one split the
// epilogue adds bias[n], multiplies by GELU'(aux[m][n]) (mode 1; mode 2 also
// writes GELU(aux[m][n]) over aux[m][n]) and adds add[m][n] (aux and add
// with the stride ldc of C).
struct Gemm {
  int M, N, K;
  const float* A;
  int lda, ta;
  const float* B;
  int ldb, tb;
  float* C;
  int ldc;
  int splits, kchunk;
  const float* bias;
  const float* add;
  float* aux;
  int mode;
  int vec_a, vec_b;   // 16-byte aligned rows: 16-byte copies
};

// The epilogue of one output element (no split).
__device__ __forceinline__ float gemm_epilogue(const Gemm& g, int m, int n, float v) {
  if (g.bias) v += g.bias[n];
  if (g.mode) {
    float* u = g.aux + (size_t)m * g.ldc + n;
    const float uv = *u;
    v *= gelu_erf_grad(uv);
    if (g.mode == 2) *u = gelu_erf(uv);
  }
  if (g.add) v += g.add[(size_t)m * g.ldc + n];
  return v;
}

// ---- tensor cores: mma.sync m16n8k8 TF32 in 3xTF32 form ----------------------
//
// Each float32 operand x is split into big = tf32(x) and small = tf32(x - big)
// (cvt.rna: round to nearest, ties away, to 10 mantissa bits), and each
// product accumulates small_a big_b + big_a small_b (one f32 sum) beside
// big_a big_b (another), added at the end: the dropped small_a small_b
// term is 2^-22 of the product, so the result keeps float32 accuracy
// (ops/bert_layer.py tf32_split / matmul_3xtf32 is the plain model of this
// arithmetic). With the three terms in one accumulator the float64 error
// of the weight gradients came out 2.6-4x the float32 SIMT GEMM's; apart,
// 1.1-1.3x. The second accumulator costs registers: at 2 blocks an SM the
// compiler spills ~130 bytes a thread, which measured faster at batch 16
// than 1 block an SM without spills. Block tile 128 x 96 (the 84-wide
// products fill one column tile), 8 warps of 32 x 48, k tiles of 32 through
// a 3-stage ring of 16-byte cp.async copies (4-byte where a row is not
// 16-byte aligned); ragged M, N and K are zero-filled in shared memory.
// Each operand keeps its global majorness in shared memory, padded so that
// the fragment reads of a warp hit 32 distinct banks.
#define TG_BM 128
#define TG_BN 96
#define TG_BK 32
#define TG_STAGES 3
#define TG_THREADS 256

template <int TA, int TB>
struct TgTile {
  // A: [BM][BK + 4] (k fastest) or [BK][BM + 8] (m fastest); B: [BK][BN + 8]
  // (n fastest) or [BN][BK + 4] (k fastest)
  static constexpr int AST = TA ? TG_BM + 8 : TG_BK + 4;
  static constexpr int BST = TB ? TG_BK + 4 : TG_BN + 8;
  static constexpr int A_FLOATS = TA ? TG_BK * AST : TG_BM * AST;
  static constexpr int B_FLOATS = TB ? TG_BN * BST : TG_BK * BST;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int SMEM = TG_STAGES * STAGE * (int)sizeof(float);
};

__device__ __forceinline__ void tg_cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void tg_cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

// Copy a rows x cols tile (cols a multiple of 4) whose row r starts at
// src + r * ld, with rows_valid rows and cols_valid columns in range, into
// shared rows of `st` floats; out-of-range elements are zero-filled.
template <int ROWS, int COLS>
__device__ __forceinline__ void tg_copy(float* dst, int st, const float* src, long long ld,
                                        int rows_valid, int cols_valid, int vec) {
  for (int c = threadIdx.x; c < ROWS * COLS / 4; c += TG_THREADS) {
    const int r = c / (COLS / 4), cc = (c % (COLS / 4)) * 4;
    float* d = dst + r * st + cc;
    const float* row = src + (long long)(r < rows_valid ? r : 0) * ld;
    if (vec) {
      const int n = r < rows_valid ? min(4, max(0, cols_valid - cc)) : 0;
      tg_cp16(d, n ? row + cc : src, 4 * n);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = r < rows_valid && cc + e < cols_valid;
        tg_cp4(d + e, ok ? row + cc + e : src, ok ? 4 : 0);
      }
    }
  }
}

template <int TA, int TB>
__global__ void __launch_bounds__(TG_THREADS, 2) tc_gemm_kernel(Gemm g) {
  using Tile = TgTile<TA, TB>;
  extern __shared__ __align__(16) float tsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;              // the mma fragment's group, thread
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 48;
  const int m0 = blockIdx.y * TG_BM, n0 = blockIdx.x * TG_BN;
  const int kb = blockIdx.z * g.kchunk;
  const int ke = min(g.K, kb + g.kchunk);
  const int nk = (ke - kb + TG_BK - 1) / TG_BK;

  auto load = [&](int stage, int kt) {
    float* As = tsm + stage * Tile::STAGE;
    float* Bs = As + Tile::A_FLOATS;
    const int k0 = kb + kt * TG_BK;
    if (TA)   // BK rows of k, m fastest
      tg_copy<TG_BK, TG_BM>(As, Tile::AST, g.A + (size_t)k0 * g.lda + m0, g.lda, ke - k0,
                            g.M - m0, g.vec_a);
    else      // BM rows of m, k fastest
      tg_copy<TG_BM, TG_BK>(As, Tile::AST, g.A + (size_t)m0 * g.lda + k0, g.lda, g.M - m0,
                            ke - k0, g.vec_a);
    if (TB)   // BN rows of n, k fastest
      tg_copy<TG_BN, TG_BK>(Bs, Tile::BST, g.B + (size_t)n0 * g.ldb + k0, g.ldb, g.N - n0,
                            ke - k0, g.vec_b);
    else      // BK rows of k, n fastest
      tg_copy<TG_BK, TG_BN>(Bs, Tile::BST, g.B + (size_t)k0 * g.ldb + n0, g.ldb, ke - k0,
                            g.N - n0, g.vec_b);
  };

  // big_a big_b accumulates in acc, the two small terms in accs: the large
  // partial sums then take one product a k-step, as in a single-pass
  // product, and the small sum (~2^-11 of the large) adds its own
  // rounding at that scale
  float acc[2][6][4], accs[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = accs[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < TG_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(TG_STAGES - 2));
    __syncthreads();
    if (kt + TG_STAGES - 1 < nk) load((kt + TG_STAGES - 1) % TG_STAGES, kt + TG_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* As = tsm + (kt % TG_STAGES) * Tile::STAGE;
    const float* Bs = As + Tile::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < TG_BK; kk += 8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + gq;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // a0 (r, k), a1 (r + 8, k), a2 (r, k + 4), a3 (r + 8, k + 4)
          const int rr = r + (q & 1) * 8, k = kk + tq + (q >> 1) * 4;
          const float v = TA ? As[k * Tile::AST + rr] : As[rr * Tile::AST + k];
          tf32_split(v, ab[i][q], as[i][q]);
        }
      }
      // one column tile at a time, so that only its B fragment is live
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int n = wn + j * 8 + gq;
        uint32_t bb[2], bsm[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = kk + tq + q * 4;
          const float v = TB ? Bs[n * Tile::BST + k] : Bs[k * Tile::BST + n];
          tf32_split(v, bb[q], bsm[q]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(accs[i][j], as[i], bb[0], bb[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(accs[i][j], ab[i], bsm[0], bsm[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(acc[i][j], ab[i], bb[0], bb[1]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const bool split = g.splits > 1;
  float* C = split ? g.C + (size_t)blockIdx.z * g.M * g.N : g.C;
  const int ldc = split ? g.N : g.ldc;
  // c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1): each
  // pair of columns as one 8-byte store where C's rows allow it
  const bool pairs = ldc % 2 == 0 && (uintptr_t)C % 8 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + gq + h * 8;
        const int n = n0 + wn + j * 8 + 2 * tq;
        if (m >= g.M || n >= g.N) continue;
        float v0 = acc[i][j][2 * h] + accs[i][j][2 * h];
        float v1 = acc[i][j][2 * h + 1] + accs[i][j][2 * h + 1];
        float* dst = C + (size_t)m * ldc + n;
        if (!split) {
          v0 = gemm_epilogue(g, m, n, v0);
          if (n + 1 < g.N) v1 = gemm_epilogue(g, m, n + 1, v1);
        }
        if (pairs && n + 1 < g.N) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (n + 1 < g.N) dst[1] = v1;
        }
      }
}

// ---- the SIMT route (float32 FMAs on the CUDA cores) -------------------------
//
// The port's first GEMM, kept as the precision yardstick of the 3xTF32
// route: a test selects it (bert_layer_backward's simt argument) and holds
// the tensor-core gradients' float64 error against this one's. 64 x 64
// output tiles, 4 x 4 register tiles a thread, K in steps of 16.
#define GM_BM 64
#define GM_BN 64
#define GM_BK 16

__global__ void __launch_bounds__(256) gemm_simt_kernel(Gemm g) {
  __shared__ __align__(16) float As[GM_BK][GM_BM + 4];
  __shared__ __align__(16) float Bs[GM_BK][GM_BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;
  const int kb = blockIdx.z * g.kchunk;
  const int ke = min(g.K, kb + g.kchunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = kb; k0 < ke; k0 += GM_BK) {
    for (int i = tid; i < GM_BM * GM_BK; i += 256) {
      // the fastest index follows the operand's contiguous axis
      const int mm = g.ta ? i % GM_BM : i / GM_BK;
      const int kk = g.ta ? i / GM_BM : i % GM_BK;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < g.M && k < ke)
        v = g.ta ? g.A[(size_t)k * g.lda + m] : g.A[(size_t)m * g.lda + k];
      As[kk][mm] = v;
    }
    for (int i = tid; i < GM_BN * GM_BK; i += 256) {
      const int nn = g.tb ? i / GM_BK : i % GM_BN;
      const int kk = g.tb ? i % GM_BK : i / GM_BN;
      const int n = n0 + nn, k = k0 + kk;
      float v = 0.f;
      if (n < g.N && k < ke)
        v = g.tb ? g.B[(size_t)n * g.ldb + k] : g.B[(size_t)k * g.ldb + n];
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GM_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const bool split = g.splits > 1;
  float* C = split ? g.C + (size_t)blockIdx.z * g.M * g.N : g.C;
  const int ldc = split ? g.N : g.ldc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      C[(size_t)m * ldc + n] = split ? acc[i][j] : gemm_epilogue(g, m, n, acc[i][j]);
    }
  }
}

// K splits for an M x N x K product on tiles of bm x bn: about two waves of
// 132 SMs, at least 128 of K a split; each split's K range a multiple of 32.
static void gemm_split(int M, int N, int K, int bm, int bn, int* splits, int* kchunk) {
  const int tiles = ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  int s = (264 + tiles - 1) / tiles;
  if (s > K / 128) s = K / 128;
  if (s > 32) s = 32;
  if (s < 1) s = 1;
  *kchunk = ((K + s - 1) / s + 31) / 32 * 32;
  *splits = (K + *kchunk - 1) / *kchunk;
}

static long long gemm_part_floats(int M, int N, int K) {
  int s = 0, tc = 0, s2 = 0;
  gemm_split(M, N, K, TG_BM, TG_BN, &s, &tc);
  gemm_split(M, N, K, GM_BM, GM_BN, &s2, &tc);
  if (s2 > s) s = s2;
  return s > 1 ? (long long)s * M * N : 0;
}

// The routes of gemm(): 3xTF32 on the tensor cores (the float32 layer's),
// float32 FMAs on the CUDA cores (its precision yardstick).
enum GemmRoute { GEMM_TF32X3 = 0, GEMM_SIMT = 1 };

// One product: split over K (partials in `part`, then reduced, with `add`
// added) when that fills the card better. A split product writes a dense
// C (ldc == N) and takes no bias or GELU epilogue. route: a GemmRoute.
static cudaError_t gemm(int M, int N, int K, const float* A, int lda, int ta, const float* B,
                        int ldb, int tb, float* C, int ldc, const float* add, float* part,
                        cudaStream_t stream, int route, const float* bias = nullptr,
                        float* aux = nullptr, int mode = 0) {
  Gemm g;
  g.M = M; g.N = N; g.K = K;
  g.A = A; g.lda = lda; g.ta = ta;
  g.B = B; g.ldb = ldb; g.tb = tb;
  g.ldc = ldc; g.bias = bias; g.add = add; g.aux = aux; g.mode = mode;
  g.vec_a = lda % 4 == 0 && (uintptr_t)A % 16 == 0;
  g.vec_b = ldb % 4 == 0 && (uintptr_t)B % 16 == 0;
  const int simt = route == GEMM_SIMT;
  const int bm = simt ? GM_BM : TG_BM, bn = simt ? GM_BN : TG_BN;
  if (bias || mode || ldc != N) {
    g.splits = 1;
    g.kchunk = K;
  } else {
    gemm_split(M, N, K, bm, bn, &g.splits, &g.kchunk);
  }
  g.C = g.splits > 1 ? part : C;
  const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm, g.splits);
  cudaError_t err = cudaSuccess;
  if (simt) {
    gemm_simt_kernel<<<grid, 256, 0, stream>>>(g);
  } else {
#define TG_LAUNCH(TA, TB)                                                               \
  do {                                                                                  \
    if ((err = allow_smem(tc_gemm_kernel<TA, TB>, TgTile<TA, TB>::SMEM)) != cudaSuccess) \
      return err;                                                                       \
    tc_gemm_kernel<TA, TB><<<grid, TG_THREADS, TgTile<TA, TB>::SMEM, stream>>>(g);      \
  } while (0)
    if (ta && tb) return cudaErrorInvalidValue;   // no product of the layer takes both
    if (ta) TG_LAUNCH(1, 0);
    else if (tb) TG_LAUNCH(0, 1);
    else TG_LAUNCH(0, 0);
#undef TG_LAUNCH
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  return reduce_partials(part, g.splits, (long long)M * N, add, C, stream);
}

#define LNB_ROWS 64   // rows a block of bert_ln_bwd_kernel

// LayerNorm backward of one post-LN residual, one row per warp:
// xh = normalised pre (the saved pre-LN sum), dres = LN'(gin) (the residual
// gradient, fusion_block.py _ln_bwd) and dmask = dres times the dropout
// factor of the branch that fed the sum. Per block, the column sums
// [gin xh | gin | dmask] (the LN scale, LN shift and branch-bias
// gradients) go to part[blockIdx.x] (3 H floats), warps combined in order.
__global__ void __launch_bounds__(BERT_THREADS)
bert_ln_bwd_kernel(const float* __restrict__ gin, const float* __restrict__ pre,
                   const float* __restrict__ gamma, Dropout drop, int T, int TP,
                   float* __restrict__ dres, float* __restrict__ dmask,
                   float* __restrict__ part, int M, int H, float eps) {
  __shared__ float red[BERT_THREADS / 32][3][FFN_MAXH + 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float sgx[4] = {0.f, 0.f, 0.f, 0.f}, sg[4] = {0.f, 0.f, 0.f, 0.f},
        sdm[4] = {0.f, 0.f, 0.f, 0.f};
  const int r_end = min(M, ((int)blockIdx.x + 1) * LNB_ROWS);
  for (int row = blockIdx.x * LNB_ROWS + warp; row < r_end; row += BERT_THREADS / 32) {
    const size_t off = (size_t)row * H;
    const uint32_t rr = (uint32_t)(row / T * TP + row % T);
    float a[4], gv[4];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = lane + 32 * t;
      a[t] = o < H ? pre[off + o] : 0.f;
      gv[t] = o < H ? gin[off + o] : 0.f;
      s += a[t];
    }
    const float mu = warp_sum(s) / H;
    float ss = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (lane + 32 * t < H) {
        const float d = a[t] - mu;
        ss = fmaf(d, d, ss);
      }
    const float r = 1.f / sqrtf(warp_sum(ss) / H + eps);
    float xh[4], dxh[4], m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = lane + 32 * t;
      xh[t] = (a[t] - mu) * r;
      dxh[t] = o < H ? gv[t] * __ldg(gamma + o) : 0.f;
      m1 += dxh[t];
      m2 = fmaf(dxh[t], xh[t], m2);
    }
    m1 = warp_sum(m1) / H;
    m2 = warp_sum(m2) / H;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = lane + 32 * t;
      if (o >= H) continue;
      const float dy = r * (dxh[t] - m1 - xh[t] * m2);
      const float dm = dy * keep(drop, rr, o);
      dres[off + o] = dy;
      dmask[off + o] = dm;
      sgx[t] = fmaf(gv[t], xh[t], sgx[t]);
      sg[t] += gv[t];
      sdm[t] += dm;
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    red[warp][0][lane + 32 * t] = sgx[t];
    red[warp][1][lane + 32 * t] = sg[t];
    red[warp][2][lane + 32 * t] = sdm[t];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * H; e += BERT_THREADS) {
    const int which = e / H, o = e % H;
    float s = 0.f;
    for (int w = 0; w < BERT_THREADS / 32; ++w) s += red[w][which][o];
    part[(size_t)blockIdx.x * 3 * H + e] = s;
  }
}

// part[blockIdx.y][n] = sum of A[r][n] over the block's rows.
__global__ void __launch_bounds__(256)
colsum_partial_kernel(const float* __restrict__ A, int M, int N, int lda, int rows,
                      float* __restrict__ part) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += A[(size_t)r * lda + n];
  part[(size_t)blockIdx.y * N + n] = s;
}

#define COLSUM_ROWS 128

static cudaError_t colsum(const float* A, int M, int N, int lda, float* out, float* part,
                          cudaStream_t stream) {
  const int rb = (M + COLSUM_ROWS - 1) / COLSUM_ROWS;
  colsum_partial_kernel<<<dim3((N + 255) / 256, rb), 256, 0, stream>>>(A, M, N, lda,
                                                                       COLSUM_ROWS, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(part, rb, N, nullptr, out, stream);
}

// dq of one (subject, head, query) and D = dctx . ctx, laid out as the
// forward's attention kernel: four lanes a query, each taking every fourth
// key; p = exp(s - lse) rebuilt from the saved log-sum-exp.
template <int MAXHD>
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ ctx,
                        const float* __restrict__ dctx, const float* __restrict__ lse,
                        float* __restrict__ Dd, float* __restrict__ dq, int ldq, Dropout drop,
                        int T, int TP, int H, int hd, int t_valid, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + (size_t)t_valid * hd;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t row0 = (size_t)b * T;
  for (int i = threadIdx.x; i < t_valid * hd; i += BERT_ATTN_THREADS) {
    const int t = i / hd, d = i % hd;
    const size_t g = (row0 + t) * H + h * hd + d;
    ks[i] = k[g];
    vs[i] = v[g];
  }
  __syncthreads();
  const int part = threadIdx.x % BERT_ATTN_SPLIT;
  const int i = blockIdx.x * BERT_ATTN_QUERIES + threadIdx.x / BERT_ATTN_SPLIT;
  const bool live = i < T;
  const size_t qrow = (row0 + (live ? i : 0)) * H + h * hd;
  const size_t si = ((size_t)b * gridDim.y + h) * T + (live ? i : 0);
  float qi[MAXHD], gi[MAXHD], dqa[MAXHD];
  float Di = 0.f;
#pragma unroll
  for (int d = 0; d < MAXHD; ++d) {
    qi[d] = live && d < hd ? q[qrow + d] * scale : 0.f;
    gi[d] = live && d < hd ? dctx[qrow + d] : 0.f;
    if (live && d < hd) Di = fmaf(gi[d], ctx[qrow + d], Di);
    dqa[d] = 0.f;
  }
  const float li = live ? lse[si] : 0.f;
  const uint32_t r = (uint32_t)(b * TP + i);
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) {
        s = fmaf(qi[d], ks[j * hd + d], s);
        dp = fmaf(gi[d], vs[j * hd + d], dp);
      }
    const float p = expf(s - li);
    const float ds = p * (dp * keep(drop, r, (uint32_t)(h * TP + j)) - Di);
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) dqa[d] = fmaf(ds, ks[j * hd + d], dqa[d]);
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) dqa[d] += __shfl_xor_sync(MNT_FULL_MASK, dqa[d], off);
  if (!live || part != 0) return;
  Dd[si] = Di;
  const size_t drow = (row0 + i) * ldq + h * hd;
#pragma unroll
  for (int d = 0; d < MAXHD; ++d)
    if (d < hd) dq[drow + d] = dqa[d] * scale;
}

// dk and dv of one (subject, head, key): four lanes a key, each taking every
// fourth query; the head's scaled q, dctx, log-sum-exp and D in shared
// memory. Keys >= t_valid were masked out: their gradients are 0.
template <int MAXHD>
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dctx,
                         const float* __restrict__ lse, const float* __restrict__ Dd,
                         float* __restrict__ dk, float* __restrict__ dv, int ldo, Dropout drop,
                         int T, int TP, int H, int hd, int t_valid, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + (size_t)T * hd;
  float* ls = gs + (size_t)T * hd;
  float* Ds = ls + T;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t row0 = (size_t)b * T;
  const size_t s0 = ((size_t)b * gridDim.y + h) * T;
  for (int i = threadIdx.x; i < T * hd; i += BERT_ATTN_THREADS) {
    const int t = i / hd, d = i % hd;
    const size_t g = (row0 + t) * H + h * hd + d;
    qs[i] = q[g] * scale;
    gs[i] = dctx[g];
  }
  for (int i = threadIdx.x; i < T; i += BERT_ATTN_THREADS) {
    ls[i] = lse[s0 + i];
    Ds[i] = Dd[s0 + i];
  }
  __syncthreads();
  const int part = threadIdx.x % BERT_ATTN_SPLIT;
  const int j = blockIdx.x * BERT_ATTN_QUERIES + threadIdx.x / BERT_ATTN_SPLIT;
  const bool live = j < t_valid;
  const size_t krow = (row0 + (live ? j : 0)) * H + h * hd;
  float kj[MAXHD], vj[MAXHD], dka[MAXHD], dva[MAXHD];
#pragma unroll
  for (int d = 0; d < MAXHD; ++d) {
    kj[d] = live && d < hd ? k[krow + d] : 0.f;
    vj[d] = live && d < hd ? v[krow + d] : 0.f;
    dka[d] = dva[d] = 0.f;
  }
  if (live) {
    const uint32_t c = (uint32_t)(h * TP + j);
    for (int i = part; i < T; i += BERT_ATTN_SPLIT) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          s = fmaf(qs[i * hd + d], kj[d], s);
          dp = fmaf(gs[i * hd + d], vj[d], dp);
        }
      const float p = expf(s - ls[i]);
      const float kp = keep(drop, (uint32_t)(b * TP + i), c);
      const float ds = p * (dp * kp - Ds[i]);
      const float pk = p * kp;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          dka[d] = fmaf(ds, qs[i * hd + d], dka[d]);
          dva[d] = fmaf(pk, gs[i * hd + d], dva[d]);
        }
    }
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) {
      dka[d] += __shfl_xor_sync(MNT_FULL_MASK, dka[d], off);
      dva[d] += __shfl_xor_sync(MNT_FULL_MASK, dva[d], off);
    }
  if (j >= T || part != 0) return;
  const size_t drow = (row0 + j) * ldo + h * hd;
#pragma unroll
  for (int d = 0; d < MAXHD; ++d)
    if (d < hd) {
      dk[drow + d] = dka[d];
      dv[drow + d] = dva[d];
    }
}

// bert_attn_bwd_dq_kernel for any hd (the wide kernels' layout, see
// bert_attention_wide_kernel): the block's 32 scaled q and dctx rows in
// shared memory, K and V streamed a tile at a time, dq a chunk of 32 dims a
// pass. Shared memory (2 x 32 + 2 BERT_WIDE_KT) hd floats.
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attn_bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ ctx,
                             const float* __restrict__ dctx, const float* __restrict__ lse,
                             float* __restrict__ Dd, float* __restrict__ dq, int ldq,
                             Dropout drop, int T, int TP, int H, int hd, int t_valid,
                             float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + BERT_ATTN_QUERIES * hd;
  float* ks = gs + BERT_ATTN_QUERIES * hd;
  float* vs = ks + BERT_WIDE_KT * hd;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BERT_ATTN_QUERIES;
  const size_t row0 = (size_t)b * T;
  bert_wide_tile(qs, q, row0, i0, T, H, h * hd, hd, scale);
  bert_wide_tile(gs, dctx, row0, i0, T, H, h * hd, hd, 1.f);
  const int part = threadIdx.x % BERT_ATTN_SPLIT, qi = threadIdx.x / BERT_ATTN_SPLIT;
  const int i = i0 + qi;
  const bool live = i < T;
  const size_t si = ((size_t)b * gridDim.y + h) * T + (live ? i : 0);
  const float* qr = qs + qi * hd;
  const float* gr = gs + qi * hd;
  __syncthreads();
  float Di = 0.f;
  if (live) {
    const float* cr = ctx + (row0 + i) * H + h * hd;
    for (int d = 0; d < hd; ++d) Di = fmaf(gr[d], cr[d], Di);
  }
  const float li = live ? lse[si] : 0.f;
  const uint32_t r = (uint32_t)(b * TP + i);
  for (int c0 = 0; c0 < hd; c0 += BERT_WIDE_CH) {
    float dqa[BERT_WIDE_CH];
#pragma unroll
    for (int d = 0; d < BERT_WIDE_CH; ++d) dqa[d] = 0.f;
    for (int j0 = 0; j0 < t_valid; j0 += BERT_WIDE_KT) {
      __syncthreads();
      bert_wide_tile(ks, k, row0, j0, t_valid, H, h * hd, hd, 1.f);
      bert_wide_tile(vs, v, row0, j0, t_valid, H, h * hd, hd, 1.f);
      __syncthreads();
      for (int jl = part; jl < BERT_WIDE_KT && j0 + jl < t_valid; jl += BERT_ATTN_SPLIT) {
        const float* kj = ks + jl * hd;
        const float p = expf(bert_wide_dot(qr, kj, hd) - li);
        const float dp = bert_wide_dot(gr, vs + jl * hd, hd);
        const float ds = p * (dp * keep(drop, r, (uint32_t)(h * TP + j0 + jl)) - Di);
#pragma unroll
        for (int d = 0; d < BERT_WIDE_CH; ++d)
          if (c0 + d < hd) dqa[d] = fmaf(ds, kj[c0 + d], dqa[d]);
      }
    }
#pragma unroll
    for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
#pragma unroll
      for (int d = 0; d < BERT_WIDE_CH; ++d) dqa[d] += __shfl_xor_sync(MNT_FULL_MASK, dqa[d], off);
    if (live && part == 0) {
      const size_t drow = (row0 + i) * ldq + h * hd + c0;
#pragma unroll
      for (int d = 0; d < BERT_WIDE_CH; ++d)
        if (c0 + d < hd) dq[drow + d] = dqa[d] * scale;
    }
  }
  if (live && part == 0) Dd[si] = Di;
}

// bert_attn_bwd_dkv_kernel for any hd: the block's 32 k and v rows in shared
// memory, the scaled q, dctx, log-sum-exp and D streamed a tile of queries
// at a time, dk and dv a chunk of 32 dims a pass. Shared memory (2 x 32 +
// 2 BERT_WIDE_KT) hd + 2 BERT_WIDE_KT floats.
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attn_bwd_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dctx,
                              const float* __restrict__ lse, const float* __restrict__ Dd,
                              float* __restrict__ dk, float* __restrict__ dv, int ldo,
                              Dropout drop, int T, int TP, int H, int hd, int t_valid,
                              float scale) {
  extern __shared__ float smem[];
  float* kS = smem;
  float* vS = kS + BERT_ATTN_QUERIES * hd;
  float* qs = vS + BERT_ATTN_QUERIES * hd;
  float* gs = qs + BERT_WIDE_KT * hd;
  float* ls = gs + BERT_WIDE_KT * hd;
  float* Ds = ls + BERT_WIDE_KT;
  const int b = blockIdx.z, h = blockIdx.y, j0b = blockIdx.x * BERT_ATTN_QUERIES;
  const size_t row0 = (size_t)b * T;
  const size_t s0 = ((size_t)b * gridDim.y + h) * T;
  bert_wide_tile(kS, k, row0, j0b, t_valid, H, h * hd, hd, 1.f);
  bert_wide_tile(vS, v, row0, j0b, t_valid, H, h * hd, hd, 1.f);
  const int part = threadIdx.x % BERT_ATTN_SPLIT, kj = threadIdx.x / BERT_ATTN_SPLIT;
  const int j = j0b + kj;
  const bool live = j < t_valid;
  const float* kr = kS + kj * hd;
  const float* vr = vS + kj * hd;
  const uint32_t c = (uint32_t)(h * TP + j);
  for (int c0 = 0; c0 < hd; c0 += BERT_WIDE_CH) {
    float dka[BERT_WIDE_CH], dva[BERT_WIDE_CH];
#pragma unroll
    for (int d = 0; d < BERT_WIDE_CH; ++d) dka[d] = dva[d] = 0.f;
    for (int i0 = 0; i0 < T; i0 += BERT_WIDE_KT) {
      __syncthreads();
      bert_wide_tile(qs, q, row0, i0, T, H, h * hd, hd, scale);
      bert_wide_tile(gs, dctx, row0, i0, T, H, h * hd, hd, 1.f);
      if (threadIdx.x < BERT_WIDE_KT) {
        const int i = i0 + threadIdx.x;
        ls[threadIdx.x] = i < T ? lse[s0 + i] : 0.f;
        Ds[threadIdx.x] = i < T ? Dd[s0 + i] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      for (int il = part; il < BERT_WIDE_KT && i0 + il < T; il += BERT_ATTN_SPLIT) {
        const float* qi = qs + il * hd;
        const float* gi = gs + il * hd;
        const float p = expf(bert_wide_dot(qi, kr, hd) - ls[il]);
        const float dp = bert_wide_dot(gi, vr, hd);
        const float kp = keep(drop, (uint32_t)(b * TP + i0 + il), c);
        const float ds = p * (dp * kp - Ds[il]);
        const float pk = p * kp;
#pragma unroll
        for (int d = 0; d < BERT_WIDE_CH; ++d)
          if (c0 + d < hd) {
            dka[d] = fmaf(ds, qi[c0 + d], dka[d]);
            dva[d] = fmaf(pk, gi[c0 + d], dva[d]);
          }
      }
    }
#pragma unroll
    for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
#pragma unroll
      for (int d = 0; d < BERT_WIDE_CH; ++d) {
        dka[d] += __shfl_xor_sync(MNT_FULL_MASK, dka[d], off);
        dva[d] += __shfl_xor_sync(MNT_FULL_MASK, dva[d], off);
      }
    if (j < T && part == 0) {
      const size_t drow = (row0 + j) * ldo + h * hd + c0;
#pragma unroll
      for (int d = 0; d < BERT_WIDE_CH; ++d)
        if (c0 + d < hd) {
          dk[drow + d] = dka[d];
          dv[drow + d] = dva[d];
        }
    }
  }
}

// Scratch layout of bert_layer_backward (floats).
struct BertBwdScratch {
  long long U, DU, dy2, dz, dx1, dy1, da, dctx, dqkv, Dd, lnp, ln3, colp, gp, total;

  BertBwdScratch(int B, int T, int H, int F, int heads) {
    const long long M = (long long)B * T, MH = M * H, MF = M * F;
    const long long ln_blocks = (M + LNB_ROWS - 1) / LNB_ROWS;
    const long long col_blocks = (M + COLSUM_ROWS - 1) / COLSUM_ROWS;
    long long gpart = 0;
    const long long shapes[4][3] = {{H, F, M}, {F, H, M}, {M, H, F}, {H, H, M}};
    for (const auto& s : shapes) {
      const long long f = gemm_part_floats((int)s[0], (int)s[1], (int)s[2]);
      if (f > gpart) gpart = f;
    }
    long long off = 0;
    U = off; off += MF;
    DU = off; off += MF;
    dy2 = off; off += MH;
    dz = off; off += MH;
    dx1 = off; off += MH;
    dy1 = off; off += MH;
    da = off; off += MH;
    dctx = off; off += MH;
    dqkv = off; off += 3 * MH;
    Dd = off; off += (long long)B * heads * T;
    lnp = off; off += ln_blocks * 3 * H;
    ln3 = off; off += 3 * H;
    colp = off; off += col_blocks * F;
    gp = off; off += gpart;
    total = off;
  }
};

extern "C" long long bert_layer_backward_scratch_floats(int B, int T, int H, int F, int heads) {
  return BertBwdScratch(B, T, H, F, heads).total;
}

// LN backward + its three column-sum gradients (scale -> dgamma, shift ->
// dbeta, dropped branch -> dbias).
static cudaError_t ln_backward(const float* gin, const float* pre, const float* gamma,
                               const Dropout& drop, int T, int TP, float* dres, float* dmask,
                               float* lnp, float* ln3, float* dgamma, float* dbeta,
                               float* dbias, int M, int H, cudaStream_t stream) {
  const int blocks = (M + LNB_ROWS - 1) / LNB_ROWS;
  bert_ln_bwd_kernel<<<blocks, BERT_THREADS, 0, stream>>>(gin, pre, gamma, drop, T, TP, dres,
                                                          dmask, lnp, M, H, 1e-12f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = reduce_partials(lnp, blocks, 3 * H, nullptr, ln3, stream)) != cudaSuccess)
    return err;
  const size_t bytes = (size_t)H * sizeof(float);
  if ((err = cudaMemcpyAsync(dgamma, ln3, bytes, cudaMemcpyDeviceToDevice, stream)) !=
      cudaSuccess)
    return err;
  if ((err = cudaMemcpyAsync(dbeta, ln3 + H, bytes, cudaMemcpyDeviceToDevice, stream)) !=
      cudaSuccess)
    return err;
  return cudaMemcpyAsync(dbias, ln3 + 2 * H, bytes, cudaMemcpyDeviceToDevice, stream);
}

#define CK(call)                                      \
  do {                                                \
    cudaError_t e_ = (call);                          \
    if (e_ != cudaSuccess) return (int)e_;            \
  } while (0)

// x: the layer input (B, T, H); resid: what bert_layer_forward saved with the
// same seed and rates; g = dL/dout (B, T, H). params as in the forward;
// grads: host array of 16 device pointers, in the same order and shapes,
// which receive the parameter gradients (written, not accumulated). dx
// (B, T, H) receives dL/dx. scratch: bert_layer_backward_scratch_floats()
// floats. simt: run the products on the float32 SIMT GEMM (the precision
// yardstick) instead of 3xTF32 on the tensor cores. Returns the cudaError_t
// of the first launch that fails.
extern "C" int bert_layer_backward(const float* x, const float* resid, const float* g,
                                   const void* const* params, void* const* grads, float* dx,
                                   float* scratch, int B, int T, int H, int F, int heads,
                                   int t_valid, int TP, int seed, double attn_rate,
                                   double hidden_rate, int simt, cudaStream_t stream) {
  const int route = simt ? GEMM_SIMT : GEMM_TF32X3;
  if (bert_bad_dims(T, H, F, heads, t_valid, TP)) return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(params);
  float* const* dp = reinterpret_cast<float* const*>(grads);
  const float *wq = p[0], *wk = p[2], *wv = p[4], *wo = p[6], *g1 = p[8];
  const float *w1 = p[10], *b1m = p[11], *w2 = p[12], *g2 = p[14];
  const int M = B * T;
  const size_t MH = (size_t)M * H;
  const float *q = resid, *k = q + MH, *v = k + MH, *ctx = v + MH, *a1 = ctx + MH;
  const float *x1 = a1 + MH, *a2 = x1 + MH, *lse = a2 + MH;
  const BertBwdScratch L(B, T, H, F, heads);
  float *U = scratch + L.U, *DU = scratch + L.DU, *dy2 = scratch + L.dy2;
  float *dz = scratch + L.dz, *dx1 = scratch + L.dx1, *dy1 = scratch + L.dy1;
  float *da = scratch + L.da, *dctx = scratch + L.dctx, *dqkv = scratch + L.dqkv;
  float *Dd = scratch + L.Dd, *lnp = scratch + L.lnp, *ln3 = scratch + L.ln3;
  float *colp = scratch + L.colp, *gp = scratch + L.gp;
  const Dropout d_attn = make_dropout(seed, 3, attn_rate);
  const Dropout d0 = make_dropout(seed, 0, hidden_rate);
  const Dropout d1 = make_dropout(seed, 1, hidden_rate);
  const int hd = H / heads;
  const float scale = 1.f / sqrtf((float)hd);

  // ---- FFN side ----------------------------------------------------------
  CK(ln_backward(g, a2, g2, d1, T, TP, dy2, dz, lnp, ln3, dp[14], dp[15], dp[13], M, H,
                 stream));
  // U = x1 W1^T + b1 (M x F)
  CK(gemm(M, F, H, x1, H, 0, w1, H, 1, U, F, nullptr, gp, stream, route, b1m));
  // DU = (dz W2) * GELU'(U), and U -> GELU(U) in the same epilogue
  CK(gemm(M, F, H, dz, H, 0, w2, F, 0, DU, F, nullptr, gp, stream, route, nullptr, U, 2));
  CK(gemm(H, F, M, dz, H, 1, U, F, 0, dp[12], F, nullptr, gp, stream, route));  // dW2 = dz^T GELU(U)
  CK(gemm(F, H, M, DU, F, 1, x1, H, 0, dp[10], H, nullptr, gp, stream, route)); // dW1 = DU^T x1
  CK(colsum(DU, M, F, F, dp[11], colp, stream));                               // db1
  CK(gemm(M, H, F, DU, F, 0, w1, H, 0, dx1, H, dy2, gp, stream, route));        // dx1 = dy2 + DU W1

  // ---- attention side ------------------------------------------------------
  CK(ln_backward(dx1, a1, g1, d0, T, TP, dy1, da, lnp, ln3, dp[8], dp[9], dp[7], M, H, stream));
  CK(gemm(H, H, M, da, H, 1, ctx, H, 0, dp[6], H, nullptr, gp, stream, route));  // dWo = da^T ctx
  CK(gemm(M, H, H, da, H, 0, wo, H, 0, dctx, H, nullptr, gp, stream, route));    // dctx = da Wo
  const dim3 grid((T + BERT_ATTN_QUERIES - 1) / BERT_ATTN_QUERIES, heads, B);
  const size_t smem_dq = 2 * (size_t)t_valid * hd * sizeof(float);
  const size_t smem_dkv = (2 * (size_t)T * hd + 2 * (size_t)T) * sizeof(float);
  if (hd > BERT_MAXHD) {
    const size_t smem_w = (2 * BERT_ATTN_QUERIES + 2 * BERT_WIDE_KT) * (size_t)hd * sizeof(float);
    CK(allow_smem(bert_attn_bwd_dq_wide_kernel, smem_w));
    bert_attn_bwd_dq_wide_kernel<<<grid, BERT_ATTN_THREADS, smem_w, stream>>>(
        q, k, v, ctx, dctx, lse, Dd, dqkv, 3 * H, d_attn, T, TP, H, hd, t_valid, scale);
    CK(cudaGetLastError());
    const size_t smem_wkv = smem_w + 2 * BERT_WIDE_KT * sizeof(float);
    CK(allow_smem(bert_attn_bwd_dkv_wide_kernel, smem_wkv));
    bert_attn_bwd_dkv_wide_kernel<<<grid, BERT_ATTN_THREADS, smem_wkv, stream>>>(
        q, k, v, dctx, lse, Dd, dqkv + H, dqkv + 2 * H, 3 * H, d_attn, T, TP, H, hd, t_valid,
        scale);
  } else if (hd <= 8) {
    CK(allow_smem(bert_attn_bwd_dq_kernel<8>, smem_dq));
    bert_attn_bwd_dq_kernel<8><<<grid, BERT_ATTN_THREADS, smem_dq, stream>>>(
        q, k, v, ctx, dctx, lse, Dd, dqkv, 3 * H, d_attn, T, TP, H, hd, t_valid, scale);
    CK(cudaGetLastError());
    CK(allow_smem(bert_attn_bwd_dkv_kernel<8>, smem_dkv));
    bert_attn_bwd_dkv_kernel<8><<<grid, BERT_ATTN_THREADS, smem_dkv, stream>>>(
        q, k, v, dctx, lse, Dd, dqkv + H, dqkv + 2 * H, 3 * H, d_attn, T, TP, H, hd, t_valid,
        scale);
  } else {
    CK(allow_smem(bert_attn_bwd_dq_kernel<16>, smem_dq));
    bert_attn_bwd_dq_kernel<16><<<grid, BERT_ATTN_THREADS, smem_dq, stream>>>(
        q, k, v, ctx, dctx, lse, Dd, dqkv, 3 * H, d_attn, T, TP, H, hd, t_valid, scale);
    CK(cudaGetLastError());
    CK(allow_smem(bert_attn_bwd_dkv_kernel<16>, smem_dkv));
    bert_attn_bwd_dkv_kernel<16><<<grid, BERT_ATTN_THREADS, smem_dkv, stream>>>(
        q, k, v, dctx, lse, Dd, dqkv + H, dqkv + 2 * H, 3 * H, d_attn, T, TP, H, hd, t_valid,
        scale);
  }
  CK(cudaGetLastError());
  const float* wqkv[3] = {wq, wk, wv};
  for (int j = 0; j < 3; ++j) {
    const float* dj = dqkv + j * H;
    // dW = d^T x
    CK(gemm(H, H, M, dj, 3 * H, 1, x, H, 0, dp[2 * j], H, nullptr, gp, stream, route));
    CK(colsum(dj, M, H, 3 * H, dp[2 * j + 1], colp, stream));                     // db
    // dx = dy1 + dq Wq + dk Wk + dv Wv, one product at a time
    CK(gemm(M, H, H, dj, 3 * H, 0, wqkv[j], H, 0, dx, H, j == 0 ? dy1 : dx, gp, stream,
            route));
  }
  return (int)cudaSuccess;
}

// ===========================================================================
// The mm16 form: the layer under the bf16 policy (JAX nn/bert.py keeps the
// residual stream float32 and forces mm16 on the layer; _fbl_fwd / _fbl_bwd
// with mm16=True). Every product rounds its two operands to bf16 and
// accumulates in float32, at the points where JAX's _mm(True) rounds them:
// x, ctx, x1 and GELU(u) against the bf16 weights; q * scale (not q) and k
// in the scores; the dropped probabilities and v in the context. The
// softmax is JAX's packed one: no max subtraction, logits capped at 80,
// e = exp(min(s, 80)), the denominator a float32 sum of bf16(e) and
// p = e * bf16(1 / den) (_seg_softmax with mm16). Residual stream, both
// LayerNorms and the saved residuals stay float32; the saved log-sum-exp's
// slot holds bf16(1 / den) instead.
//
// Every product, the head-dim-7 scores and contexts included, runs on bf16
// mma.sync.m16n8k16 with float32 sums: both operands of each are bf16
// values, so each product of two is exact and only the order of the float32
// sums differs from JAX's. A warp owns 16 rows of every tile as A
// fragments; a C fragment that feeds the next product (GELU(u), the dropped
// probabilities, ds, DU) is rounded and repacked in registers as that
// product's A fragment (GELU(U) and DU are also stored, as bf16, for the
// backward's weight gradients; nothing else of the FFN's width is).
//
// What bounds it on the H100: not the products (a batch-16 layer's ~10
// GFLOP take ~10 us at the bf16 tensor rate) but the float32 work on the
// fragments: GELU and GELU' of every (row, F) element, an exponential (and
// at dropout the hash) of every score, on the CUDA cores, around short
// chains of dependent mma.sync; and the bytes of the FFN's (M, F)
// intermediates. The forward keeps GELU(u)
// in registers (as the TPU kernel keeps its F-chunks in VMEM,
// multimodal_neuroimage_tpu/ops/bert_layer.py _ffn_chunk); the backward
// recomputes U a chunk at a time and stores GELU(U) and DU only as bf16,
// the values JAX's mm16 products round them to (_ffn_bwd_body).
//
// Layout: hidden rows are padded to K16_KP = 96 columns for the k16 steps
// (H <= 96), F runs in chunks of K16_FC = 32 columns, and the F chunks of
// one launch split into `slices` blocks a row tile, whose float32 partial
// sums a row kernel adds up in a fixed order. Every sum across blocks is a
// per-block partial added in a fixed order (k16_reduce_kernel): the
// gradients are bitwise the same from run to run, with no float atomics.
// ===========================================================================

#define BERT_LOGIT_CAP 80.f
#define K16_LOG2E 1.4426950408889634f
#define K16_KP 96                   // padded hidden width: k16 steps of H <= 96
#define K16_KS (K16_KP / 16)        // its k16 steps
#define K16_NB (K16_KP / 8)         // its n8 blocks
#define K16_LD (K16_KP + 8)         // bf16 pitch of a 96-wide shared row (208 B)
#define K16_FC 32                   // F columns a chunk
#define K16_FLD (K16_FC + 8)        // bf16 pitch of a chunk-wide shared row (80 B)
#define K16_WARPS 4
#define K16_ROWS (16 * K16_WARPS)   // rows a block of the row kernels
#define K16_THREADS (32 * K16_WARPS)
#define K16_AT 64                   // keys (or queries) an attention tile
#define K16_MAXSLICE 16
#define K16_FWD_PER_SM 4            // resident blocks an SM of the FFN kernels
#define K16_BWD_PER_SM 3            // (their __launch_bounds__)
#define K16_LN_ROWS 16              // rows a block of the LN backward (two a warp)
#define K16_K3KS 18                 // k16 steps of the merged dx product: 3H <= 288
#define K16_K3P (16 * K16_K3KS)     // dq | dk | dv rows, zero-padded
#define K16_TN_BI 128               // dW products: output rows (i) a block
#define K16_TN_BJ 96                // output columns (j) a block (H <= 96)
#define K16_TN_BK 32                // rows of m a stage
#define K16_TN_STAGES 3
#define K16_TN_THREADS 256

typedef unsigned short bf16_t;   // bf16 bits in shared memory and buffers

__device__ __forceinline__ uint32_t k16_pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ bf16_t k16_bits(float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  return *reinterpret_cast<const bf16_t*>(&h);
}

// 16-byte cp.async; ok == false zero-fills the 16 bytes (src must stay a
// valid address).
__device__ __forceinline__ void k16_cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tc_smem(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void k16_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void k16_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The A fragments of rows [r0, r0 + 16) x columns [0, 16 KS) of a float32
// row-major matrix (ld floats a row), rounded to bf16; zero past M rows and
// past `cols` columns (tc_mma's fragment layout).
template <int KS>
__device__ __forceinline__ void k16_frag32(uint32_t (&a)[KS][4], const float* __restrict__ src,
                                           int ld, int r0, int M, int cols, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), c = 16 * kk + 8 * (e >> 1) + 2 * t;
      float v0 = 0.f, v1 = 0.f;
      if (r < M) {
        const float* p = src + (size_t)r * ld + c;
        if (c < cols) v0 = p[0];
        if (c + 1 < cols) v1 = p[1];
      }
      a[kk][e] = k16_pack(v0, v1);
    }
}

// The same from a bf16 row-major matrix whose rows hold at least 16 KS
// (zero-padded) columns: one 4-byte load a register.
template <int KS>
__device__ __forceinline__ void k16_frag16(uint32_t (&a)[KS][4], const bf16_t* __restrict__ src,
                                           int ld, int r0, int M, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), c = 16 * kk + 8 * (e >> 1) + 2 * t;
      a[kk][e] = r < M ? *reinterpret_cast<const uint32_t*>(src + (size_t)r * ld + c) : 0u;
    }
}

// c[nb] += a x^T over a shared tile x whose rows are the n index (n8 block
// nb: rows 8 nb .. 8 nb + 7) and whose columns are the k index (k16 step
// kk: columns 16 kk ..): ldmatrix of [n][k] storage.
template <int NB>
__device__ __forceinline__ void k16_mma_nk(float (&c)[NB][4], const uint32_t (&a)[4],
                                           const bf16_t* x, int ld, int kk, int lane) {
#pragma unroll
  for (int p = 0; p < NB / 2; ++p) {
    uint32_t b[4];
    tc_ldsm(b, x + (16 * p + 8 * (lane >> 4) + (lane & 7)) * ld + 16 * kk +
                   8 * ((lane >> 3) & 1));
    tc_mma(c[2 * p], a, b[0], b[1]);
    tc_mma(c[2 * p + 1], a, b[2], b[3]);
  }
}

// The same over a tile whose rows are the k index (k16 step kk: rows 16 kk
// ..) and whose columns are the n index: ldmatrix.trans of [k][n] storage.
template <int NB>
__device__ __forceinline__ void k16_mma_kn(float (&c)[NB][4], const uint32_t (&a)[4],
                                           const bf16_t* x, int ld, int kk, int lane) {
#pragma unroll
  for (int p = 0; p < NB / 2; ++p) {
    uint32_t b[4];
    tc_ldsm_t(b, x + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * ld + 16 * p +
                     8 * (lane >> 4));
    tc_mma(c[2 * p], a, b[0], b[1]);
    tc_mma(c[2 * p + 1], a, b[2], b[3]);
  }
}

// The C fragments of n8 blocks 2p and 2p + 1 (x[e]: row g + 8 (e >> 1),
// column 2t + (e & 1)) rounded to bf16 and repacked as the A fragment of a
// product whose k index is those 16 columns.
__device__ __forceinline__ void k16_c2a(uint32_t (&a)[4], const float (&c0)[4],
                                        const float (&c1)[4]) {
  a[0] = k16_pack(c0[0], c0[1]);
  a[1] = k16_pack(c0[2], c0[3]);
  a[2] = k16_pack(c1[0], c1[1]);
  a[3] = k16_pack(c1[2], c1[3]);
}

// ---- the weights as bf16 -------------------------------------------------------
//
// Each launch rounds the weights its products read into bf16 matrices of
// `rows` x `ld` (zero past `cols`), once a call: element (r, c) = w[0][r cols
// + c], or with trans w[c / rows][(c % rows) rows + r] (rows x rows weights
// stacked along c, transposed: Wo^T, [Wq; Wk; Wv]^T). The FFN kernels and the
// hidden-width products then stage them with 16-byte cp.async.
struct K16WJob {
  const float* w[3];
  bf16_t* dst;
  int rows, cols, ld, trans;
};

#define K16_MAXW 6

struct K16Weights {
  K16WJob job[K16_MAXW];
};

__global__ void __launch_bounds__(256) k16_weights_kernel(K16Weights W) {
  const K16WJob& J = W.job[blockIdx.y];
  const int n = J.rows * J.ld;
  for (int e = blockIdx.x * 256 + threadIdx.x; e < n; e += gridDim.x * 256) {
    const int r = e / J.ld, c = e % J.ld;
    float v = 0.f;
    if (c < J.cols)
      v = J.trans ? J.w[c / J.rows][(size_t)(c % J.rows) * J.rows + r]
                  : J.w[0][(size_t)r * J.cols + c];
    J.dst[e] = k16_bits(v);
  }
}

// Launch the jobs (at most K16_MAXW), one grid row each.
static cudaError_t k16_weights(const K16Weights& W, int njobs, cudaStream_t stream) {
  k16_weights_kernel<<<dim3(256, njobs), 256, 0, stream>>>(W);
  return cudaGetLastError();
}

// The FFN kernels stream the weights a chunk at a time through a ring of
// K16_FSTAGES stages (each a W1 chunk, then a W2 chunk), two chunks in
// flight while one multiplies: a chunk's products are short, and the L2
// latency of its copies would stall a shallower ring.
#define K16_FSTAGES 3
#define K16_W1ST (K16_FC * K16_LD)                 // bf16 of a stage's W1 chunk
#define K16_WSTAGE (K16_W1ST + K16_KP * K16_FLD)   // bf16 of a stage

// One chunk of the FFN weights into ring stage w: w1s [K16_FC][K16_LD] (rows
// f0 .. of w1b, (j, h)) and w2s [K16_KP][K16_FLD] (columns f0 .. of w2b,
// (h, j); rows >= H stay as zeroed once).
__device__ __forceinline__ void k16_stage_chunk(bf16_t* w, const bf16_t* __restrict__ w1b,
                                                const bf16_t* __restrict__ w2b, int f0, int H,
                                                int F) {
  bf16_t *w1s = w, *w2s = w + K16_W1ST;
  for (int i = threadIdx.x; i < K16_FC * (K16_KP / 8); i += K16_THREADS) {
    const int j = i / (K16_KP / 8), c = (i % (K16_KP / 8)) * 8;
    k16_cp16(w1s + j * K16_LD + c, w1b + (size_t)(f0 + j) * K16_KP + c, true);
  }
  for (int i = threadIdx.x; i < H * (K16_FC / 8); i += K16_THREADS) {
    const int h = i / (K16_FC / 8), c = (i % (K16_FC / 8)) * 8;
    k16_cp16(w2s + h * K16_FLD + c, w2b + (size_t)h * F + f0 + c, true);
  }
}

// Zero the W2 rows >= H of every ring stage, then start the ring: chunks
// 0 .. K16_FSTAGES - 2 of the slice from f0, a commit group each.
__device__ __forceinline__ void k16_ring_start(bf16_t* ring, const bf16_t* __restrict__ w1b,
                                               const bf16_t* __restrict__ w2b, int f0, int H,
                                               int F, int chunks) {
  for (int st = 0; st < K16_FSTAGES; ++st)
    for (int i = threadIdx.x; i < (K16_KP - H) * K16_FLD; i += K16_THREADS)
      ring[st * K16_WSTAGE + K16_W1ST + H * K16_FLD + i] = 0;
  for (int st = 0; st < K16_FSTAGES - 1; ++st) {
    if (st < chunks) k16_stage_chunk(ring + st * K16_WSTAGE, w1b, w2b, f0 + st * K16_FC, H, F);
    k16_commit();
  }
}

// Chunk c's stage is in (every thread's copies waited for, then the block
// synchronised, so that chunk c - 1's stage is free): start chunk c +
// K16_FSTAGES - 1's copies into it; returns chunk c's stage.
__device__ __forceinline__ const bf16_t* k16_ring_next(bf16_t* ring,
                                                       const bf16_t* __restrict__ w1b,
                                                       const bf16_t* __restrict__ w2b, int fbase,
                                                       int c, int H, int F, int chunks) {
  k16_wait<K16_FSTAGES - 2>();
  __syncthreads();
  const int nc = c + K16_FSTAGES - 1;
  if (nc < chunks)
    k16_stage_chunk(ring + (nc % K16_FSTAGES) * K16_WSTAGE, w1b, w2b, fbase + nc * K16_FC, H, F);
  k16_commit();
  return ring + (c % K16_FSTAGES) * K16_WSTAGE;
}

// The block's K16_ROWS rows of a float32 (M, H) matrix, rounded to bf16, into
// a [K16_ROWS][K16_LD] shared tile (zero past M and past H).
__device__ __forceinline__ void k16_rows_tile(bf16_t* tile, const float* __restrict__ src,
                                              int r0, int M, int H) {
  for (int i = threadIdx.x; i < K16_ROWS * K16_KP; i += K16_THREADS) {
    const int r = i / K16_KP, c = i % K16_KP;
    tile[r * K16_LD + c] = k16_bits(r0 + r < M && c < H ? src[(size_t)(r0 + r) * H + c] : 0.f);
  }
}

// The A fragment (rows r .. r + 15, k16 step kk) of a [rows][ld] bf16 shared
// tile: ldmatrix of [m][k] storage.
__device__ __forceinline__ void k16_lda(uint32_t (&a)[4], const bf16_t* tile, int ld, int r,
                                        int kk, int lane) {
  tc_ldsm(a, tile + (r + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 16 * kk + 8 * (lane >> 4));
}

// ---- FFN forward -----------------------------------------------------------------
//
// grid (ceil(M / K16_ROWS), slices), K16_THREADS threads. Per chunk of K16_FC
// columns: U = x1 W1c^T (+ b1) on mma, GELU on the fragments, rounded to bf16
// and repacked in registers as the A fragment of z += GELU(U) W2c^T. The
// slice's partial z (M, H) goes to zp[slice]; bert_bias_res_ln_kernel adds
// the slices. GELU(u) never leaves the registers. x1's tile sits in shared
// memory as bf16 (its fragments read by ldmatrix a chunk), which keeps the
// registers at four blocks an SM. K16_FFN_FWD_SMEM bytes of dynamic shared
// memory.
#define K16_FFN_FWD_SMEM ((K16_FSTAGES * K16_WSTAGE + K16_ROWS * K16_LD) * 2)

__global__ void __launch_bounds__(K16_THREADS, K16_FWD_PER_SM)
k16_ffn_fwd_kernel(const float* __restrict__ x1, const bf16_t* __restrict__ w1b,
                   const bf16_t* __restrict__ w2b, const float* __restrict__ b1m,
                   float* __restrict__ zp, int M, int H, int F, int chunks) {
  extern __shared__ __align__(16) bf16_t k16s[];
  bf16_t* ring = k16s;
  bf16_t* xs = ring + K16_FSTAGES * K16_WSTAGE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rb = blockIdx.x * K16_ROWS, r0 = rb + warp * 16;
  const int fbase = blockIdx.y * chunks * K16_FC;
  k16_ring_start(ring, w1b, w2b, fbase, H, F, chunks);
  k16_rows_tile(xs, x1, rb, M, H);
  float z[K16_NB][4];
#pragma unroll
  for (int nb = 0; nb < K16_NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[nb][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int f0 = fbase + c * K16_FC;
    const bf16_t* w1s = k16_ring_next(ring, w1b, w2b, fbase, c, H, F, chunks);
    const bf16_t* w2s = w1s + K16_W1ST;
    float u[K16_FC / 8][4];
#pragma unroll
    for (int nb = 0; nb < K16_FC / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K16_KS; ++kk) {
      uint32_t xa[4];
      k16_lda(xa, xs, K16_LD, warp * 16, kk, lane);
      k16_mma_nk<K16_FC / 8>(u, xa, w1s, K16_LD, kk, lane);
    }
#pragma unroll
    for (int nb = 0; nb < K16_FC / 8; ++nb) {
      const float bb0 = __ldg(b1m + f0 + 8 * nb + 2 * t), bb1 = __ldg(b1m + f0 + 8 * nb + 2 * t + 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) u[nb][e] = gelu_erf(u[nb][e] + (e & 1 ? bb1 : bb0));
    }
#pragma unroll
    for (int p = 0; p < K16_FC / 16; ++p) {
      uint32_t ga[4];
      k16_c2a(ga, u[2 * p], u[2 * p + 1]);
      // z += GELU(U)_p W2c^T: w2s holds (n = h, k = j)
      k16_mma_nk<K16_NB>(z, ga, w2s, K16_FLD, p, lane);
    }
  }
  float* dst = zp + (size_t)blockIdx.y * M * H;
#pragma unroll
  for (int nb = 0; nb < K16_NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), o = 8 * nb + 2 * t + (e & 1);
      if (r < M && o < H) dst[(size_t)r * H + o] = z[nb][e];
    }
}

// GELU(u) and GELU'(u) from one erf, in gelu_erf's and gelu_erf_grad's
// arithmetic.
__device__ __forceinline__ void k16_gelu2(float u, float& gv, float& dv) {
  const float e = 1.0f + erff(u * 0.70710678118654752f);
  gv = 0.5f * u * e;
  dv = 0.5f * e + u * expf(-0.5f * u * u) * 0.39894228040143268f;
}

// ---- FFN backward, the row pass ---------------------------------------------------
//
// grid (ceil(M / K16_ROWS), slices), K16_THREADS threads, k16_ffn_bwd_smem()
// bytes of dynamic shared memory. Per chunk of K16_FC columns, in registers:
// U = bf16(x1) W1c^T + b1 and dGU = bf16(dz) W2c (two mma products over H),
// DU = dGU * GELU'(U); then bf16(GELU(U)) and bf16(DU) are stored (through a
// per-warp shared tile, 16-byte rows), DU's float32 column sums over the
// block's rows go to db1p[row tile] (db1 sums the float32 DU, as JAX's), and
// dx1 += bf16(DU) W1c accumulates in registers across the slice; the
// slice's partial goes to dx1p[slice]. x1's and dz's tiles sit in shared
// memory as bf16 (fragments by ldmatrix a chunk). Slice 0 also writes
// bf16(x1), (M, K16_KP), for the dW1 product.
struct K16FfnBwdSmem {
  static constexpr int RING = K16_FSTAGES * K16_WSTAGE;
  static constexpr int X = K16_ROWS * K16_LD, OT = K16_WARPS * 16 * K16_FLD;
  static constexpr int BYTES = (RING + 2 * X + OT) * 2 + K16_WARPS * K16_FC * 4;
};

__global__ void __launch_bounds__(K16_THREADS, K16_BWD_PER_SM)
k16_ffn_bwd_kernel(const float* __restrict__ x1, const bf16_t* __restrict__ dzb,
                   const bf16_t* __restrict__ w1b, const bf16_t* __restrict__ w2b,
                   const float* __restrict__ b1m, bf16_t* __restrict__ gub,
                   bf16_t* __restrict__ dub, float* __restrict__ db1p, float* __restrict__ dx1p,
                   bf16_t* __restrict__ x1b, int M, int H, int F, int chunks) {
  using S = K16FfnBwdSmem;
  extern __shared__ __align__(16) bf16_t k16s[];
  bf16_t* ring = k16s;
  bf16_t* xs = ring + S::RING;
  bf16_t* zs = xs + S::X;
  float(*red)[K16_FC] = reinterpret_cast<float(*)[K16_FC]>(zs + S::X + S::OT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rb = blockIdx.x * K16_ROWS, r0 = rb + warp * 16;
  const int fbase = blockIdx.y * chunks * K16_FC;
  bf16_t* tile = zs + S::X + warp * 16 * K16_FLD;
  for (int i = threadIdx.x; i < K16_ROWS * (K16_KP / 8); i += K16_THREADS) {
    const int r = i / (K16_KP / 8), c = (i % (K16_KP / 8)) * 8;
    const bool ok = rb + r < M;
    k16_cp16(zs + r * K16_LD + c, ok ? dzb + (size_t)(rb + r) * K16_KP + c : dzb, ok);
  }
  k16_ring_start(ring, w1b, w2b, fbase, H, F, chunks);   // dz's tile joins chunk 0's group
  k16_rows_tile(xs, x1, rb, M, H);
  if (blockIdx.y == 0) {
    __syncthreads();
    for (int i = threadIdx.x; i < K16_ROWS * (K16_KP / 8); i += K16_THREADS) {
      const int r = i / (K16_KP / 8), c = (i % (K16_KP / 8)) * 8;
      if (rb + r < M)
        *reinterpret_cast<uint4*>(x1b + (size_t)(rb + r) * K16_KP + c) =
            *reinterpret_cast<const uint4*>(xs + r * K16_LD + c);
    }
  }
  float dx[K16_NB][4];
#pragma unroll
  for (int nb = 0; nb < K16_NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dx[nb][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int f0 = fbase + c * K16_FC;
    const bf16_t* w1s = k16_ring_next(ring, w1b, w2b, fbase, c, H, F, chunks);
    const bf16_t* w2s = w1s + K16_W1ST;
    float u[K16_FC / 8][4], dg[K16_FC / 8][4];
#pragma unroll
    for (int nb = 0; nb < K16_FC / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[nb][e] = dg[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K16_KS; ++kk) {
      uint32_t xa[4], za[4];
      k16_lda(xa, xs, K16_LD, warp * 16, kk, lane);
      k16_lda(za, zs, K16_LD, warp * 16, kk, lane);
      k16_mma_nk<K16_FC / 8>(u, xa, w1s, K16_LD, kk, lane);     // (n = j, k = h)
      k16_mma_kn<K16_FC / 8>(dg, za, w2s, K16_FLD, kk, lane);   // (k = h, n = j)
    }
    uint32_t da[K16_FC / 16][4];
    float cs[K16_FC / 8][2];
#pragma unroll
    for (int nb = 0; nb < K16_FC / 8; ++nb) {
      const int col = f0 + 8 * nb + 2 * t;
      const float bb[2] = {__ldg(b1m + col), __ldg(b1m + col + 1)};
      float gv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float gd;
        k16_gelu2(u[nb][e] + bb[e & 1], gv[e], gd);
        dg[nb][e] *= gd;   // DU; rows past M have dz = 0
      }
      cs[nb][0] = dg[nb][0] + dg[nb][2];
      cs[nb][1] = dg[nb][1] + dg[nb][3];
      *reinterpret_cast<uint32_t*>(tile + g * K16_FLD + 8 * nb + 2 * t) = k16_pack(gv[0], gv[1]);
      *reinterpret_cast<uint32_t*>(tile + (g + 8) * K16_FLD + 8 * nb + 2 * t) =
          k16_pack(gv[2], gv[3]);
    }
#pragma unroll
    for (int p = 0; p < K16_FC / 16; ++p) k16_c2a(da[p], dg[2 * p], dg[2 * p + 1]);
    // the warp's 16 x 32 tile out as 16-byte row pieces: GELU(U), then DU
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      __syncwarp();
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int piece = lane + 32 * s, r = piece >> 2, part = (piece & 3) * 8;
        if (r0 + r < M)
          *reinterpret_cast<uint4*>((which ? dub : gub) + (size_t)(r0 + r) * F + f0 + part) =
              *reinterpret_cast<const uint4*>(tile + r * K16_FLD + part);
      }
      __syncwarp();
      if (which == 0)
#pragma unroll
        for (int p = 0; p < K16_FC / 16; ++p) {
          *reinterpret_cast<uint32_t*>(tile + g * K16_FLD + 16 * p + 2 * t) = da[p][0];
          *reinterpret_cast<uint32_t*>(tile + (g + 8) * K16_FLD + 16 * p + 2 * t) = da[p][1];
          *reinterpret_cast<uint32_t*>(tile + g * K16_FLD + 16 * p + 8 + 2 * t) = da[p][2];
          *reinterpret_cast<uint32_t*>(tile + (g + 8) * K16_FLD + 16 * p + 8 + 2 * t) = da[p][3];
        }
    }
    // dx1 += bf16(DU) W1c: w1s holds (k = j, n = h)
#pragma unroll
    for (int p = 0; p < K16_FC / 16; ++p)
      k16_mma_kn<K16_NB>(dx, da[p], w1s, K16_LD, p, lane);
    // DU's column sums: the warp's 16 rows (lanes of one t), then the warps
#pragma unroll
    for (int nb = 0; nb < K16_FC / 8; ++nb)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = cs[nb][q];
        v += __shfl_xor_sync(MNT_FULL_MASK, v, 4);
        v += __shfl_xor_sync(MNT_FULL_MASK, v, 8);
        v += __shfl_xor_sync(MNT_FULL_MASK, v, 16);
        if (g == 0) red[warp][8 * nb + 2 * t + q] = v;
      }
    __syncthreads();
    if (threadIdx.x < K16_FC) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < K16_WARPS; ++w) sum += red[w][threadIdx.x];
      db1p[(size_t)blockIdx.x * F + f0 + threadIdx.x] = sum;
    }
  }
  float* dst = dx1p + (size_t)blockIdx.y * M * H;
#pragma unroll
  for (int nb = 0; nb < K16_NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), o = 8 * nb + 2 * t + (e & 1);
      if (r < M && o < H) dst[(size_t)r * H + o] = dx[nb][e];
    }
}

// F slices a row tile for an FFN kernel that keeps `per_sm` blocks resident
// on each SM: enough blocks to fill every resident slot once (more blocks
// measured faster than fewer, longer ones at the same count of waves), at
// most K16_MAXSLICE, a divisor of the chunk count.
static int k16_slices(int M, int F, int per_sm) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (M + K16_ROWS - 1) / K16_ROWS, chunks = F / K16_FC;
  int s = (per_sm * sms + tiles - 1) / tiles;
  if (s > K16_MAXSLICE) s = K16_MAXSLICE;
  if (s > chunks) s = chunks;
  while (chunks % s) --s;
  return s;
}

// ---- dense products of the hidden width -------------------------------------------
//
// C = A B^T (+ bias) (+ add) for M rows, N <= 96 outputs, K <= 16 KS: A (M, K)
// float32 (rounded on load) or bf16 rows (zero-padded to 16 KS columns),
// each warp's fragments loaded straight into registers; B (N, 16 KS) bf16
// from k16_weights_kernel, staged once a block by cp.async while the warps
// load their A fragments. grid (ceil(M / K16_ROWS), Y): block y takes b[y],
// bias[y] and c32[y]. Output float32 (c32) or bf16 (c16).
struct K16Rows {
  const float* a32;
  const bf16_t* a16;
  int lda;
  const bf16_t* b[3];
  const float* bias[3];
  const float* add;
  float* c32[3];
  bf16_t* c16;
  int ldc, M, N, K;
};

template <int KS>
__global__ void __launch_bounds__(K16_THREADS) k16_rows_kernel(K16Rows g) {
  extern __shared__ __align__(16) bf16_t bs[];   // [K16_KP][16 KS + 8]
  constexpr int LDB = 16 * KS + 8;
  const int y = blockIdx.y;
  const bf16_t* B = g.b[y];
  for (int i = threadIdx.x; i < K16_KP * 2 * KS; i += K16_THREADS) {
    const int n = i / (2 * KS), c = (i % (2 * KS)) * 8;
    k16_cp16(bs + n * LDB + c, n < g.N ? B + (size_t)n * 16 * KS + c : B, n < g.N);
  }
  k16_commit();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * K16_ROWS + warp * 16;
  uint32_t a[KS][4];
  if (g.a16) k16_frag16<KS>(a, g.a16, g.lda, r0, g.M, gq, t);
  else k16_frag32<KS>(a, g.a32, g.lda, r0, g.M, g.K, gq, t);
  float c[K16_NB][4];
#pragma unroll
  for (int nb = 0; nb < K16_NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
  k16_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) k16_mma_nk<K16_NB>(c, a[kk], bs, LDB, kk, lane);
  const float* bias = g.bias[y];
#pragma unroll
  for (int nb = 0; nb < K16_NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + gq + 8 * (e >> 1), n = 8 * nb + 2 * t + (e & 1);
      if (r >= g.M || n >= g.N) continue;
      float v = c[nb][e];
      if (bias) v += __ldg(bias + n);
      if (g.add) v += g.add[(size_t)r * g.N + n];
      if (g.c16) g.c16[(size_t)r * g.ldc + n] = k16_bits(v);
      else g.c32[y][(size_t)r * g.ldc + n] = v;
    }
}

template <int KS>
static cudaError_t k16_rows(const K16Rows& g, int Y, cudaStream_t stream) {
  const size_t smem = (size_t)K16_KP * (16 * KS + 8) * sizeof(bf16_t);
  cudaError_t err = allow_smem(k16_rows_kernel<KS>, smem);
  if (err != cudaSuccess) return err;
  k16_rows_kernel<KS><<<dim3((g.M + K16_ROWS - 1) / K16_ROWS, Y), K16_THREADS, smem, stream>>>(g);
  return cudaGetLastError();
}

// ---- LayerNorm backward under mm16 -------------------------------------------------
//
// One post-LN residual's backward, one row a warp, K16_LN_ROWS rows a block:
// gin = the gradient reaching the LN (gin, plus the `nparts` partial
// products of gparts added in order: LN1 sums dy2 and the FFN slices' dx1
// here), pre = the saved pre-LN sum; writes dres = LN'(gin) (float32) and
// bf16(dres * keep) (K16_KP-wide rows, pad zero) for the products, a bf16
// copy of one float32 (M, H) matrix (copy_src, K16_KP-wide rows) for the dW
// products, zeros columns [pad_from, pad_ld) of pad_dst's rows, and the
// block's column sums [gin xh | gin | dres * keep] (scale, shift and branch
// bias gradients) into part[blockIdx.x].
struct K16Ln {
  const float* gin;
  const float* gparts;
  int nparts;
  const float* pre;
  const float* gamma;
  Dropout drop;
  float* dres;
  bf16_t* dmask16;
  const float* copy_src;
  bf16_t* copy_dst;
  bf16_t* pad_dst;
  int pad_ld, pad_from;
  float* part;
  int T, TP, M, H;
};

__global__ void __launch_bounds__(BERT_THREADS) k16_ln_bwd_kernel(K16Ln L) {
  __shared__ float red[BERT_THREADS / 32][3][FFN_MAXH + 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = L.H;
  const size_t MH = (size_t)L.M * H;
  float sgx[4] = {0.f, 0.f, 0.f, 0.f}, sg[4] = {0.f, 0.f, 0.f, 0.f},
        sdm[4] = {0.f, 0.f, 0.f, 0.f};
  const int r_end = min(L.M, ((int)blockIdx.x + 1) * K16_LN_ROWS);
  for (int row = blockIdx.x * K16_LN_ROWS + warp; row < r_end; row += BERT_THREADS / 32) {
    const size_t off = (size_t)row * H;
    const uint32_t rr = (uint32_t)(row / L.T * L.TP + row % L.T);
    float a[4], gv[4];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = lane + 32 * t;
      a[t] = o < H ? L.pre[off + o] : 0.f;
      gv[t] = 0.f;
      if (o < H) {
        float pp = 0.f;
        for (int sp = 0; sp < L.nparts; ++sp) pp += L.gparts[sp * MH + off + o];
        gv[t] = L.gin[off + o] + pp;
      }
      s += a[t];
    }
    const float mu = warp_sum(s) / H;
    float ss = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (lane + 32 * t < H) {
        const float d = a[t] - mu;
        ss = fmaf(d, d, ss);
      }
    const float r = 1.f / sqrtf(warp_sum(ss) / H + 1e-12f);
    float xh[4], dxh[4], m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = lane + 32 * t;
      xh[t] = (a[t] - mu) * r;
      dxh[t] = o < H ? gv[t] * __ldg(L.gamma + o) : 0.f;
      m1 += dxh[t];
      m2 = fmaf(dxh[t], xh[t], m2);
    }
    m1 = warp_sum(m1) / H;
    m2 = warp_sum(m2) / H;
    const size_t off16 = (size_t)row * K16_KP;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = lane + 32 * t;
      if (o < H) {
        const float dy = r * (dxh[t] - m1 - xh[t] * m2);
        const float dm = dy * keep(L.drop, rr, o);
        L.dres[off + o] = dy;
        L.dmask16[off16 + o] = k16_bits(dm);
        if (L.copy_src) L.copy_dst[off16 + o] = k16_bits(L.copy_src[off + o]);
        sgx[t] = fmaf(gv[t], xh[t], sgx[t]);
        sg[t] += gv[t];
        sdm[t] += dm;
      } else if (o < K16_KP) {
        L.dmask16[off16 + o] = 0;
        if (L.copy_src) L.copy_dst[off16 + o] = 0;
      }
    }
    if (L.pad_dst)
      for (int o = L.pad_from + lane; o < L.pad_ld; o += 32)
        L.pad_dst[(size_t)row * L.pad_ld + o] = 0;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    red[warp][0][lane + 32 * t] = sgx[t];
    red[warp][1][lane + 32 * t] = sg[t];
    red[warp][2][lane + 32 * t] = sdm[t];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * H; e += BERT_THREADS) {
    const int which = e / H, o = e % H;
    float s = 0.f;
    for (int w = 0; w < BERT_THREADS / 32; ++w) s += red[w][which][o];
    L.part[(size_t)blockIdx.x * 3 * H + e] = s;
  }
}

// ---- the dW products: C[i][j] = sum_m P[m][i] Q[m][j] -------------------------------
//
// Up to four products in one launch (dW1 = DU^T x1, dW2^T = GU^T dz, dWo =
// da^T ctx, [dWq; dWk; dWv] = [dq dk dv]^T x), each over M rows of bf16
// (M, .) matrices, j < H. A block owns a 128 x 96 output tile and one split
// of the rows (its float32 partial goes to part[split], reduced in order by
// k16_reduce_kernel); 8 warps of 32 x 48; rows of m in stages of 32 through
// a 3-stage ring of 16-byte cp.async copies (no register staging), both
// operands read by ldmatrix.trans.
struct K16TnJob {
  const bf16_t* P;
  int ldp, ni;
  const bf16_t* Q;
  float* part;   // (ni, nj) a split, or with trans (nj, ni): dW2 = (dW2^T)^T
  int tiles_i, first_block, trans;
};

struct K16Tn {
  K16TnJob job[4];
  int njobs, splits, kchunk, M, nj, ldq;
};

__global__ void __launch_bounds__(K16_TN_THREADS, 2) k16_tn_kernel(K16Tn g) {
  constexpr int PLD = K16_TN_BI + 8, QLD = K16_TN_BJ + 8;   // 272 B, 208 B pitches
  constexpr int STAGE = K16_TN_BK * (PLD + QLD);
  __shared__ __align__(16) bf16_t sm[K16_TN_STAGES * STAGE];
  int jb = 0;
  while (jb + 1 < g.njobs && (int)blockIdx.x >= g.job[jb + 1].first_block) ++jb;
  const K16TnJob& J = g.job[jb];
  const int local = blockIdx.x - J.first_block;
  const int i0 = (local % J.tiles_i) * K16_TN_BI, split = local / J.tiles_i;
  const int mb = split * g.kchunk, me = min(g.M, mb + g.kchunk);
  const int nk = (me - mb + K16_TN_BK - 1) / K16_TN_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int wi = (warp & 3) * 32, wj = (warp >> 2) * 48;

  auto load = [&](int stage, int kt) {
    bf16_t* Ps = sm + stage * STAGE;
    bf16_t* Qs = Ps + K16_TN_BK * PLD;
    const int m0 = mb + kt * K16_TN_BK;
    for (int c = threadIdx.x; c < K16_TN_BK * (K16_TN_BI / 8); c += K16_TN_THREADS) {
      const int r = c / (K16_TN_BI / 8), col = (c % (K16_TN_BI / 8)) * 8;
      const bool ok = m0 + r < me && i0 + col < J.ldp;
      k16_cp16(Ps + r * PLD + col, ok ? J.P + (size_t)(m0 + r) * J.ldp + i0 + col : J.P, ok);
    }
    for (int c = threadIdx.x; c < K16_TN_BK * (K16_TN_BJ / 8); c += K16_TN_THREADS) {
      const int r = c / (K16_TN_BJ / 8), col = (c % (K16_TN_BJ / 8)) * 8;
      const bool ok = m0 + r < me && col < g.ldq;
      k16_cp16(Qs + r * QLD + col, ok ? J.Q + (size_t)(m0 + r) * g.ldq + col : J.Q, ok);
    }
  };

  float acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < K16_TN_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    k16_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    k16_wait<K16_TN_STAGES - 2>();
    __syncthreads();
    if (kt + K16_TN_STAGES - 1 < nk)
      load((kt + K16_TN_STAGES - 1) % K16_TN_STAGES, kt + K16_TN_STAGES - 1);
    k16_commit();
    const bf16_t* Ps = sm + (kt % K16_TN_STAGES) * STAGE;
    const bf16_t* Qs = Ps + K16_TN_BK * PLD;
#pragma unroll
    for (int kk = 0; kk < K16_TN_BK / 16; ++kk) {
      // A (i, k = m) from P's [m][i] rows: matrix q = lane / 8 covers rows
      // i + 8 (q & 1) and k + 8 (q >> 1)
      uint32_t a[2][4];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int q = lane >> 3;
        tc_ldsm_t(a[ii], Ps + (16 * kk + 8 * (q >> 1) + (lane & 7)) * PLD + wi + 16 * ii +
                             8 * (q & 1));
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint32_t b[4];
        tc_ldsm_t(b, Qs + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * QLD + wj + 16 * p +
                         8 * (lane >> 4));
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          tc_mma(acc[ii][2 * p], a[ii], b[0], b[1]);
          tc_mma(acc[ii][2 * p + 1], a[ii], b[2], b[3]);
        }
      }
    }
  }
  k16_wait<0>();
  float* C = J.part + (size_t)split * J.ni * g.nj;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int jj = 0; jj < 6; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wi + 16 * ii + gq + 8 * (e >> 1), j = wj + 8 * jj + 2 * t + (e & 1);
        if (i < J.ni && j < g.nj)
          C[J.trans ? (size_t)j * J.ni + i : (size_t)i * g.nj + j] = acc[ii][jj][e];
      }
}

// ---- every cross-block sum of the backward, in one launch ---------------------------
//
// Segment s: dst[e] = the sum over k < S of part[k * stride + e]. A block
// takes 32 consecutive elements (a lane each) of one segment (blockIdx.y);
// warp w sums the partials k = w, w + 8, .. in order, then the eight warps'
// sums are added in order: a fixed order whatever the grid.
struct K16Seg {
  const float* part;
  long long stride;
  int S, n;
  float* dst;
};

#define K16_MAXSEG 16

struct K16Reduce {
  K16Seg seg[K16_MAXSEG];
};

__global__ void __launch_bounds__(256) k16_reduce_kernel(K16Reduce R) {
  __shared__ float red[8][32];
  const K16Seg& s = R.seg[blockIdx.y];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e0 = blockIdx.x * 32; e0 < s.n; e0 += gridDim.x * 32) {
    const int e = e0 + lane;
    float acc = 0.f;
    if (e < s.n)
      for (int k = warp; k < s.S; k += 8) acc += s.part[k * s.stride + e];
    __syncthreads();   // the previous round's sums are read
    red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && e < s.n) {
      float sum = red[0][lane];
#pragma unroll
      for (int w = 1; w < 8; ++w) sum += red[w][lane];
      s.dst[e] = sum;
    }
  }
}

// ---- attention on the tensor cores ------------------------------------------------
//
// Every score is the exact product of bf16(q * scale) and bf16(k) (the head
// dim zero-padded to DP = 16 KS, KS k16 steps) summed in float32; a block
// owns 64 rows of one (subject, head), a warp 16 of them as A fragments, and
// streams the other side through double-buffered [64][DP + 8] shared tiles
// (dynamic shared memory: 53 KB at KS 6). A head's row is hd floats (28
// bytes at hd 7), too ragged for wide copies, so k16_heads_kernel first
// writes bf16(q * scale), bf16(k), bf16(v) (and in the backward bf16(dctx))
// head-major, (B, heads, T, DP) with the head dim zero-padded: a 64-row tile
// is then 128 DP bytes contiguous, KS 16-byte cp.async a thread. The kernels
// are compiled for KS 1, 2, 3 and 6 (k16_ks: every head dim of hidden 84 and
// 48 pads to one of them exactly; 4 and 5 take 6); at KS 1, the flagship's
// hd 7, their arithmetic is that of the one-step kernels they generalise. Keys >= t_valid are masked out (their e, p, ds are 0) and get
// zero gradients. Dropout of the probabilities: draw 3 at (b TP + query,
// h TP + key), as the CUDA-core kernels and the JAX kernel key it.

struct K16Heads {
  const float* src32[4];
  const bf16_t* src16[4];
  float scale[4];
  bf16_t* dst[4];
};

// The k16 steps of a head dim's padding: the smallest compiled KS (1, 2, 3,
// 6) with 16 KS >= hd.
static int k16_ks(int hd) {
  const int ks = (hd + 15) / 16;
  return ks <= 3 ? ks : 6;
}

// grid (ceil(B heads T / 256), matrices), one (b, h, t) row a thread
// (threads in (b, t, h) order, so that a warp reads whole token rows):
// dst[m][((b heads + h) T + t) dp + d] = bf16(src[m][(b T + t) H + h hd + d]
// * scale[m]) for d < hd, else 0 (two 16-byte stores a 16 dims); a bf16
// source (src16) is copied as it is.
__global__ void __launch_bounds__(256)
k16_heads_kernel(K16Heads P, int BHT, int T, int H, int hd, int heads, int dp) {
  const int m = blockIdx.y, idx = blockIdx.x * 256 + threadIdx.x;   // (b, t, h) order
  if (idx >= BHT) return;
  const int h = idx % heads, bt = idx / heads, b = bt / T, t = bt % T;
  const int row = (b * heads + h) * T + t;
  const size_t src = (size_t)bt * H + h * hd;
  for (int d0 = 0; d0 < dp; d0 += 16) {
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int d = d0 + 2 * i + q;
        v[q] = 0.f;
        if (d < hd)
          v[q] = P.src16[m] ? __bfloat162float(
                                  *reinterpret_cast<const __nv_bfloat16*>(P.src16[m] + src + d))
                            : P.src32[m][src + d] * P.scale[m];
      }
      w[i] = k16_pack(v[0], v[1]);
    }
    uint4* dst = reinterpret_cast<uint4*>(P.dst[m] + (size_t)row * dp + d0);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

static cudaError_t k16_heads(const K16Heads& P, int nmat, int B, int T, int H, int heads,
                             cudaStream_t stream) {
  const int BHT = B * heads * T, hd = H / heads;
  k16_heads_kernel<<<dim3((BHT + 255) / 256, nmat), 256, 0, stream>>>(P, BHT, T, H, hd, heads,
                                                                       16 * k16_ks(hd));
  return cudaGetLastError();
}

// The shared tiles of a KS attention kernel: [64][16 KS + 8] bf16 (the
// pitch an odd number of 16-byte units: ldmatrix rows on distinct banks).
template <int KS>
struct K16Att {
  static constexpr int DP = 16 * KS, ALD = DP + 8, TILE = K16_AT * ALD;
  static constexpr size_t TILE_BYTES = (size_t)TILE * sizeof(bf16_t);
};

// Rows [r0, r0 + 64) of one head's (T, 16 KS) bf16 rows into a [64][16 KS
// + 8] tile, zero past `rows`: KS 16-byte cp.async a thread.
template <int KS>
__device__ __forceinline__ void k16_tile_cp(bf16_t* tile, const bf16_t* head, int r0, int rows) {
  constexpr int DP = K16Att<KS>::DP, ALD = K16Att<KS>::ALD, CPR = 2 * KS;
#pragma unroll
  for (int it = 0; it < KS; ++it) {
    const int e = threadIdx.x + it * K16_THREADS, r = e / CPR, c = (e % CPR) * 8;
    const bool ok = r0 + r < rows;
    k16_cp16(tile + r * ALD + c, ok ? head + (size_t)(r0 + r) * DP + c : head, ok);
  }
}

// 4-byte cp.async (rows of float32 per-row values start unaligned); ok ==
// false zero-fills.
__device__ __forceinline__ void k16_cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tc_smem(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

// e = exp(min(s, 80)) of a score (exp2 on the MUFU), 0 for a key past
// t_valid.
__device__ __forceinline__ float k16_exp(float s, bool live) {
  return live ? tc_ex2(fminf(s, BERT_LOGIT_CAP) * K16_LOG2E) : 0.f;
}

// Store a warp's (16 rows, 16 KS dims) accumulator times `scale` as bf16
// into columns col0 + d of rows row0 + r of a (., ld) bf16 matrix (and as
// float32 where out32 is not NULL, ld32 a row), rows < rows_valid, d < hd;
// write its float32 column sums over the warp's rows to red[d] (one slot a
// warp).
template <int KS>
__device__ __forceinline__ void k16_head_store(const float (&acc)[2 * KS][4], float scale,
                                               bf16_t* out16, int ld, float* out32, int ld32,
                                               size_t row0, int r0, int rows_valid, int hd,
                                               float* red, int g, int t) {
  float cs[2 * KS][2];
#pragma unroll
  for (int db = 0; db < 2 * KS; ++db) cs[db][0] = cs[db][1] = 0.f;
#pragma unroll
  for (int db = 0; db < 2 * KS; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), d = 8 * db + 2 * t + (e & 1);
      if (r < rows_valid && d < hd) {
        const float v = acc[db][e] * scale;
        if (out16) out16[(row0 + r) * ld + d] = k16_bits(v);
        if (out32) out32[(row0 + r) * ld32 + d] = v;
        cs[db][e & 1] += v;
      }
    }
  if (!red) return;
#pragma unroll
  for (int db = 0; db < 2 * KS; ++db)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float v = cs[db][q];
      v += __shfl_xor_sync(MNT_FULL_MASK, v, 4);
      v += __shfl_xor_sync(MNT_FULL_MASK, v, 8);
      v += __shfl_xor_sync(MNT_FULL_MASK, v, 16);
      if (g == 0) red[8 * db + 2 * t + q] = v;
    }
}

// grid (ceil(T / 64), heads, B), K16_THREADS threads. Pass 1 over the key
// tiles: den = sum of bf16(e) (keys < t_valid); rd = bf16(1 / den). Pass 2:
// p = e rd, pd = p keep, ctx = bf16(pd) bf16(v) on mma. ctx float32; rd to
// rden (the residuals' log-sum-exp slot) where rden is not NULL.
// Shared memory: two k and two v tiles (4 K16Att<KS>::TILE_BYTES).
template <int KS, bool DROP>
__global__ void __launch_bounds__(K16_THREADS)
k16_attn_fwd_kernel(const bf16_t* __restrict__ qh, const bf16_t* __restrict__ kh,
                    const bf16_t* __restrict__ vh, float* __restrict__ ctx,
                    float* __restrict__ rden, Dropout drop, int T, int TP, int H, int hd,
                    int t_valid) {
  using A = K16Att<KS>;
  extern __shared__ uint4 k16_dyn[];
  bf16_t* ks = reinterpret_cast<bf16_t*>(k16_dyn);   // [2][TILE]
  bf16_t* vs = ks + 2 * A::TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * K16_AT + warp * 16;
  const size_t bh = (size_t)b * gridDim.y + h, hb = bh * T * A::DP;
  uint32_t hr[2] = {0u, 0u};
  if (DROP) {
    hr[0] = keep_row(drop, (uint32_t)(b * TP + i0 + g));
    hr[1] = keep_row(drop, (uint32_t)(b * TP + i0 + g + 8));
  }
  uint32_t qa[KS][4];
  k16_frag16<KS>(qa, qh + hb, A::DP, i0, T, g, t);
  const int tiles = (t_valid + K16_AT - 1) / K16_AT, steps = 2 * tiles;
  auto load = [&](int st) {   // pass 1: k; pass 2: k and v
    const int j0 = (st % tiles) * K16_AT;
    k16_tile_cp<KS>(ks + (st & 1) * A::TILE, kh + hb, j0, t_valid);
    if (st >= tiles) k16_tile_cp<KS>(vs + (st & 1) * A::TILE, vh + hb, j0, t_valid);
  };
  load(0);
  k16_commit();
  float den[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
  float o[2 * KS][4];
#pragma unroll
  for (int db = 0; db < 2 * KS; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[db][e] = 0.f;
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) load(st + 1);
    k16_commit();
    k16_wait<1>();
    __syncthreads();
    const int j0 = (st % tiles) * K16_AT, buf = st & 1;
    if (st == tiles)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        den[hh] += __shfl_xor_sync(MNT_FULL_MASK, den[hh], 1);
        den[hh] += __shfl_xor_sync(MNT_FULL_MASK, den[hh], 2);
        rd[hh] = bf16r(1.f / fmaxf(den[hh], 1e-38f));
      }
    float s[K16_AT / 8][4];
#pragma unroll
    for (int nb = 0; nb < K16_AT / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      k16_mma_nk<K16_AT / 8>(s, qa[kk], ks + buf * A::TILE, A::ALD, kk, lane);
    if (st < tiles) {
#pragma unroll
      for (int nb = 0; nb < K16_AT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          den[e >> 1] += bf16r(k16_exp(s[nb][e], j0 + 8 * nb + 2 * t + (e & 1) < t_valid));
    } else {
#pragma unroll
      for (int nb = 0; nb < K16_AT / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + 8 * nb + 2 * t + (e & 1);
          float p = k16_exp(s[nb][e], key < t_valid) * rd[e >> 1];
          if (DROP) p *= keep_at(drop, hr[e >> 1], (uint32_t)(h * TP + key));
          s[nb][e] = p;
        }
#pragma unroll
      for (int p = 0; p < K16_AT / 16; ++p) {
        uint32_t pa[4];
        k16_c2a(pa, s[2 * p], s[2 * p + 1]);
        k16_mma_kn<2 * KS>(o, pa, vs + buf * A::TILE, A::ALD, p, lane);   // (k = key, n = d)
      }
    }
    __syncthreads();   // the tiles are read before the next copy into them
  }
  const size_t row0 = (size_t)b * T;
  k16_head_store<KS>(o, 1.f, nullptr, 0, ctx + (size_t)h * hd, H, row0, i0, T, hd, nullptr, g,
                     t);
  if (rden && t == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + g + 8 * hh;
      if (i < T) rden[bh * T + i] = rd[hh];
    }
}

// dq of 64 queries of one (subject, head): pass 1 over the key tiles, seg =
// bf16(sum_j bf16(dp p)) with p = e rden, dp = (bf16(dctx) bf16(v)) keep;
// pass 2, ds = bf16(p (dp - seg)) and dq = scale sum_j ds bf16(k) on mma.
// dq goes to dqkvb (bf16, columns h hd ..), seg to seg_out for the dk/dv
// kernel, the block's float32 column sums of dq to dbp[b tiles + tile]
// (columns h hd .. of a 3H row). grid (ceil(T / 64), heads, B); with
// dropout, a word of dynamic shared memory a thread and key tile holds pass
// 1's keep bits, so that pass 2 does not hash again. Shared memory: two k
// and two v tiles, then the keep words.
template <int KS, bool DROP>
__global__ void __launch_bounds__(K16_THREADS)
k16_attn_dq_kernel(const bf16_t* __restrict__ qh, const bf16_t* __restrict__ kh,
                   const bf16_t* __restrict__ vh, const bf16_t* __restrict__ gh,
                   const float* __restrict__ rden, float* __restrict__ seg_out,
                   bf16_t* __restrict__ dqkvb, int ldd, float* __restrict__ dbp, Dropout drop,
                   int T, int TP, int H, int hd, int t_valid, float scale) {
  using A = K16Att<KS>;
  __shared__ float red[K16_WARPS][A::DP];
  extern __shared__ uint4 k16_dyn[];
  bf16_t* ks = reinterpret_cast<bf16_t*>(k16_dyn);   // [2][TILE]
  bf16_t* vs = ks + 2 * A::TILE;
  uint32_t* kbits = reinterpret_cast<uint32_t*>(vs + 2 * A::TILE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * K16_AT + warp * 16;
  const size_t bh = (size_t)b * gridDim.y + h, hb = bh * T * A::DP, si = bh * T;
  uint32_t hr[2] = {0u, 0u};
  float rd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + g + 8 * hh;
    rd[hh] = i < T ? rden[si + i] : 0.f;
    if (DROP) hr[hh] = keep_row(drop, (uint32_t)(b * TP + i));
  }
  uint32_t qa[KS][4], ga[KS][4];
  k16_frag16<KS>(qa, qh + hb, A::DP, i0, T, g, t);
  k16_frag16<KS>(ga, gh + hb, A::DP, i0, T, g, t);
  const int tiles = (t_valid + K16_AT - 1) / K16_AT, steps = 2 * tiles;
  auto load = [&](int st) {
    const int j0 = (st % tiles) * K16_AT;
    k16_tile_cp<KS>(ks + (st & 1) * A::TILE, kh + hb, j0, t_valid);
    k16_tile_cp<KS>(vs + (st & 1) * A::TILE, vh + hb, j0, t_valid);
  };
  load(0);
  k16_commit();
  float sacc[2] = {0.f, 0.f}, seg[2] = {0.f, 0.f};
  float dq[2 * KS][4];
#pragma unroll
  for (int db = 0; db < 2 * KS; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[db][e] = 0.f;
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) load(st + 1);
    k16_commit();
    k16_wait<1>();
    __syncthreads();
    const int j0 = (st % tiles) * K16_AT, buf = st & 1;
    const bool pass1 = st < tiles;
    if (st == tiles)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sacc[hh] += __shfl_xor_sync(MNT_FULL_MASK, sacc[hh], 1);
        sacc[hh] += __shfl_xor_sync(MNT_FULL_MASK, sacc[hh], 2);
        seg[hh] = bf16r(sacc[hh]);
      }
    float s[K16_AT / 8][4], dp[K16_AT / 8][4];
#pragma unroll
    for (int nb = 0; nb < K16_AT / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      k16_mma_nk<K16_AT / 8>(s, qa[kk], ks + buf * A::TILE, A::ALD, kk, lane);
      k16_mma_nk<K16_AT / 8>(dp, ga[kk], vs + buf * A::TILE, A::ALD, kk, lane);
    }
    uint32_t* kw = kbits + (st % tiles) * K16_THREADS + threadIdx.x;
    uint32_t bits = DROP && !pass1 ? *kw : 0u;
#pragma unroll
    for (int nb = 0; nb < K16_AT / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * nb + 2 * t + (e & 1);
        const float p = k16_exp(s[nb][e], key < t_valid) * rd[e >> 1];
        float d = dp[nb][e];
        if (DROP) {
          if (pass1) bits |= (uint32_t)(keep_at(drop, hr[e >> 1], (uint32_t)(h * TP + key)) != 0.f)
                            << (4 * nb + e);
          d *= bits >> (4 * nb + e) & 1u ? drop.scale : 0.f;
        }
        if (pass1) sacc[e >> 1] += bf16r(d * p);
        else s[nb][e] = p * (d - seg[e >> 1]);   // ds, rounded by k16_c2a
      }
    if (DROP && pass1) *kw = bits;
    if (!pass1)
#pragma unroll
      for (int p = 0; p < K16_AT / 16; ++p) {
        uint32_t da[4];
        k16_c2a(da, s[2 * p], s[2 * p + 1]);
        k16_mma_kn<2 * KS>(dq, da, ks + buf * A::TILE, A::ALD, p, lane);   // (k = key, n = d)
      }
    __syncthreads();
  }
  const size_t row0 = (size_t)b * T, col = (size_t)h * hd;
  k16_head_store<KS>(dq, scale, dqkvb + col, ldd, nullptr, 0, row0, i0, T, hd, red[warp], g, t);
  if (t == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + g + 8 * hh;
      if (i < T) seg_out[si + i] = seg[hh];
    }
  __syncthreads();
  if (threadIdx.x < hd) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < K16_WARPS; ++w) sum += red[w][threadIdx.x];
    dbp[((size_t)b * gridDim.x + blockIdx.x) * 3 * H + col + threadIdx.x] = sum;
  }
}

// dk and dv of 64 keys of one (subject, head), a warp's 16 keys as A
// fragments (bf16 k, bf16 v), streaming the query tiles (bf16(q scale),
// bf16(dctx), rden, seg): s^T = k (q scale)^T, dp^T = v dctx^T; p = e rden
// (0 for a key >= t_valid), ds = bf16(p (dp keep - seg)), pd = bf16(p keep);
// dk = sum_i ds bf16(q scale), dv = sum_i pd bf16(dctx) on mma. Both go to
// dqkvb (columns H + h hd .., 2H + h hd ..), their column sums to dbp.
// Shared memory: two q and two dctx tiles.
template <int KS, bool DROP>
__global__ void __launch_bounds__(K16_THREADS)
k16_attn_dkv_kernel(const bf16_t* __restrict__ qh, const bf16_t* __restrict__ kh,
                    const bf16_t* __restrict__ vh, const bf16_t* __restrict__ gh,
                    const float* __restrict__ rden, const float* __restrict__ seg,
                    bf16_t* __restrict__ dqkvb, int ldd, float* __restrict__ dbp, Dropout drop,
                    int T, int TP, int H, int hd, int t_valid) {
  using A = K16Att<KS>;
  extern __shared__ uint4 k16_dyn[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(k16_dyn);   // [2][TILE]
  bf16_t* gs = qs + 2 * A::TILE;
  __shared__ float rs[2][K16_AT], sg[2][K16_AT];
  __shared__ float red[2][K16_WARPS][A::DP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * K16_AT + warp * 16;
  const size_t bh = (size_t)b * gridDim.y + h, hb = bh * T * A::DP, si = bh * T;
  uint32_t ka[KS][4], va[KS][4];
  k16_frag16<KS>(ka, kh + hb, A::DP, j0, t_valid, g, t);
  k16_frag16<KS>(va, vh + hb, A::DP, j0, t_valid, g, t);
  const bool live[2] = {j0 + g < t_valid, j0 + g + 8 < t_valid};
  float dk[2 * KS][4], dv[2 * KS][4];
#pragma unroll
  for (int db = 0; db < 2 * KS; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[db][e] = dv[db][e] = 0.f;
  const int tiles = (T + K16_AT - 1) / K16_AT;
  auto load = [&](int n) {   // queries past T: zero rows, rden = seg = 0 (p = 0)
    const int c0 = n * K16_AT, buf = n & 1, r = threadIdx.x & (K16_AT - 1);
    k16_tile_cp<KS>(qs + buf * A::TILE, qh + hb, c0, T);
    k16_tile_cp<KS>(gs + buf * A::TILE, gh + hb, c0, T);
    const bool ok = c0 + r < T;
    if (threadIdx.x < K16_AT) k16_cp4(&rs[buf][r], ok ? rden + si + c0 + r : rden, ok);
    else k16_cp4(&sg[buf][r], ok ? seg + si + c0 + r : seg, ok);
  };
  load(0);
  k16_commit();
  for (int n = 0; n < tiles; ++n) {
    if (n + 1 < tiles) load(n + 1);
    k16_commit();
    k16_wait<1>();
    __syncthreads();
    const int c0 = n * K16_AT, buf = n & 1;
    float st[K16_AT / 8][4], dpt[K16_AT / 8][4];
#pragma unroll
    for (int nb = 0; nb < K16_AT / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      k16_mma_nk<K16_AT / 8>(st, ka[kk], qs + buf * A::TILE, A::ALD, kk, lane);
      k16_mma_nk<K16_AT / 8>(dpt, va[kk], gs + buf * A::TILE, A::ALD, kk, lane);
    }
#pragma unroll
    for (int nb = 0; nb < K16_AT / 8; ++nb) {
      const int c = 8 * nb + 2 * t;   // the tile's queries c, c + 1
      uint32_t hq[2] = {0u, 0u};
      if (DROP) {
        hq[0] = keep_row(drop, (uint32_t)(b * TP + c0 + c));
        hq[1] = keep_row(drop, (uint32_t)(b * TP + c0 + c + 1));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + g + 8 * (e >> 1);
        const float p = k16_exp(st[nb][e], live[e >> 1]) * rs[buf][c + (e & 1)];
        const float kp = DROP ? keep_at(drop, hq[e & 1], (uint32_t)(h * TP + key)) : 1.f;
        st[nb][e] = p * (dpt[nb][e] * kp - sg[buf][c + (e & 1)]);   // ds
        dpt[nb][e] = p * kp;                                        // pd
      }
    }
#pragma unroll
    for (int p = 0; p < K16_AT / 16; ++p) {
      uint32_t sa[4], pa[4];
      k16_c2a(sa, st[2 * p], st[2 * p + 1]);
      k16_c2a(pa, dpt[2 * p], dpt[2 * p + 1]);
      k16_mma_kn<2 * KS>(dk, sa, qs + buf * A::TILE, A::ALD, p, lane);   // (k = query, n = d)
      k16_mma_kn<2 * KS>(dv, pa, gs + buf * A::TILE, A::ALD, p, lane);
    }
    __syncthreads();
  }
  const size_t row0 = (size_t)b * T, col = (size_t)h * hd;
  k16_head_store<KS>(dk, 1.f, dqkvb + H + col, ldd, nullptr, 0, row0, j0, T, hd, red[0][warp], g,
                     t);
  k16_head_store<KS>(dv, 1.f, dqkvb + 2 * H + col, ldd, nullptr, 0, row0, j0, T, hd,
                     red[1][warp], g, t);
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * hd; e += K16_THREADS) {
    const int which = e / hd, d = e % hd;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < K16_WARPS; ++w) sum += red[which][w][d];
    dbp[((size_t)b * gridDim.x + blockIdx.x) * 3 * H + (1 + which) * H + col + d] = sum;
  }
}

// pre = (sum of `splits` partial products + bias) * the branch's dropout +
// res; out = LN(pre) (two-pass, eps); pre saved if asked. One row a warp.
__global__ void __launch_bounds__(BERT_THREADS)
bert_bias_res_ln_kernel(const float* __restrict__ part, int splits, const float* __restrict__ bias,
                        const float* __restrict__ res, const float* __restrict__ gamma,
                        const float* __restrict__ beta, Dropout drop, int T, int TP, int M, int H,
                        float eps, float* __restrict__ out, float* __restrict__ pre) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (BERT_THREADS / 32) + warp;
  if (row >= M) return;
  const uint32_t rr = (uint32_t)(row / T * TP + row % T);   // padded row
  float vals[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int o = lane + 32 * t;
    vals[t] = 0.f;
    if (o < H) {
      float z = part[(size_t)row * H + o];
      for (int sp = 1; sp < splits; ++sp) z += part[((size_t)sp * M + row) * H + o];
      vals[t] = (z + __ldg(bias + o)) * keep(drop, rr, o) + res[(size_t)row * H + o];
      if (pre) pre[(size_t)row * H + o] = vals[t];
    }
  }
  warp_ln_store(vals, lane, H, gamma, beta, eps, out + (size_t)row * H);
}

// ---- the mm16 entry points ------------------------------------------------------------

static long long k16_align(long long floats) { return (floats + 63) / 64 * 64; }

// bf16 elements as floats of scratch (two a float), aligned.
static long long k16_half(long long elems) { return k16_align((elems + 1) / 2); }

// Scratch layout of bert_layer_forward16 (floats; bf16 buffers take half a
// float an element): q, k, v, ctx, x1 where no residuals are saved (as the
// float32 forward's), the FFN slices' partial sums (M, H) each (the
// out-projection's product uses the first), the bf16 weights and the
// head-major bf16 q * scale, k, v; no (M, F) buffer.
struct K16FwdScratch {
  long long zp, w1b, w2b, wqkv, wo, qh, kh, vh, total;
  int slices;

  K16FwdScratch(int B, int T, int H, int F, int heads) {
    const long long M = (long long)B * T, MH = M * H, BHT = (long long)B * heads * T;
    slices = k16_slices((int)M, F, K16_FWD_PER_SM);
    long long off = k16_align(5 * MH);
    zp = off; off += k16_align(slices * MH);
    w1b = off; off += k16_half((long long)F * K16_KP);
    w2b = off; off += k16_half((long long)H * F);
    wqkv = off; off += k16_half(3LL * H * K16_KP);
    wo = off; off += k16_half((long long)H * K16_KP);
    const long long BHTD = BHT * 16 * k16_ks(H / heads);
    qh = off; off += k16_half(BHTD);
    kh = off; off += k16_half(BHTD);
    vh = off; off += k16_half(BHTD);
    total = off;
  }
};

extern "C" long long bert_layer_scratch16_floats(int B, int T, int H, int F, int heads) {
  return K16FwdScratch(B, T, H, F, heads).total;
}

static bool k16_bad_dims(int T, int H, int F, int heads, int t_valid, int TP) {
  return bert_bad_dims(T, H, F, heads, t_valid, TP) || H > K16_KP || 3 * H > K16_K3P;
}

// Launch KERNEL<KS, drop.on> with SMEM bytes of dynamic shared memory (the
// opt-in counts up to 4 KB of the kernels' static arrays beside it).
#define K16_ATT_LAUNCH(KERNEL, GRID, SMEM, ...)                                           \
  do {                                                                                    \
    if (drop.on) {                                                                        \
      CK(allow_smem(KERNEL<KS, true>, (SMEM) + 4096));                                    \
      KERNEL<KS, true><<<GRID, K16_THREADS, SMEM, stream>>>(__VA_ARGS__);                 \
    } else {                                                                              \
      CK(allow_smem(KERNEL<KS, false>, (SMEM) + 4096));                                   \
      KERNEL<KS, false><<<GRID, K16_THREADS, SMEM, stream>>>(__VA_ARGS__);                \
    }                                                                                     \
    CK(cudaGetLastError());                                                               \
  } while (0)

// The mm16 attention forward over the head-major copies at KS k16 steps.
template <int KS>
static int k16_attention_fwd(const bf16_t* qh, const bf16_t* kh, const bf16_t* vh, float* ctx,
                             float* rden, const Dropout& drop, int B, int T, int TP, int H,
                             int heads, int t_valid, cudaStream_t stream) {
  const dim3 grid((T + K16_AT - 1) / K16_AT, heads, B);
  K16_ATT_LAUNCH(k16_attn_fwd_kernel, grid, 4 * K16Att<KS>::TILE_BYTES, qh, kh, vh, ctx, rden,
                 drop, T, TP, H, H / heads, t_valid);
  return (int)cudaSuccess;
}

// The mm16 attention backward at KS k16 steps: dq (and seg), then dk, dv.
template <int KS>
static int k16_attention_bwd(const bf16_t* qh, const bf16_t* kh, const bf16_t* vh,
                             const bf16_t* gh, const float* rden, float* seg, bf16_t* dqkvb,
                             int ldd, float* dbp, const Dropout& drop, int B, int T, int TP,
                             int H, int heads, int t_valid, float scale, cudaStream_t stream) {
  const int tiles_q = (T + K16_AT - 1) / K16_AT, hd = H / heads;
  const dim3 grid(tiles_q, heads, B);
  const size_t tiles = 4 * K16Att<KS>::TILE_BYTES;
  const size_t kb = drop.on ? (size_t)tiles_q * K16_THREADS * sizeof(uint32_t) : 0;
  K16_ATT_LAUNCH(k16_attn_dq_kernel, grid, tiles + kb, qh, kh, vh, gh, rden, seg, dqkvb, ldd,
                 dbp, drop, T, TP, H, hd, t_valid, scale);
  K16_ATT_LAUNCH(k16_attn_dkv_kernel, grid, tiles, qh, kh, vh, gh, rden, seg, dqkvb, ldd, dbp,
                 drop, T, TP, H, hd, t_valid);
  return (int)cudaSuccess;
}

// FN<KS>(args) at the KS of the head dim hd; returns its error if any.
#define K16_BY_KS(FN, ...)                                                  \
  do {                                                                      \
    const int ks_ = k16_ks(hd);                                             \
    const int e_ = ks_ == 1   ? FN<1>(__VA_ARGS__)                          \
                   : ks_ == 2 ? FN<2>(__VA_ARGS__)                          \
                   : ks_ == 3 ? FN<3>(__VA_ARGS__)                          \
                              : FN<6>(__VA_ARGS__);                         \
    if (e_ != (int)cudaSuccess) return e_;                                  \
  } while (0)

// The mm16 form of bert_layer_forward: same arguments, layouts, dropout
// draws and saved residuals (bert_layer_resid_floats), scratch of
// bert_layer_scratch16_floats(); the residuals' log-sum-exp slot receives
// bf16(1 / den) of every (subject, head, query). Eight launches: the bf16
// weights, QKV, the head-major copies, attention, the out-projection, LN1,
// the FFN, LN2. Returns the cudaError_t of the first launch that fails, or
// of the last.
extern "C" int bert_layer_forward16(const float* x, const void* const* params, float* scratch,
                                    float* resid, float* out, int B, int T, int H, int F,
                                    int heads, int t_valid, int TP, int seed, double attn_rate,
                                    double hidden_rate, cudaStream_t stream) {
  if (k16_bad_dims(T, H, F, heads, t_valid, TP)) return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(params);
  const int M = B * T;
  const size_t MH = (size_t)M * H;
  float* base = resid ? resid : scratch;
  float *q = base, *k = q + MH, *v = k + MH, *ctx = v + MH;
  float *a1 = nullptr, *x1 = ctx + MH, *a2 = nullptr, *rden = nullptr;
  if (resid) {
    a1 = ctx + MH;
    x1 = a1 + MH;
    a2 = x1 + MH;
    rden = a2 + MH;
  }
  const K16FwdScratch L(B, T, H, F, heads);
  auto b16 = [&](long long off) { return reinterpret_cast<bf16_t*>(scratch + off); };
  float* zp = scratch + L.zp;
  bf16_t *w1b = b16(L.w1b), *w2b = b16(L.w2b), *wqkv = b16(L.wqkv), *wo = b16(L.wo);
  bf16_t *qh = b16(L.qh), *kh = b16(L.kh), *vh = b16(L.vh);
  const int hd = H / heads;
  const float eps = 1e-12f, scale = 1.f / sqrtf((float)hd);
  const Dropout d_attn = make_dropout(seed, 3, attn_rate);
  const Dropout d0 = make_dropout(seed, 0, hidden_rate);
  const Dropout d1 = make_dropout(seed, 1, hidden_rate);
  const int ln_blocks = (M + BERT_THREADS / 32 - 1) / (BERT_THREADS / 32);

  K16Weights W = {};
  W.job[0] = {{p[10]}, w1b, F, H, K16_KP, 0};
  W.job[1] = {{p[12]}, w2b, H, F, F, 0};
  for (int j = 0; j < 3; ++j) W.job[2 + j] = {{p[2 * j]}, wqkv + (size_t)j * H * K16_KP, H, H,
                                             K16_KP, 0};
  W.job[5] = {{p[6]}, wo, H, H, K16_KP, 0};
  CK(k16_weights(W, 6, stream));
  // q, k, v = x W^T + b
  K16Rows r = {};
  r.a32 = x; r.lda = H; r.M = M; r.N = H; r.K = H; r.ldc = H;
  for (int j = 0; j < 3; ++j) {
    r.b[j] = wqkv + (size_t)j * H * K16_KP;
    r.bias[j] = p[2 * j + 1];
  }
  r.c32[0] = q; r.c32[1] = k; r.c32[2] = v;
  CK(k16_rows<K16_KS>(r, 3, stream));
  K16Heads hp = {};
  const float* src[3] = {q, k, v};
  bf16_t* dst[3] = {qh, kh, vh};
  for (int j = 0; j < 3; ++j) {
    hp.src32[j] = src[j];
    hp.scale[j] = j == 0 ? scale : 1.f;
    hp.dst[j] = dst[j];
  }
  CK(k16_heads(hp, 3, B, T, H, heads, stream));
  K16_BY_KS(k16_attention_fwd, qh, kh, vh, ctx, rden, d_attn, B, T, TP, H, heads, t_valid,
            stream);
  // x1 = LN1((ctx Wo^T + bo) * m0 + x)
  r = {};
  r.a32 = ctx; r.lda = H; r.M = M; r.N = H; r.K = H; r.ldc = H;
  r.b[0] = wo;
  r.c32[0] = zp;
  CK(k16_rows<K16_KS>(r, 1, stream));
  bert_bias_res_ln_kernel<<<ln_blocks, BERT_THREADS, 0, stream>>>(
      zp, 1, p[7], x, p[8], p[9], d0, T, TP, M, H, eps, x1, a1);
  CK(cudaGetLastError());
  // out = LN2((GELU(x1 W1^T + b1) W2^T + b2) * m1 + x1)
  CK(allow_smem(k16_ffn_fwd_kernel, K16_FFN_FWD_SMEM));
  k16_ffn_fwd_kernel<<<dim3((M + K16_ROWS - 1) / K16_ROWS, L.slices), K16_THREADS,
                       K16_FFN_FWD_SMEM, stream>>>(
      x1, w1b, w2b, p[11], zp, M, H, F, F / K16_FC / L.slices);
  CK(cudaGetLastError());
  bert_bias_res_ln_kernel<<<ln_blocks, BERT_THREADS, 0, stream>>>(
      zp, L.slices, p[13], x1, p[14], p[15], d1, T, TP, M, H, eps, out, a2);
  return (int)cudaGetLastError();
}

// Scratch layout of bert_layer_backward16 (floats; bf16 buffers take half a
// float an element).
struct K16BwdScratch {
  long long dy2, dy1, dx1p, db1p, lnp2, lnp1, dbp, seg, tnp, dzb, xb, x1b, dab, ctxb, dctxb,
      dqkvb, gub, dub, w1b, w2b, wot, wqkvt, qh, kh, vh, gh, total;
  int slices, ln_blocks, tiles_q, splits, kchunk;
  long long tn_off[4], tn_ni[4];

  K16BwdScratch(int B, int T, int H, int F, int heads) {
    const long long M = (long long)B * T, MH = M * H, BHT = (long long)B * heads * T;
    slices = k16_slices((int)M, F, K16_BWD_PER_SM);
    ln_blocks = (int)((M + K16_LN_ROWS - 1) / K16_LN_ROWS);
    tiles_q = (T + K16_AT - 1) / K16_AT;
    // the dW products: 128-row tiles of F (dW1, dW2^T), H (dWo), 3H
    const long long ni[4] = {F, F, H, 3LL * H};
    long long tiles = 0;
    for (int j = 0; j < 4; ++j) tiles += (ni[j] + K16_TN_BI - 1) / K16_TN_BI;
    splits = (int)(264 / tiles);   // one wave of two blocks an SM
    if (splits > M / 64) splits = (int)(M / 64);
    if (splits < 1) splits = 1;
    kchunk = (int)(((M + splits - 1) / splits + K16_TN_BK - 1) / K16_TN_BK * K16_TN_BK);
    splits = (int)((M + kchunk - 1) / kchunk);
    long long tn = 0;
    for (int j = 0; j < 4; ++j) {
      tn_ni[j] = ni[j];
      tn_off[j] = tn;
      tn += k16_align(splits * ni[j] * H);
    }
    long long off = 0;
    dy2 = off; off += k16_align(MH);
    dy1 = off; off += k16_align(MH);
    dx1p = off; off += k16_align(slices * MH);
    db1p = off; off += k16_align(((M + K16_ROWS - 1) / K16_ROWS) * F);
    lnp2 = off; off += k16_align((long long)ln_blocks * 3 * H);
    lnp1 = off; off += k16_align((long long)ln_blocks * 3 * H);
    dbp = off; off += k16_align((long long)B * tiles_q * 3 * H);
    seg = off; off += k16_align(BHT);
    tnp = off; off += tn;
    dzb = off; off += k16_half(M * K16_KP);
    xb = off; off += k16_half(M * K16_KP);
    x1b = off; off += k16_half(M * K16_KP);
    dab = off; off += k16_half(M * K16_KP);
    ctxb = off; off += k16_half(M * K16_KP);
    dctxb = off; off += k16_half(MH);
    dqkvb = off; off += k16_half(M * K16_K3P);
    gub = off; off += k16_half(M * F);
    dub = off; off += k16_half(M * F);
    w1b = off; off += k16_half((long long)F * K16_KP);
    w2b = off; off += k16_half((long long)H * F);
    wot = off; off += k16_half((long long)H * K16_KP);
    wqkvt = off; off += k16_half((long long)H * K16_K3P);
    const long long BHTD = BHT * 16 * k16_ks(H / heads);
    qh = off; off += k16_half(BHTD);
    kh = off; off += k16_half(BHTD);
    vh = off; off += k16_half(BHTD);
    gh = off; off += k16_half(BHTD);
    total = off;
  }
};

extern "C" long long bert_layer_backward16_scratch_floats(int B, int T, int H, int F,
                                                          int heads) {
  return K16BwdScratch(B, T, H, F, heads).total;
}

// The mm16 form of bert_layer_backward: x, resid (from bert_layer_forward16
// with the same seed and rates), g, params, grads and dx as there; scratch
// of bert_layer_backward16_scratch_floats(). Eleven launches: the bf16
// weights; LN2's backward; the FFN row pass (GELU(U) and DU stored as bf16,
// dx1's slices, db1's partials); LN1's backward (adds dy2 and dx1's slices);
// dctx = da Wo; the head-major copies; dq (with seg); dk, dv; the four dW
// products; dx = dy1 + [dq dk dv] [Wq; Wk; Wv] (one product, K = 3H); every
// cross-block sum.
extern "C" int bert_layer_backward16(const float* x, const float* resid, const float* g,
                                     const void* const* params, void* const* grads, float* dx,
                                     float* scratch, int B, int T, int H, int F, int heads,
                                     int t_valid, int TP, int seed, double attn_rate,
                                     double hidden_rate, cudaStream_t stream) {
  if (k16_bad_dims(T, H, F, heads, t_valid, TP)) return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(params);
  float* const* dp = reinterpret_cast<float* const*>(grads);
  const int M = B * T;
  const size_t MH = (size_t)M * H;
  const float *q = resid, *k = q + MH, *v = k + MH, *ctx = v + MH, *a1 = ctx + MH;
  const float *x1 = a1 + MH, *a2 = x1 + MH, *rden = a2 + MH;
  const K16BwdScratch L(B, T, H, F, heads);
  auto f32 = [&](long long off) { return scratch + off; };
  auto b16 = [&](long long off) { return reinterpret_cast<bf16_t*>(scratch + off); };
  float *dy2 = f32(L.dy2), *dy1 = f32(L.dy1), *dx1p = f32(L.dx1p), *db1p = f32(L.db1p);
  float *lnp2 = f32(L.lnp2), *lnp1 = f32(L.lnp1), *dbp = f32(L.dbp), *seg = f32(L.seg);
  bf16_t *dzb = b16(L.dzb), *xb = b16(L.xb), *x1b = b16(L.x1b), *dab = b16(L.dab);
  bf16_t *ctxb = b16(L.ctxb), *dctxb = b16(L.dctxb), *dqkvb = b16(L.dqkvb);
  bf16_t *gub = b16(L.gub), *dub = b16(L.dub), *w1b = b16(L.w1b), *w2b = b16(L.w2b);
  bf16_t *wot = b16(L.wot), *wqkvt = b16(L.wqkvt);
  bf16_t *qh = b16(L.qh), *kh = b16(L.kh), *vh = b16(L.vh), *gh = b16(L.gh);
  const Dropout d_attn = make_dropout(seed, 3, attn_rate);
  const Dropout d0 = make_dropout(seed, 0, hidden_rate);
  const Dropout d1 = make_dropout(seed, 1, hidden_rate);
  const int hd = H / heads;
  const float scale = 1.f / sqrtf((float)hd);
  const int row_tiles = (M + K16_ROWS - 1) / K16_ROWS;

  // W1, W2 for the FFN; Wo^T (dctx = da Wo) and [Wq; Wk; Wv]^T (dx)
  K16Weights W = {};
  W.job[0] = {{p[10]}, w1b, F, H, K16_KP, 0};
  W.job[1] = {{p[12]}, w2b, H, F, F, 0};
  W.job[2] = {{p[6]}, wot, H, H, K16_KP, 1};
  W.job[3] = {{p[0], p[2], p[4]}, wqkvt, H, 3 * H, K16_K3P, 1};
  CK(k16_weights(W, 4, stream));
  // ---- FFN side ----------------------------------------------------------
  // dy2 = LN2'(g) over the saved a2, bf16(dz = dy2 m1), bf16(x)
  K16Ln ln = {};
  ln.gin = g; ln.pre = a2; ln.gamma = p[14]; ln.drop = d1;
  ln.dres = dy2; ln.dmask16 = dzb; ln.copy_src = x; ln.copy_dst = xb;
  ln.part = lnp2; ln.T = T; ln.TP = TP; ln.M = M; ln.H = H;
  k16_ln_bwd_kernel<<<L.ln_blocks, BERT_THREADS, 0, stream>>>(ln);
  CK(cudaGetLastError());
  CK(allow_smem(k16_ffn_bwd_kernel, K16FfnBwdSmem::BYTES));
  k16_ffn_bwd_kernel<<<dim3(row_tiles, L.slices), K16_THREADS, K16FfnBwdSmem::BYTES, stream>>>(
      x1, dzb, w1b, w2b, p[11], gub, dub, db1p, dx1p, x1b, M, H, F, F / K16_FC / L.slices);
  CK(cudaGetLastError());

  // ---- attention side ------------------------------------------------------
  // dx1 = dy2 + the slices' DU W1; dy1 = LN1'(dx1) over the saved a1,
  // bf16(da = dy1 m0), bf16(ctx), dqkvb's pad columns zeroed
  ln = {};
  ln.gin = dy2; ln.gparts = dx1p; ln.nparts = L.slices; ln.pre = a1; ln.gamma = p[8];
  ln.drop = d0; ln.dres = dy1; ln.dmask16 = dab; ln.copy_src = ctx; ln.copy_dst = ctxb;
  ln.pad_dst = dqkvb; ln.pad_ld = K16_K3P; ln.pad_from = 3 * H;
  ln.part = lnp1; ln.T = T; ln.TP = TP; ln.M = M; ln.H = H;
  k16_ln_bwd_kernel<<<L.ln_blocks, BERT_THREADS, 0, stream>>>(ln);
  CK(cudaGetLastError());
  // dctx = bf16(da) Wo, stored as bf16 (the scores' backward rounds it)
  K16Rows r = {};
  r.a16 = dab; r.lda = K16_KP; r.M = M; r.N = H; r.K = H; r.ldc = H;
  r.b[0] = wot;
  r.c16 = dctxb;
  CK(k16_rows<K16_KS>(r, 1, stream));
  K16Heads hp = {};
  const float* src[3] = {q, k, v};
  bf16_t* dst[4] = {qh, kh, vh, gh};
  for (int j = 0; j < 4; ++j) {
    if (j < 3) hp.src32[j] = src[j];
    hp.scale[j] = j == 0 ? scale : 1.f;
    hp.dst[j] = dst[j];
  }
  hp.src16[3] = dctxb;
  CK(k16_heads(hp, 4, B, T, H, heads, stream));
  K16_BY_KS(k16_attention_bwd, qh, kh, vh, gh, rden, seg, dqkvb, K16_K3P, dbp, d_attn, B, T, TP,
            H, heads, t_valid, scale, stream);

  // ---- the four dW products in one launch ---------------------------------
  K16Tn tn = {};
  const bf16_t* P[4] = {dub, gub, dab, dqkvb};
  const int ldp[4] = {F, F, K16_KP, K16_K3P};
  const bf16_t* Q[4] = {x1b, dzb, ctxb, xb};
  int blocks = 0;
  for (int j = 0; j < 4; ++j) {
    K16TnJob& J = tn.job[j];
    J.P = P[j]; J.ldp = ldp[j]; J.ni = (int)L.tn_ni[j]; J.Q = Q[j];
    J.part = f32(L.tnp + L.tn_off[j]);
    J.tiles_i = (J.ni + K16_TN_BI - 1) / K16_TN_BI;
    J.first_block = blocks;
    J.trans = j == 1;
    blocks += J.tiles_i * L.splits;
  }
  tn.njobs = 4; tn.splits = L.splits; tn.kchunk = L.kchunk; tn.M = M; tn.nj = H;
  tn.ldq = K16_KP;
  k16_tn_kernel<<<blocks, K16_TN_THREADS, 0, stream>>>(tn);
  CK(cudaGetLastError());

  // dx = dy1 + bf16([dq dk dv]) bf16([Wq; Wk; Wv]), K = 3H
  r = {};
  r.a16 = dqkvb; r.lda = K16_K3P; r.M = M; r.N = H; r.K = 3 * H; r.ldc = H;
  r.b[0] = wqkvt;
  r.add = dy1;
  r.c32[0] = dx;
  CK(k16_rows<K16_K3KS>(r, 1, stream));

  // ---- every cross-block sum, in order --------------------------------------
  K16Reduce red = {};
  int ns = 0, nmax = 0;
  auto seg_add = [&](const float* part, long long stride, int S, int n, float* dst) {
    red.seg[ns++] = {part, stride, S, n, dst};
    if (n > nmax) nmax = n;
  };
  for (int j = 0; j < 3; ++j) {   // LN2: dgamma2, dbeta2, db2; LN1: dgamma1, dbeta1, dbo
    seg_add(lnp2 + j * H, 3 * H, L.ln_blocks, H, dp[j == 0 ? 14 : j == 1 ? 15 : 13]);
    seg_add(lnp1 + j * H, 3 * H, L.ln_blocks, H, dp[j == 0 ? 8 : j == 1 ? 9 : 7]);
    seg_add(dbp + j * H, 3 * H, B * L.tiles_q, H, dp[2 * j + 1]);   // dbq, dbk, dbv
    seg_add(f32(L.tnp + L.tn_off[3]) + (long long)j * H * H, 3LL * H * H, L.splits, H * H,
            dp[2 * j]);                                               // dWq, dWk, dWv
  }
  seg_add(db1p, F, row_tiles, F, dp[11]);
  seg_add(f32(L.tnp + L.tn_off[0]), (long long)F * H, L.splits, F * H, dp[10]);
  seg_add(f32(L.tnp + L.tn_off[1]), (long long)F * H, L.splits, F * H, dp[12]);
  seg_add(f32(L.tnp + L.tn_off[2]), (long long)H * H, L.splits, H * H, dp[6]);
  int rb = (nmax + 31) / 32;
  if (rb > 1024) rb = 1024;
  k16_reduce_kernel<<<dim3(rb, ns), 256, 0, stream>>>(red);
  return (int)cudaGetLastError();
}

// ===========================================================================
// The float32 forward on tensor cores (bert_layer_forward). Every dense
// product (QKV, Wo, x1 W1^T, GELU(u) W2^T) runs on mma.sync.m16n8k8 in the
// 3xTF32 form of the backward's tc_gemm_kernel: each operand x split into
// big = tf32(x) and small = tf32(x - big), small_a big_b + big_a small_b
// accumulated beside big_a big_b in float32 and added at the end
// (ops/bert_layer.py matmul_3xtf32; bert_layer_model_tf32 models the
// decomposition). The attention (~10% of the operations), GELU and both
// LayerNorms stay float32 on the CUDA cores. The attention's scores stay
// bitwise the float32 ones the backward rebuilds p from: scores on TF32
// tensor cores were faster but moved the key bias's gradient, zero in exact
// arithmetic, past its float32 noise floor.
//
// What bounds it on the H100: the FFN's products, ~90% of the operations,
// 3x over at the TF32 tensor rate; in this design, the shared-memory loads
// that feed them (the FFN's ~110 16-byte warp loads a warp and chunk against
// 264 mma: probes with fewer W1 loads ran faster, one that ran 1xTF32 did
// not). Every operand reaches the tensor cores as (big, small) pairs, and
// the k index of every product is permuted within each k8 step (k slot t
// <-> column 2t, slot t + 4 <-> 2t + 1): a lane's A or B operands are then
// one 16-byte (big, small, big, small) shared load, and the two columns a
// lane holds of a C fragment are the A slots the next product needs, with
// no shuffle. Design, five launches (six where the F slices need adding):
//   1. t32_weights_kernel splits the weights once a call into pairs: W1
//      (F, KP, 2), W2 (H, F, 2), Wq, Wk, Wv, Wo (H, KP, 2), KP = 8 KS the
//      hidden width padded to k8 steps (KS = 11 for H <= 88).
//   2. t32_rows_kernel: QKV, 64-row tiles x {q, k, v}; a warp owns 16 rows
//      and all H outputs, its A fragments split in registers straight from
//      device memory, the weight's pairs staged once a block; it writes
//      float32 q, k and v.
//   3. bert_attention_kernel on the CUDA cores in float32, register-blocked
//      (two or four queries a lane group, the head dim 7 compiled in).
//   4. t32_rows_kernel on Wo with the LN epilogue: + bo, dropout 0, + x,
//      LN1 (the row statistics from quad shuffles of the C fragments).
//   5. t32_ffn_kernel: row tiles x F slices; the x1 tile split once into
//      shared memory; per chunk of the slice (W1 and W2 chunk pairs through
//      a cp.async ring), u = x1 W1c^T, then GELU(u + b1) on the C
//      fragments, split, is the A fragment of z += GELU(u) W2c^T. GELU(u)
//      never leaves the registers. With one slice the block applies + b2,
//      dropout 1, + x1 and LN2 itself;
//   6. otherwise bert_bias_res_ln_kernel adds the slices' partials in order.
// Each slice takes a contiguous run of chunks (t32_slices picks the count
// that fills the card's waves); every sum has a fixed order, so a call is
// bitwise repeatable.
// ===========================================================================

#define T32_RWARPS 4                     // warps of the row kernel
#define T32_RROWS (16 * T32_RWARPS)
#define T32_MAXSLICE 16

// floats of a shared row of (big, small) pairs over 8 KS columns: 16 KS,
// padded to 16 mod 32 so that the 16-byte fragment loads of a quarter warp
// (rows g, g + 1; lanes t) fall on distinct banks
__host__ __device__ constexpr int t32_pld(int KS) { return KS % 2 ? 16 * KS : 16 * KS + 16; }

__device__ __forceinline__ uint32_t t32_bits(float v) { return __float_as_uint(v); }

// one 16-byte cp.async (addresses 16-byte aligned)
__device__ __forceinline__ void t32_cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(tc_smem(dst)), "l"(src));
}

// ---- the weights as (big, small) TF32 pairs ------------------------------------------
//
// dst[(r ld + c) 2 + s] = split(w[r cols + c])[s] for c < cols, 0 past it.
struct T32WJob {
  const float* w;
  float* dst;
  int rows, cols, ld;
};

#define T32_MAXW 6

struct T32Weights {
  T32WJob job[T32_MAXW];
};

__global__ void __launch_bounds__(256) t32_weights_kernel(T32Weights W) {
  const T32WJob& J = W.job[blockIdx.y];
  const int n = J.rows * J.ld;
  for (int e = blockIdx.x * 256 + threadIdx.x; e < n; e += gridDim.x * 256) {
    const int r = e / J.ld, c = e % J.ld;
    uint32_t big = 0u, small = 0u;
    if (c < J.cols) tf32_split(J.w[(size_t)r * J.cols + c], big, small);
    reinterpret_cast<float2*>(J.dst)[e] = make_float2(__uint_as_float(big), __uint_as_float(small));
  }
}

// c += a b three times over: the small terms into cs, big_a big_b into c.
// ab / as: the A fragment's big and small halves; w: {b0 big, b0 small,
// b1 big, b1 small} of the B fragment.
__device__ __forceinline__ void t32_mma3(float (&c)[4], float (&cs)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], const float4& w) {
  mma_tf32(cs, as, t32_bits(w.x), t32_bits(w.z));
  mma_tf32(cs, ab, t32_bits(w.y), t32_bits(w.w));
  mma_tf32(c, ab, t32_bits(w.x), t32_bits(w.z));
}

// The LN epilogue of a warp's 16 rows r0 .. r0 + 15 (lane (g, t) holds rows
// r0 + g and r0 + g + 8, columns 8 nb + 2t + e of c + cs): v = (c + cs +
// bias) * keep + res, saved to pre where it is not NULL; out = LN(v) with
// gamma, beta (two-pass over the quad's H columns).
template <int KS>
__device__ __forceinline__ void t32_ln_rows(const float (&c)[KS][4], const float (&cs)[KS][4],
                                            int r0, int M, int H, const float* __restrict__ bias,
                                            const Dropout& drop, int T, int TP,
                                            const float* __restrict__ res,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta, float eps,
                                            float* __restrict__ pre, float* __restrict__ out,
                                            int g, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + g + 8 * hh;
    const bool live = row < M;
    const uint32_t rr = live ? (uint32_t)(row / T * TP + row % T) : 0u;   // padded row
    float v[KS][2];
    float s = 0.f;
#pragma unroll
    for (int nb = 0; nb < KS; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nb + 2 * t + e;
        float x = 0.f;
        if (live && col < H) {
          x = (c[nb][2 * hh + e] + cs[nb][2 * hh + e] + __ldg(bias + col)) * keep(drop, rr, col) +
              res[(size_t)row * H + col];
          if (pre) pre[(size_t)row * H + col] = x;
        }
        v[nb][e] = x;
        s += x;
      }
    s += __shfl_xor_sync(MNT_FULL_MASK, s, 1);
    s += __shfl_xor_sync(MNT_FULL_MASK, s, 2);
    const float mu = s / H;
    float ss = 0.f;
#pragma unroll
    for (int nb = 0; nb < KS; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * nb + 2 * t + e < H) {
          const float d = v[nb][e] - mu;
          ss = fmaf(d, d, ss);
        }
    ss += __shfl_xor_sync(MNT_FULL_MASK, ss, 1);
    ss += __shfl_xor_sync(MNT_FULL_MASK, ss, 2);
    const float r = 1.f / sqrtf(ss / H + eps);
    if (!live) continue;
#pragma unroll
    for (int nb = 0; nb < KS; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nb + 2 * t + e;
        if (col < H)
          out[(size_t)row * H + col] = (v[nb][e] - mu) * r * __ldg(gamma + col) + __ldg(beta + col);
      }
  }
}

// ---- products of the hidden width ---------------------------------------------------
//
// C = A W^T + bias for M rows (A (M, H) float32), W one of the (H, KP, 2)
// split weights; grid (ceil(M / T32_RROWS), Y): block y takes w[y], bias[y],
// c[y]. With ln, block 0's rows go through t32_ln_rows (res, gamma, beta,
// drop, pre) into c[0] instead. Dynamic shared memory: the weight's pairs,
// [8 KS][t32_pld(KS)] floats (rows >= H zero).
struct T32Rows {
  const float* a;
  const float* w[3];
  const float* bias[3];
  float* c[3];
  int M, H;
  int ln;
  const float *res, *gamma, *beta;
  float* pre;
  Dropout drop;
  int T, TP;
};

template <int KS>
__global__ void __launch_bounds__(32 * T32_RWARPS) t32_rows_kernel(T32Rows P) {
  extern __shared__ __align__(16) float t32s[];
  constexpr int LD = t32_pld(KS);
  const float* W = P.w[blockIdx.y];
  for (int i = threadIdx.x; i < 8 * KS * 4 * KS; i += 32 * T32_RWARPS) {   // 4 KS copies a row
    const int r = i / (4 * KS), c = (i % (4 * KS)) * 4;
    if (r < P.H) t32_cp16(t32s + r * LD + c, W + (size_t)r * 16 * KS + c);
    else *reinterpret_cast<float4*>(t32s + r * LD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  k16_commit();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * T32_RROWS + warp * 16;
  const int M = P.M, H = P.H;
  // the warp's A values, all loads in flight at once (beside the staging):
  // a0 (g, slot t), a1 (g + 8, slot t), a2 (g, slot t + 4), a3 (g + 8,
  // slot t + 4) of each k8 step; slot t is column 8 kk + 2t, slot t + 4
  // column 8 kk + 2t + 1
  float av[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + g + 8 * (q & 1), col = 8 * kk + 2 * t + (q >> 1);
      av[kk][q] = row < M && col < H ? __ldg(P.a + (size_t)row * H + col) : 0.f;
    }
  float c[KS][4], cs[KS][4];
#pragma unroll
  for (int nb = 0; nb < KS; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] = cs[nb][e] = 0.f;
  k16_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t ab[4], as[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) tf32_split(av[kk][q], ab[q], as[q]);
#pragma unroll
    for (int nb = 0; nb < KS; ++nb)
      t32_mma3(c[nb], cs[nb], ab, as,
               *reinterpret_cast<const float4*>(t32s + (8 * nb + g) * LD + 16 * kk + 4 * t));
  }
  const int y = blockIdx.y;
  if (P.ln) {
    t32_ln_rows<KS>(c, cs, r0, M, H, P.bias[0], P.drop, P.T, P.TP, P.res, P.gamma, P.beta,
                    1e-12f, P.pre, P.c[0], g, t);
    return;
  }
  float* dst = P.c[y];
  const float* bias = P.bias[y];
#pragma unroll
  for (int nb = 0; nb < KS; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), col = 8 * nb + 2 * t + (e & 1);
      if (row < M && col < H) dst[(size_t)row * H + col] = c[nb][e] + cs[nb][e] + __ldg(bias + col);
    }
}

// ---- the FFN ----------------------------------------------------------------------
//
// grid (ceil(M / T32_FROWS), slices), 32 T32_FWARPS threads (one block an
// SM); slice s takes chunks [s chunks / slices, (s + 1) chunks / slices) of
// T32_FC columns. Shared memory (floats): the x1 tile's pairs [T32_FROWS][LD],
// then a ring of two stages, each a W1 chunk [T32_FC][LD] and a W2 chunk
// [8 KS][2 T32_FC + 16] (rows >= H zero); one barrier a chunk. Probed on an
// H100: 4 warps at two blocks an SM, 16-column chunks, three stages, single
// accumulators and x1's fragments held in registers were none faster at
// every batch than this shape. slices == 1: the LN2 epilogue
// (T32Rows' LN fields give b2, dropout 1, x1 as the residual, gamma, beta,
// a2 as pre, out); else the slice's z partial goes to zp[slice].
#define T32_FWARPS 8
#define T32_FROWS (16 * T32_FWARPS)
#define T32_FC 32
#define T32_FSTAGES 2

template <int KS>
struct T32Ffn {
  static constexpr int LD = t32_pld(KS);
  static constexpr int W2LD = 2 * T32_FC + 16;   // 16 mod 32
  static constexpr int X = T32_FROWS * LD;
  static constexpr int W1 = T32_FC * LD;
  static constexpr int STAGE = W1 + 8 * KS * W2LD;
  static constexpr int BYTES = (X + T32_FSTAGES * STAGE) * (int)sizeof(float);
};

template <int KS>
__global__ void __launch_bounds__(32 * T32_FWARPS, 1)
t32_ffn_kernel(const float* __restrict__ x1, const float* __restrict__ w1s,
               const float* __restrict__ w2s, const float* __restrict__ b1m, float* __restrict__ zp,
               int F, int slices, T32Rows P) {
  using S = T32Ffn<KS>;
  constexpr int LD = S::LD, NT = 32 * T32_FWARPS, FC = T32_FC, STAGES = T32_FSTAGES;
  extern __shared__ __align__(16) float t32s[];
  float* xs = t32s;
  float* ring = t32s + S::X;
  const int M = P.M, H = P.H;
  const int chunks = F / FC;
  const int cb = (int)((long long)blockIdx.y * chunks / slices);
  const int nch = (int)((long long)(blockIdx.y + 1) * chunks / slices) - cb;
  const int rb = blockIdx.x * T32_FROWS;
  auto stage = [&](int buf, int chunk) {
    float* w1 = ring + buf * S::STAGE;
    float* w2 = w1 + S::W1;
    const int f0 = chunk * FC;
    for (int i = threadIdx.x; i < FC * 4 * KS; i += NT) {
      const int j = i / (4 * KS), c = (i % (4 * KS)) * 4;
      t32_cp16(w1 + j * LD + c, w1s + (size_t)(f0 + j) * 16 * KS + c);
    }
    for (int i = threadIdx.x; i < H * (FC / 2); i += NT) {
      const int h = i / (FC / 2), c = (i % (FC / 2)) * 4;
      t32_cp16(w2 + h * S::W2LD + c, w2s + ((size_t)h * F + f0) * 2 + c);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nch) stage(st, cb + st);
    k16_commit();
  }
  // the W2 rows >= H of every stage stay zero; the x1 tile, split
  for (int st = 0; st < STAGES; ++st)
    for (int i = threadIdx.x; i < (8 * KS - H) * S::W2LD; i += NT)
      ring[st * S::STAGE + S::W1 + H * S::W2LD + i] = 0.f;
  for (int i = threadIdx.x; i < T32_FROWS * 8 * KS; i += NT) {
    const int r = i / (8 * KS), h = i % (8 * KS);
    uint32_t big = 0u, small = 0u;
    if (rb + r < M && h < H) tf32_split(x1[(size_t)(rb + r) * H + h], big, small);
    *reinterpret_cast<float2*>(xs + r * LD + 2 * h) =
        make_float2(__uint_as_float(big), __uint_as_float(small));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* xa = xs + (warp * 16 + g) * LD + 4 * t;   // rows g and g + 8 of the warp
  float z[KS][4], zs[KS][4];
#pragma unroll
  for (int nb = 0; nb < KS; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[nb][e] = zs[nb][e] = 0.f;

  for (int ci = 0; ci < nch; ++ci) {
    // chunk ci is in (this thread's copies waited for, then every thread's),
    // and every warp is done with chunk ci - 1, whose stage takes chunk ci
    // + STAGES - 1
    k16_wait<STAGES - 2>();
    __syncthreads();
    if (ci + STAGES - 1 < nch) stage((ci + STAGES - 1) % STAGES, cb + ci + STAGES - 1);
    k16_commit();
    const float* w1 = ring + (ci % STAGES) * S::STAGE;
    const float* w2 = w1 + S::W1;
    const int f0 = (cb + ci) * FC;
    // u = x1 W1c^T: 16 rows x FC columns a warp
    float u[FC / 8][4], us[FC / 8][4];
#pragma unroll
    for (int nb = 0; nb < FC / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) u[nb][e] = us[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 lo = *reinterpret_cast<const float4*>(xa + 16 * kk);            // row g
      const float4 hi = *reinterpret_cast<const float4*>(xa + 8 * LD + 16 * kk);   // row g + 8
      const uint32_t ab[4] = {t32_bits(lo.x), t32_bits(hi.x), t32_bits(lo.z), t32_bits(hi.z)};
      const uint32_t as[4] = {t32_bits(lo.y), t32_bits(hi.y), t32_bits(lo.w), t32_bits(hi.w)};
#pragma unroll
      for (int nb = 0; nb < FC / 8; ++nb)
        t32_mma3(u[nb], us[nb], ab, as,
                 *reinterpret_cast<const float4*>(w1 + (8 * nb + g) * LD + 16 * kk + 4 * t));
    }
    // GELU(u + b1) on the C fragments (row g / g + 8, columns 2t, 2t + 1 of
    // n8 block p), split: the A fragment of k8 step p of z += GELU(u) W2c^T
#pragma unroll
    for (int p = 0; p < FC / 8; ++p) {
      const float bb0 = __ldg(b1m + f0 + 8 * p + 2 * t), bb1 = __ldg(b1m + f0 + 8 * p + 2 * t + 1);
      uint32_t ab[4], as[4];
      tf32_split(gelu_erf(u[p][0] + us[p][0] + bb0), ab[0], as[0]);
      tf32_split(gelu_erf(u[p][2] + us[p][2] + bb0), ab[1], as[1]);
      tf32_split(gelu_erf(u[p][1] + us[p][1] + bb1), ab[2], as[2]);
      tf32_split(gelu_erf(u[p][3] + us[p][3] + bb1), ab[3], as[3]);
#pragma unroll
      for (int nb = 0; nb < KS; ++nb)
        t32_mma3(z[nb], zs[nb], ab, as,
                 *reinterpret_cast<const float4*>(w2 + (8 * nb + g) * S::W2LD + 16 * p + 4 * t));
    }
  }
  k16_wait<0>();
  const int r0 = rb + warp * 16;
  if (slices == 1) {
    t32_ln_rows<KS>(z, zs, r0, M, H, P.bias[0], P.drop, P.T, P.TP, P.res, P.gamma, P.beta,
                    1e-12f, P.pre, P.c[0], g, t);
    return;
  }
  float* dst = zp + (size_t)blockIdx.y * M * H;
#pragma unroll
  for (int nb = 0; nb < KS; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), col = 8 * nb + 2 * t + (e & 1);
      if (row < M && col < H) dst[(size_t)row * H + col] = z[nb][e] + zs[nb][e];
    }
}

// F slices of the FFN kernel's row tiles (one block an SM): the fewest whose
// blocks fill at least 85% of the waves they take, at most T32_MAXSLICE and
// the chunk count.
static int t32_sms() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

static int t32_slices(int M, int F) {
  const long long tiles = (M + T32_FROWS - 1) / T32_FROWS, slots = t32_sms();
  int cap = F / T32_FC;
  if (cap > T32_MAXSLICE) cap = T32_MAXSLICE;
  for (int s = 1; s < cap; ++s) {
    const long long blocks = tiles * s, waves = (blocks + slots - 1) / slots;
    if (100 * blocks >= 85 * waves * slots) return s;
  }
  return cap;
}

// k8 steps of the padded hidden width: 11 for H <= 88, else 12 (H <= 96).
static int t32_ks(int H) { return H <= 88 ? 11 : 12; }

// Scratch layout of bert_layer_forward (floats): q, k, v, ctx, x1 where no
// residuals are saved, the FFN slices' partials (with more than one), the
// split weights.
struct T32FwdScratch {
  long long zp, w1s, w2s, wr, total;
  int slices, KS;

  T32FwdScratch(int B, int T, int H, int F) {
    const long long M = (long long)B * T, MH = M * H;
    KS = t32_ks(H);
    const long long KP = 8LL * KS;
    slices = t32_slices((int)M, F);
    long long off = k16_align(5 * MH);
    zp = off; off += slices > 1 ? k16_align(slices * MH) : 0;
    w1s = off; off += k16_align(2 * F * KP);
    w2s = off; off += k16_align(2LL * H * F);
    wr = off; off += k16_align(4 * 2 * H * KP);
    total = off;
  }
};

// Floats of device scratch bert_layer_forward needs.
extern "C" long long bert_layer_scratch_floats(int B, int T, int H, int F) {
  return T32FwdScratch(B, T, H, F).total;
}

template <int KS>
static cudaError_t t32_forward(const float* x, const float* const* p, float* scratch,
                               const T32FwdScratch& L, float* q, float* k, float* v, float* ctx,
                               float* a1, float* x1, float* a2, float* lse, float* out, int B,
                               int T, int H, int F, int heads, int t_valid, int TP,
                               const Dropout& d_attn, const Dropout& d0, const Dropout& d1,
                               cudaStream_t stream) {
  const int M = B * T, KP = 8 * KS;
  float *w1s = scratch + L.w1s, *w2s = scratch + L.w2s, *wr = scratch + L.wr;
  const size_t wsz = 2 * (size_t)H * KP;   // floats of one split H x H weight
  T32Weights W = {};
  W.job[0] = {p[10], w1s, F, H, KP};
  W.job[1] = {p[12], w2s, H, F, F};
  for (int j = 0; j < 4; ++j) W.job[2 + j] = {p[2 * j], wr + j * wsz, H, H, KP};
  t32_weights_kernel<<<dim3(128, 6), 256, 0, stream>>>(W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // q, k, v = x W^T + b
  const size_t smem_rows = (size_t)8 * KS * t32_pld(KS) * sizeof(float);
  if ((err = allow_smem(t32_rows_kernel<KS>, smem_rows)) != cudaSuccess) return err;
  const int row_tiles = (M + T32_RROWS - 1) / T32_RROWS;
  T32Rows r = {};
  r.a = x; r.M = M; r.H = H;
  float* qkv[3] = {q, k, v};
  for (int j = 0; j < 3; ++j) {
    r.w[j] = wr + j * wsz;
    r.bias[j] = p[2 * j + 1];
    r.c[j] = qkv[j];
  }
  t32_rows_kernel<KS><<<dim3(row_tiles, 3), 32 * T32_RWARPS, smem_rows, stream>>>(r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // the attention on the CUDA cores in the float32 arithmetic of the
  // backward's rebuild of p (which takes the key-bias gradient, zero in
  // exact arithmetic, to its float32 noise floor), four queries a lane group
  // where that still gives every SM four blocks, else two
  const int groups = B * heads * ((T + 4 * BERT_ATTN_QUERIES - 1) / (4 * BERT_ATTN_QUERIES));
  err = groups >= 4 * t32_sms() ? bert_attention<4, true>(q, k, v, ctx, lse, d_attn, B, T, TP, H,
                                                     heads, t_valid, stream)
                          : bert_attention<2, true>(q, k, v, ctx, lse, d_attn, B, T, TP, H,
                                                     heads, t_valid, stream);
  if (err != cudaSuccess) return err;

  // x1 = LN1((ctx Wo^T + bo) * m0 + x)
  r = {};
  r.a = ctx; r.M = M; r.H = H;
  r.w[0] = wr + 3 * wsz;
  r.bias[0] = p[7];
  r.c[0] = x1;
  r.ln = 1; r.res = x; r.gamma = p[8]; r.beta = p[9]; r.pre = a1;
  r.drop = d0; r.T = T; r.TP = TP;
  t32_rows_kernel<KS><<<dim3(row_tiles, 1), 32 * T32_RWARPS, smem_rows, stream>>>(r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // out = LN2((GELU(x1 W1^T + b1) W2^T + b2) * m1 + x1)
  r.a = x1;
  r.w[0] = nullptr;
  r.bias[0] = p[13];
  r.c[0] = out;
  r.res = x1; r.gamma = p[14]; r.beta = p[15]; r.pre = a2;
  r.drop = d1;
  const size_t smem_ffn = T32Ffn<KS>::BYTES;
  if ((err = allow_smem(t32_ffn_kernel<KS>, smem_ffn)) != cudaSuccess) return err;
  float* zp = scratch + L.zp;
  t32_ffn_kernel<KS><<<dim3((M + T32_FROWS - 1) / T32_FROWS, L.slices), 32 * T32_FWARPS, smem_ffn,
                       stream>>>(x1, w1s, w2s, p[11], zp, F, L.slices, r);
  if ((err = cudaGetLastError()) != cudaSuccess || L.slices == 1) return err;
  const int ln_blocks = (M + BERT_THREADS / 32 - 1) / (BERT_THREADS / 32);
  bert_bias_res_ln_kernel<<<ln_blocks, BERT_THREADS, 0, stream>>>(
      zp, L.slices, p[13], x1, p[14], p[15], d1, T, TP, M, H, 1e-12f, out, a2);
  return cudaGetLastError();
}

// x, out: (B, T, H) f32 contiguous; scratch: bert_layer_scratch_floats()
// floats of device memory. params: host array of 16 device pointers in the
// JAX kernel's order
//   wq bq wk bk wv bv wo bo g1 b1 w1 b1m w2 b2m g2 b2
// with weights in torch (out, in) layout. Keys >= t_valid are masked out.
// Training: resid (bert_layer_resid_floats() floats) receives the residuals
// the backward consumes, and the dropout draws (attention 3 at attn_rate,
// hidden 0 and 1 at hidden_rate, from seed) use the JAX kernel's padded
// coordinates with TP = round_up(T, 8) rows a subject. Inference: resid
// NULL and both rates 0. Needs H <= 96, heads dividing H and F % 32 == 0.
// Returns the cudaError_t of the first launch that fails, or of the last.
extern "C" int bert_layer_forward(const float* x, const void* const* params, float* scratch,
                                  float* resid, float* out, int B, int T, int H, int F,
                                  int heads, int t_valid, int TP, int seed, double attn_rate,
                                  double hidden_rate, cudaStream_t stream) {
  if (bert_bad_dims(T, H, F, heads, t_valid, TP)) return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(params);
  const size_t MH = (size_t)B * T * H;
  float* base = resid ? resid : scratch;
  float *q = base, *k = q + MH, *v = k + MH, *ctx = v + MH;
  float *a1 = nullptr, *x1 = ctx + MH, *a2 = nullptr, *lse = nullptr;
  if (resid) {
    a1 = ctx + MH;
    x1 = a1 + MH;
    a2 = x1 + MH;
    lse = a2 + MH;
  }
  const T32FwdScratch L(B, T, H, F);
  const Dropout d_attn = make_dropout(seed, 3, attn_rate);
  const Dropout d0 = make_dropout(seed, 0, hidden_rate);
  const Dropout d1 = make_dropout(seed, 1, hidden_rate);
  const cudaError_t err =
      L.KS == 11 ? t32_forward<11>(x, p, scratch, L, q, k, v, ctx, a1, x1, a2, lse, out, B, T, H,
                                   F, heads, t_valid, TP, d_attn, d0, d1, stream)
                 : t32_forward<12>(x, p, scratch, L, q, k, v, ctx, a1, x1, a2, lse, out, B, T, H,
                                   F, heads, t_valid, TP, d_attn, d0, d1, stream);
  return (int)err;
}
