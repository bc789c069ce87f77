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
// ~90% of the layer's 1.5 GFLOP at B = 4, T = 369. It is compute-bound on
// the CUDA cores in f32 (the port keeps f32 products, no TF32), and its
// (T, 3072) intermediate would be 18 MB a subject-layer if written out.
// Design, four kernels launched back to back on one stream:
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

template <int MAXHD>
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ ctx,
                      float* __restrict__ lse, Dropout drop, int T, int TP, int H, int hd,
                      int t_valid, float scale) {
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
  // BERT_ATTN_SPLIT consecutive lanes share one query and take every
  // BERT_ATTN_SPLIT-th key; all lanes stay live for the shuffles
  const int part = threadIdx.x % BERT_ATTN_SPLIT;
  const int i = blockIdx.x * BERT_ATTN_QUERIES + threadIdx.x / BERT_ATTN_SPLIT;
  const bool live = i < T;
  const size_t qrow = (row0 + (live ? i : 0)) * H + h * hd;
  float qi[MAXHD];
#pragma unroll
  for (int d = 0; d < MAXHD; ++d) qi[d] = live && d < hd ? q[qrow + d] * scale : 0.f;

  float m = -INFINITY;
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) s = fmaf(qi[d], ks[j * hd + d], s);
    m = fmaxf(m, s);
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(MNT_FULL_MASK, m, off));
  float l = 0.f;
  float acc[MAXHD];
#pragma unroll
  for (int d = 0; d < MAXHD; ++d) acc[d] = 0.f;
  // dropout of the normalised probabilities (draw 3, padded coordinates
  // r = b * TP + i, c = h * TP + key): the keep factor multiplies e^(s - m)
  // and the 1/l of the softmax factors out unchanged
  const uint32_t r = (uint32_t)(b * TP + i);
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) s = fmaf(qi[d], ks[j * hd + d], s);
    const float p = expf(s - m);
    l += p;
    const float pk = p * keep(drop, r, (uint32_t)(h * TP + j));
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) acc[d] = fmaf(pk, vs[j * hd + d], acc[d]);
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1) {
    l += __shfl_xor_sync(MNT_FULL_MASK, l, off);
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) acc[d] += __shfl_xor_sync(MNT_FULL_MASK, acc[d], off);
  }
  if (!live || part != 0) return;
  if (lse) lse[((size_t)b * gridDim.y + h) * T + i] = m + logf(l);
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < MAXHD; ++d)
    if (d < hd) ctx[qrow + d] = acc[d] * inv;
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

// Floats of device scratch bert_layer_forward needs: q, k, v, ctx, x1 and
// the FFN's per-slice partial sums.
extern "C" long long bert_layer_scratch_floats(int B, int T, int H, int F) {
  return (long long)B * T * H * (5 + ffn_splits(F));
}

// Floats of the training forward's saved residuals: q, k, v, ctx, a1 (the
// pre-LN1 sum), x1, a2 (the pre-LN2 sum), (B, T, H) each, then the
// per-(subject, head, query) log-sum-exp of the attention, (B, heads, T).
extern "C" long long bert_layer_resid_floats(int B, int T, int H, int heads) {
  return 7LL * B * T * H + (long long)B * heads * T;
}

static bool bert_bad_dims(int T, int H, int F, int heads, int t_valid, int TP) {
  return H > FFN_MAXH || heads < 1 || H % heads != 0 || H / heads > BERT_MAXHD ||
         F % FFN_BF != 0 || t_valid < 1 || t_valid > T || TP < T;
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
// NULL and both rates 0. Needs H <= 96, H / heads <= 16 and F % 32 == 0.
// Returns the cudaError_t of the first launch that fails, or of the last.
extern "C" int bert_layer_forward(const float* x, const void* const* params, float* scratch,
                                  float* resid, float* out, int B, int T, int H, int F,
                                  int heads, int t_valid, int TP, int seed, double attn_rate,
                                  double hidden_rate, cudaStream_t stream) {
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

  const size_t smem_attn = 2 * (size_t)t_valid * hd * sizeof(float);
  const dim3 grid_attn((T + BERT_ATTN_QUERIES - 1) / BERT_ATTN_QUERIES, heads, B);
  const float scale = 1.f / sqrtf((float)hd);
  if (hd <= 8) {
    if ((err = allow_smem(bert_attention_kernel<8>, smem_attn)) != cudaSuccess) return (int)err;
    bert_attention_kernel<8><<<grid_attn, BERT_ATTN_THREADS, smem_attn, stream>>>(
        q, k, v, ctx, lse, d_attn, T, TP, H, hd, t_valid, scale);
  } else {
    if ((err = allow_smem(bert_attention_kernel<16>, smem_attn)) != cudaSuccess) return (int)err;
    bert_attention_kernel<16><<<grid_attn, BERT_ATTN_THREADS, smem_attn, stream>>>(
        q, k, v, ctx, lse, d_attn, T, TP, H, hd, t_valid, scale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

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

__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// ---- tensor cores: mma.sync m16n8k16 on bf16 operands (the bf16 policy) -----
//
// The route of the layer's mm16 form (JAX _mm(mm16=True)): every operand is
// rounded to bf16 (to nearest even) and the products accumulate in float32.
// A product of two bf16 values is exact in float32, so one bf16 mma a
// k-step gives JAX's arithmetic up to the order of summation, where 3xTF32
// needs three. Same block tile, warp tile and epilogue as tc_gemm_kernel;
// the operands sit in shared memory as bf16 (half the bytes), each in its
// global majorness with rows padded by 8 elements (fragment reads of a warp
// on distinct banks). Global operands stay float32: a thread loads its
// share of the next k tile (16-byte loads where rows allow) into registers
// while the warps multiply the current one, then rounds and stores it in
// the other of two stages. Ragged M, N and K are zero-filled.
#define TB_BK 32
#define TB_PAD 8

template <int TA, int TB>
struct TbTile {
  // bf16 elements: A [BM][BK + 8] (k fastest) or [BK][BM + 8] (m fastest);
  // B [BN][BK + 8] (k fastest) or [BK][BN + 8] (n fastest)
  static constexpr int AST = TA ? TG_BM + TB_PAD : TB_BK + TB_PAD;
  static constexpr int BST = TB ? TB_BK + TB_PAD : TG_BN + TB_PAD;
  static constexpr int A_ELEMS = TA ? TB_BK * AST : TG_BM * AST;
  static constexpr int B_ELEMS = TB ? TG_BN * BST : TB_BK * BST;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SMEM = 2 * STAGE * 2;   // two stages of bf16
  // float4 loads a thread issues per k tile
  static constexpr int A_LOADS = TG_BM * TB_BK / 4 / TG_THREADS;
  static constexpr int B_LOADS = TG_BN * TB_BK / 4 / TG_THREADS;
};

// Register-staged copy of a ROWS x COLS float tile (row r at src + r * ld,
// rows_valid x cols_valid in range, zero elsewhere): load() fetches a
// thread's share, store() rounds it to bf16 into shared rows of `st`.
template <int ROWS, int COLS, int LOADS>
struct TbCopy {
  float4 v[LOADS];

  __device__ __forceinline__ void load(const float* src, long long ld, int rows_valid,
                                       int cols_valid, int vec) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = threadIdx.x + i * TG_THREADS;
      const int r = c / (COLS / 4), cc = (c % (COLS / 4)) * 4;
      const float* row = src + (long long)r * ld + cc;
      if (vec && r < rows_valid && cc + 4 <= cols_valid) {
        v[i] = __ldg(reinterpret_cast<const float4*>(row));
      } else {
        const bool ok = r < rows_valid;
        v[i].x = ok && cc < cols_valid ? __ldg(row) : 0.f;
        v[i].y = ok && cc + 1 < cols_valid ? __ldg(row + 1) : 0.f;
        v[i].z = ok && cc + 2 < cols_valid ? __ldg(row + 2) : 0.f;
        v[i].w = ok && cc + 3 < cols_valid ? __ldg(row + 3) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* dst, int st) const {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = threadIdx.x + i * TG_THREADS;
      const int r = c / (COLS / 4), cc = (c % (COLS / 4)) * 4;
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[i].x, v[i].y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v[i].z, v[i].w);
      uint2 w;
      w.x = *reinterpret_cast<uint32_t*>(&lo);
      w.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + r * st + cc) = w;
    }
  }
};

// The two bf16 values (k, k + 1) of one fragment register: one 32-bit read
// where k is the fastest axis, two 16-bit reads packed otherwise.
template <int KFAST>
__device__ __forceinline__ uint32_t tb_pair(const __nv_bfloat16* s, int st, int line, int k) {
  if (KFAST) return *reinterpret_cast<const uint32_t*>(s + line * st + k);
  const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
  return (uint32_t)u[k * st + line] | ((uint32_t)u[(k + 1) * st + line] << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tc_gemm_kernel's epilogue plus mode 3: GELU(v + bias), the FFN's first
// product in the forward.
__device__ __forceinline__ float gemm16_epilogue(const Gemm& g, int m, int n, float v) {
  if (g.mode == 3) return gelu_erf(g.bias ? v + g.bias[n] : v);
  return gemm_epilogue(g, m, n, v);
}

template <int TA, int TB>
__global__ void __launch_bounds__(TG_THREADS, 2) tc_gemm_bf16_kernel(Gemm g) {
  using Tile = TbTile<TA, TB>;
  extern __shared__ __align__(16) __nv_bfloat16 tbs[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 48;
  const int m0 = blockIdx.y * TG_BM, n0 = blockIdx.x * TG_BN;
  const int kb = blockIdx.z * g.kchunk;
  const int ke = min(g.K, kb + g.kchunk);
  const int nk = (ke - kb + TB_BK - 1) / TB_BK;

  // A: BK rows of k, m fastest (TA) or BM rows of m, k fastest; B: BN rows
  // of n, k fastest (TB) or BK rows of k, n fastest
  TbCopy<TA ? TB_BK : TG_BM, TA ? TG_BM : TB_BK, Tile::A_LOADS> ca;
  TbCopy<TB ? TG_BN : TB_BK, TB ? TB_BK : TG_BN, Tile::B_LOADS> cb;
  auto fetch = [&](int kt) {
    const int k0 = kb + kt * TB_BK;
    if (TA) ca.load(g.A + (size_t)k0 * g.lda + m0, g.lda, ke - k0, g.M - m0, g.vec_a);
    else ca.load(g.A + (size_t)m0 * g.lda + k0, g.lda, g.M - m0, ke - k0, g.vec_a);
    if (TB) cb.load(g.B + (size_t)n0 * g.ldb + k0, g.ldb, g.N - n0, ke - k0, g.vec_b);
    else cb.load(g.B + (size_t)k0 * g.ldb + n0, g.ldb, ke - k0, g.N - n0, g.vec_b);
  };
  auto put = [&](int stage) {
    __nv_bfloat16* As = tbs + stage * Tile::STAGE;
    ca.store(As, Tile::AST);
    cb.store(As + Tile::A_ELEMS, Tile::BST);
  };

  float acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  if (nk > 0) {
    fetch(0);
    put(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch(kt + 1);   // in flight while this tile multiplies
    const __nv_bfloat16* As = tbs + (kt & 1) * Tile::STAGE;
    const __nv_bfloat16* Bs = As + Tile::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < TB_BK; kk += 16) {
      // a0a1 (r, k..k+1), a2a3 (r + 8, k..), a4a5 (r, k + 8..), a6a7 (r + 8, k + 8..)
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + gq, k = kk + 2 * tq;
        a[i][0] = tb_pair<!TA>(As, Tile::AST, r, k);
        a[i][1] = tb_pair<!TA>(As, Tile::AST, r + 8, k);
        a[i][2] = tb_pair<!TA>(As, Tile::AST, r, k + 8);
        a[i][3] = tb_pair<!TA>(As, Tile::AST, r + 8, k + 8);
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        // b0b1 (k..k+1, n), b2b3 (k + 8.., n)
        const int n = wn + j * 8 + gq, k = kk + 2 * tq;
        const uint32_t b0 = tb_pair<TB>(Bs, Tile::BST, n, k);
        const uint32_t b1 = tb_pair<TB>(Bs, Tile::BST, n, k + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    if (kt + 1 < nk) put((kt + 1) & 1);
    __syncthreads();
  }

  const bool split = g.splits > 1;
  float* C = split ? g.C + (size_t)blockIdx.z * g.M * g.N : g.C;
  const int ldc = split ? g.N : g.ldc;
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
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        float* dst = C + (size_t)m * ldc + n;
        if (!split) {
          v0 = gemm16_epilogue(g, m, n, v0);
          if (n + 1 < g.N) v1 = gemm16_epilogue(g, m, n + 1, v1);
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
// float32 FMAs on the CUDA cores (its precision yardstick), bf16 operands on
// the tensor cores (the mm16 layer's).
enum GemmRoute { GEMM_TF32X3 = 0, GEMM_SIMT = 1, GEMM_BF16 = 2 };

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
  } else if (route == GEMM_BF16) {
#define TB_LAUNCH(TA, TB)                                                                        \
  do {                                                                                           \
    if ((err = allow_smem(tc_gemm_bf16_kernel<TA, TB>, TbTile<TA, TB>::SMEM)) != cudaSuccess)    \
      return err;                                                                                \
    tc_gemm_bf16_kernel<TA, TB><<<grid, TG_THREADS, TbTile<TA, TB>::SMEM, stream>>>(g);          \
  } while (0)
    if (ta && tb) return cudaErrorInvalidValue;
    if (ta) TB_LAUNCH(1, 0);
    else if (tb) TB_LAUNCH(0, 1);
    else TB_LAUNCH(0, 0);
#undef TB_LAUNCH
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
static int bert_backward(const float* x, const float* resid, const float* g,
                         const void* const* params, void* const* grads, float* dx, float* scratch,
                         int B, int T, int H, int F, int heads, int t_valid, int TP, int seed,
                         double attn_rate, double hidden_rate, int route, int mm16,
                         cudaStream_t stream);

extern "C" int bert_layer_backward(const float* x, const float* resid, const float* g,
                                   const void* const* params, void* const* grads, float* dx,
                                   float* scratch, int B, int T, int H, int F, int heads,
                                   int t_valid, int TP, int seed, double attn_rate,
                                   double hidden_rate, int simt, cudaStream_t stream) {
  return bert_backward(x, resid, g, params, grads, dx, scratch, B, T, H, F, heads, t_valid, TP,
                       seed, attn_rate, hidden_rate, simt ? GEMM_SIMT : GEMM_TF32X3, 0, stream);
}

// The attention half's score backward under mm16 (defined with the mm16
// form below).
static cudaError_t attn_bwd16(const float* q, const float* k, const float* v,
                              const float* dctx, const float* rden, float* seg, float* dqkv,
                              const Dropout& drop, int B, int T, int TP, int H, int heads,
                              int t_valid, cudaStream_t stream);

// The backward of either form: route is the products' GemmRoute, mm16
// selects the score backward of the mm16 form (resid's log-sum-exp slot
// then holds the forward's rounded reciprocal denominators).
static int bert_backward(const float* x, const float* resid, const float* g,
                         const void* const* params, void* const* grads, float* dx, float* scratch,
                         int B, int T, int H, int F, int heads, int t_valid, int TP, int seed,
                         double attn_rate, double hidden_rate, int route, int mm16,
                         cudaStream_t stream) {
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
  if (mm16) {
    CK(attn_bwd16(q, k, v, dctx, lse, Dd, dqkv, d_attn, B, T, TP, H, heads, t_valid, stream));
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
// The dense products (QKV, out-projection, both FFN products; all five of
// the backward's FFN products and its projections) run on
// tc_gemm_bf16_kernel, one bf16 mma.sync a k-step. The per-head scores and
// context (head dim 7) stay on the CUDA cores, in the layout of the float32
// kernels: four lanes a query. The forward writes GELU(x1 W1^T + b1), one
// (M, F) float32 buffer, where the float32 forward keeps F-chunks in shared
// memory: the price of putting both FFN products on the tensor cores.
//
// What bounds it on the H100: not the card's rates (a batch-16 layer's
// ~6 GFLOP of products take ~6 us at the bf16 tensor rate) but latency:
// the K = 84 products' short k loops, the head-dim-7 attention on the CUDA
// cores, and the FFN intermediates crossing device memory as float32 (72 MB
// a layer at batch 16 forward, five such in the backward).
// ===========================================================================

#define BERT_LOGIT_CAP 80.f

template <int MAXHD>
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attention16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ ctx,
                        float* __restrict__ rden, Dropout drop, int T, int TP, int H, int hd,
                        int t_valid, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + (size_t)t_valid * hd;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t row0 = (size_t)b * T;
  for (int i = threadIdx.x; i < t_valid * hd; i += BERT_ATTN_THREADS) {
    const size_t g = (row0 + i / hd) * H + h * hd + i % hd;
    ks[i] = bf16r(k[g]);
    vs[i] = bf16r(v[g]);
  }
  __syncthreads();
  const int part = threadIdx.x % BERT_ATTN_SPLIT;
  const int i = blockIdx.x * BERT_ATTN_QUERIES + threadIdx.x / BERT_ATTN_SPLIT;
  const bool live = i < T;
  const size_t qrow = (row0 + (live ? i : 0)) * H + h * hd;
  float qi[MAXHD];
#pragma unroll
  for (int d = 0; d < MAXHD; ++d) qi[d] = live && d < hd ? bf16r(q[qrow + d] * scale) : 0.f;

  float den = 0.f;
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) s = fmaf(qi[d], ks[j * hd + d], s);
    den += bf16r(expf(fminf(s, BERT_LOGIT_CAP)));
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
    den += __shfl_xor_sync(MNT_FULL_MASK, den, off);
  const float rd = bf16r(1.f / fmaxf(den, 1e-38f));
  float acc[MAXHD];
#pragma unroll
  for (int d = 0; d < MAXHD; ++d) acc[d] = 0.f;
  const uint32_t r = (uint32_t)(b * TP + i);
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) s = fmaf(qi[d], ks[j * hd + d], s);
    const float p = expf(fminf(s, BERT_LOGIT_CAP)) * rd;
    const float pb = bf16r(p * keep(drop, r, (uint32_t)(h * TP + j)));   // draw 3
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) acc[d] = fmaf(pb, vs[j * hd + d], acc[d]);
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) acc[d] += __shfl_xor_sync(MNT_FULL_MASK, acc[d], off);
  if (!live || part != 0) return;
  if (rden) rden[((size_t)b * gridDim.y + h) * T + i] = rd;
#pragma unroll
  for (int d = 0; d < MAXHD; ++d)
    if (d < hd) ctx[qrow + d] = acc[d];
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

// A bf16 product A B^T (A (M, K) row-major, B (N, K)) whose K splits stay
// unreduced: C receives *splits dense (M, N) slices of partial sums (one
// when K is not split) for bert_bias_res_ln_kernel to add up.
static cudaError_t gemm16_parts(int M, int N, int K, const float* A, int lda, const float* B,
                                int ldb, float* C, int* splits, cudaStream_t stream) {
  Gemm g = {};
  g.M = M; g.N = N; g.K = K;
  g.A = A; g.lda = lda; g.ta = 0;
  g.B = B; g.ldb = ldb; g.tb = 1;
  g.C = C; g.ldc = N;
  g.vec_a = lda % 4 == 0 && (uintptr_t)A % 16 == 0;
  g.vec_b = ldb % 4 == 0 && (uintptr_t)B % 16 == 0;
  gemm_split(M, N, K, TG_BM, TG_BN, &g.splits, &g.kchunk);
  *splits = g.splits;
  cudaError_t err = allow_smem(tc_gemm_bf16_kernel<0, 1>, TbTile<0, 1>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TG_BN - 1) / TG_BN, (M + TG_BM - 1) / TG_BM, g.splits);
  tc_gemm_bf16_kernel<0, 1><<<grid, TG_THREADS, TbTile<0, 1>::SMEM, stream>>>(g);
  return cudaGetLastError();
}

static long long bert_fwd16_part_floats(long long M, int H, int F) {
  const long long p = gemm_part_floats((int)M, H, F);
  return p > M * H ? p : M * H;
}

// Floats of device scratch bert_layer_forward16 needs: q, k, v, ctx, x1 (as
// the float32 forward's), GELU(u) (M x F) and the products' partial sums.
extern "C" long long bert_layer_scratch16_floats(int B, int T, int H, int F) {
  const long long M = (long long)B * T;
  return 5 * M * H + M * F + bert_fwd16_part_floats(M, H, F);
}

// The mm16 form of bert_layer_forward: same arguments, layouts, dropout
// draws and saved residuals (bert_layer_resid_floats), scratch of
// bert_layer_scratch16_floats(); the residuals' log-sum-exp slot receives
// bf16(1 / den) of every (subject, head, query). Returns the cudaError_t of
// the first launch that fails, or of the last.
extern "C" int bert_layer_forward16(const float* x, const void* const* params, float* scratch,
                                    float* resid, float* out, int B, int T, int H, int F,
                                    int heads, int t_valid, int TP, int seed, double attn_rate,
                                    double hidden_rate, cudaStream_t stream) {
  if (bert_bad_dims(T, H, F, heads, t_valid, TP)) return (int)cudaErrorInvalidValue;
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
  float* gu = scratch + 5 * MH;
  float* part = gu + (size_t)M * F;
  const int hd = H / heads;
  const float eps = 1e-12f;
  const Dropout d_attn = make_dropout(seed, 3, attn_rate);
  const Dropout d0 = make_dropout(seed, 0, hidden_rate);
  const Dropout d1 = make_dropout(seed, 1, hidden_rate);
  const int ln_blocks = (M + BERT_THREADS / 32 - 1) / (BERT_THREADS / 32);
  int splits = 1;

  // q, k, v = x W^T + b (bias in the epilogue)
  float* qkv[3] = {q, k, v};
  for (int j = 0; j < 3; ++j)
    CK(gemm(M, H, H, x, H, 0, p[2 * j], H, 1, qkv[j], H, nullptr, part, stream, GEMM_BF16,
            p[2 * j + 1]));

  const size_t smem_attn = 2 * (size_t)t_valid * hd * sizeof(float);
  const dim3 grid_attn((T + BERT_ATTN_QUERIES - 1) / BERT_ATTN_QUERIES, heads, B);
  const float scale = 1.f / sqrtf((float)hd);
  if (hd <= 8) {
    CK(allow_smem(bert_attention16_kernel<8>, smem_attn));
    bert_attention16_kernel<8><<<grid_attn, BERT_ATTN_THREADS, smem_attn, stream>>>(
        q, k, v, ctx, rden, d_attn, T, TP, H, hd, t_valid, scale);
  } else {
    CK(allow_smem(bert_attention16_kernel<16>, smem_attn));
    bert_attention16_kernel<16><<<grid_attn, BERT_ATTN_THREADS, smem_attn, stream>>>(
        q, k, v, ctx, rden, d_attn, T, TP, H, hd, t_valid, scale);
  }
  CK(cudaGetLastError());

  // x1 = LN1((ctx Wo^T + bo) * m0 + x)
  CK(gemm16_parts(M, H, H, ctx, H, p[6], H, part, &splits, stream));
  bert_bias_res_ln_kernel<<<ln_blocks, BERT_THREADS, 0, stream>>>(
      part, splits, p[7], x, p[8], p[9], d0, T, TP, M, H, eps, x1, a1);
  CK(cudaGetLastError());

  // GELU(x1 W1^T + b1), then out = LN2((GELU(.) W2^T + b2) * m1 + x1)
  CK(gemm(M, F, H, x1, H, 0, p[10], H, 1, gu, F, nullptr, part, stream, GEMM_BF16, p[11],
          nullptr, 3));
  CK(gemm16_parts(M, H, F, gu, F, p[12], F, part, &splits, stream));
  bert_bias_res_ln_kernel<<<ln_blocks, BERT_THREADS, 0, stream>>>(
      part, splits, p[13], x1, p[14], p[15], d1, T, TP, M, H, eps, out, a2);
  return (int)cudaGetLastError();
}

// dq of one (subject, head, query) under mm16, four lanes a query as the
// float32 kernel: p = e * rden rebuilt from the scores, dp = (dctx . v) * keep;
// seg = bf16(sum_j bf16(dp p)) (fusion_block._seg_rows with mm16), saved for
// the dk/dv kernel; ds = p (dp - seg); dq = scale sum_j bf16(ds) bf16(k).
template <int MAXHD>
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attn_bwd_dq16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dctx,
                          const float* __restrict__ rden, float* __restrict__ seg_out,
                          float* __restrict__ dq, int ldq, Dropout drop, int T, int TP, int H,
                          int hd, int t_valid, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + (size_t)t_valid * hd;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t row0 = (size_t)b * T;
  for (int i = threadIdx.x; i < t_valid * hd; i += BERT_ATTN_THREADS) {
    const size_t g = (row0 + i / hd) * H + h * hd + i % hd;
    ks[i] = bf16r(k[g]);
    vs[i] = bf16r(v[g]);
  }
  __syncthreads();
  const int part = threadIdx.x % BERT_ATTN_SPLIT;
  const int i = blockIdx.x * BERT_ATTN_QUERIES + threadIdx.x / BERT_ATTN_SPLIT;
  const bool live = i < T;
  const size_t qrow = (row0 + (live ? i : 0)) * H + h * hd;
  const size_t si = ((size_t)b * gridDim.y + h) * T + (live ? i : 0);
  float qi[MAXHD], gi[MAXHD], dqa[MAXHD];
#pragma unroll
  for (int d = 0; d < MAXHD; ++d) {
    qi[d] = live && d < hd ? bf16r(q[qrow + d] * scale) : 0.f;
    gi[d] = live && d < hd ? bf16r(dctx[qrow + d]) : 0.f;
    dqa[d] = 0.f;
  }
  const float rd = live ? rden[si] : 0.f;
  const uint32_t r = (uint32_t)(b * TP + i);
  float sacc = 0.f;
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float s = 0.f, dpd = 0.f;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) {
        s = fmaf(qi[d], ks[j * hd + d], s);
        dpd = fmaf(gi[d], vs[j * hd + d], dpd);
      }
    const float p = expf(fminf(s, BERT_LOGIT_CAP)) * rd;
    sacc += bf16r(dpd * keep(drop, r, (uint32_t)(h * TP + j)) * p);
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
    sacc += __shfl_xor_sync(MNT_FULL_MASK, sacc, off);
  const float seg = bf16r(sacc);
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float s = 0.f, dpd = 0.f;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) {
        s = fmaf(qi[d], ks[j * hd + d], s);
        dpd = fmaf(gi[d], vs[j * hd + d], dpd);
      }
    const float p = expf(fminf(s, BERT_LOGIT_CAP)) * rd;
    const float ds = bf16r(p * (dpd * keep(drop, r, (uint32_t)(h * TP + j)) - seg));
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) dqa[d] = fmaf(ds, ks[j * hd + d], dqa[d]);
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1)
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) dqa[d] += __shfl_xor_sync(MNT_FULL_MASK, dqa[d], off);
  if (!live || part != 0) return;
  seg_out[si] = seg;
  const size_t drow = (row0 + i) * ldq + h * hd;
#pragma unroll
  for (int d = 0; d < MAXHD; ++d)
    if (d < hd) dq[drow + d] = dqa[d] * scale;
}

// dk and dv of one (subject, head, key) under mm16: dk = sum_i bf16(ds)
// bf16(q scale), dv = sum_i bf16(p keep) bf16(dctx); four lanes a key, the
// head's rounded q * scale and dctx, rden and seg in shared memory.
template <int MAXHD>
__global__ void __launch_bounds__(BERT_ATTN_THREADS)
bert_attn_bwd_dkv16_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dctx,
                           const float* __restrict__ rden, const float* __restrict__ seg,
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
    const size_t g = (row0 + i / hd) * H + h * hd + i % hd;
    qs[i] = bf16r(q[g] * scale);
    gs[i] = bf16r(dctx[g]);
  }
  for (int i = threadIdx.x; i < T; i += BERT_ATTN_THREADS) {
    ls[i] = rden[s0 + i];
    Ds[i] = seg[s0 + i];
  }
  __syncthreads();
  const int part = threadIdx.x % BERT_ATTN_SPLIT;
  const int j = blockIdx.x * BERT_ATTN_QUERIES + threadIdx.x / BERT_ATTN_SPLIT;
  const bool live = j < t_valid;
  const size_t krow = (row0 + (live ? j : 0)) * H + h * hd;
  float kj[MAXHD], vj[MAXHD], dka[MAXHD], dva[MAXHD];
#pragma unroll
  for (int d = 0; d < MAXHD; ++d) {
    kj[d] = live && d < hd ? bf16r(k[krow + d]) : 0.f;
    vj[d] = live && d < hd ? bf16r(v[krow + d]) : 0.f;
    dka[d] = dva[d] = 0.f;
  }
  if (live) {
    const uint32_t c = (uint32_t)(h * TP + j);
    for (int i = part; i < T; i += BERT_ATTN_SPLIT) {
      float s = 0.f, dpd = 0.f;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          s = fmaf(qs[i * hd + d], kj[d], s);
          dpd = fmaf(gs[i * hd + d], vj[d], dpd);
        }
      const float p = expf(fminf(s, BERT_LOGIT_CAP)) * ls[i];
      const float kp = keep(drop, (uint32_t)(b * TP + i), c);
      const float ds = bf16r(p * (dpd * kp - Ds[i]));
      const float pd = bf16r(p * kp);
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) {
          dka[d] = fmaf(ds, qs[i * hd + d], dka[d]);
          dva[d] = fmaf(pd, gs[i * hd + d], dva[d]);
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

static cudaError_t attn_bwd16(const float* q, const float* k, const float* v,
                              const float* dctx, const float* rden, float* seg, float* dqkv,
                              const Dropout& drop, int B, int T, int TP, int H, int heads,
                              int t_valid, cudaStream_t stream) {
  const int hd = H / heads;
  const float scale = 1.f / sqrtf((float)hd);
  const dim3 grid((T + BERT_ATTN_QUERIES - 1) / BERT_ATTN_QUERIES, heads, B);
  const size_t smem_dq = 2 * (size_t)t_valid * hd * sizeof(float);
  const size_t smem_dkv = (2 * (size_t)T * hd + 2 * (size_t)T) * sizeof(float);
  cudaError_t err;
#define ATTN16(HD)                                                                              \
  do {                                                                                          \
    if ((err = allow_smem(bert_attn_bwd_dq16_kernel<HD>, smem_dq)) != cudaSuccess) return err;  \
    bert_attn_bwd_dq16_kernel<HD><<<grid, BERT_ATTN_THREADS, smem_dq, stream>>>(                \
        q, k, v, dctx, rden, seg, dqkv, 3 * H, drop, T, TP, H, hd, t_valid, scale);             \
    if ((err = cudaGetLastError()) != cudaSuccess) return err;                                  \
    if ((err = allow_smem(bert_attn_bwd_dkv16_kernel<HD>, smem_dkv)) != cudaSuccess) return err; \
    bert_attn_bwd_dkv16_kernel<HD><<<grid, BERT_ATTN_THREADS, smem_dkv, stream>>>(              \
        q, k, v, dctx, rden, seg, dqkv + H, dqkv + 2 * H, 3 * H, drop, T, TP, H, hd, t_valid,   \
        scale);                                                                                 \
  } while (0)
  if (hd <= 8) ATTN16(8);
  else ATTN16(16);
#undef ATTN16
  return cudaGetLastError();
}

// The mm16 form of bert_layer_backward: x, resid (from bert_layer_forward16
// with the same seed and rates), g, params, grads, dx and scratch
// (bert_layer_backward_scratch_floats()) as there; every product on bf16
// operands (tc_gemm_bf16_kernel) at JAX's mm16 rounding points.
extern "C" int bert_layer_backward16(const float* x, const float* resid, const float* g,
                                     const void* const* params, void* const* grads, float* dx,
                                     float* scratch, int B, int T, int H, int F, int heads,
                                     int t_valid, int TP, int seed, double attn_rate,
                                     double hidden_rate, cudaStream_t stream) {
  return bert_backward(x, resid, g, params, grads, dx, scratch, B, T, H, F, heads, t_valid, TP,
                       seed, attn_rate, hidden_rate, GEMM_BF16, 1, stream);
}
