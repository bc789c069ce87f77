// K1: one HF post-LN BERT layer, forward.
//
// Replaces multimodal_neuroimage_tpu/ops/bert_layer.py bert_layer_call
// (_fbl_fwd over _make_fwd_kernel / _fwd_parts, and its batched-grid twin
// _make_fwd_kernel_batched, which computes the same layer):
//
//   q, k, v = x Wq, x Wk, x Wv; per head softmax(q k^T / sqrt(hd)) with keys
//   >= t_valid masked out; context; x1 = LN(ctx Wo + bo + x); out =
//   LN(GELU(x1 W1 + b1) W2 + b2 + x1); LN eps 1e-12, two-pass variance.
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
                      const float* __restrict__ v, float* __restrict__ ctx, int T, int H,
                      int hd, int t_valid, float scale) {
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
  for (int j = part; j < t_valid; j += BERT_ATTN_SPLIT) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) s = fmaf(qi[d], ks[j * hd + d], s);
    const float p = expf(s - m);
    l += p;
#pragma unroll
    for (int d = 0; d < MAXHD; ++d)
      if (d < hd) acc[d] = fmaf(p, vs[j * hd + d], acc[d]);
  }
#pragma unroll
  for (int off = 1; off < BERT_ATTN_SPLIT; off <<= 1) {
    l += __shfl_xor_sync(MNT_FULL_MASK, l, off);
#pragma unroll
    for (int d = 0; d < MAXHD; ++d) acc[d] += __shfl_xor_sync(MNT_FULL_MASK, acc[d], off);
  }
  if (!live || part != 0) return;
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
                   float* __restrict__ x1, int M, int H, float eps) {
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
    float vals[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int o = lane + 32 * t;
      vals[t] = 0.f;
      if (o < H) {
        const float* cr = cs + r * HP;
        const float* wr = ws + o * HP;
        float s = __ldg(P.bo + o) + x[row + o];
        for (int c = 0; c < H; ++c) s = fmaf(cr[c], wr[c], s);
        vals[t] = s;
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
                          int M, int H, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (BERT_THREADS / 32) + warp;
  if (row >= M) return;
  float vals[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int o = lane + 32 * t;
    vals[t] = 0.f;
    if (o < H) {
      float s = __ldg(P.b2m + o) + x1[(size_t)row * H + o];
      for (int sp = 0; sp < splits; ++sp) s += part[((size_t)sp * M + row) * H + o];
      vals[t] = s;
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

// x, out: (B, T, H) f32 contiguous; scratch: bert_layer_scratch_floats()
// floats of device memory. params: host array of 16 device pointers in the
// JAX kernel's order
//   wq bq wk bk wv bv wo bo g1 b1 w1 b1m w2 b2m g2 b2
// with weights in torch (out, in) layout. Keys >= t_valid are masked out.
// Needs H <= 96, H / heads <= 16 and F % 32 == 0. Returns the cudaError_t
// of the first launch that fails, or of the last.
extern "C" int bert_layer_forward(const float* x, const void* const* params, float* scratch,
                                  float* out, int B, int T, int H, int F, int heads,
                                  int t_valid, cudaStream_t stream) {
  if (H > FFN_MAXH || heads < 1 || H % heads != 0 || H / heads > BERT_MAXHD ||
      F % FFN_BF != 0 || t_valid < 1 || t_valid > T)
    return (int)cudaErrorInvalidValue;
  const float* const* p = reinterpret_cast<const float* const*>(params);
  const BertParams P = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                        p[8], p[9], p[10], p[11], p[12], p[13], p[14], p[15]};
  const int M = B * T;
  const size_t MH = (size_t)M * H;
  float *q = scratch, *k = q + MH, *v = k + MH, *ctx = v + MH, *x1 = ctx + MH;
  float* part = x1 + MH;
  const int HP = H + 1;
  const int hd = H / heads;
  const float eps = 1e-12f;
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
        q, k, v, ctx, T, H, hd, t_valid, scale);
  } else {
    if ((err = allow_smem(bert_attention_kernel<16>, smem_attn)) != cudaSuccess) return (int)err;
    bert_attention_kernel<16><<<grid_attn, BERT_ATTN_THREADS, smem_attn, stream>>>(
        q, k, v, ctx, T, H, hd, t_valid, scale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_ln = (size_t)(H + BERT_LN_ROWS) * HP * sizeof(float);
  if ((err = allow_smem(bert_out_ln_kernel, smem_ln)) != cudaSuccess) return (int)err;
  bert_out_ln_kernel<<<(M + BERT_LN_ROWS - 1) / BERT_LN_ROWS, BERT_THREADS, smem_ln, stream>>>(
      ctx, x, P, x1, M, H, eps);
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
                              stream>>>(part, splits, x1, P, out, M, H, eps);
  return (int)cudaGetLastError();
}
