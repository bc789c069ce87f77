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
// at inference (dropout and DropPath are the identity).
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
                    float* __restrict__ out, int windows, int nW, int N, int C, int H, int Ch) {
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
#pragma unroll
        for (int d = 0; d < MAXHD; ++d)
          if (d < hd) acc[d] = fmaf(p, vs[j * CS + c0 + d], acc[d]);
      }
      const float inv = 1.f / l;
#pragma unroll
      for (int d = 0; d < MAXHD; ++d)
        if (d < hd) hs[n * CS + c0 + d] = acc[d] * inv;
    }
    __syncthreads();

    dense(hs, CS, C, smem + L.wp, smem + L.bp, C, N,
          [&](int n, int o, float s) { x2[n * CS + o] = xs[n * CS + o] + s; });
    __syncthreads();

    for (int n = tid; n < N; n += FUSION_THREADS)
      ln_row(x2 + n * CS, qs + n * CS, smem + L.g2, smem + L.b2, C);
    __syncthreads();

    dense(qs, CS, C, smem + L.w1, smem + L.b1m, Ch, N,
          [&](int n, int o, float s) { us[n * HS + o] = gelu_erf(s); });
    __syncthreads();

    dense(us, HS, Ch, smem + L.w2, smem + L.b2m, C, N, [&](int n, int o, float s) {
      out[base + (size_t)n * C + o] = x2[n * CS + o] + s;
    });
    __syncthreads();  // the next window overwrites xs, ys and ms
  }
}

template <bool CROSS, int MAXHD>
static cudaError_t launch_fusion(const float* x, const float* y, const FusionParams& P,
                                 const float* bias, const float* mask, float* out,
                                 int windows, int nW, int N, int C, int H, int Ch,
                                 cudaStream_t stream) {
  const size_t smem = (size_t)FusionLayout(CROSS, N, C, H, Ch).total * sizeof(float);
  auto kernel = fusion_block_kernel<CROSS, MAXHD>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // a grid that fills the card once; blocks then loop over the windows
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FUSION_THREADS,
                                                          smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = windows < sms * per_sm ? windows : sms * per_sm;
  kernel<<<blocks, FUSION_THREADS, smem, stream>>>(x, y, P, bias, mask, out, windows, nW, N,
                                                  C, H, Ch);
  return cudaGetLastError();
}

template <bool CROSS>
static cudaError_t launch_fusion_hd(const float* x, const float* y, const FusionParams& P,
                                    const float* bias, const float* mask, float* out,
                                    int windows, int nW, int N, int C, int H, int Ch,
                                    cudaStream_t stream) {
  // the flagship's head dim is 2; anything wider takes the general bound
  if (C / H <= 2)
    return launch_fusion<CROSS, 2>(x, y, P, bias, mask, out, windows, nW, N, C, H, Ch, stream);
  return launch_fusion<CROSS, FUSION_MAXHD>(x, y, P, bias, mask, out, windows, nW, N, C, H,
                                            Ch, stream);
}

// x, y, out: (B, nW, N, C) windows, f32 contiguous (y unused unless cross).
// params: host array of device pointers in the JAX kernels' order
//   self  (12): g1 b1 wqkv bqkv wp bp g2 b2 w1 b1m w2 b2m
//   cross (16): g1 b1 g1y b1y wq bq wkv bkv wp bp g2 b2 w1 b1m w2 b2m
// with weights in torch (out, in) layout. bias (H, N, N); mask (nW, N, N) or
// NULL. Needs N <= 256 and C / H <= 16. Returns the cudaError_t of the
// launch.
extern "C" int fusion_block_forward(int cross, const float* x, const float* y,
                                    const void* const* params, const float* bias,
                                    const float* mask, float* out, int B, int nW,
                                    int N, int C, int H, int Ch, cudaStream_t stream) {
  if (H < 1 || C % H != 0 || C / H > FUSION_MAXHD || N < 1 || N > FUSION_THREADS)
    return (int)cudaErrorInvalidValue;
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

  const int windows = B * nW;
  return (int)(cross ? launch_fusion_hd<true>(x, y, P, bias, mask, out, windows, nW, N, C, H,
                                              Ch, stream)
                     : launch_fusion_hd<false>(x, y, P, bias, mask, out, windows, nW, N, C, H,
                                               Ch, stream));
}
