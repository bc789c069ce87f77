// K6: plain multi-head attention over long sequences, forward and backward.
//
// Replaces multimodal_neuroimage_tpu/ops/attention.py fused_attention
// (_fused_fwd -> _make_fwd_kernel, _fused_bwd -> _make_bwd_kernel): per
// (batch, head), softmax(q k^T) v on (B, H, T, D) with q already scaled by
// the caller, and dropout on the normalised probabilities. The BERT layer
// takes this route when round_up(T, 8) > 640: HCP's T = 1201 (1200 TRs and
// the CLS token), hidden 22, 2 heads of dim 11.
//
// What bounds it on the H100: the operations, not the bytes. At HCP shapes
// (8, 2, 1201, 11) the forward reads and writes ~3.4 MB but does ~1.0 GFLOP
// of score and context products (4 T^2 D per (b, h)) and 23 M exponentials.
//
// The TPU kernel kept one whole (T, T) score matrix in VMEM; at T = 1201
// that is 5.8 MB, beyond a block's 227 KB of shared memory. So the scores
// never exist as a matrix here: flash-style, a block owns 64 query rows of
// one (b, h) and streams the keys through shared memory in tiles, with an
// online softmax (running max m, running sum l, the output accumulator in
// registers). The forward also writes the row's log-sum-exp, from which the
// backward rebuilds p = exp(s - lse) without a second max pass.
//
// Dropout is on the normalised probabilities (attention.py:58-62): l sums
// the unmasked exponentials, and only the accumulator takes keep / (1 -
// rate). The mask is the port's coordinate hash (common.cuh keep) at row
// (b * H + h) * T + i, column j, draw MHA_DRAW, which no other kernel uses;
// forward and backward regenerate it, nothing is stored.
//
// The backward is deterministic (no float atomics): a row pass writes
// delta_i = do_i . out_i (= sum_j p_ij g_ij with g the dropped gradient of
// the probabilities, since out_i = sum_j p_ij keep_ij v_j); a key-tile kernel
// loops over every query for dv_j = sum_i p_ij keep_ij do_i and dk_j =
// sum_i ds_ij q_i; a query-tile kernel loops over every key for dq_i =
// sum_j ds_ij k_j, with ds_ij = p_ij (keep_ij do_i . v_j - delta_i). Every
// sum runs in a fixed order, so repeat calls are bitwise equal.
//
// Two forms share that structure, both on the tensor cores with warp-level
// mma.sync, templated on the padded head dim and on dropout on or off (rate
// 0 carries no hash). mma.sync and not wgmma: the depth of q k^T and dO v^T
// is the padded head dim (16 at HCP's 11), and the n of p v, p^T dO, ds^T q
// and ds k is the head dim again; wgmma's 64-row warpgroup tiles buy nothing
// on products this short, whose time goes to the per-score work between
// them (the exponential, the split, the hash), not to the products.
//
// The float32 form (mha_forward / mha_backward) takes every product on
// mma.sync.m16n8k8 TF32 in 3xTF32 form, which keeps float32 accuracy (see
// "the float32 form on tensor cores" below): a float32 operand has no exact
// tensor-core product short of it. Its scores are the same float32 values
// in the forward and in both backward kernels, so that the backward's p =
// exp(s - lse) sums to one as the forward's did: K1's scores, computed one
// way in its forward and another in its backward, moved a gradient that is
// zero in exact arithmetic past its float32 noise (bert_layer.cu). Here that
// gradient is sum_j dk_j (sum_j ds_ij = 0 for every query). The CUDA-core
// float32 form, four threads a row each taking every fourth key of a tile,
// their states merged with warp shuffles, stays as mha_forward_simt /
// mha_backward_simt: the precision yardstick of the tests
// (ops/attention.py _K6_SIMT).
//
// The bf16 form (mha_forward16 / mha_backward16: JAX's fused_attention on
// bf16 q, k, v, the HCP layers under the bf16 policy) runs on the tensor
// cores (mma.sync.m16n8k16, bf16 operands, f32 accumulators). On the CUDA
// cores it was bound by shared-memory loads, one float read a multiply-add
// with no register tiling, and it lost to scaled_dot_product_attention. A
// warp owns 16 rows and keeps them as an mma A fragment, the head dim
// zero-padded to 16, 32 or 64 (zeros add nothing, so the padding is exact);
// the other side's tiles (64 rows, 32 at head dim 64) are staged as bf16
// [row][DP + 8], whose pitch lets ldmatrix read eight rows from eight bank
// groups, double-buffered through registers (a row of 11 bf16 is 22 bytes,
// so no 16-byte copy is aligned: each thread loads 2-byte values, the next
// tile's while the current one is computed).
//  - q k^T (and k q^T, v dO^T, dO v^T in the backward) multiply bf16 values:
//    the products are exact in f32, one mma a 16-deep step, as JAX's f32
//    upcast computes them (attention.py:55-58, 72-76, 86).
//  - The softmax runs on the accumulator fragments in f32: row max and sum
//    over the quad of lanes that share a row, exponentials as one
//    ex2.approx.ftz each on log2(e)-scaled scores (relative error ~2^-22),
//    the hash per element with its row part hoisted.
//  - p v, p^T dO, ds^T q and ds k have an f32 operand (p or ds) that a bf16
//    mma would round to 8 bits. Each is split x = hi + lo, hi = bf16(x), lo
//    = bf16(x - hi), which carries x to 2^-16 |x|, and the two halves go
//    through two mma into one f32 accumulator; the other operand (v, dO, q,
//    k) is exactly bf16. The halves are packed straight from the C fragment
//    into A fragments (a C fragment's columns are an A fragment's k), and
//    the B side comes by ldmatrix.trans.
// What bounds the bf16 form is then the instruction stream of the
// per-score work, not the products: at head dim 16 the forward runs 3 mma
// per 16 x 8 scores, but a score takes an exponential, the split's
// conversions, its share of the running max and sum and of the next
// tile's staging, and at rate > 0 the hash's 11 integer operations
// (common.cuh keep_at). At HCP's shapes
// a grid has only 304 blocks of 4 warps, about 2 warps a scheduler, so
// the latency of each tile's chain (mma, quad shuffles, exponentials, mma)
// is not hidden either. The kernels are templated on dropout on or off, so
// rate 0 carries no hash.
//
// out, dq, dk, dv are rounded to bf16 once, on store. The forward also
// writes an f32 copy of out for the backward's delta: from the bf16 out,
// delta would carry its 2^-9 relative rounding into ds = p (g - delta),
// whose cancellation amplifies it (JAX sums g_p . p from the f32 p). The
// CUDA-core bf16 form stays as mha_forward16_simt / mha_backward16_simt,
// the precision yardstick of the tests (ops/attention.py _K6_SIMT).
//
// T need be a multiple of nothing: tail keys of the last tile never enter m
// or l (or ds), tail rows are never written.
#include "common.cuh"

#define MHA_DRAW 4      // the hash draw of K6's probability dropout (ops/attention.py MHA_DRAW)
#define MHA_ROWS 64     // query (or key) rows a block owns
#define MHA_TILE 64     // keys (or queries) staged in shared memory at a time
#define MHA_SPLIT 4     // threads that share one row
#define MHA_THREADS (MHA_ROWS * MHA_SPLIT)

// Storage of q, k, v, dout and the outputs: float (the f32 form) or
// __nv_bfloat16 (the bf16 form), widened on load and rounded on store.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Stage rows [r0, r0 + MHA_TILE) of up to two (T, D) matrices of one (b, h)
// into shared [MHA_TILE][MAXD + 1] arrays, zero past T and past D.
template <int MAXD, typename S>
__device__ __forceinline__ void stage_tile(const S* __restrict__ a, const S* __restrict__ b,
                                           float (*as)[MAXD + 1], float (*bs)[MAXD + 1], int r0,
                                           int T, int D) {
  for (int e = threadIdx.x; e < MHA_TILE * MAXD; e += blockDim.x) {
    const int r = e / MAXD, d = e % MAXD;
    const bool in = r0 + r < T && d < D;
    const size_t at = (size_t)(r0 + r) * D + d;
    as[r][d] = in ? ld(a + at) : 0.f;
    bs[r][d] = in ? ld(b + at) : 0.f;
  }
}

// Combine the online-softmax states (m, l, acc) of the MHA_SPLIT threads of
// a row (neighbouring lanes). Every lane ends with the same merged state:
// each step adds the same two terms in either order.
template <int MAXD>
__device__ __forceinline__ void merge_states(float& m, float& l, float (&acc)[MAXD]) {
#pragma unroll
  for (int off = 1; off < MHA_SPLIT; off <<= 1) {
    const float mo = __shfl_xor_sync(MNT_FULL_MASK, m, off);
    const float lo = __shfl_xor_sync(MNT_FULL_MASK, l, off);
    const float mn = fmaxf(m, mo);
    const float a = m == -INFINITY ? 0.f : expf(m - mn);
    const float b = mo == -INFINITY ? 0.f : expf(mo - mn);
    l = l * a + lo * b;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      const float ao = __shfl_xor_sync(MNT_FULL_MASK, acc[d], off);
      acc[d] = acc[d] * a + ao * b;
    }
    m = mn;
  }
}

// Sum a per-thread vector over the MHA_SPLIT threads of a row.
template <int MAXD>
__device__ __forceinline__ void sum_split(float (&x)[MAXD]) {
#pragma unroll
  for (int off = 1; off < MHA_SPLIT; off <<= 1)
#pragma unroll
    for (int d = 0; d < MAXD; ++d) x[d] += __shfl_xor_sync(MNT_FULL_MASK, x[d], off);
}

// grid (ceil(T / MHA_ROWS), B * H), MHA_THREADS threads. out32 (the bf16
// form's f32 copy of out) and lse may be NULL.
template <int MAXD, typename S>
__global__ void __launch_bounds__(MHA_THREADS)
    mha_forward_kernel(const S* __restrict__ q, const S* __restrict__ k,
                       const S* __restrict__ v, S* __restrict__ out,
                       float* __restrict__ out32, float* __restrict__ lse, int T, int D,
                       Dropout drop) {
  __shared__ float ks[MHA_TILE][MAXD + 1];
  __shared__ float vs[MHA_TILE][MAXD + 1];
  const int bh = blockIdx.y;
  const int sub = threadIdx.x % MHA_SPLIT;
  const int i = blockIdx.x * MHA_ROWS + threadIdx.x / MHA_SPLIT;
  const bool valid = i < T;
  const size_t base = (size_t)bh * T * D;
  const S* kb = k + base;
  const S* vb = v + base;

  float qi[MAXD], acc[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    qi[d] = valid && d < D ? ld(q + base + (size_t)i * D + d) : 0.f;
    acc[d] = 0.f;
  }
  const uint32_t hrow = (uint32_t)bh * (uint32_t)T + (uint32_t)i;
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < T; j0 += MHA_TILE) {
    __syncthreads();
    stage_tile<MAXD>(kb, vb, ks, vs, j0, T, D);
    __syncthreads();
    const int nk = min(MHA_TILE, T - j0);
    float s[MHA_TILE / MHA_SPLIT];
    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < MHA_TILE / MHA_SPLIT; ++t) {
      const int jj = sub + t * MHA_SPLIT;
      float sv = -INFINITY;
      if (jj < nk) {
        sv = 0.f;
#pragma unroll
        for (int d = 0; d < MAXD; ++d) sv = fmaf(qi[d], ks[jj][d], sv);
      }
      s[t] = sv;
      tmax = fmaxf(tmax, sv);
    }
    if (tmax == -INFINITY) continue;     // no key of this tile is this thread's
    const float mnew = fmaxf(m, tmax);
    const float corr = expf(m - mnew);   // 0 on the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) acc[d] *= corr;
    m = mnew;
#pragma unroll
    for (int t = 0; t < MHA_TILE / MHA_SPLIT; ++t) {
      const int jj = sub + t * MHA_SPLIT;
      if (jj < nk) {
        const float p = expf(s[t] - m);
        l += p;
        const float pk = p * keep(drop, hrow, (uint32_t)(j0 + jj));
#pragma unroll
        for (int d = 0; d < MAXD; ++d) acc[d] = fmaf(pk, vs[jj][d], acc[d]);
      }
    }
  }
  merge_states<MAXD>(m, l, acc);
  if (valid && sub == 0) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) {
        const float o = acc[d] * inv;
        st(out + base + (size_t)i * D + d, o);
        if (out32) out32[base + (size_t)i * D + d] = o;
      }
    if (lse) lse[(size_t)bh * T + i] = m + logf(l);
  }
}

// delta[r] = dout[r] . out[r] over the B * H * T rows (out in f32 in both
// forms).
template <typename S>
__global__ void mha_delta_kernel(const float* __restrict__ out, const S* __restrict__ dout,
                                 float* __restrict__ delta, long long rows, int D) {
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < rows;
       r += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(ld(dout + r * D + d), out[r * D + d], s);
    delta[r] = s;
  }
}

// dk, dv of MHA_ROWS keys of one (b, h), looping over every query.
// grid (ceil(T / MHA_ROWS), B * H), MHA_THREADS threads.
template <int MAXD, typename S>
__global__ void __launch_bounds__(MHA_THREADS)
    mha_backward_dkdv_kernel(const S* __restrict__ q, const S* __restrict__ k,
                             const S* __restrict__ v, const S* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             S* __restrict__ dk, S* __restrict__ dv, int T, int D,
                             Dropout drop) {
  __shared__ float qs[MHA_TILE][MAXD + 1];
  __shared__ float gs[MHA_TILE][MAXD + 1];
  __shared__ float ls[MHA_TILE];
  __shared__ float dls[MHA_TILE];
  const int bh = blockIdx.y;
  const int sub = threadIdx.x % MHA_SPLIT;
  const int j = blockIdx.x * MHA_ROWS + threadIdx.x / MHA_SPLIT;
  const bool valid = j < T;
  const size_t base = (size_t)bh * T * D;
  const size_t rbase = (size_t)bh * T;

  float kj[MAXD], vj[MAXD], ak[MAXD], av[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    kj[d] = valid && d < D ? ld(k + base + (size_t)j * D + d) : 0.f;
    vj[d] = valid && d < D ? ld(v + base + (size_t)j * D + d) : 0.f;
    ak[d] = av[d] = 0.f;
  }

  for (int i0 = 0; i0 < T; i0 += MHA_TILE) {
    __syncthreads();
    stage_tile<MAXD>(q + base, dout + base, qs, gs, i0, T, D);
    for (int r = threadIdx.x; r < MHA_TILE; r += blockDim.x) {
      ls[r] = i0 + r < T ? lse[rbase + i0 + r] : 0.f;
      dls[r] = i0 + r < T ? delta[rbase + i0 + r] : 0.f;
    }
    __syncthreads();
    if (!valid) continue;
    const int ni = min(MHA_TILE, T - i0);
#pragma unroll 4
    for (int t = 0; t < MHA_TILE / MHA_SPLIT; ++t) {
      const int ii = sub + t * MHA_SPLIT;
      if (ii >= ni) break;
      float s = 0.f, dov = 0.f;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        s = fmaf(qs[ii][d], kj[d], s);
        dov = fmaf(gs[ii][d], vj[d], dov);
      }
      const float p = expf(s - ls[ii]);
      const float kp = keep(drop, (uint32_t)(rbase + i0 + ii), (uint32_t)j);
      const float pd = p * kp;
      const float dsv = p * (kp * dov - dls[ii]);
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        av[d] = fmaf(pd, gs[ii][d], av[d]);
        ak[d] = fmaf(dsv, qs[ii][d], ak[d]);
      }
    }
  }
  sum_split<MAXD>(ak);
  sum_split<MAXD>(av);
  if (valid && sub == 0) {
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) {
        st(dk + base + (size_t)j * D + d, ak[d]);
        st(dv + base + (size_t)j * D + d, av[d]);
      }
  }
}

// dq of MHA_ROWS queries of one (b, h), looping over every key.
// grid (ceil(T / MHA_ROWS), B * H), MHA_THREADS threads.
template <int MAXD, typename S>
__global__ void __launch_bounds__(MHA_THREADS)
    mha_backward_dq_kernel(const S* __restrict__ q, const S* __restrict__ k,
                           const S* __restrict__ v, const S* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           S* __restrict__ dq, int T, int D, Dropout drop) {
  __shared__ float ks[MHA_TILE][MAXD + 1];
  __shared__ float vs[MHA_TILE][MAXD + 1];
  const int bh = blockIdx.y;
  const int sub = threadIdx.x % MHA_SPLIT;
  const int i = blockIdx.x * MHA_ROWS + threadIdx.x / MHA_SPLIT;
  const bool valid = i < T;
  const size_t base = (size_t)bh * T * D;
  const size_t r = (size_t)bh * T + i;

  float qi[MAXD], gi[MAXD], aq[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    qi[d] = valid && d < D ? ld(q + base + (size_t)i * D + d) : 0.f;
    gi[d] = valid && d < D ? ld(dout + base + (size_t)i * D + d) : 0.f;
    aq[d] = 0.f;
  }
  const float li = valid ? lse[r] : 0.f;
  const float di = valid ? delta[r] : 0.f;

  for (int j0 = 0; j0 < T; j0 += MHA_TILE) {
    __syncthreads();
    stage_tile<MAXD>(k + base, v + base, ks, vs, j0, T, D);
    __syncthreads();
    if (!valid) continue;
    const int nk = min(MHA_TILE, T - j0);
#pragma unroll 4
    for (int t = 0; t < MHA_TILE / MHA_SPLIT; ++t) {
      const int jj = sub + t * MHA_SPLIT;
      if (jj >= nk) break;
      float s = 0.f, dov = 0.f;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        s = fmaf(qi[d], ks[jj][d], s);
        dov = fmaf(gi[d], vs[jj][d], dov);
      }
      const float p = expf(s - li);
      const float kp = keep(drop, (uint32_t)r, (uint32_t)(j0 + jj));
      const float dsv = p * (kp * dov - di);
#pragma unroll
      for (int d = 0; d < MAXD; ++d) aq[d] = fmaf(dsv, ks[jj][d], aq[d]);
    }
  }
  sum_split<MAXD>(aq);
  if (valid && sub == 0) {
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d < D) st(dq + base + (size_t)i * D + d, aq[d]);
  }
}

static bool mha_shape_ok(int BH, int T, int D) {
  return BH >= 1 && BH <= 65535 && T >= 1 && D >= 1 && D <= 64;
}

template <typename S>
static int launch_forward(const S* q, const S* k, const S* v, S* out, float* out32, float* lse,
                          int BH, int T, int D, int seed, double rate, cudaStream_t stream) {
  if (!mha_shape_ok(BH, T, D)) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, MHA_DRAW, rate);
  const dim3 grid((unsigned)((T + MHA_ROWS - 1) / MHA_ROWS), (unsigned)BH);
  if (D <= 16)
    mha_forward_kernel<16, S><<<grid, MHA_THREADS, 0, stream>>>(q, k, v, out, out32, lse, T, D,
                                                                drop);
  else
    mha_forward_kernel<64, S><<<grid, MHA_THREADS, 0, stream>>>(q, k, v, out, out32, lse, T, D,
                                                                drop);
  return (int)cudaGetLastError();
}

template <typename S>
static cudaError_t launch_delta(const float* out, const S* dout, float* delta, int BH, int T,
                                int D, cudaStream_t stream) {
  const long long rows = (long long)BH * T;
  long long blocks = (rows + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  mha_delta_kernel<S><<<(int)blocks, 256, 0, stream>>>(out, dout, delta, rows, D);
  return cudaGetLastError();
}

template <typename S>
static int launch_backward(const S* q, const S* k, const S* v, const float* out, const S* dout,
                           const float* lse, S* dq, S* dk, S* dv, float* delta, int BH, int T,
                           int D, int seed, double rate, cudaStream_t stream) {
  if (!mha_shape_ok(BH, T, D)) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, MHA_DRAW, rate);
  cudaError_t err = launch_delta<S>(out, dout, delta, BH, T, D, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + MHA_ROWS - 1) / MHA_ROWS), (unsigned)BH);
  if (D <= 16) {
    mha_backward_dkdv_kernel<16, S><<<grid, MHA_THREADS, 0, stream>>>(q, k, v, dout, lse, delta,
                                                                      dk, dv, T, D, drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    mha_backward_dq_kernel<16, S><<<grid, MHA_THREADS, 0, stream>>>(q, k, v, dout, lse, delta, dq,
                                                                    T, D, drop);
  } else {
    mha_backward_dkdv_kernel<64, S><<<grid, MHA_THREADS, 0, stream>>>(q, k, v, dout, lse, delta,
                                                                      dk, dv, T, D, drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    mha_backward_dq_kernel<64, S><<<grid, MHA_THREADS, 0, stream>>>(q, k, v, dout, lse, delta, dq,
                                                                    T, D, drop);
  }
  return (int)cudaGetLastError();
}

// ---- the bf16 form on tensor cores ---------------------------------------------

#define TC_WARPS 4                    // warps a block; each owns 16 rows
#define TC_ROWS (16 * TC_WARPS)       // query (or key) rows a block owns
#define TC_THREADS (32 * TC_WARPS)
// At HCP's shapes (head dim 11: DP 16) a grid has 19 x 16 = 304 blocks:
// three resident an SM (at most 170 registers a thread) take them in one
// wave. The wider head dims keep two (255 registers), where 170 would
// spill.
#define TC_MIN_BLOCKS(DP) ((DP) == 16 ? 3 : 2)
#define TC_LOG2E 1.4426950408889634f
#define TC_LN2 0.69314718055994531f

// The tiles of padded head dim DP (16, 32 or 64): KT rows of the other side
// a shared-memory tile, pitch LD bf16 (DP + 8: the eight 16-byte rows of an
// ldmatrix phase fall in eight different 4-bank groups).
template <int DP>
struct TcShape {
  static constexpr int KT = DP == 64 ? 32 : 64;
  static constexpr int LD = DP + 8;
  static constexpr int NB = KT / 8;                  // n8 blocks of a tile's rows
  static constexpr int KS = DP / 16;                 // k16 steps of the head dim
  static constexpr int DB = DP / 8;                  // n8 blocks of the head dim
  static constexpr int NS = KT * DP / TC_THREADS;    // values a thread stages a tile
};

// x0, x1 split into bf16 halves, packed (x0 in the low 16 bits) as an A
// fragment register each: hi = bf16(x), lo = bf16(x - hi); hi + lo = x to
// 2^-16 |x| (each rounding to nearest keeps 8 bits).
__device__ __forceinline__ void tc_split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A fragments of rows [r0, r0 + 16) of one (b, h)'s (T, D) bf16 matrix,
// zero past T and past D.
template <int KS>
__device__ __forceinline__ void tc_load_a(uint32_t (&a)[KS][4], const __nv_bfloat16* x, int r0,
                                          int T, int D, int g, int t) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), c = 16 * kk + 8 * (e >> 1) + 2 * t;
      uint32_t lo = 0, hi = 0;
      if (r < T) {
        if (c < D) lo = xs[(size_t)r * D + c];
        if (c + 1 < D) hi = xs[(size_t)r * D + c + 1];
      }
      a[kk][e] = lo | hi << 16;
    }
}

// Rows [r0, r0 + KT) of one (b, h)'s (T, D) bf16 matrix into registers: the
// thread's slots tid + s * TC_THREADS of the [KT][DP] tile, zero past T and
// past D (coalesced 2-byte loads; rows are not 4-byte aligned at odd D).
template <int DP>
__device__ __forceinline__ void tc_tile_load(unsigned short (&r)[TcShape<DP>::NS],
                                             const __nv_bfloat16* x, int r0, int T, int D) {
  constexpr int RS = TC_THREADS / DP;   // rows between a thread's slots
  const int row = r0 + threadIdx.x / DP, c = threadIdx.x % DP;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(x) + (size_t)row * D + c;
  const int left = c < D ? T - row : 0;   // slot s is in range iff RS s < left
#pragma unroll
  for (int s = 0; s < TcShape<DP>::NS; ++s)
    r[s] = RS * s < left ? __ldg(src + s * RS * D) : (unsigned short)0;
}

template <int DP>
__device__ __forceinline__ void tc_tile_store(const unsigned short (&r)[TcShape<DP>::NS],
                                              unsigned short (*tile)[TcShape<DP>::LD]) {
#pragma unroll
  for (int s = 0; s < TcShape<DP>::NS; ++s) {
    const int e = threadIdx.x + s * TC_THREADS;
    tile[e / DP][e % DP] = r[s];
  }
}

// c[nb] = a x^T over a staged tile: the tile's rows are the n index (n8
// block nb: rows 8 nb .. 8 nb + 7), the head dim the k index.
template <int DP>
__device__ __forceinline__ void tc_rows(float (&c)[TcShape<DP>::NB][4],
                                        const uint32_t (&a)[TcShape<DP>::KS][4],
                                        const unsigned short (*x)[TcShape<DP>::LD], int lane) {
  using S = TcShape<DP>;
#pragma unroll
  for (int nb = 0; nb < S::NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
#pragma unroll
  for (int p = 0; p < S::NB / 2; ++p)
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk) {
      uint32_t b[4];
      tc_ldsm(b, &x[16 * p + 8 * (lane >> 4) + (lane & 7)][16 * kk + 8 * ((lane >> 3) & 1)]);
      tc_mma(c[2 * p], a[kk], b[0], b[1]);
      tc_mma(c[2 * p + 1], a[kk], b[2], b[3]);
    }
}

// acc[db] += (hi + lo) x[16 p .. 16 p + 16): the A halves' k index is the
// tile's rows 16 p .., the head dim the n index (n8 block db).
template <int DP>
__device__ __forceinline__ void tc_cols(float (&acc)[TcShape<DP>::DB][4], const uint32_t (&hi)[4],
                                        const uint32_t (&lo)[4],
                                        const unsigned short (*x)[TcShape<DP>::LD], int p,
                                        int lane) {
#pragma unroll
  for (int dp = 0; dp < TcShape<DP>::DB / 2; ++dp) {
    uint32_t b[4];
    tc_ldsm_t(b, &x[16 * p + 8 * ((lane >> 3) & 1) + (lane & 7)][16 * dp + 8 * (lane >> 4)]);
    tc_mma(acc[2 * dp], hi, b[0], b[1]);
    tc_mma(acc[2 * dp + 1], hi, b[2], b[3]);
    tc_mma(acc[2 * dp], lo, b[0], b[1]);
    tc_mma(acc[2 * dp + 1], lo, b[2], b[3]);
  }
}

// Store a C-layout (16 rows, DP) accumulator of rows r0 .. r0 + 15 times
// scale[row half], as bf16 and, where f32 is not NULL, as f32.
template <int DP>
__device__ __forceinline__ void tc_store(const float (&acc)[TcShape<DP>::DB][4],
                                         const float (&scale)[2], __nv_bfloat16* out16,
                                         float* out32, int r0, int T, int D, int g, int t) {
#pragma unroll
  for (int db = 0; db < TcShape<DP>::DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = 8 * db + 2 * t + (e & 1);
      if (r < T && c < D) {
        const float o = acc[db][e] * scale[e >> 1];
        out16[(size_t)r * D + c] = __float2bfloat16_rn(o);
        if (out32) out32[(size_t)r * D + c] = o;
      }
    }
}

// grid (ceil(T / TC_ROWS), B * H), TC_THREADS threads; a warp owns 16 query
// rows and streams every key tile. out32 and lse may be NULL.
template <int DP, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS(DP))
    mha_forward_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ out32, float* __restrict__ lse, int T, int D,
                          Dropout drop) {
  using S = TcShape<DP>;
  __shared__ __align__(16) unsigned short ks[2][S::KT][S::LD];
  __shared__ __align__(16) unsigned short vs[2][S::KT][S::LD];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, i0 = blockIdx.x * TC_ROWS + (threadIdx.x >> 5) * 16;
  const size_t base = (size_t)bh * T * D;
  const uint32_t hrow = (uint32_t)bh * (uint32_t)T + (uint32_t)(i0 + g);
  const uint32_t hr[2] = {keep_row(drop, hrow), keep_row(drop, hrow + 8)};   // rows g, g + 8

  uint32_t qa[S::KS][4];
  tc_load_a<S::KS>(qa, q + base, i0, T, D, g, t);
  float o[S::DB][4];
#pragma unroll
  for (int db = 0; db < S::DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[db][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // m in log2 units

  unsigned short kr[S::NS], vr[S::NS];
  tc_tile_load<DP>(kr, k + base, 0, T, D);
  tc_tile_load<DP>(vr, v + base, 0, T, D);
  tc_tile_store<DP>(kr, ks[0]);
  tc_tile_store<DP>(vr, vs[0]);
  __syncthreads();
  const int tiles = (T + S::KT - 1) / S::KT;
  for (int n = 0; n < tiles; ++n) {
    const int j0 = n * S::KT, cur = n & 1;
    if (n + 1 < tiles) {   // the next tile's loads fly while this one computes
      tc_tile_load<DP>(kr, k + base, j0 + S::KT, T, D);
      tc_tile_load<DP>(vr, v + base, j0 + S::KT, T, D);
    }
    float s[S::NB][4];
    tc_rows<DP>(s, qa, ks[cur], lane);
    if (j0 + S::KT > T) {   // keys past T never enter m or l
#pragma unroll
      for (int nb = 0; nb < S::NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * nb + 2 * t + (e & 1) >= T) s[nb][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < S::NB; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(MNT_FULL_MASK, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(MNT_FULL_MASK, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h] * TC_LOG2E);
      corr[h] = tc_ex2(m[h] - mn);   // 0 on the first tile (m = -inf)
      m[h] = mn;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int db = 0; db < S::DB; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[db][e] *= corr[e >> 1];
#pragma unroll
    for (int p = 0; p < S::NB / 2; ++p) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nb = 2 * p + h;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = tc_ex2(fmaf(s[nb][e], TC_LOG2E, -m[e >> 1]));
        l[0] += x[0] + x[1];
        l[1] += x[2] + x[3];
        if (DROP) {
          const uint32_t col = (uint32_t)(j0 + 8 * nb + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] *= keep_at(drop, hr[e >> 1], col + (e & 1));
        }
        tc_split(x[0], x[1], hi[2 * h], lo[2 * h]);
        tc_split(x[2], x[3], hi[2 * h + 1], lo[2 * h + 1]);
      }
      tc_cols<DP>(o, hi, lo, vs[cur], p, lane);
    }
    if (n + 1 < tiles) {
      tc_tile_store<DP>(kr, ks[cur ^ 1]);
      tc_tile_store<DP>(vr, vs[cur ^ 1]);
    }
    __syncthreads();
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(MNT_FULL_MASK, l[h], 1);
    l[h] += __shfl_xor_sync(MNT_FULL_MASK, l[h], 2);
    inv[h] = 1.f / l[h];
  }
  tc_store<DP>(o, inv, out + base, out32 ? out32 + base : nullptr, i0, T, D, g, t);
  if (lse && t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i0 + g + 8 * h;
      if (r < T) lse[(size_t)bh * T + r] = m[h] * TC_LN2 + logf(l[h]);
    }
}

// dk, dv of TC_ROWS keys of one (b, h), a warp's 16 keys as A fragments,
// streaming every query tile (q, dout, lse, delta).
// grid (ceil(T / TC_ROWS), B * H), TC_THREADS threads.
template <int DP, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS(DP))
    mha_backward_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                int T, int D, Dropout drop) {
  using S = TcShape<DP>;
  __shared__ __align__(16) unsigned short qs[2][S::KT][S::LD];
  __shared__ __align__(16) unsigned short gs[2][S::KT][S::LD];
  __shared__ __align__(16) float ls[2][S::KT];    // lse * log2(e) of the tile's rows
  __shared__ __align__(16) float dls[2][S::KT];   // delta of the tile's rows
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, j0 = blockIdx.x * TC_ROWS + (threadIdx.x >> 5) * 16;
  const size_t base = (size_t)bh * T * D, rbase = (size_t)bh * T;

  uint32_t ka[S::KS][4], va[S::KS][4];
  tc_load_a<S::KS>(ka, k + base, j0, T, D, g, t);
  tc_load_a<S::KS>(va, v + base, j0, T, D, g, t);
  float dka[S::DB][4], dva[S::DB][4];
#pragma unroll
  for (int db = 0; db < S::DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[db][e] = dva[db][e] = 0.f;

  // rows past T stage zero q and dout and lse = delta = 0: p = 1, ds = 0,
  // and their zero rows add nothing to dk or dv
  unsigned short qr[S::NS], gr[S::NS];
  float lr = 0.f, dr = 0.f;
  const int tid = threadIdx.x;
  tc_tile_load<DP>(qr, q + base, 0, T, D);
  tc_tile_load<DP>(gr, dout + base, 0, T, D);
  if (tid < S::KT && tid < T) {
    lr = lse[rbase + tid] * TC_LOG2E;
    dr = delta[rbase + tid];
  }
  tc_tile_store<DP>(qr, qs[0]);
  tc_tile_store<DP>(gr, gs[0]);
  if (tid < S::KT) {
    ls[0][tid] = lr;
    dls[0][tid] = dr;
  }
  __syncthreads();
  const int tiles = (T + S::KT - 1) / S::KT;
  for (int n = 0; n < tiles; ++n) {
    const int i0 = n * S::KT, cur = n & 1;
    if (n + 1 < tiles) {
      const int nx = i0 + S::KT;
      tc_tile_load<DP>(qr, q + base, nx, T, D);
      tc_tile_load<DP>(gr, dout + base, nx, T, D);
      lr = dr = 0.f;
      if (tid < S::KT && nx + tid < T) {
        lr = lse[rbase + nx + tid] * TC_LOG2E;
        dr = delta[rbase + nx + tid];
      }
    }
    float st[S::NB][4], dpt[S::NB][4];   // s^T = k q^T, dP^T = v dout^T: rows keys
    tc_rows<DP>(st, ka, qs[cur], lane);
    tc_rows<DP>(dpt, va, gs[cur], lane);
#pragma unroll
    for (int p = 0; p < S::NB / 2; ++p) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nb = 2 * p + h, c = 8 * nb + 2 * t;   // the tile's query c, c + 1
        const float2 lc = *reinterpret_cast<const float2*>(&ls[cur][c]);
        const float2 dc = *reinterpret_cast<const float2*>(&dls[cur][c]);
        uint32_t hq[2] = {0u, 0u};   // the hash's row parts of queries c, c + 1
        if (DROP) {
          hq[0] = keep_row(drop, (uint32_t)(rbase + i0 + c));
          hq[1] = keep_row(drop, (uint32_t)(rbase + i0 + c + 1));
        }
        float pk[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = tc_ex2(fmaf(st[nb][e], TC_LOG2E, -(e & 1 ? lc.y : lc.x)));
          float kp = 1.f;
          if (DROP) kp = keep_at(drop, hq[e & 1], (uint32_t)(j0 + g + 8 * (e >> 1)));
          pk[e] = pe * kp;
          ds[e] = pe * (kp * dpt[nb][e] - (e & 1 ? dc.y : dc.x));
        }
        tc_split(pk[0], pk[1], ph[2 * h], pl[2 * h]);
        tc_split(pk[2], pk[3], ph[2 * h + 1], pl[2 * h + 1]);
        tc_split(ds[0], ds[1], sh[2 * h], sl[2 * h]);
        tc_split(ds[2], ds[3], sh[2 * h + 1], sl[2 * h + 1]);
      }
      tc_cols<DP>(dva, ph, pl, gs[cur], p, lane);
      tc_cols<DP>(dka, sh, sl, qs[cur], p, lane);
    }
    if (n + 1 < tiles) {
      tc_tile_store<DP>(qr, qs[cur ^ 1]);
      tc_tile_store<DP>(gr, gs[cur ^ 1]);
      if (tid < S::KT) {
        ls[cur ^ 1][tid] = lr;
        dls[cur ^ 1][tid] = dr;
      }
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  tc_store<DP>(dka, one, dk + base, nullptr, j0, T, D, g, t);
  tc_store<DP>(dva, one, dv + base, nullptr, j0, T, D, g, t);
}

// dq of TC_ROWS queries of one (b, h), a warp's 16 queries (q and dout as A
// fragments), streaming every key tile (k, v).
// grid (ceil(T / TC_ROWS), B * H), TC_THREADS threads.
template <int DP, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS(DP))
    mha_backward_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int T, int D, Dropout drop) {
  using S = TcShape<DP>;
  __shared__ __align__(16) unsigned short ks[2][S::KT][S::LD];
  __shared__ __align__(16) unsigned short vs[2][S::KT][S::LD];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, i0 = blockIdx.x * TC_ROWS + (threadIdx.x >> 5) * 16;
  const size_t base = (size_t)bh * T * D, rbase = (size_t)bh * T;
  const uint32_t hr[2] = {keep_row(drop, (uint32_t)(rbase + i0 + g)),
                          keep_row(drop, (uint32_t)(rbase + i0 + g + 8))};   // rows g, g + 8

  uint32_t qa[S::KS][4], ga[S::KS][4];
  tc_load_a<S::KS>(qa, q + base, i0, T, D, g, t);
  tc_load_a<S::KS>(ga, dout + base, i0, T, D, g, t);
  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = i0 + g + 8 * h;
    lr[h] = r < T ? lse[rbase + r] * TC_LOG2E : 0.f;
    dl[h] = r < T ? delta[rbase + r] : 0.f;
  }
  float dqa[S::DB][4];
#pragma unroll
  for (int db = 0; db < S::DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[db][e] = 0.f;

  unsigned short kr[S::NS], vr[S::NS];
  tc_tile_load<DP>(kr, k + base, 0, T, D);
  tc_tile_load<DP>(vr, v + base, 0, T, D);
  tc_tile_store<DP>(kr, ks[0]);
  tc_tile_store<DP>(vr, vs[0]);
  __syncthreads();
  const int tiles = (T + S::KT - 1) / S::KT;
  for (int n = 0; n < tiles; ++n) {
    const int j0 = n * S::KT, cur = n & 1;
    if (n + 1 < tiles) {
      tc_tile_load<DP>(kr, k + base, j0 + S::KT, T, D);
      tc_tile_load<DP>(vr, v + base, j0 + S::KT, T, D);
    }
    float s[S::NB][4], dp[S::NB][4];   // s = q k^T, dP = dout v^T
    tc_rows<DP>(s, qa, ks[cur], lane);
    tc_rows<DP>(dp, ga, vs[cur], lane);
    const bool tail = j0 + S::KT > T;
#pragma unroll
    for (int p = 0; p < S::NB / 2; ++p) {
      uint32_t sh[4], sl[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nb = 2 * p + h, col = j0 + 8 * nb + 2 * t;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = tc_ex2(fmaf(s[nb][e], TC_LOG2E, -lr[e >> 1]));
          float kp = 1.f;
          if (DROP) kp = keep_at(drop, hr[e >> 1], (uint32_t)(col + (e & 1)));
          ds[e] = pe * (kp * dp[nb][e] - dl[e >> 1]);
          if (tail && col + (e & 1) >= T) ds[e] = 0.f;   // keys past T
        }
        tc_split(ds[0], ds[1], sh[2 * h], sl[2 * h]);
        tc_split(ds[2], ds[3], sh[2 * h + 1], sl[2 * h + 1]);
      }
      tc_cols<DP>(dqa, sh, sl, ks[cur], p, lane);
    }
    if (n + 1 < tiles) {
      tc_tile_store<DP>(kr, ks[cur ^ 1]);
      tc_tile_store<DP>(vr, vs[cur ^ 1]);
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  tc_store<DP>(dqa, one, dq + base, nullptr, i0, T, D, g, t);
}

template <int DP, bool DROP>
static cudaError_t tc_forward(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* out, float* out32,
                              float* lse, int BH, int T, int D, Dropout drop,
                              cudaStream_t stream) {
  const dim3 grid((unsigned)((T + TC_ROWS - 1) / TC_ROWS), (unsigned)BH);
  mha_forward_tc_kernel<DP, DROP><<<grid, TC_THREADS, 0, stream>>>(q, k, v, out, out32, lse, T, D,
                                                                   drop);
  return cudaGetLastError();
}

template <int DP, bool DROP>
static cudaError_t tc_backward(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const __nv_bfloat16* dout,
                               const float* lse, const float* delta, __nv_bfloat16* dq,
                               __nv_bfloat16* dk, __nv_bfloat16* dv, int BH, int T, int D,
                               Dropout drop, cudaStream_t stream) {
  const dim3 grid((unsigned)((T + TC_ROWS - 1) / TC_ROWS), (unsigned)BH);
  mha_backward_dkdv_tc_kernel<DP, DROP><<<grid, TC_THREADS, 0, stream>>>(q, k, v, dout, lse, delta,
                                                                         dk, dv, T, D, drop);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_backward_dq_tc_kernel<DP, DROP><<<grid, TC_THREADS, 0, stream>>>(q, k, v, dout, lse, delta,
                                                                       dq, T, D, drop);
  return cudaGetLastError();
}

// ---- the float32 form on tensor cores (3xTF32) ----------------------------------
//
// The bf16 form's structure on mma.sync.m16n8k8 TF32: every float32 operand
// split into (big, small) = (tf32(x), tf32(x - big)) (common.cuh
// tf32_split), each product c += a b taken as small_a big_b + big_a small_b
// into one accumulator and big_a big_b into another, added at the end (K1's
// t32_* arithmetic; ops/attention.py mha_reference_3xtf32 models it).
//
// The tensor cores add a product's terms into the accumulator with
// truncation, not rounding to nearest, so a sum over the whole sequence in
// one accumulator drifts: the big terms of p v, p^T dO, ds^T q and ds k are
// summed a tile at a time from zero (t3_flush), each tile's sum added to
// the running total in float32. Summed over all 1201 keys in one
// accumulator, the output's float64 error came out several times the
// CUDA-core form's and max |sum_j dk_j| past its bound (H100, HCP's
// shape); a tile at a time, both are below the CUDA-core form's.
//
// The k index of every product is permuted within each k8 step: A and B
// slot t hold column 2t of the step, slot t + 4 column 2t + 1. The two
// columns a lane holds of a C fragment (2t, 2t + 1) are then the A slots t,
// t + 4 of the next product: the scores' fragments go straight into p v
// (and p^T dO, ds^T q, ds k) with no shuffle. A lane's B operands of a step
// are one 16-byte shared load of {big(2t), big(2t + 1), small(2t), small(2t
// + 1)}: the register pairs the three mma read, with no move between.
//
// Shared tiles, each staged once a tile for the block and already split,
// in those 4-float groups:
//  - rows [KT][DP] (pitch T3Shape::LR): the B operand of a product whose n
//    index is the tile's rows (q k^T, dO v^T, k q^T, v dO^T); a group is
//    two head-dim columns of a row;
//  - columns [DP][KT] (pitch LT): the B operand of one whose k index is the
//    tile's rows (p v, ds k, p^T dO, ds^T q); a group is two rows of a
//    head-dim column.
// Only the head dim's D columns are staged (a row of 11 floats is 44 bytes:
// 4-byte loads); the padding is zeroed once. Each thread stages whole
// groups (one 16-byte store each), consecutive lanes on consecutive groups
// of a row (rows tiles) or of a column (columns tiles), the next tile's
// values in flight in registers while the current one is computed (through
// cp.async and a raw shared buffer it was slower).
//
// What bounds the form on the H100 at HCP's shapes: integer instructions
// more than the tensor cores (PERF.md §6). About half of the key-tile
// kernel's instructions are integer, which the card runs at half the
// float32 rate: the rounding of every split (two to three each),
// the dropout hash (eight a score at rate > 0), addresses. Hence the
// groups above (no register moves before an mma), only D of the DP
// columns staged, no store branched around, the hash's parts hoisted
// (t3_keep), and the query-tile kernel overlapping the key-tile one. The
// grid is 304 blocks of 4 warps, three an SM at most (168 registers a
// thread).

// floats of a shared row of n values as (big, small): 2n, padded to 16 mod
// 32 so that the 16-byte fragment loads of a quarter warp (rows g and g + 1,
// lanes t) fall on distinct banks
__host__ __device__ constexpr int t3_pitch(int n) {
  return (2 * n) % 32 == 16 ? 2 * n : 2 * n + 16;
}

template <int DP>
struct T3Shape {
  static constexpr int KT = DP == 64 ? 32 : 64;      // rows of the other side a tile
  static constexpr int NB = KT / 8;                  // n8 blocks (k8 steps) of a tile's rows
  static constexpr int KS = DP / 8;                  // k8 steps (n8 blocks) of the head dim
  static constexpr int LR = t3_pitch(DP);
  static constexpr int LT = t3_pitch(KT);
  static constexpr int ROWS = KT * LR;               // floats of a rows tile
  static constexpr int COLS = DP * LT;               // floats of a columns tile
  // a thread's groups of a rows or a columns tile, at most (D = DP)
  static constexpr int NG = (KT * DP / 2 + TC_THREADS - 1) / TC_THREADS;
  static constexpr int KH = KT / 2;                  // groups of a column
};

// Blocks an SM at which each head dim is compiled: at HCP's shapes (DP 16)
// the grid's 304 blocks fit in one wave at three (at most 170 registers a
// thread); the wider head dims hold twice and four times the fragments.
#define T3_MIN_BLOCKS(DP) ((DP) == 16 ? 3 : (DP) == 32 ? 2 : 1)

// Two shared stages where they fit T3_MIN_BLOCKS blocks an SM (one barrier a
// tile), else one (two barriers a tile).
__host__ __device__ constexpr int t3_stages(int floats, int blocks) {
  return 2 * floats * 4 * blocks <= 216 * 1024 ? 2 : 1;
}

template <int DP, int STAGE>
struct T3Smem {
  static constexpr int STAGES = t3_stages(STAGE, T3_MIN_BLOCKS(DP));
  static constexpr int BYTES = STAGES * STAGE * (int)sizeof(float);
};

__device__ __forceinline__ uint32_t t3_bits(float v) { return __float_as_uint(v); }

// Zero the block's dynamic shared memory (the padding no staging writes).
__device__ __forceinline__ void t3_zero(float* smem, int floats) {
  for (int i = 4 * threadIdx.x; i < floats; i += 4 * TC_THREADS)
    *reinterpret_cast<float4*>(smem + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// x0, x1 split into a 4-float group {big0, big1, small0, small1} at dst.
__device__ __forceinline__ void t3_store_group(float* dst, float x0, float x1) {
  uint32_t b0, s0, b1, s1;
  tf32_split(x0, b0, s0);
  tf32_split(x1, b1, s1);
  *reinterpret_cast<uint4*>(dst) = make_uint4(b0, b1, s0, s1);
}

// A thread's groups of a rows tile: group i = tid + n TC_THREADS of the
// tile's KT ceil(D / 2) groups is row i / ceil(D / 2), head-dim columns 2m,
// 2m + 1 (m = i % ceil(D / 2)). o[n] packs its element offset in a tile of
// the (T, D) matrix (row D + 2m; 0xFFFF: no group) in the low half and its
// float offset in the shared tile (row LR + 4m, + 1 where column 2m + 1 is
// past D; for no group 2 DP, the padding of row 0, which no fragment reads,
// so that every store is made and none is branched around) in the high
// half. Fixed for the kernel: a tile of KT rows is one contiguous run of KT
// D elements.
template <int DP>
struct T3RowGroups {
  uint32_t o[T3Shape<DP>::NG];
  int groups;   // the tile's groups: slot n is in use where n TC_THREADS < groups
  __device__ __forceinline__ explicit T3RowGroups(int D) {
    const int P = (D + 1) / 2;
    groups = T3Shape<DP>::KT * P;
#pragma unroll
    for (int n = 0; n < T3Shape<DP>::NG; ++n) {
      const int i = threadIdx.x + n * TC_THREADS, r = i / P, m = i - r * P;
      const uint32_t so = r * T3Shape<DP>::LR + 4 * m + (2 * m + 1 >= D);
      o[n] = r < T3Shape<DP>::KT ? so << 16 | (uint32_t)(r * D + 2 * m) : 2 * DP << 16 | 0xFFFFu;
    }
  }
};

// The values of a thread's groups of the rows tile whose first element is
// `tile`, zero past the `valid` elements of the matrix left from it.
template <int DP>
__device__ __forceinline__ void t3_load_rows(float (&v)[T3Shape<DP>::NG][2],
                                             const T3RowGroups<DP>& gr, const float* tile,
                                             int valid) {
  const uint32_t left = min(valid, T3Shape<DP>::KT * DP);   // below 0xFFFF
#pragma unroll
  for (int n = 0; n < T3Shape<DP>::NG; ++n) {
    if (n * TC_THREADS >= gr.groups) break;   // no thread has a group here
    const uint32_t go = gr.o[n] & 0xFFFFu;
    const bool in = go < left;
    v[n][0] = in ? __ldg(tile + go) : 0.f;
    v[n][1] = in && !(gr.o[n] >> 16 & 1) ? __ldg(tile + go + 1) : 0.f;
  }
}

template <int DP>
__device__ __forceinline__ void t3_store_rows(const float (&v)[T3Shape<DP>::NG][2],
                                              const T3RowGroups<DP>& gr, float* tile) {
#pragma unroll
  for (int n = 0; n < T3Shape<DP>::NG && n * TC_THREADS < gr.groups; ++n)
    t3_store_group(tile + (gr.o[n] >> 17 << 1), v[n][0], v[n][1]);
}

// A thread's groups of a columns tile: group i = tid + n TC_THREADS of the
// tile's DP KH groups is head-dim column i / KH, rows 2m, 2m + 1 (m = i %
// KH); only the columns below D are staged (a group past them is stored to
// 2 KT, the padding of column 0, which no fragment reads). `tile` is the
// first element of the tile's rows in the (T, D) matrix, `rows` the rows
// left in it.
template <int DP>
__device__ __forceinline__ void t3_load_cols(float (&v)[T3Shape<DP>::NG][2], const float* tile,
                                             int rows, int D) {
  constexpr int KH = T3Shape<DP>::KH, CS = TC_THREADS / KH;   // columns between a thread's groups
  const int m = threadIdx.x % KH, c = threadIdx.x / KH;
  const float* src = tile + 2 * m * D + c;
#pragma unroll
  for (int n = 0; n < T3Shape<DP>::NG && CS * n < D; ++n) {   // some thread's column below D
    const bool in = c + CS * n < D;
    v[n][0] = in && 2 * m < rows ? __ldg(src + CS * n) : 0.f;
    v[n][1] = in && 2 * m + 1 < rows ? __ldg(src + CS * n + D) : 0.f;
  }
}

template <int DP>
__device__ __forceinline__ void t3_store_cols(const float (&v)[T3Shape<DP>::NG][2], float* tile,
                                              int D) {
  constexpr int KH = T3Shape<DP>::KH, CS = TC_THREADS / KH;
  const int m = threadIdx.x % KH, c = threadIdx.x / KH;
  float* dst = tile + c * T3Shape<DP>::LT + 4 * m;
#pragma unroll
  for (int n = 0; n < T3Shape<DP>::NG && CS * n < D; ++n)
    t3_store_group(c + CS * n < D ? dst + CS * n * T3Shape<DP>::LT : tile + 2 * T3Shape<DP>::KT,
                   v[n][0], v[n][1]);
}

// K6's dropout decision (common.cuh keep_at) with its parts hoisted: the
// first step of fmix32, u ^= u >> 16, is linear over xor, so the row part
// and the column product each take it apart (t3_row, t3_col) where they
// are fixed; and after the last step (u ^= u >> 16) u >= thr is (u ^ (thr
// >> 16)) >= thr, the step keeping the high half and xoring it into the low
// half. t3_keep(d, t3_row(d, r), t3_col(c)) is keep_at(d, keep_row(d, r), c).
__device__ __forceinline__ uint32_t t3_mix(uint32_t x) { return x ^ (x >> 16); }

__device__ __forceinline__ uint32_t t3_row(const Dropout& d, uint32_t r) {
  return t3_mix(keep_row(d, r));
}

__device__ __forceinline__ uint32_t t3_col(uint32_t c) { return t3_mix(c * 668265261u); }

__device__ __forceinline__ float t3_keep(const Dropout& d, uint32_t row, uint32_t col) {
  uint32_t u = (row ^ col) * 0x85EBCA6Bu;
  u = (u ^ (u >> 13)) * 0xC2B2AE35u;
  return (u ^ (d.thr >> 16)) >= d.thr ? d.scale : 0.f;
}

// The split A fragments of rows [r0, r0 + 16) of one (b, h)'s (T, D)
// matrix, zero past T and past D: k8 step kk, a0 (g, 2t), a1 (g + 8, 2t),
// a2 (g, 2t + 1), a3 (g + 8, 2t + 1) of columns 8 kk ...
template <int KS>
__device__ __forceinline__ void t3_load_a(uint32_t (&ab)[KS][4], uint32_t (&as)[KS][4],
                                          const float* x, int r0, int T, int D, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1), c = 8 * kk + 2 * t + (e >> 1);
      tf32_split(r < T && c < D ? __ldg(x + (size_t)r * D + c) : 0.f, ab[kk][e], as[kk][e]);
    }
}

// A C fragment of values x (rows g, g + 8; columns 2t, 2t + 1 of an n8
// block) split into the A fragment of the k8 step over those columns.
__device__ __forceinline__ void t3_c2a(const float (&x)[4], uint32_t (&ab)[4], uint32_t (&as)[4]) {
  tf32_split(x[0], ab[0], as[0]);
  tf32_split(x[2], ab[1], as[1]);
  tf32_split(x[1], ab[2], as[2]);
  tf32_split(x[3], ab[3], as[3]);
}

// c += a b in 3xTF32: the small terms into cs, big_a big_b into c. w: {b0
// big, b1 big, b0 small, b1 small}. SWAP takes the two small terms in the
// other order, for a product whose A and B are the other's B and A: k q^T
// in the key-tile kernel adds q_small k_big, then q_big k_small, as q k^T
// in the forward and the query-tile kernel does (each product of two TF32
// values is exact, so a b and b a are the same term).
template <bool SWAP>
__device__ __forceinline__ void t3_mma(float (&c)[4], float (&cs)[4], const uint32_t (&ab)[4],
                                       const uint32_t (&as)[4], const float4& w) {
  const uint32_t b0 = t3_bits(w.x), b1 = t3_bits(w.y), s0 = t3_bits(w.z), s1 = t3_bits(w.w);
  if (SWAP) {
    mma_tf32(cs, ab, s0, s1);
    mma_tf32(cs, as, b0, b1);
  } else {
    mma_tf32(cs, as, b0, b1);
    mma_tf32(cs, ab, s0, s1);
  }
  mma_tf32(c, ab, b0, b1);
}

// s = a x^T for n8 block nb of a rows tile x: the head dim's k8 steps in
// order, c + cs at the end. The forward's q k^T, the query-tile kernel's q
// k^T (SWAP false: A = q, B = k) and the key-tile kernel's k q^T (SWAP true:
// A = k, B = q) all go through here with the same split of q and k, so each
// score is the same float32 value in all three kernels, and the backward's
// p = exp(s - lse) is the p the forward normalised.
template <int DP, bool SWAP>
__device__ __forceinline__ void t3_scores(float (&s)[4], const uint32_t (&ab)[DP / 8][4],
                                          const uint32_t (&as)[DP / 8][4], const float* x, int nb,
                                          int g, int t) {
  const float* row = x + (8 * nb + g) * T3Shape<DP>::LR + 4 * t;
  float c[4] = {0.f, 0.f, 0.f, 0.f}, cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
    t3_mma<SWAP>(c, cs, ab[kk], as[kk], *reinterpret_cast<const float4*>(row + 16 * kk));
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = c[e] + cs[e];
}

// c[db] += (ab, as) x[k8 step p] over the head dim's n8 blocks db, x a
// columns tile (the small terms into cs).
template <int DP>
__device__ __forceinline__ void t3_cols(float (&c)[DP / 8][4], float (&cs)[DP / 8][4],
                                        const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                        const float* x, int p, int g, int t) {
  const float* col = x + g * T3Shape<DP>::LT + 16 * p + 4 * t;
#pragma unroll
  for (int db = 0; db < DP / 8; ++db)
    t3_mma<false>(c[db], cs[db], ab, as,
                  *reinterpret_cast<const float4*>(col + 8 * db * T3Shape<DP>::LT));
}

// acc += c, then c = 0: a tile's big terms into the running total.
template <int KS>
__device__ __forceinline__ void t3_flush(float (&acc)[KS][4], float (&c)[KS][4]) {
#pragma unroll
  for (int db = 0; db < KS; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[db][e] += c[db][e];
      c[db][e] = 0.f;
    }
}

// Store (c + cs) scale[row half] of a C-layout (16 rows, DP) accumulator of
// rows r0 .. r0 + 15.
template <int DP>
__device__ __forceinline__ void t3_store(const float (&c)[DP / 8][4], const float (&cs)[DP / 8][4],
                                         const float (&scale)[2], float* out, int r0, int T, int D,
                                         int g, int t) {
#pragma unroll
  for (int db = 0; db < DP / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), col = 8 * db + 2 * t + (e & 1);
      if (r < T && col < D) out[(size_t)r * D + col] = (c[db][e] + cs[db][e]) * scale[e >> 1];
    }
}

// shared floats of the forward: a stage is k's rows tile and v's columns
// tile
template <int DP>
using T3Fwd = T3Smem<DP, T3Shape<DP>::ROWS + T3Shape<DP>::COLS>;

// grid (ceil(T / TC_ROWS), B * H), TC_THREADS threads; a warp owns 16 query
// rows and streams every key tile. lse may be NULL.
template <int DP, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, T3_MIN_BLOCKS(DP))
    mha_forward_t32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ lse, int T, int D, Dropout drop) {
  using S = T3Shape<DP>;
  using F = T3Fwd<DP>;
  constexpr int STAGE = S::ROWS + S::COLS;
  extern __shared__ __align__(16) float t3s[];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, i0 = blockIdx.x * TC_ROWS + (threadIdx.x >> 5) * 16;
  const size_t base = (size_t)bh * T * D;
  const float* kb = k + base;
  const float* vb = v + base;
  const uint32_t hrow = (uint32_t)bh * (uint32_t)T + (uint32_t)(i0 + g);
  const uint32_t hr[2] = {t3_row(drop, hrow), t3_row(drop, hrow + 8)};   // rows g, g + 8
  const T3RowGroups<DP> gr(D);

  float kr[S::NG][2], vr[S::NG][2];
  t3_load_rows<DP>(kr, gr, kb, T * D);
  t3_load_cols<DP>(vr, vb, T, D);
  uint32_t qb[S::KS][4], qs[S::KS][4];
  t3_load_a<S::KS>(qb, qs, q + base, i0, T, D, g, t);
  // o: the total of the tiles' big terms; c: this tile's; os: the small
  // terms of all tiles
  float o[S::KS][4], c[S::KS][4], os[S::KS][4];
#pragma unroll
  for (int db = 0; db < S::KS; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[db][e] = c[db][e] = os[db][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // m in log2 units

  t3_zero(t3s, F::STAGES * STAGE);
  __syncthreads();
  t3_store_rows<DP>(kr, gr, t3s);
  t3_store_cols<DP>(vr, t3s + S::ROWS, D);
  __syncthreads();
  const int tiles = (T + S::KT - 1) / S::KT;
  for (int n = 0; n < tiles; ++n) {
    const int j0 = n * S::KT;
    const float* ks = t3s + (n % F::STAGES) * STAGE;
    const float* vs = ks + S::ROWS;
    if (n + 1 < tiles) {   // the next tile's loads fly while this one computes
      const int nx = j0 + S::KT;
      t3_load_rows<DP>(kr, gr, kb + (size_t)nx * D, (T - nx) * D);
      t3_load_cols<DP>(vr, vb + (size_t)nx * D, T - nx, D);
    }
    float s[S::NB][4];
#pragma unroll
    for (int nb = 0; nb < S::NB; ++nb) t3_scores<DP, false>(s[nb], qb, qs, ks, nb, g, t);
    if (j0 + S::KT > T) {   // keys past T never enter m or l
#pragma unroll
      for (int nb = 0; nb < S::NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * nb + 2 * t + (e & 1) >= T) s[nb][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < S::NB; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(MNT_FULL_MASK, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(MNT_FULL_MASK, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h] * TC_LOG2E);
      corr[h] = tc_ex2(m[h] - mn);   // 0 on the first tile (m = -inf)
      m[h] = mn;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int db = 0; db < S::KS; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[db][e] *= corr[e >> 1];
        os[db][e] *= corr[e >> 1];
      }
#pragma unroll
    for (int p = 0; p < S::NB; ++p) {   // k8 step p of p v: keys j0 + 8p ..
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = tc_ex2(fmaf(s[p][e], TC_LOG2E, -m[e >> 1]));
      l[0] += x[0] + x[1];
      l[1] += x[2] + x[3];
      if (DROP) {
        const uint32_t col = (uint32_t)(j0 + 8 * p + 2 * t);
        const uint32_t hc[2] = {t3_col(col), t3_col(col + 1)};
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] *= t3_keep(drop, hr[e >> 1], hc[e & 1]);
      }
      uint32_t ab[4], as[4];
      t3_c2a(x, ab, as);
      t3_cols<DP>(c, os, ab, as, vs, p, g, t);
    }
    t3_flush<S::KS>(o, c);
    if (n + 1 < tiles) {
      if (F::STAGES == 1) __syncthreads();
      float* nx = t3s + ((n + 1) % F::STAGES) * STAGE;
      t3_store_rows<DP>(kr, gr, nx);
      t3_store_cols<DP>(vr, nx + S::ROWS, D);
    }
    __syncthreads();
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(MNT_FULL_MASK, l[h], 1);
    l[h] += __shfl_xor_sync(MNT_FULL_MASK, l[h], 2);
    inv[h] = 1.f / l[h];
  }
  t3_store<DP>(o, os, inv, out + base, i0, T, D, g, t);
  if (lse && t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i0 + g + 8 * h;
      if (r < T) lse[(size_t)bh * T + r] = m[h] * TC_LN2 + logf(l[h]);
    }
}

// shared floats of the key-tile kernel: a stage is q and dout as rows and as
// columns, lse * log2(e) and delta of the tile's rows
template <int DP>
using T3Dkdv = T3Smem<DP, 2 * T3Shape<DP>::ROWS + 2 * T3Shape<DP>::COLS + 2 * T3Shape<DP>::KT>;

// dk, dv of TC_ROWS keys of one (b, h), a warp's 16 keys (k and v as split A
// fragments), streaming every query tile (q, dout, lse, delta). The rows of
// s^T = k q^T are keys: its scores are the forward's through t3_scores
// with SWAP (see there). grid (ceil(T / TC_ROWS), B * H), TC_THREADS threads.
template <int DP, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, T3_MIN_BLOCKS(DP))
    mha_backward_dkdv_t32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 float* __restrict__ dk, float* __restrict__ dv, int T, int D,
                                 Dropout drop) {
  using S = T3Shape<DP>;
  using F = T3Dkdv<DP>;
  constexpr int STAGE = 2 * S::ROWS + 2 * S::COLS + 2 * S::KT;
  extern __shared__ __align__(16) float t3s[];
  // the query-tile kernel needs nothing of this one: let it launch now
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, tid = threadIdx.x;
  const int bh = blockIdx.y, j0 = blockIdx.x * TC_ROWS + (threadIdx.x >> 5) * 16;
  const size_t base = (size_t)bh * T * D, rbase = (size_t)bh * T;
  const float* qb0 = q + base;
  const float* gb0 = dout + base;
  const T3RowGroups<DP> gr(D);
  const uint32_t hk[2] = {t3_col((uint32_t)(j0 + g)), t3_col((uint32_t)(j0 + g + 8))};   // keys

  // rows past T stage zero q and dout and lse = delta = 0: p = 1, ds = 0,
  // and their zero rows add nothing to dk or dv
  float qr[S::NG][2], gq[S::NG][2], qc[S::NG][2], gc[S::NG][2];
  float lr = 0.f, dr = 0.f;
  auto load = [&](int i0) {
    const size_t o = (size_t)i0 * D;
    t3_load_rows<DP>(qr, gr, qb0 + o, (T - i0) * D);
    t3_load_rows<DP>(gq, gr, gb0 + o, (T - i0) * D);
    t3_load_cols<DP>(qc, qb0 + o, T - i0, D);
    t3_load_cols<DP>(gc, gb0 + o, T - i0, D);
    lr = dr = 0.f;
    if (tid < S::KT && i0 + tid < T) {
      lr = lse[rbase + i0 + tid] * TC_LOG2E;
      dr = delta[rbase + i0 + tid];
    }
  };
  auto store = [&](float* st) {
    t3_store_rows<DP>(qr, gr, st);
    t3_store_rows<DP>(gq, gr, st + S::ROWS);
    t3_store_cols<DP>(qc, st + 2 * S::ROWS, D);
    t3_store_cols<DP>(gc, st + 2 * S::ROWS + S::COLS, D);
    if (tid < S::KT) {
      st[2 * S::ROWS + 2 * S::COLS + tid] = lr;
      st[2 * S::ROWS + 2 * S::COLS + S::KT + tid] = dr;
    }
  };
  load(0);
  uint32_t kb[S::KS][4], ks[S::KS][4], vb[S::KS][4], vs[S::KS][4];
  t3_load_a<S::KS>(kb, ks, k + base, j0, T, D, g, t);
  t3_load_a<S::KS>(vb, vs, v + base, j0, T, D, g, t);
  // dka, dva: the totals of the tiles' big terms; ck, cv: this tile's;
  // dks, dvs: the small terms of all tiles
  float dka[S::KS][4], dks[S::KS][4], ck[S::KS][4], dva[S::KS][4], dvs[S::KS][4], cv[S::KS][4];
#pragma unroll
  for (int db = 0; db < S::KS; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dka[db][e] = dks[db][e] = ck[db][e] = dva[db][e] = dvs[db][e] = cv[db][e] = 0.f;
  t3_zero(t3s, F::STAGES * STAGE);
  __syncthreads();
  store(t3s);
  __syncthreads();
  const int tiles = (T + S::KT - 1) / S::KT;
  for (int n = 0; n < tiles; ++n) {
    const int i0 = n * S::KT;
    const float* st = t3s + (n % F::STAGES) * STAGE;
    const float* qrow = st;
    const float* grow = st + S::ROWS;
    const float* qcol = st + 2 * S::ROWS;
    const float* gcol = qcol + S::COLS;
    const float* ls = gcol + S::COLS;   // lse * log2(e) of the tile's rows
    const float* dls = ls + S::KT;      // delta of the tile's rows
    if (n + 1 < tiles) load(i0 + S::KT);
#pragma unroll
    for (int nb = 0; nb < S::NB; ++nb) {   // the tile's queries 8 nb ..
      float sv[4], dpt[4];                 // s^T = k q^T, dP^T = v dout^T: rows keys
      t3_scores<DP, true>(sv, kb, ks, qrow, nb, g, t);
      t3_scores<DP, false>(dpt, vb, vs, grow, nb, g, t);
      const int c = 8 * nb + 2 * t;   // the tile's query c, c + 1
      const float2 lc = *reinterpret_cast<const float2*>(ls + c);
      const float2 dc = *reinterpret_cast<const float2*>(dls + c);
      uint32_t hq[2] = {0u, 0u};   // the hash's row parts of queries c, c + 1
      if (DROP) {
        hq[0] = t3_row(drop, (uint32_t)(rbase + i0 + c));
        hq[1] = t3_row(drop, (uint32_t)(rbase + i0 + c + 1));
      }
      float pk[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = tc_ex2(fmaf(sv[e], TC_LOG2E, -(e & 1 ? lc.y : lc.x)));
        float kp = 1.f;
        if (DROP) kp = t3_keep(drop, hq[e & 1], hk[e >> 1]);
        pk[e] = pe * kp;
        ds[e] = pe * (kp * dpt[e] - (e & 1 ? dc.y : dc.x));
      }
      uint32_t pb[4], ps[4], sb[4], ss[4];
      t3_c2a(pk, pb, ps);
      t3_c2a(ds, sb, ss);
      t3_cols<DP>(cv, dvs, pb, ps, gcol, nb, g, t);
      t3_cols<DP>(ck, dks, sb, ss, qcol, nb, g, t);
    }
    t3_flush<S::KS>(dka, ck);
    t3_flush<S::KS>(dva, cv);
    if (n + 1 < tiles) {
      if (F::STAGES == 1) __syncthreads();
      store(t3s + ((n + 1) % F::STAGES) * STAGE);
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  t3_store<DP>(dka, dks, one, dk + base, j0, T, D, g, t);
  t3_store<DP>(dva, dvs, one, dv + base, j0, T, D, g, t);
}

// shared floats of the query-tile kernel: a stage is k and v as rows and k
// as columns
template <int DP>
using T3Dq = T3Smem<DP, 2 * T3Shape<DP>::ROWS + T3Shape<DP>::COLS>;

// dq of TC_ROWS queries of one (b, h), a warp's 16 queries (q and dout as
// split A fragments), streaming every key tile (k, v). Launched to overlap
// the key-tile kernel (programmatic dependent launch), it completes after
// it. grid (ceil(T / TC_ROWS), B * H), TC_THREADS threads.
template <int DP, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, T3_MIN_BLOCKS(DP))
    mha_backward_dq_t32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dq, int T, int D, Dropout drop) {
  using S = T3Shape<DP>;
  using F = T3Dq<DP>;
  constexpr int STAGE = 2 * S::ROWS + S::COLS;
  extern __shared__ __align__(16) float t3s[];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, i0 = blockIdx.x * TC_ROWS + (threadIdx.x >> 5) * 16;
  const size_t base = (size_t)bh * T * D, rbase = (size_t)bh * T;
  const float* kb0 = k + base;
  const float* vb0 = v + base;
  const uint32_t hr[2] = {t3_row(drop, (uint32_t)(rbase + i0 + g)),
                          t3_row(drop, (uint32_t)(rbase + i0 + g + 8))};   // rows g, g + 8
  const T3RowGroups<DP> gr(D);

  float kr[S::NG][2], vr[S::NG][2], kc[S::NG][2];
  auto load = [&](int j0) {
    const size_t o = (size_t)j0 * D;
    t3_load_rows<DP>(kr, gr, kb0 + o, (T - j0) * D);
    t3_load_rows<DP>(vr, gr, vb0 + o, (T - j0) * D);
    t3_load_cols<DP>(kc, kb0 + o, T - j0, D);
  };
  auto store = [&](float* st) {
    t3_store_rows<DP>(kr, gr, st);
    t3_store_rows<DP>(vr, gr, st + S::ROWS);
    t3_store_cols<DP>(kc, st + 2 * S::ROWS, D);
  };
  load(0);
  uint32_t qb[S::KS][4], qs[S::KS][4], gb[S::KS][4], gs[S::KS][4];
  t3_load_a<S::KS>(qb, qs, q + base, i0, T, D, g, t);
  t3_load_a<S::KS>(gb, gs, dout + base, i0, T, D, g, t);
  float lr[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = i0 + g + 8 * h;
    lr[h] = r < T ? lse[rbase + r] * TC_LOG2E : 0.f;
    dl[h] = r < T ? delta[rbase + r] : 0.f;
  }
  // dqa: the total of the tiles' big terms; cq: this tile's; dqs: the small
  // terms of all tiles
  float dqa[S::KS][4], cq[S::KS][4], dqs[S::KS][4];
#pragma unroll
  for (int db = 0; db < S::KS; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[db][e] = cq[db][e] = dqs[db][e] = 0.f;
  t3_zero(t3s, F::STAGES * STAGE);
  __syncthreads();
  store(t3s);
  __syncthreads();
  const int tiles = (T + S::KT - 1) / S::KT;
  for (int n = 0; n < tiles; ++n) {
    const int j0 = n * S::KT;
    const float* st = t3s + (n % F::STAGES) * STAGE;
    const float* krow = st;
    const float* vrow = st + S::ROWS;
    const float* kcol = st + 2 * S::ROWS;
    if (n + 1 < tiles) load(j0 + S::KT);
    const bool tail = j0 + S::KT > T;
#pragma unroll
    for (int nb = 0; nb < S::NB; ++nb) {   // the tile's keys 8 nb ..
      float sv[4], dp[4];                  // s = q k^T, dP = dout v^T
      t3_scores<DP, false>(sv, qb, qs, krow, nb, g, t);
      t3_scores<DP, false>(dp, gb, gs, vrow, nb, g, t);
      const int col = j0 + 8 * nb + 2 * t;
      uint32_t hc[2] = {0u, 0u};
      if (DROP) {
        hc[0] = t3_col((uint32_t)col);
        hc[1] = t3_col((uint32_t)col + 1);
      }
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = tc_ex2(fmaf(sv[e], TC_LOG2E, -lr[e >> 1]));
        float kp = 1.f;
        if (DROP) kp = t3_keep(drop, hr[e >> 1], hc[e & 1]);
        ds[e] = pe * (kp * dp[e] - dl[e >> 1]);
        if (tail && col + (e & 1) >= T) ds[e] = 0.f;   // keys past T
      }
      uint32_t sb[4], ss[4];
      t3_c2a(ds, sb, ss);
      t3_cols<DP>(cq, dqs, sb, ss, kcol, nb, g, t);
    }
    t3_flush<S::KS>(dqa, cq);
    if (n + 1 < tiles) {
      if (F::STAGES == 1) __syncthreads();
      store(t3s + ((n + 1) % F::STAGES) * STAGE);
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  t3_store<DP>(dqa, dqs, one, dq + base, i0, T, D, g, t);
  // complete only after the key-tile kernel: what follows in the stream may
  // read dk and dv
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <int DP, bool DROP>
static cudaError_t t3_forward(const float* q, const float* k, const float* v, float* out,
                              float* lse, int BH, int T, int D, Dropout drop,
                              cudaStream_t stream) {
  const cudaError_t err = allow_smem(mha_forward_t32_kernel<DP, DROP>, T3Fwd<DP>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((T + TC_ROWS - 1) / TC_ROWS), (unsigned)BH);
  mha_forward_t32_kernel<DP, DROP><<<grid, TC_THREADS, T3Fwd<DP>::BYTES, stream>>>(
      q, k, v, out, lse, T, D, drop);
  return cudaGetLastError();
}

// The key-tile kernel, then the query-tile kernel, which needs none of its
// results, by programmatic dependent launch: its blocks take the SMs the
// key-tile kernel leaves idle.
template <int DP, bool DROP>
static cudaError_t t3_backward(const float* q, const float* k, const float* v, const float* dout,
                               const float* lse, const float* delta, float* dq, float* dk,
                               float* dv, int BH, int T, int D, Dropout drop,
                               cudaStream_t stream) {
  cudaError_t err = allow_smem(mha_backward_dkdv_t32_kernel<DP, DROP>, T3Dkdv<DP>::BYTES);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(mha_backward_dq_t32_kernel<DP, DROP>, T3Dq<DP>::BYTES)) != cudaSuccess)
    return err;
  const dim3 grid((unsigned)((T + TC_ROWS - 1) / TC_ROWS), (unsigned)BH);
  mha_backward_dkdv_t32_kernel<DP, DROP><<<grid, TC_THREADS, T3Dkdv<DP>::BYTES, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, T, D, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = T3Dq<DP>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, mha_backward_dq_t32_kernel<DP, DROP>, q, k, v, dout, lse,
                                delta, dq, T, D, drop)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// FN<DP, DROP>(...) at the padded head dim of D and dropout on or off.
#define TC_DISPATCH(FN, D, on, ...)                                                  \
  ((D) <= 16   ? ((on) ? FN<16, true>(__VA_ARGS__) : FN<16, false>(__VA_ARGS__))     \
   : (D) <= 32 ? ((on) ? FN<32, true>(__VA_ARGS__) : FN<32, false>(__VA_ARGS__))     \
               : ((on) ? FN<64, true>(__VA_ARGS__) : FN<64, false>(__VA_ARGS__)))

// The float32 form on 3xTF32 tensor cores: q, k, v, out (B * H, T, D)
// contiguous f32; lse (B * H, T) or NULL. Dropout at `rate` with `seed` (0 <=
// rate < 1). Returns the cudaError_t.
extern "C" int mha_forward(const float* q, const float* k, const float* v, float* out, float* lse,
                           int BH, int T, int D, int seed, double rate, cudaStream_t stream) {
  if (!mha_shape_ok(BH, T, D)) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, MHA_DRAW, rate);
  return (int)TC_DISPATCH(t3_forward, D, drop.on, q, k, v, out, lse, BH, T, D, drop, stream);
}

// The backward of mha_forward at the same seed and rate: out and lse are the
// forward's, dout the output's gradient; dq, dk, dv (B * H, T, D) are
// written; delta is (B * H, T) scratch. Returns the cudaError_t of the first
// launch that fails, or of the last.
extern "C" int mha_backward(const float* q, const float* k, const float* v, const float* out,
                            const float* dout, const float* lse, float* dq, float* dk, float* dv,
                            float* delta, int BH, int T, int D, int seed, double rate,
                            cudaStream_t stream) {
  if (!mha_shape_ok(BH, T, D)) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, MHA_DRAW, rate);
  const cudaError_t err = launch_delta<float>(out, dout, delta, BH, T, D, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)TC_DISPATCH(t3_backward, D, drop.on, q, k, v, dout, lse, delta, dq, dk, dv, BH, T, D,
                          drop, stream);
}

// The float32 form on the CUDA cores, with mha_forward's and mha_backward's
// arguments: the precision yardstick.
extern "C" int mha_forward_simt(const float* q, const float* k, const float* v, float* out,
                                float* lse, int BH, int T, int D, int seed, double rate,
                                cudaStream_t stream) {
  return launch_forward<float>(q, k, v, out, nullptr, lse, BH, T, D, seed, rate, stream);
}

extern "C" int mha_backward_simt(const float* q, const float* k, const float* v,
                                 const float* out, const float* dout, const float* lse, float* dq,
                                 float* dk, float* dv, float* delta, int BH, int T, int D, int seed,
                                 double rate, cudaStream_t stream) {
  return launch_backward<float>(q, k, v, out, dout, lse, dq, dk, dv, delta, BH, T, D, seed, rate,
                                stream);
}

// The bf16 form on tensor cores: q, k, v, out (B * H, T, D) contiguous bf16;
// out32 (B * H, T, D) f32 (the backward's copy of out) and lse (B * H, T)
// f32, each NULL where no backward follows.
extern "C" int mha_forward16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, __nv_bfloat16* out, float* out32, float* lse,
                             int BH, int T, int D, int seed, double rate, cudaStream_t stream) {
  if (!mha_shape_ok(BH, T, D)) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, MHA_DRAW, rate);
  return (int)TC_DISPATCH(tc_forward, D, drop.on, q, k, v, out, out32, lse, BH, T, D, drop,
                          stream);
}

// The backward of mha_forward16: q, k, v, dout bf16, out32 and lse the
// forward's f32 ones; dq, dk, dv written in bf16; delta (B * H, T) f32
// scratch.
extern "C" int mha_backward16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const float* out32,
                              const __nv_bfloat16* dout, const float* lse, __nv_bfloat16* dq,
                              __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta, int BH, int T,
                              int D, int seed, double rate, cudaStream_t stream) {
  if (!mha_shape_ok(BH, T, D)) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, MHA_DRAW, rate);
  const cudaError_t err = launch_delta<__nv_bfloat16>(out32, dout, delta, BH, T, D, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)TC_DISPATCH(tc_backward, D, drop.on, q, k, v, dout, lse, delta, dq, dk, dv, BH, T,
                          D, drop, stream);
}

// The bf16 form on the CUDA cores (the float32 form's kernels on bf16 storage), with
// mha_forward16's and mha_backward16's arguments: the precision yardstick.
extern "C" int mha_forward16_simt(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, __nv_bfloat16* out, float* out32,
                                  float* lse, int BH, int T, int D, int seed, double rate,
                                  cudaStream_t stream) {
  return launch_forward<__nv_bfloat16>(q, k, v, out, out32, lse, BH, T, D, seed, rate, stream);
}

extern "C" int mha_backward16_simt(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, const float* out32,
                                   const __nv_bfloat16* dout, const float* lse,
                                   __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                                   float* delta, int BH, int T, int D, int seed, double rate,
                                   cudaStream_t stream) {
  return launch_backward<__nv_bfloat16>(q, k, v, out32, dout, lse, dq, dk, dv, delta, BH, T, D,
                                        seed, rate, stream);
}
