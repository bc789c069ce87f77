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
// of score and context products (4 T^2 D per (b, h)) and 23 M exponentials;
// D = 11 is far too thin for tensor cores (an mma tile is 16 deep), so this
// runs on the f32 CUDA cores.
//
// Design. The TPU kernel kept one whole (T, T) score matrix in VMEM; at
// T = 1201 that is 5.8 MB, beyond a block's 227 KB of shared memory. So the
// scores never exist as a matrix here: flash-style, each block owns 64 query
// rows of one (b, h) and streams the keys through shared memory in tiles of
// 64, with an online softmax (running max m, running sum l, the output
// accumulator in registers). Four threads share a query row, each taking
// every fourth key of a tile; their (m, l, acc) states are merged with warp
// shuffles at the end. The forward also writes the row's log-sum-exp, from
// which the backward rebuilds p = exp(s - lse) without a second max pass.
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
// sum_j ds_ij k_j, with ds_ij = p_ij (keep_ij do_i . v_j - delta_i). Each
// thread's partial sums over its share of rows are added across the four
// threads of a row in a fixed butterfly order.
//
// The bf16 form (JAX's fused_attention on bf16 q/k/v, the HCP layers under
// the bf16 policy) is the same kernels instantiated on bf16 storage: q, k,
// v and dout are read as bf16 and widened to f32 on load, every sum,
// exponential and accumulator is f32 (as _make_fwd_kernel /
// _make_bwd_kernel upcast their blocks), and out, dq, dk, dv are rounded to
// bf16 once, on store. The forward also writes an f32 copy of out for the
// backward's delta: from the bf16 out, delta would carry its 2^-9 relative
// rounding into ds = p (g - delta), whose cancellation amplifies it (JAX
// sums g_p . p from the f32 p). q k^T and dout v^T have bf16-valued
// operands on both sides, but p v, p^T dout, ds k and ds^T q each have an
// f32 operand that a bf16 tensor-core product would round, so the bf16
// form runs on the CUDA cores too.
//
// T need be a multiple of nothing: tail keys of the last tile never enter m
// or l, tail rows are never written. The head dim is a template bound (16
// or 64); shared-memory rows are padded to bound + 1 floats, so the four
// threads of a row read four different banks.
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
static int launch_backward(const S* q, const S* k, const S* v, const float* out, const S* dout,
                           const float* lse, S* dq, S* dk, S* dv, float* delta, int BH, int T,
                           int D, int seed, double rate, cudaStream_t stream) {
  if (!mha_shape_ok(BH, T, D)) return (int)cudaErrorInvalidValue;
  const Dropout drop = make_dropout(seed, MHA_DRAW, rate);
  const long long rows = (long long)BH * T;
  long long blocks = (rows + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  mha_delta_kernel<S><<<(int)blocks, 256, 0, stream>>>(out, dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
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

// q, k, v, out: (B * H, T, D) contiguous f32; lse (B * H, T) or NULL.
// Dropout at `rate` with `seed` (0 <= rate < 1). Returns the cudaError_t.
extern "C" int mha_forward(const float* q, const float* k, const float* v, float* out, float* lse,
                           int BH, int T, int D, int seed, double rate, cudaStream_t stream) {
  return launch_forward<float>(q, k, v, out, nullptr, lse, BH, T, D, seed, rate, stream);
}

// The backward of mha_forward at the same seed and rate: out and lse are the
// forward's, dout the output's gradient; dq, dk, dv (B * H, T, D) are
// written; delta is (B * H, T) scratch. Returns the cudaError_t of the first
// launch that fails, or of the last.
extern "C" int mha_backward(const float* q, const float* k, const float* v, const float* out,
                            const float* dout, const float* lse, float* dq, float* dk, float* dv,
                            float* delta, int BH, int T, int D, int seed, double rate,
                            cudaStream_t stream) {
  return launch_backward<float>(q, k, v, out, dout, lse, dq, dk, dv, delta, BH, T, D, seed, rate,
                                stream);
}

// The bf16 form: q, k, v, out (B * H, T, D) contiguous bf16; out32 (B * H,
// T, D) f32 (the backward's copy of out) and lse (B * H, T) f32, each NULL
// where no backward follows.
extern "C" int mha_forward16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, __nv_bfloat16* out, float* out32, float* lse,
                             int BH, int T, int D, int seed, double rate, cudaStream_t stream) {
  return launch_forward<__nv_bfloat16>(q, k, v, out, out32, lse, BH, T, D, seed, rate, stream);
}

// The backward of mha_forward16: q, k, v, dout bf16, out32 and lse the
// forward's f32 ones; dq, dk, dv written in bf16; delta (B * H, T) f32
// scratch.
extern "C" int mha_backward16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const float* out32,
                              const __nv_bfloat16* dout, const float* lse, __nv_bfloat16* dq,
                              __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta, int BH, int T,
                              int D, int seed, double rate, cudaStream_t stream) {
  return launch_backward<__nv_bfloat16>(q, k, v, out32, dout, lse, dq, dk, dv, delta, BH, T, D,
                                        seed, rate, stream);
}
