// K2/K3: the SwinFusion self and cross blocks, forward and backward, one
// kernel each way templated on CROSS (the window bodies live in
// fusion_block.cuh, shared with K7).
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
#include "fusion_block.cuh"

template <bool CROSS, int MAXHD>
__global__ void __launch_bounds__(FUSION_THREADS)
fusion_block_kernel(const float* __restrict__ x, const float* __restrict__ y, FusionParams P,
                    const float* __restrict__ bias, const float* __restrict__ mask,
                    float* __restrict__ out, int windows, int nW, int N, int C, int H, int Ch,
                    FusionTrain T) {
  extern __shared__ float smem[];
  const FusionLayout L(CROSS, N, C, H, Ch);

  // weights and the bias are the same for every window: stage them once
  stage_weights(smem, L, CROSS, P, bias, N, C, H, Ch);

  // each block walks windows b * nW + w with a grid stride
  for (int bw = blockIdx.x; bw < windows; bw += gridDim.x) {
    const size_t base = (size_t)bw * N * C;
    if (mask) stage(smem + L.mask, L.BS, mask + (size_t)(bw % nW) * N * N, N, N);
    FusionWindow W = {};
    W.x = x + base;
    W.y = CROSS ? y + base : nullptr;
    W.out = out + base;
    W.x2r = T.x2r ? T.x2r + base : nullptr;
    W.stride = C;
    W.row0 = (uint32_t)bw * T.NP;   // padded dropout row of token 0
    W.dp1 = T.dp ? T.dp[(bw / nW) * 2] : 1.f;
    W.dp2 = T.dp ? T.dp[(bw / nW) * 2 + 1] : 1.f;
    fusion_forward_window<CROSS, MAXHD>(smem, L, mask != nullptr, N, C, H, Ch, T, W);
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
  float* acc = smem + L.acc;

  for (int e = threadIdx.x; e < G.total; e += FUSION_THREADS) acc[e] = 0.f;
  stage_weights(smem + L.fwd, F, CROSS, P, bias, N, C, H, Ch);

  for (int bw = blockIdx.x; bw < windows; bw += gridDim.x) {
    const size_t base = (size_t)bw * N * C;
    if (mask) stage(smem + L.fwd + F.mask, F.BS, mask + (size_t)(bw % nW) * N * N, N, N);
    FusionWindow W = {};
    W.x = x + base;
    W.y = CROSS ? y + base : nullptr;
    W.x2r = const_cast<float*>(x2r) + base;
    W.g = g + base;
    W.dx = dx + base;
    W.dy = CROSS ? dy + base : nullptr;
    W.stride = C;
    W.row0 = (uint32_t)bw * T.NP;
    W.dp1 = T.dp ? T.dp[(bw / nW) * 2] : 1.f;
    W.dp2 = T.dp ? T.dp[(bw / nW) * 2 + 1] : 1.f;
    fusion_backward_window<CROSS, MAXHD>(smem, L, F, G, mask != nullptr, N, C, H, Ch, T, W);
  }
  float* mine = part + (size_t)blockIdx.x * G.total;
  for (int e = threadIdx.x; e < G.total; e += FUSION_THREADS) mine[e] = acc[e];
}

// ---------------------------------------------------------------------------
// Entry points.
// ---------------------------------------------------------------------------

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
