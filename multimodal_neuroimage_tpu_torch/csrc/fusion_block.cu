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
// What bounds it on the H100: latency and issue slots, not bytes. A
// flagship step runs 48 self and 12 directed cross calls over 196 windows
// of 36 tokens at C = 12 (6 heads of dim 2): about 0.04 GFLOP and 0.7 MB
// of stream traffic a subject a call. Unfused, each block is ~20 small
// kernels with every intermediate (qkv, the (H, 36, 36) scores, the MLP
// hidden) round-tripping device memory.
//
// Design (fusion_block.cuh fusion_forward_items): a grid that fills the card
// once, each block of FUSION_FWD_THREADS walking work items; an item is up
// to FUSION_FWD_WINDOWS subjects' windows at one window position, so they
// share the shift mask, and every phase's loop spans all of them: one
// barrier serves the item, not one window. Only x (and y) are read and only
// the block output (and x2r) written; everything else lives in shared
// memory, each window's buffers laid out by liveness (FusionFwdLayout: x2
// over x, h2 over q, the GELU hidden over the dead q/k/v and attention
// output; ~11 KB a window). The weights (transposed) and the (H, N, N) bias
// table are staged once a block (the table by cp.async, beside the first
// item's), and the next item's x (and y) windows and mask land by cp.async
// while the current item computes.
//   - LayerNorm: four lanes a row and shuffle sums.
//   - Dense layers: a task is 2 or 4 rows by four outputs, its sums in
//     registers; lanes of a warp take consecutive outputs, so a row's float4
//     is a broadcast and the weights' float4s lie side by side (W^T); each
//     sum is one fmaf chain over c = 0, 1, ..., the plain order.
//   - Attention: a task is one (head, query row) over the item's windows
//     (four at head dim 2), so the bias and mask terms of a key are read
//     once for all of them and four independent chains interleave. The
//     softmax is online and in base 2 (q and a key's bias + mask scaled by
//     log2 e): one exponential a score, the running max rescaled once every
//     FUSION_FWD_KEYS keys; the dropout hash runs once a score, its column
//     product stepped key by key, and the dropout scale joins 1 / l at the
//     end.
//   - A training template: the inference body computes no hash and applies
//     no DropPath.
// Windows are unpadded (N = 36) and the bias is a plain (H, N, N) tensor:
// the NP = 40 pad and the head-packed bias layout were TPU tiling choices.
// The softmax subtracts the row max where the TPU kernel clamped logits at
// 80; the two agree for all scores below 80 (ops/fusion_block.py
// _LOGIT_CAP).
#include "fusion_block.cuh"

// K2/K3's work items: item (chunk, w) holds window w of subjects
// chunk * per .. chunk * per + per - 1 (fewer in the last chunk).
struct FusionStdItems {
  const float *x, *y;
  float *out, *x2r;
  const float* dp;
  int B, nW, N, C, NP, per;

  __device__ int count() const { return (B + per - 1) / per * nW; }
  __device__ int windows(int item) const { return min(per, B - item / nW * per); }
  __device__ int position(int item) const { return item % nW; }
  __device__ FusionWindow window(int item, int k) const {
    const int b = item / nW * per + k, bw = b * nW + item % nW;
    const size_t base = (size_t)bw * N * C;
    FusionWindow W = {};
    W.x = x + base;
    W.y = y ? y + base : nullptr;
    W.out = out + base;
    W.x2r = x2r ? x2r + base : nullptr;
    W.stride = C;
    W.row0 = (uint32_t)bw * NP;   // padded dropout row of token 0
    W.dp1 = dp ? dp[b * 2] : 1.f;
    W.dp2 = dp ? dp[b * 2 + 1] : 1.f;
    return W;
  }
};

// ---------------------------------------------------------------------------
// Backward. Replaces fusion_block.py _bwd_impl (_make_bwd_kernel, :547-713):
// per window, the MLP/LN2 backward over the saved x2r, then LN1 and q/k/v
// recomputed and the attention backward, giving dx (and dy for cross) and
// the window's share of dbias and of the 12 (self) or 16 (cross) parameter
// gradients.
//
// The TPU kernel summed the parameter gradients over its sequential grid in
// resident output blocks. Blocks of the H100 run in parallel, so each block
// accumulates its share in shared memory (every accumulator element is owned
// by one thread, which adds the windows in a fixed order), writes it to a
// per-block partial, and a second kernel adds the partials in block order:
// two runs give bitwise the same gradients, with no float atomics. The
// attention recompute never stores the (H, N, N) probabilities: a row pass
// (one thread per (window, head, query)) rebuilds the softmax, the
// attention output, its log-sum-exp and D = dO . O, and dq; a column pass
// (one thread per (head, key), over the windows in order) rebuilds p from
// the log-sum-exp and gives dk, dv and dbias.
//
// What bounds it on the H100: latency, not FLOPs or bytes (about 0.3 GFLOP
// a flagship call at B = 4). One window at a time, with a buffer for every
// intermediate (~140 KB with the accumulators and staged weights), a block
// of 256 threads fills an SM, passes ~14 barriers a window, and its row
// phases keep 36 of its threads busy. So each window's buffers are laid
// out by liveness (FusionBwdLayout: ~24 KB a self window, ~28 KB cross) and
// a block of 512 threads runs FUSION_BWD_WINDOWS windows at once, every
// phase's loop spanning them all: the weights, bias, accumulators and the
// shift mask are shared by the windows in flight (a work item is one
// window position for up to four subjects, so they share the mask), row
// phases have 4 x 36 rows, the row pass 4 x 216 items, a barrier serves
// four windows, and threads the column pass leaves free add the gradients
// that need no dk/dv beside it.
// ---------------------------------------------------------------------------

template <bool CROSS, int MAXHD>
__global__ void __launch_bounds__(FUSION_BWD_THREADS, 1)
fusion_block_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                             const float* __restrict__ x2r, const float* __restrict__ g,
                             FusionParams P, const float* __restrict__ bias,
                             const float* __restrict__ mask, FusionTrain T,
                             float* __restrict__ dx, float* __restrict__ dy,
                             float* __restrict__ part, int B, int nW, int N, int C, int H,
                             int Ch, int windows) {
  extern __shared__ float smem[];
  __shared__ FusionWindow wins[FUSION_BWD_WINDOWS];
  const FusionBwdLayout L(CROSS, N, C, H, Ch, windows);
  const FusionLayout F(CROSS, N, C, H, Ch);
  const FusionGrads G(CROSS, N, C, H, Ch);
  float* acc = smem + L.acc;

  for (int e = threadIdx.x; e < G.total; e += FUSION_BWD_THREADS) acc[e] = 0.f;
  stage_weights<FUSION_BWD_THREADS>(smem + L.fwd, F, CROSS, P, bias, N, C, H, Ch);

  // work item (chunk, w): window w of subjects chunk * windows + k
  const int chunks = (B + windows - 1) / windows;
  for (int item = blockIdx.x; item < chunks * nW; item += gridDim.x) {
    const int w = item % nW, b0 = (item / nW) * windows;
    const int kw = min(windows, B - b0);
    if (threadIdx.x < kw) {
      const int bw = (b0 + threadIdx.x) * nW + w;
      const size_t base = (size_t)bw * N * C;
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
      wins[threadIdx.x] = W;
    }
    if (mask)
      stage<FUSION_BWD_THREADS>(smem + L.fwd + F.mask, F.BS, mask + (size_t)w * N * N, N, N);
    __syncthreads();
    fusion_backward_windows<CROSS, MAXHD>(smem, L, F, G, mask != nullptr, N, C, H, Ch, T, wins,
                                          kw);
  }
  float* mine = part + (size_t)blockIdx.x * G.total;
  for (int e = threadIdx.x; e < G.total; e += FUSION_BWD_THREADS) mine[e] = acc[e];
}

// ---------------------------------------------------------------------------
// Entry points.
// ---------------------------------------------------------------------------

template <bool CROSS, bool FLAG>
static cudaError_t launch_forward(const float* x, const float* y, const FusionParams& P,
                                  const float* bias, const float* mask, float* out, int B,
                                  int nW, int N, int C, int H, int Ch, const FusionTrain& T,
                                  cudaStream_t stream, FusionFwdPlan* plan = nullptr) {
  auto items = [&](int per) {
    return FusionStdItems{x, CROSS ? y : nullptr, out, static_cast<float*>(T.x2r), T.dp, B, nW,
                          N, C, T.NP, per};
  };
  return launch_fusion_forward<CROSS, FLAG, false, float>(items, B, nW, P, bias, mask, N, C, H,
                                                            Ch, T, stream, plan);
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
#define FWD(c, h) launch_forward<c, h>(x, y, P, bias, mask, out, B, nW, N, C, H, Ch, T, stream)
  return (int)FUSION_FWD_DISPATCH(cross, N, C, H, Ch, FWD);
#undef FWD
}

// How fusion_block_forward runs at these shapes on the current card (the
// training body): out[0] blocks an SM, out[1] windows in flight a block,
// out[2] subjects a work item, out[3] shared-memory bytes a block, out[4]
// blocks in the grid. Returns the cudaError_t of the query.
extern "C" int fusion_block_forward_occupancy(int cross, int B, int nW, int N, int C, int H,
                                              int Ch, int* out) {
  if (bad_dims(N, C, H)) return (int)cudaErrorInvalidValue;
  FusionTrain T = make_train(nullptr, 0, 0.1, 0.1, N, nullptr);
  FusionFwdPlan plan = {};
#define PLAN(c, h)                                                                          \
  launch_forward<c, h>(nullptr, nullptr, FusionParams{}, nullptr, nullptr, nullptr, B, nW, N, \
                       C, H, Ch, T, nullptr, &plan)
  const cudaError_t err = FUSION_FWD_DISPATCH(cross, N, C, H, Ch, PLAN);
#undef PLAN
  out[0] = plan.per_sm;
  out[1] = plan.windows;
  out[2] = plan.per;
  out[3] = (int)plan.smem;
  out[4] = plan.blocks;
  return (int)err;
}

template <bool CROSS, int MAXHD>
static cudaError_t backward_grid(int B, int nW, int N, int C, int H, int Ch, int* blocks,
                                 size_t* smem, int* windows, int* per_sm = nullptr) {
  cudaError_t err = backward_windows(CROSS, N, C, H, Ch, B, windows, smem);
  if (err != cudaSuccess) return err;
  const int items = (B + *windows - 1) / *windows * nW;
  return persistent_grid(fusion_block_backward_kernel<CROSS, MAXHD>, *smem, items, blocks,
                         FUSION_BWD_THREADS, per_sm);
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
  int blocks = 0, windows = 0;
  size_t smem = 0;
#define GRID(c, h) backward_grid<c, h>(B, nW, N, C, H, Ch, &blocks, &smem, &windows)
  if (FUSION_DISPATCH(cross, C / H, GRID) != cudaSuccess) return -1;
#undef GRID
  return (long long)blocks * FusionGrads(cross != 0, N, C, H, Ch).total;
}

// What the backward kernel of this layout runs with: out[0] blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] windows in
// flight a block, out[2] shared-memory bytes a block, out[3] blocks in the
// grid. Returns the cudaError_t of the query.
extern "C" int fusion_block_backward_occupancy(int cross, int B, int nW, int N, int C, int H,
                                               int Ch, int* out) {
  if (bad_dims(N, C, H)) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
#define GRID(c, h) backward_grid<c, h>(B, nW, N, C, H, Ch, &out[3], &smem, &out[1], &out[0])
  const cudaError_t err = FUSION_DISPATCH(cross, C / H, GRID);
#undef GRID
  out[2] = (int)smem;
  return (int)err;
}

template <bool CROSS, int MAXHD>
static cudaError_t launch_backward(const float* x, const float* y, const float* x2r,
                                   const float* g, const FusionParams& P, const float* bias,
                                   const float* mask, const FusionTrain& T, float* dx,
                                   float* dy, float* grads, float* scratch, int B, int nW, int N,
                                   int C, int H, int Ch, cudaStream_t stream) {
  int blocks = 0, windows = 0;
  size_t smem = 0;
  cudaError_t err = backward_grid<CROSS, MAXHD>(B, nW, N, C, H, Ch, &blocks, &smem, &windows);
  if (err != cudaSuccess) return err;
  fusion_block_backward_kernel<CROSS, MAXHD><<<blocks, FUSION_BWD_THREADS, smem, stream>>>(
      x, y, x2r, g, P, bias, mask, T, dx, dy, scratch, B, nW, N, C, H, Ch, windows);
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
  launch_backward<c, h>(x, y, x2r, g, P, bias, mask, T, dx, dy, grads, scratch, B, nW, N, C, \
                        H, Ch, stream)
  return (int)FUSION_DISPATCH(cross, C / H, BWD);
#undef BWD
}
