// K7: the SwinFusion self and cross blocks on group-major streams, forward
// and backward, one kernel each way templated on CROSS and the head-dim
// bound (as K2/K3).
//
// Replaces multimodal_neuroimage_tpu/ops/fusion_block_bp.py _fwd_impl_bp
// and _bwd_impl_bp (behind fused_fusion_block_bp and
// fused_cross_fusion_block_bp): the block of K2/K3 on windows laid out
// (ngroups, nW, N, G*C), subject b = g * G + j in lanes [j * C, (j+1) * C)
// of group g, with the bp kernels' dropout coordinates: row w * NP + n (no
// batch term), column g*G*C + j*C + c for proj and fc2, g*G*C + j*Ch + f for
// fc1 (the JAX kernel offsets the hidden lanes by the group's C-lane width,
// not its Ch-lane width: reproduced as it is) and g*L + (j*H + h)*NP + key
// for the attention, L = G*H*NP.
//
// The TPU had reasons for the layout that the card does not: 12 of 128 VPU
// lanes were live at C = 12, LayerNorm statistics ran as an MXU dot against
// kron(I_G, 1/C), and block-diagonal kron(I_G, W) weights let the MXU
// multiply the zeros for free. None of that is copied. What the card can use
// is the grouping itself: one thread block owns one (group, window) at a
// time (grid-striding over them, as K2 over windows), stages the window's
// shift mask once for its G subjects (the weights and the bias once per
// block), and walks the G subjects, running each through K2/K3's window body
// (fusion_block.cuh) at row stride G*C. The backward runs K2/K3's
// multi-window body: one work item is a (group, window) and up to
// FUSION_BWD_WINDOWS of its subjects at once, which share the shift mask;
// it recomputes the forward from x and the saved x2r, accumulates every
// parameter and bias-table gradient over all its work in shared memory,
// writes one partial per block, and the ordered reduce_partials adds them:
// no float atomics, bitwise-repeatable gradients.
//
// What bounds it on the H100: latency per window, as K2/K3 (the same work:
// about 0.8 GFLOP a forward call at B = 16).
#include "fusion_block.cuh"

// Row stride, dropout coordinates and DropPath factors of subject j's
// window in item (g, w); the caller sets the stream pointers.
__device__ __forceinline__ FusionWindow bp_window(int g, int w, int j, int G, int C, int H,
                                                  int Ch, const FusionTrain& T) {
  FusionWindow W = {};
  const uint32_t GC = (uint32_t)G * C, L = (uint32_t)G * H * T.NP;
  W.stride = G * C;
  W.row0 = (uint32_t)w * T.NP;
  W.colC = (uint32_t)g * GC + (uint32_t)j * C;
  W.colH = (uint32_t)g * GC + (uint32_t)j * Ch;
  W.colA = (uint32_t)g * L + (uint32_t)j * H * T.NP;
  const int b = g * G + j;
  W.dp1 = T.dp ? T.dp[b * 2] : 1.f;
  W.dp2 = T.dp ? T.dp[b * 2 + 1] : 1.f;
  return W;
}

template <bool CROSS, int MAXHD>
__global__ void __launch_bounds__(FUSION_THREADS)
fusion_block_bp_kernel(const float* __restrict__ x, const float* __restrict__ y, FusionParams P,
                       const float* __restrict__ bias, const float* __restrict__ mask,
                       float* __restrict__ out, int items, int G, int nW, int N, int C, int H,
                       int Ch, FusionTrain T) {
  extern __shared__ float smem[];
  const FusionLayout L(CROSS, N, C, H, Ch);
  stage_weights(smem, L, CROSS, P, bias, N, C, H, Ch);

  // each block walks (group, window) items g * nW + w with a grid stride
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item / nW, w = item % nW;
    const size_t base = (size_t)item * N * G * C;
    if (mask) stage(smem + L.mask, L.BS, mask + (size_t)w * N * N, N, N);
    for (int j = 0; j < G; ++j) {
      FusionWindow W = bp_window(g, w, j, G, C, H, Ch, T);
      const size_t off = base + (size_t)j * C;
      W.x = x + off;
      W.y = CROSS ? y + off : nullptr;
      W.out = out + off;
      W.x2r = T.x2r ? T.x2r + off : nullptr;
      fusion_forward_window<CROSS, MAXHD>(smem, L, mask != nullptr, N, C, H, Ch, T, W);
    }
  }
}

template <bool CROSS, int MAXHD>
__global__ void __launch_bounds__(FUSION_BWD_THREADS, 1)
fusion_block_bp_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                const float* __restrict__ x2r, const float* __restrict__ g,
                                FusionParams P, const float* __restrict__ bias,
                                const float* __restrict__ mask, FusionTrain T,
                                float* __restrict__ dx, float* __restrict__ dy,
                                float* __restrict__ part, int ngroups, int G, int nW, int N,
                                int C, int H, int Ch, int windows) {
  extern __shared__ float smem[];
  __shared__ FusionWindow wins[FUSION_BWD_WINDOWS];
  const FusionBwdLayout L(CROSS, N, C, H, Ch, windows);
  const FusionLayout F(CROSS, N, C, H, Ch);
  const FusionGrads Gr(CROSS, N, C, H, Ch);
  float* acc = smem + L.acc;

  for (int e = threadIdx.x; e < Gr.total; e += FUSION_BWD_THREADS) acc[e] = 0.f;
  stage_weights<FUSION_BWD_THREADS>(smem + L.fwd, F, CROSS, P, bias, N, C, H, Ch);

  // work item ((grp, w), chunk): subjects chunk * windows + k of group grp
  const int chunks = (G + windows - 1) / windows;
  for (int item = blockIdx.x; item < ngroups * nW * chunks; item += gridDim.x) {
    const int gw = item / chunks, j0 = (item % chunks) * windows;
    const int grp = gw / nW, w = gw % nW;
    const int kw = min(windows, G - j0);
    if (threadIdx.x < kw) {
      const int j = j0 + threadIdx.x;
      FusionWindow W = bp_window(grp, w, j, G, C, H, Ch, T);
      const size_t off = (size_t)gw * N * G * C + (size_t)j * C;
      W.x = x + off;
      W.y = CROSS ? y + off : nullptr;
      W.x2r = const_cast<float*>(x2r) + off;
      W.g = g + off;
      W.dx = dx + off;
      W.dy = CROSS ? dy + off : nullptr;
      wins[threadIdx.x] = W;
    }
    if (mask)
      stage<FUSION_BWD_THREADS>(smem + L.fwd + F.mask, F.BS, mask + (size_t)w * N * N, N, N);
    __syncthreads();
    fusion_backward_windows<CROSS, MAXHD>(smem, L, F, Gr, mask != nullptr, N, C, H, Ch, T, wins,
                                          kw);
  }
  float* mine = part + (size_t)blockIdx.x * Gr.total;
  for (int e = threadIdx.x; e < Gr.total; e += FUSION_BWD_THREADS) mine[e] = acc[e];
}

// ---------------------------------------------------------------------------
// Entry points.
// ---------------------------------------------------------------------------

template <bool CROSS, int MAXHD>
static cudaError_t launch_bp_forward(const float* x, const float* y, const FusionParams& P,
                                     const float* bias, const float* mask, float* out,
                                     int items, int G, int nW, int N, int C, int H, int Ch,
                                     const FusionTrain& T, cudaStream_t stream) {
  const size_t smem = (size_t)FusionLayout(CROSS, N, C, H, Ch).total * sizeof(float);
  auto kernel = fusion_block_bp_kernel<CROSS, MAXHD>;
  int blocks = 0;
  cudaError_t err = persistent_grid(kernel, smem, items, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, FUSION_THREADS, smem, stream>>>(x, y, P, bias, mask, out, items, G, nW, N,
                                                  C, H, Ch, T);
  return cudaGetLastError();
}

// x, y, out: (ngroups, nW, N, G*C) group-major windows, f32 contiguous (y
// unused unless cross); params, bias, mask, dp (B = ngroups * G, 2), seed,
// rates, NP and x2r (the stream's shape) as fusion_block_forward. Needs
// N <= 256 and C / H <= 16. Returns the cudaError_t of the launch.
extern "C" int fusion_block_bp_forward(int cross, const float* x, const float* y,
                                       const void* const* params, const float* bias,
                                       const float* mask, float* out, int ngroups, int G,
                                       int nW, int N, int C, int H, int Ch, const float* dp,
                                       int seed, double attn_rate, double drop_rate, int NP,
                                       float* x2r, cudaStream_t stream) {
  if (bad_dims(N, C, H) || G < 1) return (int)cudaErrorInvalidValue;
  const FusionParams P = unpack_params(cross, params);
  const FusionTrain T = make_train(dp, seed, attn_rate, drop_rate, NP, x2r);
#define FWD(c, h) \
  launch_bp_forward<c, h>(x, y, P, bias, mask, out, ngroups * nW, G, nW, N, C, H, Ch, T, stream)
  return (int)FUSION_DISPATCH(cross, C / H, FWD);
#undef FWD
}

template <bool CROSS, int MAXHD>
static cudaError_t bp_backward_grid(int ngroups, int G, int nW, int N, int C, int H, int Ch,
                                    int* blocks, size_t* smem, int* windows,
                                    int* per_sm = nullptr) {
  cudaError_t err = backward_windows(CROSS, N, C, H, Ch, G, windows, smem);
  if (err != cudaSuccess) return err;
  const int items = ngroups * nW * ((G + *windows - 1) / *windows);
  return persistent_grid(fusion_block_bp_backward_kernel<CROSS, MAXHD>, *smem, items, blocks,
                         FUSION_BWD_THREADS, per_sm);
}

// Floats of device scratch fusion_block_bp_backward needs (one partial of
// fusion_block_grad_floats() per block), or -1 if the kernel cannot be
// configured.
extern "C" long long fusion_block_bp_backward_scratch_floats(int cross, int ngroups, int G,
                                                             int nW, int N, int C, int H,
                                                             int Ch) {
  if (bad_dims(N, C, H) || G < 1) return -1;
  int blocks = 0, windows = 0;
  size_t smem = 0;
#define GRID(c, h) bp_backward_grid<c, h>(ngroups, G, nW, N, C, H, Ch, &blocks, &smem, &windows)
  if (FUSION_DISPATCH(cross, C / H, GRID) != cudaSuccess) return -1;
#undef GRID
  return (long long)blocks * FusionGrads(cross != 0, N, C, H, Ch).total;
}

// As fusion_block_backward_occupancy, for the group-major backward.
extern "C" int fusion_block_bp_backward_occupancy(int cross, int ngroups, int G, int nW, int N,
                                                  int C, int H, int Ch, int* out) {
  if (bad_dims(N, C, H) || G < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
#define GRID(c, h) \
  bp_backward_grid<c, h>(ngroups, G, nW, N, C, H, Ch, &out[3], &smem, &out[1], &out[0])
  const cudaError_t err = FUSION_DISPATCH(cross, C / H, GRID);
#undef GRID
  out[2] = (int)smem;
  return (int)err;
}

template <bool CROSS, int MAXHD>
static cudaError_t launch_bp_backward(const float* x, const float* y, const float* x2r,
                                      const float* g, const FusionParams& P, const float* bias,
                                      const float* mask, const FusionTrain& T, float* dx,
                                      float* dy, float* grads, float* scratch, int ngroups,
                                      int G, int nW, int N, int C, int H, int Ch,
                                      cudaStream_t stream) {
  int blocks = 0, windows = 0;
  size_t smem = 0;
  cudaError_t err =
      bp_backward_grid<CROSS, MAXHD>(ngroups, G, nW, N, C, H, Ch, &blocks, &smem, &windows);
  if (err != cudaSuccess) return err;
  fusion_block_bp_backward_kernel<CROSS, MAXHD><<<blocks, FUSION_BWD_THREADS, smem, stream>>>(
      x, y, x2r, g, P, bias, mask, T, dx, dy, scratch, ngroups, G, nW, N, C, H, Ch, windows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(scratch, blocks, FusionGrads(CROSS, N, C, H, Ch).total, nullptr, grads,
                         stream);
}

// Backward of fusion_block_bp_forward with the same inputs plus x2r (saved
// by the training forward) and g = dL/dout, all (ngroups, nW, N, G*C).
// Writes dx (and dy for cross) in that layout and grads
// (fusion_block_grad_floats() floats: the parameter gradients in parameter
// order, then dbias), summed over every subject. scratch:
// fusion_block_bp_backward_scratch_floats() floats. Returns the cudaError_t
// of the first launch that fails, or of the last.
extern "C" int fusion_block_bp_backward(int cross, const float* x, const float* y,
                                        const void* const* params, const float* bias,
                                        const float* mask, const float* x2r, const float* g,
                                        float* dx, float* dy, float* grads, float* scratch,
                                        int ngroups, int G, int nW, int N, int C, int H, int Ch,
                                        const float* dp, int seed, double attn_rate,
                                        double drop_rate, int NP, cudaStream_t stream) {
  if (bad_dims(N, C, H) || G < 1) return (int)cudaErrorInvalidValue;
  const FusionParams P = unpack_params(cross, params);
  const FusionTrain T = make_train(dp, seed, attn_rate, drop_rate, NP, nullptr);
#define BWD(c, h)                                                                           \
  launch_bp_backward<c, h>(x, y, x2r, g, P, bias, mask, T, dx, dy, grads, scratch, ngroups, \
                           G, nW, N, C, H, Ch, stream)
  return (int)FUSION_DISPATCH(cross, C / H, BWD);
#undef BWD
}
