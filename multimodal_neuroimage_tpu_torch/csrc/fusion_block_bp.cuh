// K7: the SwinFusion self and cross blocks on group-major streams, forward
// and backward, one kernel each way templated on CROSS, the head-dim bound,
// MM16 and the stream type (as K2/K3). The entry points are in
// fusion_block_bp.cu (float32 streams) and fusion_block_bp16.cu (the bf16
// form), two sources that nvcc compiles side by side.
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
//
// The bf16 form (fusion_block_bp_forward16 / _backward16) replaces the same
// two functions under the bf16 policy, where JAX casts the bp stacks'
// streams to bf16 and the kernels turn mm16 on (_fwd_impl_bp:721,
// _bwd_impl_bp:773): x, y, out, x2r, the cotangent and dx, dy are bf16 in
// device memory, the window body computes in float32 with mm16 products
// (fusion_block.cuh, MM16 = true), and the parameter and bias gradients
// come out float32 for the wrapper to cast to the parameters' dtype, as
// JAX's d.astype(p.dtype). Same kernels, instantiated on the stream type;
// latency per window bounds them as the float32 form, and the bf16 form
// spends more instructions a window (the mm16 softmax's extra pass, operand
// rounding on every product read) to halve the streams' bytes.
#pragma once

#include "fusion_block.cuh"

// Row stride, dropout coordinates and DropPath factors of subject j's
// window in item (g, w); the caller sets the stream pointers.
template <typename S>
__device__ __forceinline__ FusionWindowT<S> bp_window(int g, int w, int j, int G, int C, int H,
                                                      int Ch, const FusionTrain& T) {
  FusionWindowT<S> W = {};
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

template <bool CROSS, int MAXHD, bool MM16, typename S>
__global__ void __launch_bounds__(FUSION_THREADS)
fusion_block_bp_kernel(const S* __restrict__ x, const S* __restrict__ y, FusionParams P,
                       const float* __restrict__ bias, const float* __restrict__ mask,
                       S* __restrict__ out, S* __restrict__ x2r, int items, int G, int nW, int N,
                       int C, int H, int Ch, FusionTrain T) {
  extern __shared__ float smem[];
  const FusionLayout L(CROSS, N, C, H, Ch);
  stage_weights<FUSION_THREADS, MM16>(smem, L, CROSS, P, bias, N, C, H, Ch);

  // each block walks (group, window) items g * nW + w with a grid stride
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item / nW, w = item % nW;
    const size_t base = (size_t)item * N * G * C;
    if (mask) stage(smem + L.mask, L.BS, mask + (size_t)w * N * N, N, N);
    for (int j = 0; j < G; ++j) {
      FusionWindowT<S> W = bp_window<S>(g, w, j, G, C, H, Ch, T);
      const size_t off = base + (size_t)j * C;
      W.x = x + off;
      W.y = CROSS ? y + off : nullptr;
      W.out = out + off;
      W.x2r = x2r ? x2r + off : nullptr;
      fusion_forward_window<CROSS, MAXHD, MM16>(smem, L, mask != nullptr, N, C, H, Ch, T, W);
    }
  }
}

template <bool CROSS, int MAXHD, bool MM16, typename S>
__global__ void __launch_bounds__(FUSION_BWD_THREADS, 1)
fusion_block_bp_backward_kernel(const S* __restrict__ x, const S* __restrict__ y,
                                const S* __restrict__ x2r, const S* __restrict__ g,
                                FusionParams P, const float* __restrict__ bias,
                                const float* __restrict__ mask, FusionTrain T,
                                S* __restrict__ dx, S* __restrict__ dy,
                                float* __restrict__ part, int ngroups, int G, int nW, int N,
                                int C, int H, int Ch, int windows) {
  extern __shared__ float smem[];
  __shared__ FusionWindowT<S> wins[FUSION_BWD_WINDOWS];
  const FusionBwdLayout L(CROSS, N, C, H, Ch, windows);
  const FusionLayout F(CROSS, N, C, H, Ch);
  const FusionGrads Gr(CROSS, N, C, H, Ch);
  float* acc = smem + L.acc;

  for (int e = threadIdx.x; e < Gr.total; e += FUSION_BWD_THREADS) acc[e] = 0.f;
  stage_weights<FUSION_BWD_THREADS, MM16>(smem + L.fwd, F, CROSS, P, bias, N, C, H, Ch);

  // work item ((grp, w), chunk): subjects chunk * windows + k of group grp
  const int chunks = (G + windows - 1) / windows;
  for (int item = blockIdx.x; item < ngroups * nW * chunks; item += gridDim.x) {
    const int gw = item / chunks, j0 = (item % chunks) * windows;
    const int grp = gw / nW, w = gw % nW;
    const int kw = min(windows, G - j0);
    if (threadIdx.x < kw) {
      const int j = j0 + threadIdx.x;
      FusionWindowT<S> W = bp_window<S>(grp, w, j, G, C, H, Ch, T);
      const size_t off = (size_t)gw * N * G * C + (size_t)j * C;
      W.x = x + off;
      W.y = CROSS ? y + off : nullptr;
      W.x2r = const_cast<S*>(x2r) + off;
      W.g = g + off;
      W.dx = dx + off;
      W.dy = CROSS ? dy + off : nullptr;
      wins[threadIdx.x] = W;
    }
    if (mask)
      stage<FUSION_BWD_THREADS>(smem + L.fwd + F.mask, F.BS, mask + (size_t)w * N * N, N, N);
    __syncthreads();
    fusion_backward_windows<CROSS, MAXHD, MM16>(smem, L, F, Gr, mask != nullptr, N, C, H, Ch, T,
                                                wins, kw);
  }
  float* mine = part + (size_t)blockIdx.x * Gr.total;
  for (int e = threadIdx.x; e < Gr.total; e += FUSION_BWD_THREADS) mine[e] = acc[e];
}

// ---------------------------------------------------------------------------
// Launch plumbing of both forms.
// ---------------------------------------------------------------------------

template <bool CROSS, int MAXHD, bool MM16 = false, typename S = float>
static cudaError_t launch_bp_forward(const S* x, const S* y, const FusionParams& P,
                                     const float* bias, const float* mask, S* out, S* x2r,
                                     int items, int G, int nW, int N, int C, int H, int Ch,
                                     const FusionTrain& T, cudaStream_t stream) {
  const size_t smem = (size_t)FusionLayout(CROSS, N, C, H, Ch).total * sizeof(float);
  auto kernel = fusion_block_bp_kernel<CROSS, MAXHD, MM16, S>;
  int blocks = 0;
  cudaError_t err = persistent_grid(kernel, smem, items, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, FUSION_THREADS, smem, stream>>>(x, y, P, bias, mask, out, x2r, items, G, nW,
                                                  N, C, H, Ch, T);
  return cudaGetLastError();
}

template <bool CROSS, int MAXHD, bool MM16 = false, typename S = float>
static cudaError_t bp_backward_grid(int ngroups, int G, int nW, int N, int C, int H, int Ch,
                                    int* blocks, size_t* smem, int* windows,
                                    int* per_sm = nullptr) {
  cudaError_t err = backward_windows(CROSS, N, C, H, Ch, G, windows, smem);
  if (err != cudaSuccess) return err;
  const int items = ngroups * nW * ((G + *windows - 1) / *windows);
  return persistent_grid(fusion_block_bp_backward_kernel<CROSS, MAXHD, MM16, S>, *smem, items,
                         blocks, FUSION_BWD_THREADS, per_sm);
}

template <bool CROSS, int MAXHD, bool MM16 = false, typename S = float>
static cudaError_t launch_bp_backward(const S* x, const S* y, const S* x2r, const S* g,
                                      const FusionParams& P, const float* bias,
                                      const float* mask, const FusionTrain& T, S* dx, S* dy,
                                      float* grads, float* scratch, int ngroups, int G, int nW,
                                      int N, int C, int H, int Ch, cudaStream_t stream) {
  int blocks = 0, windows = 0;
  size_t smem = 0;
  cudaError_t err = bp_backward_grid<CROSS, MAXHD, MM16, S>(ngroups, G, nW, N, C, H, Ch,
                                                            &blocks, &smem, &windows);
  if (err != cudaSuccess) return err;
  fusion_block_bp_backward_kernel<CROSS, MAXHD, MM16, S>
      <<<blocks, FUSION_BWD_THREADS, smem, stream>>>(
      x, y, x2r, g, P, bias, mask, T, dx, dy, scratch, ngroups, G, nW, N, C, H, Ch, windows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(scratch, blocks, FusionGrads(CROSS, N, C, H, Ch).total, nullptr, grads,
                         stream);
}

