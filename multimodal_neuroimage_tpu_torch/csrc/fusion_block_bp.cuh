// K7: the SwinFusion self and cross blocks on group-major streams, forward
// and backward. The forward is one kernel templated on CROSS, the shape,
// MM16 and the stream type (as K2/K3); the backward here is the float32
// one, and the bf16 form's backward is fusion_block_bp16.cuh's. The entry
// points are in fusion_block_bp.cu (float32 streams) and
// fusion_block_bp16.cu (the bf16 form), two sources that nvcc compiles side
// by side.
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
// is the grouping itself. The forward runs K2/K3's multi-window body
// (fusion_block.cuh fusion_forward_items): one work item is a (group,
// window) and up to FUSION_FWD_WINDOWS of its subjects at once, which share
// the shift mask, the weights and the bias staged once a block. The
// backward runs K2/K3's multi-window backward: one work item is a (group,
// window) and up to FUSION_BWD_WINDOWS of its subjects at once; it
// recomputes the forward from x and the saved x2r, accumulates every
// parameter and bias-table gradient over all its work in shared memory,
// writes one partial per block, and the ordered reduce_partials adds them:
// no float atomics, bitwise-repeatable gradients.
//
// What bounds it on the H100: neither bytes nor operations (about 0.6
// GFLOP a forward call at B = 16, 0.009 ms at the float32 rate) but the
// latency of a work item's chain of phases, each ended by a block barrier,
// times the items a block walks, as K2/K3.
//
// The bf16 form (fusion_block_bp_forward16 / _backward16) replaces the same
// two functions under the bf16 policy, where JAX casts the bp stacks'
// streams to bf16 and the kernels turn mm16 on (_fwd_impl_bp:721,
// _bwd_impl_bp:773): x, y, out, x2r, the cotangent and dx, dy are bf16 in
// device memory, and the parameter and bias gradients come out float32 for
// the wrapper to cast to the parameters' dtype, as JAX's d.astype(p.dtype).
// Its forward is the forward kernel instantiated on bf16 streams with mm16
// products (fusion_block.cuh, MM16 = true). Its backward is a body of its
// own, on bf16 tensor cores with its operands staged once as bf16
// (fusion_block_bp16.cuh, where its bound and design are set out).
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

// K7's forward work items: item ((grp, w), chunk) holds window w of
// subjects j = chunk * per .. chunk * per + per - 1 of group grp.
template <typename S>
struct FusionBpItems {
  const S *x, *y;
  S *out, *x2r;
  FusionTrain T;
  int ngroups, G, nW, N, C, H, Ch, per;

  __device__ int chunks() const { return (G + per - 1) / per; }
  __device__ int count() const { return ngroups * nW * chunks(); }
  __device__ int windows(int item) const { return min(per, G - item % chunks() * per); }
  __device__ int position(int item) const { return item / chunks() % nW; }
  __device__ FusionWindowT<S> window(int item, int k) const {
    const int gw = item / chunks(), j = item % chunks() * per + k;
    FusionWindowT<S> W = bp_window<S>(gw / nW, gw % nW, j, G, C, H, Ch, T);
    const size_t off = (size_t)gw * N * G * C + (size_t)j * C;
    W.x = x + off;
    W.y = y ? y + off : nullptr;
    W.out = out + off;
    W.x2r = x2r ? x2r + off : nullptr;
    return W;
  }
};

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
      FusionWindow W = bp_window<float>(grp, w, j, G, C, H, Ch, T);
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
// Launch plumbing of both forms.
// ---------------------------------------------------------------------------

template <bool CROSS, bool FLAG, bool MM16 = false, typename S = float>
static cudaError_t launch_bp_forward(const S* x, const S* y, const FusionParams& P,
                                     const float* bias, const float* mask, S* out, S* x2r,
                                     int ngroups, int G, int nW, int N, int C, int H, int Ch,
                                     const FusionTrain& T, cudaStream_t stream) {
  auto items = [&](int per) {
    return FusionBpItems<S>{x, CROSS ? y : nullptr, out, x2r, T, ngroups, G, nW, N, C, H, Ch,
                            per};
  };
  return launch_fusion_forward<CROSS, FLAG, MM16, S>(items, G, ngroups * nW, P, bias, mask, N,
                                                       C, H, Ch, T, stream);
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
  fusion_block_bp_backward_kernel<CROSS, MAXHD>
      <<<blocks, FUSION_BWD_THREADS, smem, stream>>>(
      x, y, x2r, g, P, bias, mask, T, dx, dy, scratch, ngroups, G, nW, N, C, H, Ch, windows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(scratch, blocks, FusionGrads(CROSS, N, C, H, Ch).total, nullptr, grads,
                         stream);
}

