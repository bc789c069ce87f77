// K7 entry points of the bf16 form: bf16 streams, mm16 products (the
// forward: fusion_block_bp.cuh, instantiated with MM16 = true on
// __nv_bfloat16 streams; the backward: fusion_block_bp16.cuh, on bf16
// tensor cores).
#include "fusion_block_bp16.cuh"

// The bf16 form of fusion_block_bp_forward: x, y, out and x2r are bf16
// (ngroups, nW, N, G*C) streams; everything else as there. The body runs
// with mm16 products. Returns the cudaError_t of the launch.
extern "C" int fusion_block_bp_forward16(int cross, const void* x, const void* y,
                                         const void* const* params, const float* bias,
                                         const float* mask, void* out, int ngroups, int G,
                                         int nW, int N, int C, int H, int Ch, const float* dp,
                                         int seed, double attn_rate, double drop_rate, int NP,
                                         void* x2r, cudaStream_t stream) {
  if (bad_dims(N, C, H) || G < 1) return (int)cudaErrorInvalidValue;
  using B16 = __nv_bfloat16;
  const FusionParams P = unpack_params(cross, params);
  const FusionTrain T = make_train(dp, seed, attn_rate, drop_rate, NP, x2r);
#define FWD16(c, h)                                                                          \
  launch_bp_forward<c, h, true, B16>(static_cast<const B16*>(x), static_cast<const B16*>(y), \
                                     P, bias, mask, static_cast<B16*>(out),                  \
                                     static_cast<B16*>(x2r), ngroups, G, nW, N, C, H, Ch, T, \
                                     stream)
  return (int)FUSION_FWD_DISPATCH(cross, N, C, H, Ch, FWD16);
#undef FWD16
}

// The bf16 form's scratch floats, occupancy and backward: as
// fusion_block_bp_backward_scratch_floats, fusion_block_bp_backward_occupancy
// and fusion_block_bp_backward, with x, y, x2r, g, dx and dy bf16 streams
// and mm16 products (fusion_block_bp16.cuh); grads float32.
extern "C" long long fusion_block_bp_backward16_scratch_floats(int cross, int ngroups, int G,
                                                               int nW, int N, int C, int H,
                                                               int Ch) {
  if (bad_dims(N, C, H) || G < 1) return -1;
  int blocks = 0, windows = 0;
  size_t smem = 0;
#define GRID(c, h) \
  bp16_backward_grid<c, h>(ngroups, G, nW, N, C, H, Ch, &blocks, &smem, &windows)
  if (FUSION_DISPATCH(cross, C / H, GRID) != cudaSuccess) return -1;
#undef GRID
  return (long long)blocks * FusionGrads(cross != 0, N, C, H, Ch).total;
}

extern "C" int fusion_block_bp_backward16_occupancy(int cross, int ngroups, int G, int nW, int N,
                                                    int C, int H, int Ch, int* out) {
  if (bad_dims(N, C, H) || G < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
#define GRID(c, h) \
  bp16_backward_grid<c, h>(ngroups, G, nW, N, C, H, Ch, &out[3], &smem, &out[1], &out[0])
  const cudaError_t err = FUSION_DISPATCH(cross, C / H, GRID);
#undef GRID
  out[2] = (int)smem;
  return (int)err;
}

extern "C" int fusion_block_bp_backward16(int cross, const void* x, const void* y,
                                          const void* const* params, const float* bias,
                                          const float* mask, const void* x2r, const void* g,
                                          void* dx, void* dy, float* grads, float* scratch,
                                          int ngroups, int G, int nW, int N, int C, int H,
                                          int Ch, const float* dp, int seed, double attn_rate,
                                          double drop_rate, int NP, cudaStream_t stream) {
  if (bad_dims(N, C, H) || G < 1) return (int)cudaErrorInvalidValue;
  using B16 = __nv_bfloat16;
  const FusionParams P = unpack_params(cross, params);
  const FusionTrain T = make_train(dp, seed, attn_rate, drop_rate, NP, nullptr);
#define BWD16(c, h)                                                                            \
  launch_bp_backward16<c, h>(                                                                  \
      static_cast<const B16*>(x), static_cast<const B16*>(y), static_cast<const B16*>(x2r),   \
      static_cast<const B16*>(g), P, bias, mask, T, static_cast<B16*>(dx),                    \
      static_cast<B16*>(dy), grads, scratch, ngroups, G, nW, N, C, H, Ch, stream)
  return (int)FUSION_DISPATCH(cross, C / H, BWD16);
#undef BWD16
}
