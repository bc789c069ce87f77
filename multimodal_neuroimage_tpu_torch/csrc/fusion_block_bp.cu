// K7 entry points on float32 streams (the kernels: fusion_block_bp.cuh).
#include "fusion_block_bp.cuh"

// ---------------------------------------------------------------------------
// Entry points.
// ---------------------------------------------------------------------------

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
  launch_bp_forward<c, h>(x, y, P, bias, mask, out, x2r, ngroups, G, nW, N, C, H, Ch, T, stream)
  return (int)FUSION_FWD_DISPATCH(cross, N, C, H, Ch, FWD);
#undef FWD
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

