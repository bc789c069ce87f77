// K5: the fused Adam / AdamW update, one launch over every parameter.
//
// Replaces multimodal_neuroimage_tpu/ops/fused_update.py _fused_flat_update
// (the Pallas _kernel, :55-77): per element
//
//   g <- g * clip;  adam: g <- g + wd p  (torch-Adam L2 into the gradient)
//   mu <- b1 mu + (1 - b1) g;  nu <- b2 nu + (1 - b2) g^2
//   u <- (mu bc1) / (sqrt(nu bc2) + eps);  adamw: u <- u + wd p (decoupled)
//   p <- p + (-lr u)
//
// with the clip factor, the LR (evaluated at the pre-increment count) and
// the bias corrections bc1 = 1 / (1 - b1^t), bc2 = 1 / (1 - b2^t) computed
// outside the kernel, as the JAX package does. Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction), in the
// order of the JAX kernel, so the result is the plain PyTorch version's bit
// for bit.
//
// IN PLACE: p, mu and nu are overwritten; g is read only. The port keeps all
// parameters, gradients and moments in flat buffers (each parameter and its
// .grad are views into them, as DDP's gradient_as_bucket_view does), so the
// 1,542 tensors of the flagship take one launch.
//
// What bounds it on the H100: bytes. 4 reads + 3 writes of 4 B for each of
// the flagship's 18.06 M parameters, ~0.5 GB a step, ~0.15 ms at 3.35 TB/s;
// a grid-stride loop over coalesced float accesses, no shared memory.
#include "common.cuh"

struct AdamScalars {
  float lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  int adamw;
};

__global__ void __launch_bounds__(256)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ mu,
                  float* __restrict__ nu, long long n, const float* __restrict__ clip,
                  AdamScalars s) {
  const float scale = clip ? *clip : 1.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float pi = p[i];
    float gi = __fmul_rn(g[i], scale);
    if (!s.adamw && s.wd != 0.f) gi = __fadd_rn(gi, __fmul_rn(s.wd, pi));
    const float m = __fadd_rn(__fmul_rn(s.b1, mu[i]), __fmul_rn(s.one_minus_b1, gi));
    const float v = __fadd_rn(__fmul_rn(s.b2, nu[i]), __fmul_rn(s.one_minus_b2, __fmul_rn(gi, gi)));
    float u = __fdiv_rn(__fmul_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.bc2)), s.eps));
    if (s.adamw && s.wd != 0.f) u = __fadd_rn(u, __fmul_rn(s.wd, pi));
    p[i] = __fadd_rn(pi, __fmul_rn(-s.lr, u));
    mu[i] = m;
    nu[i] = v;
  }
}

// p, g, mu, nu: n contiguous f32 on the device; clip: one device float (the
// clip factor) or NULL (no clipping). Hyper-parameters arrive as doubles and
// are rounded to f32 here, as JAX rounds Python floats against f32 arrays.
// Returns the cudaError_t of the launch.
extern "C" int fused_adam_update(float* p, const float* g, float* mu, float* nu, long long n,
                                 const float* clip, float lr, float bc1, float bc2, double b1,
                                 double b2, double eps, double wd, int adamw,
                                 cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  AdamScalars s;
  s.lr = lr;
  s.bc1 = bc1;
  s.bc2 = bc2;
  s.b1 = (float)b1;
  s.one_minus_b1 = (float)(1.0 - b1);
  s.b2 = (float)b2;
  s.one_minus_b2 = (float)(1.0 - b2);
  s.eps = (float)eps;
  s.wd = (float)wd;
  s.adamw = adamw;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fused_adam_kernel<<<(int)blocks, 256, 0, stream>>>(p, g, mu, nu, n, clip, s);
  return (int)cudaGetLastError();
}
