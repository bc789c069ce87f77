"""The rate of warp-level ``mma.sync`` on one CUDA card, the instruction the
port's tensor-core kernels issue (K1's and K6's float32 forms:
``m16n8k8`` TF32; the bf16 forms: ``m16n8k16`` bf16).

    python -m multimodal_neuroimage_tpu_torch.bench.mma_rate

Compiles a small benchmark with ``nvcc`` into the package's ``_build/``
directory and runs it: 528 blocks of 1, 2 and 4 warps, each warp issuing
eight independent accumulator chains of ``mma.sync`` for 4096 rounds, timed
with CUDA events; prints TFLOP/s (2 operations a multiply-add) and ns per
``mma`` per SM, with the card's name and power limit. The data sheet's
dense TF32 peak (495 TFLOP/s) is ``wgmma``'s; this is what ``mma.sync``
reaches. Without a card or ``nvcc`` it exits with code 2.
"""

from __future__ import annotations

import subprocess
import sys

SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

template <int KIND>
__global__ void bench(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int KIND>
static void run(const char* name, double flop, int warps) {
  const int blocks = 528, threads = 32 * warps, iters = 4096;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  bench<KIND><<<blocks, threads>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<KIND><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const double mmas = (double)blocks * warps * iters * 8;
  printf("%s, %d warp(s) a block x %d blocks: %.1f TFLOP/s, %.3f ns per mma per SM\n", name,
         warps, blocks, mmas * flop / (ms * 1e-3) / 1e12, ms * 1e6 / (mmas / sms));
  cudaFree(out);
}

int main() {
  for (int w : {1, 2, 4}) {
    run<0>("mma.sync m16n8k8 tf32", 2.0 * 16 * 8 * 8, w);
    run<1>("mma.sync m16n8k16 bf16", 2.0 * 16 * 8 * 16, w);
  }
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> int:
    import torch
    from multimodal_neuroimage_tpu_torch.ops import build
    if not torch.cuda.is_available():
        print("mma_rate: needs a CUDA card", file=sys.stderr)
        return 2
    try:
        nvcc = build._nvcc()
    except RuntimeError as err:
        print(f"mma_rate: {err}", file=sys.stderr)
        return 2
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, exe = build.BUILD_DIR / "mma_rate.cu", build.BUILD_DIR / "mma_rate"
    src.write_text(SOURCE)
    subprocess.run([nvcc] + build.ARCH_FLAGS + ["-O3", "-o", str(exe), str(src)],
                   check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
