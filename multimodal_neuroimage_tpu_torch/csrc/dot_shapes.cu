// K8: a batched matrix product, C[b] = alpha * A[b] B[b], float32
// accumulation, operands float32 or rounded once to bfloat16.
//
// Replaces scripts/bench_dot_shapes.py _mk.run: the micro-benchmark that
// chains scores + context batched products of the fusion window attention in
// five formulations (cur, sm, st, ffold, flat) at the flagship's G = 8
// geometry. The TPU kernel kept a cell's whole chain in VMEM; on the card the
// cur operands alone are 737 KB a window, far past a block's 227 KB of shared
// memory, so a chain of `reps` pairs is 2 * reps launches of this kernel
// (ops/dot_shapes.py) with the scores going through device memory.
//
// Batch: two levels (outer, inner) with a stride each for A and B, so that a
// stride of 0 broadcasts an operand (the TPU kernel read block 0 of every
// input in every grid cell); C is contiguous.
//
// What bounds it on the H100: at f32, operations (5.78 GFLOP a cur pair over
// 196 windows, 0.086 ms at 67 TFLOP/s outside the tensor cores); at bf16,
// the bytes of three of the five formulations (the chain's operands and
// output) and the operations of the other two. Every product here has K = 96
// (scores) or N = 96 (context), with the other output dimension 40 to 7,680.
//
// Design:
// - Tiles by shape: one of six compile-time block tiles (BM x BN in
//   {128x128, 64x128, 48x128, 128x48, 64x96, 48x96}), picked per product by
//   ops/dot_shapes.py choose_config (the least padded output, then the larger
//   tile), so that M = 40 (cur) or N = 40 (st scores) wastes 17%, not 38-53%
//   as a fixed 64x64 tile did.
// - Split-K where the grid is short and K long (the cur, ffold and flat
//   context products): split s of S takes the 32-wide k chunks
//   [s * nc / S, (s + 1) * nc / S) of nc = ceil(K / 32), writes an f32
//   partial, and one ordered pass adds the S partials (common.cuh
//   reduce_partials): no float atomics, the same result on every run.
// - Work items (tile, split, batch) run with the batch's outer level fastest,
//   so that the 7 cells reading one broadcast (stride-0) tile run together
//   and six of them find it in L2.
// - bf16 (the script's cast after S * 1e-3): tensor cores through warp-level
//   mma.sync.m16n8k16 (bf16 x bf16 -> f32). The operands arrive as f32 and
//   must be scaled and rounded on their way in, which a TMA copy cannot do:
//   16-byte cp.async copies fill a 2-stage ring of raw 32-deep tiles and
//   each warp builds its fragments from it, f32 pairs scaled (A by alpha) and
//   rounded with __floats2bfloat162_rn, on padded rows that put a fragment's
//   reads on distinct banks. In a chain the scores product stores
//   bf16(1e-3 S), the value the context product rounds at load, in half the
//   bytes, and the context product reads it with ldmatrix: the bf16 chain
//   ran 6-27% faster this way than with f32 scores (PERF.md). Products of
//   two bf16 values are exact in f32, so only the summation order differs
//   from a scalar loop. wgmma (the card's full tensor-core rate) and a bf16
//   operand pass that would let TMA feed it are for a later change: the
//   bf16 products measured no faster with deeper k tiles or more stages
//   (which cost blocks per SM), tiles rounded once per block for ldmatrix,
//   or persistent blocks.
// - f32 (the full-precision yardstick; TF32 stays off): a SIMT GEMM on FMAs.
//   16-byte cp.async copies feed a 3-stage ring of shared tiles (A m-major,
//   B k-major, each row padded by 16 bytes), each thread keeps an 8 x 8 (6 x 8
//   where BM = 48) register tile and reads shared memory as float4: its rows
//   are strided by the block's thread rows and its columns are two float4
//   halves BN / 2 apart, so that a quarter warp's reads hit distinct banks.
//   alpha scales the output.
// - Ragged M, N and K are zero-filled at load and masked at store. Where K or
//   N is not a multiple of 4 (8 for a bf16 A) or an operand is not 16-byte
//   aligned, that operand loads element by element.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

#define DOT_KCHUNK 32   // split-K granularity (ops/dot_shapes.py K_CHUNK)
#define DOT_TILES 6

struct DotArgs {
  const float* A;  // float32 operands, or A already in bfloat16 (a16 mode)
  const float* B;
  float* C;        // the output, or the split partials [splits][batch][M][N]
  int M, N, K, outer, inner, nchunks, splits;
  long long sa0, sa1, sb0, sb1;
  float alpha, oscale;       // oscale: bf16 output (c16 mode) holds oscale * C
  int vec_a, vec_b, vec_c;   // 16-byte loads of A / B rows; vector stores of C
};

// One output tile of one split of one batch: a work item. Items are
// numbered tile fastest, then split, then batch, and the batch's outer level
// (the broadcast cells) runs fastest within the batch, so that the blocks
// reading one broadcast tile run together and all but the first find it in
// L2.
struct DotItem {
  int m0, n0, kbeg, kend;
  long long a_off, b_off, c_off;   // in elements of A, B and C
};

template <int BM, int BN>
__device__ __forceinline__ DotItem dot_item(const DotArgs& p, int idx) {
  const int tiles_n = (p.N + BN - 1) / BN, tiles = ((p.M + BM - 1) / BM) * tiles_n;
  const int tile = idx % tiles, rest = idx / tiles;
  const int s = rest % p.splits, z = rest / p.splits;
  const int bo = z % p.outer, bi = z / p.outer;
  DotItem d;
  d.m0 = (tile / tiles_n) * BM;
  d.n0 = (tile % tiles_n) * BN;
  d.a_off = bo * p.sa0 + bi * p.sa1;
  d.b_off = bo * p.sb0 + bi * p.sb1;
  d.c_off = ((long long)s * p.outer * p.inner + (long long)bo * p.inner + bi) * p.M * p.N;
  d.kbeg = (int)((long long)s * p.nchunks / p.splits) * DOT_KCHUNK;
  d.kend = min((int)((long long)(s + 1) * p.nchunks / p.splits) * DOT_KCHUNK, p.K);
  return d;
}

template <int BM, int BN>
__host__ __device__ __forceinline__ int dot_items(const DotArgs& p) {
  return ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN) * p.splits * p.outer * p.inner;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A rows x BK floats of f32 rows (row stride ld, valid columns < kend, valid
// rows < rows_valid) into shared rows of AST floats, starting at column k0;
// ragged ends are zero-filled.
template <int ROWS, int BK, int AST, int THREADS>
__device__ __forceinline__ void dot_copy_rows(float* dst, const float* __restrict__ src,
                                              long long ld, int rows_valid, int k0, int kend,
                                              int vec) {
  for (int c = threadIdx.x; c < ROWS * BK / 4; c += THREADS) {
    const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4, k = k0 + kc;
    float* d = dst + r * AST + kc;
    const float* row = src + (long long)min(r, rows_valid - 1) * ld;
    if (vec) {
      const bool ok = r < rows_valid && k < kend;
      cp_async16(d, ok ? row + k : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = r < rows_valid && k + e < kend;
        cp_async4(d + e, ok ? row + k + e : src, ok ? 4 : 0);
      }
    }
  }
}

// BK rows x BN columns of f32 B (b: row 0 at the tile's first column, row
// stride N; rows valid below kend, columns below cols_valid) into shared rows
// of BST floats, starting at row k0; ragged ends are zero-filled.
template <int BK, int BN, int BST, int THREADS>
__device__ __forceinline__ void dot_copy_b(float* dst, const float* __restrict__ b, int N, int K,
                                           int cols_valid, int k0, int kend, int vec) {
  for (int c = threadIdx.x; c < BK * BN / 4; c += THREADS) {
    const int r = c / (BN / 4), nc = (c % (BN / 4)) * 4, k = k0 + r;
    float* d = dst + r * BST + nc;
    const float* row = b + (long long)min(k, K - 1) * N;
    if (vec) {
      const bool ok = k < kend && nc < cols_valid;
      cp_async16(d, ok ? row + nc : b, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k < kend && nc + e < cols_valid;
        cp_async4(d + e, ok ? row + nc + e : b, ok ? 4 : 0);
      }
    }
  }
}

// ---- bf16: mma.sync on tensor cores ------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats scaled by s and rounded to a bf16 pair (x in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y, float s) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x * s, y * s);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int BM, int BN, bool A16>
struct DotMma {
  static constexpr int BK = 32, STAGES = 2;
  // A: f32 rows of BK + 8 floats (float2 fragment reads hit distinct banks
  // per half warp), or bf16 rows of BK + 8 values (ldmatrix's 8 row reads
  // hit distinct banks); B: f32 rows of BN + 4 floats (BN + 4 = 4 mod 16:
  // the fragment's k = 2t rows and n = g columns hit distinct banks)
  static constexpr int AST = BK + 8, BST = BN + 4;
  static constexpr int A_BYTES = BM * AST * (A16 ? 2 : 4), B_BYTES = BK * BST * 4;
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES);
};

// Block tile BM x BN (one work item a block), k tiles of 32 in a 2-stage
// cp.async ring of raw operand tiles, WM x WN warps each owning a
// (BM / WM) x (BN / WN) warp tile of m16n8 accumulators, whose fragments
// each warp builds from the ring: f32 pairs scaled (A by alpha) and rounded
// with __floats2bfloat162_rn, or ldmatrix where A arrives in bf16 (A16:
// already scaled and rounded). C16: the output is bf16(oscale * C)
// (splits 1).
template <int BM, int BN, int WM, int WN, bool A16, bool C16>
__global__ void __launch_bounds__(32 * WM * WN) dot_bf16_kernel(DotArgs p) {
  using F = DotMma<BM, BN, A16>;
  constexpr int BK = F::BK, STAGES = F::STAGES, THREADS = 32 * WM * WN;
  constexpr int AST = F::AST, BST = F::BST;
  constexpr int WTM = BM / WM, WTN = BN / WN, MI = WTM / 16, NI = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BK % 16 == 0, "warp tile");
  extern __shared__ float4 dot_smem4[];
  char* smem = reinterpret_cast<char*>(dot_smem4);
  float* Bs = reinterpret_cast<float*>(smem + STAGES * F::A_BYTES);

  const DotItem d = dot_item<BM, BN>(p, blockIdx.x);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN, g = lane / 4, t = lane % 4;
  const int ktiles = (d.kend - d.kbeg + BK - 1) / BK, rows_a = p.M - d.m0;

  auto load = [&](int stage, int kt) {
    const int k0 = d.kbeg + kt * BK;
    if (A16) {
      __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem + stage * F::A_BYTES);
      const __nv_bfloat16* a =
          reinterpret_cast<const __nv_bfloat16*>(p.A) + d.a_off + (long long)d.m0 * p.K;
      for (int c = tid; c < BM * BK / 8; c += THREADS) {
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8, k = k0 + kc;
        __nv_bfloat16* dst = as + r * AST + kc;
        const __nv_bfloat16* row = a + (long long)min(r, rows_a - 1) * p.K;
        if (p.vec_a) {
          const bool ok = r < rows_a && k < d.kend;
          cp_async16(dst, ok ? row + k : a, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = r < rows_a && k + e < d.kend ? row[k + e] : __float2bfloat16(0.f);
        }
      }
    } else {
      dot_copy_rows<BM, BK, AST, THREADS>(reinterpret_cast<float*>(smem + stage * F::A_BYTES),
                                          p.A + d.a_off + (long long)d.m0 * p.K, p.K, rows_a,
                                          k0, d.kend, p.vec_a);
    }
    dot_copy_b<BK, BN, BST, THREADS>(Bs + stage * BK * BST, p.B + d.b_off + d.n0, p.N, p.K,
                                     p.N - d.n0, k0, d.kend, p.vec_b);
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt landed; every thread is done with tile kt - 1
    if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const char* as = smem + (kt % STAGES) * F::A_BYTES;
    const float* bs = Bs + (kt % STAGES) * BK * BST;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wm * WTM + i * 16;
        if (A16) {
          ldmatrix_x4(af[i], reinterpret_cast<const __nv_bfloat16*>(as) + (r + lane % 16) * AST +
                                 ks + (lane / 16) * 8);
        } else {
          // a0..a3: (row g, k 2t), (row g + 8, k 2t), (g, 2t + 8), (g + 8, 2t + 8)
          const float* a = reinterpret_cast<const float*>(as) + (r + g) * AST + ks + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = *reinterpret_cast<const float2*>(a + (e % 2) * 8 * AST + (e / 2) * 8);
            af[i][e] = pack_bf16(x.x, x.y, p.alpha);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        // b0: k 2t, 2t + 1 and b1: k 2t + 8, 2t + 9, at column g
        const float* b = bs + (ks + 2 * t) * BST + wn * WTN + j * 8 + g;
        const uint32_t b0 = pack_bf16(b[0], b[BST], 1.f);
        const uint32_t b1 = pack_bf16(b[8 * BST], b[9 * BST], 1.f);
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j): rows g and g + 8, columns 2t and 2t + 1 of its m16n8
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = d.m0 + wm * WTM + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = d.n0 + wn * WTN + j * 8 + 2 * t;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (C16) {
          __nv_bfloat16* crow =
              reinterpret_cast<__nv_bfloat16*>(p.C) + d.c_off + (long long)m * p.N;
          if (p.vec_c && n + 1 < p.N) {
            *reinterpret_cast<__nv_bfloat162*>(crow + n) =
                __floats2bfloat162_rn(x * p.oscale, y * p.oscale);
          } else {
            if (n < p.N) crow[n] = __float2bfloat16_rn(x * p.oscale);
            if (n + 1 < p.N) crow[n + 1] = __float2bfloat16_rn(y * p.oscale);
          }
        } else {
          float* crow = p.C + d.c_off + (long long)m * p.N;
          if (p.vec_c && n + 1 < p.N) {
            *reinterpret_cast<float2*>(crow + n) = make_float2(x, y);
          } else {
            if (n < p.N) crow[n] = x;
            if (n + 1 < p.N) crow[n + 1] = y;
          }
        }
      }
    }
}

// ---- f32: a SIMT GEMM fed by cp.async ----------------------------------------------

template <int BM, int BN, int TM>
struct DotF32 {
  static constexpr int BK = 16, STAGES = 3, TN = 8;
  static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  static constexpr int AST = BK + 4, BST = BN + 4;   // float row strides (16-byte pad)
  static constexpr int SMEM = STAGES * (BM * AST + BK * BST) * (int)sizeof(float);
};

// Thread (ty, tx) owns rows ty + TY * i (i < TM) and columns tx * 4 + c and
// BN / 2 + tx * 4 + c (c < 4) of the BM x BN block tile.
template <int BM, int BN, int TM>
__global__ void __launch_bounds__(DotF32<BM, BN, TM>::THREADS) dot_f32_kernel(DotArgs p) {
  using F = DotF32<BM, BN, TM>;
  constexpr int BK = F::BK, STAGES = F::STAGES, TX = F::TX, TY = F::TY, THREADS = F::THREADS;
  constexpr int AST = F::AST, BST = F::BST;
  static_assert(BN % 8 == 0 && BM % TM == 0, "block tile");
  extern __shared__ float4 dot_smem4[];
  float* As = reinterpret_cast<float*>(dot_smem4);
  float* Bs = As + STAGES * BM * AST;

  const DotItem d = dot_item<BM, BN>(p, blockIdx.x);
  const int m0 = d.m0, n0 = d.n0;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int ktiles = (d.kend - d.kbeg + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    const int k0 = d.kbeg + kt * BK;
    dot_copy_rows<BM, BK, AST, THREADS>(As + stage * BM * AST, p.A + d.a_off + (long long)m0 * p.K,
                                        p.K, p.M - m0, k0, d.kend, p.vec_a);
    dot_copy_b<BK, BN, BST, THREADS>(Bs + stage * BK * BST, p.B + d.b_off + n0, p.N, p.K,
                                     p.N - n0, k0, d.kend, p.vec_b);
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt landed; every thread is done with tile kt - 1
    if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const float* as = As + (kt % STAGES) * BM * AST;
    const float* bs = Bs + (kt % STAGES) * BK * BST;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + TY * i) * AST + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + (k4 + kk) * BST + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + (k4 + kk) * BST + BN / 2 + tx * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, b0.x, acc[i][0]);
          acc[i][1] = fmaf(av, b0.y, acc[i][1]);
          acc[i][2] = fmaf(av, b0.z, acc[i][2]);
          acc[i][3] = fmaf(av, b0.w, acc[i][3]);
          acc[i][4] = fmaf(av, b1.x, acc[i][4]);
          acc[i][5] = fmaf(av, b1.y, acc[i][5]);
          acc[i][6] = fmaf(av, b1.z, acc[i][6]);
          acc[i][7] = fmaf(av, b1.w, acc[i][7]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= p.M) continue;
    float* crow = p.C + d.c_off + (long long)m * p.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      const float4 v = make_float4(p.alpha * acc[i][4 * h], p.alpha * acc[i][4 * h + 1],
                                   p.alpha * acc[i][4 * h + 2], p.alpha * acc[i][4 * h + 3]);
      if (p.vec_c && n + 3 < p.N) {
        *reinterpret_cast<float4*>(crow + n) = v;
      } else {
        if (n < p.N) crow[n] = v.x;
        if (n + 1 < p.N) crow[n + 1] = v.y;
        if (n + 2 < p.N) crow[n + 2] = v.z;
        if (n + 3 < p.N) crow[n + 3] = v.w;
      }
    }
  }
}

// ---- launch ---------------------------------------------------------------------------

// one block a work item; shared memory opted in once (per instantiation)
template <typename Kernel>
static cudaError_t dot_launch_kernel(Kernel kernel, const DotArgs& p, int items, int threads,
                                     int smem, bool& ready, cudaStream_t stream) {
  if (!ready) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  kernel<<<items, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN, int WM, int WN, bool A16, bool C16>
static cudaError_t dot_launch_mma(const DotArgs& p, cudaStream_t stream) {
  static bool ready = false;
  return dot_launch_kernel(dot_bf16_kernel<BM, BN, WM, WN, A16, C16>, p, dot_items<BM, BN>(p),
                           32 * WM * WN, DotMma<BM, BN, A16>::SMEM, ready, stream);
}

// mode: 0 f32; 1 bf16; 2 bf16 with A already in bf16; 3 bf16 with a bf16 output
template <int BM, int BN, int TM, int WM, int WN>
static cudaError_t dot_launch(const DotArgs& p, int mode, cudaStream_t stream) {
  if (mode == 1) return dot_launch_mma<BM, BN, WM, WN, false, false>(p, stream);
  if (mode == 2) return dot_launch_mma<BM, BN, WM, WN, true, false>(p, stream);
  if (mode == 3) return dot_launch_mma<BM, BN, WM, WN, false, true>(p, stream);
  static bool ready = false;
  return dot_launch_kernel(dot_f32_kernel<BM, BN, TM>, p, dot_items<BM, BN>(p),
                           DotF32<BM, BN, TM>::THREADS, DotF32<BM, BN, TM>::SMEM, ready, stream);
}

// A: rows of K values, B: rows of N floats (each matrix row-major); batch
// b = bo * inner + bi of outer * inner starts at A + bo * sa0 + bi * sa1 and
// B + bo * sb0 + bi * sb1 (strides in elements, 0 broadcasts); C (outer *
// inner, M, N) contiguous. mode 0: float32 throughout; 1: every operand
// rounded to bfloat16 at load, after alpha; 2: as 1 with A already in
// bfloat16 (scaled and rounded; alpha unused); 3: as 1 with C stored as
// bfloat16(oscale * C) (splits 1). tile: the block tile, in
// ops/dot_shapes.py TILES order (0 128x128, 1 64x128, 2 48x128, 3 128x48,
// 4 64x96, 5 48x96); splits: split-K factor, at most ceil(K / 32); with
// splits > 1, part holds splits * outer * inner * M * N floats of scratch.
// Returns the cudaError_t of the first launch that fails, or of the last.
extern "C" int batched_matmul(const void* A, const float* B, void* C, float* part, int outer,
                              int inner, int M, int N, int K, long long sa0, long long sa1,
                              long long sb0, long long sb1, float alpha, float oscale, int mode,
                              int tile, int splits, cudaStream_t stream) {
  const int nchunks = (K + DOT_KCHUNK - 1) / DOT_KCHUNK;
  if (M < 1 || N < 1 || K < 1 || outer < 1 || inner < 1 || outer * inner > 65535 || tile < 0 ||
      tile >= DOT_TILES || mode < 0 || mode > 3 || splits < 1 || splits > nchunks ||
      (splits > 1 && (part == nullptr || mode == 3)))
    return (int)cudaErrorInvalidValue;
  DotArgs p;
  p.A = static_cast<const float*>(A);
  p.B = B;
  p.C = splits > 1 ? part : static_cast<float*>(C);
  p.M = M;
  p.N = N;
  p.K = K;
  p.outer = outer;
  p.inner = inner;
  p.nchunks = nchunks;
  p.splits = splits;
  p.sa0 = sa0;
  p.sa1 = sa1;
  p.sb0 = sb0;
  p.sb1 = sb1;
  p.alpha = alpha;
  p.oscale = oscale;
  const int per16 = mode == 2 ? 8 : 4;   // A elements in 16 bytes
  p.vec_a = K % per16 == 0 && sa0 % per16 == 0 && sa1 % per16 == 0 && (uintptr_t)A % 16 == 0;
  p.vec_b = N % 4 == 0 && sb0 % 4 == 0 && sb1 % 4 == 0 && (uintptr_t)B % 16 == 0;
  p.vec_c = N % 4 == 0;
  const int batch = outer * inner;
  cudaError_t err;
  switch (tile) {   // <BM, BN, f32 rows a thread, bf16 warps along m, along n>
    case 0: err = dot_launch<128, 128, 8, 2, 4>(p, mode, stream); break;
    case 1: err = dot_launch<64, 128, 8, 2, 2>(p, mode, stream); break;
    case 2: err = dot_launch<48, 128, 6, 1, 4>(p, mode, stream); break;
    case 3: err = dot_launch<128, 48, 8, 4, 1>(p, mode, stream); break;
    case 4: err = dot_launch<64, 96, 8, 2, 2>(p, mode, stream); break;
    default: err = dot_launch<48, 96, 6, 1, 3>(p, mode, stream); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)reduce_partials(part, splits, (long long)batch * M * N, nullptr,
                              static_cast<float*>(C), stream);
}
