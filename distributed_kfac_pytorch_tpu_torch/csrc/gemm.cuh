// The batched fp32 tile GEMM of K3 (bucket_precond.cu; K4 runs on
// gemm_tc.cuh): one 64 x 64 output tile per 256-thread block, 4 x 4
// outputs per thread, operands staged through shared memory kK deep, every
// product a plain fp32 FMA (no tensor cores, no TF32). Each kernel that
// includes it adds its own epilogue on the accumulators.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // output tile edge; 4 x 4 per thread
constexpr int kK = 16;     // depth staged in shared memory per step

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Output tiles of an (M, N) product over S slices: grid x, y and z.
inline dim3 tile_grid(int M, int N, int S) {
  return dim3((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, S);
}

// acc[i][j] = sum_k op(A)[m0 + ty*4 + i, k] * op(B)[k, n0 + tx*4 + j] for
// the block's tile (m0, n0), with ty = t / 16 and tx = t % 16.
// op(A)[m, k] = TA ? A[k, m] : A[m, k];  op(B)[k, n] = TB ? B[n, k] : B[k, n].
// Rows past M, columns past N and depth past K read as zero. With
// `mult_bf16` every operand is rounded to bf16 before its product.
template <bool TA, bool TB>
__device__ __forceinline__ void tile_mma(const float* A, int lda,
                                         const float* B, int ldb, int M,
                                         int N, int K, int m0, int n0,
                                         int mult_bf16,
                                         float (&sa)[kK][kTile],
                                         float (&sb)[kK][kTile],
                                         float (&acc)[4][4]) {
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kK) {
#pragma unroll
    for (int q = 0; q < (kK * kTile) / kThreads; ++q) {
      const int e = t + q * kThreads;
      // Consecutive threads read consecutive addresses of each layout.
      int m, k;
      if (TA) { m = e % kTile; k = e / kTile; }
      else    { k = e % kK;    m = e / kK; }
      const int gm = m0 + m, gk = k0 + k;
      float v = 0.f;
      if (gm < M && gk < K)
        v = TA ? A[static_cast<int64_t>(gk) * lda + gm]
               : A[static_cast<int64_t>(gm) * lda + gk];
      sa[k][m] = mult_bf16 ? round_bf16(v) : v;
    }
#pragma unroll
    for (int q = 0; q < (kK * kTile) / kThreads; ++q) {
      const int e = t + q * kThreads;
      int n, k;
      if (TB) { k = e % kK;    n = e / kK; }
      else    { n = e % kTile; k = e / kTile; }
      const int gn = n0 + n, gk = k0 + k;
      float v = 0.f;
      if (gn < N && gk < K)
        v = TB ? B[static_cast<int64_t>(gn) * ldb + gk]
               : B[static_cast<int64_t>(gk) * ldb + gn];
      sb[k][n] = mult_bf16 ? round_bf16(v) : v;
    }
    __syncthreads();
    // Two-level sum: each kK-deep step is summed on its own, then added
    // to the running total, so a K-long product accumulates in chains of
    // kK + K / kK terms rather than one of K (at K ~ 2000 the one long
    // chain's rounding reaches the Newton--Schulz tolerance of 1e-5).
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
}

}  // namespace
