// Batched fp32 tile GEMM on the Hopper tensor cores by 3xTF32, used by K4
// (ns_inverse.cu). K3 keeps the CUDA-core GEMM of gemm.cuh.
//
// One 128 x 128 output tile of C = A B (A: M x K, B: K x N, both row-major)
// per 256-thread block. The 8 warps sit in a 2 x 4 grid, each owning 64 x 32
// of the tile as 4 x 4 tiles of mma.sync.m16n8k8 (TF32 in, fp32 out).
// Operands are staged kTcK = 32 deep through a kTcStages-slot cp.async ring
// in dynamic shared memory (kTcSmemBytes, above the 48 KB default: the host
// raises each kernel's limit with cudaFuncSetAttribute before launching).
// The warps load their fragments from shared memory themselves, so B is
// taken as it lies (row-major); rows are padded (kTcLdA, kTcLdB) so that
// every fragment load touches 32 distinct banks.
//
// 3xTF32: each fp32 operand x splits into a TF32 big part b (x rounded to
// nearest) and a TF32 small part s (the rest x - b, cut to TF32), and a
// product is taken as a_s b_b + a_b b_s + a_b b_b, small terms first,
// accumulated in fp32. The dropped a_s b_s and the cut of the small parts
// lie below 2^-21 of the product, near fp32's own rounding, while one TF32
// product keeps only 2^-11 (the Newton--Schulz residual stalls near 2e-3
// with it). The split costs four integer and float operations per operand
// element, done on the fragments each warp loads (no conversion unit).
//
// Two-level sum: the tensor cores add into their accumulator with
// truncation, so one chain of 3 K / 8 additions would drift away from an
// fp32 sum; every 32-deep k-tile is summed into fresh accumulators, which
// are then added to the running ones by the CUDA cores (round to nearest),
// a chain of K / 32 additions.
//
// Ragged edges: rows, columns and depth past M, N and K read as zero
// (cp.async's src-size operand zero-fills). kVec = true stages with 16-byte
// copies and needs K, N, lda and ldb to be multiples of 4 and A, B 16-byte
// aligned; kVec = false stages with 4-byte copies and takes any shape.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTcThreads = 256;
constexpr int kTcTile = 128;   // output tile edge
constexpr int kTcK = 32;       // depth of one staged k-tile
constexpr int kTcStages = 4;   // slots of the cp.async ring
// Row strides in shared memory: A fragment loads read rows g = 0..7 at
// columns t = 0..3 (bank 4 g + t), B fragment loads rows t at columns g
// (bank 8 t + g); both are 16-byte multiples for the 16-byte copies.
constexpr int kTcLdA = kTcK + 4;
constexpr int kTcLdB = kTcTile + 8;
constexpr int kTcStageFloats = kTcTile * kTcLdA + kTcK * kTcLdB;
constexpr int kTcSmemBytes =
    kTcStages * kTcStageFloats * static_cast<int>(sizeof(float));

// Output tiles of an (M, N) product over S slices: grid x, y and z.
inline dim3 tc_tile_grid(int M, int N, int S) {
  return dim3((N + kTcTile - 1) / kTcTile, (M + kTcTile - 1) / kTcTile, S);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from src to dst; with valid = false nothing is read and
// dst is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small in TF32 bit patterns. big is x rounded to TF32, to
// nearest with ties away from zero as cvt.rna.tf32.f32 rounds, in two
// integer operations (add half a TF32 ulp to the bits, clear the 13 low
// mantissa bits); small is the exact rest x - big with its 13 low bits
// cleared (cut toward zero; a NaN x stays NaN in small).
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// c += a b for one m16n8k8 tile (a: 16 x 8 row-major, b: 8 x 8 col-major
// fragments of TF32 bit patterns).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Issues the copies of the A tile (kTcTile x kTcK at (m0, k0)) into sa and
// of the B tile (kTcK x kTcTile at (k0, n0)) into sb.
template <bool kVec>
__device__ __forceinline__ void tc_stage(const float* A, int lda,
                                         const float* B, int ldb, int M,
                                         int N, int K, int m0, int n0, int k0,
                                         float* sa, float* sb) {
  const int t = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < kTcTile * kTcK / 4 / kTcThreads; ++q) {
      const int e = t + q * kTcThreads;
      const int r = e / (kTcK / 4), c = e % (kTcK / 4) * 4;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < K;
      cp_async16(sa + r * kTcLdA + c,
                 ok ? A + static_cast<int64_t>(gm) * lda + gk : A, ok);
    }
#pragma unroll
    for (int q = 0; q < kTcK * kTcTile / 4 / kTcThreads; ++q) {
      const int e = t + q * kTcThreads;
      const int r = e / (kTcTile / 4), c = e % (kTcTile / 4) * 4;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async16(sb + r * kTcLdB + c,
                 ok ? B + static_cast<int64_t>(gk) * ldb + gn : B, ok);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kTcTile * kTcK / kTcThreads; ++q) {
      const int e = t + q * kTcThreads;
      const int r = e / kTcK, c = e % kTcK;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < M && gk < K;
      cp_async4(sa + r * kTcLdA + c,
                ok ? A + static_cast<int64_t>(gm) * lda + gk : A, ok);
    }
#pragma unroll
    for (int q = 0; q < kTcK * kTcTile / kTcThreads; ++q) {
      const int e = t + q * kTcThreads;
      const int r = e / kTcTile, c = e % kTcTile;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      cp_async4(sb + r * kTcLdB + c,
                ok ? B + static_cast<int64_t>(gk) * ldb + gn : B, ok);
    }
  }
}

// acc = the thread's part of the block's tile (m0, n0) of A B, over the
// whole depth K, in the m16n8 accumulator layout (see tc_for_each). smem
// holds kTcSmemBytes of dynamic shared memory.
template <bool kVec>
__device__ __forceinline__ void tc_tile_mma(const float* A, int lda,
                                            const float* B, int ldb, int M,
                                            int N, int K, int m0, int n0,
                                            float* smem,
                                            float (&acc)[4][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = warp / 4 * 64, wn = warp % 4 * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + kTcK - 1) / kTcK;
  // Prologue: the first kTcStages - 1 k-tiles in flight (one copy group
  // each, empty past the last tile, so the group count stays in step).
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < ktiles) {
      float* sa = smem + s * kTcStageFloats;
      tc_stage<kVec>(A, lda, B, ldb, M, N, K, m0, n0, s * kTcK, sa,
                     sa + kTcTile * kTcLdA);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    // k-tile kt has landed for this thread; the barrier makes it visible
    // to all and retires every warp's reads of the slot refilled below
    // (the one k-tile kt - 1 used).
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    const int next = kt + kTcStages - 1;
    if (next < ktiles) {
      float* sa = smem + next % kTcStages * kTcStageFloats;
      tc_stage<kVec>(A, lda, B, ldb, M, N, K, m0, n0, next * kTcK, sa,
                     sa + kTcTile * kTcLdA);
    }
    cp_async_commit();

    const float* sa = smem + kt % kTcStages * kTcStageFloats;
    const float* sb = sa + kTcTile * kTcLdA;
    float part[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 8) {
      unsigned bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = sb + (kk + tg) * kTcLdB + wn + j * 8 + g;
        split_tf32(p[0], bb[j][0], bs[j][0]);
        split_tf32(p[4 * kTcLdB], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = sa + (wm + i * 16 + g) * kTcLdA + kk + tg;
        unsigned ab[4], as[4];
        split_tf32(p[0], ab[0], as[0]);
        split_tf32(p[8 * kTcLdA], ab[1], as[1]);
        split_tf32(p[4], ab[2], as[2]);
        split_tf32(p[8 * kTcLdA + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(part[i][j], as, bb[j]);
          mma_tf32(part[i][j], ab, bs[j]);
          mma_tf32(part[i][j], ab, bb[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
}

// f(row, col, v) for each of the thread's accumulators, with its global
// row and column: m16n8 tile (i, j) of the warp holds c0, c1 at row
// lane / 4 and c2, c3 eight rows below, at columns 2 (lane % 4) + {0, 1}.
template <class F>
__device__ __forceinline__ void tc_for_each(const float (&acc)[4][4][4],
                                            int m0, int n0, F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + warp / 4 * 64 + lane / 4;
  const int col0 = n0 + warp % 4 * 32 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(row0 + i * 16 + e / 2 * 8, col0 + j * 8 + e % 2, acc[i][j][e]);
}

}  // namespace
