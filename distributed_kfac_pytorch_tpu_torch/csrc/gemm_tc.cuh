// Batched fp32 tile GEMM on the Hopper tensor cores by 3xTF32: the products
// of K4 (ns_inverse.cu) and K3 (bucket_precond.cu); the Gram engine of K1
// and K2 (gram_tc.cuh) uses its primitives (the cp.async copies,
// split_tf32, mma_tf32).
//
// One BM x 128 output tile (BM = 128 or 64 rows) of C = op(A) op(B), with
// op(A) M x K and op(B) K x N, per 256-thread block. The 8 warps sit in a
// 2 x 4 grid, each owning BM/2 x 32 of the tile as BM/32 x 4 tiles of
// mma.sync.m16n8k8 (TF32 in, fp32 out). Operands are staged kTcK = 32 deep
// through a kTcStages-slot cp.async ring in dynamic shared memory
// (kTcSmemBytesOf, above the 48 KB default: the host raises each kernel's
// limit with cudaFuncSetAttribute before launching). The warps load their
// fragments from shared memory themselves, so each operand is staged as it
// lies in memory, in one of four layouts (template flags kTA, kTB):
//   A   row-major, k contiguous:        staged [m][k], rows of kTcLdA;
//   A^T stored K x M, m contiguous:     staged [k][m], rows of BM + 8 (as
//                                       B), fragments read across rows;
//   B   row-major, n contiguous:        staged [k][n], rows of kTcLdB;
//   B^T stored N x K, k contiguous:     staged [n][k], rows of kTcLdA (as
//                                       A; K1's K-major layout).
// Each padding puts the 32 lanes of a fragment load on 32 distinct banks:
// [x][k] rows of 36 floats give bank 4 g + t for lane (g, t), [k][x] rows
// of 8 mod 32 floats give bank 8 t + g; all are 16-byte multiples for the
// 16-byte copies.
//
// 3xTF32: each fp32 operand x splits into a TF32 big part b (x rounded to
// nearest) and a TF32 small part s (the rest x - b, cut to TF32), and a
// product is taken as a_s b_b + a_b b_s + a_b b_b, small terms first,
// accumulated in fp32. The dropped a_s b_s and the cut of the small parts
// lie below 2^-21 of the product, near fp32's own rounding, while one TF32
// product keeps only 2^-11 (the Newton--Schulz residual stalls near 2e-3
// with it). The split costs four integer and float operations per operand
// element, done on the fragments each warp loads (no conversion unit).
// kBf16 = true is the bf16-multiplicand mode: each operand is rounded to
// bf16 as it is loaded, which TF32 holds exactly, and the two small-part
// products are not issued (one TF32 product per product).
//
// Two-level sum: the tensor cores add into their accumulator with
// truncation, so one chain of 3 K / 8 additions would drift away from an
// fp32 sum; every 32-deep k-tile is summed into fresh accumulators, which
// are then added to the running ones by the CUDA cores (round to nearest),
// a chain of K / 32 additions.
//
// Ragged edges: rows, columns and depth past M, N and K read as zero
// (cp.async's src-size operand zero-fills). kVec = true stages with 16-byte
// copies and needs the contiguous extent of each operand (K of A and B^T,
// M of A^T, N of B) and lda, ldb to be multiples of 4 and A, B 16-byte
// aligned; kVec = false stages with 4-byte copies and takes any shape.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTcThreads = 256;
constexpr int kTcTile = 128;   // output tile columns (and K4's rows)
constexpr int kTcK = 32;       // depth of one staged k-tile
constexpr int kTcStages = 4;   // slots of the cp.async ring
// Row strides in shared memory: A fragment loads read rows g = 0..7 at
// columns t = 0..3 (bank 4 g + t), B fragment loads rows t at columns g
// (bank 8 t + g); both are 16-byte multiples for the 16-byte copies.
constexpr int kTcLdA = kTcK + 4;
constexpr int kTcLdB = kTcTile + 8;
// Floats of one ring slot's A and B tiles, by layout.
template <int BM, bool kTA>
constexpr int kTcAFloats = kTA ? kTcK * (BM + 8) : BM * kTcLdA;
template <bool kTB>
constexpr int kTcBFloats = kTB ? kTcTile * kTcLdA : kTcK * kTcLdB;
template <int BM, bool kTA, bool kTB>
constexpr int kTcSmemBytesOf =
    kTcStages * (kTcAFloats<BM, kTA> + kTcBFloats<kTB>) *
    static_cast<int>(sizeof(float));
constexpr int kTcSmemBytes = kTcSmemBytesOf<kTcTile, false, false>;

// Output tiles of an (M, N) product over S slices: grid x, y and z.
inline dim3 tc_tile_grid(int M, int N, int S, int bm = kTcTile) {
  return dim3((N + kTcTile - 1) / kTcTile, (M + bm - 1) / bm, S);
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

// The operand's TF32 parts: 3xTF32's split, or in the bf16 mode x rounded
// to bf16 (to nearest even; exact in TF32) and no small part.
template <bool kBf16>
__device__ __forceinline__ void tc_split(float x, unsigned& big,
                                         unsigned& small) {
  if constexpr (kBf16) {
    big = __float_as_uint(__bfloat162float(__float2bfloat16_rn(x)));
  } else {
    split_tf32(x, big, small);
  }
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

// Issues the copies of the R x C tile at (r0, c0) of a row-major matrix X
// (leading dimension ld; rows past nr and columns past nc read as zero)
// into s[r][c], rows LD floats apart. kRolled keeps the loop of 4-byte
// copies rolled: unrolled, the compiler holds every copy's address and
// predicate in registers, and K3's 64-row tiles (two blocks per SM, 128
// registers) spilled 272-384 bytes. Rolled costs issue slots: K3's
// 128-row tiles, which have the registers, ran 1.4x slower rolled.
template <bool kVec, int R, int C, int LD, bool kRolled = false>
__device__ __forceinline__ void tc_stage_tile(const float* X, int ld, int nr,
                                              int nc, int r0, int c0,
                                              float* s) {
  const int t = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < R * C / 4 / kTcThreads; ++q) {
      const int e = t + q * kTcThreads;
      const int r = e / (C / 4), c = e % (C / 4) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < nr && gc < nc;
      cp_async16(s + r * LD + c,
                 ok ? X + static_cast<int64_t>(gr) * ld + gc : X, ok);
    }
  } else {
    auto copy = [&](int q) {
      const int e = t + q * kTcThreads;
      const int r = e / C, c = e % C;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < nr && gc < nc;
      cp_async4(s + r * LD + c,
                ok ? X + static_cast<int64_t>(gr) * ld + gc : X, ok);
    };
    if constexpr (kRolled) {
#pragma unroll 1
      for (int q = 0; q < R * C / kTcThreads; ++q) copy(q);
    } else {
#pragma unroll
      for (int q = 0; q < R * C / kTcThreads; ++q) copy(q);
    }
  }
}

// Issues the copies of op(A)'s BM x kTcK tile at (m0, k0) into sa and of
// op(B)'s kTcK x kTcTile tile at (k0, n0) into sb, each in its layout.
template <bool kVec, int BM = kTcTile, bool kTA = false, bool kTB = false,
          bool kRolled = false>
__device__ __forceinline__ void tc_stage(const float* A, int lda,
                                         const float* B, int ldb, int M,
                                         int N, int K, int m0, int n0, int k0,
                                         float* sa, float* sb) {
  if constexpr (kTA) {
    tc_stage_tile<kVec, kTcK, BM, BM + 8, kRolled>(A, lda, K, M, k0, m0, sa);
  } else {
    tc_stage_tile<kVec, BM, kTcK, kTcLdA, kRolled>(A, lda, M, K, m0, k0, sa);
  }
  if constexpr (kTB) {
    tc_stage_tile<kVec, kTcTile, kTcK, kTcLdA, kRolled>(B, ldb, N, K, n0, k0,
                                                        sb);
  } else {
    tc_stage_tile<kVec, kTcK, kTcTile, kTcLdB, kRolled>(B, ldb, K, N, k0, n0,
                                                        sb);
  }
}

// acc = the thread's part of the block's tile (m0, n0) of op(A) op(B),
// over the whole depth K, in the m16n8 accumulator layout (see
// tc_for_each). smem holds kTcSmemBytesOf<BM, kTA, kTB> bytes of dynamic
// shared memory. kRolled: see tc_stage_tile.
template <bool kVec, int BM = kTcTile, bool kTA = false, bool kTB = false,
          bool kBf16 = false, bool kRolled = false>
__device__ __forceinline__ void tc_tile_mma(const float* A, int lda,
                                            const float* B, int ldb, int M,
                                            int N, int K, int m0, int n0,
                                            float* smem,
                                            float (&acc)[BM / 32][4][4]) {
  constexpr int TM = BM / 32;  // m16 tiles of a warp
  constexpr int kLdAT = BM + 8;
  constexpr int kAFloats = kTcAFloats<BM, kTA>;
  constexpr int kStage = kAFloats + kTcBFloats<kTB>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = warp / 4 * (BM / 2), wn = warp % 4 * 32;
#pragma unroll
  for (int i = 0; i < TM; ++i)
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
      float* sa = smem + s * kStage;
      tc_stage<kVec, BM, kTA, kTB, kRolled>(A, lda, B, ldb, M, N, K, m0, n0,
                                            s * kTcK, sa, sa + kAFloats);
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
      float* sa = smem + next % kTcStages * kStage;
      tc_stage<kVec, BM, kTA, kTB, kRolled>(A, lda, B, ldb, M, N, K, m0, n0,
                                            next * kTcK, sa, sa + kAFloats);
    }
    cp_async_commit();

    const float* sa = smem + kt % kTcStages * kStage;
    const float* sb = sa + kAFloats;
    float part[TM][4][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 8) {
      unsigned bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kTB) {
          const float* p = sb + (wn + j * 8 + g) * kTcLdA + kk + tg;
          tc_split<kBf16>(p[0], bb[j][0], bs[j][0]);
          tc_split<kBf16>(p[4], bb[j][1], bs[j][1]);
        } else {
          const float* p = sb + (kk + tg) * kTcLdB + wn + j * 8 + g;
          tc_split<kBf16>(p[0], bb[j][0], bs[j][0]);
          tc_split<kBf16>(p[4 * kTcLdB], bb[j][1], bs[j][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        unsigned ab[4], as[4];
        if constexpr (kTA) {
          const float* p = sa + (kk + tg) * kLdAT + wm + i * 16 + g;
          tc_split<kBf16>(p[0], ab[0], as[0]);
          tc_split<kBf16>(p[8], ab[1], as[1]);
          tc_split<kBf16>(p[4 * kLdAT], ab[2], as[2]);
          tc_split<kBf16>(p[4 * kLdAT + 8], ab[3], as[3]);
        } else {
          const float* p = sa + (wm + i * 16 + g) * kTcLdA + kk + tg;
          tc_split<kBf16>(p[0], ab[0], as[0]);
          tc_split<kBf16>(p[8 * kTcLdA], ab[1], as[1]);
          tc_split<kBf16>(p[4], ab[2], as[2]);
          tc_split<kBf16>(p[8 * kTcLdA + 4], ab[3], as[3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (!kBf16) {
            mma_tf32(part[i][j], as, bb[j]);
            mma_tf32(part[i][j], ab, bs[j]);
          }
          mma_tf32(part[i][j], ab, bb[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
}

// f(row, col, v) for each of the thread's accumulators, with its global
// row and column: m16n8 tile (i, j) of the warp holds c0, c1 at row
// lane / 4 and c2, c3 eight rows below, at columns 2 (lane % 4) + {0, 1}.
template <int TM, class F>
__device__ __forceinline__ void tc_for_each(const float (&acc)[TM][4][4],
                                            int m0, int n0, F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + warp / 4 * (16 * TM) + lane / 4;
  const int col0 = n0 + warp % 4 * 32 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(row0 + i * 16 + e / 2 * 8, col0 + j * 8 + e % 2, acc[i][j][e]);
}

}  // namespace
