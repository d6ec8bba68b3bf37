// The split-K Gram engine of K1 (factor_ema.cu) and K2 (patch_cov.cu) on the
// Hopper tensor cores: G = X^T X over the rows of an implicitly addressed
// fp32 matrix X, 3xTF32 (gemm_tc.cuh: split_tf32, mma_tf32, the cp.async
// ring), with the bias column sums, in two passes. The two kernels differ
// only in how a k-tile of X is staged, a policy class passed to the
// engine (its `__global__` entries stay in each kernel's source, under
// each kernel's own names).
//
// Pass 1 (gram_partial<TM>): block (p, chunk) owns one lower-triangle pair
//   p = (ta >= tb) of T x T output tiles (T = 32 TM: 32, 64 or 128) and one
//   row chunk (a multiple of 32 rows). Both operands are X^T tiles staged
//   K-major, [feature][32 rows] with a padded row (kLd = 36: the mma.sync
//   row.col fragments of A and of B touch 32 distinct banks), through a
//   kTcStages-slot cp.async ring. A diagonal pair stages one tile and reads
//   it for both operands. Every 32-deep k-tile is summed into fresh
//   accumulators and added to the running ones by the CUDA cores (K
//   reaches 802,816 rows: one truncating tensor-core chain would drift).
//   Diagonal pairs of a factor with a bias also sum the staged columns from
//   shared memory, in a fixed order. The partial tile (and column sums) go
//   to a workspace: no atomics.
//   The staging policy `Stage` has two members, templated on TM:
//     prepare<TM>(fa, fb): once per block, before the first copy (the
//       first feature of tile A and of tile B);
//     stage<TM>(which, f0, k0, r1, s): issue the cp.async copies of the
//       k-tile of rows k0 .. k0 + 31 (rows at or past r1, and features
//       past the last, read as zero) of features f0 .. f0 + T - 1 into
//       s[f][k]; `which` is 0 for tile A, 1 for tile B.
//   RowStage<kPath> below is K1's policy (rows of a strided 2-D view);
//   K2 adds the implicit im2col (patch_cov.cu) and takes RowStage for 1 x 1
//   stride-1 unpadded convs, whose patch matrix is the input itself.
// Pass 2 (gram_finalize): one 32 x 32 block of the (n, n) output per
//   lower-triangle block pair, one thread per entry; it sums the chunk
//   partials of the lower entries in chunk order (coalesced), scales, adds
//   the bias row and corner, and writes the block and its mirror image
//   (through shared memory, both coalesced), each blended with `old` in
//   fp32 (an `old` stored in bf16 is widened on the load and the result
//   rounded to bf16 on the store).
//   Entry (v, u) is written from (u, v), so the result is exactly
//   symmetric and repeatable bit for bit.

#pragma once

#include <cuda_bf16.h>

#include "gemm_tc.cuh"

namespace {

constexpr int kLd = kTcK + 4;        // padded K-major row in shared memory
constexpr int kKMajor16 = 0, kKMajor4 = 1, kFeature4 = 2;

struct Src {
  const float* x;
  int rows, d_in, inner, sb, ss, sc;
  // Element offset of row r (32-bit: the host checks the span).
  __device__ __forceinline__ int row_off(int r) const {
    if (inner == 1) return r * sb;
    const int b = r / inner;
    return b * sb + (r - b * inner) * ss;
  }
};

// Lower-triangle pair index p -> (ta, tb), p = ta (ta + 1) / 2 + tb.
__device__ __forceinline__ void pair_of(int p, int& ta, int& tb) {
  int a = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while ((a + 1) * (a + 2) / 2 <= p) ++a;
  while (a * (a + 1) / 2 > p) --a;
  ta = a;
  tb = p - a * (a + 1) / 2;
}

// Issues the copies of one operand's k-tile: features f0 .. f0 + T - 1,
// rows k0 .. k0 + 31 (rows at or past r1 read as zero), into s[f][k].
// X is (rows, d_in), read in place through strides: row r = (b, s) with
// s in [0, inner) at b*sb + s*ss, feature c at c*sc. Staging paths, all
// straight from the caller's strides, ragged rows and features zero-filled
// by cp.async's src-size:
//   kKMajor16: rows unit-stride (NCHW conv G), groups of 4 rows never
//     cross an image and are 16-byte aligned: 16-byte copies;
//   kKMajor4: rows unit-stride otherwise (7 x 7 grads, inner 49): one
//     4-byte copy per element, a warp on 32 consecutive rows;
//   kFeature4: features unit-stride (dense row-major, channels-last):
//     one 4-byte copy per element, a warp on consecutive features.
template <int TM, int kPath>
__device__ __forceinline__ void stage_operand(const Src& src, int f0, int k0,
                                              int r1, float* s) {
  constexpr int T = 32 * TM;
  const int t = threadIdx.x;
  if constexpr (kPath == kKMajor16) {
    // Thread: row group t % 8 (4 rows), features t / 8 + 32 q.
    const int k = (t % 8) * 4;
    const int r = k0 + k;
    const int nvalid = min(4, r1 - r);
    const int roff = nvalid > 0 ? src.row_off(r) : 0;
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int c = t / 8 + 32 * q;
      const int f = f0 + c;
      const bool ok = nvalid > 0 && f < src.d_in;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(s + c * kLd + k)),
                   "l"(ok ? src.x + (roff + f * src.sc) : src.x),
                   "r"(ok ? 4 * nvalid : 0));
    }
  } else if constexpr (kPath == kKMajor4) {
    // Thread: row t % 32, features t / 32 + 8 q.
    const int k = t % 32;
    const int r = k0 + k;
    const bool rok = r < r1;
    const int roff = rok ? src.row_off(r) : 0;
    const int c0 = t / 32;
#pragma unroll
    for (int q = 0; q < 4 * TM; ++q) {
      const int c = c0 + 8 * q;
      const int f = f0 + c;
      const bool ok = rok && f < src.d_in;
      cp_async4(s + c * kLd + k, ok ? src.x + (roff + f * src.sc) : src.x,
                ok);
    }
  } else {
    // Thread: feature t % T, rows t / T + (256 / T) q.
    const int c = t % T;
    const int f = f0 + c;
    const bool fok = f < src.d_in;
    const int foff = fok ? f * src.sc : 0;
#pragma unroll
    for (int q = 0; q < 4 * TM; ++q) {
      const int k = t / T + (kTcThreads / T) * q;
      const int r = k0 + k;
      const bool ok = fok && r < r1;
      cp_async4(s + c * kLd + k,
                ok ? src.x + (src.row_off(r) + foff) : src.x, ok);
    }
  }
}

// The staging policy of rows of a strided 2-D view (K1's three paths).
template <int kPath>
struct RowStage {
  Src src;
  template <int TM>
  __device__ __forceinline__ void prepare(int, int) const {}
  template <int TM>
  __device__ __forceinline__ void stage(int, int f0, int k0, int r1,
                                        float* s) const {
    stage_operand<TM, kPath>(src, f0, k0, r1, s);
  }
};

// 147, 74 and 37 KB of shared memory at T = 128, 64, 32: one block per
// SM at T = 128, two at T = 64, four at T = 32 with the register cap of
// each kernel's __launch_bounds__ (ops/kernels.py's _K1_BLOCKS_PER_SM
// plans waves with it).
template <int TM>
constexpr int kSmemBytes =
    kTcStages * 2 * 32 * TM * kLd * static_cast<int>(sizeof(float));

// Pass 1 of the Gram over `rows` rows, staged by `st` (see the top).
template <int TM, class Stage>
__device__ __forceinline__ void gram_partial(const Stage& st, int rows,
                                             int rows_per_chunk,
                                             int mult_bf16, int has_bias,
                                             float* __restrict__ ws,
                                             float* __restrict__ ws_colsum,
                                             int ncols_pad) {
  constexpr int T = 32 * TM;
  constexpr int kStage = 2 * T * kLd;  // floats per ring slot (A, B)
  extern __shared__ __align__(16) float smem[];

  const int p = blockIdx.x, chunk = blockIdx.y, npairs = gridDim.x;
  int ta, tb;
  pair_of(p, ta, tb);
  const bool diag = ta == tb;
  const bool colsum = diag && has_bias;
  const int fa = ta * T, fb = tb * T;
  st.template prepare<TM>(fa, fb);
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  const int ktiles = (r1 - r0 + kTcK - 1) / kTcK;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = warp / 4 * 16 * TM, wn = warp % 4 * 8 * TM;

  auto stage = [&](int kt) {
    float* sa = smem + kt % kTcStages * kStage;
    st.template stage<TM>(0, fa, r0 + kt * kTcK, r1, sa);
    if (!diag) st.template stage<TM>(1, fb, r0 + kt * kTcK, r1,
                                     sa + T * kLd);
  };

  float acc[TM][TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float cs = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < ktiles) stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    // k-tile kt has landed; the barrier also retires all reads of the slot
    // refilled below (the one k-tile kt - 1 used).
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    if (kt + kTcStages - 1 < ktiles) stage(kt + kTcStages - 1);
    cp_async_commit();

    float* sa = smem + kt % kTcStages * kStage;
    const float* sb = diag ? sa : sa + T * kLd;
    if (mult_bf16) {
      // Round the landed k-tile to bf16 in place, as the plain version
      // rounds its input; the 3xTF32 small parts are then zero.
      for (int e = t; e < (diag ? T : 2 * T) * kTcK; e += kTcThreads) {
        float* v = sa + e / kTcK * kLd + e % kTcK;
        *v = __bfloat162float(__float2bfloat16_rn(*v));
      }
      __syncthreads();
    }
    if (colsum && t < T) {
      // Feature t's staged rows, rotated so a warp reads 32 banks.
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kTcK; ++k)
        sum += sa[t * kLd + ((k + t) & (kTcK - 1))];
      cs += sum;
    }

    float part[TM][TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 8) {
      unsigned bb[TM][2], bs[TM][2];
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float* q = sb + (wn + j * 8 + g) * kLd + kk + tg;
        split_tf32(q[0], bb[j][0], bs[j][0]);
        split_tf32(q[4], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float* q = sa + (wm + i * 16 + g) * kLd + kk + tg;
        unsigned ab[4], as[4];
        split_tf32(q[0], ab[0], as[0]);
        split_tf32(q[8 * kLd], ab[1], as[1]);
        split_tf32(q[4], ab[2], as[2]);
        split_tf32(q[8 * kLd + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          mma_tf32(part[i][j], as, bb[j]);
          mma_tf32(part[i][j], ab, bs[j]);
          mma_tf32(part[i][j], ab, bb[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  float* out = ws + (static_cast<int64_t>(chunk) * npairs + p) * T * T;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int u = wm + i * 16 + g, v = wn + j * 8 + 2 * tg;
      *reinterpret_cast<float2*>(out + u * T + v) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out + (u + 8) * T + v) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  if (colsum && t < T)
    ws_colsum[static_cast<int64_t>(chunk) * ncols_pad + fa + t] = cs;
}

constexpr int kFin = 32;  // finalize block edge, one thread per entry

// v[0] + v[step] + ... over `chunks` terms, added in chunk order; the
// loads of 16 chunks are issued before their adds.
__device__ __forceinline__ float chunk_sum(const float* __restrict__ v,
                                           int64_t step, int chunks) {
  float s = 0.f;
  int c = 0;
  for (; c + 16 <= chunks; c += 16) {
    float w[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) w[u] = v[(c + u) * step];
#pragma unroll
    for (int u = 0; u < 16; ++u) s += w[u];
  }
  for (; c < chunks; ++c) s += v[c * step];
  return s;
}

// The running factor's storage: fp32, or bf16 (K1 under bf16 factor
// storage) read widened and written rounded to nearest even, so the blend
// itself is the fp32 one in both.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void blend(T* __restrict__ out,
                                      const T* __restrict__ old,
                                      float decay, int n, int i, int j,
                                      float f) {
  if (i >= n || j >= n) return;
  const int64_t idx = static_cast<int64_t>(i) * n + j;
  put(out + idx, old ? decay * widen(old[idx]) + (1.f - decay) * f : f);
}

// Pass 2: one kFin x kFin block (bi >= bj) of the output and its mirror
// image, launched as kFin x kFin threads. Threads compute the block's
// lower entries (i >= j; coalesced reads of the workspace) and write the
// upper ones from shared memory. `old` may be null (no EMA). T is the
// storage type of `old` and `out` (float, or __nv_bfloat16 under bf16
// factor storage).
template <typename T>
__device__ __forceinline__ void gram_finalize(
    const float* __restrict__ ws, const float* __restrict__ ws_colsum,
    int chunks, int npairs, int tile, int ncols_pad, int d_in, int n,
    float inv_scale, float bias_scale, float corner,
    const T* __restrict__ old, float decay, T* __restrict__ out) {
  __shared__ float blk[kFin][kFin + 1];
  int bi, bj;
  pair_of(blockIdx.x, bi, bj);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = bi * kFin + ty, j = bj * kFin + tx;
  float f = 0.f;
  if (i < n && (bi > bj || ty >= tx)) {
    if (i < d_in) {
      const int ti = i / tile, tj = j / tile;
      f = inv_scale *
          chunk_sum(ws + static_cast<int64_t>(ti * (ti + 1) / 2 + tj) *
                             tile * tile +
                        (i - ti * tile) * tile + (j - tj * tile),
                    static_cast<int64_t>(npairs) * tile * tile, chunks);
    } else if (j == d_in) {
      f = corner;
    } else {
      f = bias_scale * chunk_sum(ws_colsum + j, ncols_pad, chunks);
    }
  }
  blk[ty][tx] = f;
  __syncthreads();
  if (bi == bj) {
    blend(out, old, decay, n, i, j, ty >= tx ? f : blk[tx][ty]);
  } else {
    blend(out, old, decay, n, i, j, f);
    blend(out, old, decay, n, bj * kFin + ty, bi * kFin + tx, blk[tx][ty]);
  }
}

}  // namespace
