// K1: factor contraction + EMA (replaces the Pallas `_factor_ema_kernel`,
// distributed_kfac_pytorch_tpu/ops/pallas_kernels.py:593, driven by
// `_pallas_factor_ema` (:661) and `fused_factor_ema` (:696)).
//
// out = decay * old + (1 - decay) * [[X^T X / scale, b], [b^T, corner]]
// with b = colsum(X) / rows when has_bias (old null: contraction only).
// X is (rows, d_in), read in place through strides: row r = (b, s) with
// s in [0, inner) at b*sb + s*ss, feature c at c*sc. A dense matrix has
// inner = 1 (row stride sb); an NCHW conv output-grad is inner = H*W,
// ss = 1, sc = H*W. The host (ops/kernels.py, factor_ema_plan) collapses
// the row axes where it can and picks the staging path and split.
//
// Bound on the H100: bytes at ResNet-32 widths (conv G reads up to
// (131072, 16) fp32 rows for a 16 x 16 output), operations at ResNet-50's
// d >= 128 (rows d (d + 1) FLOPs, ~13 GFLOP per heavy conv G launch, about
// 300 FLOPs per byte read). The products therefore run on the tensor
// cores by 3xTF32 (gemm_tc.cuh: split_tf32, mma_tf32, the cp.async ring
// and the two-level sum), three TF32 products per fp32 product, read
// against the dense TF32 rate of 494.7 TFLOP/s.
//
// Pass 1 (factor_partial_kernel<TM, kPath>): block (p, chunk) owns one
//   lower-triangle pair p = (ta >= tb) of T x T output tiles (T = 32 TM:
//   32, 64 or 128 by d) and one row chunk (a multiple of 32 rows). Both
//   operands are X^T tiles staged K-major, [feature][32 rows] with a
//   padded row (kLd = 36: the mma.sync row.col fragments of A and of B
//   touch 32 distinct banks), through a kTcStages-slot cp.async ring. A
//   diagonal pair stages one tile and reads it for both operands. Every
//   32-deep k-tile is summed into fresh accumulators and added to the
//   running ones by the CUDA cores (K reaches 200,704 rows: one truncating
//   tensor-core chain would drift). Diagonal pairs of a factor with a bias
//   also sum the staged columns from shared memory, in a fixed order. The
//   partial tile (and column sums) go to a workspace: no atomics.
//   Staging paths (kPath), all straight from the caller's strides, ragged
//   rows and features zero-filled by cp.async's src-size:
//     kKMajor16: rows unit-stride (NCHW conv G), groups of 4 rows never
//       cross an image and are 16-byte aligned: 16-byte copies;
//     kKMajor4: rows unit-stride otherwise (7 x 7 grads, inner 49): one
//       4-byte copy per element, a warp on 32 consecutive rows;
//     kFeature4: features unit-stride (dense row-major, channels-last):
//       one 4-byte copy per element, a warp on consecutive features.
// Pass 2 (factor_finalize_kernel): one 32 x 32 block of the (n, n) output
//   per lower-triangle block pair, one thread per entry; it sums the chunk
//   partials of the lower entries in chunk order (coalesced), scales, adds the bias row and corner, and
//   writes the block and its mirror image (through shared memory, both
//   coalesced), each blended with `old`. Entry (v, u) is written from
//   (u, v), so the result is exactly symmetric and repeatable bit for bit.

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

// 147, 74 and 37 KB of shared memory at T = 128, 64, 32.
template <int TM>
constexpr int kSmemBytes =
    kTcStages * 2 * 32 * TM * kLd * static_cast<int>(sizeof(float));

// One block per SM at T = 128, two at T = 64, four at T = 32 (shared
// memory and the register cap; ops/kernels.py's _K1_BLOCKS_PER_SM plans
// waves with it).
template <int TM, int kPath>
__global__ void __launch_bounds__(kTcThreads, TM == 4 ? 1 : TM == 2 ? 2 : 4)
factor_partial_kernel(Src src, int rows_per_chunk, int mult_bf16,
                      int has_bias, float* __restrict__ ws,
                      float* __restrict__ ws_colsum, int ncols_pad) {
  constexpr int T = 32 * TM;
  constexpr int kStage = 2 * T * kLd;  // floats per ring slot (A, B)
  extern __shared__ __align__(16) float smem[];

  const int p = blockIdx.x, chunk = blockIdx.y, npairs = gridDim.x;
  int ta, tb;
  pair_of(p, ta, tb);
  const bool diag = ta == tb;
  const bool colsum = diag && has_bias;
  const int fa = ta * T, fb = tb * T;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(src.rows, r0 + rows_per_chunk);
  const int ktiles = (r1 - r0 + kTcK - 1) / kTcK;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = warp / 4 * 16 * TM, wn = warp % 4 * 8 * TM;

  auto stage = [&](int kt) {
    float* sa = smem + kt % kTcStages * kStage;
    stage_operand<TM, kPath>(src, fa, r0 + kt * kTcK, r1, sa);
    if (!diag) stage_operand<TM, kPath>(src, fb, r0 + kt * kTcK, r1,
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

__device__ __forceinline__ void blend(float* __restrict__ out,
                                      const float* __restrict__ old,
                                      float decay, int n, int i, int j,
                                      float f) {
  if (i >= n || j >= n) return;
  const int64_t idx = static_cast<int64_t>(i) * n + j;
  out[idx] = old ? decay * old[idx] + (1.f - decay) * f : f;
}

// One kFin x kFin block (bi >= bj) of the output and its mirror image.
// Threads compute the block's lower entries (i >= j; coalesced reads of
// the workspace) and write the upper ones from shared memory.
__global__ void __launch_bounds__(kFin * kFin)
factor_finalize_kernel(const float* __restrict__ ws,
                       const float* __restrict__ ws_colsum, int chunks,
                       int npairs, int tile, int ncols_pad, int d_in, int n,
                       float inv_scale, float bias_scale, float corner,
                       const float* __restrict__ old, float decay,
                       float* __restrict__ out) {
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

template <int TM, int kPath>
cudaError_t launch_partial(const Src& src, int npairs, int chunks,
                           int rows_per_chunk, int mult_bf16, int has_bias,
                           float* ws, float* ws_colsum, int ncols_pad,
                           cudaStream_t stream) {
  auto kernel = factor_partial_kernel<TM, kPath>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<TM>);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(npairs, chunks), kTcThreads, kSmemBytes<TM>, stream>>>(
      src, rows_per_chunk, mult_bf16, has_bias, ws, ws_colsum, ncols_pad);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_tile(int path, const Src& src, int npairs, int chunks,
                        int rows_per_chunk, int mult_bf16, int has_bias,
                        float* ws, float* ws_colsum, int ncols_pad,
                        cudaStream_t stream) {
  switch (path) {
    case kKMajor16:
      return launch_partial<TM, kKMajor16>(src, npairs, chunks,
                                           rows_per_chunk, mult_bf16,
                                           has_bias, ws, ws_colsum,
                                           ncols_pad, stream);
    case kKMajor4:
      return launch_partial<TM, kKMajor4>(src, npairs, chunks,
                                          rows_per_chunk, mult_bf16, has_bias,
                                          ws, ws_colsum, ncols_pad, stream);
    case kFeature4:
      return launch_partial<TM, kFeature4>(src, npairs, chunks,
                                           rows_per_chunk, mult_bf16,
                                           has_bias, ws, ws_colsum,
                                           ncols_pad, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ws holds chunks x npairs x tile^2 partial floats followed, with has_bias,
// by chunks x ncols_pad column sums (ncols_pad = ceil(d_in / tile) tile).
extern "C" int kfac_factor_ema(const float* x, int rows, int d_in, int inner,
                               int sb, int ss, int sc, int mult_bf16,
                               int tile, int path, int chunks,
                               int rows_per_chunk, float* ws,
                               const float* old, float decay,
                               float inv_scale, int has_bias,
                               float bias_scale, float corner, float* out,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Src src{x, rows, d_in, inner, sb, ss, sc};
  const int ntiles = (d_in + tile - 1) / tile;
  const int npairs = ntiles * (ntiles + 1) / 2;
  const int ncols_pad = ntiles * tile;
  float* ws_colsum = ws + static_cast<int64_t>(chunks) * npairs * tile * tile;
  cudaError_t err;
  switch (tile) {
    case 32:
      err = launch_tile<1>(path, src, npairs, chunks, rows_per_chunk,
                           mult_bf16, has_bias, ws, ws_colsum, ncols_pad, st);
      break;
    case 64:
      err = launch_tile<2>(path, src, npairs, chunks, rows_per_chunk,
                           mult_bf16, has_bias, ws, ws_colsum, ncols_pad, st);
      break;
    case 128:
      err = launch_tile<4>(path, src, npairs, chunks, rows_per_chunk,
                           mult_bf16, has_bias, ws, ws_colsum, ncols_pad, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = d_in + (has_bias ? 1 : 0);
  const int nb = (n + kFin - 1) / kFin;
  factor_finalize_kernel<<<nb * (nb + 1) / 2, dim3(kFin, kFin), 0, st>>>(
      ws, ws_colsum, chunks, npairs, tile, ncols_pad, d_in, n, inv_scale,
      bias_scale, corner, old, decay, out);
  return static_cast<int>(cudaGetLastError());
}
