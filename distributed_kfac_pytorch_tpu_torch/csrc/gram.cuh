// Split-K Gram (X^T X) of an implicitly addressed fp32 matrix on the CUDA
// cores, used by the conv-A patch covariance kernel (patch_cov.cu, K2)
// alone. The factor contraction kernel (factor_ema.cu, K1) runs on the
// tensor cores (gemm_tc.cuh) with its own staging; StridedLoader below, its
// former loader, has no caller left.
//
// The TPU kernels these replace walk the rows sequentially and carry the
// (d, d) accumulator in VMEM from one grid step to the next. Blocks on
// Hopper run in parallel and in no order, so the row walk becomes split-K:
//
//   pass 1 (gram_partial_kernel): block (p, chunk) owns one lower-triangle
//     output tile pair p = (ta >= tb) and one contiguous row chunk. It
//     stages kRowStep rows of both column tiles in shared memory (column
//     major, so each thread reads four rows of a column as one float4),
//     keeps a TM x TM micro-tile of the sum in registers per thread, and
//     prefetches the next row step into registers while it computes. It
//     writes the fp32 partial tile (plus, on diagonal pairs, the column
//     sums) to a workspace. No atomics: the result is deterministic.
//   pass 2 (gram_finalize_kernel): one thread per output element sums the
//     chunk partials in chunk order, scales, assembles the bias row and
//     column, blends with the running factor and writes the dense (n, n)
//     factor.
//
// The Loader decides how (row, column) maps to memory, so the same two
// passes read a strided 2-D view (conv output-grads straight from NCHW,
// dense captures) or an implicit im2col of a 4-D input with padding
// handled by bounds checks (never a padded copy). A thread stages one row
// of each step (kThreads is a multiple of kRowStep), so it decodes that
// row once and reuses it for all its columns.
//
// Symmetry: pair (ta, tb) with ta > tb is computed once and read back
// transposed; a diagonal pair stages one tile and reads it for both
// operands, so entries (u, v) and (v, u) are the same products summed in
// the same row order: the result is exactly symmetric and needs no
// (C + C^T) / 2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kfac {

constexpr int kThreads = 256;      // a 16 x 16 thread grid per block
constexpr int kRowStep = 32;       // rows staged in shared memory per step
constexpr int kStride = kRowStep + 4;  // padded smem column (conflict-free)

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Lower-triangle pair index p -> (ta, tb) with ta >= tb, p = ta(ta+1)/2 + tb.
__device__ __forceinline__ void pair_of(int p, int* ta, int* tb) {
  int a = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while ((a + 1) * (a + 2) / 2 <= p) ++a;
  while (a * (a + 1) / 2 > p) --a;
  *ta = a;
  *tb = p - a * (a + 1) / 2;
}

// Rows r = (b, s), s in [0, inner): element (r, c) at b*sb + s*ss + c*sc.
// A dense (rows, d) matrix is inner = 1; an NCHW conv output-grad read as
// rows (b, h*w) by columns c is inner = H*W, ss = 1, sc = H*W. Offsets are
// 32-bit: the wrapper requires every element offset to fit an int.
struct StridedLoader {
  const float* x;
  int inner;
  int sb, ss, sc;
  int ncols;
  struct Col {
    int off;  // c * sc; -1 past the last column (reads as zero)
  };
  struct Row {
    int off;
  };
  __device__ Col col(int c) const { return Col{c < ncols ? c * sc : -1}; }
  __device__ Row row(int r) const {
    const int b = r / inner;
    return Row{b * sb + (r - b * inner) * ss};
  }
  __device__ float load(const Row& rw, const Col& k) const {
    return k.off >= 0 ? __ldg(x + (rw.off + k.off)) : 0.f;
  }
};

// Implicit im2col of a 4-D (B, C, H, W) input addressed by its element
// strides (NCHW-contiguous or channels-last alike): row r = (b, oh, ow),
// feature f = (c, ki, kj) with kj fastest -- torch's (Cout, Cin, KH, KW)
// weight flattening order. Out-of-image taps (padding) read as zero. A
// row carries its top-left tap (h0, w0) and base offset, a column its tap
// shift (dh, dw), packed in one int, and offset, so a load is two adds,
// two unsigned bound checks and one add for the address (32-bit offsets,
// as above). A column past the last one gets a tap shift that is always
// out of the image.
struct PatchLoader {
  const float* x;
  int C, H, W, KH, KW, SH, SW, PH, PW, OH, OW;
  int sb, sc, sh, sw;  // element strides of the b, c, h, w axes
  int ncols;           // C * KH * KW
  struct Col {
    int off;             // c*sc + dh*sh + dw*sw
    int dhw;             // dh << 16 | (dw & 0xffff)
  };
  struct Row {
    int off;             // b*sb + h0*sh + w0*sw
    int h0, w0;
  };
  __device__ Col col(int f) const {
    if (f >= ncols) return Col{0, -(1 << 30)};
    const int kj = f % KW;
    const int t = f / KW;
    const int ki = t % KH;
    const int c = t / KH;
    const int dh = ki - PH, dw = kj - PW;
    return Col{c * sc + dh * sh + dw * sw,
               static_cast<int>((static_cast<unsigned>(dh) << 16) |
                                (static_cast<unsigned>(dw) & 0xffffu))};
  }
  __device__ Row row(int r) const {
    const int ow = r % OW;
    const int t = r / OW;
    const int oh = t % OH;
    const int b = t / OH;
    const int h0 = oh * SH, w0 = ow * SW;
    return Row{b * sb + h0 * sh + w0 * sw, h0, w0};
  }
  __device__ float load(const Row& rw, const Col& k) const {
    const unsigned h = static_cast<unsigned>(rw.h0 + (k.dhw >> 16));
    const unsigned w =
        static_cast<unsigned>(rw.w0 + static_cast<short>(k.dhw & 0xffff));
    if (h >= static_cast<unsigned>(H) || w >= static_cast<unsigned>(W))
      return 0.f;
    return __ldg(x + (rw.off + k.off));
  }
};

// Thread (tx, ty) owns output rows ty + 16*i and columns tx + 16*j of its
// TD x TD tile (TD = 16*TM). Staging: thread t stages row k = t % kRowStep
// of columns t / kRowStep + kColStep * q.
// Two blocks per SM: the register cap keeps 16 warps resident to hide
// the gather latency (without it the 64-wide im2col kernel took 176
// registers, one block per SM).
template <int TM, class Loader>
__global__ void __launch_bounds__(kThreads, 2)
gram_partial_kernel(Loader ld, int rows, int rows_per_chunk, int mult_bf16,
                    float* __restrict__ ws, float* __restrict__ ws_colsum,
                    int ncols_pad) {
  constexpr int TD = 16 * TM;
  constexpr int kColStep = kThreads / kRowStep;
  constexpr int kLoads = TD / kColStep;
  __shared__ __align__(16) float sa[TD][kStride];
  __shared__ __align__(16) float sb[TD][kStride];

  const int p = blockIdx.x;
  const int chunk = blockIdx.y;
  const int npairs = gridDim.x;
  int ta, tb;
  pair_of(p, &ta, &tb);
  const bool diag = ta == tb;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int kk = t % kRowStep;
  const int c0 = t / kRowStep;

  // Column descriptors of both tiles, decoded once per block and read
  // back as warp broadcasts (a warp stages one column at a time).
  __shared__ typename Loader::Col scol[2][TD];
  if (t < TD) {
    scol[0][t] = ld.col(ta * TD + t);
    scol[1][t] = ld.col(tb * TD + t);
  }
  __syncthreads();

  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float va[kLoads], vb[kLoads];
  auto fetch = [&](int rb) {
    const int r = rb + kk;
    const bool ok = r < r1;
    const typename Loader::Row rw = ld.row(ok ? r : r0);
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int c = c0 + kColStep * q;
      float a = ok ? ld.load(rw, scol[0][c]) : 0.f;
      float b = (ok && !diag) ? ld.load(rw, scol[1][c]) : 0.f;
      if (mult_bf16) {
        a = round_bf16(a);
        b = round_bf16(b);
      }
      va[q] = a;
      vb[q] = b;
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
  // Diagonal pairs also sum their columns: per lane over its rows here,
  // across the warp (one warp = one column group) at the end.
  float cs[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) cs[q] = 0.f;
  const float(*B)[kStride] = diag ? sa : sb;

  if (r0 < r1) fetch(r0);
  for (int rb = r0; rb < r1; rb += kRowStep) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      sa[c0 + kColStep * q][kk] = va[q];
      if (diag)
        cs[q] += va[q];
      else
        sb[c0 + kColStep * q][kk] = vb[q];
    }
    __syncthreads();
    if (rb + kRowStep < r1) fetch(rb + kRowStep);
#pragma unroll
    for (int k = 0; k < kRowStep; k += 4) {
      float4 a4[TM], b4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a4[i] = *reinterpret_cast<const float4*>(&sa[ty + 16 * i][k]);
#pragma unroll
      for (int j = 0; j < TM; ++j)
        b4[j] = *reinterpret_cast<const float4*>(&B[tx + 16 * j][k]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          acc[i][j] = fmaf(a4[i].x, b4[j].x, acc[i][j]);
          acc[i][j] = fmaf(a4[i].y, b4[j].y, acc[i][j]);
          acc[i][j] = fmaf(a4[i].z, b4[j].z, acc[i][j]);
          acc[i][j] = fmaf(a4[i].w, b4[j].w, acc[i][j]);
        }
    }
    __syncthreads();
  }

  float* out = ws + (static_cast<int64_t>(chunk) * npairs + p) * TD * TD;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j)
      out[(ty + 16 * i) * TD + tx + 16 * j] = acc[i][j];
  if (diag) {
    static_assert(kRowStep == 32, "one warp must stage one column group");
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      float v = cs[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (kk == 0)
        ws_colsum[static_cast<int64_t>(chunk) * ncols_pad + ta * TD + c0 +
                  kColStep * q] = v;
    }
  }
}

// out[i, j] = decay * old[i, j] + (1 - decay) * F[i, j]  (old may be null:
// contraction only), where F is the scaled Gram with, when has_bias, the
// bias row/column at index d_in (column sums times bias_scale) and
// `corner` at (d_in, d_in).
__global__ void gram_finalize_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ ws_colsum,
                                     int chunks, int npairs, int tile,
                                     int ncols_pad, int d_in, int n,
                                     float inv_scale, float bias_scale,
                                     float corner,
                                     const float* __restrict__ old,
                                     float decay, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * n) return;
  const int i = idx / n;
  const int j = idx - i * n;
  float f;
  if (i < d_in && j < d_in) {
    int ti = i / tile, tj = j / tile, u = i % tile, v = j % tile;
    if (ti < tj) {
      int s = ti; ti = tj; tj = s;
      s = u; u = v; v = s;
    }
    const int p = ti * (ti + 1) / 2 + tj;
    const int64_t step = static_cast<int64_t>(npairs) * tile * tile;
    const float* src = ws + static_cast<int64_t>(p) * tile * tile +
                       u * tile + v;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += src[c * step];
    f = s * inv_scale;
  } else if (i == d_in && j == d_in) {
    f = corner;
  } else {
    const int k = i == d_in ? j : i;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c)
      s += ws_colsum[static_cast<int64_t>(c) * ncols_pad + k];
    f = s * bias_scale;
  }
  out[idx] = old ? decay * old[idx] + (1.f - decay) * f : f;
}

template <class Loader>
cudaError_t launch_gram(const Loader& ld, int rows, int tile, int chunks,
                        int rows_per_chunk, int mult_bf16, float* ws,
                        float* ws_colsum, int d_in, int n, float inv_scale,
                        float bias_scale, float corner, const float* old,
                        float decay, float* out, cudaStream_t stream) {
  const int ntiles = (d_in + tile - 1) / tile;
  const int npairs = ntiles * (ntiles + 1) / 2;
  const int ncols_pad = ntiles * tile;
  const dim3 grid(npairs, chunks);
  switch (tile) {
    case 16:
      gram_partial_kernel<1, Loader><<<grid, kThreads, 0, stream>>>(
          ld, rows, rows_per_chunk, mult_bf16, ws, ws_colsum, ncols_pad);
      break;
    case 32:
      gram_partial_kernel<2, Loader><<<grid, kThreads, 0, stream>>>(
          ld, rows, rows_per_chunk, mult_bf16, ws, ws_colsum, ncols_pad);
      break;
    case 64:
      gram_partial_kernel<4, Loader><<<grid, kThreads, 0, stream>>>(
          ld, rows, rows_per_chunk, mult_bf16, ws, ws_colsum, ncols_pad);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = n * n;
  gram_finalize_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      ws, ws_colsum, chunks, npairs, tile, ncols_pad, d_in, n, inv_scale,
      bias_scale, corner, old, decay, out);
  return cudaGetLastError();
}

}  // namespace kfac
