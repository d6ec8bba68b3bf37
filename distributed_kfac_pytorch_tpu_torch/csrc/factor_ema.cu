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
// The two passes are the Gram engine of gram_tc.cuh, shared with K2:
// factor_partial_kernel<TM, kPath> (pass 1) stages X^T tiles K-major
// through RowStage<kPath> (kKMajor16, kKMajor4 or kFeature4, picked by the
// host), and factor_finalize_kernel (pass 2) sums the split-K chunks in a
// fixed order, adds the bias row and corner, blends with `old` and writes
// each upper entry from its lower one (exactly symmetric, repeatable bit
// for bit). Under bf16 factor storage `old` and `out` are bf16: the blend
// reads `old` widened, blends in fp32 and rounds once to nearest even on
// the store, so the running factor makes one trip through memory at 2
// bytes an entry and equals the fp32 blend rounded, bit for bit.

#include "gram_tc.cuh"

namespace {

template <int TM, int kPath>
__global__ void __launch_bounds__(kTcThreads, TM == 4 ? 1 : TM == 2 ? 2 : 4)
factor_partial_kernel(Src src, int rows_per_chunk, int mult_bf16,
                      int has_bias, float* __restrict__ ws,
                      float* __restrict__ ws_colsum, int ncols_pad) {
  gram_partial<TM>(RowStage<kPath>{src}, src.rows, rows_per_chunk,
                   mult_bf16, has_bias, ws, ws_colsum, ncols_pad);
}

template <typename T>
__global__ void __launch_bounds__(kFin * kFin)
factor_finalize_kernel(const float* __restrict__ ws,
                       const float* __restrict__ ws_colsum, int chunks,
                       int npairs, int tile, int ncols_pad, int d_in, int n,
                       float inv_scale, float bias_scale, float corner,
                       const T* __restrict__ old, float decay,
                       T* __restrict__ out) {
  gram_finalize<T>(ws, ws_colsum, chunks, npairs, tile, ncols_pad, d_in, n,
                   inv_scale, bias_scale, corner, old, decay, out);
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
// `old` and `out` are fp32, or bf16 with storage_bf16 (bf16 factor storage:
// the blend reads `old` widened and writes `out` rounded, in one pass).
extern "C" int kfac_factor_ema(const float* x, int rows, int d_in, int inner,
                               int sb, int ss, int sc, int mult_bf16,
                               int tile, int path, int chunks,
                               int rows_per_chunk, float* ws,
                               const void* old, float decay,
                               float inv_scale, int has_bias,
                               float bias_scale, float corner, void* out,
                               int storage_bf16, void* stream) {
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
  const dim3 grid(nb * (nb + 1) / 2), block(kFin, kFin);
  if (storage_bf16)
    factor_finalize_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        ws, ws_colsum, chunks, npairs, tile, ncols_pad, d_in, n, inv_scale,
        bias_scale, corner, static_cast<const __nv_bfloat16*>(old), decay,
        static_cast<__nv_bfloat16*>(out));
  else
    factor_finalize_kernel<float><<<grid, block, 0, st>>>(
        ws, ws_colsum, chunks, npairs, tile, ncols_pad, d_in, n, inv_scale,
        bias_scale, corner, static_cast<const float*>(old), decay,
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
