// K1: factor contraction + EMA (replaces the Pallas `_factor_ema_kernel`,
// distributed_kfac_pytorch_tpu/ops/pallas_kernels.py, driven by
// `_pallas_factor_ema` / `fused_factor_ema`).
//
// out = decay * old + (1 - decay) * [[X^T X / scale, b], [b^T, corner]]
// with b = colsum(X) / rows when has_bias (old null: contraction only).
//
// Bound on the H100: bytes. ResNet-32's conv G reads (131072, 16) fp32
// rows for a 16 x 16 output -- 16 FMAs per loaded value at best. The
// design reads X once, straight from the layer's NCHW output-grad through
// strides (no batch-sized permute copy), spreads the row walk over ~500
// blocks (split-K, see gram.cuh) and writes only the small (n, n) result.

#include "gram.cuh"

extern "C" int kfac_factor_ema(const float* x, int rows, int d_in, int inner,
                               int sb, int ss, int sc, int mult_bf16,
                               int tile, int chunks, int rows_per_chunk,
                               float* ws,
                               float* ws_colsum, const float* old,
                               float decay, float inv_scale, int has_bias,
                               float bias_scale, float corner, float* out,
                               void* stream) {
  kfac::StridedLoader ld;
  ld.x = x;
  ld.inner = inner;
  ld.sb = sb;
  ld.ss = ss;
  ld.sc = sc;
  ld.ncols = d_in;
  const int n = d_in + (has_bias ? 1 : 0);
  return static_cast<int>(kfac::launch_gram(
      ld, rows, tile, chunks, rows_per_chunk, mult_bf16, ws, ws_colsum, d_in,
      n, inv_scale, bias_scale, corner, old, decay, out,
      static_cast<cudaStream_t>(stream)));
}
