// K2: conv-A patch covariance (replaces the Pallas `_patch_cov_kernel`,
// distributed_kfac_pytorch_tpu/ops/pallas_kernels.py, driven by
// `_pallas_patch_cov` / `conv_a_factor_fused`).
//
// A = P^T P / (rows * spatial^2) for the implicit im2col matrix P of a
// (B, C, H, W) input (features in (c, kh, kw) order), with the bias
// row/column colsum(P) / (rows * spatial^2) and corner 1 / spatial^2 when
// has_bias. No EMA: the caller blends the running average, as the JAX
// path does.
//
// Bound on the H100: operations. ResNet-32 conv A is up to ~2.7 GFMA per
// layer (e.g. 8192 rows x 576^2) against a few MB of input, far above
// the fp32 ridge. The patch tensor, KH*KW times the input, never exists:
// each block gathers its rows of both feature tiles into shared memory
// from the input itself, padding is a bounds check, and only
// lower-triangle 64 x 64 output tiles are computed (see gram.cuh).

#include "gram.cuh"

extern "C" int kfac_patch_cov(const float* x, int B, int C, int H, int W,
                              int sb, int sc, int sh, int sw, int KH,
                              int KW, int SH, int SW, int PH, int PW,
                              int OH, int OW, int mult_bf16, int tile,
                              int chunks, int rows_per_chunk,
                              float* ws, float* ws_colsum, float inv_scale,
                              int has_bias, float bias_scale, float corner,
                              float* out, void* stream) {
  kfac::PatchLoader ld;
  ld.x = x;
  ld.C = C;
  ld.H = H;
  ld.W = W;
  ld.KH = KH;
  ld.KW = KW;
  ld.SH = SH;
  ld.SW = SW;
  ld.PH = PH;
  ld.PW = PW;
  ld.OH = OH;
  ld.OW = OW;
  ld.sb = sb;
  ld.sc = sc;
  ld.sh = sh;
  ld.sw = sw;
  ld.ncols = C * KH * KW;
  const int rows = B * OH * OW;
  const int d_in = C * KH * KW;
  const int n = d_in + (has_bias ? 1 : 0);
  return static_cast<int>(kfac::launch_gram(
      ld, rows, tile, chunks, rows_per_chunk, mult_bf16, ws, ws_colsum, d_in,
      n, inv_scale, bias_scale, corner, nullptr, 0.f, out,
      static_cast<cudaStream_t>(stream)));
}
