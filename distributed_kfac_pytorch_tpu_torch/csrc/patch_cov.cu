// K2: conv-A patch covariance (replaces the Pallas `_patch_cov_kernel`,
// distributed_kfac_pytorch_tpu/ops/pallas_kernels.py:319, driven by
// `_pallas_patch_cov` (:372) and `conv_a_factor_fused` (:485)).
//
// A = P^T P / (rows * spatial^2) for the implicit im2col matrix P of a
// (B, C, H, W) input: row r = (b, oh, ow), feature f = (c, ki, kj) with kj
// fastest (torch's (Cout, Cin, KH, KW) weight flattening order), with the
// bias row/column colsum(P) / (rows * spatial^2) and corner 1 / spatial^2
// when has_bias. No EMA: the caller blends the running average, as the JAX
// path does.
//
// Bound on the H100: operations. ResNet-50's conv A factors are 1.31 TFLOP
// per step (rows D (D + 1) FLOPs; D up to 4608) against a few MB of input
// per layer, far above the ridge. The products run on the tensor cores by
// 3xTF32 on the Gram engine of gram_tc.cuh (K1's: lower-triangle T x T
// tile pairs, T = 32, 64 or 128, a 4-slot cp.async ring of K-major tiles,
// fresh accumulators per 32-deep k-tile, split-K and a fixed-order
// finalize that mirrors each upper entry from its lower one: exactly
// symmetric, repeatable bit for bit), read against three TF32 products per
// fp32 product at 494.7 TFLOP/s.
//
// The patch tensor, KH*KW times the input, never exists. Staging paths
// (picked by the host, ops/kernels.py patch_cov_plan):
//   kPatch4 (PatchStage below): the implicit im2col. A k-tile is 32
//     consecutive patch rows of T features, one 4-byte cp.async per element
//     with K1's kKMajor4 thread map (a warp on one feature and 32
//     consecutive rows, so at stride 1 on consecutive w addresses). The
//     block decodes its 2T column descriptors once into shared memory:
//     offset c*sc + dh*sh + dw*sw and the tap shift (dh, dw) = (ki - PH,
//     kj - PW) packed in one int; a thread decodes its row once per
//     k-tile: top-left tap (h0, w0) = (oh*SH, ow*SW) and base offset
//     b*sb + h0*sh + w0*sw. A tap outside the image, a row past the last
//     and a feature past the last (whose shift is always outside) copy
//     zero bytes: cp.async's src-size zero-fills, so padding reads as zero
//     with no padded copy. Offsets are 32-bit (the host checks the span).
//   kKMajor16, kKMajor4, kFeature4 (gram_tc.cuh's RowStage, K1's paths):
//     1 x 1 stride-1 unpadded convs, whose patch matrix is the input read
//     as (B*H*W, C) rows, the rows K1 stages from a conv output-grad.

#include "gram_tc.cuh"

namespace {

constexpr int kPatch4 = 3;
constexpr int kMaxTile = 128;
// A packed tap shift whose row shift puts every tap outside the image.
constexpr int kNoTap = -(1 << 30);

// Column descriptors of the block's two tiles (A's T, then B's T).
__shared__ int2 tap_cols[2 * kMaxTile];

struct PatchSrc {
  const float* x;
  int d_in, H, W, KH, KW, SH, SW, PH, PW, OH, OW;
  int sb, sc, sh, sw;  // element strides of the b, c, h, w axes
};

struct PatchStage {
  PatchSrc src;

  template <int TM>
  __device__ __forceinline__ void prepare(int fa, int fb) const {
    constexpr int T = 32 * TM;
    const int t = threadIdx.x;
    if (t < 2 * T) {
      const int f = t < T ? fa + t : fb + t - T;
      int2 d = make_int2(0, kNoTap);
      if (f < src.d_in) {
        const int kj = f % src.KW, q = f / src.KW;
        const int ki = q % src.KH, c = q / src.KH;
        const int dh = ki - src.PH, dw = kj - src.PW;
        d = make_int2(c * src.sc + dh * src.sh + dw * src.sw,
                      static_cast<int>((static_cast<unsigned>(dh) << 16) |
                                       (static_cast<unsigned>(dw) & 0xffffu)));
      }
      tap_cols[t] = d;
    }
    __syncthreads();
  }

  template <int TM>
  __device__ __forceinline__ void stage(int which, int, int k0, int r1,
                                        float* s) const {
    constexpr int T = 32 * TM;
    // Thread: row t % 32, features t / 32 + 8 j.
    const int t = threadIdx.x;
    const int k = t % 32;
    const int r = k0 + k;
    const bool rok = r < r1;
    const int ow = r % src.OW, q = r / src.OW;
    const int oh = q % src.OH, b = q / src.OH;
    const int h0 = oh * src.SH, w0 = ow * src.SW;
    const int roff = b * src.sb + h0 * src.sh + w0 * src.sw;
    const int2* cols = tap_cols + which * T;
    const int c0 = t / 32;
#pragma unroll
    for (int j = 0; j < 4 * TM; ++j) {
      const int c = c0 + 8 * j;
      const int2 d = cols[c];
      const unsigned h = static_cast<unsigned>(h0 + (d.y >> 16));
      const unsigned w =
          static_cast<unsigned>(w0 + static_cast<short>(d.y & 0xffff));
      const bool ok = rok && h < static_cast<unsigned>(src.H) &&
                      w < static_cast<unsigned>(src.W);
      cp_async4(s + c * kLd + k, ok ? src.x + (roff + d.x) : src.x, ok);
    }
  }
};

template <int TM, class Stage>
__global__ void __launch_bounds__(kTcThreads, TM == 4 ? 1 : TM == 2 ? 2 : 4)
patch_partial_kernel(Stage st, int rows, int rows_per_chunk, int mult_bf16,
                     int has_bias, float* __restrict__ ws,
                     float* __restrict__ ws_colsum, int ncols_pad) {
  gram_partial<TM>(st, rows, rows_per_chunk, mult_bf16, has_bias, ws,
                   ws_colsum, ncols_pad);
}

__global__ void __launch_bounds__(kFin * kFin)
patch_finalize_kernel(const float* __restrict__ ws,
                      const float* __restrict__ ws_colsum, int chunks,
                      int npairs, int tile, int ncols_pad, int d_in, int n,
                      float inv_scale, float bias_scale, float corner,
                      float* __restrict__ out) {
  gram_finalize<float>(ws, ws_colsum, chunks, npairs, tile, ncols_pad, d_in,
                       n, inv_scale, bias_scale, corner, nullptr, 0.f, out);
}

struct Launch {
  int rows, npairs, chunks, rows_per_chunk, mult_bf16, has_bias;
  float* ws;
  float* ws_colsum;
  int ncols_pad;
  cudaStream_t stream;
};

template <int TM, class Stage>
cudaError_t launch_partial(const Stage& st, const Launch& l) {
  auto kernel = patch_partial_kernel<TM, Stage>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<TM>);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(l.npairs, l.chunks), kTcThreads, kSmemBytes<TM>,
           l.stream>>>(st, l.rows, l.rows_per_chunk, l.mult_bf16,
                       l.has_bias, l.ws, l.ws_colsum, l.ncols_pad);
  return cudaGetLastError();
}

template <class Stage>
cudaError_t launch_tile(int tile, const Stage& st, const Launch& l) {
  switch (tile) {
    case 32:
      return launch_partial<1>(st, l);
    case 64:
      return launch_partial<2>(st, l);
    case 128:
      return launch_partial<4>(st, l);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x is (B, C, H, W) at element strides (sb, sc, sh, sw); the conv has a
// KH x KW kernel, strides (SH, SW), top / left padding (PH, PW) and an
// OH x OW output, so rows = B*OH*OW and d_in = C*KH*KW. The K1 paths read
// rows r = (b, s), s < inner, at b*rsb + s*rss, feature c at c*rsc (the
// host's collapse of a 1 x 1 stride-1 conv's input). ws holds chunks x
// npairs x tile^2 partial floats followed, with has_bias, by chunks x
// ncols_pad column sums (ncols_pad = ceil(d_in / tile) tile).
extern "C" int kfac_patch_cov(const float* x, int B, int C, int H, int W,
                              int sb, int sc, int sh, int sw, int KH,
                              int KW, int SH, int SW, int PH, int PW,
                              int OH, int OW, int inner, int rsb, int rss,
                              int rsc, int mult_bf16, int tile, int path,
                              int chunks, int rows_per_chunk, float* ws,
                              float inv_scale, int has_bias,
                              float bias_scale, float corner, float* out,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * OH * OW;
  const int d_in = C * KH * KW;
  const int ntiles = (d_in + tile - 1) / tile;
  const int npairs = ntiles * (ntiles + 1) / 2;
  const int ncols_pad = ntiles * tile;
  float* ws_colsum = ws + static_cast<int64_t>(chunks) * npairs * tile * tile;
  const Launch l{rows,     npairs,    chunks,    rows_per_chunk, mult_bf16,
                 has_bias, ws,        ws_colsum, ncols_pad,      st};
  const Src src{x, rows, d_in, inner, rsb, rss, rsc};
  cudaError_t err;
  switch (path) {
    case kKMajor16:
      err = launch_tile(tile, RowStage<kKMajor16>{src}, l);
      break;
    case kKMajor4:
      err = launch_tile(tile, RowStage<kKMajor4>{src}, l);
      break;
    case kFeature4:
      err = launch_tile(tile, RowStage<kFeature4>{src}, l);
      break;
    case kPatch4:
      err = launch_tile(tile, PatchStage{{x, d_in, H, W, KH, KW, SH, SW, PH,
                                          PW, OH, OW, sb, sc, sh, sw}},
                        l);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = d_in + (has_bias ? 1 : 0);
  const int nb = (n + kFin - 1) / kFin;
  patch_finalize_kernel<<<nb * (nb + 1) / 2, dim3(kFin, kFin), 0, st>>>(
      ws, ws_colsum, chunks, npairs, tile, ncols_pad, d_in, n, inv_scale,
      bias_scale, corner, out);
  return static_cast<int>(cudaGetLastError());
}
