// K3: bucketed preconditioning with the KL-clip v.g partial (replaces the
// Pallas `_bucket_precond_kernel`, distributed_kfac_pytorch_tpu/ops/
// pallas_kernels.py:804, driven by `_pallas_bucket_precond` (:845) and
// `fused_bucket_precondition` (:883)).
//
// Per slice s of a same-shape bucket:
//   eigen: v = QG [(QG^T g QA) / (dG dA^T + lambda)] QA^T
//   baked: v = G_inv g A_inv
//   vg[s] = sum(v * g)
//
// Bound on the H100: operations at the large buckets (ResNet-50's
// (512, 4608) x 3 is 72.5 GFLOP against ~0.3 GB of operands; the LSTM's
// (16, 650, 651) eigen bucket 35.3 GFLOP), bytes or launches at the small
// ones. The products run on the tensor cores by 3xTF32 (gemm_tc.cuh: three
// TF32 mma.sync products per fp32 product, each 32-deep k-tile summed into
// fresh accumulators, a 4-slot cp.async ring), so the bound is three times
// the fp32 FLOPs at the dense TF32 rate of 494.7 TFLOP/s. The TPU kernel
// keeps one slice's whole chain in VMEM; a 4608 x 4608 fp32 A_inv is 85 MB,
// far beyond a block's shared memory, so here the chain is one launch of
// the batched tile product per product (grid z = slice), in the order
//   eigen: U = g QA;  T = (QG^T U) / (dG dA^T + lambda);  W = T QA^T;
//          v = QG W
//   baked: U = g A_inv;  v = G_inv U
// with the eigenvalue divide fused into T's epilogue and the per-tile
// sum(v * g) partial into v's; a last one-thread-per-slice launch sums the
// partials in a fixed order (deterministic, no atomics). QG^T is read from
// QG through the transposed-A staging and QA^T from QA through the
// transposed-B staging: no transposed copy is made.
//
// Every product's output is (G, A): a block owns BM x 128 of it, BM = 128,
// or 64 where G is small or 128-row tiles leave the card's last wave
// mostly empty (the host plan, ops/kernels.py bucket_precond_plan, picks
// BM and the staging). Buckets whose G and A are multiples of 4 (with
// 16-byte aligned operands) stage with 16-byte copies, the others (A =
// 2049, 651, 147; G = 650) with 4-byte copies. In the bf16-multiplicand
// mode every operand, U and T included, is rounded to bf16 as it is loaded
// and each product is one TF32 product (kBf16).

#include <type_traits>

#include "gemm_tc.cuh"

namespace {

enum Epilogue { kStore = 0, kDivide = 1, kStoreVg = 2 };

struct GemmArgs {
  // C[s] (M x N) = op(A[s]) (M x K) @ op(B[s]) (K x N), row-major slices.
  const float* a;
  int64_t a_stride;
  int lda;
  const float* b;
  int64_t b_stride;
  int ldb;
  float* c;
  int64_t c_stride;
  int M, N, K;
  // kDivide: C[m, n] = acc / (dm[m] * dn[n] + damping), per-slice vectors.
  const float* dm;
  const float* dn;
  float damping;
  // kStoreVg: per-block partial of sum(C * g) -> vg_part[s * tiles + tile].
  const float* g;
  float* vg_part;
};

// op(A)[m, k] = kTA ? A[k, m] : A[m, k];
// op(B)[k, n] = kTB ? B[n, k] : B[k, n].
// One block per SM at BM = 128 (140-144 KB of ring), two at BM = 64.
template <int BM, bool kVec, bool kTA, bool kTB, bool kBf16, int EPI>
__global__ void __launch_bounds__(kTcThreads, BM == 128 ? 1 : 2)
bgemm_kernel(GemmArgs p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kTcThreads / 32];
  const int s = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kTcTile;
  float acc[BM / 32][4][4];
  // A 64-row tile's 4-byte copies run in a rolled loop (gemm_tc.cuh
  // tc_stage_tile); the 128-row tiles run faster unrolled.
  tc_tile_mma<kVec, BM, kTA, kTB, kBf16, !kVec && BM < kTcTile>(
      p.a + s * p.a_stride, p.lda, p.b + s * p.b_stride, p.ldb, p.M, p.N,
      p.K, m0, n0, smem, acc);

  float* C = p.c + s * p.c_stride;
  float part = 0.f;
  tc_for_each(acc, m0, n0, [&](int gm, int gn, float v) {
    if (gm < p.M && gn < p.N) {
      if constexpr (EPI == kDivide)
        v = v / __fadd_rn(__fmul_rn(p.dm[s * p.M + gm], p.dn[s * p.N + gn]),
                          p.damping);
      const int64_t off = static_cast<int64_t>(gm) * p.N + gn;
      C[off] = v;
      // g has the output's (S, M, N) layout.
      if constexpr (EPI == kStoreVg) part += v * p.g[s * p.c_stride + off];
    }
  });
  if constexpr (EPI == kStoreVg) {
    // Fixed order: the thread's accumulators, a butterfly over the warp,
    // then the warps' sums in warp order.
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    const int t = threadIdx.x;
    if (t % 32 == 0) red[t / 32] = part;
    __syncthreads();
    if (t == 0) {
      float sum = red[0];
#pragma unroll
      for (int w = 1; w < kTcThreads / 32; ++w) sum += red[w];
      const int tiles = gridDim.x * gridDim.y;
      p.vg_part[static_cast<int64_t>(s) * tiles + blockIdx.y * gridDim.x +
                blockIdx.x] = sum;
    }
  }
}

__global__ void vg_reduce_kernel(const float* part, int tiles, int S,
                                 float* vg) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float acc = 0.f;
  for (int i = 0; i < tiles; ++i)
    acc += part[static_cast<int64_t>(s) * tiles + i];
  vg[s] = acc;
}

template <int BM, bool kVec, bool kTA, bool kTB, bool kBf16, int EPI>
cudaError_t gemm(const GemmArgs& p, int S, cudaStream_t stream) {
  constexpr int bytes = kTcSmemBytesOf<BM, kTA, kTB>;
  auto kernel = bgemm_kernel<BM, kVec, kTA, kTB, kBf16, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<tc_tile_grid(p.M, p.N, S, BM), kTcThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

GemmArgs make(const float* a, int64_t a_stride, int lda, const float* b,
              int64_t b_stride, int ldb, float* c, int M, int N, int K) {
  GemmArgs p{};
  p.a = a; p.a_stride = a_stride; p.lda = lda;
  p.b = b; p.b_stride = b_stride; p.ldb = ldb;
  p.c = c; p.c_stride = static_cast<int64_t>(M) * N;
  p.M = M; p.N = N; p.K = K;
  return p;
}

cudaError_t reduce_vg(const float* vg_part, int G, int A, int S, int tile_m,
                      float* vg, cudaStream_t stream) {
  const dim3 grid = tc_tile_grid(G, A, 1, tile_m);
  vg_reduce_kernel<<<(S + 127) / 128, 128, 0, stream>>>(
      vg_part, static_cast<int>(grid.x * grid.y), S, vg);
  return cudaGetLastError();
}

// f(bm, vec, bf16) with each argument a std::integral_constant, for the
// runtime tile height (64 or 128), staging path and mode.
template <class F>
cudaError_t dispatch(int tile_m, int vec, int mult_bf16, F&& f) {
  auto by_mode = [&](auto bm, auto v) {
    return mult_bf16 ? f(bm, v, std::true_type{})
                     : f(bm, v, std::false_type{});
  };
  auto by_vec = [&](auto bm) {
    return vec ? by_mode(bm, std::true_type{})
               : by_mode(bm, std::false_type{});
  };
  switch (tile_m) {
    case 64:
      return by_vec(std::integral_constant<int, 64>{});
    case 128:
      return by_vec(std::integral_constant<int, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// g (S, G, A); qa (S, A, A); qg (S, G, G); da (S, A); dg (S, G).
// ws_u, ws_t: (S, G, A) scratch; vg_part: S x tiles scratch, tiles =
// ceil(G / tile_m) ceil(A / 128). tile_m: 64 or 128; vec: 16-byte staging
// (G and A multiples of 4, every pointer 16-byte aligned). Returns a
// cudaError_t.
extern "C" int kfac_bucket_precond_eigen(const float* g, const float* qa,
                                         const float* qg, const float* da,
                                         const float* dg, float damping,
                                         int S, int G, int A, int tile_m,
                                         int vec, int mult_bf16, float* ws_u,
                                         float* ws_t, float* vg_part,
                                         float* v, float* vg,
                                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t ga = static_cast<int64_t>(G) * A;
  const int64_t aa = static_cast<int64_t>(A) * A;
  const int64_t gg = static_cast<int64_t>(G) * G;
  cudaError_t err = dispatch(tile_m, vec, mult_bf16, [&](auto bm, auto v16,
                                                         auto bf) {
    constexpr int BM = decltype(bm)::value;
    constexpr bool kVec = decltype(v16)::value, kBf16 = decltype(bf)::value;
    cudaError_t e;
    // U = g QA
    GemmArgs p = make(g, ga, A, qa, aa, A, ws_u, G, A, A);
    if ((e = gemm<BM, kVec, false, false, kBf16, kStore>(p, S, stream)) !=
        cudaSuccess)
      return e;
    // T = (QG^T U) / (dG dA^T + lambda)
    p = make(qg, gg, G, ws_u, ga, A, ws_t, G, A, G);
    p.dm = dg; p.dn = da; p.damping = damping;
    if ((e = gemm<BM, kVec, true, false, kBf16, kDivide>(p, S, stream)) !=
        cudaSuccess)
      return e;
    // W = T QA^T   (into the U buffer)
    p = make(ws_t, ga, A, qa, aa, A, ws_u, G, A, A);
    if ((e = gemm<BM, kVec, false, true, kBf16, kStore>(p, S, stream)) !=
        cudaSuccess)
      return e;
    // v = QG W, with the per-tile sum(v * g) partials
    p = make(qg, gg, G, ws_u, ga, A, v, G, A, G);
    p.g = g; p.vg_part = vg_part;
    return gemm<BM, kVec, false, false, kBf16, kStoreVg>(p, S, stream);
  });
  if (err != cudaSuccess) return err;
  return reduce_vg(vg_part, G, A, S, tile_m, vg, stream);
}

// g (S, G, A); a_inv (S, A, A); g_inv (S, G, G). ws_u: (S, G, A) scratch;
// vg_part, tile_m, vec as above.
extern "C" int kfac_bucket_precond_baked(const float* g, const float* a_inv,
                                         const float* g_inv, int S, int G,
                                         int A, int tile_m, int vec,
                                         int mult_bf16, float* ws_u,
                                         float* vg_part, float* v, float* vg,
                                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t ga = static_cast<int64_t>(G) * A;
  const int64_t aa = static_cast<int64_t>(A) * A;
  const int64_t gg = static_cast<int64_t>(G) * G;
  cudaError_t err = dispatch(tile_m, vec, mult_bf16, [&](auto bm, auto v16,
                                                         auto bf) {
    constexpr int BM = decltype(bm)::value;
    constexpr bool kVec = decltype(v16)::value, kBf16 = decltype(bf)::value;
    cudaError_t e;
    // U = g A_inv
    GemmArgs p = make(g, ga, A, a_inv, aa, A, ws_u, G, A, A);
    if ((e = gemm<BM, kVec, false, false, kBf16, kStore>(p, S, stream)) !=
        cudaSuccess)
      return e;
    // v = G_inv U, with the per-tile sum(v * g) partials
    p = make(g_inv, gg, G, ws_u, ga, A, v, G, A, G);
    p.g = g; p.vg_part = vg_part;
    return gemm<BM, kVec, false, false, kBf16, kStoreVg>(p, S, stream);
  });
  if (err != cudaSuccess) return err;
  return reduce_vg(vg_part, G, A, S, tile_m, vg, stream);
}
