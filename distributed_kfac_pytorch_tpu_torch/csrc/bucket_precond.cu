// K3: bucketed preconditioning with the KL-clip v.g partial (replaces the
// Pallas `_bucket_precond_kernel`, distributed_kfac_pytorch_tpu/ops/
// pallas_kernels.py, driven by `_pallas_bucket_precond` /
// `fused_bucket_precondition`).
//
// Per slice s of a same-shape bucket:
//   eigen: v = QG [(QG^T g QA) / (dG dA^T + lambda)] QA^T
//   baked: v = G_inv g A_inv
//   vg[s] = sum(v * g)
//
// Bound on the H100: operations at the large buckets (the (64, 576)
// bucket is 4 * 64 * 576 * 640 FLOPs per slice against ~1.5 MB of
// operands), bytes at the small ones. The TPU kernel keeps one slice's
// whole chain in VMEM; a 576 x 576 fp32 QA is 1.3 MB, far beyond a
// block's shared memory, so here the chain is four launches of one
// batched 64 x 64-tile FMA GEMM (gemm.cuh, K3's alone; grid z =
// slice), with the eigenvalue
// divide fused into the second product's epilogue and the v.g partial
// into the last one's; a final one-thread-per-slice launch sums the
// per-tile partials in a fixed order (deterministic, no atomics).

#include "gemm.cuh"

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
  int mult_bf16;
  // kDivide: C[m, n] = acc / (dm[m] * dn[n] + damping), per-slice vectors.
  const float* dm;
  const float* dn;
  float damping;
  // kStoreVg: per-block partial of sum(C * g) -> vg_part[s * tiles + tile].
  const float* g;
  float* vg_part;
};

// op(A)[m, k] = TA ? A[k, m] : A[m, k];  op(B)[k, n] = TB ? B[n, k] : B[k, n]
template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(kThreads) bgemm_kernel(GemmArgs p) {
  __shared__ float sa[kK][kTile];  // [k][m]
  __shared__ float sb[kK][kTile];  // [k][n]
  __shared__ float red[kThreads];
  const int s = blockIdx.z;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  float acc[4][4];
  tile_mma<TA, TB>(p.a + s * p.a_stride, p.lda, p.b + s * p.b_stride, p.ldb,
                   p.M, p.N, p.K, m0, n0, p.mult_bf16, sa, sb, acc);

  float* C = p.c + s * p.c_stride;
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= p.N) continue;
      float v = acc[i][j];
      if (EPI == kDivide)
        v = v / (p.dm[s * p.M + gm] * p.dn[s * p.N + gn] + p.damping);
      const int64_t off = static_cast<int64_t>(gm) * p.N + gn;
      C[off] = v;
      // g has the output's (S, M, N) layout.
      if (EPI == kStoreVg) part += v * p.g[s * p.c_stride + off];
    }
  }
  if (EPI == kStoreVg) {
    red[t] = part;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (t < w) red[t] += red[t + w];
      __syncthreads();
    }
    if (t == 0) {
      const int tiles = gridDim.x * gridDim.y;
      p.vg_part[s * tiles + blockIdx.y * gridDim.x + blockIdx.x] = red[0];
    }
  }
}

__global__ void vg_reduce_kernel(const float* part, int tiles, int S,
                                 float* vg) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float acc = 0.f;
  for (int i = 0; i < tiles; ++i) acc += part[s * tiles + i];
  vg[s] = acc;
}

template <bool TA, bool TB, int EPI>
cudaError_t gemm(const GemmArgs& p, int S, cudaStream_t stream) {
  const dim3 grid = tile_grid(p.M, p.N, S);
  bgemm_kernel<TA, TB, EPI><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

GemmArgs make(const float* a, int64_t a_stride, int lda, const float* b,
              int64_t b_stride, int ldb, float* c, int M, int N, int K,
              int mult_bf16) {
  GemmArgs p{};
  p.a = a; p.a_stride = a_stride; p.lda = lda;
  p.b = b; p.b_stride = b_stride; p.ldb = ldb;
  p.c = c; p.c_stride = static_cast<int64_t>(M) * N;
  p.M = M; p.N = N; p.K = K;
  p.mult_bf16 = mult_bf16;
  return p;
}

}  // namespace

// Number of per-slice v.g partials the final (G, A) product writes: the
// size of the vg_part workspace per slice, which the caller allocates.
extern "C" int kfac_bucket_precond_tiles(int G, int A) {
  const dim3 grid = tile_grid(G, A, 1);
  return static_cast<int>(grid.x * grid.y);
}

// g (S, G, A); qa (S, A, A); qg (S, G, G); da (S, A); dg (S, G).
// ws_u, ws_t: (S, G, A) scratch; vg_part: (S, tiles) scratch.
extern "C" int kfac_bucket_precond_eigen(const float* g, const float* qa,
                                         const float* qg, const float* da,
                                         const float* dg, float damping,
                                         int S, int G, int A, int mult_bf16,
                                         float* ws_u, float* ws_t,
                                         float* vg_part, float* v, float* vg,
                                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t ga = static_cast<int64_t>(G) * A;
  const int64_t aa = static_cast<int64_t>(A) * A;
  const int64_t gg = static_cast<int64_t>(G) * G;
  cudaError_t err;
  // U = g QA
  GemmArgs p = make(g, ga, A, qa, aa, A, ws_u, G, A, A, mult_bf16);
  if ((err = gemm<false, false, kStore>(p, S, stream)) != cudaSuccess)
    return err;
  // T = (QG^T U) / (dG dA^T + lambda)
  p = make(qg, gg, G, ws_u, ga, A, ws_t, G, A, G, mult_bf16);
  p.dm = dg; p.dn = da; p.damping = damping;
  if ((err = gemm<true, false, kDivide>(p, S, stream)) != cudaSuccess)
    return err;
  // W = T QA^T   (reuses the U buffer)
  p = make(ws_t, ga, A, qa, aa, A, ws_u, G, A, A, mult_bf16);
  if ((err = gemm<false, true, kStore>(p, S, stream)) != cudaSuccess)
    return err;
  // v = QG W, with the per-tile sum(v * g) partials
  p = make(qg, gg, G, ws_u, ga, A, v, G, A, G, mult_bf16);
  p.g = g; p.vg_part = vg_part;
  if ((err = gemm<false, false, kStoreVg>(p, S, stream)) != cudaSuccess)
    return err;
  vg_reduce_kernel<<<(S + 127) / 128, 128, 0, stream>>>(
      vg_part, kfac_bucket_precond_tiles(G, A), S, vg);
  return static_cast<int>(cudaGetLastError());
}

// g (S, G, A); a_inv (S, A, A); g_inv (S, G, G). ws_u: (S, G, A) scratch.
extern "C" int kfac_bucket_precond_baked(const float* g, const float* a_inv,
                                         const float* g_inv, int S, int G,
                                         int A, int mult_bf16, float* ws_u,
                                         float* vg_part, float* v, float* vg,
                                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t ga = static_cast<int64_t>(G) * A;
  const int64_t aa = static_cast<int64_t>(A) * A;
  const int64_t gg = static_cast<int64_t>(G) * G;
  cudaError_t err;
  // U = g A_inv
  GemmArgs p = make(g, ga, A, a_inv, aa, A, ws_u, G, A, A, mult_bf16);
  if ((err = gemm<false, false, kStore>(p, S, stream)) != cudaSuccess)
    return err;
  // v = G_inv U, with the per-tile sum(v * g) partials
  p = make(g_inv, gg, G, ws_u, ga, A, v, G, A, G, mult_bf16);
  p.g = g; p.vg_part = vg_part;
  if ((err = gemm<false, false, kStoreVg>(p, S, stream)) != cudaSuccess)
    return err;
  vg_reduce_kernel<<<(S + 127) / 128, 128, 0, stream>>>(
      vg_part, kfac_bucket_precond_tiles(G, A), S, vg);
  return static_cast<int>(cudaGetLastError());
}
