// K4: batched damped SPD inverse by Newton--Schulz (replaces the Pallas
// `_ns_inverse_kernel`, distributed_kfac_pytorch_tpu/ops/pallas_kernels.py,
// driven by `_pallas_batched_ns_inverse`, `batched_inverse` and
// `damped_inverse_stack`).
//
// Per matrix z of a (B, n, n) stack, as `ops.linalg.newton_schulz_inverse`
// computes it (the unpadded iteration):
//   M = F + lambda I,  X_0 = I / max(max_i sum_j |M_ij|, 1e-30)
//   while k < iters and res > tol:   (res starts at +inf)
//     Y = M X_k;  res = max|Y - I|;  X_{k+1} = 2 X_k - X_k Y;  k += 1
// The residual is that of the iterate before the update, the update of
// the iteration whose residual first meets `tol` is still applied, and
// every matrix stops on its own.
//
// Bound on the H100: operations, 4 n^3 fp32 FLOPs per matrix and
// iteration (two n x n x n products) against 3 n^2 floats of traffic per
// product. Both products run on the tensor cores by 3xTF32 (gemm_tc.cuh):
// three TF32 products per fp32 product, so the kernel is held to
// 3 x 4 n^3 FLOPs at the dense TF32 rate of 494.7 TFLOP/s, about 2.5x
// below the fp32 CUDA-core bound (4 n^3 at 67 TFLOP/s), which no fp32-FMA
// design can beat and which lies above a library Cholesky inverse. One
// TF32 product is not enough: the reference iterates at
// Precision.HIGHEST, and with one TF32 product per fp32 product the
// residual stalls near 2e-3, far above the 1e-5 tolerance.
//
// The TPU kernel holds M and X in VMEM for the whole solve; an n = 4608
// matrix is 85 MB, so here each iteration is two launches of the batched
// 128 x 128-tile tensor-core GEMM (grid z = matrix; 32-deep k-tiles through
// a 4-slot cp.async ring in dynamic shared memory; mma.sync m16n8k8 with
// fp32 accumulators, each k-tile summed on its own and then added to the
// running sum):
//   residual launch: Y = M X_k, epilogue max|Y - I| per tile, folded into
//     the matrix's residual of iteration k with an atomicMax on the bits of
//     the non-negative float (order-free, so deterministic; a NaN wins, as
//     it does in the reference's max);
//   update launch: X_{k+1} = 2 X_k - X_k Y into the other X buffer
//     (ping-pong); the matrix's last block to finish reads the residual,
//     clears the matrix's active flag once it is <= tol (or NaN) and
//     counts its iterations.
// Blocks of an inactive matrix return at once. Sizes with n % 4 != 0 stage
// their tiles with 4-byte copies (rows are not 16-byte aligned), the others
// with 16-byte copies; either way the edges past n are zero-filled. The
// host loop issues the launches without a sync and reads the count of
// active matrices once every 8 iterations, to stop early. A last launch
// copies each matrix whose final iterate sits in the second buffer into
// the output.

#include "gemm_tc.cuh"

namespace {

constexpr int kThreads = 256;  // the element-wise and row kernels

__device__ __forceinline__ unsigned warp_max(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// M = F + lambda I, and the matrix's largest absolute row sum into
// bound_bits[z] (float bits: a max of non-negative floats). One warp per
// row, 8 rows per block; grid (ceil(n / 8), B). Block (0, z) also resets
// matrix z's loop state (and block (0, 0) the active count).
__global__ void __launch_bounds__(kThreads) ns_fold_kernel(
    const float* f, float damping, int B, int n, float* m,
    unsigned* bound_bits, int* active, int* iters_run, int* done,
    int* n_active) {
  const int z = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    active[z] = 1;
    iters_run[z] = 0;
    done[z] = 0;
    if (z == 0) *n_active = B;
  }
  if (row >= n) return;
  const int64_t base = static_cast<int64_t>(z) * n * n +
                       static_cast<int64_t>(row) * n;
  float s = 0.f;
  for (int j = lane; j < n; j += 32) {
    float v = f[base + j];
    if (j == row) v += damping;
    m[base + j] = v;
    s += fabsf(v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) atomicMax(&bound_bits[z], __float_as_uint(fabsf(s)));
}

// X_0 = I / max(bound, 1e-30); grid (ceil(n * n / kThreads), B).
__global__ void ns_init_kernel(const unsigned* bound_bits, int n, float* x) {
  const int z = blockIdx.y;
  const int64_t nn = static_cast<int64_t>(n) * n;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= nn) return;
  const float b = __uint_as_float(bound_bits[z]);
  const float bound = isnan(b) ? b : fmaxf(b, 1e-30f);
  const int i = static_cast<int>(e / n), j = static_cast<int>(e % n);
  x[z * nn + e] = (i == j) ? 1.f / bound : 0.f;
}

// Y = M X_k and res_k[z] = max |Y - I| (float bits).
template <bool kVec>
__global__ void __launch_bounds__(kTcThreads, 1) ns_residual_kernel(
    const float* m, const float* x, float* y, int n, const int* active,
    unsigned* res_k) {
  const int z = blockIdx.z;
  if (!active[z]) return;
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned red[kTcThreads / 32];
  const int64_t nn = static_cast<int64_t>(n) * n;
  const int m0 = blockIdx.y * kTcTile, n0 = blockIdx.x * kTcTile;
  float acc[4][4][4];
  tc_tile_mma<kVec>(m + z * nn, n, x + z * nn, n, n, n, n, m0, n0, smem,
                    acc);
  float* Y = y + z * nn;
  unsigned part = 0;
  tc_for_each(acc, m0, n0, [&](int gm, int gn, float v) {
    if (gm < n && gn < n) {
      Y[static_cast<int64_t>(gm) * n + gn] = v;
      part = max(part, __float_as_uint(fabsf(v - (gm == gn ? 1.f : 0.f))));
    }
  });
  part = warp_max(part);
  const int t = threadIdx.x;
  if (t % 32 == 0) red[t / 32] = part;
  __syncthreads();
  if (t == 0) {
    unsigned r = red[0];
#pragma unroll
    for (int w = 1; w < kTcThreads / 32; ++w) r = max(r, red[w]);
    atomicMax(&res_k[z], r);
  }
}

// X_{k+1} = 2 X_k - X_k Y; the matrix's last block closes iteration k.
template <bool kVec>
__global__ void __launch_bounds__(kTcThreads, 1) ns_update_kernel(
    const float* x, const float* y, float* x_next, int n, int k, float tol,
    const float* res_k, int* active, int* iters_run, int* done,
    int* n_active) {
  const int z = blockIdx.z;
  if (!active[z]) return;
  extern __shared__ __align__(16) float smem[];
  const int64_t nn = static_cast<int64_t>(n) * n;
  const int m0 = blockIdx.y * kTcTile, n0 = blockIdx.x * kTcTile;
  float acc[4][4][4];
  const float* X = x + z * nn;
  tc_tile_mma<kVec>(X, n, y + z * nn, n, n, n, n, m0, n0, smem, acc);
  float* Xn = x_next + z * nn;
  tc_for_each(acc, m0, n0, [&](int gm, int gn, float v) {
    if (gm < n && gn < n) {
      const int64_t off = static_cast<int64_t>(gm) * n + gn;
      Xn[off] = 2.f * X[off] - v;
    }
  });
  if (threadIdx.x == 0) {
    // Every block of matrix z has read active[z] before it counts itself
    // here, so the last one may clear the flag for the next iteration.
    const int blocks = gridDim.x * gridDim.y;
    if (atomicAdd(&done[z], 1) == blocks - 1) {
      done[z] = 0;
      iters_run[z] = k + 1;
      if (!(res_k[z] > tol)) {
        active[z] = 0;
        atomicSub(n_active, 1);
      }
    }
  }
}

// out[z] = x1[z] for every matrix whose last iterate is in the second
// buffer (an odd iteration count); grid (ceil(n * n / kThreads), B).
__global__ void ns_finish_kernel(const float* x1, const int* iters_run,
                                 int n, float* out) {
  const int z = blockIdx.y;
  if ((iters_run[z] & 1) == 0) return;
  const int64_t nn = static_cast<int64_t>(n) * n;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e < nn) out[z * nn + e] = x1[z * nn + e];
}

// The iterations: two tensor-core launches each, X_k alternating between
// out (even k) and x_ws (odd k).
template <bool kVec>
cudaError_t ns_iterate(int B, int n, int iters, float tol, const float* m_ws,
                       float* y_ws, float* x_ws, unsigned* res, int* active,
                       int* iters_run, int* done, int* n_active, float* out,
                       cudaStream_t stream) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ns_residual_kernel<kVec>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kTcSmemBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ns_update_kernel<kVec>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kTcSmemBytes)) != cudaSuccess)
    return err;
  const dim3 grid = tc_tile_grid(n, n, B);
  for (int k = 0; k < iters; ++k) {
    const float* xk = (k % 2 == 0) ? out : x_ws;
    float* xn = (k % 2 == 0) ? x_ws : out;
    unsigned* res_k = res + static_cast<int64_t>(k) * B;
    ns_residual_kernel<kVec><<<grid, kTcThreads, kTcSmemBytes, stream>>>(
        m_ws, xk, y_ws, n, active, res_k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ns_update_kernel<kVec><<<grid, kTcThreads, kTcSmemBytes, stream>>>(
        xk, y_ws, xn, n, k, tol, reinterpret_cast<const float*>(res_k),
        active, iters_run, done, n_active);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((k + 1) % 8 == 0 && k + 1 < iters) {
      int left = 0;
      if ((err = cudaMemcpyAsync(&left, n_active, sizeof(int),
                                 cudaMemcpyDeviceToHost, stream)) !=
          cudaSuccess)
        return err;
      if ((err = cudaStreamSynchronize(stream)) != cudaSuccess) return err;
      if (left == 0) break;
    }
  }
  return cudaSuccess;
}

}  // namespace

// f, out: (B, n, n). m_ws, y_ws, x_ws: (B, n, n) scratch. fstate: B +
// iters * B floats (the X_0 bound, then the residual of each iteration per
// matrix). istate: 3 * B + 1 ints (active flags, iterations run per
// matrix, block counters, active count). Returns a cudaError_t.
extern "C" int kfac_ns_inverse(const float* f, float damping, int B, int n,
                               int iters, float tol, float* m_ws,
                               float* y_ws, float* x_ws, float* fstate,
                               int* istate, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned* bound_bits = reinterpret_cast<unsigned*>(fstate);
  unsigned* res = bound_bits + B;
  int* active = istate;
  int* iters_run = istate + B;
  int* done = istate + 2 * B;
  int* n_active = istate + 3 * B;
  const int64_t nn = static_cast<int64_t>(n) * n;
  cudaError_t err;
  const size_t fbytes = sizeof(float) * (B + static_cast<int64_t>(iters) * B);
  if ((err = cudaMemsetAsync(fstate, 0, fbytes, stream)) != cudaSuccess)
    return err;
  const int rows_per_block = kThreads / 32;
  ns_fold_kernel<<<dim3((n + rows_per_block - 1) / rows_per_block, B),
                   kThreads, 0, stream>>>(f, damping, B, n, m_ws, bound_bits,
                                          active, iters_run, done, n_active);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 elem_grid(static_cast<unsigned>((nn + kThreads - 1) / kThreads),
                       B);
  ns_init_kernel<<<elem_grid, kThreads, 0, stream>>>(bound_bits, n, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = (n % 4 == 0)
            ? ns_iterate<true>(B, n, iters, tol, m_ws, y_ws, x_ws, res, active,
                               iters_run, done, n_active, out, stream)
            : ns_iterate<false>(B, n, iters, tol, m_ws, y_ws, x_ws, res,
                                active, iters_run, done, n_active, out,
                                stream);
  if (err != cudaSuccess) return err;
  ns_finish_kernel<<<elem_grid, kThreads, 0, stream>>>(x_ws, iters_run, n,
                                                       out);
  return static_cast<int>(cudaGetLastError());
}
