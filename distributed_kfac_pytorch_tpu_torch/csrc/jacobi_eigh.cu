// K5: batched symmetric eigendecomposition by Brent--Luk parallel cyclic
// Jacobi (replaces the Pallas `_jacobi_eigh_kernel`,
// distributed_kfac_pytorch_tpu/ops/pallas_kernels.py, driven by
// `_pallas_batched_jacobi_eigh` / `batched_jacobi_eigh`).
//
// Per matrix of a (B, n, n) stack, n even (the wrapper pads odd n with a
// decoupled unit eigenpair), in the slot basis of
// `ops.linalg.jacobi_slot_iteration`: `rounds` = sweeps * (n - 1) rounds,
// each pairing slot i with slot p + i (p = n / 2) for every i at once:
//   (c_i, s_i) from app = A[i][i], aqq = A[p+i][p+i], apq = A[i][p+i]:
//     tau = (aqq - app) / (2 apq)  (t = 0 when |apq| <= 1e-30),
//     t = sign(tau) / (|tau| + sqrt(1 + tau^2)), sign(0) = +1,
//     c = 1 / sqrt(1 + t^2), s = t c;
//   rows of A:    lo' = c lo - s hi,  hi' = s lo + c hi  (lo = row i,
//                 hi = row p + i), then the same over the columns of A and
//                 of V (V starts as the identity);
//   then the Brent--Luk exchange moves each slot k to dest[k] (rows and
//   columns of A, columns of V), dest being the host-built int32 table.
// The output is V and A in the final slot order; the wrapper reads the
// diagonal of A, sorts ascending and strips the pad eigenpair.
//
// Design. One launch per round; the host loop enqueues every round of a
// bucket on the caller's stream with no sync and no early exit (the JAX
// iteration runs a fixed number of rounds). A thread owns the 2 x 2 block
// at (pair i, pair j) of A and of V: it reads the four old values of each,
// rotates them (rows, then columns, in the plain version's order) and
// stores each result straight to its slot after the exchange, so the
// shuffle costs no extra pass. A block recomputes the (c, s) of its 32 row
// pairs and 32 column pairs from the old A into shared memory. A and V
// ping-pong between two buffers each (the permuted stores would race an
// in-place update).
//
// Arithmetic. Every operation uses the round-to-nearest intrinsics, so
// nvcc contracts nothing into an FMA and the kernel rounds exactly as the
// plain PyTorch version does op by op (IEEE division and square root, no
// fast math).
//
// Bound on the H100: operations, 9 n^2 fp32 FLOPs per matrix and round
// (6 per element of A, 3 per element of V) -- e.g. ~518 GFLOP, ~7.7 ms at
// 67 TFLOP/s for a (16, 652) stack's 13 x 651 rounds. This simple design
// moves A and V through memory every round (4 x B n^2 floats read or
// written), so it is bound by that traffic instead. The host loop runs
// the stack in chunks of `chunk` matrices, all rounds of one chunk before
// the next, so that a chunk's four buffers can stay in the 50 MB L2.

#include <cuda_runtime.h>

namespace {

constexpr int kPairsJ = 32;   // column pairs per block (threadIdx.x)
constexpr int kPairsI = 32;   // row pairs per block
constexpr int kRowsY = 8;     // threadIdx.y; each thread walks 4 row pairs

__device__ __forceinline__ void rotation(float app, float aqq, float apq,
                                         float* c, float* s) {
  const bool small = fabsf(apq) <= 1e-30f;
  const float tau = __fdiv_rn(__fsub_rn(aqq, app),
                              small ? 1.0f : __fmul_rn(2.0f, apq));
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  float t = __fdiv_rn(
      sgn, __fadd_rn(fabsf(tau),
                     __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)))));
  if (small) t = 0.0f;
  const float cc =
      __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  *c = cc;
  *s = __fmul_rn(t, cc);
}

// lo' = c lo - s hi
__device__ __forceinline__ float rot_lo(float c, float s, float lo,
                                        float hi) {
  return __fsub_rn(__fmul_rn(c, lo), __fmul_rn(s, hi));
}

// hi' = s lo + c hi
__device__ __forceinline__ float rot_hi(float c, float s, float lo,
                                        float hi) {
  return __fadd_rn(__fmul_rn(s, lo), __fmul_rn(c, hi));
}

// One round over matrices blockIdx.z of the chunk; grid (ceil(p / 32),
// ceil(p / 32), chunk), block (32, 8).
__global__ void __launch_bounds__(kPairsJ * kRowsY) jacobi_round_kernel(
    const float* __restrict__ a_in, float* __restrict__ a_out,
    const float* __restrict__ v_in, float* __restrict__ v_out,
    const int* __restrict__ dest, int n) {
  __shared__ float c_i[kPairsI], s_i[kPairsI], c_j[kPairsJ], s_j[kPairsJ];
  const int p = n / 2;
  const size_t off = static_cast<size_t>(blockIdx.z) * n * n;
  a_in += off;
  a_out += off;
  v_in += off;
  v_out += off;
  const int i0 = blockIdx.y * kPairsI, j0 = blockIdx.x * kPairsJ;
  const int tid = threadIdx.y * kPairsJ + threadIdx.x;
  if (tid < kPairsI) {
    const int i = i0 + tid;
    if (i < p)
      rotation(a_in[static_cast<size_t>(i) * n + i],
               a_in[static_cast<size_t>(p + i) * n + p + i],
               a_in[static_cast<size_t>(i) * n + p + i], &c_i[tid],
               &s_i[tid]);
  } else if (tid < kPairsI + kPairsJ) {
    const int k = tid - kPairsI, j = j0 + k;
    if (j < p)
      rotation(a_in[static_cast<size_t>(j) * n + j],
               a_in[static_cast<size_t>(p + j) * n + p + j],
               a_in[static_cast<size_t>(j) * n + p + j], &c_j[k], &s_j[k]);
  }
  __syncthreads();
  const int j = j0 + threadIdx.x;
  if (j >= p) return;
  const float cj = c_j[threadIdx.x], sj = s_j[threadIdx.x];
  const int dj0 = dest[j], dj1 = dest[p + j];
  for (int k = threadIdx.y; k < kPairsI; k += kRowsY) {
    const int i = i0 + k;
    if (i >= p) break;
    const float ci = c_i[k], si = s_i[k];
    const size_t r0 = static_cast<size_t>(i) * n;
    const size_t r1 = static_cast<size_t>(p + i) * n;
    // A: rows of pair i, then columns of pair j.
    const float a00 = a_in[r0 + j], a01 = a_in[r0 + p + j];
    const float a10 = a_in[r1 + j], a11 = a_in[r1 + p + j];
    const float b00 = rot_lo(ci, si, a00, a10), b10 = rot_hi(ci, si, a00, a10);
    const float b01 = rot_lo(ci, si, a01, a11), b11 = rot_hi(ci, si, a01, a11);
    const size_t d0 = static_cast<size_t>(dest[i]) * n;
    const size_t d1 = static_cast<size_t>(dest[p + i]) * n;
    a_out[d0 + dj0] = rot_lo(cj, sj, b00, b01);
    a_out[d0 + dj1] = rot_hi(cj, sj, b00, b01);
    a_out[d1 + dj0] = rot_lo(cj, sj, b10, b11);
    a_out[d1 + dj1] = rot_hi(cj, sj, b10, b11);
    // V: columns of pair j only; its rows keep their places.
    const float v00 = v_in[r0 + j], v01 = v_in[r0 + p + j];
    const float v10 = v_in[r1 + j], v11 = v_in[r1 + p + j];
    v_out[r0 + dj0] = rot_lo(cj, sj, v00, v01);
    v_out[r0 + dj1] = rot_hi(cj, sj, v00, v01);
    v_out[r1 + dj0] = rot_lo(cj, sj, v10, v11);
    v_out[r1 + dj1] = rot_hi(cj, sj, v10, v11);
  }
}

}  // namespace

// a0 / v0 hold the padded stack and the identity on entry; after `rounds`
// rounds the result sits in (a0, v0) for an even count, (a1, v1) for an
// odd one. Returns the first CUDA error of a launch, else 0.
extern "C" int kfac_jacobi_eigh(float* a0, float* a1, float* v0, float* v1,
                                const int* dest, int batch, int n,
                                int rounds, int chunk, void* stream) {
  if (n < 2 || n % 2 || batch < 1 || chunk < 1 || chunk > 65535 ||
      rounds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int p = n / 2;
  const size_t mat = static_cast<size_t>(n) * n;
  const dim3 block(kPairsJ, kRowsY);
  for (int z0 = 0; z0 < batch; z0 += chunk) {
    const int count = batch - z0 < chunk ? batch - z0 : chunk;
    const dim3 grid((p + kPairsJ - 1) / kPairsJ, (p + kPairsI - 1) / kPairsI,
                    count);
    float* a[2] = {a0 + z0 * mat, a1 + z0 * mat};
    float* v[2] = {v0 + z0 * mat, v1 + z0 * mat};
    for (int r = 0; r < rounds; ++r) {
      const int src = r & 1;
      jacobi_round_kernel<<<grid, block, 0, st>>>(a[src], a[src ^ 1], v[src],
                                                  v[src ^ 1], dest, n);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
