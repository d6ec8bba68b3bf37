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
//   then the Brent--Luk exchange moves the rows and columns of A and the
//   columns of V to the next pairing.
// The output is V and diag(A) in the final slot order; the wrapper sorts
// ascending and strips the pad eigenpair.
//
// Bound on the H100: operations, 9 n^2 fp32 FLOPs per matrix and round
// (6 per element of A, 3 per element of V) -- e.g. ~518 GFLOP, ~7.7 ms at
// 67 TFLOP/s for a (16, 652) stack's 13 x 651 rounds. Every operation uses
// the round-to-nearest intrinsics, so nvcc contracts nothing into an FMA
// and the kernels round exactly as the plain PyTorch version does, op by
// op (IEEE division and square root, no fast math), and every multiply
// and add is an instruction of its own: twice the FMA-counted bound.
//
// Two paths, chosen by the wrapper by size alone.
//
// Cluster path (n up to 664, `kfac_jacobi_eigh_cluster`). Two facts carry
// it. (1) The exchange is a ring rotation: slot 0 stays, and the other
// n - 1 slots, in the ring order t1 .. t_{p-1}, b_{p-1} .. b0 (the
// wrapper's `pos` table gives each slot's ring position, -1 for slot 0),
// each move one place forward per round. So a row never has to move: a
// column stores the row whose content started at ring position q at
// index q + 1 (slot 0's at 0), and at round r slot k's row sits at index
// 1 + (pos[k] - r mod (n - 1)). (2) V can be split off: A's rounds alone
// give every round's (c, s), and applying that log to V afterwards (a
// right-multiplication, under which V's rows are independent) gives the
// same bits as the joint iteration.
//
// `jacobi_cluster_kernel`: one cluster of C CTAs per matrix, all rounds in
// one launch, A resident in distributed shared memory. CTA k owns pairs
// [k p / C, (k + 1) p / C): the columns of those top and bottom slots, all
// rows, plus two staging columns; a column table maps each local slot to
// its buffer. Per round: (a) the owner of pair i computes (c_i, s_i) from
// its two local columns and stores it into every CTA's (c, s) table
// (`map_shared_rank`) and into the log; (c) cluster barrier; (d) each
// thread rotates the 2 x 2 blocks of one row pair over its share of the
// local column pairs (rows, then columns, in place), while one thread
// reads from the neighbours' column tables which buffers they send;
// (e) cluster barrier; (f) the exchange: tops move one slot right and
// bottoms one left, so each CTA pulls its incoming top column from its
// left neighbour and its incoming bottom column from its right one into
// its staging buffers and rewrites its column table (b0 -> t1 and
// t_{p-1} -> b_{p-1} stay inside the first and last CTA; the columns
// sent out become the next staging buffers). A staging buffer is written
// only in the round after the neighbour read it, and a (c, s) table only
// after every CTA passed the barrier behind its last read. After the last
// round each CTA writes its slots' diagonal entries, then a final cluster
// barrier keeps its shared memory alive for the neighbours' last pulls.
// `jacobi_vlog_kernel`: a CTA holds `vrows` rows of V (rows of the
// identity at the start) in shared memory and applies every round's
// column rotations from the log, prefetching round r + 1 with cp.async
// while it applies round r, with columns at the same ring-shifted indices
// as A's rows; no synchronisation between CTAs. At n = 652 the A kernel
// moves each CTA's 82 columns through shared memory twice per round (~428
// KB), so it is bound by shared-memory bandwidth and the two cluster
// barriers, not by device memory.
//
// Streaming path (larger n, `kfac_jacobi_eigh`): one launch per round; a
// thread owns the 2 x 2 block at (pair i, pair j) of A and of V, rotates
// it and stores each result straight to its slot after the exchange (an
// int32 destination table), and a block recomputes the (c, s) of its 32
// row pairs and 32 column pairs from the old A; A and V ping-pong between
// two buffers each. Every round moves A and V through L2 / device memory
// (4 B n^2 floats read or written); the host loop runs the stack in chunks
// small enough for a chunk's four buffers to stay in the 50 MB L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// Opt-in dynamic shared memory of one block on the H100.
constexpr int kSmemLimit = 232448;
constexpr int kClusterThreads = 1024;  // at most, per CTA of the A kernel
constexpr int kVThreads = 512;         // at most, per CTA of the V kernel

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


// ---------------------------------------------------------------------------
// Cluster path
// ---------------------------------------------------------------------------

// Storage index of slot k's row (or V column) after `roff` rounds, from
// its ring position pos_k (-1 for slot 0); roff in [0, m), m = n - 1.
__device__ __forceinline__ int ring_row(int pos_k, int roff, int m) {
  if (pos_k < 0) return 0;
  const int q = pos_k - roff;
  return (q < 0 ? q + m : q) + 1;
}

__host__ __device__ __forceinline__ int pair_begin(int k, int p, int c) {
  return static_cast<int>(static_cast<long long>(k) * p / c);
}

// A's rounds for one matrix per cluster; grid (C, matrices), cluster
// (C, 1, 1), block (32 ceil(p / 32)) x ct threads: thread (tx, ty) rotates
// row pair tx over the local column pairs ty, ty + ct, ... Dynamic shared
// memory: (2 nl_max + 2) columns of n floats, the p pairs' (c, s) (float2),
// the column table (2 nl + 2 ints: tops, bottoms, staging top, staging
// bottom) and the two incoming buffer indices.
__global__ void __launch_bounds__(kClusterThreads, 1) jacobi_cluster_kernel(
    const float* __restrict__ a, float* __restrict__ d_out,
    float2* __restrict__ log, const int* __restrict__ pos, int n,
    int rounds, int nl_max) {
  extern __shared__ float4 smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int p = n / 2, m = n - 1;
  const int nbuf = 2 * nl_max + 2;
  float* cols = reinterpret_cast<float*>(smem_raw);
  float2* cs = reinterpret_cast<float2*>(cols + static_cast<size_t>(nbuf) * n);
  int* tab = reinterpret_cast<int*>(cs + p);
  int* in_idx = tab + nbuf;
  const int csize = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int i0 = pair_begin(k, p, csize);
  const int nl = pair_begin(k + 1, p, csize) - i0;
  const size_t mat = blockIdx.y;
  a += mat * n * n;
  d_out += mat * n;
  log += mat * static_cast<size_t>(rounds) * p;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rt = (p + 31) / 32 * 32, ct = nthr / rt;
  const int tx = tid % rt, ty = tid / rt;

  // Columns of the local slots, rows at their ring indices.
  if (tid < 2 * nl + 2) tab[tid] = tid;
  for (int idx = tid; idx < 2 * nl * n; idx += nthr) {
    const int row = idx / (2 * nl), c = idx - row * (2 * nl);
    const int slot = c < nl ? i0 + c : p + i0 + (c - nl);
    cols[static_cast<size_t>(c) * n + ring_row(pos[row], 0, m)] =
        a[static_cast<size_t>(row) * n + slot];
  }
  // Ring positions of this thread's row pair and of its diagonal pair.
  const int row_lo = tx < p ? pos[tx] : 0, row_hi = tx < p ? pos[p + tx] : 0;
  const int dg_lo = tid < nl ? pos[i0 + tid] : 0;
  const int dg_hi = tid < nl ? pos[p + i0 + tid] : 0;
  // Every CTA of the cluster has started and loaded its columns.
  cluster.sync();

  int roff = 0;
  for (int r = 0; r < rounds; ++r) {
    // (a), (b): (c, s) of the local pairs, to every CTA and to the log.
    if (tid < nl) {
      const float* top = cols + static_cast<size_t>(tab[tid]) * n;
      const float* bot = cols + static_cast<size_t>(tab[nl + tid]) * n;
      const int lo = ring_row(dg_lo, roff, m), hi = ring_row(dg_hi, roff, m);
      float c, s;
      rotation(top[lo], bot[hi], bot[lo], &c, &s);
      const float2 v = make_float2(c, s);
      for (int q = 0; q < csize; ++q)
        cluster.map_shared_rank(cs, q)[i0 + tid] = v;
      log[static_cast<size_t>(r) * p + i0 + tid] = v;
    }
    cluster.sync();  // (c)
    // Which buffers the neighbours send this round (their tables change
    // only after the next barrier).
    if (p > 1 && tid == 0) {
      if (k > 0) {
        const int nl_left = i0 - pair_begin(k - 1, p, csize);
        in_idx[0] = cluster.map_shared_rank(tab, k - 1)[nl_left - 1];
      }
      if (k < csize - 1) {
        const int nl_right = pair_begin(k + 2, p, csize) - (i0 + nl);
        in_idx[1] = cluster.map_shared_rank(tab, k + 1)[nl_right];
      }
    }
    // (d): rows of pair tx, then the columns of each local pair.
    if (tx < p) {
      const float2 ri = cs[tx];
      const int lo = ring_row(row_lo, roff, m), hi = ring_row(row_hi, roff, m);
      for (int j = ty; j < nl; j += ct) {
        const float2 cj = cs[i0 + j];
        float* tb = cols + static_cast<size_t>(tab[j]) * n;
        float* bb = cols + static_cast<size_t>(tab[nl + j]) * n;
        const float a00 = tb[lo], a10 = tb[hi], a01 = bb[lo], a11 = bb[hi];
        const float b00 = rot_lo(ri.x, ri.y, a00, a10);
        const float b10 = rot_hi(ri.x, ri.y, a00, a10);
        const float b01 = rot_lo(ri.x, ri.y, a01, a11);
        const float b11 = rot_hi(ri.x, ri.y, a01, a11);
        tb[lo] = rot_lo(cj.x, cj.y, b00, b01);
        bb[lo] = rot_hi(cj.x, cj.y, b00, b01);
        tb[hi] = rot_lo(cj.x, cj.y, b10, b11);
        bb[hi] = rot_hi(cj.x, cj.y, b10, b11);
      }
    }
    cluster.sync();  // (e)
    // (f): the exchange (none at p = 1, as in the plain loop).
    if (p > 1) {
      const int st = tab[2 * nl], sb = tab[2 * nl + 1];
      int next = 0;
      if (tid < nl) {  // new top tid
        next = k == 0 ? (tid == 0 ? tab[0] : tid == 1 ? tab[nl] : tab[tid - 1])
                      : (tid == 0 ? st : tab[tid - 1]);
      } else if (tid < 2 * nl) {  // new bottom tid - nl
        const int t = tid - nl;
        next = t < nl - 1 ? tab[nl + t + 1]
                          : (k == csize - 1 ? tab[nl - 1] : sb);
      } else if (tid == 2 * nl) {
        next = k > 0 ? tab[nl] : st;
      } else if (tid == 2 * nl + 1) {
        next = k < csize - 1 ? tab[nl - 1] : sb;
      }
      if (k > 0) {
        const float* src = cluster.map_shared_rank(cols, k - 1) +
                           static_cast<size_t>(in_idx[0]) * n;
        float* dst = cols + static_cast<size_t>(st) * n;
        for (int q = tid; q < n; q += nthr) dst[q] = src[q];
      }
      if (k < csize - 1) {
        const float* src = cluster.map_shared_rank(cols, k + 1) +
                           static_cast<size_t>(in_idx[1]) * n;
        float* dst = cols + static_cast<size_t>(sb) * n;
        for (int q = tid; q < n; q += nthr) dst[q] = src[q];
      }
      __syncthreads();
      if (tid < 2 * nl + 2) tab[tid] = next;
      __syncthreads();
    }
    if (++roff == m) roff = 0;
  }
  if (tid < nl) {
    d_out[i0 + tid] = cols[static_cast<size_t>(tab[tid]) * n +
                           ring_row(dg_lo, roff, m)];
    d_out[p + i0 + tid] = cols[static_cast<size_t>(tab[nl + tid]) * n +
                               ring_row(dg_hi, roff, m)];
  }
  // No CTA leaves while a neighbour may still read its shared memory.
  cluster.sync();
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(addr),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// V from the log: rows [blockIdx.x vrows, + vrows) of matrix blockIdx.y;
// block (32 ceil(p / 32), by): thread x owns pair x, rows y, y + by, ...
// Dynamic shared memory: vrows rows of n floats, then two rounds of the
// log (2 p float2).
__global__ void __launch_bounds__(kVThreads) jacobi_vlog_kernel(
    const float2* __restrict__ log, const int* __restrict__ pos,
    float* __restrict__ v_out, int n, int rounds, int vrows) {
  extern __shared__ float4 smem_raw[];
  const int p = n / 2, m = n - 1;
  float* v = reinterpret_cast<float*>(smem_raw);
  float2* lbuf = reinterpret_cast<float2*>(v + static_cast<size_t>(vrows) * n);
  const size_t mat = blockIdx.y;
  const int row0 = blockIdx.x * vrows;
  const int nrows = min(vrows, n - row0);
  log += mat * static_cast<size_t>(rounds) * p;
  v_out += (mat * n + row0) * n;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  for (int idx = tid; idx < nrows * n; idx += nthr) v[idx] = 0.0f;
  __syncthreads();
  for (int rho = tid; rho < nrows; rho += nthr)
    v[static_cast<size_t>(rho) * n + ring_row(pos[row0 + rho], 0, m)] = 1.0f;
  const int i = threadIdx.x;
  const int pos_lo = i < p ? pos[i] : 0, pos_hi = i < p ? pos[p + i] : 0;
  if (rounds > 0 && tid < p) cp_async8(&lbuf[tid], &log[tid]);
  cp_async_commit();
  int roff = 0;
  for (int r = 0; r < rounds; ++r) {
    if (r + 1 < rounds && tid < p)
      cp_async8(&lbuf[((r + 1) & 1) * p + tid],
                &log[static_cast<size_t>(r + 1) * p + tid]);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (i < p) {
      const float2 c = lbuf[(r & 1) * p + i];
      const int lo = ring_row(pos_lo, roff, m), hi = ring_row(pos_hi, roff, m);
      for (int rho = threadIdx.y; rho < nrows; rho += blockDim.y) {
        float* row = v + static_cast<size_t>(rho) * n;
        const float x = row[lo], y = row[hi];
        row[lo] = rot_lo(c.x, c.y, x, y);
        row[hi] = rot_hi(c.x, c.y, x, y);
      }
    }
    __syncthreads();
    if (++roff == m) roff = 0;
  }
  __syncthreads();  // (for rounds = 0: the identity's entries)
  for (int idx = tid; idx < nrows * n; idx += nthr) {
    const int rho = idx / n, col = idx - rho * n;
    v_out[idx] = v[static_cast<size_t>(rho) * n + ring_row(pos[col], roff, m)];
  }
}

int cluster_nl_max(int n, int csize) {
  const int p = n / 2;
  return (p + csize - 1) / csize;
}

size_t cluster_smem(int n, int csize) {  // = ops.kernels.jacobi_cluster_bytes
  const int p = n / 2, nl = cluster_nl_max(n, csize);
  return 4 * static_cast<size_t>(2 * nl + 2) * n + 8 * static_cast<size_t>(p) +
         4 * static_cast<size_t>(2 * nl + 4);
}

cudaLaunchConfig_t cluster_config(int n, int csize, int count,
                                  cudaStream_t st, cudaLaunchAttribute* attr) {
  const int p = n / 2, rt = (p + 31) / 32 * 32;
  int ct = kClusterThreads / rt;
  if (ct > cluster_nl_max(n, csize)) ct = cluster_nl_max(n, csize);
  if (ct < 1) ct = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, count, 1);
  cfg.blockDim = dim3(rt * ct, 1, 1);
  cfg.dynamicSmemBytes = cluster_smem(n, csize);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool cluster_args_ok(int n, int csize) {
  const int p = n / 2;
  return n >= 2 && n % 2 == 0 &&
         (csize == 1 || csize == 2 || csize == 4 || csize == 8) &&
         (csize == 1 || p >= 2 * csize) && (p + 31) / 32 * 32 <= kVThreads &&
         cluster_smem(n, csize) <= static_cast<size_t>(kSmemLimit);
}

// Max active clusters of the A kernel at (n, csize), after raising its
// shared-memory limit; 0 and an error code on failure.
int cluster_occupancy(int n, int csize, cudaStream_t st, int* out) {
  *out = 0;
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cluster_smem(n, csize)));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(n, csize, 1, st, attr);
  err = cudaOccupancyMaxActiveClusters(out, jacobi_cluster_kernel, &cfg);
  return static_cast<int>(err);
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

// Cluster path for `batch` matrices (at most 65535): a (batch, n, n) padded
// stack in, diag(A) (batch, n) and V (batch, n, n) in the final slot order
// out; `log` holds batch * rounds * (n / 2) float2; `pos` is the ring
// position table. Returns the first CUDA error, cudaErrorInvalidValue for
// arguments this path does not take, and
// cudaErrorInvalidConfiguration when the card holds no cluster of this
// shape; else 0.
extern "C" int kfac_jacobi_eigh_cluster(const float* a, float* d, float* v,
                                        void* log, const int* pos, int batch,
                                        int n, int rounds, int csize,
                                        int vrows, void* stream) {
  if (!cluster_args_ok(n, csize) || batch < 1 || batch > 65535 ||
      rounds < 0 || vrows < 1 || vrows > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int active = 0;
  int err = cluster_occupancy(n, csize, st, &active);
  if (err != 0) return err;
  if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(n, csize, batch, st, attr);
  float2* lg = static_cast<float2*>(log);
  cudaError_t e = cudaLaunchKernelEx(&cfg, jacobi_cluster_kernel, a, d, lg,
                                     pos, n, rounds,
                                     cluster_nl_max(n, csize));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int p = n / 2, bx = (p + 31) / 32 * 32;
  int by = kVThreads / bx;
  if (by > vrows) by = vrows;
  const size_t vsmem =
      4 * static_cast<size_t>(vrows) * n + 16 * static_cast<size_t>(p);
  if (vsmem > static_cast<size_t>(kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(jacobi_vlog_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(vsmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + vrows - 1) / vrows, batch);
  jacobi_vlog_kernel<<<grid, dim3(bx, by), vsmem, st>>>(lg, pos, v, n, rounds,
                                                        vrows);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the A kernel at (n, csize) the card holds at once.
extern "C" int kfac_jacobi_cluster_occupancy(int n, int csize,
                                             int* max_clusters) {
  if (!cluster_args_ok(n, csize))
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_occupancy(n, csize, 0, max_clusters);
}
