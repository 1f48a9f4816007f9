// Batched rank-1 Sherman-Morrison update for Hopper (sm_90a), fp32, in place.
//
// Replaces: src/repro/kernels/sem_update/kernel.py::sem_update_matmul, the
// Pallas TPU kernel behind repro.kernels.sem_update.ops.sem_rank1_update.
//
// What it computes.  For every walker w with accept[w] != 0:
//     minv[w] <- minv[w] - outer(u[w], row[w]);   minv[w, j] <- row[w]
// over the (W, n, n) ensemble of running inverses.  Rejected walkers are
// left untouched (NaN/Inf in their row never reaches memory).  Unlike the
// JAX version, which returns a new array, the update is IN PLACE: the
// sweep's carry is the only holder of minv.
//
// What bounds it.  Two flops per element against one 4-byte read and one
// write: memory.  At W = 256, n = 79, all accepted, it moves ~12.8 MB, ~4 us
// at 3.35 TB/s; it runs once per electron move, n_e = 158 times a sweep.
//
// Design.  One 256-thread block per (walker, band of 16 rows); a rejected
// walker's blocks return before touching memory, so the traffic follows the
// acceptance rate.  Consecutive threads take consecutive elements of the
// band, so the read and the write of minv are coalesced; u and row are
// read through the cache.  No padding: n = 79 stays 79.  The product is
// rounded before the subtraction (no FMA contraction), so the result is
// bitwise the plain PyTorch version's minv - u * row.

#include <cuda_runtime.h>
#include <stdint.h>

#define ROWS_PER_BLOCK 16
#define NTHREADS 256

__global__ void __launch_bounds__(NTHREADS)
sem_update_kernel(float* __restrict__ minv, const float* __restrict__ u,
                  const float* __restrict__ row,
                  const uint8_t* __restrict__ accept, int n, int j) {
  const long long w = blockIdx.x;
  if (!accept[w]) return;
  const int r0 = blockIdx.y * ROWS_PER_BLOCK;
  const int r1 = min(r0 + ROWS_PER_BLOCK, n);
  float* M = minv + w * (size_t)n * (size_t)n;
  const float* uw = u + w * (size_t)n;
  const float* rw = row + w * (size_t)n;
  const int count = (r1 - r0) * n;
  for (int i = threadIdx.x; i < count; i += NTHREADS) {
    const int rr = r0 + i / n, c = i % n;
    const size_t off = (size_t)rr * n + c;
    const float rv = __ldg(rw + c);
    M[off] = (rr == j) ? rv : __fsub_rn(M[off], __fmul_rn(__ldg(uw + rr), rv));
  }
}

// minv (W, n, n), u (W, n), row (W, n): fp32 contiguous; accept (W,) bytes.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int sem_update_launch(void* minv, const void* u, const void* row,
                                 const void* accept, int W, int n, int j,
                                 void* stream) {
  if (W > 0 && n > 0) {
    dim3 grid((unsigned int)W, (unsigned int)((n + ROWS_PER_BLOCK - 1)
                                              / ROWS_PER_BLOCK));
    sem_update_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (float*)minv, (const float*)u, (const float*)row,
        (const uint8_t*)accept, n, j);
  }
  return (int)cudaGetLastError();
}
