// Phase-profile build of the fused-sweep kernels (fused_sweep.cu): the same
// code, with FS_MARK recording clock64() on thread 0 of each block and
// summing, per block over the sweep, the SM cycles spent in each phase:
//   9  the pass's dot products and their shuffles (rows route)
//   10 the pass's e-e pairs (thread 0's share) and S_old's terms (rows)
//   0  the rest of the pass: row e's raw columns, g, the warp sums (rows
//      route); the ratio and e-e block reduction with its barrier (tables
//      routes)
//   1  waiting for phi: the wait for the next row's copy (rows); the load
//      of the move's row from device memory and its barrier (tables)
//   2  the barrier that closes the pass (rows)
//   8  the decision: the slot sums, the logs, the test (rows); the test
//      (tables)
//   5  the division of row e and its barrier (rows: every move with CI,
//      accepted moves without); u = Minv phi, the division and their
//      barrier (tables, accepted moves)
//   4  the CI determinants, S_new and their barrier
//   11 the cluster route's CI: the held rows' g and its sends
//   3  the update (accepted moves)
//   6  before the first move (loads), 7 after the last (stores)
// Not on the main path; chip_phases.py builds and reads it.

#include <cuda_runtime.h>

#define FS_MAX_BLOCKS 4096
#define FS_PHASES 12

__device__ unsigned long long fs_phase_cycles[FS_MAX_BLOCKS * FS_PHASES];

#define FS_PHASE_MARKS
#define FS_CLOCK_INIT                                            \
  long long fs_t = clock64();                                    \
  long long fs_acc[FS_PHASES] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#define FS_MARK(k)                                               \
  if (threadIdx.x == 0) {                                        \
    const long long fs_now = clock64();                          \
    fs_acc[k] += fs_now - fs_t;                                  \
    fs_t = fs_now;                                               \
  }
#define FS_CLOCK_FLUSH                                                     \
  if (threadIdx.x == 0 && blockIdx.x < FS_MAX_BLOCKS)                      \
    for (int q = 0; q < FS_PHASES; ++q)                                    \
      fs_phase_cycles[blockIdx.x * FS_PHASES + q] =                        \
          (unsigned long long)fs_acc[q];

#include "fused_sweep.cu"

// Copy the phase sums of the first n blocks (n * FS_PHASES values) to out.
extern "C" int fused_sweep_phases_read(unsigned long long* out, int n) {
  if (n > FS_MAX_BLOCKS) n = FS_MAX_BLOCKS;
  return (int)cudaMemcpyFromSymbol(
      out, fs_phase_cycles, (size_t)n * FS_PHASES * sizeof(long long));
}
