// Phase-profile build of the two MO-product kernels (sparse_mo.cu,
// screened_mo.cu): the same code, with MO_TILE_MARK recording clock64() on
// thread 0 of each block at the phase boundaries of mo_tile.cuh's first
// window (marks 0-5: start, compaction, window end, bitmap trim, union
// prefix, union ids and offsets; then 6 + 3 s, 7 + 3 s and 8 + 3 s for
// stage s's copy wait, the next stage's copies issued, and its products
// and stores; 30: end of the window) and the block's number of windows in
// slot 31.  Not on the main path; chip_phases.py builds and reads it.

#include <cuda_runtime.h>

#define MO_TILE_MAX_BLOCKS 16384
#define MO_TILE_MARKS 32

__device__ long long mo_tile_marks[MO_TILE_MAX_BLOCKS * MO_TILE_MARKS];

#define MO_TILE_MARK(k)                                                 \
  if (threadIdx.x == 0 && blockIdx.x < MO_TILE_MAX_BLOCKS && window == 0) \
    mo_tile_marks[blockIdx.x * MO_TILE_MARKS + (k)] = clock64();
#define MO_TILE_WINDOWS(n)                                  \
  if (threadIdx.x == 0 && blockIdx.x < MO_TILE_MAX_BLOCKS)  \
    mo_tile_marks[blockIdx.x * MO_TILE_MARKS + 31] = (n);

#include "sparse_mo.cu"
#include "screened_mo.cu"

// Copy the marks of the first n blocks (n * MO_TILE_MARKS values) to out.
extern "C" int mo_tile_phases_read(long long* out, int n) {
  if (n > MO_TILE_MAX_BLOCKS) n = MO_TILE_MAX_BLOCKS;
  return (int)cudaMemcpyFromSymbol(
      out, mo_tile_marks, (size_t)n * MO_TILE_MARKS * sizeof(long long));
}
