// Block-sparse MO product C = A * B2d for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces: src/repro/kernels/sparse_mo/kernel.py::sparse_mo_matmul, the
// Pallas TPU kernel behind repro.kernels.sparse_mo.ops.sparse_mo_products.
//
// What it computes.  A is the dense (n_orb, n_ao) MO coefficient matrix;
// B2d is the (n_ao, 5N) AO block, electron-major with 5 contiguous columns
// per electron (value, d/dx, d/dy, d/dz, laplacian).  For each electron
// tile the caller lists the k-tiles (rows of B2d) that hold any nonzero:
// block_ids (e_tiles, max_kb) with num_active (e_tiles,) valid entries.
// C[o, cols(e)] = sum over listed k-tiles of A[o, k-tile] * B2d[k-tile, cols(e)].
//
// What bounds it.  fp32 without TF32 runs on the CUDA cores (67 TFLOP/s on
// an H100 SXM), not on the tensor cores.  At the micro-peptide ensemble
// (n_orb 79, n_ao 346, N = 256 * 158 = 40448 electrons, 5N = 202240
// columns) the dense product is 11.06 GFLOP against 0.34 GB of B2d and C.
// What the data needs is less: each electron has 95.6 of the 346 AOs
// active on average, so 3.06 GFLOP and 0.14 GB, i.e. 0.046 ms of FMA
// against 0.042 ms of memory: the arithmetic bounds it (chip_smoke.py's
// kernels line on an H100 80GB HBM3 computes these from its inputs).
// The kernel reaches that bound only if it skips inactive k-tiles, and at
// these tiles it skips nothing: in the walker-major electron order, 16
// consecutive electrons of one walker are spread over the whole molecule,
// and 27783 of the 27808 (electron tile, k-tile) pairs were active in a
// cold-start ensemble.  So it does the dense work, on the CUDA cores.
//
// Design.  One 128-thread block per (electron tile, orbital tile) output
// tile: 16 electrons (80 columns) by 40 orbitals.  The block reads its own
// row of block_ids (no scalar prefetch on the card) and loops over its
// active k-tiles; each step stages a 32-row A panel (transposed, padded
// against bank conflicts) and the matching 32 x 80 B2d panel in shared
// memory, coalesced along the contiguous axis.  Each thread keeps a
// 5 orbital x 5 column register tile (one electron's five components for
// five orbitals): 10 shared loads feed 25 FMAs.  C is written once.
// Electron tiles that are local in space (sorting the flattened electrons
// by position) would let the skip work; that is not done yet.
// Offsets into B2d and C are 64-bit: n_ao * 5N passes 2^31 on the paper's
// larger systems.  Ragged edges (n_orb, n_ao, 5N not multiples of the
// tile) are masked in the loads and the store; nothing is padded.
// A simple, correct kernel: no double buffering, TMA or wgmma yet.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_O 40                 // orbitals per block
#define TILE_E 16                 // electrons per block
#define TILE_K 32                 // AO rows per k-tile
#define COLS (TILE_E * 5)         // B2d / C columns per block
#define NTX TILE_E                // thread columns: one electron each
#define NTY 8                     // thread rows
#define RO (TILE_O / NTY)         // orbitals per thread (5)
#define NTHREADS (NTX * NTY)      // 128

__global__ void __launch_bounds__(NTHREADS)
sparse_mo_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 const int* __restrict__ block_ids,
                 const int* __restrict__ num_active, float* __restrict__ C,
                 int n_orb, int n_ao, long long n_cols, int o_tiles,
                 int max_kb) {
  __shared__ float As[TILE_K][TILE_O + 1];
  __shared__ float Bs[TILE_K][COLS];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const long long e_tile = blockIdx.x / o_tiles;
  const int o0 = (blockIdx.x % o_tiles) * TILE_O;
  const long long col0 = e_tile * COLS;

  float acc[RO][5];
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int c = 0; c < 5; ++c) acc[r][c] = 0.f;

  const int nact = num_active[e_tile];
  const int* ids = block_ids + e_tile * (long long)max_kb;
  for (int t = 0; t < nact; ++t) {
    const int k0 = ids[t] * TILE_K;
    for (int i = tid; i < TILE_O * TILE_K; i += NTHREADS) {
      const int kk = i % TILE_K, o = i / TILE_K;
      const int go = o0 + o, gk = k0 + kk;
      As[kk][o] = (go < n_orb && gk < n_ao)
                      ? A[(size_t)go * n_ao + gk] : 0.f;
    }
    for (int i = tid; i < TILE_K * COLS; i += NTHREADS) {
      const int c = i % COLS, kk = i / COLS;
      const int gk = k0 + kk;
      const long long gc = col0 + c;
      Bs[kk][c] = (gk < n_ao && gc < n_cols)
                      ? B[(size_t)gk * (size_t)n_cols + (size_t)gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TILE_K; ++kk) {
      float a[RO], b[5];
#pragma unroll
      for (int r = 0; r < RO; ++r) a[r] = As[kk][ty + NTY * r];
#pragma unroll
      for (int c = 0; c < 5; ++c) b[c] = Bs[kk][tx * 5 + c];
#pragma unroll
      for (int r = 0; r < RO; ++r)
#pragma unroll
        for (int c = 0; c < 5; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int go = o0 + ty + NTY * r;
    if (go >= n_orb) continue;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const long long gc = col0 + tx * 5 + c;
      if (gc < n_cols) C[(size_t)go * (size_t)n_cols + (size_t)gc] = acc[r][c];
    }
  }
}

extern "C" int sparse_mo_tiles(int* out) {
  out[0] = TILE_O;
  out[1] = TILE_K;
  out[2] = TILE_E;
  return 0;
}

// A (n_orb, n_ao), B (n_ao, n_cols), C (n_orb, n_cols): fp32 row-major.
// block_ids (e_tiles, max_kb), num_active (e_tiles,): int32, e_tiles =
// ceil(n_cols / COLS).  Launches on `stream`; returns cudaGetLastError().
extern "C" int sparse_mo_launch(const void* A, const void* B,
                                const void* block_ids, const void* num_active,
                                void* C, int n_orb, int n_ao,
                                long long n_cols, int e_tiles, int max_kb,
                                void* stream) {
  const int o_tiles = (n_orb + TILE_O - 1) / TILE_O;
  const long long blocks = (long long)e_tiles * o_tiles;
  if (blocks > 0) {
    sparse_mo_kernel<<<(unsigned int)blocks, NTHREADS, 0,
                       (cudaStream_t)stream>>>(
        (const float*)A, (const float*)B, (const int*)block_ids,
        (const int*)num_active, (float*)C, n_orb, n_ao, n_cols, o_tiles,
        max_kb);
  }
  return (int)cudaGetLastError();
}
