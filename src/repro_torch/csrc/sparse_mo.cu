// Sparse MO product from the AO pass's rows for Hopper (sm_90a), fp32 on the
// CUDA cores.
//
// Replaces: src/repro/kernels/sparse_mo/kernel.py::sparse_mo_matmul, the
// Pallas TPU kernel behind repro.kernels.sparse_mo.ops.sparse_mo_products.
//
// What it computes.  A is the dense (n_orb, n_ao) MO coefficient matrix,
// read as At = A transposed, (n_ao, ld), zero padded to whole orbital
// stages.  B is the AO pass's own layout, (N, n_ao, 5) with the five
// components (value, d/dx, d/dy, d/dz, laplacian) of AO j at electron e in
// B[e, j, :], and mask (N, n_ao) marks the active AOs (B is zero
// elsewhere, but the kernel never reads B there: NaN stored there cannot
// reach C).  C[o, e, c] = sum over active j, ascending, of A[o, j] B[e, j, c];
// C is (n_orb, N, 5).
//
// What the TPU kernel did.  A grid over (electron tile, orbital tile) with
// a scalar-prefetched list of the k-tiles (rows of B2d, the (n_ao, 5N)
// transpose of B) that hold any nonzero; it skipped only all-zero
// (electron tile, k-tile) pairs.
//
// What bounds it.  fp32 without TF32 runs on the CUDA cores (67 TFLOP/s on
// an H100 SXM).  At the micro-peptide ensemble (n_orb 79, n_ao 346, N =
// 256 * 158 = 40448) each electron has 95.6 of the 346 AOs active: 3.06
// GFLOP (0.046 ms) against 0.14 GB (0.042 ms), so the arithmetic bounds it.
// The dense product is 11.06 GFLOP; chip_smoke.py computes the bound from
// its inputs.  In the walker-major order 16 consecutive electrons of a
// walker span the whole molecule, so a k-tile skip saved nothing there
// (27 783 of 27 808 pairs active): the caller now sorts the electrons by
// their nearest atom, and a block works on a tile of 32 electrons that
// share ~161 AO rows.
//
// Design: mo_tile.cuh (tiles of sorted electrons, per-electron compacted
// lists, the tile's union of At rows in shared memory, double-buffered
// orbital stages, C written electron-major and read as (n_orb, N, 5)).
// This file adds the source: the mask row of electron order[e] is scanned
// with one byte per lane, and an active AO's five values are the
// contiguous 20 bytes B[e, j, :].  Reading the rows layout directly saves
// the (N, n_ao, 5) -> (n_ao, N, 5) copy the TPU layout needed.  fp32 on
// the CUDA cores only (no TF32, no 3xTF32): the result equals any
// ascending fmaf chain over the same active AOs bit for bit, e.g. the
// screened kernel's on the same active sets.

#include "mo_tile.cuh"

struct RowsSource {
  static constexpr bool kIdIsPosition = true;
  const uint8_t* mask;   // (N, n_ao)
  const float* B;        // (N, n_ao, 5)
  int n_ao;
  __device__ __forceinline__ bool active(int ge, int p) const {
    return mask[(size_t)ge * n_ao + p] != 0;
  }
  __device__ __forceinline__ int id(int, int p) const { return p; }
  __device__ __forceinline__ const float* values(int ge, int p) const {
    return B + ((size_t)ge * n_ao + p) * 5;
  }
};

extern "C" int sparse_mo_config(int* out) {
  out[0] = mo_tile::TE;
  out[1] = mo_tile::OPT;
  out[2] = mo_tile::MAX_STAGE;
  return 0;
}

// {osw, n_stages, threads, lcap, ucap, smem bytes} of a launch.
extern "C" int sparse_mo_plan(int n_orb, int n_ao, int* out) {
  return mo_tile::plan_out(n_orb, n_ao, n_ao, out);
}

// At (n_ao, ld), B (N, n_ao, 5), C (N, ld, 5): fp32 row-major; mask
// (N, n_ao) bytes 0/1; order (N,) int32, a permutation of 0..N-1.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int sparse_mo_launch(const void* At, long long ld, const void* B,
                                const void* mask, const void* order, void* C,
                                int n_orb, int n_ao, long long N,
                                void* stream) {
  mo_tile::Args a{};
  a.At = (const float*)At;
  a.ld = ld;
  a.order = (const int*)order;
  a.C = (float*)C;
  a.N = N;
  a.n_orb = n_orb;
  a.n_ids = n_ao;
  a.P = n_ao;
  const RowsSource src{(const uint8_t*)mask, (const float*)B, n_ao};
  return mo_tile::launch(a, src, (cudaStream_t)stream);
}
