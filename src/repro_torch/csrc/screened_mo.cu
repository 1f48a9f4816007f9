// Screened MO product from packed candidate lists for Hopper (sm_90a), fp32
// on the CUDA cores.
//
// Replaces: src/repro/kernels/screened_mo/kernel.py::screened_mo_matmul, the
// Pallas TPU kernel behind repro.kernels.screened_mo.ops.screened_mo_products.
//
// What it computes.  The distance-screened pipeline (core/screening.py)
// gives every electron e a static-budget row of K candidate AO ids idx[e]
// (ascending, padded with 0), an activity mask active[e] (candidate inside
// its AO cutoff) and the packed AO block Bp[e, k, 0..4] (value, d/dx,
// d/dy, d/dz, laplacian).  With A the dense (n_orb, n_ao) MO matrix, read
// as At = A transposed, (n_ao, ld), zero padded to whole orbital stages:
//     C[o, e, c] = sum over active slots k of A[o, idx[e, k]] * Bp[e, k, c]
// for the five components c, summed in ascending slot (= AO) order.
// Inactive slots are never read, so whatever they hold (the NaN of a
// poisoned input) cannot reach C, and an electron with no active slot gets
// an exactly zero column.
//
// What the TPU kernel did.  A grid over (electron tile, orbital tile,
// k-chunk) with 128-lane tiles: per step it gathered A's candidate columns
// for a whole (tile_e, tile_k) chunk and contracted them on the MXU,
// skipping only chunks where no slot was active (a scalar-prefetched
// table); a chunk with one active slot cost as much as a full one.
//
// What bounds it.  fp32 without TF32 runs on the CUDA cores (67 TFLOP/s on
// an H100 SXM).  The work follows the active pairs: 2 * n_orb * 5 FLOP per
// pair.  At the b-strand (n_orb 217, n_ao 952, W = 256: N = 111 104
// electrons, K = 200 candidates at eps = 1e-8, ~67 active) that is ~16
// GFLOP, 0.24 ms; the bytes it must move (the active Bp values, idx, the
// mask and C written once, ~0.74 GB) take ~0.22 ms at 3.35 TB/s.  The first
// version of this kernel read each electron's At rows from L2 (~6.4 GB of
// L2 reads), which held it at 7.8 TFLOP/s.  chip_smoke.py computes the
// bound from its inputs.
//
// Design: mo_tile.cuh.  The caller sorts the electrons by their nearest
// atom; a tile of 32 such electrons needs ~126 distinct At rows (of 952),
// staged once per orbital stage in shared memory instead of ~67 per
// electron from L2, and C is written electron-major in whole sectors.  This file adds the source: one warp scans an
// electron's K slots (active byte and id per lane); an active slot's five
// values are the contiguous 20 bytes Bp[e, k, :].  Any K runs: lists
// longer than a stage are taken in windows of ascending AO ids.  fp32 on
// the CUDA cores only (no TF32, no 3xTF32): the result equals any
// ascending fmaf chain over the same active AOs bit for bit, e.g. the
// unscreened kernel's (sparse_mo.cu) on the same active sets.

#include "mo_tile.cuh"

struct PackedSource {
  static constexpr bool kIdIsPosition = false;
  const uint8_t* act;    // (N, K)
  const int* idx;        // (N, K)
  const float* Bp;       // (N, K, 5)
  int K;
  __device__ __forceinline__ bool active(int ge, int p) const {
    return act[(size_t)ge * K + p] != 0;
  }
  __device__ __forceinline__ int id(int ge, int p) const {
    return idx[(size_t)ge * K + p];
  }
  __device__ __forceinline__ const float* values(int ge, int p) const {
    return Bp + ((size_t)ge * K + p) * 5;
  }
};

extern "C" int screened_mo_config(int* out) {
  out[0] = mo_tile::TE;
  out[1] = mo_tile::OPT;
  out[2] = mo_tile::MAX_STAGE;
  return 0;
}

// {osw, n_stages, threads, lcap, ucap, smem bytes} of a launch.
extern "C" int screened_mo_plan(int n_orb, int n_ao, int K, int* out) {
  return mo_tile::plan_out(n_orb, n_ao, K, out);
}

// At (n_ao, ld), Bp (N, K, 5), C (N, ld, 5): fp32 row-major; idx (N, K)
// int32 with every active id in [0, n_ao), strictly ascending over an
// electron's active slots; active (N, K) bytes 0/1; order (N,) int32, a
// permutation of 0..N-1.  Launches on `stream`; returns cudaGetLastError().
extern "C" int screened_mo_launch(const void* At, long long ld,
                                  const void* Bp, const void* idx,
                                  const void* active, const void* order,
                                  void* C, int n_orb, int n_ao, long long N,
                                  int K, void* stream) {
  mo_tile::Args a{};
  a.At = (const float*)At;
  a.ld = ld;
  a.order = (const int*)order;
  a.C = (float*)C;
  a.N = N;
  a.n_orb = n_orb;
  a.n_ids = n_ao;
  a.P = K;
  const PackedSource src{(const uint8_t*)active, (const int*)idx,
                         (const float*)Bp, K};
  return mo_tile::launch(a, src, (cudaStream_t)stream);
}
