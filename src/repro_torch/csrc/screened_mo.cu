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
// d/dy, d/dz, laplacian).  With A the dense (n_orb, n_ao) MO matrix:
//     C[o, e, c] = sum over active slots k of A[o, idx[e, k]] * Bp[e, k, c]
// for the five components c.  Inactive slots are never read, so whatever
// they hold (the NaN of a poisoned input) cannot reach C, and an electron
// with no active slot gets an exactly zero column.
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
// electrons, K = 200 candidates at eps = 1e-8, ~64 active) that is ~15
// GFLOP, 0.23 ms; the bytes it must move (the active Bp values, idx, the
// mask and C written once, ~0.7 GB) take ~0.2 ms at 3.35 TB/s.  The dense
// product it replaces is 229 GFLOP.  chip_smoke.py computes both bounds
// from its inputs.
//
// Design (simple and right first).  One 256-thread block per tile of TE
// electrons (8, fewer when K is so large that the tile's lists do not fit
// the shared-memory opt-in):
//  * Compaction: one warp per electron walks its K slots 32 at a time; a
//    ballot and a popcount prefix place each active slot's (AO id, 5
//    values) into shared memory, in the candidate list's ascending order.
//  * Products: A is read from its transpose At (n_ao, n_orb), made once
//    per parameters by the wrapper, so a gathered AO row is contiguous
//    across the threads of a warp; At (826 KB at the b-strand) stays in the
//    50 MB L2.  Orbitals go in stages of 64: the block's items are (electron,
//    orbital) pairs, a warp holds 32 orbitals of one electron, and each
//    thread sums its electron's active list in ascending order into 5 fp32
//    accumulators (one At load feeds 5 FMAs; the list entry is a broadcast
//    read from shared memory).  The sum order is fixed, so the result is
//    deterministic.
//  * Output: each stage is written to a (64, TE * 5 + 1) shared tile (the
//    +1 avoids bank conflicts), then copied to C (n_orb, N, 5) along the
//    contiguous N * 5 axis.
// Offsets into Bp, idx and C are 64-bit.  The ragged edges (N not a
// multiple of TE, n_orb not a multiple of 64) are masked; nothing is padded.
// No cp.async, TMA or reuse of At rows across electrons yet.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_E 8          // electrons per block (at most)
#define ORB_STAGE 64      // orbitals per output stage
#define NTHREADS 256
#define FULL_MASK 0xffffffffu

__host__ __device__ inline size_t tile_bytes(int te, int K) {
  return (size_t)te * 4                       // active counts
         + (size_t)te * K * 4                 // compacted AO ids
         + (size_t)te * K * 5 * 4             // compacted values
         + (size_t)ORB_STAGE * (te * 5 + 1) * 4;  // output stage
}

__global__ void __launch_bounds__(NTHREADS)
screened_mo_kernel(const float* __restrict__ At, const float* __restrict__ Bp,
                   const int* __restrict__ idx,
                   const uint8_t* __restrict__ active, float* __restrict__ C,
                   int n_orb, long long N, int K, int te) {
  extern __shared__ float smem[];
  int* cnt = (int*)smem;
  int* ids = cnt + te;
  float* vals = (float*)(ids + (size_t)te * K);
  float* stage = vals + (size_t)te * K * 5;
  const int srow = te * 5 + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long e0 = (long long)blockIdx.x * te;

  // compaction of each electron's active slots, in ascending slot order
  for (int e = warp; e < te; e += NTHREADS / 32) {
    const long long ge = e0 + e;
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const size_t s = (size_t)ge * K + k;
      const bool act = ge < N && k < K && active[s] != 0;
      const unsigned m = __ballot_sync(FULL_MASK, act);
      if (act) {
        const int pos = n + __popc(m & ((1u << lane) - 1u));
        ids[(size_t)e * K + pos] = idx[s];
        const float* b = Bp + s * 5;
        float* v = vals + ((size_t)e * K + pos) * 5;
#pragma unroll
        for (int c = 0; c < 5; ++c) v[c] = b[c];
      }
      n += __popc(m);
    }
    if (lane == 0) cnt[e] = n;
  }
  __syncthreads();

  const long long n_cols = N * 5;
  const int items = te * ORB_STAGE;
  for (int o0 = 0; o0 < n_orb; o0 += ORB_STAGE) {
    for (int it = tid; it < items; it += NTHREADS) {
      const int e = it / ORB_STAGE, ol = it % ORB_STAGE;
      const int o = o0 + ol;
      float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (o < n_orb) {
        const int n = cnt[e];
        const int* id = ids + (size_t)e * K;
        const float* v = vals + (size_t)e * K * 5;
#pragma unroll 4
        for (int t = 0; t < n; ++t) {
          const float a = At[(size_t)id[t] * n_orb + o];
#pragma unroll
          for (int c = 0; c < 5; ++c) acc[c] = fmaf(a, v[t * 5 + c], acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) stage[ol * srow + e * 5 + c] = acc[c];
    }
    __syncthreads();
    const int cols = te * 5;
    for (int i = tid; i < ORB_STAGE * cols; i += NTHREADS) {
      const int ol = i / cols, col = i % cols;
      const int o = o0 + ol;
      const long long gc = e0 * 5 + col;
      if (o < n_orb && gc < n_cols)
        C[(size_t)o * (size_t)n_cols + (size_t)gc] = stage[ol * srow + col];
    }
    __syncthreads();
  }
}

// Electrons per block for candidate width K: TILE_E, or fewer when the
// tile's lists do not fit the opt-in shared memory; 0 when even one
// electron's do not.  *bytes gets the dynamic shared memory of a block.
static int choose_tile(int K, size_t* bytes) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  for (int te = TILE_E; te >= 1; --te) {
    *bytes = tile_bytes(te, K);
    if (*bytes <= (size_t)optin) return te;
  }
  return 0;
}

extern "C" int screened_mo_config(int* out) {
  out[0] = TILE_E;
  out[1] = ORB_STAGE;
  out[2] = NTHREADS;
  return 0;
}

// Electrons per block a launch at candidate width K would use (0: none
// fits); *bytes its dynamic shared memory.
extern "C" int screened_mo_tile(int K, long long* bytes) {
  size_t b = 0;
  const int te = choose_tile(K, &b);
  *bytes = (long long)b;
  return te;
}

// At (n_ao, n_orb), Bp (N, K, 5), C (n_orb, N, 5): fp32 row-major; idx
// (N, K) int32 with every active id in [0, n_ao); active (N, K) bytes 0/1.
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// when K is too wide for one electron's list to fit in shared memory).
extern "C" int screened_mo_launch(const void* At, const void* Bp,
                                  const void* idx, const void* active,
                                  void* C, int n_orb, long long N, int K,
                                  void* stream) {
  cudaGetLastError();            // clear a stale error of an earlier call
  if (N <= 0 || n_orb <= 0) return 0;
  size_t bytes = 0;
  const int te = choose_tile(K, &bytes);
  if (te == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      screened_mo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + te - 1) / te;
  screened_mo_kernel<<<(unsigned int)blocks, NTHREADS, bytes,
                       (cudaStream_t)stream>>>(
      (const float*)At, (const float*)Bp, (const int*)idx,
      (const uint8_t*)active, (float*)C, n_orb, N, K, te);
  return (int)cudaGetLastError();
}
