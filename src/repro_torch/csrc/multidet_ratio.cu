// Batched multideterminant move ratios for Hopper (sm_90a), fp32.
//
// Replaces: src/repro/kernels/multidet_ratio/kernel.py::multidet_ratio_matmul,
// the Pallas TPU kernel behind repro.kernels.multidet_ratio.ops.
//
// What it computes.  For one proposed single-electron move and every walker
// w, every determinant I of a CI expansion with excitation rank <= 2:
//     ratio[w, I] = det( T_I - gp_I (x) rh_I ),  T_I[a, b] = P_ext[p_a, h_b],
//                   gp_I[a] = g_ext[p_a],  rh_I[b] = row_ext[h_b]
//     S[w]        = sum_I c_I ratio[w, I] r_other[w, I]
// where P (n_orb, n_occ) is the shared ratio table, g = P phi - v_new and
// row = Minv[j] / ratio_ref.  "_ext" is the sentinel extension of
// repro.core.multidet: a hole index >= n_occ or a particle index >= n_orb
// names pad slot (index - n_occ) or (index - n_orb), whose table block is an
// identity and whose g / row entries are zero.
//
// What the TPU kernel did.  The gathers ran outside the kernel in XLA,
// which wrote a (W, 8, n_det) plane stack (Tg00..Tg11, gp0, gp1, rh0, rh1)
// padded to (8, 128) tiles; the kernel read it back tile by tile and
// carried the CI sum across the sequential determinant grid axis in lane 0
// of a revisited output block.
//
// What bounds it.  Per walker and determinant: 8 gathered floats, ~15
// flops, one 4-byte ratio out: memory and latency.  At W = 256, n_det = 100
// it reads the 256 tables once (37 KB each at n_orb = 118, n_occ = 79, but
// only the gathered entries are touched) and writes 100 KB of ratios.
//
// Design.  One block per walker, threads over determinants.  The gathers
// read the table directly (no plane stack in memory, no padding: the
// sentinel slots are resolved in registers).  The CI sum is a fixed-order
// block reduction (per-thread partial in determinant order, warp shuffles,
// then warp partials summed by one thread): deterministic, no atomics.  The
// 2x2 determinant rounds each product before the subtraction (no FMA
// contraction), as the plain PyTorch version does, so the ratios agree with
// it bitwise; S differs only by summation order.

#include <cuda_runtime.h>

#include "ci_ratio.cuh"

#define NTHREADS 128

__global__ void __launch_bounds__(NTHREADS)
multidet_ratio_kernel(const float* __restrict__ P,
                      const float* __restrict__ g,
                      const float* __restrict__ row,
                      const int* __restrict__ holes,
                      const int* __restrict__ parts,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ r_other,
                      float* __restrict__ ratios, float* __restrict__ S,
                      int n_orb, int n_occ, int n_det) {
  __shared__ float warp_sum[NTHREADS / 32];
  const size_t w = blockIdx.x;
  const float* Pw = P + w * (size_t)n_orb * n_occ;
  const float* gw = g + w * (size_t)n_orb;
  const float* rw = row + w * (size_t)n_occ;
  float part = 0.f;
  for (int d = threadIdx.x; d < n_det; d += NTHREADS) {
    const float det = ci_ratio2(
        Pw, gw, rw, __ldg(holes + 2 * d), __ldg(holes + 2 * d + 1),
        __ldg(parts + 2 * d), __ldg(parts + 2 * d + 1), n_orb, n_occ);
    ratios[w * n_det + d] = det;
    part = __fadd_rn(part, __fmul_rn(__fmul_rn(__ldg(coeffs + d), det),
                                     __ldg(r_other + w * n_det + d)));
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < NTHREADS / 32; ++i) s += warp_sum[i];
    S[w] = s;
  }
}

// P (W, n_orb, n_occ), g (W, n_orb), row (W, n_occ), coeffs (n_det,),
// r_other (W, n_det), ratios (W, n_det), S (W,): fp32 contiguous;
// holes/parts (n_det, 2) int32.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int multidet_ratio_launch(const void* P, const void* g,
                                     const void* row, const void* holes,
                                     const void* parts, const void* coeffs,
                                     const void* r_other, void* ratios,
                                     void* S, int W, int n_orb, int n_occ,
                                     int n_det, void* stream) {
  if (W > 0)
    multidet_ratio_kernel<<<W, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)P, (const float*)g, (const float*)row,
        (const int*)holes, (const int*)parts, (const float*)coeffs,
        (const float*)r_other, (float*)ratios, (float*)S, n_orb, n_occ,
        n_det);
  return (int)cudaGetLastError();
}
