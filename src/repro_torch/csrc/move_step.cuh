// The arithmetic of one single-electron move that the per-move kernel
// (sem_move.cu) and the fused sweep (fused_sweep.cu) share: the warp sum
// of their reductions, the log of a determinant ratio, the Metropolis
// decision and its margin, the divisor of the new inverse row, and the
// Sherman-Morrison element update.  Each is written as the plain PyTorch
// version rounds it (repro_torch/kernels/sem_update/ref.py::sem_move_ref,
// repro_torch/kernels/fused_sweep/ref.py::_move_step).
#pragma once

#define FULL_MASK 0xffffffffu

// The warp's sum in lane 0 (a fixed order: every run gives the same bits).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL_MASK, v, off);
  return v;
}

// log(|x| + 1e-30): the log of a determinant ratio or of a CI sum.
__device__ __forceinline__ float log_abs_ratio(float x) {
  return logf(fabsf(x) + 1e-30f);
}

// 2 (log|ratio| [+ log_ci] + dJ), summed in the plain version's order.
__device__ __forceinline__ float move_total(float log_ratio, float log_ci,
                                           float d_jas, bool ci) {
  return ci ? 2.f * ((log_ratio + log_ci) + d_jas)
            : 2.f * (log_ratio + d_jas);
}

// Accept iff log u < total (the margin total - log u is > 0); with CI also
// |ratio| > 1e-20, the near-reference-node guard.
__device__ __forceinline__ bool move_accept(float total, float logu,
                                            float ratio, bool ci) {
  return logu < total && (!ci || fabsf(ratio) > 1e-20f);
}

// The divisor of the new row Minv[e] / d: the ratio, or 1 where the single
// determinant's ratio is within 1e-20 of 0 (with CI the ratio itself: an
// accepted CI move has |ratio| > 1e-20, and the CI factor needs the
// unguarded row).
__device__ __forceinline__ float row_divisor(float ratio, bool ci) {
  return (ci || fabsf(ratio) > 1e-20f) ? ratio : 1.f;
}

// m - c x with the product rounded first (no FMA contraction), as the plain
// version computes minv - u (x) row and P - g (x) row.
__device__ __forceinline__ float sm_update(float m, float c, float x) {
  return __fsub_rn(m, __fmul_rn(c, x));
}

// sign(ratio) as torch.sign gives it (0 for 0).
__device__ __forceinline__ float ratio_sign(float ratio) {
  return (ratio > 0.f) ? 1.f : ((ratio < 0.f) ? -1.f : 0.f);
}
