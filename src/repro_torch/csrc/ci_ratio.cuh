// Determinant ratio of one CI excitation of rank <= 2, shared by
// multidet_ratio.cu and fused_sweep.cu.
//
// The sentinel convention of repro_torch.core.multidet: the excitation lists
// are padded to rank 2, a hole index >= n_occ or a particle index >= n_orb
// names pad slot (index - n_occ) or (index - n_orb), whose table block is an
// identity and whose g / row entries are zero.  So a single (or the
// reference itself) is the same 2x2 determinant as a double.
#pragma once

// No __restrict__ here: the fused sweep updates P in place in device memory
// in the same launch, so its reads must not go through the read-only cache.

// P_ext[p, h] for the sentinel-extended table P (n_orb, n_occ).
__device__ __forceinline__ float table_ext(const float* P,
                                           int p, int h, int n_orb,
                                           int n_occ) {
  if (p < n_orb) return h < n_occ ? P[(size_t)p * n_occ + h] : 0.f;
  return (h >= n_occ && p - n_orb == h - n_occ) ? 1.f : 0.f;
}

// det(T - gp (x) rh) with T[a, b] = P_ext[p_a, h_b], gp[a] = g_ext[p_a],
// rh[b] = row_ext[h_b].  Each product is rounded before its subtraction (no
// FMA contraction), as the plain PyTorch version computes it.
__device__ __forceinline__ float ci_ratio2(const float* P, const float* g,
                                           const float* row,
                                           int h0, int h1, int p0, int p1,
                                           int n_orb, int n_occ) {
  const float gp0 = p0 < n_orb ? g[p0] : 0.f;
  const float gp1 = p1 < n_orb ? g[p1] : 0.f;
  const float rh0 = h0 < n_occ ? row[h0] : 0.f;
  const float rh1 = h1 < n_occ ? row[h1] : 0.f;
  const float t00 = __fsub_rn(table_ext(P, p0, h0, n_orb, n_occ),
                              __fmul_rn(gp0, rh0));
  const float t01 = __fsub_rn(table_ext(P, p0, h1, n_orb, n_occ),
                              __fmul_rn(gp0, rh1));
  const float t10 = __fsub_rn(table_ext(P, p1, h0, n_orb, n_occ),
                              __fmul_rn(gp1, rh0));
  const float t11 = __fsub_rn(table_ext(P, p1, h1, n_orb, n_occ),
                              __fmul_rn(gp1, rh1));
  return __fsub_rn(__fmul_rn(t00, t11), __fmul_rn(t01, t10));
}
