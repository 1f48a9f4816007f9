// Determinant ratio of one CI excitation, shared by multidet_ratio.cu (rank
// <= 2) and fused_sweep.cu (any rank up to CI_MAX_RANK).
//
// The sentinel convention of repro_torch.core.multidet: the excitation lists
// are padded to a common rank (at least 2), a hole index >= n_occ or a
// particle index >= n_orb names pad slot (index - n_occ) or (index - n_orb),
// whose table block is an identity and whose g / row entries are zero.  So a
// single (or the reference itself) is the same 2x2 determinant as a double.
// The k x k determinant follows repro_torch.core.slater.det_small: explicit
// cofactors for k <= 3 (each product rounded before its sum, as the plain
// PyTorch version computes them), Gaussian elimination with partial pivoting
// beyond (torch.linalg.det factors by LU with partial pivoting too; the two
// agree to fp32 rounding).
#pragma once

#define CI_MAX_RANK 8

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

// T[a, b] = P_ext[p_a, h_b] - g_ext[p_a] row_ext[h_b], product rounded first.
__device__ __forceinline__ float ci_entry(const float* P, const float* g,
                                          const float* row, int h, int p,
                                          int n_orb, int n_occ) {
  const float gp = p < n_orb ? g[p] : 0.f;
  const float rh = h < n_occ ? row[h] : 0.f;
  return __fsub_rn(table_ext(P, p, h, n_orb, n_occ), __fmul_rn(gp, rh));
}

// Rank 3 by the cofactor expansion of slater.det_small, in its order:
// T00 (T11 T22 - T12 T21) - T01 (T10 T22 - T12 T20) + T02 (T10 T21 - T11 T20).
__device__ __forceinline__ float ci_ratio3(const float* P, const float* g,
                                           const float* row, const int* h,
                                           const int* p, int n_orb,
                                           int n_occ) {
  float t[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      t[a][b] = ci_entry(P, g, row, h[b], p[a], n_orb, n_occ);
  const float c0 = __fsub_rn(__fmul_rn(t[1][1], t[2][2]),
                             __fmul_rn(t[1][2], t[2][1]));
  const float c1 = __fsub_rn(__fmul_rn(t[1][0], t[2][2]),
                             __fmul_rn(t[1][2], t[2][0]));
  const float c2 = __fsub_rn(__fmul_rn(t[1][0], t[2][1]),
                             __fmul_rn(t[1][1], t[2][0]));
  return __fadd_rn(__fsub_rn(__fmul_rn(t[0][0], c0), __fmul_rn(t[0][1], c1)),
                   __fmul_rn(t[0][2], c2));
}

// Rank 4..CI_MAX_RANK: Gaussian elimination with partial pivoting, in one
// thread (an exactly singular block gives 0).
__device__ inline float ci_ratio_lu(const float* P, const float* g,
                                    const float* row, const int* h,
                                    const int* p, int k, int n_orb,
                                    int n_occ) {
  float t[CI_MAX_RANK][CI_MAX_RANK];
  for (int a = 0; a < k; ++a)
    for (int b = 0; b < k; ++b)
      t[a][b] = ci_entry(P, g, row, h[b], p[a], n_orb, n_occ);
  float det = 1.f;
  for (int c = 0; c < k; ++c) {
    int piv = c;
    float best = fabsf(t[c][c]);
    for (int r = c + 1; r < k; ++r)
      if (fabsf(t[r][c]) > best) { best = fabsf(t[r][c]); piv = r; }
    if (best == 0.f) return 0.f;
    if (piv != c) {
      for (int b = c; b < k; ++b) {
        const float x = t[c][b]; t[c][b] = t[piv][b]; t[piv][b] = x;
      }
      det = -det;
    }
    det *= t[c][c];
    for (int r = c + 1; r < k; ++r) {
      const float f = t[r][c] / t[c][c];
      for (int b = c + 1; b < k; ++b) t[r][b] -= f * t[c][b];
    }
  }
  return det;
}

// The ratio of one determinant whose lists h, p hold k >= 2 entries.
__device__ __forceinline__ float ci_ratio_k(const float* P, const float* g,
                                            const float* row, const int* h,
                                            const int* p, int k, int n_orb,
                                            int n_occ) {
  if (k == 2) return ci_ratio2(P, g, row, h[0], h[1], p[0], p[1], n_orb,
                               n_occ);
  if (k == 3) return ci_ratio3(P, g, row, h, p, n_orb, n_occ);
  return ci_ratio_lu(P, g, row, h, p, k, n_orb, n_occ);
}
