// Determinant ratio of one CI excitation, shared by multidet_ratio.cu (rank
// <= 2), sem_move.cu and fused_sweep.cu (any rank).
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
//
// Where the k x k block lives.  Up to CI_MAX_RANK it sits in the thread's
// own registers (ci_det_lu).  Beyond, a thread has no room for it (k = 39
// is 1521 floats), so the caller passes a device workspace that the
// wrapper sizes from (W, n_det, k, threads) with ci_workspace_floats: one
// k x k slot a thread that takes a determinant (threads tid < min(threads,
// n_det) of every walker's block), entry (a, b) of slot s at
// ws[(a k + b) * n_slots + s], so that the threads of a warp touch
// neighbouring words.  The elimination there (ci_det_lu_ws) runs the
// same steps in the same order as ci_det_lu, through L1 and L2: it is
// simple and right, not fast (a warp- or block-wide factorization in
// shared memory is the faster design).  k has no upper limit: the lists of
// both spin blocks are padded to one rank, the higher of the two, so a
// block may carry more slots than it has electrons (sentinels fill them).
#pragma once

#define CI_MAX_RANK 8   // ranks held in registers; beyond, the workspace

// Floats of the workspace of one launch: W blocks whose first
// min(threads, n_det) threads each take determinants, a k x k slot each;
// none up to CI_MAX_RANK.
__host__ __device__ inline long long ci_workspace_floats(int W, int n_det,
                                                         int k,
                                                         int threads) {
  if (k <= CI_MAX_RANK) return 0;
  const long long per = n_det < threads ? n_det : threads;
  return (long long)k * k * W * per;
}

// No __restrict__ here: the fused sweep updates P in place in device memory
// in the same launch, so its reads must not go through the read-only cache.

// P_ext[p, h] for the sentinel-extended table P (n_orb, n_occ).
__device__ __forceinline__ float table_ext(const float* P,
                                           int p, int h, int n_orb,
                                           int n_occ) {
  if (p < n_orb) return h < n_occ ? P[(size_t)p * n_occ + h] : 0.f;
  return (h >= n_occ && p - n_orb == h - n_occ) ? 1.f : 0.f;
}

// T[a, b] = P_ext[p_a, h_b] - g_ext[p_a] row_ext[h_b], product rounded first.
__device__ __forceinline__ float ci_entry(const float* P, const float* g,
                                          const float* row, int h, int p,
                                          int n_orb, int n_occ) {
  const float gp = p < n_orb ? g[p] : 0.f;
  const float rh = h < n_occ ? row[h] : 0.f;
  return __fsub_rn(table_ext(P, p, h, n_orb, n_occ), __fmul_rn(gp, rh));
}

// The k x k block of one determinant read from the table P itself (the
// lists h, p of its k holes and particles): the entries ci_entry forms.
// The determinants below take any such accessor t, t(a, b) = T[a, b]; the
// fused sweep's cluster route passes one over a compact table of the
// expansion's (particle, hole) entries instead (fused_sweep.cu).
struct CiTable {
  const float* P;
  const float* g;
  const float* row;
  const int* h;
  const int* p;
  int n_orb, n_occ;
  __device__ __forceinline__ float operator()(int a, int b) const {
    return ci_entry(P, g, row, h[b], p[a], n_orb, n_occ);
  }
};

// det(T) at rank 2, each product rounded before its subtraction (no FMA
// contraction), as the plain PyTorch version computes it.
template <class T>
__device__ __forceinline__ float ci_det2(const T& t) {
  const float t00 = t(0, 0), t01 = t(0, 1), t10 = t(1, 0), t11 = t(1, 1);
  return __fsub_rn(__fmul_rn(t00, t11), __fmul_rn(t01, t10));
}

// Rank 3 by the cofactor expansion of slater.det_small, in its order:
// T00 (T11 T22 - T12 T21) - T01 (T10 T22 - T12 T20) + T02 (T10 T21 - T11 T20).
template <class T>
__device__ __forceinline__ float ci_det3(const T& tt) {
  float t[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      t[a][b] = tt(a, b);
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
// thread's registers (an exactly singular block gives 0).
template <class T>
__device__ inline float ci_det_lu(const T& tt, int k) {
  float t[CI_MAX_RANK][CI_MAX_RANK];
  for (int a = 0; a < k; ++a)
    for (int b = 0; b < k; ++b)
      t[a][b] = tt(a, b);
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

// Any rank: ci_det_lu's steps, in its order, on the k x k slot t (entry
// (a, b) at t[(a k + b) * ld]) of a workspace in device or shared memory.
template <class T>
__device__ inline float ci_det_lu_ws(const T& tt, int k, float* t,
                                     long long ld) {
#define CI_T(a, b) t[((long long)(a) * k + (b)) * ld]
  for (int a = 0; a < k; ++a)
    for (int b = 0; b < k; ++b)
      CI_T(a, b) = tt(a, b);
  float det = 1.f;
  for (int c = 0; c < k; ++c) {
    int piv = c;
    float best = fabsf(CI_T(c, c));
    for (int r = c + 1; r < k; ++r)
      if (fabsf(CI_T(r, c)) > best) { best = fabsf(CI_T(r, c)); piv = r; }
    if (best == 0.f) return 0.f;
    if (piv != c) {
      for (int b = c; b < k; ++b) {
        const float x = CI_T(c, b); CI_T(c, b) = CI_T(piv, b);
        CI_T(piv, b) = x;
      }
      det = -det;
    }
    const float tcc = CI_T(c, c);
    det *= tcc;
    for (int r = c + 1; r < k; ++r) {
      const float f = CI_T(r, c) / tcc;
      for (int b = c + 1; b < k; ++b) CI_T(r, b) -= f * CI_T(c, b);
    }
  }
#undef CI_T
  return det;
}

// det(T - gp (x) rh) with T[a, b] = P_ext[p_a, h_b], gp[a] = g_ext[p_a],
// rh[b] = row_ext[h_b], at rank 2.
__device__ __forceinline__ float ci_ratio2(const float* P, const float* g,
                                           const float* row,
                                           int h0, int h1, int p0, int p1,
                                           int n_orb, int n_occ) {
  const int h[2] = {h0, h1}, p[2] = {p0, p1};
  return ci_det2(CiTable{P, g, row, h, p, n_orb, n_occ});
}

// The ratio of one determinant whose lists h, p hold k >= 2 entries; ws is
// the thread's workspace slot and ld the workspace's slot count (both used
// only for k > CI_MAX_RANK).
__device__ __forceinline__ float ci_ratio_k(const float* P, const float* g,
                                            const float* row, const int* h,
                                            const int* p, int k, int n_orb,
                                            int n_occ, float* ws,
                                            long long ld) {
  const CiTable t{P, g, row, h, p, n_orb, n_occ};
  if (k == 2) return ci_det2(t);
  if (k == 3) return ci_det3(t);
  if (k > CI_MAX_RANK) return ci_det_lu_ws(t, k, ws, ld);
  return ci_det_lu(t, k);
}
