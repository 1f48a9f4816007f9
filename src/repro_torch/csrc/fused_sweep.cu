// Fused single-electron-move sweep of one spin block for Hopper (sm_90a),
// fp32, state updated in place.
//
// Replaces: src/repro/kernels/fused_sweep/kernel.py::fused_sweep_call, the
// Pallas TPU kernel behind repro.kernels.fused_sweep.ops.fused_sweep_block.
//
// What it computes.  For each walker, the block's electrons e = 0..n-1 in
// order (electron j = offset + e), each move exactly the math of
// repro_torch/kernels/fused_sweep/ref.py::_move_step:
//   ratio  = Minv[e] . phi_e                      (occupied panel)
//   dJ     = U_ee(r'_j) - U_ee(r_j) + en_e        (Pade e-e sums against the
//                                                  CURRENT positions)
//   CI:    g = P phi_e[:n] - phi_e[:n_orb];  row_t = Minv[e] / ratio;
//          ratio_I = det(T_I - g_p (x) row_h) for every determinant, at any
//          excitation rank k <= CI_MAX_RANK (ci_ratio.cuh: cofactors for
//          k <= 3, pivoted elimination beyond)
//          S_new = sum_I c_I ratio_I r_other_I;  S_old from rdet
//   accept iff log u < 2 (log|ratio| + [log|S_new| - log|S_old|] + dJ)
//          (CI: and |ratio| > 1e-20, the near-reference-node guard)
//   on accept: Minv <- Minv - (Minv phi) (x) row, row e <- row
//          (row = Minv[e] / ratio), r_j <- r'_j, logdet += log|ratio|,
//          sign *= sign(ratio); CI: P <- P - g (x) row, rdet <- ratio_I.
// It also writes each move's accept flag and margin 2(...) - log u.
//
// What the TPU kernel did.  A grid over walker tiles (tile_w walkers per
// step, the autotuned parameter); each step looped over the electrons with
// fori_loop and ran the same jnp move math on the whole tile, vectorized
// over walkers: every move computed u = Minv phi and the masked update for
// every walker, accepted or not, and the operands were padded to 128 lanes
// (and to a multiple of tile_w walkers, padding walkers given log u = +1e30
// so they never accept).
//
// What bounds it.  The moves of one walker form a dependent chain of n
// steps, each a few block-wide reductions and barriers: latency, not
// bandwidth.  The data a sweep needs is small against the card's rate
// (Minv read and written once, phi read once: ~19 MB per spin block at
// W = 256, n = 79, ~6 us at 3.35 TB/s).
//
// Design.  One thread block per walker (threads per block is the tuned
// parameter, kernels/fused_sweep/autotune.py); no padding of any axis.
//  * Minv (and P) live in shared memory when they fit the 227 KB opt-in
//    (single determinant n <= ~230: n = 79 is 25 KB, n = 217 is 188 KB);
//    otherwise they are updated in place in device memory ("global" route,
//    n = 528 is 1.1 MB, n = 866 is 3.0 MB), with the same code through
//    generic pointers.  Positions, the move's phi row, u, row, g and the
//    determinant ratios always sit in shared memory.
//  * Each move: the ratio, the two e-e sums and (CI) S_old are block
//    reductions done together (warp shuffles, then the warp partials
//    summed in a fixed order by every thread, so every thread holds the
//    same totals and takes the same branch without a broadcast).
//  * The branch on accept is uniform per block: a rejected move does no
//    update work at all (the JAX math computes and masks it; the result is
//    the same).  u = Minv phi and g = P phi are one warp per row, lanes
//    over columns (coalesced in device memory, conflict-free in shared).
//  * The rank-1 updates round the product before the subtraction (no FMA
//    contraction), as the plain PyTorch version does; dot products and
//    reductions are summed in another order than PyTorch's, so Minv, P and
//    logdet agree with the plain version to fp32 rounding, and accept
//    decisions agree except on moves whose margin is within ~1e-5 of 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ci_ratio.cuh"

struct SweepArgs {
  float* minv;          // (W, n, n)            in place
  const float* phi;     // (W, n, n_cols)
  float* r;             // (W, n_e, 3)          in place
  const float* r_prop;  // (W, n, 3)
  const float* en;      // (W, n)
  const float* logu;    // (W, n)
  float* sign;          // (W,)                 in place
  float* logdet;        // (W,)                 in place
  uint8_t* acc;         // (W, n)               out
  float* margin;        // (W, n)               out
  const float* b_ee;    // ()
  float* P;             // (W, n_orb, n)        in place (CI)
  float* rdet;          // (W, n_det)           in place (CI)
  const float* r_other; // (W, n_det)           (CI)
  const int* holes;     // (n_det, k)           (CI)
  const int* parts;     // (n_det, k)           (CI)
  const float* coeffs;  // (n_det,)             (CI)
  int n, n_cols, n_e, offset, n_up, n_orb, n_det, k;
  int shared_tables;    // 1: Minv (and P) staged in shared memory
};

#define RED_SLOTS 32   // warps per block at most (1024 threads)

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum K per-thread values over the block; every thread gets the totals.
// `red` holds K * RED_SLOTS floats and must not be reused before the next
// __syncthreads() that all threads pass after this call.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * RED_SLOTS + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int i = 0; i < nwarps; ++i) s += red[k * RED_SLOTS + i];
    v[k] = s;
  }
}

// out[i] = sum_c A[i * cols + c] x[c] (- sub[i] when sub is not null) for
// i < rows: one warp per row.
__device__ __forceinline__ void warp_rows_gemv(const float* A,
                                               const float* x,
                                               const float* sub, float* out,
                                               int rows, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < rows; i += nwarps) {
    const float* a = A + (size_t)i * cols;
    float s = 0.f;
    for (int c = lane; c < cols; c += 32) s += a[c] * x[c];
    s = warp_sum(s);
    if (lane == 0) out[i] = sub ? s - sub[i] : s;
  }
}

// Floats of dynamic shared memory for one block.
__host__ __device__ inline size_t smem_floats(int n, int n_cols, int n_e,
                                              int n_orb, int n_det, bool ci,
                                              bool shared_tables) {
  size_t f = (size_t)3 * n_e + n_cols + 2 * (size_t)n + 5 * RED_SLOTS;
  if (ci) f += (size_t)n_orb + 2 * (size_t)n_det;
  if (shared_tables) f += (size_t)n * n + (ci ? (size_t)n_orb * n : 0);
  return f;
}

template <bool CI>
__global__ void fused_sweep_kernel(SweepArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t w = blockIdx.x;
  const int n = a.n, n_cols = a.n_cols, n_e = a.n_e;
  const int n_orb = CI ? a.n_orb : 0, n_det = CI ? a.n_det : 0;

  float* gM = a.minv + w * (size_t)n * n;
  float* gP = CI ? a.P + w * (size_t)n_orb * n : nullptr;
  float* p = smem;
  float* M = gM;
  float* Pt = gP;
  if (a.shared_tables) {
    M = p; p += (size_t)n * n;
    if (CI) { Pt = p; p += (size_t)n_orb * n; }
  }
  float* rpos = p; p += 3 * n_e;
  float* phis = p; p += n_cols;
  float* u = p; p += n;
  float* rowv = p; p += n;
  float* gv = nullptr;
  float* rd = nullptr;
  float* rd_new = nullptr;
  if (CI) {
    gv = p; p += n_orb;
    rd = p; p += n_det;
    rd_new = p; p += n_det;
  }
  float* red1 = p; p += 4 * RED_SLOTS;
  float* red2 = p;

  if (a.shared_tables) {
    for (int i = tid; i < n * n; i += nt) M[i] = gM[i];
    if (CI)
      for (int i = tid; i < n_orb * n; i += nt) Pt[i] = gP[i];
  }
  for (int i = tid; i < 3 * n_e; i += nt) rpos[i] = a.r[w * 3 * n_e + i];
  if (CI)
    for (int d = tid; d < n_det; d += nt) rd[d] = a.rdet[w * n_det + d];
  float sgn = a.sign[w], ld = a.logdet[w];     // thread 0's copies count
  const float bee = *a.b_ee;
  const float* phi_w = a.phi + w * (size_t)n * n_cols;
  const float* ro_w = CI ? a.r_other + w * n_det : nullptr;

  for (int e = 0; e < n; ++e) {
    const int j = a.offset + e;
    for (int i = tid; i < n_cols; i += nt)
      phis[i] = phi_w[(size_t)e * n_cols + i];
    const size_t m = w * n + e;
    const float rpx = a.r_prop[3 * m], rpy = a.r_prop[3 * m + 1],
                rpz = a.r_prop[3 * m + 2];
    const float en_e = a.en[m], logu_e = a.logu[m];
    __syncthreads();     // phis in place; the previous move fully applied
    const float rox = rpos[3 * j], roy = rpos[3 * j + 1],
                roz = rpos[3 * j + 2];

    // ratio, e-e sums at the new and the old point, S_old
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int o = tid; o < n; o += nt) v[0] += M[(size_t)e * n + o] * phis[o];
    const bool j_up = j < a.n_up;
    for (int i = tid; i < n_e; i += nt) {
      if (i == j) continue;
      const float aee = ((i < a.n_up) == j_up) ? 0.25f : 0.5f;
      const float xi = rpos[3 * i], yi = rpos[3 * i + 1], zi = rpos[3 * i + 2];
      float dx = rpx - xi, dy = rpy - yi, dz = rpz - zi;
      const float dn = sqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
      v[1] += aee * dn / (1.f + bee * dn);
      dx = rox - xi; dy = roy - yi; dz = roz - zi;
      const float dold = sqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
      v[2] += aee * dold / (1.f + bee * dold);
    }
    if (CI)
      for (int d = tid; d < n_det; d += nt)
        v[3] += a.coeffs[d] * rd[d] * ro_w[d];
    block_sum<4>(v, red1);
    const float ratio = v[0];
    const float log_ratio = logf(fabsf(ratio) + 1e-30f);
    const float d_jas = (v[1] - v[2]) + en_e;

    float total;
    if (CI) {
      // g = P phi_occ - phi_all; row_t = Minv[e] / ratio (unguarded: a
      // zero ratio makes the comparison NaN, hence rejected)
      warp_rows_gemv(Pt, phis, phis, gv, n_orb, n);
      for (int h = tid; h < n; h += nt)
        rowv[h] = M[(size_t)e * n + h] / ratio;
      __syncthreads();
      float s[1] = {0.f};
      for (int d = tid; d < n_det; d += nt) {
        const float det = ci_ratio_k(Pt, gv, rowv, a.holes + (size_t)d * a.k,
                                     a.parts + (size_t)d * a.k, a.k, n_orb,
                                     n);
        rd_new[d] = det;
        s[0] += a.coeffs[d] * det * ro_w[d];
      }
      block_sum<1>(s, red2);
      const float log_ci = logf(fabsf(s[0]) + 1e-30f)
                           - logf(fabsf(v[3]) + 1e-30f);
      total = 2.f * ((log_ratio + log_ci) + d_jas);
    } else {
      total = 2.f * (log_ratio + d_jas);
    }
    bool accept = logu_e < total;
    if (CI) accept = accept && (fabsf(ratio) > 1e-20f);
    if (tid == 0) {
      a.acc[m] = accept ? 1 : 0;
      a.margin[m] = total - logu_e;
    }
    if (!accept) continue;       // uniform over the block

    if (tid == 0) {
      rpos[3 * j] = rpx; rpos[3 * j + 1] = rpy; rpos[3 * j + 2] = rpz;
      ld += log_ratio;
      sgn *= (ratio > 0.f) ? 1.f : ((ratio < 0.f) ? -1.f : 0.f);
    }
    warp_rows_gemv(M, phis, nullptr, u, n, n);  // u = Minv phi
    if (!CI) {
      const float safe = fabsf(ratio) > 1e-20f ? ratio : 1.f;
      for (int o = tid; o < n; o += nt) rowv[o] = M[(size_t)e * n + o] / safe;
    }
    __syncthreads();
    for (int i = warp; i < n; i += nwarps) {
      float* Mi = M + (size_t)i * n;
      const float ui = u[i];
      if (i == e) {
        for (int o = lane; o < n; o += 32) Mi[o] = rowv[o];
      } else {
        for (int o = lane; o < n; o += 32)
          Mi[o] = __fsub_rn(Mi[o], __fmul_rn(ui, rowv[o]));
      }
    }
    if (CI) {
      for (int vv = warp; vv < n_orb; vv += nwarps) {
        float* Pv = Pt + (size_t)vv * n;
        const float gvv = gv[vv];
        for (int h = lane; h < n; h += 32)
          Pv[h] = __fsub_rn(Pv[h], __fmul_rn(gvv, rowv[h]));
      }
      for (int d = tid; d < n_det; d += nt) rd[d] = rd_new[d];
    }
  }
  __syncthreads();
  if (a.shared_tables) {
    for (int i = tid; i < n * n; i += nt) gM[i] = M[i];
    if (CI)
      for (int i = tid; i < n_orb * n; i += nt) gP[i] = Pt[i];
  }
  for (int i = tid; i < 3 * n_e; i += nt) a.r[w * 3 * n_e + i] = rpos[i];
  if (CI)
    for (int d = tid; d < n_det; d += nt) a.rdet[w * n_det + d] = rd[d];
  if (tid == 0) {
    a.sign[w] = sgn;
    a.logdet[w] = ld;
  }
}

// Route for a launch: 1 = Minv (and P) in shared memory, 2 = in device
// memory; `route` 0 picks 1 when it fits the opt-in limit.  Returns -1 when
// even the per-move buffers do not fit.
static int choose_route(int n, int n_cols, int n_e, int n_orb, int n_det,
                        bool ci, int route, size_t* bytes) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t shared = 4 * smem_floats(n, n_cols, n_e, n_orb, n_det, ci,
                                        true);
  const size_t global = 4 * smem_floats(n, n_cols, n_e, n_orb, n_det, ci,
                                        false);
  if (route == 0) route = shared <= (size_t)optin ? 1 : 2;
  *bytes = route == 1 ? shared : global;
  return *bytes <= (size_t)optin ? route : -1;
}

// Dynamic shared memory (bytes) a launch would use; -1 when it cannot run.
extern "C" long long fused_sweep_smem_bytes(int n, int n_cols, int n_e,
                                            int n_orb, int n_det, int ci,
                                            int route, int* route_used) {
  size_t bytes = 0;
  *route_used = choose_route(n, n_cols, n_e, n_orb, n_det, ci != 0, route,
                             &bytes);
  return *route_used < 0 ? -1 : (long long)bytes;
}

// All pointers device pointers (CI ones may be null when ci == 0); the CI
// lists are (n_det, k) with 2 <= k <= CI_MAX_RANK.  threads
// a multiple of 32 in [32, 1024].  route: 0 auto, 1 shared, 2 global; the
// route taken is written to *route_used.  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue when the launch cannot run).
extern "C" int fused_sweep_max_rank() { return CI_MAX_RANK; }

extern "C" int fused_sweep_launch(
    void* minv, const void* phi, void* r, const void* r_prop, const void* en,
    const void* logu, void* sign, void* logdet, void* acc, void* margin,
    const void* b_ee, void* P, void* rdet, const void* r_other,
    const void* holes, const void* parts, const void* coeffs, int W, int n,
    int n_cols, int n_e, int offset, int n_up, int n_orb, int n_det, int k,
    int ci, int threads, int route, int* route_used, void* stream) {
  cudaGetLastError();            // clear a stale error of an earlier call
  if (threads < 32 || threads > 1024 || threads % 32) return 1;
  if (ci && (k < 2 || k > CI_MAX_RANK)) return 1;
  size_t bytes = 0;
  const int rt = choose_route(n, n_cols, n_e, n_orb, n_det, ci != 0, route,
                              &bytes);
  *route_used = rt;
  if (rt < 0) return (int)cudaErrorInvalidValue;
  SweepArgs a;
  a.minv = (float*)minv; a.phi = (const float*)phi; a.r = (float*)r;
  a.r_prop = (const float*)r_prop; a.en = (const float*)en;
  a.logu = (const float*)logu; a.sign = (float*)sign;
  a.logdet = (float*)logdet; a.acc = (uint8_t*)acc;
  a.margin = (float*)margin; a.b_ee = (const float*)b_ee;
  a.P = (float*)P; a.rdet = (float*)rdet; a.r_other = (const float*)r_other;
  a.holes = (const int*)holes; a.parts = (const int*)parts;
  a.coeffs = (const float*)coeffs;
  a.n = n; a.n_cols = n_cols; a.n_e = n_e; a.offset = offset;
  a.n_up = n_up; a.n_orb = n_orb; a.n_det = n_det; a.k = k;
  a.shared_tables = rt == 1;
  if (W <= 0 || n <= 0) return 0;
  cudaError_t err;
  if (ci) {
    err = cudaFuncSetAttribute(fused_sweep_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_sweep_kernel<true><<<W, threads, bytes, (cudaStream_t)stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(fused_sweep_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    fused_sweep_kernel<false><<<W, threads, bytes, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
