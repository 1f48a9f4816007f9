// One single-electron move of the per-move sweep for Hopper (sm_90a), fp32
// on the CUDA cores, state updated in place: the determinant ratio, u =
// Minv phi, with CI the table pass, every determinant's ratio and the CI
// sums, the Metropolis decision and, for an accepted walker, the rank-1
// update of Minv (and P), in one launch a move.
//
// Replaces, on the per-move path (repro/core/sem.py::_sweep_spin_block):
// src/repro/kernels/sem_update/kernel.py::sem_update_matmul (the update) and
// src/repro/kernels/multidet_ratio/kernel.py::multidet_ratio_matmul (the CI
// ratios), with the jnp tail of the move around them.  The first designs
// (csrc/sem_update.cu, csrc/multidet_ratio.cu) stay as the ports of those
// two TPU kernels' own signatures.
//
// What it computes.  For each walker w, electron j = offset + e of a spin
// block of n, after the caller's proposal values and Jastrow delta (exactly
// repro_torch/kernels/sem_update/ref.py::sem_move_ref):
//   phi = v[:n] (v: the proposal's orbital values, all n_orb with CI)
//   u_i = Minv[i] . phi; ratio = u_e
//   CI:  g = P phi - v; row_t = Minv[e] / ratio (unguarded)
//        ratio_I = det(T_I - g_p (x) row_h) for every determinant, any rank
//        (ci_ratio.cuh: in registers up to CI_MAX_RANK, beyond in the
//        workspace the wrapper passes); S_new = sum_I c_I ratio_I ro_I,
//        S_old = sum_I c_I rdet_I ro_I; log_ci = log|S_new| - log|S_old|
//   margin = 2 (log|ratio| [+ log_ci] + dJ) - log u; accept iff margin > 0
//        (CI: and |ratio| > 1e-20)
//   on accept: row = Minv[e] / (ratio, or 1 where |ratio| <= 1e-20);
//        Minv[i] <- Minv[i] - u_i row (product rounded first), row e <- row;
//        r_j <- r', logdet += log|ratio|, sign *= sign(ratio);
//        CI: P <- P - g (x) row, rdet <- ratio_I.
// It writes accept and margin of every walker.  The arithmetic the fused
// sweep shares is in move_step.cuh and ci_ratio.cuh.
//
// What the TPU kernels did.  sem_update_matmul read the (W, n, n) inverses
// tile by tile, a select for rejected walkers; multidet_ratio_matmul read a
// (W, 8, n_det) plane stack of gathered entries that XLA wrote; u, the ratio,
// g, the decision and the P update were separate XLA operations around them.
//
// What bounds it.  Per move a walker's Minv is read once (n^2 floats), and
// written once when accepted, P likewise with CI: at W = 256, n = 79 ~10 MB
// a move with ~61 % accepted, 3 us at 3.35 TB/s; the operations (~2 n^2 a
// walker, 4 n^2 accepted) are far below.  On the per-move path what costs is
// the number of launches the host issues a move, so this kernel replaces
// the ~25 launches of the move's tail with one; within it, the chain of
// dependent steps (load, dot, reduction, barrier, decision, barrier,
// update) is what a move waits for.
//
// Design.  One thread block per walker.  The table rows are the n rows of
// Minv, then with CI the n_orb rows of P (both n columns wide, and both
// updated as row - coef row_new, coef = u_i or g_v): rows = n [+ n_orb].
//  * phi (and v) goes to shared memory by 4-byte cp.async (any strides: the
//    caller's orbital values are a transposed GEMM output), while each warp
//    loads its rows: row warp + k * warps for k < RPW in registers, lane l
//    holding columns l + 32 q, q < CPL (coalesced).  (CPL, RPW) is the first
//    of MOVE_VARIANTS whose 32 CPL columns cover n; the block has
//    32 ceil(rows / RPW) threads, at most move_max_threads(CPL, RPW), which
//    leaves each thread the registers of its RPW x CPL floats.
//  * Rows past the register rows (n = 217: 128 of 217 in registers at 512
//    threads) are copied to shared memory as they are read, as far as the
//    opt-in holds them (smem_rows), and the rest are read again from device
//    memory (L2) for the update: the route for n > 256 (CPL = RPW = 0: every
//    row), n = 528 and 866 included.  No width is refused.
//  * One pass: each lane's partial dot in column order, a butterfly of
//    shuffles, so every lane of the row's warp holds u_i (or g_v); row e's
//    warp publishes the ratio and row e.  The register rows and the copied
//    rows sum in the same order, so the routes agree bitwise.
//  * Barrier 1, then every thread takes the same, block-uniform, decision
//    from the same shared values (with CI after the division of row e, one
//    column a thread, barrier 2, one determinant a thread, barrier 3).  A
//    rejected walker's block returns before it stores anything: the traffic
//    follows the acceptance rate, and NaN/Inf in a rejected walker's row
//    never reaches memory.
//  * On accept: the division (single determinant; IEEE, one column a
//    thread), a barrier, then each warp updates its own rows from registers
//    (or shared memory, or L2) and stores them, coalesced.
//
// Numerics.  The dots and the CI sums are summed in another order than
// PyTorch's, so Minv, P, rdet and logdet agree with the plain version to
// fp32 rounding, and accept decisions agree except on moves whose margin is
// within ~1e-5 of 0.  The division and the update round as the plain
// version does.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ci_ratio.cuh"
#include "move_step.cuh"

#define RED_SLOTS 32   // warps per block at most (1024 threads)

struct MoveArgs {
  float* minv;          // (W, n, n)            in place
  const float* phi;     // v: element (w, c) at w * phi_sw + c * phi_sc
  long long phi_sw, phi_sc;
  float* r;             // (W, n_e, 3)          in place (column j)
  const float* r_new;   // (W, 3)
  const float* d_jas;   // (W,)
  const float* logu;    // element w at w * logu_s
  long long logu_s;
  float* sign;          // (W,)                 in place
  float* logdet;        // (W,)                 in place
  uint8_t* acc;         // (W,)                 out
  float* margin;        // (W,)                 out
  float* P;             // (W, n_orb, n)        in place (CI)
  float* rdet;          // (W, n_det)           in place (CI)
  const float* r_other; // (W, n_det)           (CI)
  const int* holes;     // (n_det, k)           (CI)
  const int* parts;     // (n_det, k)           (CI)
  const float* coeffs;  // (n_det,)             (CI)
  float* ws;            // ci_workspace_floats   (CI, k > CI_MAX_RANK)
  int n, n_cols, n_e, e, j, n_orb, n_det, k, ci, smem_rows;
  int ws_per;           // workspace slots a walker: min(threads, n_det)
};

__host__ __device__ constexpr int up4(int x) { return (x + 3) / 4 * 4; }

// Registers a thread of variant (CPL, RPW) needs: its RPW x CPL floats of
// rows, their RPW coefficients, CPL of phi, and ~32 more (rounded up to 8).
__host__ __device__ constexpr int move_regs(int cpl, int rpw) {
  return (rpw * cpl + rpw + cpl + 32 + 7) / 8 * 8;
}

// Threads a block of variant (CPL, RPW) may have: as many as the SM's
// 65 536 registers hold at move_regs each, in multiples of 128, at most
// 1024 (kernels/sem_update/kernel.py::move_max_threads is the chooser's
// copy).  The launch refuses a larger block.
__host__ __device__ constexpr int move_max_threads(int cpl, int rpw) {
  return rpw == 0 ? 1024
         : (65536 / move_regs(cpl, rpw) / 128 * 128 > 1024
                ? 1024 : 65536 / move_regs(cpl, rpw) / 128 * 128);
}

// Floats of dynamic shared memory: v, row e, the overflow rows' u or g, the
// warp sums, the ratio; with CI g and the new determinant ratios; then
// smem_rows rows of n.
__host__ __device__ inline size_t move_smem_floats(int n, int n_cols,
                                                   int n_orb, int n_det,
                                                   bool ci, int smem_rows) {
  size_t f = (size_t)up4(n_cols) + up4(n) + up4(n + (ci ? n_orb : 0))
             + 2 * RED_SLOTS + 4;
  if (ci) f += (size_t)up4(n_orb) + up4(n_det);
  return f + (size_t)smem_rows * n;
}

// The same sum in every lane (commutative pairs: the same bits).
__device__ __forceinline__ float warp_allsum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

__device__ __forceinline__ float slots_sum(const float* s, int nwarps) {
  float v = 0.f;
  for (int i = 0; i < nwarps; ++i) v += s[i];
  return v;
}

template <int CPL, int RPW>
__global__ void __launch_bounds__(move_max_threads(CPL, RPW), 1)
sem_move_kernel(MoveArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t w = blockIdx.x;
  const bool ci = a.ci != 0;
  const int n = a.n, n_cols = a.n_cols, e = a.e;
  const int n_orb = ci ? a.n_orb : 0, n_det = ci ? a.n_det : 0;
  const int n_rows = n + n_orb;

  float* p = smem;
  float* vs = p; p += up4(n_cols);          // v (phi = its first n)
  float* rowb = p; p += up4(n);             // row e, then row e / ratio
  float* ubuf = p; p += up4(n_rows);        // u or g of the overflow rows
  float* red = p; p += 2 * RED_SLOTS;       // S_old's and S_new's warp sums
  float* scal = p; p += 4;                  // the ratio
  float *gb = nullptr, *rdn = nullptr;
  if (ci) {
    gb = p; p += up4(n_orb);                // g, for ci_ratio_k
    rdn = p; p += up4(n_det);               // the new determinant ratios
  }
  float* ovb = p;                           // overflow rows, smem_rows of n

  float* gM = a.minv + w * (size_t)n * n;
  float* gP = ci ? a.P + w * (size_t)n_orb * n : nullptr;
  auto row_ptr = [&](int rr) -> float* {
    return rr < n ? gM + (size_t)rr * n : gP + (size_t)(rr - n) * n;
  };

  const float* vw = a.phi + (long long)w * a.phi_sw;
  for (int c = tid; c < n_cols; c += nt)
    __pipeline_memcpy_async(vs + c, vw + (long long)c * a.phi_sc, 4);
  __pipeline_commit();

  // the register rows, straight from device memory (independent loads)
  float m[RPW > 0 ? RPW : 1][CPL > 0 ? CPL : 1];
#pragma unroll
  for (int kk = 0; kk < RPW; ++kk) {
    const int rr = warp + kk * nwarps;
    const float* src = rr < n_rows ? row_ptr(rr) : nullptr;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = lane + 32 * q;
      m[kk][q] = (src != nullptr && c < n) ? src[c] : 0.f;
    }
  }
  float s_old = 0.f;
  if (ci)
    for (int d = tid; d < n_det; d += nt)
      s_old += a.coeffs[d] * a.rdet[w * n_det + d] * a.r_other[w * n_det + d];
  __pipeline_wait_prior(0);
  __syncthreads();                          // v in place

  // the pass: u_i = Minv[i] . phi, g_v = P[v] . phi - v_v
  float coef[RPW > 0 ? RPW : 1];
  {
    float ph[CPL > 0 ? CPL : 1];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = lane + 32 * q;
      ph[q] = c < n ? vs[c] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < RPW; ++kk) {
      const int rr = warp + kk * nwarps;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) s = fmaf(m[kk][q], ph[q], s);
      s = warp_allsum(s);
      if (rr >= n && rr < n_rows) {
        s = s - vs[rr - n];
        if (lane == 0) gb[rr - n] = s;
      }
      coef[kk] = s;
      if (rr == e) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = lane + 32 * q;
          if (c < n) rowb[c] = m[kk][q];
        }
        if (lane == 0) scal[0] = s;
      }
    }
  }
  const int reg_rows = RPW * nwarps;
  for (int rr = reg_rows + warp; rr < n_rows; rr += nwarps) {
    const float* src = row_ptr(rr);
    const int slot = rr - reg_rows;
    float* keep = slot < a.smem_rows ? ovb + (size_t)slot * n : nullptr;
    float s = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float x = src[c];
      if (keep != nullptr) keep[c] = x;
      if (rr == e) rowb[c] = x;
      s = fmaf(x, vs[c], s);
    }
    s = warp_allsum(s);
    if (rr >= n) {
      s = s - vs[rr - n];
      if (lane == 0) gb[rr - n] = s;
    }
    if (lane == 0) {
      ubuf[rr] = s;
      if (rr == e) scal[0] = s;
    }
  }
  if (ci) {
    s_old = warp_sum(s_old);
    if (lane == 0) red[warp] = s_old;
  }
  __syncthreads();                          // barrier 1

  const float ratio = scal[0];
  const float log_ratio = log_abs_ratio(ratio);
  float log_ci = 0.f;
  if (ci) {
    // row_t = Minv[e] / ratio, unguarded (a zero ratio makes the
    // comparison NaN, hence rejected); on accept it is also the new row
    for (int c = tid; c < n; c += nt) rowb[c] = rowb[c] / ratio;
    __syncthreads();                        // barrier 2
    float s = 0.f;
    float* slot = a.ws != nullptr ? a.ws + w * a.ws_per + tid : nullptr;
    const long long ld = (long long)gridDim.x * a.ws_per;
    for (int d = tid; d < n_det; d += nt) {
      const float det = ci_ratio_k(gP, gb, rowb, a.holes + (size_t)d * a.k,
                                   a.parts + (size_t)d * a.k, a.k, n_orb, n,
                                   slot, ld);
      rdn[d] = det;
      s += a.coeffs[d] * det * a.r_other[w * n_det + d];
    }
    s = warp_sum(s);
    if (lane == 0) red[RED_SLOTS + warp] = s;
    __syncthreads();                        // barrier 3
    log_ci = log_abs_ratio(slots_sum(red + RED_SLOTS, nwarps))
             - log_abs_ratio(slots_sum(red, nwarps));
  }
  const float logu = a.logu[(long long)w * a.logu_s];
  const float total = move_total(log_ratio, log_ci, a.d_jas[w], ci);
  const bool accept = move_accept(total, logu, ratio, ci);
  if (tid == 0) {
    a.acc[w] = accept ? 1 : 0;
    a.margin[w] = total - logu;
  }
  if (!accept) return;                      // uniform over the block

  if (!ci) {
    const float d = row_divisor(ratio, false);
    for (int c = tid; c < n; c += nt) rowb[c] = rowb[c] / d;
    __syncthreads();                        // the new row in place
  }
  {
    float rv[CPL > 0 ? CPL : 1];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      const int c = lane + 32 * q;
      rv[q] = c < n ? rowb[c] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < RPW; ++kk) {
      const int rr = warp + kk * nwarps;
      if (rr >= n_rows) break;
      float* dst = row_ptr(rr);
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        if (c < n) dst[c] = rr == e ? rv[q] : sm_update(m[kk][q], coef[kk],
                                                          rv[q]);
      }
    }
  }
  for (int rr = reg_rows + warp; rr < n_rows; rr += nwarps) {
    float* dst = row_ptr(rr);
    const int slot = rr - reg_rows;
    const float* src = slot < a.smem_rows ? ovb + (size_t)slot * n : dst;
    const float u = ubuf[rr];
    for (int c = lane; c < n; c += 32)
      dst[c] = rr == e ? rowb[c] : sm_update(src[c], u, rowb[c]);
  }
  if (ci)
    for (int d = tid; d < n_det; d += nt) a.rdet[w * n_det + d] = rdn[d];
  if (tid == 0) {
    float* rj = a.r + (w * a.n_e + a.j) * 3;
    rj[0] = a.r_new[3 * w];
    rj[1] = a.r_new[3 * w + 1];
    rj[2] = a.r_new[3 * w + 2];
    a.logdet[w] += log_ratio;
    a.sign[w] *= ratio_sign(ratio);
  }
}

// ================================ host side ================================

// (CPL, RPW) the kernel is compiled for, in the order of preference: CPL
// columns a lane (n <= 32 CPL), RPW rows a warp in registers; (0, 0) holds
// no row in registers and takes any n.  kernels/sem_update/kernel.py reads
// the list from this file.
#define MOVE_VARIANTS(X) X(1, 8) X(2, 8) X(3, 8) X(4, 8) X(6, 8) X(8, 8) X(0, 0)

#define MAX_DEVICES 64

template <int CPL, int RPW>
static int launch_variant(int dev, int W, int threads, size_t bytes,
                          void* stream, const MoveArgs& a) {
  // the shared memory above 48 KB, opted into once per device for the
  // largest size asked so far (not on every move)
  static std::atomic<int> set_bytes[MAX_DEVICES];
  auto kernel = sem_move_kernel<CPL, RPW>;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if ((int)bytes > set_bytes[dev].load()) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    set_bytes[dev].store((int)bytes);
  }
  kernel<<<W, threads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Floats of the CI workspace a launch needs (0 up to CI_MAX_RANK).
extern "C" long long sem_move_ci_workspace(int W, int n_det, int k,
                                           int threads) {
  return ci_workspace_floats(W, n_det, k, threads);
}

extern "C" int sem_move_max_threads(int cpl, int rpw) {
  return move_max_threads(cpl, rpw);
}

// Dynamic shared memory (bytes) of a launch.
extern "C" long long sem_move_smem_bytes(int n, int n_cols, int n_orb,
                                         int n_det, int ci, int smem_rows) {
  return 4 * (long long)move_smem_floats(n, n_cols, n_orb, n_det, ci != 0,
                                         smem_rows);
}

// The current device and a block's opt-in shared memory (bytes) on it.
static cudaError_t current_optin(int* dev, int* optin) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 *dev);
  return err;
}

extern "C" int sem_move_optin(int* out) {
  int dev = 0;
  return (int)current_optin(&dev, out);
}

// All pointers device pointers (the CI ones may be null when ci == 0); the
// CI lists are (n_det, k) int32 with k >= 2, and for k > CI_MAX_RANK ws
// holds sem_move_ci_workspace(W, n_det, k, threads) floats (else it may be
// null).  (cpl, rpw) a compiled variant with 32 cpl >= n unless rpw == 0;
// threads a multiple of 32 in [32, move_max_threads(cpl, rpw)].  Launches
// W blocks on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernel cannot run (nothing is launched then).
extern "C" int sem_move_launch(
    void* minv, const void* phi, long long phi_sw, long long phi_sc, void* r,
    const void* r_new, const void* d_jas, const void* logu, long long logu_s,
    void* sign, void* logdet, void* acc, void* margin, void* P, void* rdet,
    const void* r_other, const void* holes, const void* parts,
    const void* coeffs, void* ws, int W, int n, int n_cols, int n_e,
    int e, int j,
    int n_orb, int n_det, int k, int ci, int cpl, int rpw, int threads,
    int smem_rows, void* stream) {
  cudaGetLastError();            // clear a stale error of an earlier call
  const int bad = (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > move_max_threads(cpl, rpw) || threads % 32)
    return bad;
  if (rpw > 0 && 32 * cpl < n) return bad;
  if (e < 0 || e >= n || j < 0 || j >= n_e || smem_rows < 0) return bad;
  if (ci && (k < 2 || n_cols != n_orb
             || (k > CI_MAX_RANK && ws == nullptr)))
    return bad;
  if (!ci && n_cols < n) return bad;
  int dev = 0, optin = 0;
  const cudaError_t derr = current_optin(&dev, &optin);
  if (derr != cudaSuccess) return (int)derr;
  const long long bytes = sem_move_smem_bytes(n, n_cols, n_orb, n_det, ci,
                                              smem_rows);
  if (bytes > optin) return bad;
  MoveArgs a;
  a.minv = (float*)minv; a.phi = (const float*)phi;
  a.phi_sw = phi_sw; a.phi_sc = phi_sc;
  a.r = (float*)r; a.r_new = (const float*)r_new;
  a.d_jas = (const float*)d_jas; a.logu = (const float*)logu;
  a.logu_s = logu_s; a.sign = (float*)sign; a.logdet = (float*)logdet;
  a.acc = (uint8_t*)acc; a.margin = (float*)margin;
  a.P = (float*)P; a.rdet = (float*)rdet; a.r_other = (const float*)r_other;
  a.holes = (const int*)holes; a.parts = (const int*)parts;
  a.coeffs = (const float*)coeffs;
  a.ws = ci && k > CI_MAX_RANK ? (float*)ws : nullptr;
  a.ws_per = n_det < threads ? n_det : threads;
  a.n = n; a.n_cols = n_cols; a.n_e = n_e; a.e = e; a.j = j;
  a.n_orb = n_orb; a.n_det = n_det; a.k = k; a.ci = ci;
  a.smem_rows = smem_rows;
  if (W <= 0) return 0;
#define MOVE_CASE(C, R)                                                    \
  if (cpl == C && rpw == R)                                                \
    return launch_variant<C, R>(dev, W, threads, (size_t)bytes, stream,  \
                                a);
  MOVE_VARIANTS(MOVE_CASE)
#undef MOVE_CASE
  return bad;
}
