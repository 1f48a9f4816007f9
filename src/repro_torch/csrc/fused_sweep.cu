// Fused single-electron-move sweep of one spin block for Hopper (sm_90a),
// fp32 on the CUDA cores, state updated in place.
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
// step); each step looped over the electrons with fori_loop and ran the same
// jnp move math on the whole tile, vectorized over walkers, every operand
// padded to 128 lanes.
//
// What bounds it.  The n moves of one walker are a chain: each needs the
// inverse the previous one left.  The bytes (Minv read and written once,
// phi read once: ~21 MB per spin block at W = 256, n = 79, ~6 us at
// 3.35 TB/s) and the operations (~2 n^2 per move) are far below what the
// chain costs.  What a move costs on the card (chip_phases.py, SM cycles
// by clock64 marks, PERF.md): at n = 79 latency: the e-e pairs' chain of
// square roots and IEEE divisions (~700 cycles a pair), the dot, the
// decision, the update; at n = 217 shared-memory delivery: every thread
// takes its segment of phi and, on accept, of the new row from shared
// memory, n^2 floats a pass, 2 n^2 / 32 cycles a move at the crossbar's
// 32 lanes a cycle.  So the design removes dependent steps (barriers,
// reductions, loads from device memory) and keeps Minv where no pass
// moves it: in registers.
//
// Route "rows" (the size's choice for every single-determinant block up to
// n = 256, and for CI blocks whose P rows fit too; one block per walker):
//  * A thread owns a segment of L = R + S consecutive columns of one row of
//    Minv (threads 0 .. n*T-1), or with CI of P (from p_start, the next
//    multiple of 32): T = 1 or 2 threads a row, the tuned launch
//    parameter (kernels/fused_sweep/autotune.py).  R columns sit in
//    registers, S in shared memory (thread-major float4s, conflict-free);
//    the padding columns hold 0.  (R, S) is the first of ROWS_VARIANTS
//    (with CI ROWS_CI_VARIANTS) that covers the row in the registers and
//    shared memory of one SM: a thread gets at least R + 48 registers
//    (rows_max_threads: the SM's four register files of 16 384 each hold a
//    quarter of the warps).  The lists hold what blocks up to n = 256 need
//    at T = 1 and 2, each shape checked on the card with and without CI
//    (tests/test_torch_cuda_kernels.py).  At n = 79: T = 1, R = 80 (96
//    threads, 128 registers) or T = 2, R = 48 (160 threads, 96 registers).
//    At n = 217, T = 2: R = 64, S = 48, 448 threads of 128 registers
//    (57 344 of the SM's 65 536), 28 672 of Minv's 47 089 floats in
//    registers, one block per SM (two waves of 132 at W = 256); T = 1
//    holds the rows in shared memory only (R = 0, S = 224).  n = 225 ..
//    256 take T = 2 with (64, 64).  ptxas reports 16 bytes of spill for
//    (64, 48) and 8 for (80, 0) and (48, 0).
//  * The launch parameter T: the tuner measures the counts that need the
//    fewest waves of blocks for its W walkers (kernels/fused_sweep/
//    kernel.py::rows_shapes counts the blocks an SM holds, from the card's
//    own attributes), and where one count is left the size decides: at
//    n = 79 with CI, T = 1 keeps two blocks on an SM and W = 256 in one
//    wave, where T = 2 would take two.  A forced T runs wherever it fits.
//  * e-e pairs: pair i belongs to thread i % threads in every move, and
//    that thread also writes r_j on accept: the positions need no barrier.
//  * The pass: every row thread sums its segment against the proposal's
//    phi (broadcast from shared memory as float4, four partial sums) and
//    the T partials by shuffles, so u_i = Minv[i] . phi for all i: the
//    ratio is u_e, and row e's owners publish it with its log and their
//    register columns, raw.  P's owners form g_v; each warp folds its e-e
//    sums (and S_old's terms) into one shared slot.  Barrier 1 closes the
//    pass; every thread sums the slots in the same order (float4 reads)
//    and takes the same, block-uniform, decision.  u is computed on every
//    move: the ratio needs the same pass.
//  * On accept: row = Minv[e] / ratio, one column a thread (IEEE division,
//    as the plain version rounds it; the shared columns read in place),
//    barrier 2, then each thread updates its own row, M[i, c] <- M[i, c] -
//    u_i row[c] (product rounded first, no FMA contraction), row e <- row;
//    P's owners also write their row to P's mirror.  A rejected move
//    does no division and no update: one barrier.
//  * CI: the P table (n_orb x n) keeps a mirror in shared memory, because
//    ci_ratio_k reads it at scattered (part, hole) entries.  The division
//    comes on every move, before barrier 2; then one determinant a thread
//    (everything ci_ratio.cuh does: any rank <= CI_MAX_RANK, sentinels,
//    the near-node guard), S_new, barrier 3, the decision.
//  * The row buffer and the reduction slots alternate by the parity of the
//    move, so the next move writes them without waiting for the readers.
//  * Nothing from device memory on a move's path: r', the e-n deltas and
//    log u of all n moves are loaded once, the accept flags and margins
//    stored once at the end, and the proposals' phi rows go through a
//    ring of four shared buffers by 4-byte cp.async, three moves ahead
//    (the rows are not 16-byte aligned).  A move waits for the next row
//    just before barrier 1.
//  * Before the first move each thread loads its own row segment (the
//    loads are independent, so their latencies overlap); after the last,
//    Minv goes back through all the shared memory before the shared
//    columns, a chunk of rows at a time written as float4s, so that the
//    stores to device memory are coalesced (a warp's own would touch 32
//    rows each); P is loaded into and stored from its mirror.
//
// Routes "shared" and "global" (the first design, kept for what the rows
// route cannot hold: CI tables wider than its threads, n > 256): one block
// per walker, Minv (and P) in shared memory when they fit the 227 KB
// opt-in, else updated in place in device memory (n = 866 is 3.0 MB); per
// move the ratio and the e-e sums as block reductions, then on accept
// u = Minv phi one warp per row and the update one warp per row: four
// barriers and a load of phi from device memory on every move's path.
// Threads per block is their launch parameter.  The size picks rows, then
// shared, then global; any route can be forced where it fits.
//
// Tried and dropped (each measured by chip_phases.py on the H100):
//  * The row-e warp dividing row e inside the pass (one barrier a move):
//    its 3 to 7 serial divisions a lane cost more than barrier 2 and a
//    division a thread (~650 against ~260 cycles at n = 79, ~2700 against
//    ~240 at n = 217).
//  * At n = 217 the whole row in registers (R = 112, T = 2, 448 threads):
//    the register files give 128 a thread, and it spilled; R = 64 with
//    S = 48 does not.  All of the row in shared memory at one thread a row
//    (R = 0, S = 224) measures 1.6x slower than the split.
//  * Square roots and divisions of the e-e pairs written as the fast-path
//    sequences (branch-free, so they could interleave with the dot): no
//    gain; the pair's chain stays ~700 cycles.
//  * A butterfly of shuffles for the slot sums: no faster than float4
//    reads in order.
//  * Warps of their own for the e-e pairs (one pair a thread), to run
//    their chain beside the row threads' dot products: thread 0's cycles
//    a move fell ~18 % at n = 79, but the kernel did not (0.1419 against
//    0.1342 ms), and with R + 64 registers a thread the larger block held
//    one block an SM: two waves, 0.2087 ms.
//  * T = 4: at n = 79 segments of 32 floats put the four segments' float4
//    reads on the same banks, and it was ~2x slower; no size needs it
//    (T = 2 holds every n <= 256), so it is not offered.
//  * Loading Minv through shared memory in chunks of rows, as the stores
//    go: each chunk waits for its loads, and the serialized latency made
//    the loads 4x slower at n = 217 (36 K to 152 K cycles a sweep).
//
// Numerics.  Dot products and reductions are summed in another order than
// PyTorch's, so Minv, P and logdet agree with the plain version to fp32
// rounding, and accept decisions agree except on moves whose margin is
// within ~1e-5 of 0.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ci_ratio.cuh"
#include "move_step.cuh"

// Phase marks: empty here; csrc/fused_sweep_phases.cu defines them to record
// clock64() per phase (chip_phases.py reads them).
#ifndef FS_PHASE_MARKS
#define FS_CLOCK_INIT
#define FS_MARK(k)
#define FS_CLOCK_FLUSH
#endif

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
  int shared_tables;    // shared/global routes: 1 = tables in shared memory
  int per_row;          // rows route: threads per row (1 or 2)
  int p_start;          // rows route: first thread of P's rows
};

#define RED_SLOTS 32   // warps per block at most (1024 threads)

// Pade e-e value a d / (1 + b d) at the +1e-20-guarded distance.
__device__ __forceinline__ float pade_ee(float dx, float dy, float dz,
                                         float aee, float bee) {
  const float d = sqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
  return aee * d / (1.f + bee * d);
}

// ===================== routes "shared" and "global" =======================

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

// Floats of dynamic shared memory for one block of the shared/global
// routes.
__host__ __device__ inline size_t tables_smem_floats(int n, int n_cols,
                                                     int n_e, int n_orb,
                                                     int n_det, bool ci,
                                                     bool shared_tables) {
  size_t f = (size_t)3 * n_e + n_cols + 2 * (size_t)n + 5 * RED_SLOTS;
  if (ci) f += (size_t)n_orb + 2 * (size_t)n_det;
  if (shared_tables) f += (size_t)n * n + (ci ? (size_t)n_orb * n : 0);
  return f;
}

template <bool CI>
__global__ void fused_sweep_tables(SweepArgs a) {
  extern __shared__ float smem[];
  FS_CLOCK_INIT
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
  FS_MARK(6)

  for (int e = 0; e < n; ++e) {
    const int j = a.offset + e;
    for (int i = tid; i < n_cols; i += nt)
      phis[i] = phi_w[(size_t)e * n_cols + i];
    const size_t m = w * n + e;
    const float rpx = a.r_prop[3 * m], rpy = a.r_prop[3 * m + 1],
                rpz = a.r_prop[3 * m + 2];
    const float en_e = a.en[m], logu_e = a.logu[m];
    __syncthreads();     // phis in place; the previous move fully applied
    FS_MARK(1)
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
      v[1] += pade_ee(rpx - xi, rpy - yi, rpz - zi, aee, bee);
      v[2] += pade_ee(rox - xi, roy - yi, roz - zi, aee, bee);
    }
    if (CI)
      for (int d = tid; d < n_det; d += nt)
        v[3] += a.coeffs[d] * rd[d] * ro_w[d];
    block_sum<4>(v, red1);
    FS_MARK(0)
    const float ratio = v[0];
    const float log_ratio = log_abs_ratio(ratio);
    const float d_jas = (v[1] - v[2]) + en_e;

    float log_ci = 0.f;
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
      FS_MARK(4)
      log_ci = log_abs_ratio(s[0]) - log_abs_ratio(v[3]);
    }
    const float total = move_total(log_ratio, log_ci, d_jas, CI);
    const bool accept = move_accept(total, logu_e, ratio, CI);
    if (tid == 0) {
      a.acc[m] = accept ? 1 : 0;
      a.margin[m] = total - logu_e;
    }
    FS_MARK(8)
    if (!accept) {               // uniform over the block
      FS_MARK(3)
      continue;
    }

    if (tid == 0) {
      rpos[3 * j] = rpx; rpos[3 * j + 1] = rpy; rpos[3 * j + 2] = rpz;
      ld += log_ratio;
      sgn *= ratio_sign(ratio);
    }
    warp_rows_gemv(M, phis, nullptr, u, n, n);  // u = Minv phi
    if (!CI) {
      const float safe = row_divisor(ratio, false);
      for (int o = tid; o < n; o += nt) rowv[o] = M[(size_t)e * n + o] / safe;
    }
    __syncthreads();
    FS_MARK(5)
    for (int i = warp; i < n; i += nwarps) {
      float* Mi = M + (size_t)i * n;
      const float ui = u[i];
      if (i == e) {
        for (int o = lane; o < n; o += 32) Mi[o] = rowv[o];
      } else {
        for (int o = lane; o < n; o += 32)
          Mi[o] = sm_update(Mi[o], ui, rowv[o]);
      }
    }
    if (CI) {
      for (int vv = warp; vv < n_orb; vv += nwarps) {
        float* Pv = Pt + (size_t)vv * n;
        const float gvv = gv[vv];
        for (int h = lane; h < n; h += 32)
          Pv[h] = sm_update(Pv[h], gvv, rowv[h]);
      }
      for (int d = tid; d < n_det; d += nt) rd[d] = rd_new[d];
    }
    FS_MARK(3)
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
  FS_MARK(7)
  FS_CLOCK_FLUSH
}

// ============================== route "rows" ==============================

#define PHI_RING 4     // phi rows in flight: the move's own and three ahead

// Threads a block of the rows route may have when R columns of a row sit
// in registers: the SM's 65 536 registers are four files of 16 384, one per
// sub-partition, each holding a quarter of the block's warps, and a thread
// needs R + 48 (rounded up to 8) of them.  The launch refuses a larger
// block; kernels/fused_sweep/kernel.py::rows_max_threads is the chooser's
// copy.
__host__ __device__ constexpr int rows_max_threads(int R) {
  return 4 * 32 * (16384 / (32 * ((R + 48 + 7) / 8 * 8)) > 8
                       ? 8 : 16384 / (32 * ((R + 48 + 7) / 8 * 8)));
}

// Floats of dynamic shared memory for one block of the rows route; Lt =
// L * T, the padded row; S columns a thread in shared memory.  The launch
// takes this count; kernels/fused_sweep/kernel.py::smem_bytes checks the
// chooser's (rows_launch) against it.
__host__ __device__ inline size_t rows_smem_floats(int Lt, int S,
                                                   int threads, int n,
                                                   int n_cols, int n_e,
                                                   int n_orb, int n_det,
                                                   bool ci) {
  const size_t ldphi = ((size_t)Lt + (n_cols - n) + 3) / 4 * 4;
  size_t f = PHI_RING * ldphi + 2 * (size_t)Lt + (size_t)S * threads
             + 2 * 3 * RED_SLOTS + 8 + 3 * (size_t)n_e + 7 * (size_t)n;
  if (ci) f += (size_t)n_orb * n + n_orb + 4 * (size_t)n_det + RED_SLOTS;
  return f;
}

// Sum of the per-warp slots s[0 .. nwarps), in order, read as float4s (the
// slots past nwarps hold 0): every thread of the block gets the same bits.
__device__ __forceinline__ float slots_sum(const float* s, int nwarps) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < RED_SLOTS / 4; ++q) {
    if (4 * q >= nwarps) break;
    const float4 x = s4[q];
    v = (((v + x.x) + x.y) + x.z) + x.w;
  }
  return v;
}

// The thread's segment of a row (columns c0 ..) from a row-major table in
// shared memory: R columns into registers, S into its shared columns.
template <int R, int S>
__device__ __forceinline__ void take_row(float (&m)[R > 0 ? R : 1],
                                         float4* rs4, int nt,
                                         const float* src, int c0, int n) {
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (c0 + k < n) m[k] = src[c0 + k];
  for (int q = 0; q < S / 4; ++q) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + R + 4 * q + i;
      x[i] = c < n ? src[c] : 0.f;
    }
    rs4[q * nt] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// R columns of the thread's segment in registers, S more in shared memory,
// thread-major in float4s (columns R + 4q .. R + 4q + 3 of thread t at
// rs4[q * threads + t]: a warp's 32 accesses fill whole 128-byte phases).
// The loops over the S columns are not fully unrolled: they index shared
// memory, and unrolled they would hold an address per column in registers.
template <int R, int S, bool CI>
__global__ void __launch_bounds__(rows_max_threads(R), 1)
fused_sweep_rows(SweepArgs a) {
  constexpr int L = R + S;                  // columns a thread
  extern __shared__ float4 smem4[];
  FS_CLOCK_INIT
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t w = blockIdx.x;
  const int n = a.n, n_cols = a.n_cols, n_e = a.n_e, T = a.per_row;
  const int n_orb = CI ? a.n_orb : 0, n_det = CI ? a.n_det : 0;
  const int Lt = L * T;
  const int seg = tid % T, c0 = seg * L;    // the segment's first column
  // the thread's row: Minv row `row`, or (CI) P row `prow`
  const int row = tid < n * T ? tid / T : -1;
  const int prow = (CI && tid >= a.p_start && tid < a.p_start + n_orb * T)
                       ? (tid - a.p_start) / T : -1;
  const int ldphi = (Lt + (n_cols - n) + 3) / 4 * 4;

  float* p = reinterpret_cast<float*>(smem4);
  float* phib = p; p += PHI_RING * ldphi;   // phi ring: [occ | 0 pad | virt]
  float* rowb = p; p += 2 * Lt;             // row e (/ ratio), by parity
  float* red = p; p += 2 * 3 * RED_SLOTS;   // warp sums, by parity
  float* redr = p; p += 4;                  // ratio and log, by parity
  float* red2 = nullptr;
  if (CI) { red2 = p; p += RED_SLOTS; }     // S_new's warp sums
  float* rpos = p; p += 3 * n_e;
  float* rprop = p; p += 3 * n;
  float* ens = p; p += n;
  float* logus = p; p += n;
  float* outm = p; p += n;                  // margins, stored at the end
  float* outa = p; p += n;                  // accept flags, likewise
  float *Pm = nullptr, *gb = nullptr, *rd = nullptr, *rdn = nullptr,
        *cf = nullptr, *ro = nullptr;
  if (CI) {
    Pm = p; p += (size_t)n_orb * n;         // P's mirror, (n_orb, n)
    gb = p; p += n_orb;
    rd = p; p += n_det;
    rdn = p; p += n_det;
    cf = p; p += n_det;
    ro = p; p += n_det;
  }
  // this thread's shared columns, last (after the loop everything before
  // them is free: the stores go through it)
  float4* rs_all = reinterpret_cast<float4*>(
      reinterpret_cast<float*>(smem4) + (p - reinterpret_cast<float*>(smem4)
                                         + 3) / 4 * 4);
  float4* rs4 = rs_all + tid;

  const float* phi_w = a.phi + w * (size_t)n * n_cols;
  // phi row q into ring slot q % PHI_RING; occupied columns at [0, n),
  // virtual ones (CI) at [Lt, Lt + n_cols - n)
  auto issue_phi = [&](int q) {
    float* dst = phib + (q % PHI_RING) * ldphi;
    const float* src = phi_w + (size_t)q * n_cols;
    for (int c = tid; c < n_cols; c += nt)
      __pipeline_memcpy_async(dst + (c < n ? c : Lt + c - n), src + c, 4);
  };
  // Minv's rows straight from device memory (each thread's loads are
  // independent, so their latencies overlap); P through its mirror.
  float m[R > 0 ? R : 1];
#pragma unroll
  for (int k = 0; k < R; ++k) m[k] = 0.f;
  for (int q = 0; q < S / 4; ++q) rs4[q * nt] = make_float4(0.f, 0.f, 0.f,
                                                            0.f);
  if (row >= 0)
    take_row<R, S>(m, rs4, nt, a.minv + (w * n + row) * (size_t)n, c0, n);
  if (CI) {
    const float* gP = a.P + w * (size_t)n_orb * n;
    for (int i = tid; i < n_orb * n; i += nt) Pm[i] = gP[i];
    for (int d = tid; d < n_det; d += nt) {
      rd[d] = a.rdet[w * n_det + d];
      cf[d] = a.coeffs[d];
      ro[d] = a.r_other[w * n_det + d];
    }
    __syncthreads();
    if (prow >= 0) take_row<R, S>(m, rs4, nt, Pm + (size_t)prow * n, c0, n);
  }

  for (int i = tid; i < PHI_RING * ldphi; i += nt) phib[i] = 0.f;
  for (int i = tid; i < 2 * Lt; i += nt) rowb[i] = 0.f;
  for (int i = tid; i < 2 * 3 * RED_SLOTS + 4; i += nt) red[i] = 0.f;
  if (CI)
    for (int i = tid; i < RED_SLOTS; i += nt) red2[i] = 0.f;
  __syncthreads();     // the zero padding stays: the copies skip it
  for (int q = 0; q < PHI_RING - 1; ++q) {
    if (q < n) issue_phi(q);
    __pipeline_commit();
  }

  for (int i = tid; i < 3 * n_e; i += nt) rpos[i] = a.r[w * 3 * n_e + i];
  for (int i = tid; i < 3 * n; i += nt) rprop[i] = a.r_prop[w * 3 * n + i];
  for (int i = tid; i < n; i += nt) {
    ens[i] = a.en[w * n + i];
    logus[i] = a.logu[w * n + i];
  }
  float sgn = a.sign[w], ld = a.logdet[w];     // thread 0's copies count
  const float bee = *a.b_ee;
  int j_owner = a.offset % nt;                 // the thread of pair j
  __pipeline_wait_prior(PHI_RING - 2);         // phi row 0 landed
  __syncthreads();
  FS_MARK(6)

  for (int e = 0; e < n; ++e) {
    const int par = e & 1;
    const int j = a.offset + e;
    if (e + PHI_RING - 1 < n) issue_phi(e + PHI_RING - 1);
    __pipeline_commit();
    const float* ph = phib + (e % PHI_RING) * ldphi;
    const float4* ph4 = reinterpret_cast<const float4*>(ph + c0);
    float* rv = rowb + par * Lt;

    // u_i = Minv[i] . phi (P threads: P[v] . phi_occ), T partials folded
    float acc;
    {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int k = 0; k < R; k += 4) {
        const float4 q = ph4[k / 4];
        s0 = fmaf(m[k], q.x, s0);
        s1 = fmaf(m[k + 1], q.y, s1);
        s2 = fmaf(m[k + 2], q.z, s2);
        s3 = fmaf(m[k + 3], q.w, s3);
      }
#pragma unroll 4
      for (int q = 0; q < S / 4; ++q) {
        const float4 x = rs4[q * nt], y = ph4[R / 4 + q];
        s0 = fmaf(x.x, y.x, s0);
        s1 = fmaf(x.y, y.y, s1);
        s2 = fmaf(x.z, y.z, s2);
        s3 = fmaf(x.w, y.w, s3);
      }
      acc = (s0 + s1) + (s2 + s3);
      for (int off = T >> 1; off > 0; off >>= 1)
        acc += __shfl_xor_sync(FULL_MASK, acc, off);
    }
    FS_MARK(9)
    if (row == e) {           // row e's register columns, raw, for the split
      float4* dst = reinterpret_cast<float4*>(rv + c0);
#pragma unroll
      for (int k = 0; k < R; k += 4)
        dst[k / 4] = make_float4(m[k], m[k + 1], m[k + 2], m[k + 3]);
      if (seg == 0) {                         // the ratio and its log
        redr[2 * par] = acc;
        redr[2 * par + 1] = log_abs_ratio(acc);
      }
    }
    float g_v = 0.f;
    if (CI && prow >= 0) {
      g_v = acc - ph[prow < n ? prow : Lt + prow - n];
      if (seg == 0) gb[prow] = g_v;
    }

    // e-e sums at the new and the old point (pair i on thread i % threads
    // in every move); S_old
    const float rpx = rprop[3 * e], rpy = rprop[3 * e + 1],
                rpz = rprop[3 * e + 2];
    const float rox = rpos[3 * j], roy = rpos[3 * j + 1],
                roz = rpos[3 * j + 2];
    const bool j_up = j < a.n_up;
    float v_new = 0.f, v_old = 0.f, v_s = 0.f;
    for (int i = tid; i < n_e; i += nt) {
      if (i == j) continue;
      const float aee = ((i < a.n_up) == j_up) ? 0.25f : 0.5f;
      const float xi = rpos[3 * i], yi = rpos[3 * i + 1], zi = rpos[3 * i + 2];
      v_new += pade_ee(rpx - xi, rpy - yi, rpz - zi, aee, bee);
      v_old += pade_ee(rox - xi, roy - yi, roz - zi, aee, bee);
    }
    if (CI)
      for (int d = tid; d < n_det; d += nt) v_s += cf[d] * rd[d] * ro[d];
    FS_MARK(10)
    v_new = warp_sum(v_new);
    v_old = warp_sum(v_old);
    if (CI) v_s = warp_sum(v_s);
    float* rp = red + par * 3 * RED_SLOTS;
    if (lane == 0) {
      rp[warp] = v_new;
      rp[RED_SLOTS + warp] = v_old;
      if (CI) rp[2 * RED_SLOTS + warp] = v_s;
    }
    FS_MARK(0)
    __pipeline_wait_prior(PHI_RING - 2);       // phi row e + 1 landed
    FS_MARK(1)
    __syncthreads();                           // barrier 1
    FS_MARK(2)
    const float ratio = redr[2 * par], log_ratio = redr[2 * par + 1];

    // row = Minv[e] / ratio, one column a thread (IEEE division, as the
    // plain version rounds it); the shared columns read in place.  CI:
    // unguarded (a zero ratio makes the comparison NaN, hence rejected);
    // single determinant: the plain version's guard, and only on accept.
    auto divide_row = [&]() {
      const float d = row_divisor(ratio, CI);
      for (int c = tid; c < n; c += nt) {
        const int s = c / L, k = c - s * L;
        const float x = k < R ? rv[c]
            : reinterpret_cast<const float*>(
                  rs_all + ((k - R) >> 2) * nt + e * T + s)[(k - R) & 3];
        rv[c] = x / d;
      }
    };
    float log_ci = 0.f;
    const float ee_new = slots_sum(rp, nwarps);
    const float ee_old = slots_sum(rp + RED_SLOTS, nwarps);
    const float d_jas = (ee_new - ee_old) + ens[e];
    const float logu_e = logus[e];
    if (CI) {
      const float s_old = slots_sum(rp + 2 * RED_SLOTS, nwarps);
      divide_row();
      __syncthreads();                         // barrier 2
      FS_MARK(5)
      // every determinant's ratio from P (old), g and row; S_new
      float s = 0.f;
      for (int d = tid; d < n_det; d += nt) {
        const float det = ci_ratio_k(Pm, gb, rv, a.holes + (size_t)d * a.k,
                                     a.parts + (size_t)d * a.k, a.k, n_orb,
                                     n);
        rdn[d] = det;
        s += cf[d] * det * ro[d];
      }
      s = warp_sum(s);
      if (lane == 0) red2[warp] = s;
      __syncthreads();                         // barrier 3
      const float s_new = slots_sum(red2, nwarps);
      FS_MARK(4)
      log_ci = log_abs_ratio(s_new) - log_abs_ratio(s_old);
    }
    const float total = move_total(log_ratio, log_ci, d_jas, CI);
    const bool accept = move_accept(total, logu_e, ratio, CI);
    if (tid == 0) {
      outa[e] = accept ? 1.f : 0.f;
      outm[e] = total - logu_e;
    }
    FS_MARK(8)
    if (accept) {                              // uniform over the block
      if (!CI) {
        divide_row();
        __syncthreads();                       // barrier 2
        FS_MARK(5)
      }
      const float4* rv4 = reinterpret_cast<const float4*>(rv + c0);
      if (row == e) {
#pragma unroll
        for (int k = 0; k < R; k += 4) {
          const float4 q = rv4[k / 4];
          m[k] = q.x; m[k + 1] = q.y; m[k + 2] = q.z; m[k + 3] = q.w;
        }
        for (int q = 0; q < S / 4; ++q) rs4[q * nt] = rv4[R / 4 + q];
      } else if (row >= 0 || (CI && prow >= 0)) {
        const float c = row >= 0 ? acc : g_v;
#pragma unroll
        for (int k = 0; k < R; k += 4) {
          const float4 q = rv4[k / 4];
          m[k] = sm_update(m[k], c, q.x);
          m[k + 1] = sm_update(m[k + 1], c, q.y);
          m[k + 2] = sm_update(m[k + 2], c, q.z);
          m[k + 3] = sm_update(m[k + 3], c, q.w);
        }
#pragma unroll 4
        for (int q = 0; q < S / 4; ++q) {
          const float4 y = rv4[R / 4 + q];
          float4 x = rs4[q * nt];
          x.x = sm_update(x.x, c, y.x);
          x.y = sm_update(x.y, c, y.y);
          x.z = sm_update(x.z, c, y.z);
          x.w = sm_update(x.w, c, y.w);
          rs4[q * nt] = x;
        }
        if (CI && prow >= 0) {
          float* dst = Pm + (size_t)prow * n + c0;
#pragma unroll
          for (int k = 0; k < R; ++k)
            if (c0 + k < n) dst[k] = m[k];
          for (int q = 0; q < S / 4; ++q) {
            const float4 x = rs4[q * nt];
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (c0 + R + 4 * q + i < n) dst[R + 4 * q + i] = xs[i];
          }
        }
      }
      if (CI)
        for (int d = tid; d < n_det; d += nt) rd[d] = rdn[d];
      if (tid == j_owner) {      // pair j's thread: the only reader of r_j
        rpos[3 * j] = rprop[3 * e];
        rpos[3 * j + 1] = rprop[3 * e + 1];
        rpos[3 * j + 2] = rprop[3 * e + 2];
      }
      if (tid == 0) {
        ld += log_ratio;
        sgn *= ratio_sign(ratio);
      }
    }
    FS_MARK(3)
    j_owner = j_owner + 1 == nt ? 0 : j_owner + 1;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int i = tid; i < 3 * n_e; i += nt) a.r[w * 3 * n_e + i] = rpos[i];
  for (int i = tid; i < n; i += nt) {
    a.acc[w * n + i] = outa[i] != 0.f ? 1 : 0;
    a.margin[w * n + i] = outm[i];
  }
  if (CI) {
    for (int d = tid; d < n_det; d += nt) a.rdet[w * n_det + d] = rd[d];
    float* gP = a.P + w * (size_t)n_orb * n;
    for (int i = tid; i < n_orb * n; i += nt) gP[i] = Pm[i];
  }
  if (tid == 0) {
    a.sign[w] = sgn;
    a.logdet[w] = ld;
  }
  __syncthreads();
  // Minv back through the shared memory before the shared columns (all
  // free now), a chunk of rows at a time, each row written as float4s:
  // a warp's own stores to device memory would touch 32 rows each
  {
    float* stage = reinterpret_cast<float*>(smem4);
    const int ld4 = (n + 3) / 4 * 4;
    const int rows_a_chunk = (int)(reinterpret_cast<float*>(rs_all) - stage)
                             / ld4;
    float* gM = a.minv + w * (size_t)n * n;
    for (int r0 = 0; r0 < n; r0 += rows_a_chunk) {
      const int r1 = min(n, r0 + rows_a_chunk);
      if (row >= r0 && row < r1) {
        float4* dst = reinterpret_cast<float4*>(
            stage + (size_t)(row - r0) * ld4 + c0);
#pragma unroll
        for (int k = 0; k < R; k += 4)
          if (c0 + k < ld4)
            dst[k / 4] = make_float4(m[k], m[k + 1], m[k + 2], m[k + 3]);
        for (int q = 0; q < S / 4; ++q)
          if (c0 + R + 4 * q < ld4) dst[R / 4 + q] = rs4[q * nt];
      }
      __syncthreads();
      for (int i = tid; i < (r1 - r0) * n; i += nt) {
        const int rr = i / n;
        gM[(size_t)r0 * n + i] = stage[(size_t)rr * ld4 + (i - rr * n)];
      }
      __syncthreads();
    }
  }
  FS_MARK(7)
  FS_CLOCK_FLUSH
}

// ================================ host side ================================

// (R, S) pairs the rows route is compiled for, in the order of preference:
// R columns a thread in registers, S in shared memory; with CI the pairs
// whose blocks fit (at S = 224 the P rows' threads never do).  The chooser,
// kernels/fused_sweep/kernel.py, reads both lists from this file.
#define ROWS_VARIANTS(X) X(48, 0) X(80, 0) X(64, 48) X(64, 64) X(0, 224)
#define ROWS_CI_VARIANTS(X) X(48, 0) X(80, 0) X(64, 48) X(64, 64)

template <typename K>
static int launch_kernel(K kernel, int W, int threads, size_t bytes,
                         void* stream, const SweepArgs& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<W, threads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool CI>
static int launch_rows(int R, int S, int W, int threads, size_t bytes,
                       void* stream, const SweepArgs& a) {
#define ROWS_CASE(RR, SS)                                                  \
  if (R == RR && S == SS)                                                  \
    return launch_kernel(fused_sweep_rows<RR, SS, CI>, W, threads, bytes,  \
                         stream, a);
  if constexpr (CI) {
    ROWS_CI_VARIANTS(ROWS_CASE)
  } else {
    ROWS_VARIANTS(ROWS_CASE)
  }
#undef ROWS_CASE
  return (int)cudaErrorInvalidValue;
}

static bool rows_variant(int R, int S, bool ci) {
#define ROWS_IS(RR, SS) if (R == RR && S == SS) return true;
  if (ci) {
    ROWS_CI_VARIANTS(ROWS_IS)
  } else {
    ROWS_VARIANTS(ROWS_IS)
  }
#undef ROWS_IS
  return false;
}

extern "C" int fused_sweep_max_rank() { return CI_MAX_RANK; }

// What the chooser reads of the current device: SMs, per SM the registers,
// shared memory (bytes) and threads, a block's opt-in shared memory.
extern "C" int fused_sweep_card(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[5] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxRegistersPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin};
  for (int i = 0; i < 5 && err == cudaSuccess; ++i)
    err = cudaDeviceGetAttribute(out + i, attrs[i], dev);
  return (int)err;
}

// Dynamic shared memory (bytes) of a launch; route 1 shared, 2 global,
// 3 rows (per_row threads a row, R + S columns a thread, `threads` per
// block); -1 when the route has no such shape.
extern "C" long long fused_sweep_smem_bytes(int n, int n_cols, int n_e,
                                            int n_orb, int n_det, int ci,
                                            int route, int per_row, int R,
                                            int S, int threads) {
  if (route == 1 || route == 2)
    return 4 * (long long)tables_smem_floats(n, n_cols, n_e, n_orb, n_det,
                                             ci != 0, route == 1);
  if (route != 3 || !rows_variant(R, S, ci != 0)) return -1;
  return 4 * (long long)rows_smem_floats((R + S) * per_row, S, threads, n,
                                         n_cols, n_e, n_orb, n_det, ci != 0);
}

// All pointers device pointers (CI ones may be null when ci == 0); the CI
// lists are (n_det, k) with 2 <= k <= CI_MAX_RANK.  route: 1 shared, 2
// global (threads per block: a multiple of 32 in [32, 1024]), 3 rows
// (per_row 1 or 2, a compiled (R, S) with (R + S) per_row >= n;
// threads and p_start as kernels/fused_sweep/kernel.py::launch_shape
// gives them).  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the route cannot run (nothing is
// launched then).
extern "C" int fused_sweep_launch(
    void* minv, const void* phi, void* r, const void* r_prop, const void* en,
    const void* logu, void* sign, void* logdet, void* acc, void* margin,
    const void* b_ee, void* P, void* rdet, const void* r_other,
    const void* holes, const void* parts, const void* coeffs, int W, int n,
    int n_cols, int n_e, int offset, int n_up, int n_orb, int n_det, int k,
    int ci, int threads, int route, int per_row, int R, int S, int p_start,
    void* stream) {
  cudaGetLastError();            // clear a stale error of an earlier call
  const int bad = (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > 1024 || threads % 32) return bad;
  if (ci && (k < 2 || k > CI_MAX_RANK)) return bad;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const long long bytes = fused_sweep_smem_bytes(
      n, n_cols, n_e, n_orb, n_det, ci, route, per_row, R, S, threads);
  if (bytes < 0 || bytes > optin) return bad;
  if (route == 3) {
    if (per_row != 1 && per_row != 2) return bad;
    const int need = ci ? p_start + n_orb * per_row : n * per_row;
    if ((R + S) * per_row < n || need > threads
        || threads > rows_max_threads(R))
      return bad;
    if (ci && (p_start < n * per_row || p_start % 32)) return bad;
  }
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
  a.shared_tables = route == 1;
  a.per_row = per_row;
  a.p_start = p_start;
  if (W <= 0 || n <= 0) return 0;
  if (route == 3)
    return ci ? launch_rows<true>(R, S, W, threads, bytes, stream, a)
              : launch_rows<false>(R, S, W, threads, bytes, stream, a);
  return ci ? launch_kernel(fused_sweep_tables<true>, W, threads, bytes,
                            stream, a)
            : launch_kernel(fused_sweep_tables<false>, W, threads, bytes,
                            stream, a);
}
