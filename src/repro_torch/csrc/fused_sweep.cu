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
//          excitation rank (ci_ratio.cuh: cofactors for k <= 3, pivoted
//          elimination beyond, in registers up to CI_MAX_RANK, in the
//          workspace the wrapper passes above)
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
//    (everything ci_ratio.cuh does: any rank, sentinels,
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
// Route "cluster" (the size's choice for blocks past n = 256 up to n =
// 896, the paper's 1ZE7 at n = 528 and 1AMB at 866 / 865;
// kernel.py::cluster_launch; with CI see below).  What bounds it: one SM cannot hold
// the inverse (n = 866: 3.0 MB), and the global route streams it from
// device memory on every accepted move (0.9 ms a move at W = 256).  So one
// thread block cluster of C blocks a walker holds it on chip for the
// whole sweep, and what a move costs is its chain of dependent steps: the
// dot, the exchange between the blocks, the decision, the division, the
// update.
//  * Layout: block b holds rows b ceil(n / C) .. in registers, all of
//    them: warp g its K rows b ceil(n / C) + g K .., lane s their columns
//    s L .. s L + L - 1 (32 L >= n; L / 4 odd, so a quarter warp's float4
//    reads of phi and of the new row fall on distinct banks).  Compiled
//    (K, L): CLUSTER_VARIANTS; a thread has at most 255 registers at 256
//    threads, K L <= 207.  n = 866: C = 16, (7, 28), 256 threads, 55 rows
//    a block, 70 064 B of shared memory, 255 registers (44 B spilled); n =
//    528: C = 8 (the tuner's pick over 16), (9, 20), 256 threads, 66 rows.
//    Clusters of 16 are non-portable (allowed before the launch); the card
//    holds 7 of them at once (cudaOccupancyMaxActiveClusters: a cluster
//    takes one GPC), so W = 256 runs in 37 waves; 15 of 8.
//  * The pass: every warp's dot of its K rows with phi (the lane's L
//    columns, then a butterfly a row: every lane gets the bits); row e's
//    warp sends the ratio and its log to every block, row e + 1's warp
//    its u and its row as it stands (lane s's columns to block s % C: the
//    first of two hops); the warps that hold e-e pairs send their sums to
//    every block (pair i of the block's ceil(n_e / C) on thread (i - i0)
//    % threads).  The e-e sums were computed while the block waited for
//    the previous move's values: every pair but the previous mover's,
//    whose term is taken at both of its points and picked once that move
//    is decided.
//  * The exchange: asynchronous stores into the other blocks' shared
//    memory (st.async), each counted on an mbarrier of the block written
//    to (mbarrier::complete_tx::bytes); a block waits on its own mbarrier
//    for the bytes of the move (expected(e)), then sums the slots in one
//    order, so every block takes the same decision.  Buffers and
//    mbarriers rotate over CLUSTER_BUFS = 3 moves: a block may run a move
//    ahead of another, never two (it needs the other's next values).
//  * On accept every block divides its own copy of row e by the ratio, one
//    column a thread (IEEE division, the plain version's guard): row e as
//    move e - 1 found it (the second hop: after its own wait each block
//    forwards the columns it received to every block, counted on move
//    e + 1's mbarrier) updated by move e - 1 exactly as its owner updated
//    it (the same operands, so the same bits); then, after one
//    __syncthreads, each thread updates its K rows (sm_update: product
//    rounded first), row e <- row.
//  * Nothing from device memory on a move's path but the phi ring (as the
//    rows route's); r', r before the move, the e-n deltas and log u of all
//    n moves are loaded once, the accept flags and margins stored as each
//    move is decided, Minv staged at the end through the shared memory
//    below the mbarriers (never over them).
//
// Route "cluster" with CI (the size's choice for CI blocks past n = 256
// up to rank CI_MAX_RANK, the paper's 1ZE7 and 1AMB at --n-det 100: n_orb
// = 792 / 1299, 100 determinants of rank 2; kernel.py::launch_shape).
// What bounds it: the first design kept P (n_orb x n, 4.5 MB a walker at
// 1AMB) in device memory and read all of it on every move for g = P phi
// - phi (1.15 GB a move at W = 256, more than L2 holds), then wrote it
// back on every accepted one.  But the ratios read P only at the
// expansion's (particle, hole) entries and g only at its particles, and
// every other row of P follows its own chain over the accepted moves that
// never feeds a decision back.  So the route runs in two launches:
//  * The chain: the single determinant's cluster route, Minv in registers
//    as above, and each block holds its ceil(D / C) of the expansion's D
//    distinct particle rows of P in shared memory (D = 64 to 76 a spin
//    block for the paper's expansions: 5 rows of 896 floats a block at
//    1AMB, 9 of 640 at 1ZE7; kernel.py::ci_maps builds the maps once from
//    the lists), laid out as a warp's rows of Minv (lane s columns s L ..).
//    Every move each warp dots its held rows with phi[:n] from the ring
//    (phi at the held particles rides in the ring too) and sends g = dot -
//    phi[p] to every block through the exchange (counted in expected(e):
//    4 D bytes more a move).  Then every block divides all of row e by
//    the ratio (one column a thread; the ratios need row_t at the holes,
//    and a division of the whole row every move spares the accepted move
//    the division's own barrier), and computes every determinant's ratio
//    from a compact table of P at the expansion's E (particle, hole)
//    entries (two constants for the sentinels' blocks first: 0 and 1; E
//    = 109 to 121), replicated in every block, the exchanged g and the
//    row (ci_ratio.cuh's determinants through the CiCompact accessor:
//    cofactors up to rank 3, beyond the elimination in a k x k slot of
//    shared memory, which keeps the register file to Minv); S_new and
//    S_old are summed in one order, so every block takes the same
//    decision.  On accept every block updates its held rows and the
//    table with the same operands (sm_update: the table's entries stay
//    the rows' bits), takes rdet_new, and writes its columns of the new
//    row to rows (W, n, ldr) in device memory: 285 MB at 1ZE7, 768 MB at
//    1AMB for W = 256.  Two barriers a move beyond the single
//    determinant's: the division's and S's.
//  * The replay (fused_sweep_p_replay): every row of P the chain did not
//    hold, brought up to date over the accepted moves in order with the
//    plain version's arithmetic (ref.py::p_replay_ref): one block of 256
//    threads a (walker, tile of 8 RW rows), the tile in registers (warp g
//    rows g RW .., lane s columns s + 32 j, j < J: REPLAY_VARIANTS), the
//    accepted moves' rows and phi through a ring of REPLAY_RING stages in
//    shared memory by cp.async (the flags compacted into a list first, so
//    rejected moves cost nothing).  Its work is 4 n_orb n operations an
//    accepted move a walker, in parallel over walkers and tiles: no chain
//    of dependent moves but the rows' own.
//  What a move of the chain costs (chip_phases.py, SM cycles a move on
//  thread 0 at 1AMB's widths, n = 866, W = 256, clusters of 16; the single
//  determinant's in brackets): dots 2518 (2275), the pass's barrier 1460
//  (1375), the division and its barrier 1312 (408, accepted moves only),
//  the determinants, S and their barrier 1756, the held rows' g 748, the
//  update 2284 (1515); 10 954 in all (6760).  Tried and dropped: dividing
//  only the hole entries every move, as the ratios need, and the whole
//  row on the accepted moves (59 % here) behind a barrier of their own:
//  the chain took 43.72 / 168.32 ms a spin block at n = 528 / 866
//  against this design's 40.41 / 142.20 ms (one call, the two in turns,
//  timed by chip_smoke.py's _fused_times and _replay_split).
//  ptxas (-Xptxas -v, sm_90a): the chain's threads sit at 255 registers,
//  (7, 28) spilling 92 B (132 B loaded; the single determinant 44 B),
//  (9, 20) 44 B (none), (16, 12) 156 B (none); the replay's (8, 8),
//  (4, 17), (3, 28) take 118, 115 and 128 registers under
//  __launch_bounds__(256, 2), none spilled.
//
// Routes "shared" and "global" (the first design, kept for what the rows
// and cluster routes cannot hold: CI tables wider than the rows route's
// threads, CI past rank CI_MAX_RANK or whose held rows no cluster holds
// past n = 256, n > 896): one block
// per walker, Minv (and P) in shared memory when they fit the 227 KB
// opt-in, else updated in place in device memory (n = 866 is 3.0 MB); per
// move the ratio and the e-e sums as block reductions, then on accept
// u = Minv phi one warp per row and the update one warp per row: four
// barriers and a load of phi from device memory on every move's path.
// Threads per block is their launch parameter.  The size picks rows, then
// cluster, then shared, then global; any route can be forced where it
// fits.
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
//  Of the cluster route (chip_phases.py, synthetic blocks at W = 256;
//  instrumented times at n = 528 / 866, SM cycles a move at n = 866):
//  * The rows route's layout on the cluster (T = 8 threads a row, R + S =
//    48 + 20 and 64 + 52 columns): every thread takes its segment of phi
//    and of the new row from shared memory, dot 2971 and update 2300
//    cycles a move; 37.95 / 167.49 ms.  The register tile: 28.61 / 123.57.
//  * Row e pulled from its owner after the barrier (ld.shared::cluster):
//    the owner's SM serves 15 blocks 3.5 KB each, 1697 cycles a move for
//    the division against 397 with the two hops one move ahead.
//  * barrier.cluster to close each move: its release compiles to
//    MEMBAR.ALL.GPU (cuobjdump -sass); 31.19 / 123.49 ms against 28.27 /
//    114.13 with the mbarrier exchange.
//  * The update of move e - 1 and the dot of move e + 1 (its u as s - u t)
//    deferred into the wait: at 255 registers the extra values spilled
//    (132 B) and the wait outlasted the exchange; 36.84 / 144.16 ms.
//  * A halving reduction of the K row sums (16 shuffles against 35 at K =
//    7): no faster at n = 866 (86.88 against 85.78 ms, uninstrumented),
//    and (9, 20) spilled: 25.65 against 23.07 ms at n = 528.
//
// Numerics.  Dot products and reductions are summed in another order than
// PyTorch's, so Minv, P and logdet agree with the plain version to fp32
// rounding, and accept decisions agree except on moves whose margin is
// within ~1e-5 of 0.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ci_ratio.cuh"
#include "move_step.cuh"

// Phase marks: empty here; csrc/fused_sweep_phases.cu defines them to record
// clock64() per phase (chip_phases.py reads them).
namespace cg = cooperative_groups;

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
  float* ws;            // ci_workspace_floats   (CI, k > CI_MAX_RANK)
  int ws_per;           // workspace slots a walker: min(threads, n_det)
  int n, n_cols, n_e, offset, n_up, n_orb, n_det, k;
  int shared_tables;    // shared/global routes: 1 = tables in shared memory
  int per_row;          // rows route: threads per row (1 or 2)
  int p_start;          // rows route: first thread of P's rows
  int cluster;          // cluster route: blocks a walker
  int rows_per;         // cluster route: rows a block, ceil(n / cluster)
  // cluster route with CI (kernels/fused_sweep/kernel.py::ci_maps):
  const int* held;      // (n_held,) the expansion's particles, sorted
  const int* ent;       // (n_det, k, k) each entry's place in the table
  const int* pslot;     // (n_det, k) each particle's held slot, -1 pad
  const int* pair_slot; // (n_pairs,) held slot of each table entry
  const int* pair_hole; // (n_pairs,) its hole
  float* rows;          // (W, n, ldr) the accepted moves' rows (out)
  int n_held, n_pairs, ldr;
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
  float* ws_slot = a.ws != nullptr ? a.ws + w * a.ws_per + tid : nullptr;
  const long long ws_ld = (long long)gridDim.x * a.ws_per;
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
                                     n, ws_slot, ws_ld);
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
  float* ws_slot = a.ws != nullptr ? a.ws + w * a.ws_per + tid : nullptr;
  const long long ws_ld = (long long)gridDim.x * a.ws_per;
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
                                     n, ws_slot, ws_ld);
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

// ============================ route "cluster" =============================

// One cluster barrier: every thread of every block of the cluster arrives
// (its earlier writes released: a fence over the whole card, ~0.4 us) and
// waits (acquiring everyone's).  Used before and after the sweep only.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// The moves exchange their values by asynchronous stores into the other
// blocks' shared memory, each counted on an mbarrier of the block written
// to (st.async ... mbarrier::complete_tx): a block waits on its own
// mbarrier for the bytes of a move, with no fence and no cluster barrier.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// The same shared-memory offset in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(uint32_t a, float v,
                                         uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
               "[%0], %1, [%2];"
               :: "r"(a), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t a, float2 v,
                                         uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32"
               " [%0], {%1, %2}, [%3];"
               :: "r"(a), "r"(__float_as_uint(v.x)),
                  "r"(__float_as_uint(v.y)), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t a, float4 v,
                                         uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
               " [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(a), "r"(__float_as_uint(v.x)),
                  "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
                  "r"(__float_as_uint(v.w)), "r"(bar) : "memory");
}
// This thread's arrival on a local mbarrier, expecting `bytes` more.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Wait until the mbarrier's phase of this parity is complete; a kernel
// whose bytes never come traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t ok;
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// The warp's sum in every lane, by a butterfly (each step adds the same two
// values in every lane of a pair, so every lane gets the same bits).
__device__ __forceinline__ float warp_all_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// Warps of a cluster-route block that hold e-e pairs (pair i of the
// block's pe on thread (i - i0) % threads): their sums cross the cluster.
__host__ __device__ inline int cluster_pair_warps(int pe, int threads) {
  const int t = pe < threads ? pe : threads;
  return (t + 31) / 32;
}

#define CLUSTER_BUFS 3   // buffers a move's exchange rotates through

// Floats of dynamic shared memory for one block of the cluster route (L
// columns a lane, 32 L the padded row; C blocks a walker);
// kernels/fused_sweep/kernel.py::cluster_launch is the chooser's copy.
__host__ __device__ inline size_t cluster_smem_floats(int L, int threads,
                                                      int n, int n_e,
                                                      int C) {
  const int pe = (n_e + C - 1) / C;
  const size_t f = (PHI_RING + 2 * CLUSTER_BUFS + 1) * 32 * (size_t)L
                   + CLUSTER_BUFS * (2 * (size_t)C
                                     * cluster_pair_warps(pe, threads) + 4)
                   + 2 * CLUSTER_BUFS + 8 * (size_t)n + 3 * (size_t)pe;
  return (f + 3) / 4 * 4;
}

__host__ __device__ inline int up4(int x) { return (x + 3) / 4 * 4; }

// Floats of the cluster route's CI part, above cluster_smem_floats: a
// block's ceil(D / C) held rows of P (32 L each) and their phi values in
// each ring slot, the exchanged g of all D held rows in each buffer, the
// compact table (two constants, then the E (particle, hole) entries),
// rdet, its new values, the coefficients and r_other, the two S sums'
// warp slots, a k x k slot a determinant thread past rank 3, and the lists
// as ints (entries' places, particles' slots and holes per determinant,
// the table's slots and holes, the block's particles).
__host__ __device__ inline size_t cluster_ci_floats(int L, int threads,
                                                    int C, int n_held,
                                                    int n_pairs, int n_det,
                                                    int k) {
  const int dh = (n_held + C - 1) / C;
  const int per = n_det < threads ? n_det : threads;
  const size_t f = (size_t)dh * 32 * L + PHI_RING * up4(dh)
                   + CLUSTER_BUFS * up4(n_held) + up4(2 + n_pairs)
                   + 4 * (size_t)n_det + 2 * RED_SLOTS
                   + (k > 3 ? (size_t)k * k * per : 0)
                   + (size_t)n_det * k * k + 2 * (size_t)n_det * k
                   + 2 * (size_t)n_pairs + dh;
  return (f + 3) / 4 * 4;
}

// One CI determinant's k x k block on the cluster route (ci_ratio.cuh's
// accessor): T[a, b] = tab[ent[a k + b]] - g[pslot[a]] row[h[b]], the
// product rounded first, as ci_entry forms it from the table itself: the
// compact table holds P at the expansion's (particle, hole) entries (0
// and 1 in its first two places for the sentinels' blocks), g the
// exchanged values of the held rows, row the divided row e.
struct CiCompact {
  const float* tab;
  const int* ent;
  const float* g;
  const int* pslot;
  const float* row;
  const int* h;
  int n_occ, k;
  __device__ __forceinline__ float operator()(int a, int b) const {
    const int s = pslot[a], hb = h[b];
    const float gp = s >= 0 ? g[s] : 0.f;
    const float rh = hb < n_occ ? row[hb] : 0.f;
    return __fsub_rn(tab[ent[a * k + b]], __fmul_rn(gp, rh));
  }
};

// Block b of the walker's cluster of C holds rows b * rows_per .. (b + 1)
// * rows_per - 1 of Minv, in registers: warp g the K rows b * rows_per +
// g K .., lane s their columns s L .. s L + L - 1 (a row on the 32 lanes
// of one warp, each lane's L columns of K rows; rows and columns past the
// block's hold 0).  With CI the block also holds held rows b dh .. of P
// in shared memory (the expansion's particles; dh = ceil(D / C)), laid
// out as a warp's rows of Minv, and writes each accepted move's row for
// fused_sweep_p_replay.
template <int K, int L, bool CI>
__global__ void __launch_bounds__(rows_max_threads(K * L), 1)
fused_sweep_cluster(SweepArgs a) {
  constexpr int Lt = 32 * L;
  constexpr int NB = CLUSTER_BUFS;
  extern __shared__ float4 smem4[];
  FS_CLOCK_INIT
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster, b = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t w = blockIdx.x / C;
  const int n = a.n, n_e = a.n_e, rb = a.rows_per;
  const int r0 = b * rb, r1 = min(n, r0 + rb);
  const int g0 = r0 + warp * K;          // the warp's first row
  const int c0 = lane * L;               // the lane's first column
  // e-e pairs: this block's electrons i0 .. i1 - 1, pair i on thread
  // (i - i0) % nt, which alone reads and writes r_i
  const int pe = (n_e + C - 1) / C, i0 = b * pe, i1 = min(n_e, i0 + pe);
  const int pw = cluster_pair_warps(pe, nt);
  const int n_cols = a.n_cols, nwarps = nt >> 5;
  // CI: D held rows, dh a block (this block's hb of them: slots b dh ..),
  // E table entries, n_det determinants of rank k
  const int D = CI ? a.n_held : 0, dh = (D + C - 1) / C;
  const int hb = CI ? max(0, min(dh, D - b * dh)) : 0;
  const int E = CI ? a.n_pairs : 0, n_det = CI ? a.n_det : 0, rk = a.k;

  // the exchange of move e uses buffer and mbarrier e % NB (a block may be
  // a move ahead of another, never NB - 1: it needs the other's pushes)
  float* p = reinterpret_cast<float*>(smem4);
  float* phib = p; p += PHI_RING * Lt;     // phi ring: [occ | 0 pad]
  float* relay = p; p += NB * Lt;          // row e + 1 as move e finds it:
                                           // the columns of lanes s % C == b
  float* rowl = p; p += NB * Lt;           // row e as move e - 1 found it
  float* rv = p; p += Lt;                  // row e / ratio
  float2* slots = reinterpret_cast<float2*>(p);   // (e-e new, old) of every
  p += NB * 2 * C * pw;                    // pair warp of the cluster
  float2* redr = reinterpret_cast<float2*>(p); p += 2 * NB;  // ratio, log
  float* unext = p; p += 2 * NB;           // u of row e + 1 (padded)
  uint64_t* bars = reinterpret_cast<uint64_t*>(p); p += 2 * NB;
  float* rprop = p; p += 3 * n;
  float* rold = p; p += 3 * n;             // r_j before its move
  float* ens = p; p += n;
  float* logus = p; p += n;
  float* pos = p; p += 3 * pe;             // r_i of this block's pairs
  // CI, above the staging's reach (cluster_ci_floats)
  float *heldP = nullptr, *phip = nullptr, *gbuf = nullptr, *tab = nullptr,
        *rd = nullptr, *rdn = nullptr, *cf = nullptr, *ro = nullptr,
        *wsl = nullptr;
  float2* cis = nullptr;
  int *ent = nullptr, *psl = nullptr, *hol = nullptr, *prs = nullptr,
      *prh = nullptr, *hps = nullptr;
  if constexpr (CI) {
    p = reinterpret_cast<float*>(smem4)
        + cluster_smem_floats(L, nt, n, n_e, C);
    heldP = p; p += (size_t)dh * Lt;       // held rows, 32 L columns each
    phip = p; p += PHI_RING * up4(dh);     // their phi, by ring slot
    gbuf = p; p += NB * up4(D);            // g of all D, by buffer
    tab = p; p += up4(2 + E);              // 0, 1, P at the E entries
    rd = p; p += n_det;
    rdn = p; p += n_det;
    cf = p; p += n_det;
    ro = p; p += n_det;
    cis = reinterpret_cast<float2*>(p); p += 2 * RED_SLOTS;  // S sums
    wsl = p; if (rk > 3) p += (size_t)rk * rk * min(nt, n_det);
    int* q = reinterpret_cast<int*>(p);
    ent = q; q += n_det * rk * rk;
    psl = q; q += n_det * rk;
    hol = q; q += n_det * rk;
    prs = q; q += E;
    prh = q; q += E;
    hps = q;                               // this block's particles
  }
  // the bytes a block receives in move e: the ratio, every pair warp's
  // sums, row e + 1's u and this block's lanes' columns of it, (from move
  // 1) all of row e, and with CI g of every held row
  auto expected = [&](int e) -> uint32_t {
    uint32_t bytes = 8 + 8u * C * pw + 4u * D;
    if (e + 1 < n) bytes += 4 + 32u / C * 4 * L;
    if (e >= 1) bytes += 4u * Lt;
    return bytes;
  };

  const float* phi_w = a.phi + w * (size_t)n * n_cols;
  auto issue_phi = [&](int q) {
    float* dst = phib + (q % PHI_RING) * Lt;
    const float* src = phi_w + (size_t)q * n_cols;
    for (int c = tid; c < n; c += nt)
      __pipeline_memcpy_async(dst + c, src + c, 4);
    if constexpr (CI)
      for (int s = tid; s < hb; s += nt)
        __pipeline_memcpy_async(phip + (q % PHI_RING) * up4(dh) + s,
                                src + hps[s], 4);
  };
  // the warp's rows straight from device memory (each thread's loads are
  // independent, so their latencies overlap)
  float m[K][L];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool real = g0 + k < r1;
    const float* src = a.minv + (w * n + (real ? g0 + k : 0)) * (size_t)n;
#pragma unroll
    for (int c = 0; c < L; ++c)
      m[k][c] = real && c0 + c < n ? src[c0 + c] : 0.f;
  }
  for (int i = tid; i < PHI_RING * Lt; i += nt) phib[i] = 0.f;
  for (int i = tid; i < Lt; i += nt) rv[i] = 0.f;
  if constexpr (CI) {
    // the lists, the block's held rows (zero past n), the compact table
    // at the sweep's start, rdet and the coefficients
    const float* gP = a.P + w * (size_t)a.n_orb * n;
    for (int i = tid; i < n_det * rk * rk; i += nt) ent[i] = a.ent[i];
    for (int i = tid; i < n_det * rk; i += nt) {
      psl[i] = a.pslot[i];
      hol[i] = a.holes[i];
    }
    for (int i = tid; i < hb; i += nt) hps[i] = a.held[b * dh + i];
    for (int i = tid; i < hb * Lt; i += nt) {
      const int s = i / Lt, c = i - s * Lt;
      heldP[i] = c < n ? gP[(size_t)a.held[b * dh + s] * n + c] : 0.f;
    }
    for (int i = tid; i < E; i += nt) {
      const int ps = a.pair_slot[i], ph = a.pair_hole[i];
      prs[i] = ps;
      prh[i] = ph;
      tab[2 + i] = gP[(size_t)a.held[ps] * n + ph];
    }
    if (tid == 0) { tab[0] = 0.f; tab[1] = 1.f; }
    for (int d = tid; d < n_det; d += nt) {
      rd[d] = a.rdet[w * n_det + d];
      cf[d] = a.coeffs[d];
      ro[d] = a.r_other[w * n_det + d];
    }
  }
  if (tid == 0) {
    for (int q = 0; q < NB; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(bars + q)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();     // the zero padding stays: the copies skip it
  for (int q = 0; q < PHI_RING - 1; ++q) {
    if (q < n) issue_phi(q);
    __pipeline_commit();
  }
  float* rw = a.r + w * 3 * (size_t)n_e;
  for (int i = tid; i < 3 * n; i += nt) {
    rprop[i] = a.r_prop[w * 3 * n + i];
    rold[i] = rw[3 * a.offset + i];    // electron j moves once, at move e
  }
  for (int i = tid; i < n; i += nt) {
    ens[i] = a.en[w * n + i];
    logus[i] = a.logu[w * n + i];
  }
  for (int i = tid; i < 3 * (i1 - i0); i += nt) pos[i] = rw[3 * i0 + i];
  float sgn = a.sign[w], ld = a.logdet[w];   // block 0's thread 0 counts
  const float bee = *a.b_ee;
  const bool head = b == 0 && tid == 0;
  cluster_barrier();   // every block started, its mbarriers set
  if (tid == 0)
    for (int q = 0; q < NB && q < n; ++q)
      mbar_expect(smem_addr(bars + q), expected(q));
  if (b == 0 && warp == 0) {   // row 0 into every block's rowl[0]
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const float4 v = make_float4(m[0][4 * q], m[0][4 * q + 1],
                                   m[0][4 * q + 2], m[0][4 * q + 3]);
      for (int r = 0; r < C; ++r)
        reinterpret_cast<float4*>(cluster.map_shared_rank(rowl + c0, r))[q]
            = v;
    }
  }
  // this thread's e-e pairs of move e1 (electron offset + e1) at its new
  // and its old point: pn, po over every pair but the one of electron
  // jprev, which moves at move e1 - 1 and is taken at both of its points
  // (its old one in *_rej, its proposal in *_acc; has_prev marks it)
  float pn, po, jn_rej, jo_rej, jn_acc, jo_acc;
  bool has_prev;
  auto pairs = [&](int e1, int jprev) {
    const int j1 = a.offset + e1;
    const float rpx = rprop[3 * e1], rpy = rprop[3 * e1 + 1],
                rpz = rprop[3 * e1 + 2];
    const float rox = rold[3 * e1], roy = rold[3 * e1 + 1],
                roz = rold[3 * e1 + 2];
    const bool j_up = j1 < a.n_up;
    pn = po = jn_rej = jo_rej = jn_acc = jo_acc = 0.f;
    has_prev = false;
    for (int i = i0 + tid; i < i1; i += nt) {
      if (i == j1) continue;
      const float aee = ((i < a.n_up) == j_up) ? 0.25f : 0.5f;
      const float* q = pos + 3 * (i - i0);
      const float xi = q[0], yi = q[1], zi = q[2];
      const float tn = pade_ee(rpx - xi, rpy - yi, rpz - zi, aee, bee);
      const float to = pade_ee(rox - xi, roy - yi, roz - zi, aee, bee);
      if (i == jprev) {
        const float* pp = rprop + 3 * (e1 - 1);
        jn_rej = tn;
        jo_rej = to;
        jn_acc = pade_ee(rpx - pp[0], rpy - pp[1], rpz - pp[2], aee, bee);
        jo_acc = pade_ee(rox - pp[0], roy - pp[1], roz - pp[2], aee, bee);
        has_prev = true;
      } else {
        pn += tn;
        po += to;
      }
    }
  };
  pairs(0, -1);
  __pipeline_wait_prior(PHI_RING - 2);       // phi row 0 landed
  cluster_barrier();                         // row 0 in place
  bool prev_acc = false;     // move e - 1 accepted
  float u_prev = 0.f;        // u of row e in move e - 1
  FS_MARK(6)

  for (int e = 0; e < n; ++e) {
    const int x = e % NB, x1 = (e + 1) % NB;
    const int j = a.offset + e;
    if (e + PHI_RING - 1 < n) issue_phi(e + PHI_RING - 1);
    __pipeline_commit();
    const float4* ph4 = reinterpret_cast<const float4*>(
        phib + (e % PHI_RING) * Lt + c0);
    const int le = e >= r0 && e < r1 ? e - g0 : -1;   // row e in this warp
    const int le1 = e + 1 >= r0 && e + 1 < r1 ? e + 1 - g0 : -1;  // e + 1
    const uint32_t bar = smem_addr(bars + x);

    // u_i = Minv[i] . phi for the warp's K rows: the lane's L columns,
    // then the 32 lanes' sums by a butterfly (every lane gets the bits)
    float u[K];
#pragma unroll
    for (int k = 0; k < K; ++k) u[k] = 0.f;
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const float4 y = ph4[q];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        u[k] = fmaf(m[k][4 * q], y.x, u[k]);
        u[k] = fmaf(m[k][4 * q + 1], y.y, u[k]);
        u[k] = fmaf(m[k][4 * q + 2], y.z, u[k]);
        u[k] = fmaf(m[k][4 * q + 3], y.w, u[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) u[k] = warp_all_sum(u[k]);
    FS_MARK(9)
    if (le >= 0 && le < K) {   // warp-uniform: the ratio and its log into
                               // every block
      float ue = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k == le) ue = u[k];
      if (lane < C)
        st_async(cluster_addr(smem_addr(redr + x), lane),
                 make_float2(ue, log_abs_ratio(ue)), cluster_addr(bar, lane));
    }
    if (le1 >= 0 && le1 < K) {   // row e + 1 as it stands, lane s's columns
                                 // into block s % C (the first of two hops),
                                 // and its u into every block
      const int to = lane % C;
      const uint32_t dst = cluster_addr(smem_addr(relay + x1 * Lt + c0), to);
      const uint32_t tb = cluster_addr(bar, to);
      float u1 = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k == le1) {
          u1 = u[k];
#pragma unroll
          for (int q = 0; q < L / 4; ++q)
            st_async(dst + 16 * q,
                     make_float4(m[k][4 * q], m[k][4 * q + 1],
                                 m[k][4 * q + 2], m[k][4 * q + 3]), tb);
        }
      if (lane < C)
        st_async(cluster_addr(smem_addr(unext + x), lane), u1,
                 cluster_addr(bar, lane));
    }

    if constexpr (CI) {   // g of the held rows into every block
      FS_MARK(10)
      const float* php = phip + (e % PHI_RING) * up4(dh);
      for (int s = warp; s < hb; s += nwarps) {
        const float4* P4 = reinterpret_cast<const float4*>(heldP + s * Lt
                                                           + c0);
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < L / 4; ++q) {
          const float4 y = ph4[q], v = P4[q];
          acc = fmaf(v.x, y.x, acc);
          acc = fmaf(v.y, y.y, acc);
          acc = fmaf(v.z, y.z, acc);
          acc = fmaf(v.w, y.w, acc);
        }
        acc = warp_all_sum(acc) - php[s];
        if (lane < C)
          st_async(cluster_addr(smem_addr(gbuf + x * up4(D) + b * dh + s),
                                lane), acc, cluster_addr(bar, lane));
      }
      FS_MARK(11)
    }

    // this block's e-e sums, computed while the last move's values came;
    // the previous mover's pair at the point it took
    float v_new = pn, v_old = po;
    if (has_prev) {
      v_new += prev_acc ? jn_acc : jn_rej;
      v_old += prev_acc ? jo_acc : jo_rej;
    }
    FS_MARK(10)
    if (warp < pw) {     // the warp's sums into slot (b, warp) of block lane
      v_new = warp_all_sum(v_new);
      v_old = warp_all_sum(v_old);
      if (lane < C)
        st_async(cluster_addr(smem_addr(slots + (x * C + b) * pw + warp),
                              lane),
                 make_float2(v_new, v_old), cluster_addr(bar, lane));
    }
    FS_MARK(0)
    __pipeline_wait_prior(PHI_RING - 2);       // phi row e + 1 landed
    __syncthreads();   // phi row e + 1 in place; rv no longer read
    FS_MARK(1)
    if (e + 1 < n) pairs(e + 1, j);            // while the move's values come
    mbar_wait(bar, (uint32_t)(e / NB) & 1);
    if (tid == 0 && e + NB < n) mbar_expect(bar, expected(e + NB));
    FS_MARK(2)
    const float2 rl = redr[x];
    const float ratio = rl.x, log_ratio = rl.y;
    const float u_next = unext[x];
    // every warp of every block sums the C * pw slots in one order
    float ee_new = 0.f, ee_old = 0.f;
    {
      const float2* sp = slots + x * C * pw;
      for (int q = lane; q < C * pw; q += 32) {
        const float2 v = sp[q];
        ee_new += v.x;
        ee_old += v.y;
      }
      ee_new = warp_all_sum(ee_new);
      ee_old = warp_all_sum(ee_old);
    }
    const float d_jas = (ee_new - ee_old) + ens[e];
    const float logu_e = logus[e];
    // row = Minv[e] / ratio, one column a thread (IEEE division, the
    // plain version's guard; with CI unguarded): row e as it stood at move
    // e - 1, updated by move e - 1 as its owner updated it (the same
    // operands, so the same bits), from this block's own copy
    auto divide_row = [&]() {
      const float d = row_divisor(ratio, CI);
      const float* src = rowl + x * Lt;
      for (int c = tid; c < n; c += nt) {
        float v = src[c];
        if (prev_acc) v = sm_update(v, u_prev, rv[c]);
        rv[c] = v / d;
      }
      __syncthreads();
      FS_MARK(5)
    };
    float log_ci = 0.f;
    const float* gx = CI ? gbuf + x * up4(D) : nullptr;
    if constexpr (CI) {
      // every move: the division (the ratios read row_t at the holes),
      // then every determinant's ratio from the compact table, the
      // exchanged g and the row, S_new and S_old summed in one order (the
      // same bits in every block)
      divide_row();
      float sn = 0.f, so = 0.f;
      const int per = min(nt, n_det);
      for (int d = tid; d < n_det; d += nt) {
        const CiCompact t{tab, ent + d * rk * rk, gx, psl + d * rk, rv,
                          hol + d * rk, n, rk};
        const float det = rk == 2 ? ci_det2(t) : rk == 3 ? ci_det3(t)
                        : ci_det_lu_ws(t, rk, wsl + tid, per);
        rdn[d] = det;
        sn += cf[d] * det * ro[d];
        so += cf[d] * rd[d] * ro[d];
      }
      sn = warp_sum(sn);
      so = warp_sum(so);
      if (lane == 0) cis[warp] = make_float2(sn, so);
      __syncthreads();
      float s_new = 0.f, s_old = 0.f;
      for (int i = 0; i < nwarps; ++i) {
        const float2 v = cis[i];
        s_new += v.x;
        s_old += v.y;
      }
      FS_MARK(4)
      log_ci = log_abs_ratio(s_new) - log_abs_ratio(s_old);
    }
    const float total = move_total(log_ratio, log_ci, d_jas, CI);
    const bool accept = move_accept(total, logu_e, ratio, CI);
    if (head) {
      a.acc[w * n + e] = accept ? 1 : 0;
      a.margin[w * n + e] = total - logu_e;
    }
    FS_MARK(8)
    if (accept) {                              // uniform over the cluster
      if constexpr (!CI) divide_row();
      // M[i, c] <- M[i, c] - u_i row[c] (product rounded first), then row
      // e <- row in its warp
      const float4* rv4 = reinterpret_cast<const float4*>(rv + c0);
#pragma unroll
      for (int q = 0; q < L / 4; ++q) {
        const float4 y = rv4[q];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          m[k][4 * q] = sm_update(m[k][4 * q], u[k], y.x);
          m[k][4 * q + 1] = sm_update(m[k][4 * q + 1], u[k], y.y);
          m[k][4 * q + 2] = sm_update(m[k][4 * q + 2], u[k], y.z);
          m[k][4 * q + 3] = sm_update(m[k][4 * q + 3], u[k], y.w);
        }
      }
      if (le >= 0 && le < K) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k == le) {
#pragma unroll
            for (int q = 0; q < L / 4; ++q) {
              const float4 y = rv4[q];
              m[k][4 * q] = y.x; m[k][4 * q + 1] = y.y;
              m[k][4 * q + 2] = y.z; m[k][4 * q + 3] = y.w;
            }
          }
      }
      if constexpr (CI) {
        // the held rows and the table with the same operands (so the
        // table's entries stay the rows' bits), rdet, and this block's
        // columns of the row for the replay
        for (int s = warp; s < hb; s += nwarps) {
          float4* P4 = reinterpret_cast<float4*>(heldP + s * Lt + c0);
          const float gs = gx[b * dh + s];
#pragma unroll
          for (int q = 0; q < L / 4; ++q) {
            const float4 y = rv4[q];
            float4 v = P4[q];
            v.x = sm_update(v.x, gs, y.x);
            v.y = sm_update(v.y, gs, y.y);
            v.z = sm_update(v.z, gs, y.z);
            v.w = sm_update(v.w, gs, y.w);
            P4[q] = v;
          }
        }
        for (int q = tid; q < E; q += nt)
          tab[2 + q] = sm_update(tab[2 + q], gx[prs[q]], rv[prh[q]]);
        for (int d = tid; d < n_det; d += nt) rd[d] = rdn[d];
        const int cw = (n + C - 1) / C;
        float* dst = a.rows + (w * n + e) * (size_t)a.ldr;
        for (int c = b * cw + tid; c < min(n, (b + 1) * cw); c += nt)
          dst[c] = rv[c];
      }
      if (j >= i0 && j < i1 && tid == (j - i0) % nt) {   // pair j's thread
        float* q = pos + 3 * (j - i0);
        q[0] = rprop[3 * e]; q[1] = rprop[3 * e + 1]; q[2] = rprop[3 * e + 2];
      }
      if (head) {
        ld += log_ratio;
        sgn *= ratio_sign(ratio);
      }
    }
    // the second hop: the columns of row e + 1 this block received, into
    // every block's rowl, counted on move e + 1's mbarrier
    if (e + 1 < n) {
      constexpr int F = L / 4;                 // float4s a lane
      const int share = 32 / C * F;            // float4s this block holds
      const float4* src = reinterpret_cast<const float4*>(relay + x1 * Lt);
      const uint32_t dst = smem_addr(rowl + x1 * Lt);
      const uint32_t nb = smem_addr(bars + x1);
      for (int t = tid; t < share * C; t += nt) {
        const int f = t / C, to = t - f * C;
        const int q = (b + C * (f / F)) * F + f % F;   // float4 of the row
        st_async(cluster_addr(dst + 16 * q, to), src[q],
                 cluster_addr(nb, to));
      }
    }
    prev_acc = accept;
    u_prev = u_next;
    FS_MARK(3)
  }
  __pipeline_wait_prior(0);
  cluster_barrier();   // no block writes this block's shared memory any more
  for (int i = tid; i < 3 * (i1 - i0); i += nt) rw[3 * i0 + i] = pos[i];
  if (head) {
    a.sign[w] = sgn;
    a.logdet[w] = ld;
  }
  if constexpr (CI) {    // the held rows and (block 0) rdet; the rest of P
                         // is fused_sweep_p_replay's
    float* gP = a.P + w * (size_t)a.n_orb * n;
    for (int i = tid; i < hb * n; i += nt) {
      const int s = i / n, c = i - s * n;
      gP[(size_t)hps[s] * n + c] = heldP[s * Lt + c];
    }
    if (b == 0)
      for (int d = tid; d < n_det; d += nt) a.rdet[w * n_det + d] = rd[d];
  }
  __syncthreads();     // the positions are out: the staging overwrites them
  // this block's rows back through the shared memory below the
  // mbarriers, a chunk of rows at a time, each row written as float4s:
  // the lanes' own stores to device memory would lie L floats apart.
  // The mbarriers' words are not reused: PTX leaves a plain store over a
  // live mbarrier undefined, and on the card such staged values read back
  // corrupted in some runs (n = 528 at clusters of 16, where a staged
  // row fell on them)
  {
    float* stage = reinterpret_cast<float*>(smem4);
    const int ld4 = (n + 3) / 4 * 4;
    const int rows_a_chunk =
        (int)(reinterpret_cast<float*>(bars) - stage) / ld4;
    float* gM = a.minv + (w * n + r0) * (size_t)n;
    for (int q0 = r0; q0 < r1; q0 += rows_a_chunk) {
      const int q1 = min(r1, q0 + rows_a_chunk);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (g0 + k >= q0 && g0 + k < q1) {
          float4* dst = reinterpret_cast<float4*>(
              stage + (size_t)(g0 + k - q0) * ld4 + c0);
#pragma unroll
          for (int q = 0; q < L / 4; ++q)
            if (c0 + 4 * q < ld4)
              dst[q] = make_float4(m[k][4 * q], m[k][4 * q + 1],
                                   m[k][4 * q + 2], m[k][4 * q + 3]);
        }
      __syncthreads();
      for (int i = tid; i < (q1 - q0) * n; i += nt) {
        const int rr = i / n;
        gM[(size_t)(q0 - r0) * n + i] =
            stage[(size_t)rr * ld4 + (i - rr * n)];
      }
      __syncthreads();
    }
  }
  FS_MARK(7)
  FS_CLOCK_FLUSH
}

// ===================== the replay of P: fused_sweep_p_replay ================

#define REPLAY_THREADS 256   // 8 warps a block
#define REPLAY_RING 3        // accepted moves in flight: the move's and two

struct ReplayArgs {
  float* P;             // (W, n_orb, n)   in place: the rows `rep` lists
  const float* rows;    // (W, n, ldr)     each accepted move's new row
  const float* phi;     // (W, n, n_cols)  the proposals' phi
  const uint8_t* acc;   // (W, n)          the accept flags
  const int* rep;       // (n_rep,)        the rows to bring up to date
  int n, n_cols, n_orb, n_rep, ldr, tiles;
};

// Floats of dynamic shared memory of a replay block: REPLAY_RING stages of
// (the row, phi's occupied columns: 32 J each; phi at the tile's TR rows)
// and the accepted moves' list (n ints) with the warps' counts.
__host__ __device__ inline size_t replay_smem_floats(int J, int TR, int n) {
  return (size_t)REPLAY_RING * (2 * 32 * J + up4(TR)) + up4(n)
         + REPLAY_THREADS / 32;
}

// Every row v of P that the chain did not hold, brought up to date over
// the sweep's accepted moves in order, with the plain version's arithmetic
// (ref.py::p_replay_ref): g = P[v] . phi_e[:n] - phi_e[v], then P[v] <-
// P[v] - g row_e (product rounded first).  Block (walker w, tile t) holds
// the tile's TR = 8 RW rows in registers: warp g rows t TR + g RW .., lane
// s columns s + 32 j (j < J), so a warp's reads of phi and of the row from
// shared memory are 32 consecutive words.  The moves' rows and phi stream
// through a ring of REPLAY_RING stages by cp.async, the rejected moves
// skipped (the accept flags, compacted into a list first).
template <int RW, int J>
__global__ void __launch_bounds__(REPLAY_THREADS, 2)
fused_sweep_p_replay(ReplayArgs a) {
  constexpr int TR = REPLAY_THREADS / 32 * RW;
  constexpr int LS = 32 * J;                 // a stage's row and phi
  constexpr int STAGE = 2 * LS + (TR + 3) / 4 * 4;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t w = blockIdx.x / a.tiles;
  const int t0 = (int)(blockIdx.x % a.tiles) * TR;
  const int n = a.n, n_cols = a.n_cols;
  float* ring = reinterpret_cast<float*>(smem4);
  int* list = reinterpret_cast<int*>(ring + REPLAY_RING * STAGE);
  int* wcnt = list + up4(n);

  // the accepted moves, in order
  int cnt = 0;
  for (int c0 = 0; c0 < n; c0 += REPLAY_THREADS) {
    const int e = c0 + tid;
    const bool f = e < n && a.acc[w * n + e] != 0;
    const unsigned bal = __ballot_sync(FULL_MASK, f);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = cnt, tot = 0;
    for (int i = 0; i < REPLAY_THREADS / 32; ++i) {
      if (i < warp) off += wcnt[i];
      tot += wcnt[i];
    }
    if (f) list[off + __popc(bal & ((1u << lane) - 1u))] = e;
    cnt += tot;
    __syncthreads();
  }
  if (cnt == 0) return;                      // P as it was

  int v[RW];
  float m[RW][J];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int rr = t0 + warp * RW + i;
    v[i] = rr < a.n_rep ? a.rep[rr] : -1;
    const float* src = a.P + (w * a.n_orb + (v[i] >= 0 ? v[i] : 0))
                                 * (size_t)n;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      m[i][j] = v[i] >= 0 && c < n ? src[c] : 0.f;
    }
  }
  // zero the stages once: the copies fill columns < n and the tile's rows
  for (int i = tid; i < REPLAY_RING * STAGE; i += REPLAY_THREADS)
    ring[i] = 0.f;
  __syncthreads();
  auto stage_move = [&](int q) {
    float* st = ring + (q % REPLAY_RING) * STAGE;
    const int e = list[q];
    const float* row = a.rows + (w * n + e) * (size_t)a.ldr;
    const float* ph = a.phi + (w * n + e) * (size_t)n_cols;
    const int n16 = n / 4;                   // the row's whole float4s
    for (int i = tid; i < n16; i += REPLAY_THREADS)
      __pipeline_memcpy_async(st + 4 * i, row + 4 * i, 16);
    for (int c = 4 * n16 + tid; c < n; c += REPLAY_THREADS)
      __pipeline_memcpy_async(st + c, row + c, 4);
    for (int c = tid; c < n; c += REPLAY_THREADS)
      __pipeline_memcpy_async(st + LS + c, ph + c, 4);
    for (int r = tid; r < TR && t0 + r < a.n_rep; r += REPLAY_THREADS)
      __pipeline_memcpy_async(st + 2 * LS + r, ph + a.rep[t0 + r], 4);
  };
  for (int q = 0; q < REPLAY_RING - 1; ++q) {
    if (q < cnt) stage_move(q);
    __pipeline_commit();
  }
  for (int q = 0; q < cnt; ++q) {
    __pipeline_wait_prior(REPLAY_RING - 2);  // stage q landed (own copies)
    __syncthreads();                         // everyone's; q - 1 read
    if (q + REPLAY_RING - 1 < cnt) stage_move(q + REPLAY_RING - 1);
    __pipeline_commit();
    const float* st = ring + (q % REPLAY_RING) * STAGE;
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float x = st[LS + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RW; ++i) s[i] = fmaf(m[i][j], x, s[i]);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i)
      s[i] = warp_all_sum(s[i]) - st[2 * LS + warp * RW + i];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float y = st[lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RW; ++i) m[i][j] = sm_update(m[i][j], s[i], y);
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (v[i] < 0) continue;
    float* dst = a.P + (w * a.n_orb + v[i]) * (size_t)n;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      if (c < n) dst[c] = m[i][j];
    }
  }
}

// ================================ host side ================================

// (R, S) pairs the rows route is compiled for, in the order of preference:
// R columns a thread in registers, S in shared memory; with CI the pairs
// whose blocks fit (at S = 224 the P rows' threads never do).  The chooser,
// kernels/fused_sweep/kernel.py, reads both lists from this file.
#define ROWS_VARIANTS(X) X(48, 0) X(80, 0) X(64, 48) X(64, 64) X(0, 224)
#define ROWS_CI_VARIANTS(X) X(48, 0) X(80, 0) X(64, 48) X(64, 64)
// (K, L) pairs the cluster route is compiled for: K rows a thread, L
// columns a lane (a multiple of 4 whose quarter is odd: a quarter warp's
// float4 reads of phi and of the row fall on distinct banks), all in
// registers; and its largest cluster; kernel.py reads both.
#define CLUSTER_VARIANTS(X) X(7, 28) X(9, 20) X(16, 12)
#define CLUSTER_MAX 16
// (RW, J) pairs the replay is compiled for, in the order of preference:
// RW rows a warp, J columns a lane in registers (32 J >= n; kernel.py
// reads them).
#define REPLAY_VARIANTS(X) X(8, 8) X(4, 17) X(3, 28)

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

static bool cluster_variant(int K, int L) {
#define CLUSTER_IS(KK, LL) if (K == KK && L == LL) return true;
  CLUSTER_VARIANTS(CLUSTER_IS)
#undef CLUSTER_IS
  return false;
}

// Launch (active == nullptr) or ask how many clusters the card holds at
// once (cudaOccupancyMaxActiveClusters into *active): W clusters of C
// blocks, one cluster a walker.  Past 8 blocks a cluster is non-portable
// and has to be allowed first.
template <typename K>
static int run_cluster(K kernel, int W, int C, int threads, size_t bytes,
                       void* stream, const SweepArgs& a, int* active) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)W * (unsigned)C);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static int cluster_dispatch(int K, int L, bool ci, int W, int C,
                            int threads, size_t bytes, void* stream,
                            const SweepArgs& a, int* active) {
#define CLUSTER_CASE(KK, LL)                                                \
  if (K == KK && L == LL)                                                   \
    return ci ? run_cluster(fused_sweep_cluster<KK, LL, true>, W, C,        \
                            threads, bytes, stream, a, active)              \
              : run_cluster(fused_sweep_cluster<KK, LL, false>, W, C,       \
                            threads, bytes, stream, a, active);
  CLUSTER_VARIANTS(CLUSTER_CASE)
#undef CLUSTER_CASE
  return (int)cudaErrorInvalidValue;
}

// Whether the cluster route runs this shape: C a power of two in [2,
// CLUSTER_MAX], a compiled (K, L) whose 32 lanes cover the row, warps of
// K rows for ceil(n / C) rows within the registers' limit.
static bool cluster_shape_ok(int n, int C, int K, int L, int threads) {
  if (C < 2 || C > CLUSTER_MAX || (C & (C - 1))) return false;
  const int rows = (n + C - 1) / C;
  return cluster_variant(K, L) && 32 * L >= n && threads % 32 == 0
         && threads / 32 * K >= rows && threads <= rows_max_threads(K * L);
}

// Floats of the CI workspace a launch needs (0 up to CI_MAX_RANK).
extern "C" long long fused_sweep_ci_workspace(int W, int n_det, int k,
                                              int threads) {
  return ci_workspace_floats(W, n_det, k, threads);
}

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
// block), 4 cluster (`cluster` blocks a walker, `rows` rows a thread, R
// columns a lane; with CI n_held held rows, n_pairs table entries, rank
// k up to CI_MAX_RANK); -1 when the route has no such shape.
extern "C" long long fused_sweep_smem_bytes(int n, int n_cols, int n_e,
                                            int n_orb, int n_det, int ci,
                                            int route, int per_row, int R,
                                            int S, int threads,
                                            int cluster, int rows,
                                            int n_held, int n_pairs,
                                            int k) {
  if (route == 1 || route == 2)
    return 4 * (long long)tables_smem_floats(n, n_cols, n_e, n_orb, n_det,
                                             ci != 0, route == 1);
  if (route == 4) {
    if (!cluster_shape_ok(n, cluster, rows, R, threads)) return -1;
    if (!ci)
      return n_cols != n ? -1
          : 4 * (long long)cluster_smem_floats(R, threads, n, n_e, cluster);
    if (n_cols != n_orb || k < 2 || k > CI_MAX_RANK || n_held < 1
        || n_held > n_orb || n_pairs < 0)
      return -1;
    return 4 * (long long)(cluster_smem_floats(R, threads, n, n_e, cluster)
                           + cluster_ci_floats(R, threads, cluster, n_held,
                                               n_pairs, n_det, k));
  }
  if (route != 3 || !rows_variant(R, S, ci != 0)) return -1;
  return 4 * (long long)rows_smem_floats((R + S) * per_row, S, threads, n,
                                         n_cols, n_e, n_orb, n_det, ci != 0);
}

// Clusters of the cluster route's launch shape the current device holds
// at once (cudaOccupancyMaxActiveClusters: a cluster's blocks share one
// GPC, so this is not the SMs over C) into *out.
extern "C" int fused_sweep_cluster_active(int n, int n_e, int cluster,
                                          int rows, int L, int threads,
                                          int* out) {
  *out = 0;
  const long long bytes = fused_sweep_smem_bytes(
      n, n, n_e, 0, 0, 0, 4, 32, L, 0, threads, cluster, rows, 0, 0, 0);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  SweepArgs a = {};
  return cluster_dispatch(rows, L, false, 1, cluster, threads,
                          (size_t)bytes, nullptr, a, out);
}

// All pointers device pointers (CI ones may be null when ci == 0); the CI
// lists are (n_det, k) with k >= 2, and for k > CI_MAX_RANK ws holds
// fused_sweep_ci_workspace(W, n_det, k, threads) floats (else it may be
// null).  route: 1 shared, 2 global (threads per block: a multiple of 32
// in [32, 1024]), 3 rows (per_row 1 or 2, a compiled (R, S) with (R + S)
// per_row >= n;
// threads and p_start as kernels/fused_sweep/kernel.py::launch_shape
// gives them), 4 cluster (`cluster` blocks a walker, `rows` rows a thread,
// R columns a lane, threads as launch_shape gives them; with CI up to
// CI_MAX_RANK also the maps of kernel.py::ci_maps, held .. pair_hole with
// their counts n_held and n_pairs, and `rows_out` (W, n, ldr), ldr a
// multiple of 4 >= n, where each accepted move's row goes for
// fused_sweep_p_replay_launch, which brings the rows of P not held up to
// date).  Launches on
// `stream`; returns the launch's error or cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the route cannot run (nothing is
// launched then).
extern "C" int fused_sweep_launch(
    void* minv, const void* phi, void* r, const void* r_prop, const void* en,
    const void* logu, void* sign, void* logdet, void* acc, void* margin,
    const void* b_ee, void* P, void* rdet, const void* r_other,
    const void* holes, const void* parts, const void* coeffs, void* ws,
    const void* held, const void* ent, const void* pslot,
    const void* pair_slot, const void* pair_hole, void* rows_out,
    int W, int n,
    int n_cols, int n_e, int offset, int n_up, int n_orb, int n_det, int k,
    int ci, int threads, int route, int per_row, int R, int S, int p_start,
    int cluster, int rows, int n_held, int n_pairs, int ldr, void* stream) {
  cudaGetLastError();            // clear a stale error of an earlier call
  const int bad = (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > 1024 || threads % 32) return bad;
  if (ci && (k < 2 || (k > CI_MAX_RANK && ws == nullptr))) return bad;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const long long bytes = fused_sweep_smem_bytes(
      n, n_cols, n_e, n_orb, n_det, ci, route, per_row, R, S, threads,
      cluster, rows, n_held, n_pairs, k);
  if (bytes < 0 || bytes > optin) return bad;
  if (route == 4 && ci
      && (held == nullptr || ent == nullptr || pslot == nullptr
          || (n_pairs > 0 && (pair_slot == nullptr || pair_hole == nullptr))
          || rows_out == nullptr || ldr < n || ldr % 4))
    return bad;
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
  a.ws = ci && k > CI_MAX_RANK ? (float*)ws : nullptr;
  a.ws_per = n_det < threads ? n_det : threads;
  a.n = n; a.n_cols = n_cols; a.n_e = n_e; a.offset = offset;
  a.n_up = n_up; a.n_orb = n_orb; a.n_det = n_det; a.k = k;
  a.shared_tables = route == 1;
  a.per_row = per_row;
  a.p_start = p_start;
  a.cluster = cluster;
  a.rows_per = route == 4 ? (n + cluster - 1) / cluster : 0;
  a.held = (const int*)held; a.ent = (const int*)ent;
  a.pslot = (const int*)pslot; a.pair_slot = (const int*)pair_slot;
  a.pair_hole = (const int*)pair_hole; a.rows = (float*)rows_out;
  a.n_held = n_held; a.n_pairs = n_pairs; a.ldr = ldr;
  if (W <= 0 || n <= 0) return 0;
  if (route == 4)
    return cluster_dispatch(rows, R, ci != 0, W, cluster, threads,
                            (size_t)bytes, stream, a, nullptr);
  if (route == 3)
    return ci ? launch_rows<true>(R, S, W, threads, bytes, stream, a)
              : launch_rows<false>(R, S, W, threads, bytes, stream, a);
  return ci ? launch_kernel(fused_sweep_tables<true>, W, threads, bytes,
                            stream, a)
            : launch_kernel(fused_sweep_tables<false>, W, threads, bytes,
                            stream, a);
}

// The replay's compiled (RW, J) for a block of n electrons (the first of
// REPLAY_VARIANTS whose 32 J columns cover the row) into rw, j; its rows a
// tile 8 RW; returns -1 past every variant.
static int replay_shape(int n, int* rw, int* j) {
#define REPLAY_PICK(RR, JJ)                                                 \
  if (n >= 1 && n <= 32 * JJ) { *rw = RR; *j = JJ; return 0; }
  REPLAY_VARIANTS(REPLAY_PICK)
#undef REPLAY_PICK
  return -1;
}

// Bring the n_rep rows `rep` of P (W, n_orb, n) up to date over the
// sweep's accepted moves (acc (W, n) uint8) from their rows (W, n, ldr;
// ldr a multiple of 4 >= n) and phi (W, n, n_cols), in place, on
// `stream` (fused_sweep_p_replay; all pointers device pointers).  Returns
// the launch's error, or cudaErrorInvalidValue for a shape no variant
// runs (nothing launched).
extern "C" int fused_sweep_p_replay_launch(void* P, const void* rows,
                                           const void* phi, const void* acc,
                                           const void* rep, int W, int n,
                                           int n_cols, int n_orb, int n_rep,
                                           int ldr, void* stream) {
  cudaGetLastError();
  int rw = 0, j = 0;
  if (replay_shape(n, &rw, &j) || n_cols < n_orb
      || n_rep < 0 || n_rep > n_orb || ldr < n || ldr % 4)
    return (int)cudaErrorInvalidValue;
  if (W <= 0 || n_rep == 0) return 0;
  const int TR = REPLAY_THREADS / 32 * rw;
  ReplayArgs a;
  a.P = (float*)P; a.rows = (const float*)rows; a.phi = (const float*)phi;
  a.acc = (const uint8_t*)acc; a.rep = (const int*)rep;
  a.n = n; a.n_cols = n_cols; a.n_orb = n_orb; a.n_rep = n_rep;
  a.ldr = ldr; a.tiles = (n_rep + TR - 1) / TR;
  const size_t bytes = 4 * replay_smem_floats(j, TR, n);
  const long long blocks = (long long)W * a.tiles;
#define REPLAY_CASE(RR, JJ)                                                 \
  if (rw == RR && j == JJ) {                                                \
    cudaError_t err = cudaFuncSetAttribute(                                 \
        fused_sweep_p_replay<RR, JJ>,                                       \
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);           \
    if (err != cudaSuccess) return (int)err;                                \
    fused_sweep_p_replay<RR, JJ><<<(unsigned)blocks, REPLAY_THREADS, bytes, \
                                   (cudaStream_t)stream>>>(a);              \
    return (int)cudaGetLastError();                                         \
  }
  REPLAY_VARIANTS(REPLAY_CASE)
#undef REPLAY_CASE
  return (int)cudaErrorInvalidValue;
}
