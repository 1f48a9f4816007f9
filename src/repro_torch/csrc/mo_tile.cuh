// Electron tiles with their AO rows in shared memory: the machinery that the
// two MO-product kernels (sparse_mo.cu, screened_mo.cu) share, for Hopper
// (sm_90a), fp32 on the CUDA cores.
//
// Both kernels compute, for every electron e and orbital o,
//     C[o, e, c] = sum over the active AOs j of e, ascending in j, of
//                  A[o, j] * B[e, j, c]          (c = value, d/dx, d/dy,
//                                                  d/dz, laplacian)
// and differ only in where an electron's active AOs and their five values
// come from (a "source": the AO pass's (N, n_ao, 5) rows with an (N, n_ao)
// mask, or the screened pipeline's packed (N, K) candidate lists).
//
// Tiles.  The caller sorts the electrons by a key that is local in space
// (the nearest atom) and passes the permutation `order`; block b takes the
// TE consecutive electrons order[b*TE .. b*TE+TE).  Such electrons share
// most of their AOs: at the micro-peptide a 32-electron tile needs ~161 of
// 346 AO rows where 32 consecutive electrons of one walker need all 346.
//
// Per block, window by window (one window unless the lists or the union
// outgrow shared memory; 2 of 3472 tiles at the b-strand):
//  1. Compaction.  One warp per electron loads 12 x 32 positions of its
//     activity (and ids) at once; a ballot and a popcount prefix append
//     each active AO to the electron's list in shared memory, ascending, up
//     to `lcap` entries, set its bit in the union bitmap, and start the
//     cp.async of its five values (4-byte copies: the rows are 20 bytes
//     apart).  Inactive entries are never read, so NaN stored there cannot
//     reach C.
//  2. Window end a1: the least AO id that some electron had no room for;
//     every list keeps the entries below a1 (a binary search), and the
//     bitmap loses the ids from a1 on.
//  3. Union: an exclusive prefix over the bitmap's words gives each id its
//     row in the union.  A union wider than `ucap` rows ends the window
//     earlier, at the id of union row ucap.  The threads take the electrons
//     longest list first, so that a warp's lists have about one length.
//  4. The union's ids; the first stage's rows on their way; each entry's
//     AO id replaced by the offset of its union row.
//  5. Orbital stages of `osw` orbitals (<= 80, a multiple of 4): the union's
//     rows of At (A transposed, (n_ao, ld), zero padded to whole stages) are
//     copied into shared memory with 16-byte cp.async, double-buffered: the
//     next stage's rows are in flight while this stage is summed.  One
//     barrier a stage.
//  6. Products: thread (electron e, group g) owns 4 orbitals of the stage
//     (one float4 of the At row) and 5 components: per list entry it reads
//     16 bytes of At and the 24-byte entry from shared memory and does 20
//     fmaf (a thread whose orbitals are all padding does nothing).  The sum
//     runs over the electron's list in ascending AO order, so C is
//     deterministic and equals, bit for bit, any other ascending fmaf chain
//     over the same active set (the terms skipped elsewhere are exact
//     zeros): both kernels give the same C on the same active sets, and the
//     same C as their first versions.  The loop is bound by issue and by
//     the slowest warp of the stage, not by shared memory; chip_phases.py
//     shows what else a tile spends (compaction, the union, the barriers).
//  7. Output: C is written electron-major, as a (N, ld, 5) buffer whose
//     (n_orb, N, 5) view the caller reads (mo_tile.py::output): a thread's
//     4 orbitals x 5 components are 80 contiguous, 16-byte aligned bytes,
//     five float4 stores, and an electron's threads write its stage back to
//     back, so every 32-byte sector is whole before it leaves L2.  (Written
//     as 20-byte chunks of (n_orb, N, 5) rows at the sorted electrons'
//     scattered columns, each chunk would fill part of a sector, which the
//     memory reads and writes back whole.)  A later window resumes the sums
//     from C (the thread's own earlier stores), so the chunks keep the sum
//     order.
//
// Widths.  Up to 640 threads (TE x osw / 4) per block.  `lcap` and `ucap`
// are chosen at launch to fill the shared-memory opt-in (227 KB: one
// block per SM), so a wide K or n_ao only means more windows, never a
// refused launch.  Offsets into B, At and C are 64-bit;
// electron ids are int (N < 2^31).
//
// Numerics.  fp32 on the CUDA cores only: no TF32 and no 3xTF32 split on
// the tensor cores, which would change the rounding and the sum order that
// the fp32 contract and the bitwise checks rest on.
//
// MO_TILE_MARK(k) and MO_TILE_WINDOWS(n) mark a tile's phases and count
// its windows; they are empty except in the phase-profile build
// (mo_tile_phases.cu, chip_phases.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mo_tile {

constexpr int TE = 32;            // electrons per tile (one warp's lanes)
constexpr int OPT = 4;            // orbitals per thread (one float4)
constexpr int MAX_STAGE = 80;     // orbitals per stage, at most
constexpr int SCAN = 12;          // 32-position chunks a warp loads at once
constexpr int NO_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NINT = 7;           // per-electron int arrays

#ifndef MO_TILE_MARK
#define MO_TILE_MARK(k)
#define MO_TILE_WINDOWS(n)
#endif

// One compacted list entry: the five values and the offset (in floats) of
// the AO's row in the stage buffer (the AO id until the union is known).
struct __align__(8) Entry {
  float v[5];
  int off;
};

struct Args {
  const float* At;   // (n_ids, ld): A transposed, zero padded
  long long ld;      // row stride of At, == n_stages * osw
  const int* order;  // (N,) the electrons, sorted by the tile key
  float* C;          // (N, ld, 5): C[o, e, c] at C[e, o, c]
  long long N;
  int n_orb;
  int n_ids;         // AO ids lie in [0, n_ids)
  int P;             // positions per electron in the source
  int osw, n_stages, lcap, ucap;
};

struct Layout {
  size_t at, buf, ent, bm, wpre, uid, ints, total;   // buf: floats a buffer
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Shared memory of a block: the stage buffers of At's union rows (two when
// there is a next stage to load while one is summed), the lists, the
// union's bitmap, prefix and ids, and the per-electron ints.
__host__ __device__ inline Layout layout(int osw, int n_stages, int lcap,
                                         int ucap, int n_ids) {
  Layout L;
  const size_t nw = (size_t)(n_ids + 31) / 32;
  L.buf = ((size_t)ucap * osw + 3) / 4 * 4;
  size_t o = 0;
  L.at = o;   o = align16(o + (n_stages > 1 ? 2 : 1) * L.buf * sizeof(float));
  L.ent = o;  o = align16(o + (size_t)TE * lcap * sizeof(Entry));
  L.bm = o;   o = align16(o + nw * sizeof(unsigned));
  L.wpre = o; o = align16(o + nw * sizeof(int));
  L.uid = o;  o = align16(o + (size_t)ucap * sizeof(int));
  L.ints = o; o = align16(o + (size_t)(NINT * TE + 4) * sizeof(int));
  L.total = o;
  return L;
}

// Orbitals per stage: the fewest stages of at most MAX_STAGE orbitals,
// evened out and rounded up to a multiple of OPT.
inline int stage_width(int n_orb, int* n_stages) {
  int s = (n_orb + MAX_STAGE - 1) / MAX_STAGE;
  if (s < 1) s = 1;
  int w = (n_orb + s - 1) / s;
  w = (w + OPT - 1) / OPT * OPT;
  if (w < OPT) w = OPT;
  *n_stages = s;
  return w;
}

struct Plan {
  int osw, n_stages, threads, lcap, ucap;
  size_t smem;
};

// List and union capacities that fill `budget` bytes of shared memory, in
// the ratio ucap ~ 1.25 lcap (a tile's union is ~1.2-1.3x its longest
// list on the paper's systems), each capped by what the problem can need.
// lcap = 0 when not even one entry fits.
inline Plan plan(int n_orb, int n_ids, int P, size_t budget) {
  Plan p;
  p.osw = stage_width(n_orb, &p.n_stages);
  p.threads = TE * p.osw / OPT;
  const int n_buf = p.n_stages > 1 ? 2 : 1;
  const long long fixed = (long long)layout(p.osw, 1, 0, 0, n_ids).total + 64;
  const long long per_l = (long long)TE * sizeof(Entry);
  const long long per_u = (long long)n_buf * p.osw * sizeof(float)
                          + sizeof(int);
  const long long rem = (long long)budget - fixed;
  long long l = rem > 0 ? rem * 4 / (4 * per_l + 5 * per_u) : 0;
  long long u = l * 5 / 4;
  if (l > P) {
    l = P;
    u = (rem - l * per_l) / per_u;
  }
  if (u > n_ids) {
    u = n_ids;
    l = (rem - u * per_u) / per_l;
    if (l > P) l = P;
  }
  p.lcap = (int)(l > 0 ? l : 0);
  p.ucap = (int)(u > 0 ? u : 0);
  p.smem = layout(p.osw, p.n_stages, p.lcap, p.ucap, n_ids).total;
  while (p.smem > budget && p.lcap > 0 && p.ucap > 0) {
    if (p.lcap * per_l >= p.ucap * per_u) --p.lcap; else --p.ucap;
    p.smem = layout(p.osw, p.n_stages, p.lcap, p.ucap, n_ids).total;
  }
  if (p.ucap == 0) p.lcap = 0;
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Set the bits of the ids `take` marks in a 32-position chunk of one
// electron (its lanes) in the union bitmap.  Ids are positions (q0 + lane)
// for the rows source: one ballot.  Otherwise the taken ids ascend with the
// lane, so a word's lanes come in runs: each run ORs its bits into its
// first lane (a segmented scan), which does the atomicOr.
__device__ __forceinline__ void union_or(unsigned* bm, bool take, int id,
                                         int q0, int lane, bool id_is_pos) {
  if (id_is_pos) {
    const unsigned tk = __ballot_sync(FULL, take);
    if (lane == 0 && tk) {
      const int w = q0 >> 5, sh = q0 & 31;
      atomicOr(&bm[w], tk << sh);
      if (sh && (tk >> (32 - sh))) atomicOr(&bm[w + 1], tk >> (32 - sh));
    }
    return;
  }
  const int w = take ? id >> 5 : -1 - lane;   // distinct when not taken
  unsigned bits = take ? 1u << (id & 31) : 0u;
  for (int d = 1; d < 32; d <<= 1) {
    const int wd = __shfl_down_sync(FULL, w, d);
    const unsigned bd = __shfl_down_sync(FULL, bits, d);
    if (lane + d < 32 && wd == w) bits |= bd;
  }
  const int wu = __shfl_up_sync(FULL, w, 1);
  if (take && (lane == 0 || wu != w)) atomicOr(&bm[w], bits);
}

// The first position from p on of electron ge whose slot is active with an
// id >= a1 (P: none), by one warp.
template <class Src>
__device__ int first_from(const Src& src, int ge, int p, int P, int a1,
                          int lane) {
  for (; p < P; p += 32) {
    const int q = p + lane;
    const bool hit = q < P && src.active(ge, q) && src.id(ge, q) >= a1;
    const unsigned m = __ballot_sync(FULL, hit);
    if (m) return p + __ffs(m) - 1;
  }
  return P;
}

// Entries of a list (ids ascending, in .off) with id < a1.
__device__ __forceinline__ int count_below(const Entry* le, int n, int a1) {
  if (a1 == NO_ID) return n;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (le[mid].off < a1) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Source interface: active(ge, p), id(ge, p) and values(ge, p) for
// positions p in [0, P) of electron ge, active ids strictly ascending with
// p; kIdIsPosition when id(ge, p) == p.
template <class Src>
__global__ void __launch_bounds__(640, 1) tile_kernel(Args a, Src src) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.osw, a.n_stages, a.lcap, a.ucap, a.n_ids);
  float* atb = (float*)(smem + L.at);
  Entry* ent = (Entry*)(smem + L.ent);
  unsigned* bm = (unsigned*)(smem + L.bm);
  int* wpre = (int*)(smem + L.wpre);
  int* uid = (int*)(smem + L.uid);
  int* gid = (int*)(smem + L.ints);
  int* cursor = gid + TE;
  int* taken = cursor + TE;
  int* cnt = taken + TE;
  int* nextp = cnt + TE;
  int* stopid = nextp + TE;
  int* byn = stopid + TE;    // the electrons, longest list first
  int* misc = byn + TE;      // [0] window end, [1] union rows, [2] cut

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nwarps = T >> 5;
  const int G = a.osw / OPT;
  const int me = tid / G, mg = tid - me * G;
  const int nw = (a.n_ids + 31) >> 5;
  const long long e0 = (long long)blockIdx.x * TE;

  int window = 0;
  MO_TILE_MARK(0)
  if (tid < TE) {
    const long long e = e0 + tid;
    gid[tid] = e < a.N ? a.order[e] : -1;
    cursor[tid] = e < a.N ? 0 : a.P;
  }

  for (;; ++window) {
    for (int w = tid; w < nw; w += T) bm[w] = 0u;
    if (tid == 0) misc[2] = NO_ID;
    __syncthreads();

    // 1. compaction, one warp per electron
    for (int e = warp; e < TE; e += nwarps) {
      const int ge = gid[e];
      Entry* le = ent + (size_t)e * a.lcap;
      int p = cursor[e], n = 0, np = a.P, sid = NO_ID;
      if (ge >= 0) {
        while (p < a.P && sid == NO_ID) {
          bool act[SCAN];
          int id[SCAN];
#pragma unroll
          for (int c = 0; c < SCAN; ++c) {
            const int q = p + c * 32 + lane;
            act[c] = q < a.P && src.active(ge, q);
            id[c] = q < a.P ? src.id(ge, q) : 0;
          }
#pragma unroll
          for (int c = 0; c < SCAN; ++c) {
            const unsigned m = __ballot_sync(FULL, act[c]);
            if (sid == NO_ID && m) {
              const int q = p + c * 32 + lane;
              const int rank = n + __popc(m & ((1u << lane) - 1u));
              const bool take = act[c] && rank < a.lcap;
              if (take) {   // the id, and the five values on their way
                le[rank].off = id[c];
                const float* v = src.values(ge, q);
#pragma unroll
                for (int k = 0; k < 5; ++k) cp_async4(&le[rank].v[k], v + k);
              }
              union_or(bm, take, id[c], p + c * 32, lane,
                       Src::kIdIsPosition);
              const unsigned over =
                  __ballot_sync(FULL, act[c] && rank == a.lcap);
              if (over) {
                const int sl = __ffs(over) - 1;
                np = __shfl_sync(FULL, q, sl);
                sid = __shfl_sync(FULL, id[c], sl);
                n = a.lcap;
              } else {
                n += __popc(m);
              }
            }
          }
          p += SCAN * 32;
        }
      }
      if (lane == 0) {
        taken[e] = n;
        nextp[e] = np;
        stopid[e] = sid;
      }
    }
    __syncthreads();
    MO_TILE_MARK(1)

    // 2. window end: the least id some electron had no room for
    if (warp == 0) {
      int s = stopid[lane];
      for (int d = 16; d; d >>= 1) s = min(s, __shfl_xor_sync(FULL, s, d));
      if (lane == 0) misc[0] = s;
    }
    __syncthreads();
    if (tid < TE)
      cnt[tid] = count_below(ent + (size_t)tid * a.lcap, taken[tid],
                             misc[0]);
    __syncthreads();
    MO_TILE_MARK(2)

    // 3. the union: the bitmap of the taken ids less those from the window
    // end on, and a prefix over its words
    if (misc[0] != NO_ID) {
      const int a1 = misc[0];
      for (int w = tid; w < nw; w += T)
        if (w * 32 >= a1) bm[w] = 0u;
        else if (w == a1 >> 5) bm[w] &= (1u << (a1 & 31)) - 1u;
      __syncthreads();
    }
    MO_TILE_MARK(3)
    if (warp == 0) {
      int carry = 0;
      for (int w0 = 0; w0 < nw; w0 += 32) {
        const int w = w0 + lane;
        const unsigned bits = w < nw ? bm[w] : 0u;
        const int pc = __popc(bits);
        int inc = pc;
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(FULL, inc, d);
          if (lane >= d) inc += y;
        }
        const int pre = carry + inc - pc;
        if (w < nw) {
          wpre[w] = pre;
          if (pre <= a.ucap && a.ucap < pre + pc) {   // union row ucap
            unsigned b = bits;
            for (int k = a.ucap - pre; k > 0; --k) b &= b - 1u;
            misc[2] = w * 32 + __ffs(b) - 1;
          }
        }
        carry += __shfl_sync(FULL, inc, 31);
      }
      if (lane == 0) misc[1] = min(carry, a.ucap);
    }
    __syncthreads();
    if (misc[2] != NO_ID) {   // the union outgrows a stage: end at the cut
      if (tid < TE)
        cnt[tid] = count_below(ent + (size_t)tid * a.lcap, cnt[tid],
                               misc[2]);
      if (tid == 0) misc[0] = misc[2];
      __syncthreads();
    }
    const int U = misc[1];
    const bool last = misc[0] == NO_ID;
    if (warp == 0) {
      // threads take the electrons longest list first, so that a warp's
      // electrons have lists of about one length: a warp runs as long as
      // its longest list
      const int c = cnt[lane];
      int rank = 0;
      for (int k = 0; k < TE; ++k) {
        const int ck = __shfl_sync(FULL, c, k);
        rank += ck > c || (ck == c && k < lane);
      }
      byn[rank] = lane;
    }
    MO_TILE_MARK(4)

    // 4. union ids; stage 0's rows on their way; entry offsets; next
    // window's cursors
    for (int w = tid; w < nw; w += T) {
      unsigned bits = bm[w];
      int pos = wpre[w];
      while (bits && pos < U) {
        uid[pos++] = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
      }
    }
    __syncthreads();
    // a thread copies one 16-byte column of every TE-th row: the block
    // has TE threads per column (T = TE * osw / 4)
    const int col = (tid % (a.osw >> 2)) * 4, row0 = tid / (a.osw >> 2);
    auto load_stage = [&](int s) {
      float* dst = atb + (size_t)(s & 1) * L.buf + col;
      const float* base = a.At + (size_t)s * a.osw + col;
      for (int u = row0; u < U; u += TE)
        cp_async16(dst + (size_t)u * a.osw,
                   base + (size_t)uid[u] * (size_t)a.ld);
      cp_async_commit();
    };
    load_stage(0);
    for (int e = warp; e < TE; e += nwarps) {
      Entry* le = ent + (size_t)e * a.lcap;
      const int n = cnt[e];
      for (int t = lane; t < n; t += 32) {
        const int id = le[t].off;
        const int w = id >> 5;
        const int up = wpre[w] + __popc(bm[w] & ((1u << (id & 31)) - 1u));
        le[t].off = up * a.osw;
      }
      // the next window starts at the first active position from the
      // window end on: the first one the list left out, or the first one
      // the scan did not reach
      if (!last) {
        const int c = n < taken[e]
                          ? first_from(src, gid[e], cursor[e], a.P, misc[0],
                                       lane)
                          : nextp[e];
        if (lane == 0) cursor[e] = c;
      }
    }
    __syncthreads();
    MO_TILE_MARK(5)

    // 5-7. orbital stages, At rows double-buffered
    const int em = byn[me];   // this thread's electron
    const int ge = gid[em];
    const Entry* mine = ent + (size_t)em * a.lcap;
    const int n_mine = cnt[em];
    for (int s = 0; s < a.n_stages; ++s) {
      cp_async_wait<0>();   // stage s's rows (and at s = 0 the values)
      __syncthreads();      // ... of every thread; stage s - 1 is summed
      MO_TILE_MARK(6 + 3 * s)
      if (s + 1 < a.n_stages) load_stage(s + 1);   // in flight meanwhile
      MO_TILE_MARK(7 + 3 * s)
      // this thread's outputs: orbitals ob + 4 mg .. +3 of electron ge, the
      // 20 contiguous floats C[ge, ob + 4 mg .. +3, 0..4] (zero at a first
      // window, else the sums so far)
      const int ob = s * a.osw;
      float* crow = a.C + ((size_t)(ge < 0 ? 0 : ge) * (size_t)a.ld + ob
                           + mg * OPT) * 5;
      float acc[OPT][5];
#pragma unroll
      for (int i = 0; i < OPT; ++i)
#pragma unroll
        for (int c = 0; c < 5; ++c)
          acc[i][c] = (window > 0 && ge >= 0) ? __ldcg(crow + i * 5 + c)
                                              : 0.f;
      const float* ab = atb + (size_t)(s & 1) * L.buf + mg * OPT;
      // a thread whose orbitals are all padding (beyond n_orb, in the last
      // stage) has nothing to sum: C's padding is never read
      const bool real = ob + mg * OPT < a.n_orb;
      const int n_sum = real ? n_mine : 0;
#pragma unroll 8
      for (int t = 0; t < n_sum; ++t) {
        const float2 x0 = *reinterpret_cast<const float2*>(&mine[t].v[0]);
        const float2 x1 = *reinterpret_cast<const float2*>(&mine[t].v[2]);
        const float2 x2 = *reinterpret_cast<const float2*>(&mine[t].v[4]);
        const float4 p =
            *reinterpret_cast<const float4*>(ab + __float_as_int(x2.y));
        const float v[5] = {x0.x, x0.y, x1.x, x1.y, x2.x};
        const float av[OPT] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < OPT; ++i)
#pragma unroll
          for (int c = 0; c < 5; ++c)
            acc[i][c] = fmaf(av[i], v[c], acc[i][c]);
      }
      // 80 bytes, 16-byte aligned (ld and ob are multiples of 4): five
      // float4 stores; an electron's G threads write its osw * 5 floats
      // back to back, so every 32-byte sector is whole before it leaves L2
      if (ge >= 0 && real) {
        float4* d = reinterpret_cast<float4*>(crow);
        const float* f = &acc[0][0];
#pragma unroll
        for (int k = 0; k < 5; ++k)
          d[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2],
                             f[4 * k + 3]);
      }
      MO_TILE_MARK(8 + 3 * s)
    }
    MO_TILE_MARK(30)
    MO_TILE_WINDOWS(window + 1)
    if (last) break;
    __syncthreads();
  }
}

// The device's opt-in shared memory per block: the budget of a launch.
inline size_t optin_bytes() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return (size_t)optin;
}

// Launch the tile kernel over ceil(N / TE) blocks on `stream`.  Returns a
// cudaError_t (cudaErrorInvalidValue for an At or C row stride ld other
// than whole stages).
template <class Src>
int launch(Args a, const Src& src, cudaStream_t stream) {
  cudaGetLastError();            // clear a stale error of an earlier call
  if (a.N <= 0 || a.n_orb <= 0) return 0;
  const Plan p = plan(a.n_orb, a.n_ids, a.P, optin_bytes());
  if (p.lcap < 1 || p.ucap < 1) return (int)cudaErrorInvalidValue;
  if (a.ld != (long long)p.n_stages * p.osw)
    return (int)cudaErrorInvalidValue;
  a.osw = p.osw;
  a.n_stages = p.n_stages;
  a.lcap = p.lcap;
  a.ucap = p.ucap;
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.N + TE - 1) / TE;
  tile_kernel<Src><<<(unsigned int)blocks, p.threads, p.smem, stream>>>(a,
                                                                      src);
  return (int)cudaGetLastError();
}

// out = {osw, n_stages, threads, lcap, ucap, smem bytes} of a launch.
inline int plan_out(int n_orb, int n_ids, int P, int* out) {
  const Plan p = plan(n_orb, n_ids, P, optin_bytes());
  out[0] = p.osw;
  out[1] = p.n_stages;
  out[2] = p.threads;
  out[3] = p.lcap;
  out[4] = p.ucap;
  out[5] = (int)p.smem;
  return 0;
}

}  // namespace mo_tile
