"""ctypes wrapper of ``csrc/fused_sweep.cu`` (route: CUDA C++, sm_90a).

Replaces ``repro/kernels/fused_sweep/kernel.py::fused_sweep_call``.  One
thread block per walker, or one cluster of blocks, on one of four routes
(``launch_shape`` picks by size, never on failure):

* ``'rows'``: each thread holds a segment of one row of the inverse (or,
  with CI, of the P table) in registers, ``per_row`` (1 or 2) threads a
  row; the launch parameter ``autotune.best_launch`` tunes.  Where the
  registers cannot hold a whole row, part of it lies in shared memory.
  Serves every single-determinant block up to n = 256.
* ``'cluster'``: a thread block cluster of ``cluster`` blocks a walker,
  each holding ceil(n / cluster) rows in registers for the whole sweep (a
  warp ``rows`` rows, a lane ``reg`` columns of each); row e and the sums
  cross between the blocks' shared memories.  Blocks past n = 256 up to
  what ``CLUSTER_MAX`` blocks hold (n = 896); the tuner picks the cluster
  size.  With CI (rank up to ``CI_MAX_RANK``) each block also holds its
  share of the P rows the expansion's particles name (``ci_maps``), every
  block computes every determinant from a compact table of P at the
  expansion's (particle, hole) entries, and each accepted move's row goes
  to a buffer from which a second kernel, ``fused_sweep_p_replay``,
  brings the other rows of P up to date after the sweep
  (``p_replay_inplace``; its own counter ``REPLAY_COUNTER``).
* ``'shared'``: the first design, the tables in shared memory, ``threads``
  per block; for what the rows route cannot hold and the 227 KB opt-in
  can.
* ``'global'``: the same body with the tables updated in device memory.

The rows and cluster routes' compiled segment shapes and buffer counts are
read from the source itself (``ROWS_VARIANTS``, ``ROWS_CI_VARIANTS``,
``CLUSTER_VARIANTS``, ``CLUSTER_MAX``, ``PHI_RING``, ``RED_SLOTS``, the
replay's ``REPLAY_VARIANTS``; ``CI_MAX_RANK`` of ``ci_ratio.cuh``), so the
chooser offers exactly what was compiled.
"""
from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build

COUNTER = _build.LaunchCounter()
REPLAY_COUNTER = _build.LaunchCounter()   # fused_sweep_p_replay
ROUTES = {'shared': 1, 'global': 2, 'rows': 3, 'cluster': 4}
PER_ROW = (1, 2)  # threads per row the rows route runs
CLUSTER_LANES = 32  # threads a row on the cluster route: a warp's lanes


def _source_constants():
    """(R, S) pairs the rows route is compiled for, without and with CI
    (R columns a thread in registers, S in shared memory, in the order of
    preference), the (K, L) pairs of the cluster route (K rows a thread, L
    columns a lane), and the integer ``#define``s of
    ``csrc/fused_sweep.cu``."""
    src = (_build.CSRC / 'fused_sweep.cu').read_text()
    pairs = {}
    for name, body in re.findall(
            r'#define ((?:ROWS_(?:CI_)?|CLUSTER_|REPLAY_)VARIANTS)\(X\)'
            r'((?:[^\n]*\\\n)*[^\n]*)', src):
        pairs[name] = tuple((int(r), int(s)) for r, s in
                            re.findall(r'X\((\d+),\s*(\d+)\)', body))
    src += (_build.CSRC / 'ci_ratio.cuh').read_text()
    defs = {k: int(v) for k, v in
            re.findall(r'^#define (\w+)\s+(\d+)\b', src, re.M)}
    return (pairs['ROWS_VARIANTS'], pairs['ROWS_CI_VARIANTS'],
            pairs['CLUSTER_VARIANTS'], pairs['REPLAY_VARIANTS'], defs)


def check_ci_rank(kernel: str, k: int) -> None:
    """Raise ``ValueError`` unless the excitation lists are padded to a
    rank k >= 2.  No upper limit: ranks up to ``CI_MAX_RANK`` of
    ``csrc/ci_ratio.cuh`` run in registers, higher ones in a device
    workspace the wrappers allocate; both spin blocks carry the higher of
    their two ranks, so a block's k may exceed its electrons."""
    if k < 2:
        raise ValueError(f'{kernel} kernel: excitation lists padded to rank '
                         f'k={k}; they are padded to rank >= 2')


VARIANTS, CI_VARIANTS, CLUSTER_VARIANTS, REPLAY_VARIANTS, _DEFS = \
    _source_constants()
PHI_RING = _DEFS['PHI_RING']      # phi rows in flight
RED_SLOTS = _DEFS['RED_SLOTS']    # warp-sum slots
CLUSTER_BUFS = _DEFS['CLUSTER_BUFS']   # the cluster route's exchange buffers
CI_MAX_RANK = _DEFS['CI_MAX_RANK']     # the cluster route's CI ranks
# 'auto' takes the cluster route with CI from this size on (below, the
# rows route holds CI blocks, or the shared route their wider tables, as
# before the cluster route took CI; a forced route runs at any size)
CI_CLUSTER_FROM = 257
# blocks a walker the cluster route offers: powers of two up to CLUSTER_MAX
CLUSTER_SIZES = tuple(2 ** k for k in range(
    1, _DEFS['CLUSTER_MAX'].bit_length()))
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@dataclass(frozen=True)
class Card:
    """What the chooser reads of the card: its SMs; per SM the registers,
    the shared memory (bytes) and the threads; one block's opt-in shared
    memory (bytes)."""
    sms: int = 132
    regs: int = 65536
    smem: int = 233472
    threads: int = 2048
    optin: int = 232448


H100 = Card()     # NVIDIA H100 SXM; the card's own values on the card


def rows_max_threads(reg: int) -> int:
    """Threads a rows-route block may have with ``reg`` columns a thread
    in registers (``__launch_bounds__`` of the source, which refuses a
    larger block at launch): each of the SM's four register files of
    16 384 holds a quarter of the warps, at reg + 48 registers a thread."""
    per_thread = -(-(reg + 48) // 8) * 8
    return 4 * 32 * min(8, 16384 // (32 * per_thread))


def rows_registers(reg: int) -> int:
    """Registers a thread of the rows route gets at most: what
    ``__launch_bounds__(rows_max_threads(reg))`` leaves it."""
    per_file = rows_max_threads(reg) // 128          # warps a register file
    return min(255, 16384 // (32 * per_file) // 8 * 8)


def blocks_per_sm(threads: int, reg: int, smem_bytes: int,
                  card: Card = H100) -> int:
    """Rows-route blocks one SM holds at once (registers in units of 256 a
    warp, shared memory less 1 KB a block, threads, 32 blocks)."""
    warps = threads // 32
    per_warp = -(-32 * rows_registers(reg) // 256) * 256
    return max(0, min(card.regs // (warps * per_warp),
                      card.smem // (smem_bytes + 1024),
                      card.threads // threads, 32))


@dataclass(frozen=True)
class Launch:
    """A launch shape: route, threads per block; on the rows and cluster
    routes threads per row, columns a thread in registers (``reg``) and in
    shared memory (``shared``), the first thread of P's rows (CI, rows
    route); 0 otherwise; dynamic shared memory bytes a block; on the
    cluster route blocks a walker and rows a thread (else 0)."""
    route: str
    threads: int
    per_row: int = 0
    reg: int = 0
    shared: int = 0
    p_start: int = 0
    smem_bytes: int = 0
    cluster: int = 0
    rows: int = 0


def _up32(x: int) -> int:
    return -(-x // 32) * 32


def _tables_smem(n, n_cols, n_e, n_orb, n_det, ci, shared) -> int:
    f = 3 * n_e + n_cols + 2 * n + 5 * RED_SLOTS
    if ci:
        f += n_orb + 2 * n_det
    if shared:
        f += n * n + (n_orb * n if ci else 0)
    return 4 * f


def rows_launch(n: int, n_cols: int, n_e: int, n_orb: int = 0,
                n_det: int = 0, ci: bool = False, per_row: int = 1,
                card: Card = H100) -> Launch | None:
    """The rows route's shape at ``per_row`` threads a row: the first of
    the compiled (R, S) pairs whose columns cover the row and whose block
    fits the registers and the opt-in shared memory of one SM
    (``rows_smem_floats`` of the source), or None."""
    if per_row not in PER_ROW:
        return None
    p_start = _up32(n * per_row) if ci else 0
    threads = _up32(p_start + n_orb * per_row if ci else n * per_row)
    fits = []
    for reg, sh in CI_VARIANTS if ci else VARIANTS:
        lt = (reg + sh) * per_row
        if lt < n or threads > rows_max_threads(reg):
            continue
        ldphi = -(-(lt + n_cols - n) // 4) * 4
        f = (PHI_RING * ldphi + 2 * lt + sh * threads + 2 * 3 * RED_SLOTS
             + 8 + 3 * n_e + 7 * n)
        if ci:
            f += n_orb * n + n_orb + 4 * n_det + RED_SLOTS
        if 4 * f <= card.optin:
            fits.append(Launch('rows', threads, per_row, reg, sh, p_start,
                               4 * f))
    # the segments' float4 reads of phi and the row hit distinct banks when
    # a segment is 32 / per_row floats past a multiple of 32
    clear = [x for x in fits
             if per_row == 1 or (x.reg + x.shared) % 32 == 32 // per_row]
    return (clear or fits or [None])[0]


def waves(shape: Launch, walkers: int, card: Card = H100) -> int:
    """Waves of ``walkers`` rows-route blocks on the card's SMs."""
    per_sm = blocks_per_sm(shape.threads, shape.reg, shape.smem_bytes, card)
    return -(-walkers // (card.sms * per_sm)) if per_sm else 1 << 30


def rows_shapes(n: int, n_cols: int, n_e: int, n_orb: int = 0,
                n_det: int = 0, ci: bool = False, walkers: int = 0,
                card: Card = H100) -> list:
    """The rows route's shapes at every threads-per-row count that holds
    the block, with ``walkers`` only those that need the fewest waves of
    blocks: the counts the size lets the tuner choose from."""
    shapes = [x for t in PER_ROW if (x := rows_launch(
        n, n_cols, n_e, n_orb, n_det, ci, t, card)) is not None]
    if walkers and shapes:
        least = min(waves(x, walkers, card) for x in shapes)
        shapes = [x for x in shapes if waves(x, walkers, card) == least]
    return shapes


def _up4(x: int) -> int:
    return -(-x // 4) * 4


def _cluster_smem(n: int, n_e: int, lanes_l: int, threads: int,
                  cluster: int) -> int:
    """Bytes of ``cluster_smem_floats`` of the source (``lanes_l`` = L
    columns a lane)."""
    pe = -(-n_e // cluster)
    pair_warps = -(-min(pe, threads) // 32)
    f = ((PHI_RING + 2 * CLUSTER_BUFS + 1) * CLUSTER_LANES * lanes_l
         + CLUSTER_BUFS * (2 * cluster * pair_warps + 4) + 2 * CLUSTER_BUFS
         + 8 * n + 3 * pe)
    return 4 * _up4(f)


def _cluster_ci_smem(lanes_l: int, threads: int, cluster: int, held: int,
                     pairs: int, n_det: int, k: int) -> int:
    """Bytes of ``cluster_ci_floats`` of the source: the CI part of a
    cluster-route block with ``held`` held rows and ``pairs`` table
    entries over the cluster."""
    dh = -(-held // cluster)
    f = (dh * CLUSTER_LANES * lanes_l + PHI_RING * _up4(dh)
         + CLUSTER_BUFS * _up4(held) + _up4(2 + pairs) + 4 * n_det
         + 2 * RED_SLOTS + (k * k * min(threads, n_det) if k > 3 else 0)
         + n_det * k * k + 2 * n_det * k + 2 * pairs + dh)
    return 4 * _up4(f)


def ci_extent(n_orb: int, n_det: int, k: int, held: int | None = None,
              pairs: int | None = None) -> tuple:
    """(held rows, table entries) of an expansion of n_det determinants of
    rank k over n_orb orbitals: the given counts (``ci_maps``), else the
    most such an expansion can name (min(n_orb, n_det k) particles,
    n_det k^2 entries), so that a route chosen from the sizes alone holds
    any expansion of them."""
    return (min(n_orb, n_det * k) if held is None else held,
            n_det * k * k if pairs is None else pairs)


def cluster_launch(n: int, n_e: int, cluster: int, card: Card = H100,
                   ci: tuple | None = None) -> Launch | None:
    """The cluster route's shape at ``cluster`` blocks a walker, each
    holding ceil(n / cluster) rows of the block's inverse in registers:
    among the compiled (K, L) whose 32 lanes cover the row and whose warps
    of K rows hold the block's rows within the registers
    (``rows_max_threads`` at K L floats a thread) and the opt-in shared
    memory, the one with the fewest padding columns (least wasted work a
    move), then the fewest padding rows, then the fewest threads; or
    None.  ``ci`` = (n_det, k, held, pairs): with CI, whose held rows, table
    and lists take shared memory too (``_cluster_ci_smem``)."""
    if cluster not in CLUSTER_SIZES:
        return None
    rows = -(-n // cluster)
    fits = []
    for k, lanes_l in CLUSTER_VARIANTS:
        threads = CLUSTER_LANES * -(-rows // k)
        if (CLUSTER_LANES * lanes_l < n
                or threads > rows_max_threads(k * lanes_l)):
            continue
        nbytes = _cluster_smem(n, n_e, lanes_l, threads, cluster)
        if ci is not None:
            n_det, rank, held, pairs = ci
            nbytes += _cluster_ci_smem(lanes_l, threads, cluster, held,
                                       pairs, n_det, rank)
        if nbytes <= card.optin:
            fits.append(Launch('cluster', threads, CLUSTER_LANES, lanes_l,
                               0, 0, nbytes, cluster, k))
    return min(fits, default=None, key=lambda x: (
        x.reg, x.threads // CLUSTER_LANES * x.rows - rows, x.threads))


def cluster_shapes(n: int, n_cols: int, n_e: int, n_orb: int = 0,
                   n_det: int = 0, ci: bool = False,
                   card: Card = H100, k: int = 2, held: int | None = None,
                   pairs: int | None = None) -> list:
    """The cluster route's shapes at every cluster size that holds the
    block, smallest first: the sizes the tuner chooses from.  With CI
    (``n_det`` determinants of rank ``k``, ``held`` held rows and
    ``pairs`` table entries as ``ci_extent`` gives them) only up to rank
    ``CI_MAX_RANK`` and with phi over all n_orb orbitals."""
    if ci:
        held, pairs = ci_extent(n_orb, n_det, k, held, pairs)
        if n_cols != n_orb or not 2 <= k <= CI_MAX_RANK or held < 1:
            return []
        extra = (n_det, k, held, pairs)
    elif n_cols != n:
        return []
    else:
        extra = None
    return [x for c in CLUSTER_SIZES
            if (x := cluster_launch(n, n_e, c, card, extra)) is not None]


def tables_route(n: int, n_cols: int, n_e: int, n_orb: int = 0,
                 n_det: int = 0, ci: bool = False,
                 card: Card = H100) -> str:
    """The route of the first design at this size: 'shared' when the
    tables fit the opt-in, else 'global'."""
    return ('shared' if _tables_smem(n, n_cols, n_e, n_orb, n_det, ci, True)
            <= card.optin else 'global')


def launch_shape(n: int, n_cols: int, n_e: int, n_orb: int = 0,
                 n_det: int = 0, ci: bool = False, route: str = 'auto',
                 threads: int = 128, per_row: int | None = None,
                 walkers: int = 0, card: Card = H100,
                 cluster: int | None = None, k: int = 2,
                 held: int | None = None,
                 pairs: int | None = None) -> Launch:
    """The launch of one spin block's sweep, a pure function of the sizes
    (``walkers`` walkers on ``card``).

    ``route='auto'``: the rows route when it holds the block, among
    ``rows_shapes`` (the counts that need the fewest waves) ``per_row``
    where it is one, else the count that keeps the largest share of a row
    in registers, the fewest threads on a tie; else the cluster route
    at ``cluster`` blocks a walker where that size holds the block, else
    the smallest that does (with CI from n = ``CI_CLUSTER_FROM`` on, rank
    ``k`` up to ``CI_MAX_RANK``, where the expansion's ``held`` rows and
    ``pairs`` table entries fit: the counts of ``ci_maps``, or the most
    ``ci_extent`` allows); else 'shared' when the tables fit the opt-in,
    else 'global'.  A forced route is honoured or raises ``ValueError``
    (nothing falls back): ``route='rows'`` with ``per_row`` runs that count
    wherever it fits, however many waves it takes; ``route='cluster'``
    with ``cluster`` that size, at any n.  ``threads`` is the block size
    of the shared and global routes.
    """
    if route not in ('auto', *ROUTES):
        raise ValueError(f'unknown fused_sweep route {route!r}')
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f'threads={threads}: a multiple of 32 in [32, 1024]')
    if route in ('auto', 'rows'):
        if route == 'rows' and per_row is not None:
            shapes = [x for x in [rows_launch(n, n_cols, n_e, n_orb, n_det,
                                              ci, per_row, card)] if x]
        else:
            shapes = rows_shapes(n, n_cols, n_e, n_orb, n_det, ci, walkers,
                                 card)
        tuned = [x for x in shapes if x.per_row == per_row]
        if tuned or shapes:      # most of the row in registers, then fewest
            return (tuned or sorted(shapes, key=lambda x: (
                x.shared / (x.reg + x.shared), x.per_row)))[0]
        if route == 'rows':
            raise ValueError(f'fused_sweep: the rows route cannot hold '
                             f'n={n}, n_orb={n_orb}, n_det={n_det} at '
                             f'per_row={per_row}')
    if route == 'cluster' or (route == 'auto'
                              and (not ci or n >= CI_CLUSTER_FROM)):
        shapes = cluster_shapes(n, n_cols, n_e, n_orb, n_det, ci, card, k,
                                held, pairs)
        tuned = [x for x in shapes if x.cluster == cluster]
        if route == 'cluster' and cluster is not None:
            shapes = tuned
        if shapes:
            return (tuned or shapes)[0]
        if route == 'cluster':
            raise ValueError(f'fused_sweep: the cluster route cannot hold '
                             f'n={n}, n_orb={n_orb}, n_det={n_det} at '
                             f'cluster={cluster} (clusters of '
                             f'{CLUSTER_SIZES}; CI up to rank '
                             f'{CI_MAX_RANK}, got {k if ci else "-"})')
    if route == 'auto':
        route = tables_route(n, n_cols, n_e, n_orb, n_det, ci, card)
    nbytes = _tables_smem(n, n_cols, n_e, n_orb, n_det, ci,
                          route == 'shared')
    if nbytes > card.optin:
        raise ValueError(f'fused_sweep: the {route} route needs {nbytes} B '
                         f'of shared memory for n={n}, n_e={n_e}, '
                         f'n_orb={n_orb}, n_det={n_det}; one block has '
                         f'{card.optin}')
    return Launch(route, threads, smem_bytes=nbytes)


@dataclass(frozen=True)
class CIMaps:
    """The cluster route's view of one spin block's CI expansion, built
    once from its sentinel-padded lists (``core/sem.py::_ci_lists``):
    ``held`` (D,) the distinct particles (real orbitals, sorted), the rows
    of P the chain holds, block b of the cluster slots b ceil(D / C) ..;
    ``ent`` (n_det, k, k) the place of each determinant's entry T[a, b]
    in the compact table (0: the constant 0, 1: the constant 1, the
    sentinels' identity block; 2 + q: P at pair q); ``pslot`` (n_det, k)
    each particle's held slot (-1 for a sentinel); ``pair_slot`` and
    ``pair_hole`` (E,) the (held slot, hole) of each pair, the distinct
    real (particle, hole) entries the determinants read; ``replay``
    (n_orb - D,) the other rows, for ``fused_sweep_p_replay``.  int32,
    on the lists' device."""
    held: torch.Tensor
    ent: torch.Tensor
    pslot: torch.Tensor
    pair_slot: torch.Tensor
    pair_hole: torch.Tensor
    replay: torch.Tensor

    @property
    def n_held(self) -> int:
        return int(self.held.shape[0])

    @property
    def n_pairs(self) -> int:
        return int(self.pair_slot.shape[0])


def ci_maps_np(holes, parts, n: int, n_orb: int) -> dict:
    """``CIMaps``' arrays (numpy int32) from (n_det, k) lists padded with
    the sentinels of ``core.multidet`` (a hole >= n or a particle >= n_orb
    names pad slot index - n or index - n_orb)."""
    holes = np.asarray(holes, dtype=np.int64)
    parts = np.asarray(parts, dtype=np.int64)
    n_det, k = holes.shape
    held = np.unique(parts[parts < n_orb])
    slot = np.full(n_orb, -1, np.int64)
    slot[held] = np.arange(held.size)
    real_p = parts < n_orb                       # (n_det, k)
    real_h = holes < n
    pslot = np.where(real_p, slot[np.minimum(parts, n_orb - 1)], -1)
    # (n_det, k, k): entry (a, b) of determinant d reads P[p_a, h_b]
    pa = np.broadcast_to(parts[:, :, None], (n_det, k, k))
    hb = np.broadcast_to(holes[:, None, :], (n_det, k, k))
    both = real_p[:, :, None] & real_h[:, None, :]
    pairs = np.unique(np.stack([pa[both], hb[both]], 1), axis=0).reshape(
        -1, 2)
    key = {(int(x), int(y)): q for q, (x, y) in enumerate(pairs)}
    ent = np.zeros((n_det, k, k), np.int64)
    ent[(pa - n_orb == hb - n) & ~real_p[:, :, None] & ~real_h[:, None, :]] = 1
    for d, a, b in zip(*np.nonzero(both)):
        ent[d, a, b] = 2 + key[(int(parts[d, a]), int(holes[d, b]))]
    rest = np.setdiff1d(np.arange(n_orb), held)
    return dict(held=held, ent=ent, pslot=pslot,
                pair_slot=slot[pairs[:, 0]] if pairs.size else
                np.zeros(0, np.int64),
                pair_hole=pairs[:, 1] if pairs.size else np.zeros(0, np.int64),
                replay=rest)


_MAPS: dict = {}


def ci_maps(holes: torch.Tensor, parts: torch.Tensor, n: int,
            n_orb: int) -> CIMaps:
    """``CIMaps`` of the lists ``holes``, ``parts`` (int32, the kernels'),
    built on the host at their first use and kept for the process (by the
    tensors themselves: an entry is served only to the same, unmodified
    tensors)."""
    key = (holes.data_ptr(), parts.data_ptr(), tuple(holes.shape), n, n_orb,
           str(holes.device))
    hit = _MAPS.get(key)
    if (hit is not None and hit[0] is holes and hit[1] is parts
            and hit[2] == (holes._version, parts._version)):
        return hit[3]
    arrays = ci_maps_np(holes.cpu().numpy(), parts.cpu().numpy(), n, n_orb)
    maps = CIMaps(**{f: torch.as_tensor(v.astype(np.int32),
                                        device=holes.device).contiguous()
                     for f, v in arrays.items()})
    if len(_MAPS) >= 64:
        _MAPS.clear()
    _MAPS[key] = (holes, parts, (holes._version, parts._version), maps)
    return maps


def _configure(lib) -> None:
    # 24 pointers (the CI workspace, then the cluster route's CI maps and
    # its rows buffer); W, n, n_cols, n_e, offset, n_up, n_orb, n_det, k,
    # ci, threads, route, per_row, R, S, p_start, cluster, rows, n_held,
    # n_pairs, ldr; stream
    lib.fused_sweep_launch.argtypes = [_VP] * 24 + [_I] * 21 + [_VP]
    lib.fused_sweep_launch.restype = _I
    lib.fused_sweep_smem_bytes.argtypes = [_I] * 16
    lib.fused_sweep_smem_bytes.restype = _LL
    lib.fused_sweep_p_replay_launch.argtypes = [_VP] * 5 + [_I] * 6 + [_VP]
    lib.fused_sweep_p_replay_launch.restype = _I
    lib.fused_sweep_cluster_active.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    lib.fused_sweep_cluster_active.restype = _I
    lib.fused_sweep_card.argtypes = [ctypes.POINTER(_I)]
    lib.fused_sweep_card.restype = _I
    lib.fused_sweep_ci_workspace.argtypes = [_I] * 4
    lib.fused_sweep_ci_workspace.restype = _LL


def smem_bytes(n: int, n_cols: int, n_e: int, n_orb: int = 0,
               n_det: int = 0, ci: bool = False, **launch) -> int:
    """Dynamic shared memory of a launch as the source computes it (the
    ``launch_shape`` arguments as keywords); checks ``launch_shape``'s own
    count against it."""
    shape = launch_shape(n, n_cols, n_e, n_orb, n_det, ci, **launch)
    held, pairs = ci_extent(n_orb, n_det, launch.get('k', 2),
                            launch.get('held'), launch.get('pairs'))
    nbytes = _lib().fused_sweep_smem_bytes(
        n, n_cols, n_e, n_orb, n_det, int(ci), ROUTES[shape.route],
        shape.per_row, shape.reg, shape.shared, shape.threads, shape.cluster,
        shape.rows, held, pairs, launch.get('k', 2))
    if nbytes != shape.smem_bytes:
        raise RuntimeError(f'fused_sweep.cu counts {nbytes} B of shared '
                           f'memory for {shape}')
    return int(nbytes)


def _lib():
    return _build.load('fused_sweep', _configure)


def cluster_active(shape: Launch, n: int, n_e: int, dev='cuda') -> int:
    """Clusters of a cluster-route ``shape`` the CUDA device holds at once
    (``cudaOccupancyMaxActiveClusters``): W walkers take ceil(W / this)
    waves."""
    out = _I()
    with torch.cuda.device(torch.device(dev)):
        _build.check(_lib().fused_sweep_cluster_active(
            n, n_e, shape.cluster, shape.rows, shape.reg, shape.threads,
            ctypes.byref(out)), 'fused_sweep_cluster_active')
    return int(out.value)


_CARDS: dict = {}


def device_card(dev) -> Card:
    """The chooser's ``Card`` of a CUDA device, as the CUDA runtime reports
    it (kept for the process)."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _CARDS:
        vals = (_I * 5)()
        with torch.cuda.device(index):
            _build.check(_lib().fused_sweep_card(vals), 'fused_sweep_card')
        _CARDS[index] = Card(*vals)
    return _CARDS[index]


def _check(name, t, dev, dt, shape):
    if t.device != dev or dev.type != 'cuda':
        raise ValueError(f'{name} must be on the CUDA device of minv '
                         f'({dev}), got {t.device}')
    if t.dtype != dt or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f'{name}: need a contiguous {tuple(shape)} {dt} '
                         f'tensor, got {tuple(t.shape)} {t.dtype}')


def fused_sweep_inplace(minv, phi, r, r_prop, en_delta, logu, sign, logdet,
                        b_ee, ci=None, *, offset: int, n_up: int,
                        threads: int = 128, route: str = 'auto',
                        per_row: int | None = None,
                        cluster: int | None = None):
    """Launch one spin block's sweep; minv, r, sign, logdet (and P, rdet)
    are updated IN PLACE.

    minv (W, n, n), phi (W, n, n_cols), r (W, n_e, 3), r_prop (W, n, 3),
    en_delta/logu (W, n), sign/logdet (W,), b_ee () — contiguous f32 on one
    CUDA device.  ``ci`` = (P (W, n_orb, n), rdet (W, n_det), r_other
    (W, n_det), holes (n_det, k) i32, parts (n_det, k) i32, coeffs
    (n_det,)) with the lists sentinel-padded to a rank k >= 2
    (``WavefunctionConfig.ci_t.*_k``; above the registers' rank the call
    allocates the kernel's workspace).
    ``route``, ``threads``, ``per_row`` and ``cluster`` as
    ``launch_shape`` takes them.

    On the cluster route with CI the chain holds the P rows the
    expansion's particles name and ``p_replay_inplace`` launches right
    after it for the other rows (``COUNTER`` counts 'cluster ci',
    ``REPLAY_COUNTER`` the replay).

    Returns (accept (W, n) bool, margin (W, n) f32, route taken).
    """
    if ci is not None:
        check_ci_rank('fused_sweep', ci[3].shape[-1])
    dev = minv.device
    W, n, n2 = minv.shape
    if n != n2:
        raise ValueError(f'minv must be (W, n, n), got {tuple(minv.shape)}')
    n_e = r.shape[1]
    n_cols = phi.shape[-1]
    for name, t, shape in (('minv', minv, (W, n, n)),
                           ('phi', phi, (W, n, n_cols)),
                           ('r', r, (W, n_e, 3)),
                           ('r_prop', r_prop, (W, n, 3)),
                           ('en_delta', en_delta, (W, n)),
                           ('logu', logu, (W, n)),
                           ('sign', sign, (W,)), ('logdet', logdet, (W,)),
                           ('b_ee', b_ee, ())):
        _check(name, t, dev, torch.float32, shape)
    if not (0 <= offset and offset + n <= n_e):
        raise ValueError(f'block {offset}..{offset + n} outside n_e={n_e}')
    n_orb = n_det = k = 0
    P = rdet = r_other = holes = parts = coeffs = None
    if ci is not None:
        P, rdet, r_other, holes, parts, coeffs = ci
        n_orb, n_det, k = P.shape[1], rdet.shape[1], holes.shape[-1]
        if n_cols != n_orb:
            raise ValueError(f'CI sweep needs phi over all {n_orb} orbitals, '
                             f'got {n_cols} columns')
        for name, t, dt, shape in (
                ('P', P, torch.float32, (W, n_orb, n)),
                ('rdet', rdet, torch.float32, (W, n_det)),
                ('r_other', r_other, torch.float32, (W, n_det)),
                ('holes', holes, torch.int32, (n_det, k)),
                ('parts', parts, torch.int32, (n_det, k)),
                ('coeffs', coeffs, torch.float32, (n_det,))):
            _check(name, t, dev, dt, shape)
    elif n_cols != n:
        raise ValueError(f'single-determinant sweep needs phi over the {n} '
                         f'occupied orbitals, got {n_cols} columns')
    maps = None if ci is None else ci_maps(holes, parts, n, n_orb)
    shape = launch_shape(n, n_cols, n_e, n_orb, n_det, ci is not None,
                         route=route, threads=threads, per_row=per_row,
                         walkers=W, card=device_card(dev), cluster=cluster,
                         k=k, held=None if maps is None else maps.n_held,
                         pairs=None if maps is None else maps.n_pairs)
    acc = torch.empty((W, n), dtype=torch.uint8, device=dev)
    margin = torch.empty((W, n), dtype=torch.float32, device=dev)

    def _p(t):
        return None if t is None else t.data_ptr()
    lib = _lib()
    ws = None
    if ci is not None and (nf := lib.fused_sweep_ci_workspace(
            W, n_det, k, shape.threads)):
        ws = torch.empty(nf, dtype=torch.float32, device=dev)
    # the cluster route with CI: each accepted move's row, for the replay
    # (W n ldr floats: 285 MB at 1ZE7's n = 528, 768 MB at 1AMB's 866 for
    # W = 256)
    chain = shape.route == 'cluster' and ci is not None
    ldr = -(-n // 4) * 4 if chain else 0
    rows = (torch.empty((W, n, ldr), dtype=torch.float32, device=dev)
            if chain else None)
    held = (maps.held, maps.ent, maps.pslot, maps.pair_slot,
            maps.pair_hole) if chain else (None,) * 5
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_sweep_launch(
            minv.data_ptr(), phi.data_ptr(), r.data_ptr(), r_prop.data_ptr(),
            en_delta.data_ptr(), logu.data_ptr(), sign.data_ptr(),
            logdet.data_ptr(), acc.data_ptr(), margin.data_ptr(),
            b_ee.data_ptr(), _p(P), _p(rdet), _p(r_other), _p(holes),
            _p(parts), _p(coeffs), _p(ws), *(_p(t) for t in held), _p(rows),
            W, n, n_cols, n_e, offset, n_up,
            n_orb, n_det, k, int(ci is not None), shape.threads,
            ROUTES[shape.route], shape.per_row, shape.reg, shape.shared,
            shape.p_start, shape.cluster, shape.rows,
            maps.n_held if chain else 0, maps.n_pairs if chain else 0, ldr,
            stream)
    _build.check(err, f'fused_sweep_launch ({shape})')
    COUNTER.add(shape.route + (' ci' if ci is not None else ''))
    if chain:
        p_replay_inplace(P, rows, phi, acc, maps.replay)
    return acc.bool(), margin, shape.route


def p_replay_inplace(P, rows, phi, acc, rep) -> None:
    """Launch ``fused_sweep_p_replay``: rows ``rep`` of P brought up to
    date over the sweep's accepted moves IN PLACE (``ref.p_replay_ref``'s
    arithmetic).  P (W, n_orb, n), rows (W, n, ldr) with ldr a multiple of
    4 >= n, phi (W, n, n_cols >= n_orb) f32, acc (W, n) uint8 (or bool),
    rep (n_rep,) int32 — contiguous, on one CUDA device.  Nothing is
    launched (or counted) when ``rep`` is empty."""
    dev = P.device
    W, n_orb, n = P.shape
    ldr = rows.shape[-1]
    if acc.dtype == torch.bool:
        acc = acc.view(torch.uint8)
    for name, t, dt, shape in (
            ('P', P, torch.float32, (W, n_orb, n)),
            ('rows', rows, torch.float32, (W, n, ldr)),
            ('phi', phi, torch.float32, (W, n, phi.shape[-1])),
            ('acc', acc, torch.uint8, (W, n)),
            ('rep', rep, torch.int32, (rep.shape[0],))):
        _check(name, t, dev, dt, shape)
    if ldr < n or ldr % 4 or phi.shape[-1] < n_orb:
        raise ValueError(f'p_replay: rows need a multiple of 4 >= {n} '
                         f'columns (got {ldr}), phi {n_orb} (got '
                         f'{phi.shape[-1]})')
    n_rep = rep.shape[0]
    if n_rep == 0:
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fused_sweep_p_replay_launch(
            P.data_ptr(), rows.data_ptr(), phi.data_ptr(), acc.data_ptr(),
            rep.data_ptr(), W, n, phi.shape[-1], n_orb, n_rep, ldr, stream)
    _build.check(err, f'fused_sweep_p_replay_launch (W={W}, n={n}, '
                      f'n_orb={n_orb}, {n_rep} rows)')
    REPLAY_COUNTER.add()
