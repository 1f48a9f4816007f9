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
  cross between the blocks' shared memories.  Single-determinant blocks
  past n = 256 up to what ``CLUSTER_MAX`` blocks hold (n = 896); the
  tuner picks the cluster size.
* ``'shared'``: the first design, the tables in shared memory, ``threads``
  per block; for what the rows route cannot hold and the 227 KB opt-in
  can.
* ``'global'``: the same body with the tables updated in device memory.

The rows and cluster routes' compiled segment shapes and buffer counts are
read from the source itself (``ROWS_VARIANTS``, ``ROWS_CI_VARIANTS``,
``CLUSTER_VARIANTS``, ``CLUSTER_MAX``, ``PHI_RING``, ``RED_SLOTS``), so the
chooser offers exactly what was compiled.
"""
from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass

import torch

from .. import _build

COUNTER = _build.LaunchCounter()
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
            r'#define ((?:ROWS_(?:CI_)?|CLUSTER_)VARIANTS)\(X\)'
            r'((?:[^\n]*\\\n)*[^\n]*)', src):
        pairs[name] = tuple((int(r), int(s)) for r, s in
                            re.findall(r'X\((\d+),\s*(\d+)\)', body))
    defs = {k: int(v) for k, v in
            re.findall(r'^#define (\w+)\s+(\d+)\b', src, re.M)}
    return (pairs['ROWS_VARIANTS'], pairs['ROWS_CI_VARIANTS'],
            pairs['CLUSTER_VARIANTS'], defs)


def check_ci_rank(kernel: str, k: int) -> None:
    """Raise ``ValueError`` unless the excitation lists are padded to a
    rank k >= 2.  No upper limit: ranks up to ``CI_MAX_RANK`` of
    ``csrc/ci_ratio.cuh`` run in registers, higher ones in a device
    workspace the wrappers allocate; both spin blocks carry the higher of
    their two ranks, so a block's k may exceed its electrons."""
    if k < 2:
        raise ValueError(f'{kernel} kernel: excitation lists padded to rank '
                         f'k={k}; they are padded to rank >= 2')


VARIANTS, CI_VARIANTS, CLUSTER_VARIANTS, _DEFS = _source_constants()
PHI_RING = _DEFS['PHI_RING']      # phi rows in flight
RED_SLOTS = _DEFS['RED_SLOTS']    # warp-sum slots
CLUSTER_BUFS = _DEFS['CLUSTER_BUFS']   # the cluster route's exchange buffers
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


def _cluster_smem(n: int, n_e: int, lanes_l: int, threads: int,
                  cluster: int) -> int:
    """Bytes of ``cluster_smem_floats`` of the source (``lanes_l`` = L
    columns a lane)."""
    pe = -(-n_e // cluster)
    pair_warps = -(-min(pe, threads) // 32)
    f = ((PHI_RING + 2 * CLUSTER_BUFS + 1) * CLUSTER_LANES * lanes_l
         + CLUSTER_BUFS * (2 * cluster * pair_warps + 4) + 2 * CLUSTER_BUFS
         + 8 * n + 3 * pe)
    return 4 * (-(-f // 4) * 4)


def cluster_launch(n: int, n_e: int, cluster: int,
                   card: Card = H100) -> Launch | None:
    """The cluster route's shape at ``cluster`` blocks a walker, each
    holding ceil(n / cluster) rows of a single-determinant block in
    registers: among the compiled (K, L) whose 32 lanes cover the row and
    whose warps of K rows hold the block's rows within the registers
    (``rows_max_threads`` at K L floats a thread) and the opt-in shared
    memory, the one with the fewest padding columns (least wasted work a
    move), then the fewest padding rows, then the fewest threads; or
    None."""
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
        if nbytes <= card.optin:
            fits.append(Launch('cluster', threads, CLUSTER_LANES, lanes_l,
                               0, 0, nbytes, cluster, k))
    return min(fits, default=None, key=lambda x: (
        x.reg, x.threads // CLUSTER_LANES * x.rows - rows, x.threads))


def cluster_shapes(n: int, n_cols: int, n_e: int, n_orb: int = 0,
                   n_det: int = 0, ci: bool = False,
                   card: Card = H100) -> list:
    """The cluster route's shapes at every cluster size that holds the
    block, smallest first (none with CI: its tables stay on the global
    route): the sizes the tuner chooses from."""
    if ci or n_cols != n:
        return []
    return [x for c in CLUSTER_SIZES
            if (x := cluster_launch(n, n_e, c, card)) is not None]


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
                 cluster: int | None = None) -> Launch:
    """The launch of one spin block's sweep, a pure function of the sizes
    (``walkers`` walkers on ``card``).

    ``route='auto'``: the rows route when it holds the block, among
    ``rows_shapes`` (the counts that need the fewest waves) ``per_row``
    where it is one, else the count that keeps the largest share of a row
    in registers, the fewest threads on a tie; else the cluster route
    (single determinant) at ``cluster`` blocks a walker where that size
    holds the block, else the smallest that does; else 'shared' when the
    tables fit the opt-in, else 'global'.  A forced route is honoured or
    raises ``ValueError`` (nothing falls back): ``route='rows'`` with
    ``per_row`` runs that count wherever it fits, however many waves it
    takes; ``route='cluster'`` with ``cluster`` that size.  ``threads`` is
    the block size of the shared and global routes.
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
    if route in ('auto', 'cluster'):
        shapes = cluster_shapes(n, n_cols, n_e, n_orb, n_det, ci, card)
        tuned = [x for x in shapes if x.cluster == cluster]
        if route == 'cluster' and cluster is not None:
            shapes = tuned
        if shapes:
            return (tuned or shapes)[0]
        if route == 'cluster':
            raise ValueError(f'fused_sweep: the cluster route cannot hold '
                             f'n={n}, n_orb={n_orb}, n_det={n_det} at '
                             f'cluster={cluster} (single determinant, '
                             f'clusters of {CLUSTER_SIZES})')
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


def _configure(lib) -> None:
    # 18 pointers (the CI workspace last); W, n, n_cols, n_e, offset, n_up,
    # n_orb, n_det, k, ci, threads, route, per_row, R, S, p_start, cluster,
    # rows; stream
    lib.fused_sweep_launch.argtypes = [_VP] * 18 + [_I] * 18 + [_VP]
    lib.fused_sweep_launch.restype = _I
    lib.fused_sweep_smem_bytes.argtypes = [_I] * 13
    lib.fused_sweep_smem_bytes.restype = _LL
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
    nbytes = _lib().fused_sweep_smem_bytes(
        n, n_cols, n_e, n_orb, n_det, int(ci), ROUTES[shape.route],
        shape.per_row, shape.reg, shape.shared, shape.threads, shape.cluster,
        shape.rows)
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
    shape = launch_shape(n, n_cols, n_e, n_orb, n_det, ci is not None,
                         route=route, threads=threads, per_row=per_row,
                         walkers=W, card=device_card(dev), cluster=cluster)
    acc = torch.empty((W, n), dtype=torch.uint8, device=dev)
    margin = torch.empty((W, n), dtype=torch.float32, device=dev)

    def _p(t):
        return None if t is None else t.data_ptr()
    lib = _lib()
    ws = None
    if ci is not None and (nf := lib.fused_sweep_ci_workspace(
            W, n_det, k, shape.threads)):
        ws = torch.empty(nf, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_sweep_launch(
            minv.data_ptr(), phi.data_ptr(), r.data_ptr(), r_prop.data_ptr(),
            en_delta.data_ptr(), logu.data_ptr(), sign.data_ptr(),
            logdet.data_ptr(), acc.data_ptr(), margin.data_ptr(),
            b_ee.data_ptr(), _p(P), _p(rdet), _p(r_other), _p(holes),
            _p(parts), _p(coeffs), _p(ws), W, n, n_cols, n_e, offset, n_up,
            n_orb, n_det, k, int(ci is not None), shape.threads,
            ROUTES[shape.route], shape.per_row, shape.reg, shape.shared,
            shape.p_start, shape.cluster, shape.rows, stream)
    _build.check(err, f'fused_sweep_launch ({shape})')
    COUNTER.add(shape.route + (' ci' if ci is not None else ''))
    return acc.bool(), margin, shape.route
