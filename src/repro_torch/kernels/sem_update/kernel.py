"""ctypes wrappers of ``csrc/sem_update.cu`` and ``csrc/sem_move.cu``
(route: CUDA C++, sm_90a).

``sem_update_inplace`` replaces ``repro/kernels/sem_update/kernel.py::
sem_update_matmul`` with its own signature (the update alone).
``sem_move_inplace`` is the per-move path's kernel: one launch a move does
the ratio, u, with CI the table pass and every determinant's ratio (the
work of ``multidet_ratio_matmul``), the decision and the update.  Its
compiled (CPL, RPW) variants are read from the source
(``MOVE_VARIANTS``), so the chooser ``move_shape`` offers exactly what was
compiled.
"""
from __future__ import annotations

import ctypes
import functools
import re
from dataclasses import dataclass

import torch

from .. import _build
from ..fused_sweep.kernel import check_ci_rank

COUNTER = _build.LaunchCounter()        # sem_update launches
MOVE_COUNTER = _build.LaunchCounter()   # sem_move launches
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _configure(lib) -> None:
    lib.sem_update_launch.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _VP]
    lib.sem_update_launch.restype = _I


def _lib():
    return _build.load('sem_update', _configure)


def sem_update_inplace(minv: torch.Tensor, u: torch.Tensor,
                       row: torch.Tensor, accept: torch.Tensor,
                       j: int) -> torch.Tensor:
    """Launch the update on minv's CUDA device; minv is modified IN PLACE.

    minv (W, n, n), u (W, n), row (W, n) contiguous f32; accept (W,) bool;
    0 <= j < n.  Returns ``minv``.
    """
    dev = minv.device
    W, n, n2 = minv.shape
    if n != n2:
        raise ValueError(f'minv must be (W, n, n), got {tuple(minv.shape)}')
    for name, t, dt, shape in (('minv', minv, torch.float32, (W, n, n)),
                               ('u', u, torch.float32, (W, n)),
                               ('row', row, torch.float32, (W, n)),
                               ('accept', accept, torch.bool, (W,))):
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'{name} must be on the CUDA device of minv '
                             f'({dev}), got {t.device}')
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'{name}: need a contiguous {shape} {dt} tensor, '
                             f'got {tuple(t.shape)} {t.dtype}')
    j = int(j)
    if not 0 <= j < n:
        raise ValueError(f'row index j={j} out of range for n={n}')
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sem_update_launch(minv.data_ptr(), u.data_ptr(),
                                    row.data_ptr(), accept.data_ptr(), W, n,
                                    j, stream)
    _build.check(err, 'sem_update_launch')
    COUNTER.add()
    return minv


# ------------------------------- sem_move ---------------------------------

def _move_source_constants():
    """The (CPL, RPW) variants ``csrc/sem_move.cu`` is compiled for, in its
    order of preference, and its ``RED_SLOTS``."""
    src = (_build.CSRC / 'sem_move.cu').read_text()
    body = re.search(r'#define MOVE_VARIANTS\(X\)((?:[^\n]*\\\n)*[^\n]*)',
                     src).group(1)
    variants = tuple((int(c), int(r)) for c, r in
                     re.findall(r'X\((\d+),\s*(\d+)\)', body))
    slots = int(re.search(r'^#define RED_SLOTS\s+(\d+)', src, re.M).group(1))
    return variants, slots


MOVE_VARIANTS, _RED_SLOTS = _move_source_constants()
OPTIN_H100 = 232448     # a block's opt-in shared memory on an H100 (bytes)


def _up4(x: int) -> int:
    return -(-x // 4) * 4


def move_max_threads(cpl: int, rpw: int) -> int:
    """Threads a block of variant (cpl, rpw) may have (``move_max_threads``
    of the source, whose launch refuses a larger block): as many as the
    SM's 65 536 registers hold, in multiples of 128, at most 1024, at
    rpw * cpl + rpw + cpl + 32 registers a thread (rounded up to 8)."""
    if rpw == 0:
        return 1024
    regs = -(-(rpw * cpl + rpw + cpl + 32) // 8) * 8
    return min(1024, 65536 // regs // 128 * 128)


def move_smem_bytes(n: int, n_cols: int, n_orb: int = 0, n_det: int = 0,
                    ci: bool = False, smem_rows: int = 0) -> int:
    """Dynamic shared memory of a launch (``move_smem_floats`` of the
    source)."""
    f = (_up4(n_cols) + _up4(n) + _up4(n + (n_orb if ci else 0))
         + 2 * _RED_SLOTS + 4)
    if ci:
        f += _up4(n_orb) + _up4(n_det)
    return 4 * (f + smem_rows * n)


@dataclass(frozen=True)
class MoveLaunch:
    """A launch shape: the variant (CPL columns a lane, RPW rows a warp in
    registers; 0, 0 for none), threads per block, the rows past the
    register rows kept in shared memory, dynamic shared memory bytes."""
    cpl: int
    rpw: int
    threads: int
    smem_rows: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def move_shape(n: int, n_cols: int, n_orb: int = 0, n_det: int = 0,
               ci: bool = False, optin: int = OPTIN_H100) -> MoveLaunch:
    """The launch of one move, a pure function of the sizes.

    The variant is the first of ``MOVE_VARIANTS`` whose 32 * CPL columns
    cover n, else (0, 0), which takes any n.  Threads: 32 per RPW rows of
    the n [+ n_orb] table rows, at most ``move_max_threads``; (0, 0) one
    warp a row up to 1024.  The rows past the register rows go to shared
    memory as far as ``optin`` holds them, the rest are read again from
    device memory for the update."""
    rows = n + (n_orb if ci else 0)
    cpl, rpw = next((v for v in MOVE_VARIANTS if v[1] and 32 * v[0] >= n),
                    (0, 0))
    cap = move_max_threads(cpl, rpw)
    threads = min(cap, 32 * -(-rows // rpw) if rpw else 32 * rows)
    base = move_smem_bytes(n, n_cols, n_orb, n_det, ci, 0)
    if base > optin:
        raise ValueError(f'sem_move: {base} B of shared memory for n={n}, '
                         f'n_orb={n_orb}, n_det={n_det}; a block has {optin}')
    over = max(0, rows - rpw * (threads // 32))
    keep = min(over, (optin - base) // (4 * n))
    return MoveLaunch(cpl, rpw, threads, keep,
                      move_smem_bytes(n, n_cols, n_orb, n_det, ci, keep))


def _configure_move(lib) -> None:
    # minv, phi, phi_sw, phi_sc, r, r_new, d_jas, logu, logu_s, sign,
    # logdet, acc, margin, P, rdet, r_other, holes, parts, coeffs, ws; W,
    # n, n_cols, n_e, e, j, n_orb, n_det, k, ci, cpl, rpw, threads,
    # smem_rows; stream
    lib.sem_move_launch.argtypes = ([_VP, _VP, _LL, _LL] + [_VP] * 4
                                    + [_LL] + [_VP] * 11 + [_I] * 14 + [_VP])
    lib.sem_move_launch.restype = _I
    lib.sem_move_smem_bytes.argtypes = [_I] * 6
    lib.sem_move_smem_bytes.restype = _LL
    lib.sem_move_max_threads.argtypes = [_I, _I]
    lib.sem_move_max_threads.restype = _I
    lib.sem_move_optin.argtypes = [ctypes.POINTER(_I)]
    lib.sem_move_optin.restype = _I
    lib.sem_move_ci_workspace.argtypes = [_I] * 4
    lib.sem_move_ci_workspace.restype = _LL


def _move_lib():
    return _build.load('sem_move', _configure_move)


_OPTIN: dict = {}


def device_optin(dev) -> int:
    """A block's opt-in shared memory (bytes) on a CUDA device, as the CUDA
    runtime reports it (kept for the process)."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _OPTIN:
        val = _I()
        with torch.cuda.device(index):
            _build.check(_move_lib().sem_move_optin(ctypes.byref(val)),
                         'sem_move_optin')
        _OPTIN[index] = int(val.value)
    return _OPTIN[index]


def _need(name, t, dev, dt, shape, contiguous=True):
    if t.device != dev or dev.type != 'cuda':
        raise ValueError(f'{name} must be on the CUDA device of minv '
                         f'({dev}), got {t.device}')
    if t.dtype != dt or tuple(t.shape) != tuple(shape) or (
            contiguous and not t.is_contiguous()):
        raise ValueError(f'{name}: need a {"contiguous " if contiguous else ""}'
                         f'{tuple(shape)} {dt} tensor, got {tuple(t.shape)} '
                         f'{t.dtype}')


def sem_move_inplace(minv, v, r, r_new, d_jas, logu, sign, logdet, acc,
                     margin, e: int, j: int, ci=None) -> MoveLaunch:
    """Launch one move of all walkers; minv, r, sign, logdet (and P, rdet)
    are updated IN PLACE, accept and margin written into ``acc``/``margin``.

    minv (W, n, n), r (W, n_e, 3), r_new (W, 3), d_jas (W,), sign/logdet
    (W,): contiguous f32 on one CUDA device; v (W, n_cols) f32, any
    strides (phi is v[:, :n]); logu (W,) f32, any stride; acc (W,) bool or
    uint8 and margin (W,) f32, contiguous (row e of the sweep's outputs).
    ``ci`` = (P (W, n_orb, n), rdet (W, n_det), r_other (W, n_det), holes
    (n_det, k) i32, parts (n_det, k) i32, coeffs (n_det,)) with the lists
    sentinel-padded to a rank k >= 2 (``WavefunctionConfig.ci_t.*_k``;
    above the registers' rank the call allocates the kernel's workspace)
    and n_cols = n_orb.  Returns the
    launch shape (``move_shape``).
    """
    if ci is not None:
        check_ci_rank('sem_move', ci[3].shape[-1])
    dev = minv.device
    W, n, n2 = minv.shape
    if n != n2:
        raise ValueError(f'minv must be (W, n, n), got {tuple(minv.shape)}')
    if v.dim() != 2 or v.shape[0] != W:
        raise ValueError(f'v must be (W={W}, n_cols), got {tuple(v.shape)}')
    n_e, n_cols = r.shape[1], v.shape[1]
    for name, t, shape, cont in (('minv', minv, (W, n, n), True),
                                 ('v', v, (W, n_cols), False),
                                 ('r', r, (W, n_e, 3), True),
                                 ('r_new', r_new, (W, 3), True),
                                 ('d_jas', d_jas, (W,), True),
                                 ('logu', logu, (W,), False),
                                 ('sign', sign, (W,), True),
                                 ('logdet', logdet, (W,), True),
                                 ('margin', margin, (W,), True)):
        _need(name, t, dev, torch.float32, shape, cont)
    if acc.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f'acc: need a bool or uint8 tensor, got {acc.dtype}')
    _need('acc', acc, dev, acc.dtype, (W,))
    if not (0 <= e < n and 0 <= j < n_e):
        raise ValueError(f'move e={e}, j={j} outside n={n}, n_e={n_e}')
    n_orb = n_det = k = 0
    P = rdet = r_other = holes = parts = coeffs = None
    if ci is not None:
        P, rdet, r_other, holes, parts, coeffs = ci
        n_orb, n_det, k = P.shape[1], rdet.shape[1], holes.shape[-1]
        if n_cols != n_orb:
            raise ValueError(f'CI move needs v over all {n_orb} orbitals, '
                             f'got {n_cols} columns')
        for name, t, dt, shape in (
                ('P', P, torch.float32, (W, n_orb, n)),
                ('rdet', rdet, torch.float32, (W, n_det)),
                ('r_other', r_other, torch.float32, (W, n_det)),
                ('holes', holes, torch.int32, (n_det, k)),
                ('parts', parts, torch.int32, (n_det, k)),
                ('coeffs', coeffs, torch.float32, (n_det,))):
            _need(name, t, dev, dt, shape)
    elif n_cols != n:
        raise ValueError(f'single-determinant move needs v over the {n} '
                         f'occupied orbitals, got {n_cols} columns')
    shape = move_shape(n, n_cols, n_orb, n_det, ci is not None,
                       device_optin(dev))

    def _p(t):
        return None if t is None else t.data_ptr()
    lib = _move_lib()
    ws = None
    if ci is not None and (nf := lib.sem_move_ci_workspace(
            W, n_det, k, shape.threads)):
        ws = torch.empty(nf, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sem_move_launch(
            minv.data_ptr(), v.data_ptr(), v.stride(0), v.stride(1),
            r.data_ptr(), r_new.data_ptr(), d_jas.data_ptr(),
            logu.data_ptr(), logu.stride(0), sign.data_ptr(),
            logdet.data_ptr(), acc.data_ptr(), margin.data_ptr(), _p(P),
            _p(rdet), _p(r_other), _p(holes), _p(parts), _p(coeffs),
            _p(ws), W, n,
            n_cols, n_e, e, j, n_orb, n_det, k, int(ci is not None),
            shape.cpl, shape.rpw, shape.threads, shape.smem_rows, stream)
    _build.check(err, f'sem_move_launch ({shape})')
    MOVE_COUNTER.add('ci' if ci is not None else 'single')
    return shape
