"""ctypes wrapper of ``csrc/fused_sweep.cu`` (route: CUDA C++, sm_90a).

Replaces ``repro/kernels/fused_sweep/kernel.py::fused_sweep_call``.  One
thread block per walker; ``threads`` (threads per block) is the launch
parameter ``autotune.best_threads`` picks.  ``route`` says where the
inverse (and the CI table) live during the sweep: 'shared' memory when it
fits the card's opt-in limit, else 'global' (device) memory; 'auto' picks.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

COUNTER = _build.LaunchCounter()
ROUTES = {'auto': 0, 'shared': 1, 'global': 2}
_ROUTE_NAMES = {1: 'shared', 2: 'global'}
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
MAX_RANK = 8      # CI_MAX_RANK of csrc/ci_ratio.cuh


def _configure(lib) -> None:
    # 17 pointers; W, n, n_cols, n_e, offset, n_up, n_orb, n_det, k, ci,
    # threads, route; &route_used; stream
    lib.fused_sweep_launch.argtypes = [_VP] * 17 + [_I] * 12 + [_PI, _VP]
    lib.fused_sweep_launch.restype = _I
    lib.fused_sweep_smem_bytes.argtypes = [_I] * 7 + [_PI]
    lib.fused_sweep_smem_bytes.restype = _LL
    lib.fused_sweep_max_rank.argtypes = []
    lib.fused_sweep_max_rank.restype = _I
    if lib.fused_sweep_max_rank() != MAX_RANK:
        raise RuntimeError(f'fused_sweep.cu CI_MAX_RANK '
                           f'{lib.fused_sweep_max_rank()} != {MAX_RANK}')


def _lib():
    return _build.load('fused_sweep', _configure)


def _check(name, t, dev, dt, shape):
    if t.device != dev or dev.type != 'cuda':
        raise ValueError(f'{name} must be on the CUDA device of minv '
                         f'({dev}), got {t.device}')
    if t.dtype != dt or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f'{name}: need a contiguous {tuple(shape)} {dt} '
                         f'tensor, got {tuple(t.shape)} {t.dtype}')


def smem_bytes(n: int, n_cols: int, n_e: int, n_orb: int = 0,
               n_det: int = 0, ci: bool = False, route: str = 'auto'):
    """(route taken, dynamic shared memory bytes) of a launch on the
    current CUDA device; raises when it cannot run at all."""
    used = ctypes.c_int(0)
    nbytes = _lib().fused_sweep_smem_bytes(n, n_cols, n_e, n_orb, n_det,
                                           int(ci), ROUTES[route],
                                           ctypes.byref(used))
    if nbytes < 0:
        raise ValueError(f'fused_sweep: the per-move buffers for n={n}, '
                         f'n_e={n_e}, n_orb={n_orb}, n_det={n_det} exceed '
                         f'the shared memory of one block')
    return _ROUTE_NAMES[used.value], int(nbytes)


def fused_sweep_inplace(minv, phi, r, r_prop, en_delta, logu, sign, logdet,
                        b_ee, ci=None, *, offset: int, n_up: int,
                        threads: int = 128, route: str = 'auto'):
    """Launch one spin block's sweep; minv, r, sign, logdet (and P, rdet)
    are updated IN PLACE.

    minv (W, n, n), phi (W, n, n_cols), r (W, n_e, 3), r_prop (W, n, 3),
    en_delta/logu (W, n), sign/logdet (W,), b_ee () — contiguous f32 on one
    CUDA device.  ``ci`` = (P (W, n_orb, n), rdet (W, n_det), r_other
    (W, n_det), holes (n_det, k) i32, parts (n_det, k) i32, coeffs
    (n_det,)) with the lists sentinel-padded to a rank k with
    2 <= k <= ``MAX_RANK`` (``WavefunctionConfig.ci_t.*_k``).

    Returns (accept (W, n) bool, margin (W, n) f32, route taken).
    """
    if ci is not None and not 2 <= ci[3].shape[-1] <= MAX_RANK:
        raise ValueError(f'fused_sweep kernel supports excitation rank '
                         f'<= {MAX_RANK} (CI_MAX_RANK of csrc/ci_ratio.cuh), '
                         f'with the lists sentinel-padded to rank >= 2; got '
                         f'k={ci[3].shape[-1]}')
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
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f'threads={threads}: a multiple of 32 in [32, 1024]')
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
    acc = torch.empty((W, n), dtype=torch.uint8, device=dev)
    margin = torch.empty((W, n), dtype=torch.float32, device=dev)

    def _p(t):
        return None if t is None else t.data_ptr()
    used = ctypes.c_int(0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_sweep_launch(
            minv.data_ptr(), phi.data_ptr(), r.data_ptr(), r_prop.data_ptr(),
            en_delta.data_ptr(), logu.data_ptr(), sign.data_ptr(),
            logdet.data_ptr(), acc.data_ptr(), margin.data_ptr(),
            b_ee.data_ptr(), _p(P), _p(rdet), _p(r_other), _p(holes),
            _p(parts), _p(coeffs), W, n, n_cols, n_e, offset, n_up, n_orb,
            n_det, k, int(ci is not None), threads, ROUTES[route],
            ctypes.byref(used), stream)
    if used.value < 0:
        raise ValueError(f'fused_sweep: the per-move buffers for n={n}, '
                         f'n_e={n_e}, n_orb={n_orb}, n_det={n_det} exceed '
                         f'the shared memory of one block')
    _build.check(err, 'fused_sweep_launch')
    COUNTER.add()
    return acc.bool(), margin, _ROUTE_NAMES[used.value]
