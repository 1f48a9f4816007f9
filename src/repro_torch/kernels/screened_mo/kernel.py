"""ctypes wrapper of ``csrc/screened_mo.cu`` (route: CUDA C++, sm_90a).

Replaces ``repro/kernels/screened_mo/kernel.py::screened_mo_matmul``.  The
tile (8 electrons per block, orbitals in stages of 64, 256 threads) is
compiled into the kernel; ``CONFIG`` mirrors it and is checked against the
library when it is loaded.  The kernel reads A transposed (``At``,
(n_ao, n_orb)), so that a gathered AO row is contiguous across a warp.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

TILE_E, ORB_STAGE, THREADS = 8, 64, 256
CONFIG = (TILE_E, ORB_STAGE, THREADS)
COUNTER = _build.LaunchCounter()
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _configure(lib) -> None:
    lib.screened_mo_launch.argtypes = [_VP] * 5 + [_I, _LL, _I, _VP]
    lib.screened_mo_launch.restype = _I
    lib.screened_mo_tile.argtypes = [_I, ctypes.POINTER(_LL)]
    lib.screened_mo_tile.restype = _I
    lib.screened_mo_config.argtypes = [_VP]
    lib.screened_mo_config.restype = _I
    got = (ctypes.c_int * 3)()
    lib.screened_mo_config(ctypes.cast(got, _VP))
    if tuple(got) != CONFIG:
        raise RuntimeError(f'screened_mo.cu config {tuple(got)} != {CONFIG}')


def _lib():
    return _build.load('screened_mo', _configure)


def tile(K: int):
    """(electrons per block, dynamic shared memory bytes) of a launch at
    candidate width K on the current CUDA device (0 electrons: K too
    wide)."""
    nbytes = _LL(0)
    te = _lib().screened_mo_tile(int(K), ctypes.byref(nbytes))
    return int(te), int(nbytes.value)


def screened_mo_matmul(At: torch.Tensor, Bp: torch.Tensor, idx: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
    """Launch C[:, e, c] = sum over active k of At[idx[e, k], :] Bp[e, k, c]
    on At's CUDA device.

    At: (n_ao, n_orb) f32 (A transposed); Bp: (N, K, 5) f32; idx: (N, K)
    int32 with every active id in [0, n_ao); active: (N, K) bool.  All
    contiguous on one CUDA device.  Returns C: (n_orb, N, 5) f32.
    """
    dev = At.device
    n_ao, n_orb = At.shape
    N, K = idx.shape
    for name, t, dt, shape in (('At', At, torch.float32, (n_ao, n_orb)),
                               ('Bp', Bp, torch.float32, (N, K, 5)),
                               ('idx', idx, torch.int32, (N, K)),
                               ('active', active, torch.bool, (N, K))):
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'{name} must be on the CUDA device of At '
                             f'({dev}), got {t.device}')
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'{name}: need a contiguous {shape} {dt} '
                             f'tensor, got {tuple(t.shape)} {t.dtype}')
    C = torch.empty((n_orb, N, 5), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.screened_mo_launch(At.data_ptr(), Bp.data_ptr(),
                                     idx.data_ptr(), active.data_ptr(),
                                     C.data_ptr(), n_orb, N, K, stream)
    if err == 1 and N > 0 and tile(K)[0] == 0:
        raise ValueError(f'screened_mo: a candidate width of K={K} does not '
                         f'fit one block\'s shared memory')
    _build.check(err, 'screened_mo_launch')
    COUNTER.add()
    return C
