"""ctypes wrapper of ``csrc/sem_update.cu`` (route: CUDA C++, sm_90a).

Replaces ``repro/kernels/sem_update/kernel.py::sem_update_matmul``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

COUNTER = _build.LaunchCounter()
_VP, _I = ctypes.c_void_p, ctypes.c_int


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
