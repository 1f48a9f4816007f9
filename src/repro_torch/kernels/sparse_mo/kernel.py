"""ctypes wrapper of ``csrc/sparse_mo.cu`` (route: CUDA C++, sm_90a).

Replaces ``repro/kernels/sparse_mo/kernel.py::sparse_mo_matmul``.  The tile
constants are compiled into ``csrc/mo_tile.cuh``; ``mo_tile.CONFIG``
mirrors them and is checked against the library when it is loaded.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, mo_tile

COUNTER = _build.LaunchCounter()
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _configure(lib) -> None:
    lib.sparse_mo_launch.argtypes = [_VP, _LL, _VP, _VP, _VP, _VP, _I, _I,
                                     _LL, _VP]
    lib.sparse_mo_launch.restype = _I
    lib.sparse_mo_plan.argtypes = [_I, _I, _VP]
    lib.sparse_mo_plan.restype = _I
    lib.sparse_mo_config.argtypes = [_VP]
    lib.sparse_mo_config.restype = _I
    got = (ctypes.c_int * 3)()
    lib.sparse_mo_config(ctypes.cast(got, _VP))
    mo_tile.check_config(got, 'sparse_mo.cu')


def _lib():
    return _build.load('sparse_mo', _configure)


def plan(n_orb: int, n_ao: int) -> dict:
    """The launch plan at these widths on the current CUDA device:
    orbitals per stage, stages, threads per block, list and union
    capacities, shared memory bytes (``mo_tile.PLAN_FIELDS``)."""
    out = (ctypes.c_int * 6)()
    _lib().sparse_mo_plan(int(n_orb), int(n_ao), ctypes.cast(out, _VP))
    return dict(zip(mo_tile.PLAN_FIELDS, out))


def sparse_mo_rows(At: torch.Tensor, B: torch.Tensor, mask: torch.Tensor,
                   order: torch.Tensor, n_orb: int) -> torch.Tensor:
    """Launch C[o, e, c] = sum over active j of A[o, j] B[e, j, c] on At's
    CUDA device.

    At: (n_ao, padded_width(n_orb)) f32, A transposed and zero padded
    (``mo_tile.transposed``); B: (N, n_ao, 5) f32, the AO pass's rows;
    mask: (N, n_ao) bool; order: (N,) int32, a permutation of 0..N-1 (the
    tiles' electron order).  All contiguous on one CUDA device.  Returns C: (n_orb, N, 5) f32 in the caller's electron order, a view
    of the electron-major buffer the kernel writes (``mo_tile.output``).
    """
    dev = At.device
    n_ao = At.shape[0]
    N = B.shape[0]
    for name, t, dt, shape in (('At', At, torch.float32, At.shape),
                               ('B', B, torch.float32, (N, n_ao, 5)),
                               ('mask', mask, torch.bool, (N, n_ao)),
                               ('order', order, torch.int32, (N,))):
        mo_tile.check_tensor(name, t, dev, dt, shape)
    mo_tile.check_at(At, n_orb)
    if N >= 2 ** 31:
        raise ValueError(f'sparse_mo: N={N} electrons does not fit int32')
    buf, C = mo_tile.output(N, n_orb, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sparse_mo_launch(At.data_ptr(), At.shape[1], B.data_ptr(),
                                   mask.data_ptr(), order.data_ptr(),
                                   buf.data_ptr(), n_orb, n_ao, N, stream)
    _build.check(err, 'sparse_mo_launch')
    if N > 0:
        COUNTER.add()
    return C
