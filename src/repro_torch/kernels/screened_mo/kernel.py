"""ctypes wrapper of ``csrc/screened_mo.cu`` (route: CUDA C++, sm_90a).

Replaces ``repro/kernels/screened_mo/kernel.py::screened_mo_matmul``.  The
tile constants are compiled into ``csrc/mo_tile.cuh``; ``mo_tile.CONFIG``
mirrors them and is checked against the library when it is loaded.  The
kernel reads A transposed and padded to whole orbital stages (``At``,
``mo_tile.transposed``), so that a union's AO rows are 16-byte copies.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, mo_tile

COUNTER = _build.LaunchCounter()
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _configure(lib) -> None:
    lib.screened_mo_launch.argtypes = [_VP, _LL] + [_VP] * 5 + [
        _I, _I, _LL, _I, _VP]
    lib.screened_mo_launch.restype = _I
    lib.screened_mo_plan.argtypes = [_I, _I, _I, _VP]
    lib.screened_mo_plan.restype = _I
    lib.screened_mo_config.argtypes = [_VP]
    lib.screened_mo_config.restype = _I
    got = (ctypes.c_int * 3)()
    lib.screened_mo_config(ctypes.cast(got, _VP))
    mo_tile.check_config(got, 'screened_mo.cu')


def _lib():
    return _build.load('screened_mo', _configure)


def plan(n_orb: int, n_ao: int, K: int) -> dict:
    """The launch plan at these widths on the current CUDA device
    (``mo_tile.PLAN_FIELDS``)."""
    out = (ctypes.c_int * 6)()
    _lib().screened_mo_plan(int(n_orb), int(n_ao), int(K),
                            ctypes.cast(out, _VP))
    return dict(zip(mo_tile.PLAN_FIELDS, out))


def screened_mo_matmul(At: torch.Tensor, Bp: torch.Tensor, idx: torch.Tensor,
                       active: torch.Tensor, order: torch.Tensor,
                       n_orb: int) -> torch.Tensor:
    """Launch C[:, e, c] = sum over active k of A[:, idx[e, k]] Bp[e, k, c]
    on At's CUDA device.

    At: (n_ao, padded_width(n_orb)) f32 (``mo_tile.transposed``); Bp:
    (N, K, 5) f32; idx: (N, K) int32 with every active id in [0, n_ao),
    strictly ascending over an electron's active slots; active: (N, K)
    bool; order: (N,) int32, a permutation of 0..N-1.  All contiguous on
    one CUDA device.  Returns C: (n_orb, N, 5) f32 in the caller's order,
    a view of the electron-major buffer the kernel writes
    (``mo_tile.output``).
    """
    dev = At.device
    n_ao = At.shape[0]
    N, K = idx.shape
    for name, t, dt, shape in (('At', At, torch.float32, At.shape),
                               ('Bp', Bp, torch.float32, (N, K, 5)),
                               ('idx', idx, torch.int32, (N, K)),
                               ('active', active, torch.bool, (N, K)),
                               ('order', order, torch.int32, (N,))):
        mo_tile.check_tensor(name, t, dev, dt, shape)
    mo_tile.check_at(At, n_orb)
    if N >= 2 ** 31:
        raise ValueError(f'screened_mo: N={N} electrons does not fit int32')
    buf, C = mo_tile.output(N, n_orb, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.screened_mo_launch(At.data_ptr(), At.shape[1],
                                     Bp.data_ptr(), idx.data_ptr(),
                                     active.data_ptr(), order.data_ptr(),
                                     buf.data_ptr(), n_orb, n_ao, N, K,
                                     stream)
    _build.check(err, 'screened_mo_launch')
    if N > 0:
        COUNTER.add()
    return C
