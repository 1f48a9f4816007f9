"""ctypes wrapper of ``csrc/multidet_ratio.cu`` (route: CUDA C++, sm_90a).

Replaces ``repro/kernels/multidet_ratio/kernel.py::multidet_ratio_matmul``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

COUNTER = _build.LaunchCounter()
_VP, _I = ctypes.c_void_p, ctypes.c_int


def _configure(lib) -> None:
    lib.multidet_ratio_launch.argtypes = [_VP] * 9 + [_I] * 4 + [_VP]
    lib.multidet_ratio_launch.restype = _I


def _lib():
    return _build.load('multidet_ratio', _configure)


def multidet_ratio(P: torch.Tensor, g: torch.Tensor, row: torch.Tensor,
                   holes2: torch.Tensor, parts2: torch.Tensor,
                   coeffs: torch.Tensor, r_other: torch.Tensor):
    """Launch the all-determinant move ratios on P's CUDA device.

    P (W, n_orb, n_occ), g (W, n_orb), row (W, n_occ), coeffs (n_det,),
    r_other (W, n_det): contiguous f32; holes2/parts2 (n_det, 2) contiguous
    int32, sentinel-padded to rank 2.  Returns (ratios (W, n_det), S (W,)).
    """
    dev = P.device
    W, n_orb, n_occ = P.shape
    n_det = coeffs.shape[0]
    for name, t, dt, shape in (
            ('P', P, torch.float32, (W, n_orb, n_occ)),
            ('g', g, torch.float32, (W, n_orb)),
            ('row', row, torch.float32, (W, n_occ)),
            ('holes2', holes2, torch.int32, (n_det, 2)),
            ('parts2', parts2, torch.int32, (n_det, 2)),
            ('coeffs', coeffs, torch.float32, (n_det,)),
            ('r_other', r_other, torch.float32, (W, n_det))):
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'{name} must be on the CUDA device of P '
                             f'({dev}), got {t.device}')
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'{name}: need a contiguous {shape} {dt} tensor, '
                             f'got {tuple(t.shape)} {t.dtype}')
    ratios = torch.empty((W, n_det), dtype=torch.float32, device=dev)
    S = torch.empty((W,), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.multidet_ratio_launch(
            P.data_ptr(), g.data_ptr(), row.data_ptr(), holes2.data_ptr(),
            parts2.data_ptr(), coeffs.data_ptr(), r_other.data_ptr(),
            ratios.data_ptr(), S.data_ptr(), W, n_orb, n_occ, n_det, stream)
    _build.check(err, 'multidet_ratio_launch')
    COUNTER.add()
    return ratios, S
