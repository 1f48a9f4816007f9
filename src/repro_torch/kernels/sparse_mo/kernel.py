"""ctypes wrapper of ``csrc/sparse_mo.cu`` (route: CUDA C++, sm_90a).

Replaces ``repro/kernels/sparse_mo/kernel.py::sparse_mo_matmul``.  The tile
shape is compiled into the kernel; ``TILES`` mirrors it and is checked
against the library when it is loaded.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

TILE_O, TILE_K, TILE_E = 40, 32, 16     # orbitals, AO rows, electrons
TILES = (TILE_O, TILE_K, TILE_E)
COUNTER = _build.LaunchCounter()
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _configure(lib) -> None:
    lib.sparse_mo_launch.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _LL,
                                     _I, _I, _VP]
    lib.sparse_mo_launch.restype = _I
    lib.sparse_mo_tiles.argtypes = [_VP]
    lib.sparse_mo_tiles.restype = _I
    got = (ctypes.c_int * 3)()
    lib.sparse_mo_tiles(ctypes.cast(got, _VP))
    if tuple(got) != TILES:
        raise RuntimeError(f'sparse_mo.cu tiles {tuple(got)} != {TILES}')


def _lib():
    return _build.load('sparse_mo', _configure)


def sparse_mo_matmul(A: torch.Tensor, B2d: torch.Tensor,
                     block_ids: torch.Tensor,
                     num_active: torch.Tensor) -> torch.Tensor:
    """Launch the block-sparse product C = A @ B2d on A's CUDA device.

    A: (n_orb, n_ao) f32; B2d: (n_ao, 5N) f32; block_ids (e_tiles, max_kb)
    int32 and num_active (e_tiles,) int32 with e_tiles = ceil(N / TILE_E),
    k-tiles of TILE_K rows.  All contiguous on one CUDA device.  Returns
    C: (n_orb, 5N) f32.
    """
    dev = A.device
    for name, t, dt, nd in (('A', A, torch.float32, 2),
                            ('B2d', B2d, torch.float32, 2),
                            ('block_ids', block_ids, torch.int32, 2),
                            ('num_active', num_active, torch.int32, 1)):
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'{name} must be on the CUDA device of A '
                             f'({dev}), got {t.device}')
        if t.dtype != dt or t.ndim != nd or not t.is_contiguous():
            raise ValueError(f'{name}: need a contiguous {nd}-d {dt} tensor, '
                             f'got {tuple(t.shape)} {t.dtype}')
    n_orb, n_ao = A.shape
    n_cols = B2d.shape[1]
    e_tiles, max_kb = block_ids.shape
    if B2d.shape[0] != n_ao or n_cols % 5:
        raise ValueError(f'B2d {tuple(B2d.shape)} does not match A '
                         f'{tuple(A.shape)} with 5 columns per electron')
    if e_tiles != -(-n_cols // (5 * TILE_E)) or num_active.shape[0] != e_tiles:
        raise ValueError(f'{e_tiles} electron tiles for {n_cols // 5} '
                         f'electrons at TILE_E={TILE_E}')
    C = torch.empty((n_orb, n_cols), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sparse_mo_launch(A.data_ptr(), B2d.data_ptr(),
                                   block_ids.data_ptr(), num_active.data_ptr(),
                                   C.data_ptr(), n_orb, n_ao, n_cols, e_tiles,
                                   max_kb, stream)
    _build.check(err, 'sparse_mo_launch')
    COUNTER.add()
    return C
