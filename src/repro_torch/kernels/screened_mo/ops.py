"""Dispatch for the screened MO product from packed candidate lists.

Port of ``repro.kernels.screened_mo.ops`` for Hopper: no 128-lane padding
and no TPU tiles (``kernel_tiles``); the CUDA kernel takes the electrons
in tiles of a spatial key and skips inactive slots itself
(``csrc/mo_tile.cuh``), so neither the per-chunk activity table nor the
zeroing of inactive values is needed on the card.
"""
from __future__ import annotations

import torch

from . import kernel
from .. import mo_tile
from .ref import screened_mo_ref


def screened_mo_products(A: torch.Tensor, Bp: torch.Tensor, idx: torch.Tensor,
                         active: torch.Tensor,
                         key: torch.Tensor | None = None) -> torch.Tensor:
    """Screened-gather C_i = A @ B_i from the packed-CSR representation
    (``repro.kernels.screened_mo.ops.screened_mo_products``, without the
    TPU tile arguments).

    A: (n_orb, n_ao); Bp: (N, K, 5) packed candidate-AO values; idx:
    (N, K) candidate AO ids (int32 or int64, ascending over the active
    slots); active: (N, K) bool; key: (N,) integer tile key (the nearest
    atom, ``screening.active_ao_lists_keyed``), or None for the given
    order.  Values at inactive slots never reach C.  The electron axis may
    be one walker's n_e or an ensemble flattened walker-major.  Returns C:
    (n_orb, N, 5) in the caller's electron order.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel.
    """
    order = mo_tile.electron_order(key, idx.shape[0], device=idx.device)
    if A.device.type == 'cpu':
        return screened_mo_ref(A, Bp, idx, active, order=order)
    if A.device.type != 'cuda':
        raise ValueError(f'unsupported device {A.device}')
    return kernel.screened_mo_matmul(
        mo_tile.transposed(A), Bp.contiguous(),
        idx.to(torch.int32).contiguous(), active.contiguous(), order,
        A.shape[0])


__all__ = ['screened_mo_products', 'screened_mo_ref']
