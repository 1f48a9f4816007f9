"""Dispatch for the screened MO product from packed candidate lists.

Port of ``repro.kernels.screened_mo.ops`` for Hopper: no 128-lane padding
and no TPU tiles (``kernel_tiles``); the CUDA kernel masks its ragged
edges and skips inactive slots itself, so neither the per-chunk activity
table nor the zeroing of inactive values is needed on the card.
"""
from __future__ import annotations

import threading
import weakref

import torch

from . import kernel
from .ref import screened_mo_ref

_AT_LOCK = threading.Lock()
_AT = {}       # device -> (weakref to A, A._version, A transposed)


def transposed(A: torch.Tensor) -> torch.Tensor:
    """A (n_orb, n_ao) as a contiguous (n_ao, n_orb) copy, made once per
    parameter tensor: kept (one per device) until A is replaced or
    modified in place (its version counter moves)."""
    key = str(A.device)
    with _AT_LOCK:
        got = _AT.get(key)
        if got is not None and got[0]() is A and got[1] == A._version:
            return got[2]
        At = A.t().contiguous()
        _AT[key] = (weakref.ref(A), A._version, At)
        return At


def screened_mo_products(A: torch.Tensor, Bp: torch.Tensor, idx: torch.Tensor,
                         active: torch.Tensor) -> torch.Tensor:
    """Screened-gather C_i = A @ B_i from the packed-CSR representation
    (``repro.kernels.screened_mo.ops.screened_mo_products``, without the
    TPU tile arguments).

    A: (n_orb, n_ao); Bp: (N, K, 5) packed candidate-AO values; idx:
    (N, K) candidate AO ids (int32 or int64); active: (N, K) bool.  Values
    at inactive slots never reach C.  The electron axis may be one
    walker's n_e or an ensemble flattened walker-major.  Returns C:
    (n_orb, N, 5).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel.
    """
    if A.device.type == 'cpu':
        return screened_mo_ref(A, Bp, idx, active)
    if A.device.type != 'cuda':
        raise ValueError(f'unsupported device {A.device}')
    return kernel.screened_mo_matmul(
        transposed(A), Bp.contiguous(), idx.to(torch.int32).contiguous(),
        active.contiguous())


__all__ = ['screened_mo_products', 'screened_mo_ref', 'transposed']
