"""Dispatch for the batched Sherman–Morrison update.

Port of ``repro.kernels.sem_update.ops``.  No padding: the CUDA kernel
takes any n (79 stays 79), where the TPU kernel padded both matrix axes to
the 128-lane tile.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import sem_update_ref


def sem_rank1_update(minv: torch.Tensor, u: torch.Tensor, row: torch.Tensor,
                     accept: torch.Tensor, j: int) -> torch.Tensor:
    """Batched Sherman–Morrison rank-1 update + row replacement.

    Same signature and semantics as ``ref.sem_update_ref``.  A CUDA
    ``minv`` is updated IN PLACE by the kernel and returned (callers own
    the buffer: the sweep clones its inverses once per sweep); a CPU
    ``minv`` goes through the plain version, which returns a new tensor.
    """
    if minv.device.type == 'cuda':
        return kernel.sem_update_inplace(minv, u.contiguous(),
                                         row.contiguous(),
                                         accept.contiguous(), j)
    if minv.device.type == 'cpu':
        return sem_update_ref(minv, u, row, accept, j)
    raise ValueError(f'unsupported device {minv.device}')


__all__ = ['sem_rank1_update', 'sem_update_ref']
