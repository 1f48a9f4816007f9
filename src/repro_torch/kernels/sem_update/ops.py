"""Dispatch for the batched Sherman–Morrison update and the per-move kernel.

Port of ``repro.kernels.sem_update.ops``.  No padding: the CUDA kernels
take any n (79 stays 79), where the TPU kernel padded both matrix axes to
the 128-lane tile.  ``sem_move`` is the per-move sweep's one call a move
(``core.sem._sweep_spin_block``); ``sem_rank1_update`` keeps the TPU
kernel's own signature.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import sem_move_ref, sem_update_ref


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


def sem_move(state, v_all: torch.Tensor, r_new: torch.Tensor,
             d_jas: torch.Tensor, logu: torch.Tensor, e: int, j: int,
             acc: torch.Tensor, margin: torch.Tensor, ci=None):
    """One move of all walkers (``ref.sem_move_ref``'s arguments and
    semantics); the move's accept flags and margins go into row e of
    ``acc`` (n_blk, W) bool and ``margin`` (n_blk, W).

    A CUDA state launches the kernel, which updates it IN PLACE (r, minv,
    sign, logdet, P, rdet: the caller's own buffers) and returns it; the
    CI lists must then be the int32 ``*_k`` lists of
    ``WavefunctionConfig.ci_t``.  A CPU state runs the plain version.
    Returns the new state.
    """
    r, minv, sign, logdet, P, rdet = state
    if minv.device.type == 'cuda':
        cik = None
        if ci is not None:
            r_other, holes, parts, coeffs = ci
            cik = (P, rdet, r_other, holes, parts, coeffs)
        kernel.sem_move_inplace(minv, v_all, r, r_new.contiguous(),
                                d_jas.contiguous(), logu, sign, logdet,
                                acc[e], margin[e], e, j, cik)
        return state
    if minv.device.type != 'cpu':
        raise ValueError(f'unsupported device {minv.device}')
    state, accept, mar = sem_move_ref(state, v_all, r_new, d_jas, logu, e,
                                      j, ci)
    acc[e] = accept
    margin[e] = mar
    return state


__all__ = ['sem_move', 'sem_move_ref', 'sem_rank1_update', 'sem_update_ref']
