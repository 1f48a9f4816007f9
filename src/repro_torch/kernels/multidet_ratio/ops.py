"""Dispatch for the batched multideterminant move ratios.

Port of ``repro.kernels.multidet_ratio.ops``.  The CUDA kernel gathers the
table entries itself, so there is no (W, 8, n_det) plane stack and no
padding of the walker or determinant axes (the TPU kernel padded both to
its (8, 128) tiles).
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernel
from .ref import multidet_ratios_ref


def normalized_excitations(holes, parts, n_occ: int, n_orb: int):
    """Sentinel-pad (n_det, k<=2) excitation lists to exactly k = 2
    (``repro.kernels.multidet_ratio.ops.normalized_excitations``): pad slot
    ``a`` is (n_occ + a, n_orb + a).  Rank > 2 raises: the kernels support
    excitation rank <= 2."""
    holes = np.asarray(holes); parts = np.asarray(parts)
    k = holes.shape[1]
    if k > 2:
        raise ValueError(f'multidet ratio kernel supports excitation rank '
                         f'<= 2, got k={k}')
    if k == 2:
        return holes.astype(np.int32), parts.astype(np.int32)
    n_det = holes.shape[0]
    pad_h = np.zeros((n_det, 2 - k), np.int32)
    pad_p = np.zeros((n_det, 2 - k), np.int32)
    for a in range(k, 2):
        pad_h[:, a - k] = n_occ + a
        pad_p[:, a - k] = n_orb + a
    return (np.concatenate([holes, pad_h], axis=1).astype(np.int32),
            np.concatenate([parts, pad_p], axis=1).astype(np.int32))


def multidet_ratios(P: torch.Tensor, g: torch.Tensor, row: torch.Tensor,
                    holes, parts, coeffs, r_other: torch.Tensor):
    """Batched multideterminant move ratios + CI sum
    (``repro.kernels.multidet_ratio.ops.multidet_ratios``; same signature
    and semantics as ``ref.multidet_ratios_ref``).

    A CPU ``P`` runs the plain version; a CUDA ``P`` launches the kernel,
    with the lists sentinel-padded to rank 2 (pass them pre-padded as
    int32 CUDA tensors, ``WavefunctionConfig.ci_t``, to skip the host
    copy).  Returns (ratios (W, n_det), ci (W,)).
    """
    if P.device.type == 'cpu':
        return multidet_ratios_ref(P, g, row, holes, parts, coeffs, r_other)
    if P.device.type != 'cuda':
        raise ValueError(f'unsupported device {P.device}')
    if not (isinstance(holes, torch.Tensor) and holes.dtype == torch.int32
            and holes.shape[-1] == 2 and holes.device == P.device):
        h2, p2 = normalized_excitations(
            holes.cpu() if isinstance(holes, torch.Tensor) else holes,
            parts.cpu() if isinstance(parts, torch.Tensor) else parts,
            P.shape[-1], P.shape[-2])
        holes = torch.as_tensor(h2, device=P.device)
        parts = torch.as_tensor(p2, device=P.device)
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=P.device)
    return kernel.multidet_ratio(P.contiguous(), g.contiguous(),
                                 row.contiguous(), holes, parts.contiguous(),
                                 coeffs.contiguous(), r_other.contiguous())


__all__ = ['multidet_ratios', 'multidet_ratios_ref',
           'normalized_excitations']
