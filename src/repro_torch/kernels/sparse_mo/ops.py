"""Dispatch for the sparse MO product, and the tile lists of the reference.

Port of ``repro.kernels.sparse_mo.ops`` for Hopper.  The TPU kernel took
the (n_ao, 5N) transpose of the AO block and a list of active k-tiles per
electron tile; the CUDA kernel takes the AO pass's own (N, n_ao, 5) rows,
the (N, n_ao) activity mask and an electron order, and compacts each
electron's active AOs itself (``csrc/mo_tile.cuh``).  ``tile_block_ids``
stays as the port of the reference's tile lists.
"""
from __future__ import annotations

import torch

from . import kernel
from .. import mo_tile
from .ref import mo_products_ref, sparse_mo_rows_ref


def tile_block_ids(ao_active: torch.Tensor, *, tile_e: int, tile_k: int,
                   max_kb: int):
    """Active k-tile lists per electron tile.

    ao_active: (n_e, n_ao) bool (exact-zero structure of B).  Returns
    (block_ids (e_tiles, max_kb) int32 ascending, zero padded;
    num_active (e_tiles,) int32).  Overflow beyond max_kb is truncated —
    callers pass max_kb >= the number of k-tiles for exactness.
    """
    n_e, n_ao = ao_active.shape
    e_tiles, n_kb = -(-n_e // tile_e), -(-n_ao // tile_k)
    act = torch.zeros((e_tiles * tile_e, n_kb * tile_k), dtype=torch.bool,
                      device=ao_active.device)
    act[:n_e, :n_ao] = ao_active
    tile_act = act.reshape(e_tiles, tile_e, n_kb, tile_k).any(dim=3).any(dim=1)
    # active tiles first, in ascending k order (stable sort on ~active)
    order = torch.argsort((~tile_act).to(torch.int8), dim=-1, stable=True)
    count = tile_act.sum(dim=-1).to(torch.int32)
    ids = order[:, :max_kb].to(torch.int32)
    keep = torch.arange(ids.shape[1], device=ids.device)[None] < count[:, None]
    ids = torch.where(keep, ids, torch.zeros_like(ids))
    return ids.contiguous(), torch.clamp(count, max=max_kb).contiguous()


def sparse_mo_rows(A: torch.Tensor, B: torch.Tensor, ao_active: torch.Tensor,
                   key: torch.Tensor | None = None) -> torch.Tensor:
    """C_i = A @ B_i over each electron's active AOs, from the AO pass's
    rows — the main path's entry.

    A: (n_orb, n_ao); B: (N, n_ao, 5) (``aos.eval_ao_rows``); ao_active:
    (N, n_ao) bool; key: (N,) integer tile key (the nearest atom), or None
    for the given order.  The electrons are taken in the order of a stable
    argsort of ``key``; the result is in the caller's order either way.
    Returns C: (n_orb, N, 5).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel.
    """
    order = mo_tile.electron_order(key, B.shape[0], device=B.device)
    if A.device.type == 'cpu':
        return sparse_mo_rows_ref(A, B, ao_active, order)
    if A.device.type != 'cuda':
        raise ValueError(f'unsupported device {A.device}')
    return kernel.sparse_mo_rows(mo_tile.transposed(A), B.contiguous(),
                                 ao_active.contiguous(), order, A.shape[0])


def sparse_mo_products(A: torch.Tensor, B: torch.Tensor,
                       ao_active: torch.Tensor) -> torch.Tensor:
    """Sparse C_i = A @ B_i for i=1..5 in the reference's layout
    (``repro.kernels.sparse_mo.ops.sparse_mo_products``, without the TPU
    tile arguments).

    A: (n_orb, n_ao); B: (n_ao, n_e, 5); ao_active: (n_e, n_ao) bool.  The
    electron axis may be one walker's n_e or a walker-major flattened
    W * n_e.  Returns C: (n_orb, n_e, 5), through ``sparse_mo_rows`` on the
    rows B.transpose(0, 1) in the given electron order.
    """
    return sparse_mo_rows(A, B.transpose(0, 1).contiguous(), ao_active)


__all__ = ['sparse_mo_products', 'sparse_mo_rows', 'tile_block_ids',
           'mo_products_ref', 'sparse_mo_rows_ref']
