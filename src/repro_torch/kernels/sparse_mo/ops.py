"""Tile-activity extraction and dispatch for the block-sparse MO product.

Port of ``repro.kernels.sparse_mo.ops`` for Hopper: the tiles are the CUDA
kernel's (``kernel.TILES``: 40 orbitals x 32 AO rows x 16 electrons), not
the TPU's 128-lane tiles, and nothing is padded — the kernel masks the
ragged edges itself.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import mo_products_ref, sparse_mo_matmul_ref


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


def sparse_mo_products(A: torch.Tensor, B: torch.Tensor,
                       ao_active: torch.Tensor) -> torch.Tensor:
    """Tile-sparse C_i = A @ B_i for i=1..5.

    A: (n_orb, n_ao); B: (n_ao, n_e, 5); ao_active: (n_e, n_ao) bool.  The
    electron axis may be one walker's n_e or a walker-major flattened
    W * n_e.  Returns C: (n_orb, n_e, 5).

    CUDA tensors go through the CUDA kernel; CPU tensors through its plain
    version on the same tile lists.
    """
    n_orb, n_ao = A.shape
    n_e = B.shape[1]
    _, tile_k, tile_e = kernel.TILES
    ids, num = tile_block_ids(ao_active, tile_e=tile_e, tile_k=tile_k,
                              max_kb=-(-n_ao // tile_k))
    B2 = B.reshape(n_ao, n_e * 5)
    if A.device.type == 'cuda':
        C2 = kernel.sparse_mo_matmul(A.contiguous(), B2.contiguous(), ids,
                                     num)
    elif A.device.type == 'cpu':
        C2 = sparse_mo_matmul_ref(A, B2, ids, num, tile_k=tile_k,
                                  tile_e=tile_e)
    else:
        raise ValueError(f'unsupported device {A.device}')
    return C2.reshape(n_orb, n_e, 5)


__all__ = ['sparse_mo_products', 'tile_block_ids', 'mo_products_ref',
           'sparse_mo_matmul_ref']
