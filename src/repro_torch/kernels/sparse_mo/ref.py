"""Plain PyTorch versions of the block-sparse MO product."""
from __future__ import annotations

import torch


def mo_products_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Dense oracle.  A: (n_orb, n_ao); B: (n_ao, n_e, 5) -> (n_orb, n_e, 5).

    B carries exact zeros outside the screened AO set, so the dense product
    equals the sparse one up to summation order.
    """
    n_ao, n_e, five = B.shape
    C = A @ B.reshape(n_ao, n_e * five)
    return C.reshape(A.shape[0], n_e, five)


def sparse_mo_matmul_ref(A: torch.Tensor, B2d: torch.Tensor,
                         block_ids: torch.Tensor, num_active: torch.Tensor,
                         *, tile_k: int, tile_e: int) -> torch.Tensor:
    """The kernel's function on the kernel's inputs: C = A @ B2d over the
    listed (electron tile, k-tile) pairs only.

    A: (n_orb, n_ao); B2d: (n_ao, n_cols) with n_cols = 5 * n_e;
    block_ids (e_tiles, max_kb) / num_active (e_tiles,) int32.  Entries of
    B2d outside the listed tiles are ignored, exactly as the kernel skips
    them, so a tile list that misses an active tile shows up here too.
    """
    n_ao, n_cols = B2d.shape
    cols = 5 * tile_e
    e_tiles, max_kb = block_ids.shape
    n_kb = -(-n_ao // tile_k)
    listed = (torch.arange(max_kb, device=B2d.device)[None, :]
              < num_active[:, None])                        # (e_tiles, max_kb)
    tile_on = torch.zeros((e_tiles, n_kb + 1), dtype=torch.bool,
                          device=B2d.device)
    ids = torch.where(listed, block_ids.long(),
                      torch.full_like(block_ids, n_kb, dtype=torch.long))
    tile_on.scatter_(1, ids, True)
    tile_on = tile_on[:, :n_kb]                             # (e_tiles, n_kb)
    mask = tile_on.T.repeat_interleave(tile_k, 0)[:n_ao]    # (n_ao, e_tiles)
    mask = mask.repeat_interleave(cols, 1)[:, :n_cols]      # (n_ao, n_cols)
    return A @ torch.where(mask, B2d, torch.zeros((), dtype=B2d.dtype,
                                                  device=B2d.device))
