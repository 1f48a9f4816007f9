"""Plain PyTorch version of the batched Sherman–Morrison update."""
from __future__ import annotations

import torch


def sem_update_ref(minv: torch.Tensor, u: torch.Tensor, row: torch.Tensor,
                   accept: torch.Tensor, j: int) -> torch.Tensor:
    """Batched rank-1 inverse update + row replacement, accepted walkers only.

    For each walker w with ``accept[w]``:

        minv[w] <- minv[w] - outer(u[w], row[w]);  minv[w, j] <- row[w]

    where ``u = minv @ phi_new`` and ``row = minv[j] / ratio``.  Rejected
    walkers pass through untouched, NaN/Inf in their ``row`` included.
    Returns a new (W, n, n) tensor; ``minv`` is not modified.
    """
    upd = minv - u[:, :, None] * row[:, None, :]
    upd[:, j, :] = row
    return torch.where(accept[:, None, None], upd, minv)
