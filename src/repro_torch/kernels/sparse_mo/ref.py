"""Plain PyTorch versions of the sparse MO product."""
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


def sparse_mo_rows_ref(A: torch.Tensor, B: torch.Tensor, mask: torch.Tensor,
                       order: torch.Tensor) -> torch.Tensor:
    """The kernel's function on the kernel's inputs, tile order included.

    A: (n_orb, n_ao); B: (N, n_ao, 5) AO rows; mask: (N, n_ao) bool;
    order: (N,) a permutation of 0..N-1.  The electrons are taken in
    ``order``, their inactive entries zeroed (whatever they hold, NaN
    included), and each column is written back at its caller's index, as
    the kernel writes it.  Returns C: (n_orb, N, 5).
    """
    o = order.long()
    Bz = torch.where(mask[o][..., None], B[o],
                     torch.zeros((), dtype=B.dtype, device=B.device))
    C = torch.empty((A.shape[0], B.shape[0], 5), dtype=A.dtype,
                    device=A.device)
    C[:, o] = torch.einsum('oj,ejc->oec', A, Bz)
    return C
