"""Plain PyTorch version of the screened MO product."""
from __future__ import annotations

import torch


def screened_mo_ref(A: torch.Tensor, Bp: torch.Tensor, idx: torch.Tensor,
                    active: torch.Tensor, chunk: int = 1024,
                    order: torch.Tensor | None = None) -> torch.Tensor:
    """Gathered product over each electron's active candidates
    (``repro.kernels.screened_mo.ref.screened_mo_ref``), electron chunk by
    electron chunk.

    The reference gathers the per-electron A panels in one shot; at the
    b-strand ensemble (217 orbitals, 111 104 electrons, 200 candidates)
    that is a 19 GB tensor, so the panels are gathered ``chunk`` electrons
    at a time (``chunk <= 0``: one shot).  Each electron's column is the
    same contraction whatever the chunk.

    Args:
      A: (n_orb, n_ao) MO coefficients.
      Bp: (N, K, 5) packed candidate-AO values.
      idx: (N, K) candidate AO ids.
      active: (N, K) bool — inactive slots contribute nothing (whatever
        they hold).
      order: optional (N,) permutation of 0..N-1: the electrons are taken
        in this order (the kernel's tiles) and each column is written back
        at its caller's index, as the kernel writes it.

    Returns C: (n_orb, N, 5).
    """
    if order is not None:
        o = order.long()
        C = torch.empty((A.shape[0], Bp.shape[0], 5), dtype=A.dtype,
                        device=A.device)
        C[:, o] = screened_mo_ref(A, Bp[o], idx[o], active[o], chunk)
        return C
    N = Bp.shape[0]
    if chunk <= 0:
        chunk = max(N, 1)
    Bz = torch.where(active[..., None], Bp, torch.zeros((), dtype=Bp.dtype,
                                                        device=Bp.device))
    ix = idx.long()
    out = [torch.einsum('oek,ekf->oef', A[:, ix[s:s + chunk]],
                        Bz[s:s + chunk])
           for s in range(0, N, chunk)]
    if not out:
        return A.new_zeros((A.shape[0], 0, 5))
    return torch.cat(out, dim=1)
