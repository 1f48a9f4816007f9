"""MO matrix products C_i = A @ B_i, i=1..5 (paper §III — the hot spot).

Port of ``repro.core.mos``.  Both implementations return
``C: (n_orb, n_elec, 5)``:

* ``mo_products_dense``  — one dense matmul against the stacked B;
* ``mo_products_sparse`` — the paper's algorithm: per-electron gather of
  the active columns of A (A stays dense) against the packed B rows.

The third implementation is the CUDA kernel behind
``kernels.sparse_mo.ops.sparse_mo_products``.
"""
from __future__ import annotations

import torch


def mo_products_dense(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A: (n_orb, n_ao), B: (n_ao, n_e, 5) -> C: (n_orb, n_e, 5)."""
    n_ao, n_e, five = B.shape
    C = A @ B.reshape(n_ao, n_e * five)
    return C.reshape(A.shape[0], n_e, five)


def default_chunk(n_e: int, ensemble: bool = False) -> int:
    """Electron-block size for ``mo_products_sparse``: 64 per walker, 256
    for large ensemble-flattened batches (bounds the gathered-A panel)."""
    return 256 if ensemble and n_e > 512 else 64


def mo_products_sparse(A: torch.Tensor, Bp: torch.Tensor, idx: torch.Tensor,
                       chunk: int = 0) -> torch.Tensor:
    """Sparse product from packed B.

    Args:
      A:   (n_orb, n_ao) dense MO coefficients.
      Bp:  (n_e, K, 5) packed active-AO values (zero padded).
      idx: (n_e, K) active AO indices (padding -> 0; Bp is 0 there).
      chunk: electron-block size bounding the gathered-A working set;
        0 -> ``default_chunk``.

    Returns C: (n_orb, n_e, 5).
    """
    n_e = Bp.shape[0]
    if chunk <= 0:
        chunk = default_chunk(n_e)
    out = []
    for s in range(0, n_e, chunk):
        ix = idx[s:s + chunk]                      # (c, K)
        Ag = A[:, ix]                              # (n_orb, c, K)
        out.append(torch.einsum('oek,ekf->oef', Ag, Bp[s:s + chunk]))
    return torch.cat(out, dim=1)
