"""MO matrix products C_i = A @ B_i, i=1..5 (paper §III — the hot spot).

Port of ``repro.core.mos``.  All implementations return
``C: (n_orb, n_elec, 5)``:

* ``mo_products_dense``  — one dense matmul against the stacked B;
* ``mo_products_sparse`` — the paper's algorithm: per-electron gather of
  the active columns of A (A stays dense) against the packed B rows;
* ``mo_products_screened`` — active MOs x active AOs per electron (the
  distance-screened pipeline with MO support screening on).

The CUDA kernels behind ``kernels.sparse_mo.ops.sparse_mo_rows`` (the AO
pass's dense rows) and ``kernels.screened_mo.ops.screened_mo_products``
(packed B) compute the same product on the card.
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


def mo_products_screened(A: torch.Tensor, Bp: torch.Tensor, idx: torch.Tensor,
                         mo_idx: torch.Tensor, mo_valid: torch.Tensor,
                         chunk: int = 0) -> torch.Tensor:
    """Doubly screened product: active MOs x active AOs per electron
    (``repro.core.mos.mo_products_screened``).

    Per electron only its active-MO rows are computed, each as a
    contraction over its candidate AO columns — a double-gathered
    (chunk, K_mo, K_ao) panel of A against the packed B rows, electron
    chunk by electron chunk — then the active panel is scattered into the
    dense C.  Rows outside an electron's MO reach are exact zeros of the
    dense product (``screening.build_screening`` derives the reach from
    A's support), so this adds no error beyond the AO tolerance.

    Args:
      A:   (n_rows, n_ao) dense MO coefficients.
      Bp:  (n_e, K_ao, 5) packed active-AO values (zeros at padding).
      idx: (n_e, K_ao) candidate AO ids.
      mo_idx / mo_valid: (n_e, K_mo) active-MO lists
        (``screening.active_mo_lists``).
      chunk: electron-block size; 0 -> ``default_chunk``.

    Returns C: (n_rows, n_e, 5).
    """
    n_rows = A.shape[0]
    n_e = Bp.shape[0]
    if chunk <= 0:
        chunk = default_chunk(n_e)
    mi = torch.where(mo_valid, mo_idx, torch.zeros_like(mo_idx)).long()
    ai = idx.long()
    parts = []
    for s in range(0, n_e, chunk):
        m, ix = mi[s:s + chunk], ai[s:s + chunk]
        Asub = A[m[:, :, None], ix[:, None, :]]     # (c, K_mo, K_ao)
        c = torch.einsum('emk,ekf->emf', Asub, Bp[s:s + chunk])
        parts.append(torch.where(mo_valid[s:s + chunk, :, None], c,
                                 torch.zeros_like(c)))
    Cp = torch.cat(parts, dim=0)                   # (n_e, K_mo, 5)
    C = torch.zeros((n_rows, n_e, 5), dtype=Cp.dtype, device=Cp.device)
    e = torch.arange(n_e, device=Cp.device)[:, None].expand_as(mi)
    return C.index_put_((mi, e), Cp, accumulate=True)
