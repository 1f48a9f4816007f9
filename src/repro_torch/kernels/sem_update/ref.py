"""Plain PyTorch versions of the batched Sherman–Morrison update and of one
whole move of the per-move sweep."""
from __future__ import annotations

import torch

from repro_torch.kernels.multidet_ratio.ref import multidet_ratios_ref


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


def sem_move_ref(state, v_all: torch.Tensor, r_new: torch.Tensor,
                 d_jas: torch.Tensor, logu: torch.Tensor, e: int, j: int,
                 ci=None):
    """One electron's Metropolis trial and state update, all walkers, after
    its proposal values and Jastrow delta (the move of
    ``repro.core.sem._sweep_spin_block`` after phi and dJ; the plain
    version of ``csrc/sem_move.cu``).

    state: (r (W, n_e, 3), minv (W, n, n), sign (W,), logdet (W,), P, rdet),
    P (W, n_orb, n) and rdet (W, n_det) None without CI; v_all: (W, n_cols)
    the proposal's orbital values (phi = v_all[:, :n]; all n_orb orbitals
    with CI); r_new: (W, 3) the proposed position of electron j (block row
    e); d_jas, logu: (W,); ci: (r_other (W, n_det), holes, parts, coeffs)
    or None.

    Returns (new_state, accept (W,) bool, margin (W,)) with margin =
    2 (log|ratio| + log_ci + dJ) - log u (accept iff > 0).  ``r`` is
    updated in place at electron j; minv, sign, logdet, P and rdet come
    back as new tensors.
    """
    r, minv, sign, logdet, P, rdet = state
    n_occ = minv.shape[-1]
    phi = v_all[:, :n_occ]
    m_e = minv[:, e, :]
    ratio = torch.sum(m_e * phi, dim=-1)
    log_ratio = torch.log(torch.abs(ratio) + 1e-30)
    if ci is not None:
        r_other, holes, parts, coeffs = ci
        # CI factor from the rank-1-updated table (un-guarded 1/ratio: a
        # near-node reference move makes the comparison NaN, rejected)
        g_vec = torch.einsum('woh,wh->wo', P, phi) - v_all
        row_t = m_e / ratio[:, None]
        rdet_new, S_new = multidet_ratios_ref(P, g_vec, row_t, holes, parts,
                                              coeffs, r_other)
        S_old = torch.sum(coeffs * rdet * r_other, dim=-1)
        log_ci = (torch.log(torch.abs(S_new) + 1e-30)
                  - torch.log(torch.abs(S_old) + 1e-30))
        margin = 2.0 * (log_ratio + log_ci + d_jas) - logu
        # near-REFERENCE-node guard (sem.py:355-363): the CI factor can
        # cancel the log barrier where only the reference is singular
        accept = (margin > 0) & (torch.abs(ratio) > 1e-20)
    else:
        margin = 2.0 * (log_ratio + d_jas) - logu
        accept = margin > 0
    u_vec = torch.bmm(minv, phi[:, :, None])[..., 0]      # (W, n)
    safe = torch.where(torch.abs(ratio) > 1e-20, ratio,
                       torch.ones_like(ratio))
    row = m_e / safe[:, None]
    minv = sem_update_ref(minv, u_vec, row, accept, e)
    r[:, j] = torch.where(accept[:, None], r_new, r[:, j])
    logdet = logdet + torch.where(accept, log_ratio,
                                  torch.zeros_like(log_ratio))
    sign = sign * torch.where(accept, torch.sign(ratio),
                              torch.ones_like(ratio))
    if ci is not None:
        P = torch.where(accept[:, None, None],
                        P - g_vec[:, :, None] * row[:, None, :], P)
        rdet = torch.where(accept[:, None], rdet_new, rdet)
    return (r, minv, sign, logdet, P, rdet), accept, margin
