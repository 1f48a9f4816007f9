"""Plain PyTorch version of the fused single-electron-move sweep.

Every electron of a sweep is trialed once, at its sweep-start position, so
all proposals, their MO values and the e-n Jastrow deltas are computable up
front (``core.sem._fused_sweeps``).  What stays sequential is the
accept/update algebra of one spin block: the determinant ratio against the
maintained inverse, the e-e Jastrow delta against the current positions,
the Metropolis test, the Sherman–Morrison update and, with a CI expansion,
the shared-table update.  ``fused_sweep_ref`` runs it as a Python loop over
the block's electrons, each move batched over walkers; ``_move_step`` is
the single source of the per-move semantics, which the CUDA kernel of
``csrc/fused_sweep.cu`` computes one walker per thread block.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.multidet_ratio.ref import multidet_ratios_ref


def _pade_u(r, a, b):
    """Padé value u = a r / (1 + b r) (``repro.kernels.fused_sweep.ref.
    _pade_u``)."""
    return a * r / (1.0 + b * r)


def _ee_sum(r, j: int, point, n_up: int, b_ee):
    """sum_{i != j} U_ee(|point - r_i|) over the current configuration
    (``repro.kernels.fused_sweep.ref._ee_sum``): cusp strength 0.25 for
    parallel, 0.5 for anti-parallel spins, the self pair masked out, the
    ``+1e-20``-guarded distance.  r: (W, n_e, 3); point: (W, 3) -> (W,)."""
    n_e = r.shape[-2]
    d = point[:, None, :] - r
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-20)
    i = torch.arange(n_e, device=r.device)
    a = torch.where((i < n_up) == (j < n_up),
                    torch.tensor(0.25, dtype=r.dtype, device=r.device),
                    torch.tensor(0.5, dtype=r.dtype, device=r.device))
    u = _pade_u(dist, a, b_ee)
    keep = (i != j).to(r.dtype)
    return torch.sum(u * keep, dim=-1)


def _move_step(state, e: int, phi_e, rp_e, en_e, logu_e, b_ee, *,
               offset: int, n_up: int, ci_args=None):
    """One electron's Metropolis trial and state update, all walkers
    (``repro.kernels.fused_sweep.ref._move_step``).

    state: (r, minv, sign, logdet, P, rdet); P/rdet are None without CI.
    phi_e: (W, n_cols) proposal MO values (the occupied panel is
    [:, :n_occ]; the full orbital panel with ``ci_args``); rp_e: (W, 3);
    en_e, logu_e: (W,); ci_args: (holes, parts, coeffs, r_other) or None.

    Returns (new_state, accept (W,) bool, margin (W,)) with margin =
    2 (log|ratio| + log_ci + dJ) - log u: the move is accepted iff
    log u < 2 (...), and a margin near 0 marks a near-tie.
    """
    r, minv, sign, logdet, P, rdet = state
    n_occ = minv.shape[-1]
    j = offset + e
    r_old = r[:, j]
    phi = phi_e[:, :n_occ]
    ratio = torch.einsum('wo,wo->w', minv[:, e, :], phi)
    d_jas = (_ee_sum(r, j, rp_e, n_up, b_ee) - _ee_sum(r, j, r_old, n_up, b_ee)
             + en_e)
    log_ratio = torch.log(torch.abs(ratio) + 1e-30)
    if ci_args is not None:
        holes, parts, coeffs, r_other = ci_args
        g_vec = torch.einsum('woh,wh->wo', P, phi) - phi_e
        row_t = minv[:, e, :] / ratio[:, None]
        rdet_new, S_new = multidet_ratios_ref(P, g_vec, row_t, holes, parts,
                                              coeffs, r_other)
        S_old = torch.sum(coeffs * rdet * r_other, dim=-1)
        log_ci = (torch.log(torch.abs(S_new) + 1e-30)
                  - torch.log(torch.abs(S_old) + 1e-30))
        total = 2.0 * (log_ratio + log_ci + d_jas)
    else:
        total = 2.0 * (log_ratio + d_jas)
    accept = logu_e < total
    margin = total - logu_e
    if ci_args is not None:
        # near-reference-node guard (repro.core.sem._sweep_spin_block)
        accept = accept & (torch.abs(ratio) > 1e-20)

    u_vec = torch.einsum('weo,wo->we', minv, phi)
    safe = torch.where(torch.abs(ratio) > 1e-20, ratio,
                       torch.ones_like(ratio))
    row = minv[:, e, :] / safe[:, None]
    upd = minv - u_vec[:, :, None] * row[:, None, :]
    upd[:, e, :] = row
    minv = torch.where(accept[:, None, None], upd, minv)
    r = r.clone()
    r[:, j] = torch.where(accept[:, None], rp_e, r_old)
    logdet = logdet + torch.where(accept, log_ratio,
                                  torch.zeros_like(log_ratio))
    sign = sign * torch.where(accept, torch.sign(ratio),
                              torch.ones_like(ratio))
    if ci_args is not None:
        P = torch.where(accept[:, None, None],
                        P - g_vec[:, :, None] * row[:, None, :], P)
        rdet = torch.where(accept[:, None], rdet_new, rdet)
    return (r, minv, sign, logdet, P, rdet), accept, margin


def fused_sweep_ref(r, minv, sign, logdet, phi, r_prop, en_delta, logu,
                    b_ee, *, offset: int, n_up: int, P=None, rdet=None,
                    ci_args=None):
    """One spin block's whole sweep as a loop over its electrons
    (``repro.kernels.fused_sweep.ref.fused_sweep_ref``).

    r: (W, n_e, 3) current positions of both spin blocks; minv: (W, n, n);
    sign/logdet: (W,); phi: (W, n_blk, n_cols) proposal MO values;
    r_prop: (W, n_blk, 3); en_delta/logu: (W, n_blk); b_ee: () tensor.
    P/rdet + ci_args=(holes, parts, coeffs, r_other): CI state.  The inputs
    are not modified.

    Returns ((r, minv, sign, logdet, P, rdet), accept (W, n_blk) bool,
    margin (W, n_blk)).
    """
    n_blk = r_prop.shape[1]
    state = (r, minv, sign, logdet, P, rdet)
    accs, margins = [], []
    for e in range(n_blk):
        state, acc, mar = _move_step(
            state, e, phi[:, e], r_prop[:, e], en_delta[:, e], logu[:, e],
            b_ee, offset=offset, n_up=n_up, ci_args=ci_args)
        accs.append(acc)
        margins.append(mar)
    return state, torch.stack(accs, dim=1), torch.stack(margins, dim=1)
