"""Single-electron-move VMC: Sherman–Morrison-updated Slater inverses.

Port of ``repro.core.sem`` (single determinant, unscreened, fp32 storage).
One ``propagate`` call is one sweep: every electron gets one Metropolis
trial, batched over the walker ensemble.  The determinant ratio of a move
is one dot product against the maintained inverse; an accepted move is a
rank-1 update of the (W, n, n) inverses — the CUDA kernel of
``kernels.sem_update`` when ``cfg.method == 'kernel'``.  Per move only the
AO values at the proposed points are evaluated, plus an O(n_e) Jastrow
delta.  After the sweep one full MO tensor pass assembles the local energy
through the maintained inverses, with a Newton–Schulz corrector every sweep
and a full ``slogdet``/inverse refresh every ``cfg.sem_refresh`` sweeps
(DESIGN.md §6) — a host ``if`` on the sweep counter, in place of the
reference's ``lax.cond``.

The sweep clones its inverses once, so ``propagate`` never modifies the
state it is given although the kernel updates in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import aos, slater
from .driver import (BlockStats as DriverStats, Population, register_method,
                     restart_ensemble)
from .hamiltonian import potential_energy
from .jastrow import jastrow_delta_one_electron, jastrow_state
from .vmc import evaluate_ensemble, sample_positions
from .wavefunction import (WavefunctionConfig, WavefunctionParams,
                           _mo_tensor_ensemble, _slater_blocks)


class SEMEnsemble(NamedTuple):
    """Walker-major single-electron-move state."""

    r: torch.Tensor          # (W, n_e, 3)
    minv_up: torch.Tensor    # (W, n_up, n_up) running inverse (elec, orb)
    minv_dn: torch.Tensor    # (W, n_dn, n_dn)
    sign: torch.Tensor       # (W,) running sign of Det_up * Det_dn
    logdet: torch.Tensor     # (W,) running sum of log|det| over spins
    log_psi: torch.Tensor    # (W,) logdet + J
    e_loc: torch.Tensor      # (W,)


class SEMState(NamedTuple):
    """Driver state: walker ensemble + host sweep counter."""

    ens: SEMEnsemble
    sweeps: int              # sweeps since the last full refresh


def _mo_blocks(cfg: WavefunctionConfig, params: WavefunctionParams):
    """Per-spin MO coefficient panels (rows of the shared 'A' matrix)."""
    return params.mo[:cfg.n_up], params.mo[:cfg.n_dn]


def _apply_update(cfg, minv, u_vec, row, accept, e):
    """Batched SM update: the CUDA kernel when cfg.method == 'kernel'."""
    if cfg.method == 'kernel':
        from repro_torch.kernels.sem_update.ops import sem_rank1_update
        return sem_rank1_update(minv, u_vec, row, accept, e)
    from repro_torch.kernels.sem_update.ref import sem_update_ref
    return sem_update_ref(minv, u_vec, row, accept, e)


def _energy_ensemble(cfg: WavefunctionConfig, params: WavefunctionParams,
                     R, Cw, minv_up, minv_dn, sign, logdet) -> SEMEnsemble:
    """Assemble the SEM ensemble from maintained inverses (no inversion)."""
    up, dn = _slater_blocks(cfg, Cw)
    gu, qu = slater.ratios_from_inverse(up, minv_up)
    if cfg.n_dn > 0:
        gd, qd = slater.ratios_from_inverse(dn, minv_dn)
        sgrad = torch.cat([gu, gd], dim=1)
        slap = torch.cat([qu, qd], dim=1)
    else:
        sgrad, slap = gu, qu
    jas = jastrow_state(params.jastrow, R, params.coords, params.charges,
                        cfg.n_up)
    lap_ratio = (slap + jas.lap + torch.sum(jas.grad * jas.grad, dim=-1)
                 + 2.0 * torch.sum(jas.grad * sgrad, dim=-1))
    e_kin = -0.5 * torch.sum(lap_ratio, dim=-1)
    e_pot = potential_energy(R, params.coords, params.charges)
    return SEMEnsemble(r=R, minv_up=minv_up, minv_dn=minv_dn, sign=sign,
                       logdet=logdet, log_psi=logdet + jas.value,
                       e_loc=e_kin + e_pot)


def _fresh_inverses(cfg: WavefunctionConfig, up, dn):
    """Batched ``slogdet`` + inverse (+ Newton–Schulz) of both spin blocks
    -> (minv_up, minv_dn, sign, logdet)."""
    su, lu, _, _, mu = slater._spin_block_batched(up, cfg.ns_steps)
    if cfg.n_dn == 0:
        return mu, up.new_zeros((up.shape[0], 0, 0)), su, lu
    sd, ld, _, _, md = slater._spin_block_batched(dn, cfg.ns_steps)
    return mu, md, su * sd, lu + ld


def evaluate_sem(cfg: WavefunctionConfig, params: WavefunctionParams,
                 R: torch.Tensor) -> SEMEnsemble:
    """Full recompute of the SEM state for a walker batch R: (W, n_e, 3):
    fresh inverses of both spin blocks, then the shared energy assembly."""
    Cw, _ = _mo_tensor_ensemble(cfg, params, R)
    up, dn = _slater_blocks(cfg, Cw)
    return _energy_ensemble(cfg, params, R, Cw,
                            *_fresh_inverses(cfg, up, dn))


def draw_sweep(gen: torch.Generator, r: torch.Tensor):
    """One sweep's draws: eta (W, n_e, 3) proposal normals and u (W, n_e)
    uniforms; electron j's move reads eta[:, j] and u[:, j]."""
    eta = torch.randn(r.shape, generator=gen, dtype=r.dtype, device=r.device)
    u = torch.rand(r.shape[:2], generator=gen, dtype=r.dtype,
                   device=r.device)
    return eta, u


def _sweep_spin_block(cfg, params, A_blk, offset, n_blk, draws, step_size,
                      carry):
    """One Metropolis trial per electron of one spin block, all walkers.

    ``carry`` is ``(r, minv, sign, logdet)`` with ``minv`` the running
    inverse of THIS spin block (updated in place on the card); electrons
    ``offset .. offset+n_blk-1`` go in order, so a later electron sees the
    earlier accepted moves of the same sweep.  Returns the updated carry,
    the (n_blk, W) accept decisions and their (n_blk, W) margins
    ``2 (log|ratio| + dJ) - log u`` (accept iff > 0), on the device.
    """
    coords, charges = params.coords, params.charges
    eta_all, u_all = draws
    r, minv, sign, logdet = carry
    accs, margins = [], []
    for e in range(n_blk):
        j = offset + e
        r_old = r[:, j]                                   # (W, 3)
        r_new = r_old + step_size * eta_all[:, j]
        vals, _ = aos.eval_ao_values(cfg.basis_t, coords, r_new)  # (ao, W)
        phi = (A_blk @ vals).T                            # (W, n_blk)
        m_e = minv[:, e, :]
        ratio = torch.sum(m_e * phi, dim=-1)
        d_jas = jastrow_delta_one_electron(params.jastrow, r, j, r_new,
                                           coords, charges, cfg.n_up)
        log_ratio = torch.log(torch.abs(ratio) + 1e-30)
        margin = (2.0 * (log_ratio + d_jas)
                  - torch.log(torch.clamp(u_all[:, j], min=1e-38)))
        accept = margin > 0
        u_vec = torch.bmm(minv, phi[:, :, None])[..., 0]  # (W, n_blk)
        safe = torch.where(torch.abs(ratio) > 1e-20, ratio,
                           torch.ones_like(ratio))
        row = m_e / safe[:, None]
        minv = _apply_update(cfg, minv, u_vec, row, accept, e)
        r[:, j] = torch.where(accept[:, None], r_new, r_old)
        logdet = logdet + torch.where(accept, log_ratio,
                                      torch.zeros_like(log_ratio))
        sign = sign * torch.where(accept, torch.sign(ratio),
                                  torch.ones_like(ratio))
        accs.append(accept)
        margins.append(margin)
    return (r, minv, sign, logdet), torch.stack(accs), torch.stack(margins)


class SEMVMCPropagator:
    """Metropolis sampling of |Psi_T|^2 by single-electron sweeps (§II.A).

    Same |Psi_T|^2 target as ``VMCPropagator`` (statistics agree in
    distribution, not move for move), at O(n^2) per electron move.
    """

    aux_fields = ('accept', 'ao_fill', 'e_kin', 'e_pot')

    def __init__(self, cfg: WavefunctionConfig, step_size: float = 0.3,
                 spread: float = 1.5):
        """``step_size`` is the isotropic Gaussian proposal width (bohr)."""
        self.cfg = cfg
        self.step_size = float(step_size)
        self.spread = float(spread)

    def init(self, params, gen, n_walkers: int, walkers=None):
        """Cold start (sampled positions) or reservoir restart."""
        if walkers is not None:
            ens = restart_ensemble(
                walkers, n_walkers,
                lambda r: evaluate_sem(self.cfg, params, r),
                params.coords.device)
        else:
            r = sample_positions(params, gen, n_walkers, self.cfg.n_elec,
                                 self.spread)
            ens = evaluate_sem(self.cfg, params, r)
        return SEMState(ens=ens, sweeps=0)

    def sweep(self, params, state: SEMState, gen, draws=None):
        """The electron moves of one sweep, no energy pass.

        Returns (r, minv_up, minv_dn, sign, logdet, accept (n_e, W),
        margin (n_e, W)) — see ``_sweep_spin_block``."""
        cfg = self.cfg
        ens = state.ens
        if draws is None:
            draws = draw_sweep(gen, ens.r)
        A_up, A_dn = _mo_blocks(cfg, params)
        # the sweep's own buffers: the kernel updates minv in place
        carry = (ens.r.clone(), ens.minv_up.clone(), ens.sign, ens.logdet)
        (r, minv_up, sign, logdet), acc, mar = _sweep_spin_block(
            cfg, params, A_up, 0, cfg.n_up, draws, self.step_size, carry)
        minv_dn = ens.minv_dn
        if cfg.n_dn > 0:
            carry = (r, ens.minv_dn.clone(), sign, logdet)
            (r, minv_dn, sign, logdet), acc_dn, mar_dn = _sweep_spin_block(
                cfg, params, A_dn, cfg.n_up, cfg.n_dn, draws,
                self.step_size, carry)
            acc, mar = torch.cat([acc, acc_dn]), torch.cat([mar, mar_dn])
        return r, minv_up, minv_dn, sign, logdet, acc, mar

    def propagate(self, params, state: SEMState, gen, pop: Population,
                  draws=None):
        """One sweep: n_e single-electron trials + energy + drift control.

        ``draws = (eta (W, n_e, 3), u (W, n_e))`` injects the sweep's
        random numbers (else drawn from ``gen``)."""
        cfg = self.cfg
        r, minv_up, minv_dn, sign, logdet, accept, _ = self.sweep(
            params, state, gen, draws)
        # one full MO tensor pass: the energy needs it, and its D blocks
        # feed the corrector/refresh that bound fp32 drift
        Cw, _ = _mo_tensor_ensemble(cfg, params, r)
        up, dn = _slater_blocks(cfg, Cw)
        sweeps = state.sweeps + 1
        if sweeps % cfg.sem_refresh == 0:
            minv_up, minv_dn, sign, logdet = _fresh_inverses(cfg, up, dn)
        else:
            minv_up = slater.refine_inverse(up[..., 0], minv_up)
            if cfg.n_dn > 0:
                minv_dn = slater.refine_inverse(dn[..., 0], minv_dn)
        ens_new = _energy_ensemble(cfg, params, r, Cw, minv_up, minv_dn,
                                   sign, logdet)
        out = (pop.mean(ens_new.e_loc), pop.mean(ens_new.e_loc ** 2),
               torch.mean(accept.to(torch.float32)))
        return SEMState(ens=ens_new, sweeps=sweeps % cfg.sem_refresh), out

    def block_stats(self, params, state: SEMState, outs,
                    pop: Population) -> DriverStats:
        """Reduce per-sweep outputs; sparsity/energy split from the final
        configuration (same convention as the all-electron VMC)."""
        e, e2, acc = outs
        ens = state.ens
        _, st = evaluate_ensemble(self.cfg, params, ens.r)
        w = float(e.shape[0] * pop.size(ens.r))
        return DriverStats(
            weight=w, e_mean=torch.mean(e), e2_mean=torch.mean(e2),
            aux=dict(accept=torch.mean(acc),
                     ao_fill=pop.mean(st.ao_count.to(torch.float32)),
                     e_kin=pop.mean(st.e_kin), e_pot=pop.mean(st.e_pot)))


# for sem-vmc the step size is a per-electron Gaussian proposal width,
# not a drift-diffusion time step
register_method('sem-vmc',
                lambda cfg, tau: SEMVMCPropagator(cfg, step_size=tau),
                default_tau=0.3)
