"""Variational Monte Carlo: all-electron drift-diffusion Metropolis sampling.

Port of ``repro.core.vmc``.  The method lives in ``VMCPropagator``; the
block loop is the generic ``driver.EnsembleDriver``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .driver import (BlockStats as DriverStats, Population, merge_accepted,
                     register_method, restart_ensemble)
from .wavefunction import (WavefunctionConfig, WavefunctionParams,
                           psi_state_batched)


class WalkerEnsemble(NamedTuple):
    """Walker-major all-electron ensemble."""

    r: torch.Tensor          # (W, n_e, 3)
    log_psi: torch.Tensor    # (W,)
    sign: torch.Tensor       # (W,)
    drift: torch.Tensor      # (W, n_e, 3)
    e_loc: torch.Tensor      # (W,)


def evaluate_ensemble(cfg, params, r):
    """Evaluate a walker batch r: (W, n_e, 3) -> (WalkerEnsemble, PsiState).

    Shared by every propagator: one ensemble pass (``psi_state_batched``).
    """
    st = psi_state_batched(cfg, params, r)
    return WalkerEnsemble(r=r, log_psi=st.log_psi, sign=st.sign,
                          drift=st.drift, e_loc=st.e_loc), st


def sample_positions(params: WavefunctionParams, gen: torch.Generator,
                     n_walkers: int, n_e: int,
                     spread: float = 1.5) -> torch.Tensor:
    """Electrons scattered around (charge-weighted) random nuclei.

    The cold-start distribution shared by every propagator.  Returns
    (n_walkers, n_e, 3) on the parameters' device.
    """
    probs = params.charges / torch.sum(params.charges)
    at = torch.multinomial(probs, n_walkers * n_e, replacement=True,
                           generator=gen).reshape(n_walkers, n_e)
    centers = params.coords[at]
    return centers + spread * torch.randn(
        (n_walkers, n_e, 3), generator=gen, dtype=params.coords.dtype,
        device=params.coords.device)


def init_walkers(cfg: WavefunctionConfig, params: WavefunctionParams,
                 gen: torch.Generator, n_walkers: int,
                 spread: float = 1.5) -> WalkerEnsemble:
    """Cold-start ensemble: sampled positions, fully evaluated."""
    r = sample_positions(params, gen, n_walkers, cfg.n_elec, spread)
    return evaluate_ensemble(cfg, params, r)[0]


def _log_green(r_to, r_from, drift_from, tau):
    """log G(r_to <- r_from) for the drift-diffusion proposal."""
    d = r_to - r_from - tau * drift_from
    return -torch.sum(d * d, dim=(-1, -2)) / (2.0 * tau)


def draw_diffusion(gen: torch.Generator, r: torch.Tensor):
    """One generation's draws: eta (W, n_e, 3) normals, u (W,) uniforms."""
    eta = torch.randn(r.shape, generator=gen, dtype=r.dtype, device=r.device)
    u = torch.rand((r.shape[0],), generator=gen, dtype=r.dtype,
                   device=r.device)
    return eta, u


def propose_diffusion(cfg, params, ens: WalkerEnsemble, gen, pop: Population,
                      tau, draws=None):
    """Drift-diffusion proposal (paper eq. 1).

    ``draws = (eta, u)`` injects the random numbers (else drawn from
    ``gen``).  Returns (proposed ensemble, Metropolis log-ratio, u).
    """
    eta, u = draws if draws is not None else draw_diffusion(gen, ens.r)
    r_new = ens.r + tau * ens.drift + tau ** 0.5 * eta
    new, _ = evaluate_ensemble(cfg, params, r_new)
    log_ratio = (2.0 * (new.log_psi - ens.log_psi)
                 + _log_green(ens.r, r_new, new.drift, tau)
                 - _log_green(r_new, ens.r, ens.drift, tau))
    return new, log_ratio, u


class VMCPropagator:
    """Metropolis sampling of |Psi_T|^2 as a driver plug-in (§II.A)."""

    aux_fields = ('accept', 'ao_fill', 'e_kin', 'e_pot')

    def __init__(self, cfg: WavefunctionConfig, tau: float = 0.3,
                 spread: float = 1.5):
        self.cfg, self.tau, self.spread = cfg, float(tau), float(spread)

    def init(self, params, gen, n_walkers: int, walkers=None):
        """Cold start (sampled positions) or reservoir restart."""
        if walkers is not None:
            return restart_ensemble(
                walkers, n_walkers,
                lambda r: evaluate_ensemble(self.cfg, params, r)[0],
                params.coords.device)
        return init_walkers(self.cfg, params, gen, n_walkers, self.spread)

    def draw(self, gen, ens: WalkerEnsemble):
        """One generation's draws for the whole population: (eta, u)."""
        return draw_diffusion(gen, ens.r)

    def propagate(self, params, ens: WalkerEnsemble, gen, pop: Population,
                  draws=None):
        """One all-electron drift-diffusion Metropolis generation."""
        merged, accept = self.step(params, ens, gen, pop, draws)
        out = (pop.mean(merged.e_loc), pop.mean(merged.e_loc ** 2),
               pop.mean(accept))
        return merged, out

    def step(self, params, ens: WalkerEnsemble, gen, pop: Population,
             draws=None):
        """One generation -> (merged ensemble, per-walker accept mask)."""
        if draws is None:
            draws = self.draw(gen, ens)
        new, log_ratio, u = propose_diffusion(self.cfg, params, ens, gen,
                                              pop, self.tau, draws)
        accept = torch.log(u) < log_ratio
        return merge_accepted(new, ens, accept), accept

    def block_stats(self, params, ens: WalkerEnsemble, outs,
                    pop: Population) -> DriverStats:
        """Reduce the stacked per-step outputs into one BlockStats."""
        e, e2, acc = outs
        _, st = evaluate_ensemble(self.cfg, params, ens.r)
        w = float(e.shape[0] * pop.size(ens.r))
        return DriverStats(
            weight=w, e_mean=torch.mean(e), e2_mean=torch.mean(e2),
            aux=dict(accept=torch.mean(acc),
                     ao_fill=pop.mean(st.ao_count.to(torch.float32)),
                     e_kin=pop.mean(st.e_kin), e_pot=pop.mean(st.e_pot)))


def vmc_step(cfg, params, ens: WalkerEnsemble, gen, tau, draws=None):
    """One Metropolis generation (single device) -> (ensemble, per-walker
    accept mask); ``draws = (eta, u)`` injects the random numbers."""
    return VMCPropagator(cfg, tau=tau).step(params, ens, gen, Population(),
                                            draws)


register_method('vmc',
                lambda cfg, tau, e_trial, equil_steps:
                VMCPropagator(cfg, tau=tau),
                default_tau=0.3)
