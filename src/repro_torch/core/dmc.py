"""Fixed-node DMC with constant-walker-count stochastic reconfiguration.

Port of ``repro.core.dmc``.  Per generation (paper §II):
  1. drift-diffusion move (eq. 1) with Metropolis accept/reject on |Psi|^2 G
     (Umrigar '93) — removes most time-step error;
  2. fixed-node constraint: moves that flip sign(Psi_T) are rejected
     (nodes act as infinite barriers);
  3. branching weight w = exp(-tau_eff/2 [(E_L(R')-E_T) + (E_L(R)-E_T)])
     (eq. 3);
  4. reconfiguration (reconfig.py) keeps the population size constant;
     the population-mean weight enters the trailing global weight
     Pi_t = prod_{s in window} w_bar_s, which weights the energy estimator
     (removes the finite-population bias, ref. [17]).

The method is ``DMCPropagator`` (init / propagate / block_stats /
feedback); the block loop is the generic ``driver.EnsembleDriver``.  A
generation stays on the device: E_T, the weight history and every per-step
output are device tensors, and the block's one host sync is
``EnsembleDriver.run_block``'s.

Random numbers: ``propagate`` draws ``(eta, u_metropolis, u_reconfig)``
from the generator, or takes them injected as ``draws`` (a test feeds the
reference's threefry draws and demands the same accept, crossing and
reconfiguration decisions).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .driver import (BlockStats as DriverStats, EnsembleDriver, Population,
                     merge_accepted, register_method, restart_ensemble)
from .reconfig import global_weight_update, reconfigure
from .vmc import (VMCPropagator, WalkerEnsemble, draw_diffusion,
                  evaluate_ensemble, init_walkers, propose_diffusion)
from .wavefunction import WavefunctionConfig


class DMCState(NamedTuple):
    """Driver state: walker ensemble + E_T / weight history (device)."""

    ens: WalkerEnsemble
    log_w_hist: torch.Tensor   # (window,) trailing log population weights
    e_trial: torch.Tensor      # () fp32 E_T reference energy


def draw_dmc(gen: torch.Generator, r: torch.Tensor):
    """One generation's draws: eta (W, n_e, 3) normals, u (W,) Metropolis
    uniforms, and the reconfiguration comb's one uniform (0-d)."""
    eta, u = draw_diffusion(gen, r)
    u_r = torch.rand((), generator=gen, dtype=r.dtype, device=r.device)
    return eta, u, u_r


class DMCPropagator:
    """Fixed-node DMC as a driver plug-in.

    ``feedback`` is the single E_T damping knob: every between-block E_T
    update (runtime feedback included) routes through ``update_e_trial``.
    Cold starts are VMC-equilibrated through a nested driver on the same
    generator; restarts re-evaluate reservoir walkers via
    ``restart_ensemble``.
    """

    aux_fields = ('accept', 'pop_weight', 'sign_flips')

    def __init__(self, cfg: WavefunctionConfig, e_trial: float,
                 tau: float = 0.02, window: int = 20, damping: float = 0.5,
                 equil_steps: int = 0, vmc_tau: float = 0.3):
        self.cfg, self.tau = cfg, float(tau)
        self.e_trial0 = float(e_trial)
        self.window, self.damping = int(window), float(damping)
        self.equil_steps, self.vmc_tau = int(equil_steps), float(vmc_tau)

    def init(self, params, gen, n_walkers: int, walkers=None):
        """Cold start (VMC-equilibrated) or reservoir restart."""
        if walkers is not None:
            ens = restart_ensemble(
                walkers, n_walkers,
                lambda r: evaluate_ensemble(self.cfg, params, r)[0],
                params.coords.device)
        else:
            ens = init_walkers(self.cfg, params, gen, n_walkers)
            if self.equil_steps:
                vmc = EnsembleDriver(VMCPropagator(self.cfg, self.vmc_tau),
                                     self.equil_steps)
                ens, _ = vmc.run_block(params, ens, gen)
        return init_dmc(ens, e_trial=self.e_trial0, window=self.window)

    def draw(self, gen, state: DMCState):
        """One generation's draws for the whole population: (eta, u,
        u_reconfig), the last 0-d (one comb for every walker)."""
        return draw_dmc(gen, state.ens.r)

    def propagate(self, params, state: DMCState, gen, pop: Population,
                  draws=None):
        """One DMC generation: move, branch weights, reconfigure.

        ``draws = (eta, u, u_reconfig)`` injects the random numbers (else
        drawn from ``gen``).  Returns (state, (mean E_L of the moved
        ensemble, global weight, accept fraction, crossed fraction, mean
        weight)), all 0-d device tensors.
        """
        ens = state.ens
        eta, u, u_r = draws if draws is not None else self.draw(gen, state)
        new, log_ratio, u = propose_diffusion(self.cfg, params, ens, gen,
                                              pop, self.tau, (eta, u))
        crossed = new.sign * ens.sign < 0      # fixed-node: reject crossings
        accept = (torch.log(u) < log_ratio) & ~crossed
        moved = merge_accepted(new, ens, accept)

        # effective time step compensates rejected moves (Umrigar '93)
        acc_frac = pop.mean(accept)
        tau_eff = self.tau * torch.clamp(acc_frac, min=1e-3)
        w = torch.exp(-0.5 * tau_eff *
                      (moved.e_loc + ens.e_loc - 2.0 * state.e_trial))
        w = torch.clamp(w, 0.0, 4.0)           # guard rare E_L spikes

        # global reconfiguration over the merged ensemble
        ens_next = reconfigure_ensemble(moved, w, u_r, pop)
        mean_w = pop.mean(w)
        log_hist, g_weight = global_weight_update(state.log_w_hist, mean_w)
        out = (pop.mean(moved.e_loc), g_weight, acc_frac,
               pop.mean(crossed), mean_w)
        return DMCState(ens=ens_next, log_w_hist=log_hist,
                        e_trial=state.e_trial), out

    def block_stats(self, params, state: DMCState, outs,
                    pop: Population) -> DriverStats:
        """Global-weight-weighted mixed estimator over the block."""
        e, gw, acc, cross, w = outs            # (steps,) device scalars
        wsum = torch.sum(gw)
        return DriverStats(
            weight=wsum,
            e_mean=torch.sum(gw * e) / wsum,
            e2_mean=torch.sum(gw * e ** 2) / wsum,
            aux=dict(accept=torch.mean(acc), pop_weight=torch.mean(w),
                     sign_flips=torch.mean(cross)))

    def feedback(self, state: DMCState, e_estimate) -> DMCState:
        """Between-block E_T update (routed through ``update_e_trial``)."""
        return update_e_trial(state, e_estimate, damping=self.damping)


def reconfigure_ensemble(moved: WalkerEnsemble, w: torch.Tensor,
                         u_r: torch.Tensor, pop: Population
                         ) -> WalkerEnsemble:
    """Global reconfiguration over the merged ensemble: the comb over the
    gathered weights, then every ``WalkerEnsemble`` field gathered at the
    surviving indices (this device's slice of them).  Sharded, the weights
    and the fields travel in one exchange."""
    w_all, *fields = pop.gather((w, *moved))
    idx = reconfigure(w_all, u_r)
    moved_all = WalkerEnsemble(*fields)
    idx_local = pop.take_local(idx, moved.r.shape[0])
    return WalkerEnsemble(*[a[idx_local] for a in moved_all])


def init_dmc(ens: WalkerEnsemble, e_trial: float,
             window: int = 20) -> DMCState:
    """DMC state around an equilibrated ensemble (unit weight history)."""
    dev = ens.r.device
    return DMCState(ens=ens,
                    log_w_hist=torch.zeros((window,), dtype=torch.float32,
                                           device=dev),
                    e_trial=torch.tensor(float(e_trial), dtype=torch.float32,
                                         device=dev))


def update_e_trial(state: DMCState, e_estimate, damping: float = 0.5):
    """Between-block E_T feedback (population control is already exact;
    this just keeps weights O(1)).  The one damping knob — every E_T
    update path (including runtime feedback) goes through here."""
    et = (1 - damping) * state.e_trial + damping * e_estimate
    return state._replace(e_trial=torch.as_tensor(
        et, dtype=torch.float32, device=state.e_trial.device))


def dmc_step(cfg, params, state: DMCState, gen, tau, draws=None):
    """One DMC generation (single device)."""
    prop = DMCPropagator(cfg, e_trial=0.0, tau=tau)
    return prop.propagate(params, state, gen, Population(), draws)


def _from_spec(cfg, tau, e_trial, equil_steps):
    """RunSpec factory: default E_T is the crude -0.5 Ha/electron guess."""
    e0 = e_trial if e_trial is not None else -0.5 * cfg.n_elec
    return DMCPropagator(cfg, e_trial=e0, tau=tau,
                         equil_steps=equil_steps)


register_method('dmc', _from_spec, default_tau=0.02)
