"""``opt-vmc``: VMC sampling + per-step moment accumulation for SR / LM.

Port of ``repro.optimize.propagator``.  ``OptVMCPropagator`` is the
all-electron Metropolis propagator (``core.vmc.VMCPropagator``) plus, each
generation, the population means

    O        (P,)    ∂ ln|Ψ| / ∂ p_i per walker, population-averaged
    O E_L    (P,)
    O Oᵀ     (P, P)
    O Oᵀ E_L (P, P)   (the extra moment the linear method needs)

reduced with ``Population.mean0``.  O comes from
``estimators.o_batched`` at the merged positions.  ``block_stats``
averages the per-step means over the block and returns them as
array-valued aux entries; ``EnsembleDriver.run_block`` brings them to the
host in the block's one transfer and ``runtime.blocks.BlockAccumulator
.from_stats`` flattens them into indexed scalar keys (``opt_o/3``,
``opt_oo/1/2``), so the moments ride the weighted-mean merge rule through
worker merge, wire encoding and database storage.  Both SR and the linear
method consume the same four moments.  The propagator holds no closure,
so it pickles as it is for the ``process`` backend.
"""
from __future__ import annotations

import torch

from repro_torch.core.driver import (BlockStats as DriverStats, Population,
                                     register_method)
from repro_torch.core.vmc import VMCPropagator, evaluate_ensemble
from repro_torch.optimize.estimators import n_params, o_batched


class OptVMCPropagator(VMCPropagator):
    """VMC sampling with SR/linear-method moment estimators (§II.A + SR)."""

    aux_fields = VMCPropagator.aux_fields + ('opt_o', 'opt_eo', 'opt_oo',
                                             'opt_oeo')

    def __init__(self, cfg, tau: float = 0.3, spread: float = 1.5):
        super().__init__(cfg, tau=tau, spread=spread)
        self.n_opt = n_params(cfg)

    def reevaluate(self, params, ens):
        """The ensemble at its positions under ``params`` (log|Psi|, sign,
        drift, E_L): ``BlockSampler`` calls it once after a parameter
        broadcast, before the first generation under the new version."""
        return evaluate_ensemble(self.cfg, params, ens.r)[0]

    def propagate(self, params, ens, gen, pop: Population, draws=None):
        """One Metropolis generation + the four optimization moments.

        ``draws = (eta, u)`` injects the random numbers, as
        ``VMCPropagator.propagate`` takes them."""
        merged, accept = self.step(params, ens, gen, pop, draws)
        O = o_batched(self.cfg, params, merged.r)            # (W, P)
        e = merged.e_loc
        OO = O[:, :, None] * O[:, None, :]                   # (W, P, P)
        out = (pop.mean(e), pop.mean(e * e), pop.mean(accept),
               pop.mean0(O), pop.mean0(O * e[:, None]),
               pop.mean0(OO), pop.mean0(OO * e[:, None, None]))
        return merged, out

    def block_stats(self, params, ens, outs, pop: Population) -> DriverStats:
        """Reduce per-step outputs; moments land as array aux entries."""
        e, e2, acc, o, eo, oo, oeo = outs      # leading axis: (steps,)
        _, st = evaluate_ensemble(self.cfg, params, ens.r)
        w = float(e.shape[0] * pop.size(ens.r))
        return DriverStats(
            weight=w, e_mean=torch.mean(e), e2_mean=torch.mean(e2),
            aux=dict(accept=torch.mean(acc),
                     ao_fill=pop.mean(st.ao_count.to(torch.float32)),
                     e_kin=pop.mean(st.e_kin), e_pot=pop.mean(st.e_pot),
                     opt_o=torch.mean(o, dim=0),
                     opt_eo=torch.mean(eo, dim=0),
                     opt_oo=torch.mean(oo, dim=0),
                     opt_oeo=torch.mean(oeo, dim=0)))


register_method('opt-vmc',
                lambda cfg, tau, e_trial, equil_steps:
                OptVMCPropagator(cfg, tau=tau),
                default_tau=0.3)
