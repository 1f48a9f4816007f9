"""VMC wavefunction optimization: stochastic reconfiguration + linear method.

Port of ``repro.optimize``: energy minimization of the Padé Jastrow
parameters (b_ee, b_en, a_en) and, for multideterminant expansions, the CI
coefficients, over the standard fault-tolerant block runtime:

* ``estimators``  — the flat parameter vector <-> ``WavefunctionParams``
  mapping and the per-walker derivative estimator
  O_i = ∂ ln|Ψ| / ∂ p_i by autograd (``o_batched``: the whole walker
  batch in one backward pass; no gradient reaches an MO-product kernel);
* ``propagator``  — ``OptVMCPropagator`` (registered as ``opt-vmc``):
  plain VMC sampling plus per-step accumulation of the moments
  ⟨O⟩, ⟨O E_L⟩, ⟨O Oᵀ⟩, ⟨O Oᵀ E_L⟩ into block aux statistics;
* ``solvers``     — merge blocks into moments and take one damped
  stochastic-reconfiguration or linear-method parameter step (numpy; a
  copy of the reference's);
* ``loop``        — the outer synchronous loop (sample -> solve ->
  broadcast PARAMS -> resample), with atomic-npz checkpoints
  (``train.checkpoint``) and restart at the latest completed step (a
  copy of the reference's).

Every block is stamped with the parameter version it was sampled under
(``opt_pv`` aux); the solver only consumes blocks whose stamp matches the
current version, so stale or torn blocks are rejected, never mixed.
"""
from repro_torch.optimize.estimators import (apply_vector, clip_vector,
                                             make_o_fn, n_params,
                                             o_batched, opt_vector,
                                             params_from_vector,
                                             reweighted_energy,
                                             traced_vector)
from repro_torch.optimize.loop import OptResult, OptStep, run_optimization
from repro_torch.optimize.propagator import OptVMCPropagator
from repro_torch.optimize.solvers import (Moments, collect_moments,
                                          lm_update, sr_matrices, sr_update)

__all__ = [
    'Moments', 'OptResult', 'OptStep', 'OptVMCPropagator', 'apply_vector',
    'clip_vector', 'collect_moments', 'lm_update', 'make_o_fn', 'n_params',
    'o_batched', 'opt_vector', 'params_from_vector', 'reweighted_energy',
    'run_optimization', 'sr_matrices', 'sr_update', 'traced_vector',
]
