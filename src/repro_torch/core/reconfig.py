"""Constant-population stochastic reconfiguration (paper §II.B, ref. [17]).

Port of ``repro.core.reconfig``.  Replaces DMC branching: at every step the
M walkers are redrawn from the current population with probabilities
p_k = w_k / sum(w), keeping M constant (no load imbalance, no walker
exchange).  The finite-population bias is removed by carrying the *global
weight* (product of population-mean weights) into the averages.

``reconfigure`` uses systematic (low-variance comb) resampling, which
preserves E[copies_k] = M p_k exactly.  Its one uniform comes from the
caller: drawn from a ``torch.Generator`` or injected (a test feeds the
reference's ``jax.random.uniform(key, ())``; torch cannot replay the
threefry key itself).
"""
from __future__ import annotations

import torch


def reconfigure(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Return indices (M,) int32 of the walkers surviving reconfiguration.

    Systematic resampling: one uniform ``u`` (0-d, in [0, 1)), comb at
    spacing 1/M over the fp32 cumulative weight distribution.  Stays on the
    device: no host sync.
    """
    m = weights.shape[0]
    p = weights / torch.sum(weights)
    cum = torch.cumsum(p, dim=0)
    comb = (u + torch.arange(m, dtype=cum.dtype, device=cum.device)) / m
    idx = torch.searchsorted(cum, comb)
    return torch.clamp(idx, 0, m - 1).to(torch.int32)


def global_weight_update(log_w_hist: torch.Tensor, mean_w: torch.Tensor):
    """Shift the trailing window of log population weights, append new one.

    log_w_hist: (P,) log of past population-mean weights (most recent last).
    The product over the window is the estimator weight Pi_t (ref. [17]).
    Returns (new history, Pi_t).
    """
    log_w_hist = torch.roll(log_w_hist, -1)
    log_w_hist[-1] = torch.log(mean_w)
    return log_w_hist, torch.exp(torch.sum(log_w_hist))
