"""Deterministic jax-free samplers for runtime drills and benchmarks.

The runtime's fault-tolerance and scaling claims are about the *transport*
(blocks, forwarders, backends), not the physics — so chaos drills and
parallel-efficiency benchmarks run a sleep-bound Gaussian sampler: each
sub-block sleeps ``delay`` seconds (modelling GIL-free XLA compute) and
emits E_L samples from N(mu, sigma^2) with a per-(seed, worker) RNG stream.
Importable without jax, so grid worker subprocesses boot in ~0.2 s.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.runtime.blocks import BlockAccumulator


class GaussianSampler:
    """Sleep-bound fake sampler with a known mean (drills/benchmarks).

    Implements the ``runtime.worker.Sampler`` protocol; statistics are
    exactly verifiable (weighted average converges to ``mu``), which is
    what every unbiasedness drill asserts.
    """

    def __init__(self, true_energy: float = -3.0, sigma: float = 0.5,
                 delay: float = 0.0, n_walkers: int = 8,
                 samples_per_subblock: int = 64):
        self.mu = float(true_energy)
        self.sigma = float(sigma)
        self.delay = float(delay)
        self.n_walkers = int(n_walkers)
        self.samples = int(samples_per_subblock)

    def init_state(self, worker_id: int, seed: int, walkers=None):
        """Distinct stream per worker from one base seed (like fold_in)."""
        return {'rng': np.random.default_rng([seed, worker_id]),
                'restarted': walkers is not None}

    def set_e_trial(self, state, e_trial: float):
        """E_T feedback is a no-op for the fixed-mean fake."""
        return state

    def run_subblock(self, state, step: int):
        """One sleep-bound sub-block of Gaussian E_L samples."""
        if self.delay:
            time.sleep(self.delay)
        rng = state['rng']
        e = rng.normal(self.mu, self.sigma, size=self.samples)
        acc = BlockAccumulator(weight=float(e.size), e_mean=float(e.mean()),
                               e2_mean=float((e ** 2).mean()))
        walkers = rng.normal(size=(self.n_walkers, 2, 3))
        return state, acc, walkers, e[:self.n_walkers]
