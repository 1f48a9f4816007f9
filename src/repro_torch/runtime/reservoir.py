"""Energy-stratified fixed-size walker reservoir (paper §V.D).

The data server keeps N_kept walkers representative of the *whole* run's
local-energy distribution.  On receiving N new walkers a node appends them,
sorts the N_kept + N list by local energy, and comb-selects N_kept entries
at stride (N_kept + N) / N_kept from a random phase — preserving the energy
distribution while bounding memory.  These walkers seed the next run
(checkpoint/restart).
"""
from __future__ import annotations

import numpy as np


class WalkerReservoir:
    def __init__(self, n_kept: int, rng: np.random.Generator | None = None):
        self.n_kept = int(n_kept)
        self._rng = rng or np.random.default_rng(0)
        self._walkers: np.ndarray | None = None   # (m, n_e, 3)
        self._energies: np.ndarray | None = None  # (m,)

    def __len__(self) -> int:
        return 0 if self._walkers is None else self._walkers.shape[0]

    def add(self, walkers: np.ndarray, energies: np.ndarray) -> None:
        """Merge a batch, then stratified-downsample to n_kept."""
        walkers = np.asarray(walkers)
        energies = np.asarray(energies).reshape(-1)
        assert walkers.shape[0] == energies.shape[0]
        if self._walkers is None:
            w, e = walkers, energies
        else:
            w = np.concatenate([self._walkers, walkers], axis=0)
            e = np.concatenate([self._energies, energies], axis=0)
        m = w.shape[0]
        if m > self.n_kept:
            order = np.argsort(e, kind='stable')       # sort by local energy
            # comb selection: indices eta + i*m/n_kept (paper's formula)
            eta = self._rng.uniform(0.0, m / self.n_kept)
            sel = np.minimum((eta + np.arange(self.n_kept) *
                              (m / self.n_kept)).astype(np.int64), m - 1)
            keep = order[sel]
            w, e = w[keep], e[keep]
        self._walkers, self._energies = w, e

    def sample(self, n: int, rng: np.random.Generator | None = None):
        """Draw n walkers (with replacement if n > len) to seed a worker."""
        rng = rng or self._rng
        assert self._walkers is not None, 'empty reservoir'
        m = self._walkers.shape[0]
        idx = rng.choice(m, size=n, replace=n > m)
        return self._walkers[idx]

    def state(self):
        return self._walkers, self._energies

    @classmethod
    def from_state(cls, n_kept: int, walkers: np.ndarray,
                   energies: np.ndarray) -> 'WalkerReservoir':
        r = cls(n_kept)
        r.add(walkers, energies)
        return r
