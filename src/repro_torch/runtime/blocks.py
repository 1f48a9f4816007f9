"""Block results: the unit of fault tolerance (paper §V.A).

A block is the average of `steps` Monte Carlo generations over one worker's
private walker population.  Block averages are i.i.d. Gaussian samples of the
same estimator, so the *combination rule is a weighted mean* and any subset
of blocks is an unbiased estimate — dropping a dead worker's in-flight block
or truncating a block at a stop signal introduces no bias (the paper's
central fault-tolerance argument).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockAccumulator:
    """Typed weighted accumulator — THE combination rule for block stats.

    Replaces the stringly ``{'weight','e_mean','e2_mean','aux'}`` dicts:
    every entry except ``weight`` is a weighted mean, and ``merge`` is the
    single source of truth for how two of them combine — used by the worker
    to fold sub-blocks into a block and by ``combine_blocks`` for the
    database running average.  Pure host-side floats (the runtime never
    imports jax); build one from a device ``core.driver.BlockStats`` with
    ``from_stats``.
    """

    weight: float = 0.0
    e_mean: float = 0.0
    e2_mean: float = 0.0
    aux: Mapping[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_stats(cls, stats) -> 'BlockAccumulator':
        """From anything with weight/e_mean/e2_mean/aux attributes
        (e.g. the jit'd driver's BlockStats) — converted to host floats.

        Array-valued aux entries (the optimizer's moment estimators) are
        flattened to indexed scalar keys — ``opt_o/3``, ``opt_oo/1/2`` —
        so the weighted-mean merge rule, the JSON wire encoding, and the
        database column all keep their scalar-float contract unchanged.
        """
        aux = {}
        for k, v in dict(stats.aux).items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                aux[k] = float(arr)
            else:
                for idx, val in np.ndenumerate(arr):
                    aux['/'.join([k, *map(str, idx)])] = float(val)
        return cls(weight=float(stats.weight), e_mean=float(stats.e_mean),
                   e2_mean=float(stats.e2_mean), aux=aux)

    def merge(self, other: 'BlockAccumulator') -> 'BlockAccumulator':
        """Weighted combination; aux keys missing on one side count as 0
        (a sub-block that never measured a statistic dilutes it)."""
        w = self.weight + other.weight
        if w <= 0.0:
            return self
        mix = lambda a, b: (self.weight * a + other.weight * b) / w
        keys = set(self.aux) | set(other.aux)
        return BlockAccumulator(
            weight=w, e_mean=mix(self.e_mean, other.e_mean),
            e2_mean=mix(self.e2_mean, other.e2_mean),
            aux={k: mix(self.aux.get(k, 0.0), other.aux.get(k, 0.0))
                 for k in keys})

    def is_valid(self) -> bool:
        return (self.weight > 0.0 and math.isfinite(self.e_mean)
                and math.isfinite(self.e2_mean))

    def to_block(self, run_key: str, worker_id: int, block_id: int,
                 job: str = '') -> 'BlockResult':
        return BlockResult(run_key=run_key, worker_id=worker_id,
                           block_id=block_id, weight=self.weight,
                           e_mean=self.e_mean, e2_mean=self.e2_mean,
                           aux=dict(self.aux), job=job)


@dataclasses.dataclass(frozen=True)
class BlockResult:
    """One block's sufficient statistics."""

    run_key: str            # CRC-32 hex of the critical data
    worker_id: int
    block_id: int           # per-worker counter (unique with worker_id)
    weight: float           # total statistical weight (walker-steps or Pi_t)
    e_mean: float           # weighted mean of E_L over the block
    e2_mean: float          # weighted mean of E_L^2 (for error bars)
    aux: Mapping[str, float] = dataclasses.field(default_factory=dict)
    timestamp: float = dataclasses.field(default_factory=time.time)
    job: str = ''           # unique job identity: (job, worker, block) is
                            # the dedupe key across clusters/restarts

    def is_valid(self) -> bool:
        return (self.weight > 0.0 and math.isfinite(self.e_mean)
                and math.isfinite(self.e2_mean))


@dataclasses.dataclass(frozen=True)
class RunningAverage:
    n_blocks: int
    weight: float
    energy: float
    variance: float         # population variance of E_L
    error: float            # standard error of the block mean

    def __str__(self) -> str:
        return (f'E = {self.energy:+.6f} +/- {self.error:.6f} '
                f'({self.n_blocks} blocks, weight {self.weight:.3g})')


def combine_blocks(blocks: list[BlockResult]) -> RunningAverage:
    """Weighted mean over blocks + block-level standard error.

    The error bar uses the spread of *block means* (blocks are i.i.d. by
    construction), not the raw E_L variance — matching the paper's
    post-processing-by-database-query model.
    """
    blocks = [b for b in blocks if b.is_valid()]
    if not blocks:
        return RunningAverage(0, 0.0, float('nan'), float('nan'),
                              float('inf'))
    acc = BlockAccumulator()
    for b in blocks:           # same merge rule the workers use sub-block-wise
        acc = acc.merge(BlockAccumulator(b.weight, b.e_mean, b.e2_mean,
                                         dict(b.aux)))
    wsum, e = acc.weight, acc.e_mean
    var = max(acc.e2_mean - e * e, 0.0)
    if len(blocks) > 1:
        # weighted variance of block means around the global mean
        num = sum(b.weight * (b.e_mean - e) ** 2 for b in blocks)
        err = math.sqrt(num / wsum / (len(blocks) - 1))
    else:
        err = float('inf')
    return RunningAverage(len(blocks), wsum, e, var, err)
