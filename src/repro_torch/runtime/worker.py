"""Worker: one single-core sampler loop (paper §V.D).

    while (.True.)
        compute_a_block_of_data();
        send_the_results_to_the_forwarder();

The paper's SIGTERM/SIGUSR2 'stop immediately without losing a step' is a
stop Event checked between blocks *and honored inside a block* by splitting
each block into sub-blocks: on stop, the partial block is flushed with its
(smaller) weight — weighted combination keeps it unbiased, so a run can be
terminated at any wall-clock instant at zero cost (the paper's key to ideal
parallel efficiency on batch systems).
"""
from __future__ import annotations

import threading
import traceback
from typing import Callable, Protocol

import numpy as np

from repro_torch.runtime.blocks import BlockAccumulator, BlockResult
from repro_torch.runtime.forwarder import Forwarder


class Sampler(Protocol):
    """Adapter between the generic runtime and a jit'd block runner
    (``samplers.BlockSampler`` over any Propagator).

    Implementations wrap jax functions; the runtime never imports jax.
    ``step`` is the worker's monotone sub-block counter — implementations
    derive the sub-block RNG as ``fold_in(worker_key, step)``, so streams
    never alias however long the run gets."""

    def init_state(self, worker_id: int, seed: int, walkers=None): ...

    def run_subblock(self, state, step: int):
        """-> (state, BlockAccumulator, walkers np, energies np)"""
        ...


class Worker:
    def __init__(self, worker_id: int, sampler: Sampler, run_key: str,
                 forwarder: 'Forwarder', seed: int,
                 subblocks_per_block: int = 4,
                 init_walkers: np.ndarray | None = None, job: str = ''):
        self.worker_id = worker_id
        self.sampler = sampler
        self.run_key = run_key
        self.job = job
        self.forwarder = forwarder
        self.seed = seed
        self.subblocks_per_block = subblocks_per_block
        self.init_walkers = init_walkers
        self._stop = threading.Event()
        self._crash = threading.Event()
        self._thread: threading.Thread | None = None
        self.blocks_done = 0
        self.error: str | None = None
        # E_T feedback mailbox (manager writes, worker reads between blocks)
        self.e_trial_update: float | None = None
        # parameter-broadcast mailbox (wavefunction optimization)
        self.params_update: tuple | None = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def send_e_trial(self, e_trial: float):
        """Between-block scalar feedback (the WorkerHandle mailbox)."""
        self.e_trial_update = float(e_trial)

    def send_params(self, version: int, vec):
        """Wavefunction-parameter broadcast (applied between blocks)."""
        self.params_update = (int(version), np.asarray(vec, np.float64))

    def stop(self):
        """SIGTERM analogue: flush the in-flight partial block, then exit."""
        self._stop.set()

    def crash(self):
        """Fault injection: die *without* flushing (hard node failure)."""
        self._crash.set()

    def join(self, timeout: float = 10.0):
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self):
        try:
            state = self.sampler.init_state(self.worker_id, self.seed,
                                            self.init_walkers)
            step = 0
            while not self._stop.is_set() and not self._crash.is_set():
                if self.e_trial_update is not None:
                    state = self.sampler.set_e_trial(state,
                                                     self.e_trial_update)
                    self.e_trial_update = None
                if self.params_update is not None:
                    version, vec = self.params_update
                    self.params_update = None
                    apply = getattr(self.sampler, 'apply_params', None)
                    if apply is not None:
                        apply(version, vec)
                acc = BlockAccumulator()
                walkers = energies = None
                for _ in range(self.subblocks_per_block):
                    if self._crash.is_set():
                        return                     # hard death: no flush
                    state, sub, walkers, energies = \
                        self.sampler.run_subblock(state, step)
                    step += 1
                    acc = acc.merge(sub)           # the one weighted-merge
                    if self._stop.is_set():
                        break                      # truncated block: flush
                if acc.is_valid():
                    blk = acc.to_block(self.run_key, self.worker_id,
                                       self.blocks_done, job=self.job)
                    self.forwarder.submit_blocks([blk])
                    if walkers is not None:
                        self.forwarder.submit_walkers(
                            np.asarray(walkers), np.asarray(energies))
                    self.blocks_done += 1
        except Exception:                           # pragma: no cover
            self.error = traceback.format_exc()
