"""The outer VMC optimization loop: sample -> solve -> broadcast -> resample.

One synchronous loop drives any execution substrate through the standard
``QMCManager``: each step waits until ``blocks_per_step`` blocks stamped
with the *current* parameter version have landed in the database, merges
them into moments, takes one damped SR or linear-method step, clips the
vector back into the valid domain, and broadcasts the new vector (with an
incremented version) to every worker — thread mailbox, process control
queue, or grid PARAMS packet, per backend.  Blocks sampled under an older
version keep arriving harmlessly; the version filter rejects them.

Fault tolerance follows the split design: the *sampling* side inherits the
runtime's drop-any-block contract (a dead worker's blocks are simply
absent), while the *loop* side checkpoints the parameter vector each step
as an atomic npz (``train.checkpoint``, run-key-guarded) — a killed
optimization resumes at the latest completed step with bitwise-identical
parameters.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.optimize import estimators, solvers
from repro_torch.runtime.blocks import combine_blocks
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)


@dataclasses.dataclass(frozen=True)
class OptStep:
    """One completed optimization step (sampled at ``vec``/``version``)."""

    step: int
    version: int
    energy: float
    error: float
    variance: float
    n_blocks: int
    vec: np.ndarray


@dataclasses.dataclass
class OptResult:
    """Trajectory + final parameters of one optimization run."""

    steps: list
    vec: np.ndarray
    version: int
    run_key: str
    final: object            # RunningAverage over every stored block

    def energies(self) -> list[float]:
        """Variational energy per optimization step."""
        return [s.energy for s in self.steps]

    def __str__(self) -> str:
        lines = [f'opt-vmc run {self.run_key}: {len(self.steps)} steps']
        for s in self.steps:
            lines.append(f'  step {s.step} (pv {s.version}): '
                         f'E = {s.energy:+.6f} +/- {s.error:.6f} '
                         f'(var {s.variance:.4f}, {s.n_blocks} blocks)')
        return '\n'.join(lines)


def _wait_for_blocks(mgr, run_key: str, version: int, n_target: int,
                     timeout: float, poll_interval: float):
    """Poll until ``n_target`` current-version blocks are in the database."""
    deadline = time.monotonic() + timeout
    while True:
        time.sleep(poll_interval)
        mgr.poll()
        blocks = mgr.db.blocks(run_key)
        cur = [b for b in blocks if b.aux.get('opt_pv') == float(version)]
        if len(cur) >= n_target:
            return blocks
        if time.monotonic() > deadline:
            raise RuntimeError(
                f'optimization step timed out after {timeout:.0f}s waiting '
                f'for {n_target} blocks at parameter version {version} '
                f'(got {len(cur)}; '
                f'{sum(w.running for w in mgr.workers)} workers running)')
        if (mgr.workers and all(not w.running for w in mgr.workers)
                and mgr.backend.name != 'grid'):
            # non-elastic substrate with every worker dead: no block at
            # the current version can ever arrive
            raise RuntimeError(
                f'all workers died at parameter version {version} '
                f'({len(cur)}/{n_target} blocks); '
                f'errors: {mgr.worker_errors()}')


def run_optimization(run, *, n_steps: int | None = None,
                     solver: str | None = None, lr: float | None = None,
                     damping: float | None = None,
                     blocks_per_step: int | None = None,
                     ckpt_dir: str | None = None, resume: bool = True,
                     step_timeout: float = 0.0,
                     on_step=None) -> OptResult:
    """Drive a built ``QMCRun`` through ``n_steps`` of VMC optimization.

    Keyword arguments default to the run's ``RunSpec`` optimization fields
    (``opt_steps`` / ``opt_solver`` / ``opt_lr`` / ``sr_damping`` /
    ``opt_blocks_per_step`` / ``ckpt_dir``).  ``on_step(step, mgr, vec)``
    is invoked after each completed step (fault-drill hook: kill or add
    workers between steps).  Returns the step trajectory; the manager is
    shut down (workers stopped, tree drained) on exit, including on error.
    """
    spec = run.spec
    n_steps = int(spec.opt_steps if n_steps is None else n_steps)
    solver = (spec.opt_solver if solver is None else solver)
    lr = float(spec.opt_lr if lr is None else lr)
    damping = float(spec.sr_damping if damping is None else damping)
    blocks_per_step = int(spec.opt_blocks_per_step if blocks_per_step is None
                          else blocks_per_step)
    ckpt_dir = (spec.ckpt_dir if ckpt_dir is None else ckpt_dir) or None
    step_timeout = float(step_timeout or spec.wall_clock_limit or 300.0)

    mgr, sampler, cfg = run.manager, run.sampler, run.cfg
    P = estimators.n_params(cfg)
    vec = estimators.opt_vector(cfg, sampler.params)
    version = 0
    start = 0
    if ckpt_dir and resume and latest_step(ckpt_dir) is not None:
        tree, k = restore_checkpoint(ckpt_dir, {'vec': np.asarray(vec)},
                                     run_key=run.run_key)
        vec = np.asarray(tree['vec'], np.float64)
        start = k + 1               # step k completed; its update is vec
        version = start             # one version increment per step

    # align every substrate on the starting vector *before* workers boot:
    # the shared/pickled sampler carries it, the grid backend ships it in
    # each WELCOME (fresh joins AND reconnects get the current version)
    sampler.apply_params(version, vec)
    mgr.broadcast_params(version, vec)
    if not mgr.workers:
        mgr.start()

    history: list[OptStep] = []
    try:
        for step in range(start, n_steps):
            blocks = _wait_for_blocks(mgr, run.run_key, version,
                                      blocks_per_step, step_timeout,
                                      mgr.control.poll_interval)
            m = solvers.collect_moments(blocks, P, version)
            avg = combine_blocks(
                [b for b in blocks
                 if b.aux.get('opt_pv') == float(version)])
            history.append(OptStep(
                step=step, version=version, energy=avg.energy,
                error=avg.error, variance=avg.variance,
                n_blocks=avg.n_blocks, vec=np.asarray(vec)))
            if solver == 'lm':
                new = solvers.lm_update(m, vec, damping=damping)
            else:
                new = solvers.sr_update(m, vec, lr=lr, damping=damping)
            vec = estimators.clip_vector(cfg, new)
            version += 1
            sampler.apply_params(version, vec)
            mgr.broadcast_params(version, vec)
            if ckpt_dir:
                save_checkpoint(ckpt_dir, step, {'vec': np.asarray(vec)},
                                run_key=run.run_key)
            if on_step is not None:
                on_step(step, mgr, vec)
    finally:
        final = mgr.shutdown()
    return OptResult(steps=history, vec=np.asarray(vec), version=version,
                     run_key=run.run_key, final=final)
