"""Declarative run description for the PyTorch port: ``RunSpec`` ->
``build_run``.

Port of ``repro.launch.spec``: every method of the reference (``vmc``,
``dmc``, ``sem-vmc``, ``fused-vmc`` and the wavefunction optimization
``opt-vmc`` with its ``opt_*`` fields); the ``thread``, ``process``,
``sim`` and ``grid`` backends; systems with a single determinant or a CI
expansion (``n_det``), with or without distance screening
(``screen_eps``); and a ``device`` (CUDA unless ``'cpu'`` is asked for;
process and grid workers run on the same device name).  The reference's
``precision`` and ``shards`` fields have no counterpart here yet.

The run key is the reference's critical-data key plus ``impl='torch'``:
blocks of the port never fold into a JAX run's averages.  A CI expansion's
coefficients and excitation lists are critical data, as in the reference;
so is ``screen_eps`` when it is > 0 (off, exhaustive and exact screening
keep the unscreened key).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.runtime import (GridConfig, QMCManager, ResultDatabase,
                                 RunControl, SimGridConfig,
                                 critical_data_key, make_backend)
from repro_torch.runtime.samplers import BlockSampler
from repro_torch.systems import build_system

# the reference's method, solver and backend names
METHODS = ('vmc', 'dmc', 'sem-vmc', 'opt-vmc', 'fused-vmc')
OPT_SOLVERS = ('sr', 'lm')
BACKEND_NAMES = ('thread', 'process', 'sim', 'grid')


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One declarative QMC run: physics + layout + stopping + resources.

    ``tau=0`` means the method default (0.3: the VMC time step and the
    sem-vmc/fused-vmc proposal width; 0.02: the DMC time step).  ``grid``
    only applies to ``backend='sim'``; ``net`` (TCP listen address +
    heartbeat policy) only to ``backend='grid'``.
    """

    # physics
    system: str = 'h2'
    method: str = 'vmc'              # vmc | dmc | sem-vmc | fused-vmc |
    #                                  opt-vmc
    n_det: int = 1                   # CI expansion size (1: single det)
    tau: float = 0.0                 # 0 -> method default
    e_trial: float | None = None     # DMC reference energy (None: guess)
    equil_steps: int = 100           # DMC cold-start VMC equilibration
    screen_eps: float = -1.0         # AO screening tolerance (negative:
    #                                  off; 0: exact zeros only)

    # ensemble layout
    n_walkers: int = 32              # walkers per worker
    steps: int = 50                  # MC generations per sub-block

    # resources
    backend: str = 'thread'
    n_workers: int = 2
    subblocks_per_block: int = 4
    grid: SimGridConfig = dataclasses.field(default_factory=SimGridConfig)
    net: GridConfig = dataclasses.field(default_factory=GridConfig)
    device: str | None = None        # None/'cuda': the GPU; 'cpu' on request

    # wavefunction optimization (method='opt-vmc')
    opt_steps: int = 5               # outer parameter-update iterations
    opt_solver: str = 'sr'           # sr (stochastic reconfig) | lm (linear)
    opt_lr: float = 0.1              # SR step scale
    sr_damping: float = 1e-2         # diagonal shift on the overlap matrix
    opt_blocks_per_step: int = 4     # blocks sampled per parameter version
    ckpt_dir: str = ''               # per-step checkpoints ('' = off)

    # stopping criteria
    max_blocks: int = 20
    target_error: float = 0.0
    wall_clock_limit: float = 0.0

    # bookkeeping
    db: str = ':memory:'
    seed: int = 0
    n_kept: int = 64
    poll_interval: float = 0.05

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f'unknown method {self.method!r} '
                             f'(choose from {METHODS})')
        if self.backend not in BACKEND_NAMES:
            raise ValueError(f'unknown backend {self.backend!r} '
                             f'(choose from {BACKEND_NAMES})')
        if self.n_det < 1:
            raise ValueError(f'n_det must be >= 1, got {self.n_det}')
        if self.opt_solver not in OPT_SOLVERS:
            raise ValueError(f'unknown opt_solver {self.opt_solver!r} '
                             f'(choose from {OPT_SOLVERS})')
        if self.opt_steps < 1:
            raise ValueError(f'opt_steps must be >= 1, got {self.opt_steps}')

    def screening_eps(self):
        """The AO screening tolerance to build the system with (None: off,
        for a negative ``screen_eps``)."""
        return self.screen_eps if self.screen_eps >= 0 else None

    def resolved_tau(self) -> float:
        """The effective step size (the method default when tau == 0)."""
        if self.tau:
            return self.tau
        from repro_torch.core.driver import method_default_tau
        return method_default_tau(self.method)


@dataclasses.dataclass
class QMCRun:
    """A RunSpec compiled against a substrate: ready to run."""

    spec: RunSpec
    run_key: str
    cfg: object
    params: object
    sampler: BlockSampler
    db: ResultDatabase
    manager: QMCManager

    @property
    def backend(self):
        """The ExecutorBackend the manager was compiled against."""
        return self.manager.backend

    def run(self):
        """Blocking run to completion.

        ``method='opt-vmc'`` runs the outer optimization loop and returns
        an ``OptResult``; every other method returns the final
        ``RunningAverage``.
        """
        if self.spec.method == 'opt-vmc':
            from repro_torch.optimize.loop import run_optimization
            return run_optimization(self)
        return self.manager.run()

    def worker_errors(self) -> list[str]:
        """Tracebacks of workers that died during the run."""
        return self.manager.worker_errors()


def spec_run_key(spec: RunSpec, cfg, params) -> str:
    """The run key ``build_run`` gives ``spec`` with its system (cfg,
    params): the reference's critical-data key plus ``impl='torch'``."""
    ci_key = {}
    if cfg.ci is not None:
        ci_key = dict(
            ci_coeffs=np.asarray(cfg.ci.coeffs),
            ci_exc=np.concatenate([cfg.ci.holes_up, cfg.ci.parts_up,
                                   cfg.ci.holes_dn, cfg.ci.parts_dn],
                                  axis=1))
    # eps > 0 drops AO values below the cutoff: a different estimator.
    # Off, exhaustive (eps < 0) and exact (eps == 0) keep the unscreened key
    screen_key = {}
    eps = spec.screening_eps()
    if eps is not None and eps > 0:
        screen_key = dict(screen_eps=eps)
    return critical_data_key(
        system=spec.system, method=spec.method, tau=spec.resolved_tau(),
        mo=params.mo.cpu().numpy(), coords=params.coords.cpu().numpy(),
        **ci_key, **screen_key, impl='torch')


def build_run(spec: RunSpec, db: ResultDatabase | None = None) -> QMCRun:
    """Compile a RunSpec into a runnable manager/sampler/backend stack:
    system on the device -> propagator from the ``core.driver`` registry ->
    ``BlockSampler`` -> ``QMCManager`` on the requested backend (DMC with
    the manager's between-block E_T feedback).  Grid workers rebuild the
    sampler on their own host from the declarative run payload; localhost
    ones are started with this spec's device (``--device``)."""
    from repro_torch.core.driver import make_propagator

    cfg, params = build_system(spec.system, n_det=spec.n_det,
                               ci_seed=spec.seed,
                               screen_eps=spec.screening_eps(),
                               device=spec.device)
    tau = spec.resolved_tau()
    prop = make_propagator(spec.method, cfg, tau=tau, e_trial=spec.e_trial,
                           equil_steps=spec.equil_steps)
    sampler = BlockSampler(prop, params, n_walkers=spec.n_walkers,
                           steps=spec.steps, device=spec.device)
    run_key = spec_run_key(spec, cfg, params)
    if db is None:
        db = ResultDatabase(spec.db)
    db.register_run(run_key, spec=dataclasses.asdict(spec))
    control = RunControl(max_blocks=spec.max_blocks,
                         target_error=spec.target_error,
                         wall_clock_limit=spec.wall_clock_limit,
                         poll_interval=spec.poll_interval,
                         subblocks_per_block=spec.subblocks_per_block,
                         e_trial_feedback=(spec.method == 'dmc'))
    net = spec.net
    if spec.device is not None and '--device' not in net.worker_args:
        net = dataclasses.replace(net, worker_args=(
            *net.worker_args, '--device', str(spec.device)))
    backend = make_backend(spec.backend, spec.n_workers, grid=spec.grid,
                           net=net)
    if spec.backend == 'grid':
        # declarative run payload: grid workers rebuild this sampler on
        # their own host from these fields (``qmc_worker
        # .sampler_from_payload``); no tensor crosses the wire
        backend.set_run_payload(dict(
            system=spec.system, method=spec.method, n_det=spec.n_det,
            ci_seed=spec.seed, tau=tau, e_trial=spec.e_trial,
            equil_steps=spec.equil_steps, n_walkers=spec.n_walkers,
            steps=spec.steps, screen_eps=spec.screen_eps))
    mgr = QMCManager(sampler, run_key, control, db=db, seed=spec.seed,
                     backend=backend, n_kept=spec.n_kept)
    return QMCRun(spec=spec, run_key=run_key, cfg=cfg, params=params,
                  sampler=sampler, db=db, manager=mgr)
