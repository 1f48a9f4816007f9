"""Declarative run description for the PyTorch port: ``RunSpec`` ->
``build_run``.

Port of ``repro.launch.spec``: every method of the reference (``vmc``,
``dmc``, ``sem-vmc``, ``fused-vmc`` and the wavefunction optimization
``opt-vmc`` with its ``opt_*`` fields); the ``thread``, ``process``,
``sim`` and ``grid`` backends; systems with a single determinant or a CI
expansion (``n_det``), with or without distance screening
(``screen_eps``), at any storage ``precision`` of the maintained sweep
state; and a ``device`` (CUDA unless ``'cpu'`` is asked for; process and
grid workers run on the same device name).  ``shards > 1`` shards each
worker's walkers over that many devices (``sharding.walkers_devices``:
the first visible cards, or the CPU that many times), on the ``thread``
and ``sim`` backends only, as in the reference; it stays out of the run
key.

The run key is the reference's critical-data key plus ``impl='torch'``:
blocks of the port never fold into a JAX run's averages.  A CI expansion's
coefficients and excitation lists are critical data, as in the reference;
so is ``screen_eps`` when it is > 0 (off, exhaustive and exact screening
keep the unscreened key), and ``precision`` when it is not 'fp32'.

``spec_to_payload`` / ``spec_from_payload`` are the reference's plain-JSON
form of a spec (the database registry, the run service's wire format);
a reference payload parses here, and the port's ``device`` field rides
along.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.slater import PRECISIONS
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
    precision: str = 'fp32'          # storage policy of the maintained
    #                                  sweep inverses / CI P-tables
    #                                  ('fp32' | 'bf16' | 'fp16'); a
    #                                  reduced one enters the run key

    # ensemble layout
    n_walkers: int = 32              # walkers per worker
    steps: int = 50                  # MC generations per sub-block
    shards: int = 1                  # devices per worker ensemble (> 1:
    #                                  thread or sim backend only)

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
        if self.precision not in PRECISIONS:
            raise ValueError(f'unknown precision {self.precision!r} '
                             f'(choose from {PRECISIONS})')
        if self.shards > 1 and self.backend in ('process', 'grid'):
            raise ValueError(
                'shards > 1 requires the thread or sim backend: walker '
                'shards are threads of one process, on its devices, and '
                'cannot be shipped to worker processes or across grid hosts')

    def replace(self, **kw) -> 'RunSpec':
        """Functional update (dataclasses.replace convenience)."""
        return dataclasses.replace(self, **kw)

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


# RunSpec fields that may cross a trust boundary as plain JSON data.
# Everything a client can set is a scalar; the two nested configs are
# rebuilt field by field from their own whitelists — nothing is ever
# unpickled or eval'd on the receive path.
_SCALAR_FIELDS = tuple(
    f.name for f in dataclasses.fields(RunSpec)
    if f.name not in ('grid', 'net'))


def spec_to_payload(spec: RunSpec) -> dict:
    """RunSpec -> plain-JSON payload (``repro.launch.spec
    .spec_to_payload``; the port's ``device`` rides along): stored under
    the run key in the database's ``runs`` registry and shipped over the
    service protocol.  Scalars + two nested dicts of scalars."""
    out = {f: getattr(spec, f) for f in _SCALAR_FIELDS}
    out['grid'] = dataclasses.asdict(spec.grid)
    out['net'] = dataclasses.asdict(spec.net)
    # tuples are not JSON; normalize to lists for a stable round trip
    for cfg in (out['grid'], out['net']):
        for k, v in cfg.items():
            if isinstance(v, tuple):
                cfg[k] = [list(x) if isinstance(x, (tuple, list)) else x
                          for x in v]
    return out


def spec_from_payload(payload: dict) -> RunSpec:
    """Plain-JSON payload -> validated RunSpec (strict whitelist;
    ``repro.launch.spec.spec_from_payload``).

    Unknown fields raise ``ValueError``, nested configs are rebuilt from
    their dataclass whitelists, and ``RunSpec.__post_init__`` re-validates
    the result: the one ingest gate for every spec that arrives over the
    wire or is reloaded from the database registry.
    """
    if not isinstance(payload, dict):
        raise ValueError(f'spec payload must be a dict, got '
                         f'{type(payload).__name__}')
    kw = {}
    for name, value in payload.items():
        if name == 'grid':
            allowed = {f.name for f in dataclasses.fields(SimGridConfig)}
            bad = set(value) - allowed
            if bad:
                raise ValueError(f'unknown grid field(s) {sorted(bad)}')
            value = dict(value)
            for k in ('worker_failures', 'forwarder_failures'):
                if k in value:
                    value[k] = tuple(tuple(x) for x in value[k])
            kw['grid'] = SimGridConfig(**value)
        elif name == 'net':
            allowed = {f.name for f in dataclasses.fields(GridConfig)}
            bad = set(value) - allowed
            if bad:
                raise ValueError(f'unknown net field(s) {sorted(bad)}')
            value = dict(value)
            if 'worker_args' in value:
                value['worker_args'] = tuple(value['worker_args'])
            kw['net'] = GridConfig(**value)
        elif name in _SCALAR_FIELDS:
            if value is not None and not isinstance(value, (int, float,
                                                            str, bool)):
                raise ValueError(f'spec field {name!r} must be scalar, '
                                 f'got {type(value).__name__}')
            kw[name] = value
        else:
            raise ValueError(f'unknown spec field {name!r}')
    return RunSpec(**kw)


class LiveTreeManager(QMCManager):
    """The runtime's ``QMCManager``, but a joining worker is attached to a
    forwarder that is alive.

    ``QMCManager.add_worker`` sends worker ``wid`` to forwarder ``1 + wid
    % (n - 1)`` whether it lives or not, and a killed forwarder drops
    every block submitted to it: a worker that joins after that node died
    (the grid's elastic join, a service lease) computes for nothing.
    Here it submits to the nearest live one of that forwarder and its
    ancestors instead, the tree's own rule for a forwarder whose parent
    died.  The reference's manager has the fault (ROADMAP Queue C); its
    copy here stays verbatim, so the repair is this subclass, which
    ``build_run`` uses."""

    def add_worker(self, init_walkers: np.ndarray | None = None):
        """Join a new computational resource to the running calculation
        (``QMCManager.add_worker`` with a live forwarder)."""
        wid = self._next_worker_id
        self._next_worker_id += 1
        fwd = self.tree[1 + wid % (len(self.tree) - 1)] \
            if len(self.tree) > 1 else self.tree[0]
        fwd = next((f for f in (fwd, *fwd.ancestors) if f.alive), fwd)
        if init_walkers is None:
            res = self.db.load_reservoir(self.run_key)
            if res is not None:
                rng = np.random.default_rng(self._seed + 7777 + wid)
                r = self.tree[0].reservoir
                if len(r) == 0:
                    r.add(res[0], res[1])
                init_walkers = r.sample(16, rng)
        w = self.backend.spawn(
            wid, self.sampler, self.run_key, fwd, seed=self._seed,
            subblocks_per_block=self.control.subblocks_per_block,
            init_walkers=init_walkers, job=self.job_id)
        self.workers.append(w)
        return w


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
        ``RunningAverage``.  Returns only once the workers that are
        threads of this process have ended (``_await_workers``).
        """
        if self.spec.method == 'opt-vmc':
            from repro_torch.optimize.loop import run_optimization
            out = run_optimization(self)
        else:
            out = self.manager.run()
        self._await_workers()
        return out

    def _await_workers(self) -> None:
        """Wait for the workers of the ``thread`` and ``sim`` backends to
        end: both run each worker as a thread of this process.  The
        manager's shutdown has asked each to stop, which it does at the
        end of the sub-block it is in, but waits only 10 s for it; a
        sub-block of the paper's larger systems takes longer (a 1amb
        sem-vmc sweep ~7 s, on an H100).  A worker left running would go
        on launching on this process's device after ``run`` returned.
        Process workers past the wait were terminated by the shutdown,
        and grid workers are other processes."""
        if self.manager.backend.name not in ('thread', 'sim'):
            return
        for w in self.manager.workers:
            w.join(None)

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
    # reduced-precision storage quantizes the estimator's resting state:
    # critical data.  fp32 adds no entry, so fp32 keys stay as they were
    precision_key = {}
    if spec.precision != 'fp32':
        precision_key = dict(precision=spec.precision)
    return critical_data_key(
        system=spec.system, method=spec.method, tau=spec.resolved_tau(),
        mo=params.mo.cpu().numpy(), coords=params.coords.cpu().numpy(),
        **ci_key, **screen_key, **precision_key, impl='torch')


def build_run(spec: RunSpec, db: ResultDatabase | None = None) -> QMCRun:
    """Compile a RunSpec into a runnable manager/sampler/backend stack:
    system on the device -> propagator from the ``core.driver`` registry ->
    ``BlockSampler`` (over ``shards`` devices) -> ``LiveTreeManager`` on
    the requested backend (DMC with the manager's between-block E_T
    feedback).  Grid workers rebuild the
    sampler on their own host from the declarative run payload; localhost
    ones are started with this spec's device (``--device``).  ``db``
    injects a shared store (the run service passes its own); either way
    the run key is registered with the spec's JSON payload
    (``spec_to_payload``), which ``extend``/``fork`` rebuild the spec
    from."""
    from repro_torch.core.driver import make_propagator

    cfg, params = build_system(spec.system, n_det=spec.n_det,
                               ci_seed=spec.seed,
                               screen_eps=spec.screening_eps(),
                               device=spec.device)
    if spec.precision != 'fp32':
        cfg = dataclasses.replace(cfg, precision=spec.precision)
    tau = spec.resolved_tau()
    prop = make_propagator(spec.method, cfg, tau=tau, e_trial=spec.e_trial,
                           equil_steps=spec.equil_steps)
    devices = None
    if spec.shards > 1:
        from repro_torch.sharding import walkers_devices
        devices = walkers_devices(spec.shards, spec.device)
    sampler = BlockSampler(prop, params, n_walkers=spec.n_walkers,
                           steps=spec.steps, device=spec.device,
                           devices=devices)
    run_key = spec_run_key(spec, cfg, params)
    if db is None:
        db = ResultDatabase(spec.db)
    db.register_run(run_key, spec=spec_to_payload(spec))
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
            steps=spec.steps, screen_eps=spec.screen_eps,
            precision=spec.precision))
    mgr = LiveTreeManager(sampler, run_key, control, db=db,
                          seed=spec.seed, backend=backend, n_kept=spec.n_kept)
    return QMCRun(spec=spec, run_key=run_key, cfg=cfg, params=params,
                  sampler=sampler, db=db, manager=mgr)
