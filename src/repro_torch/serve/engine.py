"""QMCService: a long-lived, multi-tenant QMC run engine (paper §V).

The paper's deployment is database-centric: blocks land in a store keyed
by the run's critical data, so *any* client can stop, extend, or merge a
calculation at any time.  This engine is the service form of that claim —
a single process that owns

* one durable ``ResultDatabase`` (every run's blocks, reservoirs, specs);
* one bounded worker pool, split across active runs by max-min fair-share
  leases (``serve.scheduler``), re-computed every poll so completions
  immediately promote starved runs;
* a RunSpec job queue: ``submit`` returns a run id instantly, a scheduler
  thread admits queued runs up to ``max_active``, and a per-run drive
  thread builds the stack, resizes workers to the current lease, and
  publishes live block statistics to subscribers.

Extend/fork are run-key operations, exactly §V.C's "merging databases is
a union" semantics:

* ``extend(key, n)`` re-submits the key's *stored* spec with
  ``max_blocks = already_stored + n`` — the new job appends blocks under
  the same key, so the running average continues bitwise from the stored
  sufficient statistics (dedupe on ``(run_key, job, worker_id,
  block_id)`` makes replays harmless);
* ``fork(key, **overrides)`` re-submits the stored spec with a changed
  critical field -> a *fresh* key, seeded from the parent's walker
  reservoir (warm start, independent statistics).

Builders are injectable: the default compiles specs through
``launch.spec.build_run`` (real physics, jax); ``gaussian_builder`` runs
the jax-free sleep-bound sampler from ``runtime.testing`` so service
tests and throughput benchmarks exercise scheduling/transport without
compiling XLA programs.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback

from repro_torch.launch.spec import (QMCRun, RunSpec, build_run,
                               spec_from_payload, spec_to_payload)
from repro_torch.runtime import (QMCManager, ResultDatabase, RunControl,
                           ThreadBackend, critical_data_key)
from repro_torch.serve.scheduler import fair_shares

# run lifecycle states
QUEUED = 'queued'
RUNNING = 'running'
DONE = 'done'
FAILED = 'failed'
CANCELLED = 'cancelled'
FINAL_STATES = (DONE, FAILED, CANCELLED)


def default_builder(spec: RunSpec, db: ResultDatabase) -> QMCRun:
    """Compile a spec against the real physics stack, into the shared db."""
    return build_run(spec, db=db)


def gaussian_builder(spec: RunSpec, db: ResultDatabase) -> QMCRun:
    """Jax-free builder: sleep-bound Gaussian sampler (tests/benchmarks).

    The service's scheduling, fairness, extend/fork, and durability
    behavior is about the transport — this builder keeps those tests and
    the Table XIV throughput benchmark free of XLA compilation.  The run
    key is still derived from critical data only (system/method/tau/
    n_det), so extend hits the same key and a changed critical field
    forks to a fresh one.
    """
    from repro_torch.runtime.testing import GaussianSampler
    tau = spec.tau or 0.3
    sampler = GaussianSampler(true_energy=-3.0, sigma=0.5, delay=0.002,
                              n_walkers=spec.n_walkers,
                              samples_per_subblock=max(8, spec.steps))
    run_key = critical_data_key(system=spec.system, method=spec.method,
                                tau=tau, n_det=spec.n_det,
                                sampler='gaussian')
    db.register_run(run_key, spec=spec_to_payload(spec))
    control = RunControl(max_blocks=spec.max_blocks,
                         target_error=spec.target_error,
                         wall_clock_limit=spec.wall_clock_limit,
                         poll_interval=spec.poll_interval,
                         subblocks_per_block=spec.subblocks_per_block)
    mgr = QMCManager(sampler, run_key, control, db=db, seed=spec.seed,
                     backend=ThreadBackend(spec.n_workers),
                     n_kept=spec.n_kept)
    return QMCRun(spec=spec, run_key=run_key, cfg=None, params=None,
                  sampler=sampler, db=db, manager=mgr)


class _Task:
    """One submitted run: spec + lifecycle state + live stack + listeners."""

    def __init__(self, run_id: str, spec: RunSpec,
                 parent_key: str | None = None):
        self.run_id = run_id
        self.spec = spec
        self.parent_key = parent_key
        self.state = QUEUED
        self.run: QMCRun | None = None
        self.run_key: str | None = None
        self.lease = 0
        self.cancel = threading.Event()
        self.done_evt = threading.Event()
        self.thread: threading.Thread | None = None
        self.error = ''
        self.submitted = time.time()
        self.finished: float | None = None
        self.subscribers: list[queue.Queue] = []

    def snapshot(self, store: ResultDatabase) -> dict:
        """JSON-safe status dict (the one shape status/watch/wait return)."""
        d = dict(run_id=self.run_id, run_key=self.run_key or '',
                 state=self.state, parent_key=self.parent_key or '',
                 lease=int(self.lease), detail=self.error,
                 n_blocks=0, weight=0.0, energy=None, error_bar=None)
        if self.run_key:
            avg = store.running_average(self.run_key)
            d['n_blocks'] = int(avg.n_blocks)
            d['weight'] = float(avg.weight)
            if avg.n_blocks:
                e, err = float(avg.energy), float(avg.error)
                d['energy'] = e if e == e else None          # NaN -> None
                d['error_bar'] = err if err == err else None
        return d


class QMCService:
    """The multi-tenant engine: job queue + fair-share pool + live stats.

    ``db`` is the durable store path (':memory:' for tests); every run
    this service executes lands in it, registered under its run key with
    its declarative spec payload — which is what makes ``extend``/
    ``fork`` possible after a restart.  ``total_workers`` bounds the
    worker pool across *all* concurrent runs; ``max_active`` bounds how
    many runs hold leases at once (default: one per pool worker).
    ``builder`` injects the spec -> stack compiler (``default_builder``
    unless testing).
    """

    def __init__(self, db: str = ':memory:', total_workers: int = 4,
                 builder=None, poll_interval: float = 0.05,
                 max_active: int = 0, quota_blocks: int = 0):
        self.store = ResultDatabase(db, require_registered=True)
        self.total_workers = int(total_workers)
        self.max_active = int(max_active) or self.total_workers
        self.poll_interval = float(poll_interval)
        self.quota_blocks = int(quota_blocks)
        self._builder = builder or default_builder
        self._tasks: dict[str, _Task] = {}
        self._order: list[str] = []
        self._next_id = 1
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._sched: threading.Thread | None = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Start the scheduler thread (idempotent; submit auto-starts)."""
        with self._lock:
            if self._sched is None:
                self._sched = threading.Thread(
                    target=self._schedule_loop, daemon=True,
                    name='qmc-service-scheduler')
                self._sched.start()

    def close(self, timeout: float = 30.0) -> None:
        """Cancel every active run, drain drive threads, close the store."""
        with self._lock:
            tasks = list(self._tasks.values())
        for t in tasks:
            if t.state not in FINAL_STATES:
                self.cancel(t.run_id)
        self._stop.set()
        for t in tasks:
            if t.thread is not None:
                t.thread.join(timeout)
        if self._sched is not None:
            self._sched.join(timeout)
        self.store.close()

    # -- submission API ---------------------------------------------------
    def submit(self, spec, parent_key: str | None = None) -> str:
        """Queue a run; returns its run id immediately.

        ``spec`` is a RunSpec or a plain payload dict (the wire form) —
        payloads pass through the strict ``spec_from_payload`` whitelist.
        """
        if not isinstance(spec, RunSpec):
            spec = spec_from_payload(spec)
        with self._lock:
            run_id = f'r{self._next_id}'
            self._next_id += 1
            task = _Task(run_id, spec, parent_key=parent_key)
            self._tasks[run_id] = task
            self._order.append(run_id)
        self.start()
        return run_id

    def extend(self, key: str, extra_blocks: int) -> str:
        """Continue a stored run: same key, ``stored + extra`` max blocks.

        The stored spec payload is rebuilt and re-submitted; because the
        critical data is unchanged, the new job appends under the same
        run key and the running average continues bitwise from the
        stored sufficient statistics.
        """
        key = self._resolve_key(key)
        payload = self.store.get_run_spec(key)
        if payload is None:
            raise KeyError(f'no stored spec for run key {key!r}')
        spec = spec_from_payload(payload)
        # fold the stored history into one running-average segment first:
        # the stored average becomes the bitwise prefix of every query
        # made while (and after) the extension appends fresh blocks
        self.store.compact(key)
        stored = self.store.n_blocks(key)
        return self.submit(spec.replace(
            max_blocks=stored + max(1, int(extra_blocks))))

    def fork(self, key: str, **overrides) -> str:
        """New run from a stored spec with changed fields, reservoir-seeded.

        A changed *critical* field (tau, system, n_det, ...) yields a
        fresh run key; the child starts from the parent's walker
        reservoir (warm equilibration) but accumulates independently.
        """
        key = self._resolve_key(key)
        payload = self.store.get_run_spec(key)
        if payload is None:
            raise KeyError(f'no stored spec for run key {key!r}')
        spec = spec_from_payload(payload).replace(**overrides)
        return self.submit(spec, parent_key=key)

    def cancel(self, run_id: str) -> dict:
        """Stop a run at its next poll (queued runs cancel instantly)."""
        task = self._get(run_id)
        with self._lock:
            if task.state == QUEUED:
                task.state = CANCELLED
                task.finished = time.time()
                task.done_evt.set()
                self._publish(task, 'state')
            elif task.state not in FINAL_STATES:
                task.cancel.set()
                if task.run is not None:
                    task.run.manager.request_stop()
        return self.status(run_id)

    # -- observation API --------------------------------------------------
    def status(self, run_id: str) -> dict:
        """Status snapshot for a run id (or a run key of a known task)."""
        return self._get(run_id).snapshot(self.store)

    def list_runs(self) -> list[dict]:
        """Status snapshots for every submitted run, submission order."""
        with self._lock:
            tasks = [self._tasks[rid] for rid in self._order]
        return [t.snapshot(self.store) for t in tasks]

    def subscribe(self, run_id: str) -> queue.Queue:
        """Live event queue for a run (block stats + state transitions).

        Events are status snapshots plus an ``event`` tag ('stats' or
        'state'); the queue is bounded and *lossy* under backpressure —
        a slow subscriber drops intermediate stats, never blocks the
        drive loop.  A final-state event always terminates the stream.
        """
        task = self._get(run_id)
        q: queue.Queue = queue.Queue(maxsize=512)
        with self._lock:
            task.subscribers.append(q)
            if task.state in FINAL_STATES:      # already over: replay end
                q.put_nowait(dict(task.snapshot(self.store), event='state'))
        return q

    def unsubscribe(self, run_id: str, q: queue.Queue) -> None:
        """Detach a subscriber queue."""
        task = self._get(run_id)
        with self._lock:
            if q in task.subscribers:
                task.subscribers.remove(q)

    def wait(self, run_id: str, timeout: float | None = None) -> dict:
        """Block until the run reaches a final state; returns its status."""
        task = self._get(run_id)
        task.done_evt.wait(timeout)
        return task.snapshot(self.store)

    # -- internals --------------------------------------------------------
    def _get(self, run_id: str) -> _Task:
        """Look up a task by run id, or by run key (latest submission)."""
        with self._lock:
            if run_id in self._tasks:
                return self._tasks[run_id]
            for rid in reversed(self._order):    # accept run keys too
                if self._tasks[rid].run_key == run_id:
                    return self._tasks[rid]
        raise KeyError(f'unknown run {run_id!r}')

    def _resolve_key(self, key: str) -> str:
        """Map a run id or run key to a run key present in the store."""
        with self._lock:
            if key in self._tasks:
                rk = self._tasks[key].run_key
                if rk is None:
                    raise KeyError(f'run {key!r} has not built yet — '
                                   'extend/fork need its run key')
                return rk
        if not self.store.known_run(key):
            raise KeyError(f'unknown run key {key!r}')
        return key

    def _publish(self, task: _Task, event: str) -> None:
        """Fan a tagged status snapshot out to the task's subscribers."""
        snap = dict(task.snapshot(self.store), event=event)
        with self._lock:
            subs = list(task.subscribers)
        for q in subs:
            try:
                q.put_nowait(snap)
            except queue.Full:       # lossy by design: drop, never block
                pass

    def _schedule_loop(self) -> None:
        """Admit queued runs and re-lease the pool, once per poll."""
        while not self._stop.is_set():
            with self._lock:
                tasks = [self._tasks[rid] for rid in self._order]
                active = [t for t in tasks if t.state == RUNNING]
                for t in tasks:
                    if t.state != QUEUED or len(active) >= self.max_active:
                        continue
                    t.state = RUNNING
                    t.thread = threading.Thread(
                        target=self._drive, args=(t,), daemon=True,
                        name=f'qmc-run-{t.run_id}')
                    t.thread.start()
                    active.append(t)
                shares = fair_shares(
                    self.total_workers,
                    {t.run_id: max(1, t.spec.n_workers) for t in active})
                for t in active:
                    t.lease = shares.get(t.run_id, 0)
            self._stop.wait(self.poll_interval)

    def _drive(self, task: _Task) -> None:
        """Per-run thread: build, seed, poll/resize/publish, shut down."""
        try:
            run = self._builder(task.spec, self.store)
            task.run = run
            task.run_key = run.run_key
            if self.quota_blocks:
                self.store.set_quota(run.run_key, self.quota_blocks)
            if (task.parent_key
                    and self.store.load_reservoir(run.run_key) is None):
                res = self.store.load_reservoir(task.parent_key)
                if res is not None:          # warm-start the fork
                    self.store.save_reservoir(run.run_key, *res)
            self._publish(task, 'state')
            if task.spec.method == 'opt-vmc':
                # the optimization loop owns its own worker/param cycle;
                # cancel lands between parameter steps via request_stop
                run.run()
            else:
                self._poll_loop(task, run)
            task.state = CANCELLED if task.cancel.is_set() else DONE
        except Exception:
            task.error = traceback.format_exc()
            task.state = FAILED
        finally:
            task.lease = 0
            task.finished = time.time()
            task.done_evt.set()
            self._publish(task, 'state')

    def _poll_loop(self, task: _Task, run: QMCRun) -> None:
        """Drive one sampling run: resize to lease, poll, publish, stop."""
        mgr = run.manager
        last_n = -1
        while True:
            self._resize(task, mgr)
            avg = mgr.poll()
            if avg.n_blocks != last_n:
                last_n = avg.n_blocks
                self._publish(task, 'stats')
            if (task.cancel.is_set() or self._stop.is_set()
                    or mgr.should_stop(avg)):
                break
            time.sleep(self.poll_interval)
        mgr.shutdown()

    @staticmethod
    def _resize(task: _Task, mgr: QMCManager) -> None:
        """Converge the run's live workers toward its current lease."""
        live = [w for w in mgr.workers if w.running]
        want = max(0, int(task.lease))
        for _ in range(want - len(live)):
            mgr.add_worker()
        for w in live[want:]:
            mgr.remove_worker(w, graceful=True)
