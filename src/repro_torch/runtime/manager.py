"""Manager (paper §V.D/fig. 3): orchestrates a fault-tolerant run.

Responsibilities (paper-faithful):
  * spawn the data server (root forwarder + database) and the forwarder tree;
  * start workers — on any ``ExecutorBackend`` substrate (threads,
    processes, simulated grid) — with collision-free RNG streams (fold_in
    on worker id) and reservoir-sampled initial walkers;
  * periodically query the database, compute the running average, decide the
    running/stopping state (wall-clock limit, error-bar target, block count);
  * E_T feedback for DMC (between blocks — never inside one);
  * elastic scaling: `add_worker` at any time; worker death is tolerated by
    construction (its un-flushed block is simply absent from the database);
  * termination: signal all workers, wait for the truncated-block flush to
    drain through the tree, checkpoint the walker reservoir.

The manager is written purely against the ``ExecutorBackend``/
``WorkerHandle`` interface (runtime.backends), so elastic scaling and the
termination walk are uniform across substrates.  The declarative front
door is ``launch.spec.RunSpec`` -> ``build_run``; constructing a manager
directly is the engine-level API (tests, embedding).
"""
from __future__ import annotations

import dataclasses
import time
import uuid

import numpy as np

from repro_torch.runtime.backends import ExecutorBackend, ThreadBackend, \
    WorkerHandle
from repro_torch.runtime.blocks import RunningAverage
from repro_torch.runtime.database import ResultDatabase
from repro_torch.runtime.forwarder import Forwarder, build_tree
from repro_torch.runtime.worker import Sampler


@dataclasses.dataclass(frozen=True)
class RunControl:
    """Substrate-agnostic run control: stopping criteria + polling.

    Resource layout (worker count, process vs thread, grid pathologies)
    lives on the ``ExecutorBackend``; tree shape lives on the manager.
    """

    max_blocks: int = 0              # stop after this many blocks (0: off)
    target_error: float = 0.0        # stop when stderr below this (0: off)
    wall_clock_limit: float = 0.0    # seconds (0: off)
    poll_interval: float = 0.05
    subblocks_per_block: int = 4
    e_trial_feedback: bool = False   # DMC E_T update between polls; the
    #                                  damping lives on DMCPropagator (the
    #                                  one knob), not here


class QMCManager:
    def __init__(self, sampler: Sampler, run_key: str,
                 control: RunControl | None = None,
                 db: ResultDatabase | None = None, seed: int = 0,
                 backend: ExecutorBackend | None = None,
                 n_forwarders: int = 0, n_kept: int | None = None,
                 drain_timeout: float | None = None):
        self.sampler = sampler
        self.run_key = run_key
        self.control = control or RunControl()
        self.backend = backend or ThreadBackend()
        self.db = db or ResultDatabase()
        self.n_kept = n_kept = 64 if n_kept is None else n_kept
        self.drain_timeout = 3.0 if drain_timeout is None else drain_timeout
        n_fwd = n_forwarders or (self.backend.n_workers + 1)
        self.tree: list[Forwarder] = build_tree(n_fwd, self.db,
                                                n_kept=n_kept)
        self.workers: list[WorkerHandle] = []
        self._seed = seed
        self._next_worker_id = 0
        self._t0 = time.monotonic()
        # tick-driven liveness journal: backends report joins, deaths,
        # reconnects, and stolen leases here (grid elasticity makes the
        # roster a time series, not a constant)
        self.events: list[tuple[float, str, int, str]] = []
        # unique job identity: lets independent clusters / restarted runs
        # write the same (worker, block) counters without key collisions,
        # while true replays (merging the same DB twice) still dedupe.
        self.job_id = uuid.uuid4().hex[:12]
        self._stop_requested = False

    # -- elastic resources ----------------------------------------------------
    def add_worker(self, init_walkers: np.ndarray | None = None
                   ) -> WorkerHandle:
        """Join a new computational resource to the running calculation."""
        wid = self._next_worker_id
        self._next_worker_id += 1
        fwd = self.tree[1 + wid % (len(self.tree) - 1)] \
            if len(self.tree) > 1 else self.tree[0]
        if init_walkers is None:
            res = self.db.load_reservoir(self.run_key)
            if res is not None:
                rng = np.random.default_rng(self._seed + 7777 + wid)
                r = self.tree[0].reservoir
                if len(r) == 0:
                    r.add(res[0], res[1])
                init_walkers = r.sample(16, rng)
        # one base seed for the run; per-worker/per-sub-block streams are
        # derived by fold_in(PRNGKey(seed), worker_id/step) in the sampler,
        # so streams never collide however many workers or blocks a run has
        w = self.backend.spawn(
            wid, self.sampler, self.run_key, fwd, seed=self._seed,
            subblocks_per_block=self.control.subblocks_per_block,
            init_walkers=init_walkers, job=self.job_id)
        self.workers.append(w)
        return w

    def remove_worker(self, worker: WorkerHandle,
                      graceful: bool = True) -> None:
        """Best-effort-mode preemption (graceful) or failure (not)."""
        if graceful:
            worker.stop()
        else:
            worker.crash()

    # -- run loop ---------------------------------------------------------
    def start(self) -> None:
        for _ in range(self.backend.n_workers):
            self.add_worker()

    def reset_wall_clock(self) -> None:
        """Restart the wall-clock-limit budget from now.

        The budget normally starts at construction (a batch-system
        allocation includes startup), but slow-booting substrates (the
        process backend spawns interpreters) may prefer to start it once
        workers report ready."""
        self._t0 = time.monotonic()

    @property
    def n_running(self) -> int:
        """Workers currently live (the lease-resizing observable)."""
        return sum(1 for w in self.workers if w.running)

    def request_stop(self) -> None:
        """Ask the run to stop at the next poll (cancel from outside).

        Thread-safe by construction (a single bool flip); ``should_stop``
        honors it on every substrate, so a service can cancel a run it is
        driving without reaching into worker handles.
        """
        self._stop_requested = True

    def should_stop(self, avg: RunningAverage) -> bool:
        c = self.control
        if self._stop_requested:
            return True
        if c.wall_clock_limit and (time.monotonic() - self._t0
                                   > c.wall_clock_limit):
            return True
        if c.max_blocks and avg.n_blocks >= c.max_blocks:
            return True
        if c.target_error and avg.n_blocks >= 8 and avg.error < c.target_error:
            return True
        return False

    def broadcast_params(self, version: int, vec) -> None:
        """Broadcast a versioned wavefunction-parameter vector (opt-vmc).

        Delivered to every running worker through its handle's
        ``send_params`` (thread mailbox / process control queue / grid
        PARAMS packet) and recorded on the backend (when it supports
        ``set_current_params``) so late joiners and reconnects receive
        the current version in their WELCOME.
        """
        vec = np.asarray(vec, np.float64)
        set_current = getattr(self.backend, 'set_current_params', None)
        if set_current is not None:
            set_current(version, vec)
        for w in self.workers:
            if w.running:
                w.send_params(version, vec)

    def poll(self) -> RunningAverage:
        self.backend.tick(self)
        avg = self.db.running_average(self.run_key)
        if (self.control.e_trial_feedback and avg.n_blocks > 0
                and np.isfinite(avg.energy)):
            for w in self.workers:
                if w.running:
                    w.send_e_trial(avg.energy)
        return avg

    def run(self) -> RunningAverage:
        """Blocking run to completion. Returns the final running average."""
        if not self.workers:
            self.start()
        while True:
            time.sleep(self.control.poll_interval)
            avg = self.poll()
            if self.should_stop(avg):
                break
            if self.workers and all(not w.running for w in self.workers):
                break                              # everything died/finished
            # (an empty roster keeps polling: an elastic backend may still
            # adopt workers — the stopping criteria bound the wait)
        return self.shutdown()

    def shutdown(self) -> RunningAverage:
        """Paper's termination walk: signal workers -> flush -> drain tree.

        Identical on every substrate: stop (flushes truncated blocks),
        join, tear down the backend transport, drain the tree leaves-first
        so final pushes travel through still-live ancestors, checkpoint
        the walker reservoir.
        """
        for w in self.workers:
            w.stop()
        for w in self.workers:
            w.join()
        self.backend.shutdown()
        deadline = time.monotonic() + self.drain_timeout
        # drain: wait until the root has absorbed in-flight packets
        last = -1
        while time.monotonic() < deadline:
            n = self.db.n_blocks(self.run_key)
            if n == last:
                break
            last = n
            time.sleep(0.1)
        # stop leaves first so final walker/block pushes drain through
        # still-live ancestors; the root (data server) goes down last.
        for f in reversed(self.tree[1:]):
            f.stop()
        time.sleep(0.1)                            # let the root drain
        self.tree[0].stop()
        # checkpoint the stratified walker reservoir
        w, e = self.tree[0].reservoir.state()
        if w is not None:
            self.db.save_reservoir(self.run_key, w, e)
        return self.db.running_average(self.run_key)

    # -- liveness journal ---------------------------------------------------
    def record_event(self, kind: str, worker_id: int = -1,
                     detail: str = '') -> None:
        """Append one liveness event (join/dead/reconnect/steal/...).

        Called by backends from ``tick`` — the journal is the audit trail
        for elastic runs (who joined when, who was declared dead and why).
        """
        self.events.append((time.monotonic(), str(kind), int(worker_id),
                            str(detail)))

    # -- fault injection (tests / chaos drills) -----------------------------
    def kill_forwarder(self, idx: int) -> None:
        self.tree[idx].kill()

    def worker_errors(self) -> list[str]:
        """Worker tracebacks + spawn-retry attempt histories.

        A worker that needed spawn retries (ProcessBackend backoff) shows
        its per-attempt failures here even when it eventually came up —
        silent retries would hide a sick node."""
        errs = [w.error for w in self.workers if w.error]
        for w in self.workers:
            for i, a in enumerate(getattr(w, 'spawn_attempts', ()) or ()):
                errs.append(f'worker {w.worker_id} spawn attempt '
                            f'{i + 1} failed: {a}')
        return errs
