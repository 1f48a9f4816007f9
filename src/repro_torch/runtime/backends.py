"""Pluggable execution substrates for the QMC runtime (paper §V).

The paper's fourth pillar is a framework "adapted to all kinds of
computational platforms (massively parallel machines, clusters, or
distributed grids)".  This module makes that platform axis a first-class
API: an ``ExecutorBackend`` turns (sampler, forwarder) pairs into running
workers on some substrate, and ``QMCManager`` is written purely against the
backend interface — elastic scaling, E_T feedback, and the termination /
drain walk are uniform across substrates.

Four substrates ship (the fourth, the real multi-host TCP ``GridBackend``,
lives in ``runtime.grid`` and registers here under ``'grid'``):

* ``ThreadBackend``   — workers are daemon threads in this process (the
  samplers release the GIL inside XLA).  The default; identical to the
  pre-backend runtime.
* ``ProcessBackend``  — workers are separate OS processes (``spawn``
  start method: no forking a live JAX runtime).  Each child runs the same
  block loop and ships zlib-compressed pickled block packets through a
  per-worker queue; a host-side pump thread routes them into the forwarder
  tree.  Real isolation, true multi-core: a ``crash()`` is a SIGKILL.
* ``GridBackend``     — (runtime.grid) real multi-host workers over TCP:
  heartbeats, exponential-backoff reconnect, elastic join/leave, and
  rate-proportional sub-block leases with work stealing.
* ``SimGridBackend``  — a deterministic *simulated* distributed grid:
  thread workers whose links to the forwarder tree are wrapped in lossy,
  latent ``SimChannel``s (seeded per-channel RNG for packet drop), plus a
  chaos schedule that kills workers after a block quota and forwarders
  after a database block count.  Makes the paper's fault-tolerance claims
  unit-testable as repeatable chaos drills.

All three leave the data plane (forwarder tree, database, reservoir) on
the host, so the unbiasedness contract — any block may be dropped,
truncated, or added — is enforced by one code path.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import pickle
import queue
import threading
import time
import traceback
import zlib
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.runtime.blocks import BlockAccumulator
from repro_torch.runtime.forwarder import Forwarder
from repro_torch.runtime.worker import Sampler, Worker


@runtime_checkable
class WorkerHandle(Protocol):
    """Uniform view of one running worker, whatever the substrate.

    ``stop`` flushes the in-flight partial block then exits (SIGTERM
    analogue); ``crash`` is a hard death with no flush (node failure);
    ``send_e_trial`` delivers between-block scalar feedback;
    ``send_params`` delivers a versioned wavefunction-parameter vector
    (the opt-vmc broadcast — applied between blocks, stamped into every
    subsequent block's aux).
    """

    worker_id: int
    init_walkers: np.ndarray | None
    error: str | None

    @property
    def running(self) -> bool: ...

    def stop(self) -> None: ...

    def crash(self) -> None: ...

    def join(self, timeout: float = 10.0) -> None: ...

    def send_e_trial(self, e_trial: float) -> None: ...

    def send_params(self, version: int, vec) -> None: ...


@runtime_checkable
class ExecutorBackend(Protocol):
    """One execution substrate: spawns workers against the forwarder tree.

    ``n_workers`` is the initial resource allocation (the manager's
    ``start`` spawns that many; ``add_worker`` may spawn more at any time).
    ``tick`` runs once per manager poll (chaos schedules, transport
    bookkeeping); ``shutdown`` tears the transport down after every worker
    has been joined but *before* the forwarder tree drains, so in-flight
    packets still reach the database.
    """

    name: str
    n_workers: int

    def spawn(self, worker_id: int, sampler: Sampler, run_key: str,
              forwarder: Forwarder, *, seed: int, subblocks_per_block: int,
              init_walkers: np.ndarray | None, job: str) -> WorkerHandle: ...

    def tick(self, manager) -> None: ...

    def shutdown(self) -> None: ...


# ---------------------------------------------------------------------------
# thread substrate (default — the pre-backend behavior)
# ---------------------------------------------------------------------------
class ThreadBackend:
    """In-process daemon-thread workers (XLA releases the GIL)."""

    name = 'thread'

    def __init__(self, n_workers: int = 4):
        self.n_workers = int(n_workers)

    def spawn(self, worker_id: int, sampler: Sampler, run_key: str,
              forwarder: Forwarder, *, seed: int, subblocks_per_block: int,
              init_walkers=None, job: str = '') -> Worker:
        w = Worker(worker_id, sampler, run_key, forwarder, seed=seed,
                   subblocks_per_block=subblocks_per_block,
                   init_walkers=init_walkers, job=job)
        w.start()
        return w

    def tick(self, manager) -> None:
        pass

    def shutdown(self) -> None:
        pass


# ---------------------------------------------------------------------------
# process substrate (true multi-core; spawn, never fork a live JAX runtime)
# ---------------------------------------------------------------------------
def _encode(kind: str, payload) -> bytes:
    """zlib-compressed pickle — the paper compresses all transfers."""
    return zlib.compress(pickle.dumps((kind, payload)))


def _decode(data: bytes):
    return pickle.loads(zlib.decompress(data))


def _process_worker_main(worker_id: int, sampler: Sampler, run_key: str,
                         seed: int, subblocks_per_block: int,
                         init_walkers, job: str, up_q, ctrl_q) -> None:
    """Child-process block loop: the paper's `while True: compute; send`.

    Mirrors ``Worker._run`` but egress is pickled packets on ``up_q``
    instead of direct forwarder calls.  Runs top-level so the ``spawn``
    start method can import it by reference.
    """
    def drain_ctrl(e_trial, params_upd):
        """Empty the control mailbox: -> (stop_seen, e_trial, params_upd).

        Always drains *everything* pending — E_T feedback arrives every
        manager poll, so a one-message-per-check scheme would let the
        backlog grow and bury a later 'stop' behind stale feedback.
        Parameter broadcasts keep only the newest (version, vec) pair and
        are applied between blocks only.
        """
        stop_seen = False
        while True:
            try:
                msg = ctrl_q.get_nowait()
            except queue.Empty:
                return stop_seen, e_trial, params_upd
            if msg[0] == 'stop':
                stop_seen = True
            elif msg[0] == 'e_trial':
                e_trial = msg[1]
            elif msg[0] == 'params':
                params_upd = (msg[1], msg[2])

    try:
        state = sampler.init_state(worker_id, seed, init_walkers)
        up_q.put(_encode('ready', worker_id))  # boot done (spawn is slow)
        step = 0
        blocks_done = 0
        stop = False
        e_trial = None
        params_upd = None
        while not stop:
            stop, e_trial, params_upd = drain_ctrl(e_trial, params_upd)
            if stop:
                break
            if e_trial is not None:
                state = sampler.set_e_trial(state, e_trial)
                e_trial = None
            if params_upd is not None:
                apply = getattr(sampler, 'apply_params', None)
                if apply is not None:
                    apply(*params_upd)
                params_upd = None
            acc = BlockAccumulator()
            walkers = energies = None
            for _ in range(subblocks_per_block):
                state, sub, walkers, energies = \
                    sampler.run_subblock(state, step)
                step += 1
                acc = acc.merge(sub)
                stop, e_trial, params_upd = drain_ctrl(e_trial, params_upd)
                if stop:
                    break                  # truncated block: flush below
            if acc.is_valid():
                blk = acc.to_block(run_key, worker_id, blocks_done, job=job)
                up_q.put(_encode('blocks', [blk]))
                if walkers is not None:
                    up_q.put(_encode('walkers',
                                     (np.asarray(walkers),
                                      np.asarray(energies))))
                blocks_done += 1
    except Exception:
        up_q.put(_encode('error', traceback.format_exc()))


class ProcessWorkerHandle:
    """Host-side handle for one worker process + its packet queues."""

    def __init__(self, worker_id: int, process, up_q, ctrl_q, forwarder,
                 init_walkers):
        self.worker_id = worker_id
        self.process = process
        self.up_q = up_q
        self.ctrl_q = ctrl_q
        self.forwarder = forwarder
        self.init_walkers = init_walkers
        self.error: str | None = None
        self.ready = False             # child finished its (slow) boot
        self.blocks_done = 0
        self.packets_corrupt = 0       # dropped undecodable packets
        self.spawn_attempts: list[str] = []   # failed-then-retried spawns

    @property
    def running(self) -> bool:
        return self.process.is_alive()

    def stop(self) -> None:
        try:
            self.ctrl_q.put(('stop',))
        except ValueError:                     # queue already closed
            pass

    def crash(self) -> None:
        """Hard node failure: SIGKILL — nothing is flushed."""
        self.process.kill()

    def join(self, timeout: float = 10.0) -> None:
        self.process.join(timeout)
        if self.process.is_alive():            # unresponsive: force it down
            self.process.terminate()
            self.process.join(1.0)

    def send_e_trial(self, e_trial: float) -> None:
        try:
            self.ctrl_q.put(('e_trial', float(e_trial)))
        except ValueError:
            pass

    def send_params(self, version: int, vec) -> None:
        try:
            self.ctrl_q.put(('params', int(version),
                             np.asarray(vec, np.float64)))
        except ValueError:
            pass

    def pump(self) -> int:
        """Route this worker's pending packets into its forwarder.

        A packet that fails to decode (a SIGKILL'd child can corrupt its
        queue mid-write) is *dropped*, not fatal: the same unbiasedness
        contract that tolerates a dead worker's absent block covers a
        corrupted transfer, and one bad packet must never kill the pump
        thread every live worker shares.
        """
        n = 0
        while True:
            try:
                data = self.up_q.get_nowait()
            except (queue.Empty, OSError, ValueError):
                break
            n += 1
            try:
                kind, payload = _decode(data)
            except Exception:
                self.packets_corrupt += 1
                continue
            if kind == 'blocks':
                self.forwarder.submit_blocks(payload)
                self.blocks_done += 1
            elif kind == 'walkers':
                self.forwarder.submit_walkers(*payload)
            elif kind == 'ready':
                self.ready = True
            elif kind == 'error':
                self.error = payload
        return n


class FailedSpawnHandle:
    """WorkerHandle for a worker that never came up (spawn exhausted).

    Keeps the manager's uniform bookkeeping: the handle is present (so
    ``worker_errors`` can report the attempt history) but never running,
    so the run proceeds on the workers that did spawn.
    """

    def __init__(self, worker_id: int, attempts: list[str],
                 init_walkers=None):
        self.worker_id = worker_id
        self.init_walkers = init_walkers
        self.spawn_attempts = list(attempts)
        self.error = (f'spawn failed after {len(attempts)} attempts: '
                      f'{attempts[-1] if attempts else "?"}')

    @property
    def running(self) -> bool:
        return False

    def stop(self) -> None:
        pass

    def crash(self) -> None:
        pass

    def join(self, timeout: float = 10.0) -> None:
        pass

    def send_e_trial(self, e_trial: float) -> None:
        pass

    def send_params(self, version: int, vec) -> None:
        pass


class ProcessBackend:
    """Workers as separate OS processes; packets pumped into the tree.

    The sampler is pickled into each child (``spawn`` start method), so it
    must be shipped *before* any host-side jit compilation — the
    ``EnsembleDriver`` drops its compiled-block cache on pickling, and a
    device-mesh sampler refuses to pickle (shard on the host instead).

    Spawning retries with exponential backoff (transient fork/exec
    failures — EAGAIN under process-count pressure — are the norm on
    loaded batch nodes, not the exception); the per-attempt failure
    history is kept on the handle and surfaced through
    ``QMCManager.worker_errors()``.
    """

    name = 'process'

    def __init__(self, n_workers: int = 4, start_method: str = 'spawn',
                 spawn_retries: int = 3, spawn_backoff: float = 0.05):
        self.n_workers = int(n_workers)
        self._ctx = mp.get_context(start_method)
        self.spawn_retries = int(spawn_retries)
        self.spawn_backoff = float(spawn_backoff)
        self.handles: list[ProcessWorkerHandle] = []
        self._pump_thread: threading.Thread | None = None
        self._pump_done = threading.Event()

    def spawn(self, worker_id: int, sampler: Sampler, run_key: str,
              forwarder: Forwarder, *, seed: int, subblocks_per_block: int,
              init_walkers=None, job: str = ''):
        attempts: list[str] = []
        delay = self.spawn_backoff
        proc = up_q = ctrl_q = None
        for _ in range(self.spawn_retries + 1):
            try:
                up_q = self._ctx.Queue()
                ctrl_q = self._ctx.Queue()
                proc = self._ctx.Process(
                    target=_process_worker_main,
                    args=(worker_id, sampler, run_key, seed,
                          subblocks_per_block, init_walkers, job, up_q,
                          ctrl_q),
                    daemon=True)
                proc.start()
                break
            except Exception as e:
                attempts.append(f'{type(e).__name__}: {e}')
                proc = None
                for q in (up_q, ctrl_q):
                    if q is not None:
                        try:
                            q.close()
                        except (OSError, ValueError):
                            pass
                up_q = ctrl_q = None
                time.sleep(delay)
                delay *= 2                     # exponential backoff
        if proc is None:                       # retries exhausted
            return FailedSpawnHandle(worker_id, attempts, init_walkers)
        h = ProcessWorkerHandle(worker_id, proc, up_q, ctrl_q, forwarder,
                                init_walkers)
        h.spawn_attempts = attempts            # non-empty iff retried
        self.handles.append(h)
        if self._pump_thread is None:
            self._pump_thread = threading.Thread(target=self._pump_loop,
                                                 daemon=True)
            self._pump_thread.start()
        return h

    def _pump_loop(self) -> None:
        while not self._pump_done.is_set():
            if not sum(h.pump() for h in self.handles):
                time.sleep(0.01)
        for h in self.handles:                 # final drain after join
            h.pump()

    def tick(self, manager) -> None:
        pass

    def shutdown(self) -> None:
        self._pump_done.set()
        if self._pump_thread is not None:
            self._pump_thread.join(5.0)
        for h in self.handles:
            h.pump()                           # anything the pump missed
            if h.process.is_alive():
                h.process.terminate()
            h.up_q.close()
            h.ctrl_q.close()


# ---------------------------------------------------------------------------
# simulated-grid substrate (chaos drills for the paper's §V claims)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SimGridConfig:
    """Injectable grid pathologies, all deterministic given ``seed``.

    ``worker_failures``: (worker_id, after_blocks) pairs — the worker is
    hard-crashed (no flush) once it has flushed that many blocks.
    ``forwarder_failures``: (tree_index, after_db_blocks) pairs — the
    forwarder is killed once the database holds that many blocks.
    """

    latency: float = 0.0           # seconds per worker->forwarder send
    drop_rate: float = 0.0         # per-packet Bernoulli loss probability
    seed: int = 0
    worker_failures: tuple = ()    # ((worker_id, after_blocks), ...)
    forwarder_failures: tuple = ()  # ((tree_index, after_db_blocks), ...)


class SimChannel:
    """Lossy, latent link between one worker and its forwarder.

    Implements the forwarder ingress interface, so a ``Worker`` submits
    through it unchanged.  Drops are drawn from a per-channel seeded RNG —
    the same spec replays the same packet loss.
    """

    def __init__(self, forwarder: Forwarder, rng: np.random.Generator,
                 latency: float = 0.0, drop_rate: float = 0.0):
        self.forwarder = forwarder
        self.rng = rng
        self.latency = float(latency)
        self.drop_rate = float(drop_rate)
        self.dropped = 0
        self.delivered = 0

    def _transmit(self, send) -> bool:
        if self.latency:
            time.sleep(self.latency)
        if self.drop_rate and self.rng.random() < self.drop_rate:
            self.dropped += 1          # lost in the grid: never counted,
            return True                # so the average stays unbiased
        self.delivered += 1
        return send()

    def submit_blocks(self, blocks) -> bool:
        return self._transmit(lambda: self.forwarder.submit_blocks(blocks))

    def submit_walkers(self, walkers, energies) -> bool:
        return self._transmit(
            lambda: self.forwarder.submit_walkers(walkers, energies))


class SimGridBackend:
    """Thread workers behind simulated grid links + a chaos schedule.

    The compute is real (same samplers); only the *transport* is simulated.
    ``tick`` — called once per manager poll — fires the failure schedule:
    worker crashes after a per-worker block quota, forwarder kills after a
    database block count.  Every fault path lands on the same unbiasedness
    contract the thread substrate uses, which is exactly the claim the
    chaos drill asserts.
    """

    name = 'sim'

    def __init__(self, n_workers: int = 4,
                 grid: SimGridConfig | None = None):
        self.n_workers = int(n_workers)
        self.grid = grid or SimGridConfig()
        self.channels: dict[int, SimChannel] = {}
        self.handles: dict[int, Worker] = {}
        self._fired: set = set()

    def spawn(self, worker_id: int, sampler: Sampler, run_key: str,
              forwarder: Forwarder, *, seed: int, subblocks_per_block: int,
              init_walkers=None, job: str = '') -> Worker:
        chan = SimChannel(
            forwarder,
            np.random.default_rng([self.grid.seed, worker_id]),
            latency=self.grid.latency, drop_rate=self.grid.drop_rate)
        self.channels[worker_id] = chan
        w = Worker(worker_id, sampler, run_key, chan, seed=seed,
                   subblocks_per_block=subblocks_per_block,
                   init_walkers=init_walkers, job=job)
        self.handles[worker_id] = w
        w.start()
        return w

    def tick(self, manager) -> None:
        """Fire the deterministic failure schedule (once per event)."""
        for wid, after_blocks in self.grid.worker_failures:
            w = self.handles.get(wid)
            if (('w', wid) not in self._fired and w is not None
                    and w.blocks_done >= after_blocks):
                w.crash()
                self._fired.add(('w', wid))
        n_db = manager.db.n_blocks(manager.run_key)
        for idx, after in self.grid.forwarder_failures:
            if ('f', idx) not in self._fired and n_db >= after:
                manager.kill_forwarder(idx)
                self._fired.add(('f', idx))

    def shutdown(self) -> None:
        pass

    # -- introspection (tests / reports) ---------------------------------
    def packets_dropped(self) -> int:
        return sum(c.dropped for c in self.channels.values())


def _make_grid(n_workers, net=None):
    """Lazy GridBackend factory (keeps this module socket-free)."""
    from repro_torch.runtime.grid import GridBackend
    return GridBackend(n_workers, net=net)


BACKENDS = {'thread': ThreadBackend, 'process': ProcessBackend,
            'sim': SimGridBackend, 'grid': _make_grid}


def make_backend(name: str, n_workers: int,
                 grid: SimGridConfig | None = None,
                 net=None) -> ExecutorBackend:
    """Backend factory for the string names the CLI / RunSpec use.

    ``grid`` configures the *simulated* grid substrate; ``net`` (a
    ``runtime.grid.GridConfig``) configures the real TCP grid backend.
    """
    if name not in BACKENDS:
        raise ValueError(f'unknown backend {name!r} '
                         f'(choose from {sorted(BACKENDS)})')
    if name == 'sim':
        return SimGridBackend(n_workers, grid=grid)
    if name == 'grid':
        return _make_grid(n_workers, net=net)
    return BACKENDS[name](n_workers)
