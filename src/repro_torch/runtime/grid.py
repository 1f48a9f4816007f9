"""Multi-host TCP grid backend (paper §V: dynamic, fault-tolerant workers).

The paper's framework ran QMC=Chem on 10k–80k cores with workers joining,
leaving, and dying mid-run.  This module is the real multi-host realization
of that claim for this repo: a manager-side ``GridBackend`` (implements the
``ExecutorBackend``/``WorkerHandle`` protocols) listens on a TCP socket,
and any host attaches a ``GridWorkerClient`` (CLI: ``repro.launch
.qmc_worker --connect host:port``) that runs the standard block loop and
ships results back as CRC-validated binary packets (``runtime.packets``).

Robustness model
----------------
* **Heartbeats**: each worker sends a heartbeat every
  ``heartbeat_interval`` from a dedicated thread (independent of compute).
  The manager declares a worker dead once ``now - last_seen >
  heartbeat_timeout``; a dead worker's in-flight partial block was never
  transmitted (blocks are sent only when complete or stop-truncated), so
  its exclusion is unbiased by the same argument as a SIGKILL'd process
  worker.
* **Reconnect with exponential backoff**: a worker that loses the link
  keeps its sampler state, reconnects with exponentially growing delays,
  and resumes under its previous ``(job, worker_id)`` identity.  It
  re-sends its last block packet on resume — the database primary key
  ``(run_key, job, worker_id, block_id)`` dedupes the replay.
* **Elastic join/leave**: an unclaimed HELLO is parked and adopted on the
  next manager tick via ``manager.add_worker`` — the run-key design lets
  any late worker extend the same ``RunningAverage``; reservoir-sampled
  restart walkers ride along in the WELCOME.
* **Load balancing / work stealing**: heartbeats report each worker's
  observed sub-block rate; the manager periodically re-sizes per-worker
  sub-block leases proportionally (fast workers run bigger blocks, slow
  workers flush smaller blocks at the same cadence) and requeues a dead
  worker's outstanding lease onto the fastest live worker (the assignment
  queue *is* the stealing mechanism).

The data plane stays on the host: decoded blocks are submitted into the
worker's assigned forwarder, so the tree/database/reservoir path — and its
unbiasedness contract — is byte-for-byte the one every other substrate
uses.  ``drop_rate`` injects seeded ingress packet loss for chaos drills
(parity with ``SimGridBackend``).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import select
import selectors
import socket
import struct
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

from repro_torch.runtime.blocks import BlockAccumulator
from repro_torch.runtime.database import SCHEMA_VERSION
from repro_torch.runtime.packets import (ASSIGN, BLOCKS, BYE, E_TRIAL, ERROR,
                                   HEARTBEAT, HELLO, PARAMS, STOP, WALKERS,
                                   WELCOME, FrameReader, PacketError,
                                   decode_blocks, decode_json, decode_params,
                                   decode_walkers, encode_blocks, encode_json,
                                   encode_params, encode_walkers, frame)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Transport layout + liveness policy for the TCP grid backend.

    ``local_workers``: ``spawn`` launches localhost ``qmc_worker``
    subprocesses (CI smoke / benchmarks); with it off the backend only
    adopts externally attached workers (``n_workers`` may then be 0).
    ``worker_args`` is appended to the spawned worker command line (e.g.
    ``('--sampler', 'gauss:delay=0.01')`` for transport drills).
    ``drop_rate`` drops ingress block packets with a per-worker seeded RNG
    — deterministic chaos, mirroring ``SimChannel``.
    """

    host: str = '127.0.0.1'
    port: int = 0                    # 0: ephemeral (read backend.address)
    heartbeat_interval: float = 0.1
    heartbeat_timeout: float = 2.0   # declared dead after this silence
    boot_timeout: float = 120.0      # spawned worker must HELLO by then
    rebalance_interval: float = 0.5  # lease re-sizing cadence
    max_subblock_scale: float = 4.0  # lease clamp: [1, scale * base]
    drop_rate: float = 0.0           # ingress block-packet loss (chaos)
    drop_seed: int = 0
    local_workers: bool = True
    worker_args: tuple = ()


# handle lifecycle: BOOTING -(hello)-> LIVE <-(eof/reconnect)-> LOST
#                   LIVE/LOST -(heartbeat timeout)-> DEAD
#                   LIVE -(bye)-> STOPPED
BOOTING, LIVE, LOST, DEAD, STOPPED = ('booting', 'live', 'lost', 'dead',
                                      'stopped')


class _Conn:
    """One accepted TCP connection: socket + frame parser + send lock."""

    def __init__(self, sock: socket.socket, sel=None):
        self.sock = sock
        self.sel = sel
        self.reader = FrameReader()
        self.handle: 'GridWorkerHandle | None' = None
        self._send_lock = threading.Lock()

    def send(self, kind: int, payload: bytes = b'') -> None:
        with self._send_lock:
            self.sock.sendall(frame(kind, payload))

    def close(self) -> None:
        # deregister BEFORE closing: a closed fd may be reused by the very
        # next accept, and a stale selector entry for it would poison the
        # serve loop
        if self.sel is not None:
            try:
                self.sel.unregister(self.sock)
            except (KeyError, ValueError, OSError):
                pass
        try:
            self.sock.close()
        except OSError:
            pass


class GridWorkerHandle:
    """Manager-side view of one grid worker (local subprocess or remote).

    Implements the ``WorkerHandle`` protocol.  ``crash()`` SIGKILLs a
    locally spawned worker process (a real node death for drills); for a
    purely remote worker it severs the connection (network partition) —
    either way the death is *detected* by heartbeat timeout, never
    assumed.
    """

    def __init__(self, worker_id: int, forwarder, *, seed: int,
                 subblocks: int, run_key: str, job: str,
                 init_walkers=None, proc: subprocess.Popen | None = None):
        self.worker_id = worker_id
        self.forwarder = forwarder
        self.seed = seed
        self.base_subblocks = int(subblocks)
        self.assigned_subblocks = int(subblocks)
        self.run_key = run_key
        self.job = job
        self.init_walkers = init_walkers
        self.proc = proc
        self.conn: _Conn | None = None
        self.state = BOOTING
        self.spawned_at = time.monotonic()
        self.last_seen = self.spawned_at
        self.blocks_done = 0            # worker-reported completed blocks
        self.blocks_received = 0        # block results landed host-side
        self.subblock_rate = 0.0        # worker-reported sub-blocks / s
        self.reconnects = 0
        self.stop_requested = False
        self.dead_reason = ''
        self.error: str | None = None
        self._finished = threading.Event()

    # -- WorkerHandle protocol -------------------------------------------
    @property
    def running(self) -> bool:
        return self.state in (BOOTING, LIVE, LOST)

    def stop(self) -> None:
        self.stop_requested = True
        self._send(STOP)

    def crash(self) -> None:
        if self.proc is not None:
            self.proc.kill()            # SIGKILL: a real hard node failure
        self.drop_connection()

    def join(self, timeout: float = 10.0) -> None:
        self._finished.wait(timeout)

    def send_e_trial(self, e_trial: float) -> None:
        self._send(E_TRIAL, struct.pack('>d', float(e_trial)))

    def send_params(self, version: int, vec) -> None:
        self._send(PARAMS, encode_params(version, np.asarray(vec)))

    # -- internals --------------------------------------------------------
    def _send(self, kind: int, payload: bytes = b'') -> None:
        conn = self.conn
        if conn is not None:
            try:
                conn.send(kind, payload)
            except OSError:
                pass                    # link loss is detected by heartbeat

    def drop_connection(self) -> None:
        """Sever the TCP link (chaos hook — forces a worker reconnect)."""
        conn, self.conn = self.conn, None
        if conn is not None:
            conn.close()
        if self.state == LIVE:
            self.state = LOST

    def mark_dead(self, reason: str) -> None:
        self.state = DEAD
        self.dead_reason = reason
        self.drop_connection()
        self._finished.set()

    def mark_stopped(self) -> None:
        self.state = STOPPED
        self._finished.set()


class GridBackend:
    """TCP-socket multi-host ``ExecutorBackend`` with elastic workers.

    A selector thread owns all socket reads (accept, frame parsing,
    dispatch); the manager thread drives policy through ``tick`` (adopt
    pending joins, declare heartbeat deaths, rebalance leases, surface
    events).  ``spawn`` either adopts a pending remote connection or —
    with ``local_workers`` — launches a localhost ``qmc_worker``
    subprocess pointed at the bound address.
    """

    name = 'grid'

    def __init__(self, n_workers: int = 2, net: GridConfig | None = None):
        self.n_workers = int(n_workers)
        self.net = net or GridConfig()
        self.handles: list[GridWorkerHandle] = []
        self.stolen_requeued = 0        # leases requeued from dead workers
        self.stolen_served = 0          # leases handed to a live worker
        self._stolen: collections.deque = collections.deque()
        self._pending: list[_Conn] = []
        self._events: collections.deque = collections.deque()
        self._lock = threading.RLock()
        self._run_payload: dict | None = None
        self._current_params: tuple[int, list] | None = None
        self._drop_rngs: dict[int, np.random.Generator] = {}
        self._dropped = 0
        self._next_rebalance = 0.0
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.net.host, self.net.port))
        self._listener.listen(64)
        self.address: tuple[str, int] = self._listener.getsockname()[:2]
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, None)
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()

    # -- run payload (what a spec-driven worker builds its sampler from) --
    def set_run_payload(self, payload: dict) -> None:
        """Physics/ensemble fields shipped in WELCOME so remote hosts can
        build the sampler locally (declarative — nothing jit'd crosses
        the wire)."""
        self._run_payload = dict(payload)

    def set_current_params(self, version: int, vec) -> None:
        """Record the current wavefunction-parameter broadcast (opt-vmc).

        Shipped in every subsequent WELCOME, so a worker that reconnects
        *or* joins elastically mid-optimization starts sampling at the
        current parameter version instead of the spec's initial one."""
        with self._lock:
            self._current_params = (int(version),
                                    np.asarray(vec, np.float64).tolist())

    # -- ExecutorBackend protocol ----------------------------------------
    def spawn(self, worker_id: int, sampler, run_key: str, forwarder, *,
              seed: int, subblocks_per_block: int, init_walkers=None,
              job: str = '') -> GridWorkerHandle:
        """Adopt a pending remote connection, or launch a local worker.

        The ``sampler`` argument is unused: grid workers construct their
        sampler worker-side (from the WELCOME run payload or their own
        CLI flags) — only declarative data crosses host boundaries.
        """
        with self._lock:
            pending = self._pending.pop(0) if self._pending else None
        h = GridWorkerHandle(worker_id, forwarder, seed=seed,
                             subblocks=subblocks_per_block, run_key=run_key,
                             job=job, init_walkers=init_walkers)
        if pending is not None:
            with self._lock:
                self.handles.append(h)
            self._bind(pending, h)
        else:
            if not self.net.local_workers:
                raise RuntimeError(
                    'no pending remote worker to adopt and local_workers '
                    'is off — start qmc_worker processes pointing at '
                    f'{self.address[0]}:{self.address[1]}')
            h.proc = self._launch_local(worker_id)
            with self._lock:
                self.handles.append(h)
        return h

    def tick(self, manager) -> None:
        """Once per manager poll: liveness, adoption, leases, events."""
        self._scan_liveness()
        # adopt externally attached workers (elastic join): each
        # add_worker pulls one parked connection through spawn()
        with self._lock:
            n_pending = len(self._pending)
        for _ in range(n_pending):
            manager.add_worker()
        self._rebalance()
        while True:
            with self._lock:
                if not self._events:
                    break
                kind, wid, detail = self._events.popleft()
            manager.record_event(kind, wid, detail)

    def shutdown(self) -> None:
        """Tear the transport down (workers already joined by the manager)."""
        self._done.set()
        self._thread.join(5.0)
        with self._lock:
            conns = list(self._pending)
            self._pending.clear()
        for c in conns:
            c.close()
        for h in self.handles:
            h.drop_connection()
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    h.proc.wait(timeout=2.0)
        try:
            self._sel.close()
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    # -- introspection (tests / reports) ----------------------------------
    def packets_dropped(self) -> int:
        """Ingress block packets dropped by chaos injection."""
        return self._dropped

    # -- local worker launch ----------------------------------------------
    def _launch_local(self, worker_id: int) -> subprocess.Popen:
        host, port = self.address
        cmd = [sys.executable, '-m', 'repro_torch.launch.qmc_worker',
               '--connect', f'{host}:{port}', '--claim', str(worker_id),
               *self.net.worker_args]
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))          # .../src
        env['PYTHONPATH'] = src + (os.pathsep + env['PYTHONPATH']
                                   if env.get('PYTHONPATH') else '')
        return subprocess.Popen(cmd, env=env)

    # -- serve loop (selector thread owns every socket read) --------------
    def _serve_loop(self) -> None:
        while not self._done.is_set():
            try:
                events = self._sel.select(timeout=0.05)
                for key, _ in events:
                    if key.data is None:
                        self._accept()
                    else:
                        self._service(key.data)
            except OSError:
                return
            except Exception:              # a sick connection must never
                continue                   # take the whole transport down
            self._scan_liveness()

    def _accept(self) -> None:
        try:
            sock, _addr = self._listener.accept()
        except OSError:
            return
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(sock, self._sel)
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _service(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._detach(conn, 'recv error')
            return
        if not data:
            self._detach(conn, 'eof')
            return
        conn.reader.feed(data)
        try:
            for kind, payload in conn.reader.frames():
                self._dispatch(conn, kind, payload)
        except PacketError as e:
            self._detach(conn, f'protocol violation: {e}')

    def _detach(self, conn: _Conn, reason: str) -> None:
        conn.close()                       # also deregisters from the selector
        with self._lock:
            if conn in self._pending:
                self._pending.remove(conn)
        h = conn.handle
        if h is not None and h.conn is conn:
            h.conn = None
            if h.state == LIVE:
                h.state = LOST
                self._event('disconnect', h.worker_id, reason)

    # -- frame dispatch ----------------------------------------------------
    def _dispatch(self, conn: _Conn, kind: int, payload: bytes) -> None:
        h = conn.handle
        if kind == HELLO:
            self._on_hello(conn, decode_json(payload))
            return
        if h is None:
            return                       # data before HELLO: ignore
        h.last_seen = time.monotonic()
        if kind == BLOCKS:
            if self._chaos_drop(h.worker_id):
                self._dropped += 1       # lost in the grid: never counted
                return
            blocks = decode_blocks(payload)
            h.blocks_received += len(blocks)
            h.forwarder.submit_blocks(blocks)
        elif kind == WALKERS:
            h.forwarder.submit_walkers(*decode_walkers(payload))
        elif kind == HEARTBEAT:
            beat = decode_json(payload)
            h.blocks_done = int(beat.get('blocks_done', h.blocks_done))
            h.subblock_rate = float(beat.get('rate', h.subblock_rate))
        elif kind == ERROR:
            h.error = payload.decode('utf-8', 'replace')
        elif kind == BYE:
            h.mark_stopped()
            self._detach(conn, 'bye')
            self._event('leave', h.worker_id, 'graceful')

    def _on_hello(self, conn: _Conn, hello: dict) -> None:
        resume = hello.get('resume')
        if resume is not None:
            with self._lock:
                match = [h for h in self.handles
                         if h.worker_id == int(resume.get('worker_id', -1))
                         and h.job == resume.get('job')
                         and h.state in (LIVE, LOST, BOOTING)]
            if match:
                h = match[0]
                h.reconnects += 1
                self._event('reconnect', h.worker_id,
                            f'attempt {h.reconnects}')
                self._bind(conn, h)
                return
            # unknown resume identity (e.g. manager restarted): fall
            # through and park it for adoption as a fresh worker
        claim = hello.get('claim')
        if claim is not None:
            with self._lock:
                match = [h for h in self.handles
                         if h.worker_id == int(claim) and h.state == BOOTING]
            if match:
                self._bind(conn, match[0])
                return
        with self._lock:
            self._pending.append(conn)   # adopted on the next manager tick
        self._event('hello', int(claim) if claim is not None else -1,
                    'parked for adoption')

    def _bind(self, conn: _Conn, h: GridWorkerHandle) -> None:
        old, h.conn = h.conn, conn       # rebind BEFORE detaching the old
        if old is not None and old is not conn:
            self._detach(old, 'superseded by reconnect')
        conn.handle = h
        was_booting = h.state == BOOTING
        h.state = LIVE
        h.last_seen = time.monotonic()
        welcome = dict(worker_id=h.worker_id, seed=h.seed,
                       run_key=h.run_key, job=h.job,
                       subblocks=h.assigned_subblocks,
                       heartbeat_interval=self.net.heartbeat_interval,
                       spec=self._run_payload,
                       # results-store schema this run writes into: a
                       # worker built against a newer store refuses to
                       # feed rows an older validator would reject
                       schema=SCHEMA_VERSION)
        with self._lock:
            params = self._current_params
        if params is not None:
            welcome['params_version'], welcome['params_vec'] = params
        if h.init_walkers is not None:
            welcome['init_walkers'] = np.asarray(h.init_walkers).tolist()
        try:
            conn.send(WELCOME, encode_json(welcome))
            if h.stop_requested:
                conn.send(STOP)
        except OSError:
            self._detach(conn, 'welcome send failed')
            return
        if was_booting:
            self._event('join', h.worker_id, 'worker attached')

    # -- policy (liveness, chaos, leases) ---------------------------------
    def _chaos_drop(self, worker_id: int) -> bool:
        if not self.net.drop_rate:
            return False
        rng = self._drop_rngs.get(worker_id)
        if rng is None:
            rng = np.random.default_rng([self.net.drop_seed, worker_id])
            self._drop_rngs[worker_id] = rng
        return bool(rng.random() < self.net.drop_rate)

    def _scan_liveness(self) -> None:
        now = time.monotonic()
        with self._lock:
            handles = list(self.handles)
        for h in handles:
            if h.state == BOOTING:
                if now - h.spawned_at > self.net.boot_timeout:
                    self._declare_dead(h, 'boot timeout')
            elif h.state in (LIVE, LOST):
                if now - h.last_seen > self.net.heartbeat_timeout:
                    self._declare_dead(h, 'heartbeat timeout')

    def _declare_dead(self, h: GridWorkerHandle, reason: str) -> None:
        h.mark_dead(reason)
        with self._lock:
            # work stealing: the dead worker's outstanding lease goes back
            # on the assignment queue for the next live worker
            self._stolen.append(h.assigned_subblocks)
            self.stolen_requeued += 1
        self._event('dead', h.worker_id, reason)

    def _rebalance(self) -> None:
        """Re-size sub-block leases by observed per-worker rates.

        ``rate`` is sub-blocks/s (capacity — invariant to the lease size
        itself), so the fixed point gives every worker the same block
        cadence: heterogeneous workers all flush at roughly the base
        cadence, fast ones with proportionally bigger blocks.
        """
        now = time.monotonic()
        if now < self._next_rebalance:
            return
        self._next_rebalance = now + self.net.rebalance_interval
        with self._lock:
            live = [h for h in self.handles
                    if h.state == LIVE and h.subblock_rate > 0]
            if not live:
                return
            mean = sum(h.subblock_rate for h in live) / len(live)
            fastest = max(live, key=lambda h: h.subblock_rate)
            bonus = 0
            while self._stolen:
                bonus += self._stolen.popleft()
                self.stolen_served += 1
            for h in live:
                hi = max(1, int(h.base_subblocks
                                * self.net.max_subblock_scale))
                target = min(hi, max(1, round(
                    h.base_subblocks * h.subblock_rate / mean)))
                extra = bonus if h is fastest else 0
                if target != h.assigned_subblocks or extra:
                    h.assigned_subblocks = target
                    h._send(ASSIGN, encode_json(
                        {'subblocks': target, 'bonus': extra}))

    def _event(self, kind: str, worker_id: int, detail: str = '') -> None:
        with self._lock:
            self._events.append((kind, worker_id, detail))


# ===========================================================================
# worker side
# ===========================================================================
class GridWorkerClient:
    """Worker-side grid client: the paper's `while True: compute; send`.

    Connects to a manager, runs the standard sub-block/block loop against
    a locally built sampler, and ships results as binary packets.  On any
    link loss it reconnects with exponential backoff, keeping its sampler
    state and ``(job, worker_id)`` identity so the run continues where it
    left off; an in-flight partial block is discarded (never sent — the
    unbiasedness contract covers its absence) and the last sent block
    packet is replayed after resume (the database dedupes it).
    """

    def __init__(self, address: tuple[str, int], sampler=None,
                 sampler_factory=None, *, claim: int | None = None,
                 heartbeat_interval: float | None = None,
                 max_retries: int = 10, backoff: float = 0.05,
                 backoff_max: float = 2.0, connect_timeout: float = 15.0,
                 max_blocks: int = 0):
        if sampler is None and sampler_factory is None:
            raise ValueError('need a sampler or a sampler_factory')
        self.address = address
        self.sampler = sampler
        self.sampler_factory = sampler_factory
        self.claim = claim
        self.heartbeat_interval = heartbeat_interval
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_max = float(backoff_max)
        self.connect_timeout = float(connect_timeout)
        self.max_blocks = int(max_blocks)
        # run identity / progress (survives reconnects)
        self.worker_id: int | None = None
        self.run_key = ''
        self.job = ''
        self.subblocks = 1
        self.blocks_done = 0
        self.subblocks_done = 0
        self.reconnects = 0
        self._state = None
        self._step = 0
        self._t0: float | None = None
        self._bonus = 0
        self._stop = False
        self._e_trial: float | None = None
        self._params_update: tuple | None = None
        self._last_packet: bytes | None = None

    # -- main entry --------------------------------------------------------
    def run(self) -> int:
        """Serve until stopped (or ``max_blocks``); returns blocks done."""
        delay = self.backoff
        failures = 0
        while True:
            try:
                sock = socket.create_connection(
                    self.address, timeout=self.connect_timeout)
            except OSError:
                failures += 1
                if failures > self.max_retries:
                    return self.blocks_done
                time.sleep(delay)
                delay = min(delay * 2, self.backoff_max)  # exponential
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                reader, welcome = self._handshake(sock)
            except (OSError, PacketError):
                sock.close()
                failures += 1
                if failures > self.max_retries:
                    return self.blocks_done
                time.sleep(delay)
                delay = min(delay * 2, self.backoff_max)
                continue
            failures, delay = 0, self.backoff   # link is good: reset
            try:
                outcome = self._serve(sock, reader, welcome)
            except Exception:
                # sampler bug: report it upstream, then bail out — the
                # manager surfaces it via worker_errors()
                try:
                    sock.sendall(frame(
                        ERROR, traceback.format_exc().encode()))
                except OSError:
                    pass
                sock.close()
                raise
            sock.close()
            if outcome != 'lost':
                return self.blocks_done
            self.reconnects += 1

    # -- handshake ---------------------------------------------------------
    def _handshake(self, sock) -> tuple[FrameReader, dict]:
        hello: dict = {}
        if self.claim is not None:
            hello['claim'] = int(self.claim)
        if self.worker_id is not None:
            hello['resume'] = {'job': self.job, 'worker_id': self.worker_id,
                               'blocks_done': self.blocks_done}
        sock.sendall(frame(HELLO, encode_json(hello)))
        reader = FrameReader()
        sock.settimeout(self.connect_timeout)
        deadline = time.monotonic() + self.connect_timeout
        while time.monotonic() < deadline:
            data = sock.recv(1 << 16)
            if not data:
                raise PacketError('connection closed during handshake')
            reader.feed(data)
            for kind, payload in reader.frames():
                if kind == WELCOME:
                    sock.settimeout(None)
                    return reader, decode_json(payload)
                if kind == STOP:
                    self._stop = True
            # non-WELCOME frames before the welcome are manager races
            # (e.g. immediate STOP) — recorded above, keep waiting
        raise PacketError('no WELCOME before timeout')

    # -- block loop --------------------------------------------------------
    def _serve(self, sock, reader: FrameReader, welcome: dict) -> str:
        hb_interval = (self.heartbeat_interval if self.heartbeat_interval
                       is not None
                       else float(welcome.get('heartbeat_interval', 0.1)))
        broken = threading.Event()
        send_lock = threading.Lock()

        def _send_raw(data: bytes) -> None:
            with send_lock:
                sock.sendall(data)

        def _heartbeat_loop() -> None:
            while not broken.is_set():
                # _t0 unset => still building the sampler (jax import +
                # equilibration can take far longer than the host's
                # heartbeat timeout): beat anyway, at rate 0
                elapsed = (max(time.monotonic() - self._t0, 1e-9)
                           if self._t0 is not None else None)
                beat = {'blocks_done': self.blocks_done,
                        'subblocks_done': self.subblocks_done,
                        'rate': (self.subblocks_done / elapsed
                                 if elapsed else 0.0)}
                try:
                    _send_raw(frame(HEARTBEAT, encode_json(beat)))
                except OSError:
                    broken.set()
                    return
                broken.wait(hb_interval)

        hb = threading.Thread(target=_heartbeat_loop, daemon=True)
        hb.start()
        try:
            schema = int(welcome.get('schema', SCHEMA_VERSION))
            if schema > SCHEMA_VERSION:
                # the manager's store validates rows this worker cannot
                # promise to satisfy — fail loudly (ERROR frame + raise)
                # instead of feeding blocks a newer validator may reject
                raise RuntimeError(
                    f'manager store schema v{schema} is newer than this '
                    f'worker (v{SCHEMA_VERSION}); upgrade the worker host')
            if self.worker_id is None or welcome['job'] != self.job:
                # first successful join — or a *new run* on the managing
                # end (a long-lived grid host re-attached to a service
                # that started another job): adopt the new identity and
                # reset per-run progress.  A plain reconnect inside one
                # job keeps identity, sampler state, and counters.
                new_run = self.worker_id is not None
                self.worker_id = int(welcome['worker_id'])
                self.run_key = welcome['run_key']
                self.job = welcome['job']
                self.subblocks = int(welcome['subblocks'])
                if new_run:
                    self.blocks_done = 0
                    self.subblocks_done = 0
                    self._step = 0
                    self._last_packet = None       # belongs to the old job
                    self._e_trial = None
                    self._params_update = None
                if self.sampler is None or (new_run
                                            and self.sampler_factory):
                    self.sampler = self.sampler_factory(welcome)
                init_walkers = welcome.get('init_walkers')
                if init_walkers is not None:
                    init_walkers = np.asarray(init_walkers)
                self._state = self.sampler.init_state(
                    self.worker_id, int(welcome['seed']), init_walkers)
                self._t0 = time.monotonic()
            if welcome.get('params_version') is not None:
                # the WELCOME carries the manager's current parameter
                # broadcast: a reconnecting worker (which kept its sampler)
                # and an elastic late joiner both align on the current
                # version before sampling a single block
                self._params_update = (int(welcome['params_version']),
                                       welcome['params_vec'])
            if self._last_packet is not None:
                # replay the last block packet after a reconnect — it may
                # have been lost mid-link-failure; the DB dedupes a replay
                _send_raw(self._last_packet)
            while True:
                self._drain(sock, reader, broken)
                if broken.is_set():
                    return 'lost'
                acc = BlockAccumulator()
                walkers = energies = None
                if not self._stop:
                    if self._e_trial is not None:
                        self._state = self.sampler.set_e_trial(
                            self._state, self._e_trial)
                        self._e_trial = None
                    if self._params_update is not None:
                        version, vec = self._params_update
                        self._params_update = None
                        apply = getattr(self.sampler, 'apply_params', None)
                        if apply is not None:
                            apply(int(version), np.asarray(vec))
                    n_sub = max(1, self.subblocks + self._bonus)
                    self._bonus = 0
                    for _ in range(n_sub):
                        self._state, sub, walkers, energies = \
                            self.sampler.run_subblock(self._state,
                                                      self._step)
                        self._step += 1
                        self.subblocks_done += 1
                        acc = acc.merge(sub)
                        self._drain(sock, reader, broken)
                        if self._stop or broken.is_set():
                            break          # truncated block: flushed below
                if broken.is_set():
                    return 'lost'          # partial never sent: unbiased
                if acc.is_valid():
                    blk = acc.to_block(self.run_key, self.worker_id,
                                       self.blocks_done, job=self.job)
                    pkt = frame(BLOCKS, encode_blocks([blk]))
                    try:
                        _send_raw(pkt)
                        self._last_packet = pkt
                        if walkers is not None:
                            _send_raw(frame(WALKERS, encode_walkers(
                                np.asarray(walkers), np.asarray(energies))))
                    except OSError:
                        broken.set()
                        return 'lost'
                    self.blocks_done += 1
                if self._stop:
                    self._bye(_send_raw)
                    return 'stop'
                if self.max_blocks and self.blocks_done >= self.max_blocks:
                    self._bye(_send_raw)
                    return 'done'
        finally:
            broken.set()
            hb.join(1.0)

    def _bye(self, send_raw) -> None:
        try:
            send_raw(frame(BYE))
        except OSError:
            pass

    def _drain(self, sock, reader: FrameReader,
               broken: threading.Event) -> None:
        """Non-blocking control ingest: STOP / E_TRIAL / ASSIGN frames."""
        try:
            while select.select([sock], [], [], 0)[0]:
                data = sock.recv(1 << 16)
                if not data:
                    broken.set()
                    return
                reader.feed(data)
            for kind, payload in reader.frames():
                if kind == STOP:
                    self._stop = True
                elif kind == E_TRIAL:
                    (self._e_trial,) = struct.unpack('>d', payload)
                elif kind == PARAMS:
                    self._params_update = decode_params(payload)
                elif kind == ASSIGN:
                    lease = decode_json(payload)
                    self.subblocks = int(lease['subblocks'])
                    self._bonus += int(lease.get('bonus', 0))
        except (OSError, PacketError, ValueError):
            broken.set()
