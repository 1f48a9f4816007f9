"""Binary forwarder tree with ancestor-fallback routing (paper §V.D, fig. 4).

Each compute node runs one forwarder; forwarders form a binary tree rooted
at the data server.  Results flow *up*: a forwarder batches the messages of
its workers and descendants into one compressed packet and pushes it to its
parent — or, if the parent is dead/unreachable, to any live *ancestor*
(redundancy against node failure).  Packets are the CRC-validated binary
frames of ``runtime.packets`` (the same wire format the TCP grid backend
ships between hosts); ``submit_packet`` rejects a corrupt frame — bad CRC,
bad magic — at ingress without ever killing the forwarder thread, and the
unbiasedness contract (a dropped block was never counted) makes the
rejection safe.

A forwarder also maintains a walker reservoir; after a random idle timeout
it pushes the reservoir up the tree, where it is merged — so the data server
ends up with an energy-stratified sample of the whole run's walkers without
every walker travelling to the root.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

from repro_torch.runtime.blocks import BlockResult
from repro_torch.runtime.database import ResultDatabase
from repro_torch.runtime.packets import (BLOCKS, PacketError, decode_blocks,
                                   encode_blocks, frame, unframe)
from repro_torch.runtime.reservoir import WalkerReservoir


class Forwarder:
    """One tree node: receives from workers/children, pushes to ancestors."""

    def __init__(self, node_id: int, db: ResultDatabase | None = None,
                 n_kept: int = 64, batch_timeout: float = 0.05):
        self.node_id = node_id
        self.db = db                    # non-None only at the root
        self.parent: 'Forwarder | None' = None
        self.ancestors: list['Forwarder'] = []  # parent, grandparent, ...
        self.reservoir = WalkerReservoir(
            n_kept, np.random.default_rng(1000 + node_id))
        self.batch_timeout = batch_timeout
        self._q: queue.Queue = queue.Queue()
        self._alive = threading.Event()
        self._alive.set()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None
        self.packets_sent = 0
        self.bytes_sent = 0
        self.packets_corrupt = 0       # rejected at ingress (bad CRC/frame)

    # -- wiring -------------------------------------------------------------
    def set_parent_chain(self, ancestors: list['Forwarder']) -> None:
        self.ancestors = list(ancestors)
        self.parent = ancestors[0] if ancestors else None

    @property
    def alive(self) -> bool:
        return self._alive.is_set()

    def kill(self) -> None:
        """Simulate node failure: stop accepting and forwarding."""
        self._alive.clear()

    # -- ingress ------------------------------------------------------------
    def submit_blocks(self, blocks: list[BlockResult]) -> bool:
        if not self.alive:
            return False
        self._q.put(('blocks', blocks))
        return True

    def submit_walkers(self, walkers: np.ndarray,
                       energies: np.ndarray) -> bool:
        if not self.alive:
            return False
        self._q.put(('walkers', (walkers, energies)))
        return True

    def submit_packet(self, payload: bytes) -> bool:
        """Framed packet from a child forwarder (CRC-checked at ingress).

        A corrupt frame — truncated, bit-flipped, wrong magic — is
        *rejected* (counted, never enqueued): one bad packet must not kill
        the forwarder thread every descendant shares, and the dropped
        blocks were never counted, so the average stays unbiased.
        """
        if not self.alive:
            return False
        try:
            kind, body = unframe(payload)
            if kind != BLOCKS:
                raise PacketError(f'unexpected frame kind {kind}')
        except PacketError:
            self.packets_corrupt += 1
            return False
        self._q.put(('packet', body))
        return True

    # -- egress -------------------------------------------------------------
    def _push_up(self, blocks: list[BlockResult]) -> None:
        if self.db is not None:                      # root: store directly
            self.db.append(blocks)
            return
        # the paper's compressed transfer, as a CRC-framed binary packet
        payload = frame(BLOCKS, encode_blocks(blocks))
        self.packets_sent += 1
        self.bytes_sent += len(payload)
        for anc in self.ancestors:                   # parent, then fallbacks
            if anc.alive and anc.submit_packet(payload):
                return
        # no live ancestor: blocks are dropped — the unbiasedness contract
        # makes this safe (they were never counted).

    def _push_walkers_up(self) -> None:
        w, e = self.reservoir.state()
        if w is None:
            return
        if self.db is not None:
            return                                    # root keeps its own
        for anc in self.ancestors:
            if anc.alive:
                if anc.submit_walkers(w, e):
                    return

    # -- main loop ------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        pending: list[BlockResult] = []
        last_flush = time.monotonic()
        last_walker_push = time.monotonic() + np.random.default_rng(
            self.node_id).uniform(0.1, 0.3)          # random timeout (paper)
        while not self._done.is_set():
            try:
                kind, item = self._q.get(timeout=0.02)
            except queue.Empty:
                kind = None
            if not self.alive:
                continue                             # dead node: drop input
            if kind == 'blocks':
                pending.extend(item)
            elif kind == 'packet':
                try:
                    pending.extend(decode_blocks(item))
                except Exception:      # defense in depth: ingress already
                    self.packets_corrupt += 1   # CRC-checked this frame

            elif kind == 'walkers':
                self.reservoir.add(*item)
            now = time.monotonic()
            # batch into large packets (paper: asynchronous, large messages)
            if pending and (now - last_flush > self.batch_timeout
                            or len(pending) >= 64):
                self._push_up(pending)
                pending = []
                last_flush = now
            if now - last_walker_push > 0.25 and self._q.empty():
                self._push_walkers_up()
                last_walker_push = now
        if pending and self.alive:
            self._push_up(pending)
        self._push_walkers_up()

    def stop(self, timeout: float = 2.0) -> None:
        self._done.set()
        if self._thread is not None:
            self._thread.join(timeout)


def build_tree(n_nodes: int, db: ResultDatabase,
               n_kept: int = 64) -> list[Forwarder]:
    """Binary tree of forwarders; node 0 is the data server (holds the DB).

    Every node knows its full ancestor chain so it can route around dead
    parents (paper: 'every node of the tree can send data to all its
    ancestors')."""
    nodes = [Forwarder(i, db=db if i == 0 else None, n_kept=n_kept)
             for i in range(n_nodes)]
    for i in range(1, n_nodes):
        chain = []
        j = i
        while j > 0:
            j = (j - 1) // 2
            chain.append(nodes[j])
        nodes[i].set_parent_chain(chain)
    for n in nodes:
        n.start()
    return nodes
