"""TCP front end for ``QMCService``: accept loop + per-client dispatch.

One listener socket, one daemon thread per client connection, the
``serve.protocol`` framed-JSON RPC on the wire.  Dispatch is a literal
op table over the engine's public API; every handler returns a JSON-safe
dict, every exception becomes an ``ok: false`` response (the engine is
never taken down by a bad request).  ``watch`` subscribes the connection
to the run's live event queue and streams ``EVENT`` frames until the run
reaches a final state (or the client goes away), then sends the closing
``RESPONSE`` — the one op that holds its connection open.

``shutdown`` flips a server-wide event the ``qmc_serve`` launcher waits
on; the server itself never closes the engine (the owner does, after
``stop()``), so a restart against the same database file sees every
committed block.
"""
from __future__ import annotations

import queue
import socket
import threading

from repro_torch.serve import protocol
from repro_torch.serve.engine import FINAL_STATES, QMCService


class QMCServiceServer:
    """Serve a ``QMCService`` over TCP (stdlib sockets, framed JSON)."""

    def __init__(self, service: QMCService, host: str = '127.0.0.1',
                 port: int = 0):
        self.service = service
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(0.2)
        self.address: tuple[str, int] = self._listener.getsockname()[:2]
        self._stop = threading.Event()
        self.shutdown_requested = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._clients: list[threading.Thread] = []

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Start accepting clients (idempotent)."""
        if self._accept_thread is None:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, daemon=True,
                name='qmc-serve-accept')
            self._accept_thread.start()

    def stop(self) -> None:
        """Stop accepting, close the listener, join client threads."""
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(5.0)
        self._listener.close()
        for t in list(self._clients):
            t.join(2.0)

    def _accept_loop(self) -> None:
        """Accept connections; one daemon dispatch thread per client."""
        while not self._stop.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._client_loop, args=(conn,),
                                 daemon=True, name='qmc-serve-client')
            t.start()
            self._clients.append(t)

    # -- per-client dispatch ----------------------------------------------
    def _client_loop(self, conn: socket.socket) -> None:
        """Serve one connection: whitelisted ops, errors as responses."""
        stream = protocol.MessageStream(conn)
        try:
            while not self._stop.is_set():
                msg = stream.recv()
                if msg is None:
                    break
                kind, req = msg
                if kind != protocol.REQUEST or not isinstance(req, dict):
                    continue                     # data-plane noise: ignore
                rid = req.get('id', 0)
                op = req.get('op')
                if op not in protocol.OPS:
                    stream.send(protocol.RESPONSE,
                                {'id': rid, 'ok': False,
                                 'error': f'unknown op {op!r}'})
                    continue
                try:
                    self._dispatch(stream, rid, op, req)
                except Exception as e:           # engine errors -> client
                    stream.send(protocol.RESPONSE,
                                {'id': rid, 'ok': False,
                                 'error': f'{type(e).__name__}: {e}'})
        except (protocol.PacketError, OSError):
            pass                                 # garbage/denied link: drop
        finally:
            stream.close()

    def _dispatch(self, stream, rid, op, req) -> None:
        """Execute one whitelisted op and send its response (+ events)."""
        svc = self.service
        if op == 'ping':
            out = {'pong': True, 'runs': len(svc.list_runs())}
        elif op == 'submit':
            run_id = svc.submit(req['spec'])
            out = {'run': svc.status(run_id)}
        elif op == 'status':
            out = {'run': svc.status(req['run'])}
        elif op == 'list':
            out = {'runs': svc.list_runs()}
        elif op == 'extend':
            run_id = svc.extend(req['run'], int(req.get('blocks', 1)))
            out = {'run': svc.status(run_id)}
        elif op == 'fork':
            overrides = req.get('overrides', {})
            if not isinstance(overrides, dict):
                raise ValueError('overrides must be a dict')
            run_id = svc.fork(req['run'], **overrides)
            out = {'run': svc.status(run_id)}
        elif op == 'cancel':
            out = {'run': svc.cancel(req['run'])}
        elif op == 'wait':
            timeout = req.get('timeout')
            out = {'run': svc.wait(
                req['run'], float(timeout) if timeout else None)}
        elif op == 'shutdown':
            self.shutdown_requested.set()
            out = {'stopping': True}
        elif op == 'watch':
            self._watch(stream, rid, req)
            return
        else:                                    # pragma: no cover
            raise ValueError(f'unhandled op {op!r}')
        stream.send(protocol.RESPONSE, dict(out, id=rid, ok=True))

    def _watch(self, stream, rid, req) -> None:
        """Stream live events for one run until it reaches a final state."""
        run = req['run']
        q = self.service.subscribe(run)
        try:
            while not self._stop.is_set():
                try:
                    ev = q.get(timeout=0.5)
                except queue.Empty:
                    snap = self.service.status(run)
                    if snap['state'] in FINAL_STATES:
                        break                    # missed the closing event
                    continue
                stream.send(protocol.EVENT, dict(ev, id=rid))
                if ev.get('state') in FINAL_STATES:
                    break
        finally:
            self.service.unsubscribe(run, q)
        stream.send(protocol.RESPONSE,
                    {'id': rid, 'ok': True, 'run': self.service.status(run)})
