"""Client library for the QMC service (the ``qmc_client`` CLI's engine).

A ``ServiceClient`` holds one TCP connection and runs one request at a
time (sequential RPC; open a second client for concurrent watches).
Every method mirrors a whitelisted server op and returns the server's
JSON-safe payload; an ``ok: false`` response raises ``ServiceError``
with the server's message.  ``watch`` is a generator of live status
events that terminates when the run reaches a final state.
"""
from __future__ import annotations

import socket
import time

from repro_torch.serve import protocol
from repro_torch.serve.protocol import ServiceError


class ServiceClient:
    """Sequential framed-JSON RPC client for ``QMCServiceServer``."""

    def __init__(self, host: str = '127.0.0.1', port: int = 0,
                 timeout: float = 60.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._stream = protocol.MessageStream(self._sock)
        self._next_id = 1

    def close(self) -> None:
        """Drop the connection."""
        self._stream.close()

    def __enter__(self):
        """Context-manager support: ``with ServiceClient(...) as c:``."""
        return self

    def __exit__(self, *exc):
        """Close on scope exit."""
        self.close()

    # -- RPC core ---------------------------------------------------------
    def _rpc(self, op: str, **fields) -> dict:
        """One request/response round trip; raises on ``ok: false``."""
        rid = self._next_id
        self._next_id += 1
        self._stream.send(protocol.REQUEST, dict(fields, id=rid, op=op))
        while True:
            msg = self._stream.recv()
            if msg is None:
                raise ServiceError('connection closed by server')
            kind, obj = msg
            if kind != protocol.RESPONSE or obj.get('id') != rid:
                continue                         # stray event: ignore
            if not obj.get('ok'):
                raise ServiceError(obj.get('error', 'unknown error'))
            return obj

    # -- ops --------------------------------------------------------------
    def ping(self) -> dict:
        """Liveness check; returns ``{'pong': True, 'runs': n}``."""
        return self._rpc('ping')

    def submit(self, spec_payload: dict) -> dict:
        """Submit a spec payload (``spec_to_payload`` form); run status."""
        return self._rpc('submit', spec=spec_payload)['run']

    def status(self, run: str) -> dict:
        """Status snapshot by run id or run key."""
        return self._rpc('status', run=run)['run']

    def list(self) -> list[dict]:
        """Status of every run the service knows, submission order."""
        return self._rpc('list')['runs']

    def extend(self, run: str, blocks: int) -> dict:
        """Continue a stored run key by ``blocks`` more blocks."""
        return self._rpc('extend', run=run, blocks=int(blocks))['run']

    def fork(self, run: str, overrides: dict) -> dict:
        """Fork a stored run with changed spec fields (fresh key)."""
        return self._rpc('fork', run=run, overrides=overrides)['run']

    def cancel(self, run: str) -> dict:
        """Cancel a queued or running run."""
        return self._rpc('cancel', run=run)['run']

    def wait(self, run: str, timeout: float | None = None) -> dict:
        """Block server-side until the run finishes; final status."""
        return self._rpc('wait', run=run, timeout=timeout)['run']

    def shutdown(self) -> dict:
        """Ask the service process to exit (the launcher honors it)."""
        return self._rpc('shutdown')

    def watch(self, run: str):
        """Yield live status events until the run reaches a final state.

        Each event is a status snapshot with an ``event`` tag; the
        closing server response's status is yielded last (tagged
        ``'final'``).  The connection is dedicated to the watch while
        the generator runs.
        """
        rid = self._next_id
        self._next_id += 1
        self._stream.send(protocol.REQUEST,
                          {'id': rid, 'op': 'watch', 'run': run})
        while True:
            msg = self._stream.recv()
            if msg is None:
                raise ServiceError('connection closed during watch')
            kind, obj = msg
            if obj.get('id') != rid:
                continue
            if kind == protocol.EVENT:
                yield obj
            elif kind == protocol.RESPONSE:
                if not obj.get('ok'):
                    raise ServiceError(obj.get('error', 'watch failed'))
                yield dict(obj['run'], event='final')
                return


def wait_for_server(host: str, port: int, timeout: float = 10.0) -> None:
    """Poll until a service answers ``ping`` (test/CI startup helper)."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            c = ServiceClient(host, port, timeout=2.0)
            try:
                c.ping()
                return
            finally:
                c.close()
        except OSError as e:
            last = e
            time.sleep(0.1)
    raise TimeoutError(f'no service at {host}:{port} within {timeout}s '
                       f'({last})')
