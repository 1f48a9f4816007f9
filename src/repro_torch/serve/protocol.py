"""Service wire protocol: framed JSON RPC over the packets.py discipline.

Three frame kinds ride the same versioned, CRC-32'd framing the grid
transport uses (``runtime.packets.frame``/``FrameReader``), in a kind
range disjoint from the worker data plane:

* ``REQUEST`` (client -> server): ``{"id": n, "op": "...", ...}`` — the
  op must be in the ``OPS`` whitelist, everything else is JSON data;
* ``RESPONSE`` (server -> client): ``{"id": n, "ok": true, ...}`` or
  ``{"id": n, "ok": false, "error": "..."}`` — exactly one per request;
* ``EVENT`` (server -> client): ``{"id": n, ...}`` — zero or more
  streamed before the response (``watch`` block statistics).

Requests are correlated by the client-chosen ``id``; a connection runs
one request at a time (the client is sequential by construction).  As
everywhere on the wire, nothing is ever unpickled — a corrupt frame is
dropped by CRC, a malformed request gets an error response, an unknown
op is rejected before dispatch.
"""
from __future__ import annotations

import socket

from repro_torch.runtime.packets import (FrameReader, PacketError, decode_json,
                                   encode_json, frame)

__all__ = ['REQUEST', 'RESPONSE', 'EVENT', 'OPS', 'ServiceError',
           'MessageStream', 'PacketError']

# service frame kinds: disjoint from runtime.packets worker kinds (1..11)
REQUEST = 32     # client -> server: {"id", "op", ...} (JSON)
RESPONSE = 33    # server -> client: {"id", "ok", ...} (JSON)
EVENT = 34       # server -> client: streamed watch events (JSON)

# the full RPC surface; anything else is rejected before dispatch
OPS = ('ping', 'submit', 'status', 'list', 'watch', 'extend', 'fork',
       'cancel', 'wait', 'shutdown')


class ServiceError(RuntimeError):
    """A server-side failure relayed to the client (``ok: false``)."""


class MessageStream:
    """One framed-JSON message channel over a connected socket.

    Thin composition of ``packets.frame`` (send) and ``packets
    .FrameReader`` (receive): ``send`` writes one frame, ``recv`` blocks
    for the next intact one (CRC-corrupt frames are skipped by the
    reader, EOF returns ``None``).  Used identically by both ends.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._reader = FrameReader()
        self._pending: list[tuple[int, dict]] = []

    def send(self, kind: int, obj: dict) -> None:
        """Frame + send one JSON message (kind is REQUEST/RESPONSE/EVENT)."""
        self._sock.sendall(frame(kind, encode_json(obj)))

    def recv(self) -> tuple[int, dict] | None:
        """Next ``(kind, message)``; ``None`` on clean EOF.

        Raises ``PacketError`` if the stream is garbage (bad magic) —
        the caller drops the connection.
        """
        while True:
            if self._pending:
                return self._pending.pop(0)
            data = self._sock.recv(65536)
            if not data:
                return None
            self._reader.feed(data)
            self._pending.extend(
                (kind, decode_json(payload))
                for kind, payload in self._reader.frames())

    def close(self) -> None:
        """Close the underlying socket (both directions)."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
