"""Length-prefixed, CRC-validated binary packets (paper §V.D transfers).

The paper's manager/forwarder/worker deployment ships *all* results as
compressed messages over sockets.  This module is the one wire format for
that traffic — used both between forwarder-tree nodes (in-host) and over
TCP by the multi-host grid backend (``runtime.grid``):

    frame := magic(2) version(1) kind(1) length(4) crc32(4) payload[length]

The CRC-32 covers the payload, so a truncated or bit-flipped transfer is
*detected and dropped* rather than decoded into garbage — the unbiasedness
contract (any block may be absent) makes dropping safe, and a corrupt frame
must never take down the receiving forwarder/manager thread.

Block payloads are a compact struct-packed binary encoding (replacing the
seed's zlib-pickle): per block a length-prefixed ``run_key``/``job``, the
integer identity ``(worker_id, block_id)``, the four float sufficient
statistics, and the aux dict as u32-length-prefixed JSON (opt-vmc blocks
carry O(P²) flattened moment entries) — then zlib-compressed (the paper
compresses all transfers).  No pickle is ever evaluated on the receive
path, so a malicious or corrupt peer cannot execute code via the data
plane.
"""
from __future__ import annotations

import io
import json
import struct
import zlib

import numpy as np

from repro_torch.runtime.blocks import BlockResult

MAGIC = b'\xa5Q'              # 'Q'MC + a non-ASCII guard byte
VERSION = 2                   # v2: u32 aux-JSON length in BLOCKS (the
#                               opt-vmc moment matrices overflow u16)
_HEADER = struct.Struct('>2sBBII')   # magic, version, kind, length, crc32
HEADER_SIZE = _HEADER.size

# frame kinds (worker <-> manager control + data plane)
HELLO = 1        # worker -> manager: join / reconnect (JSON)
WELCOME = 2      # manager -> worker: identity + run assignment (JSON)
BLOCKS = 3       # worker -> manager: block results (binary, see below)
WALKERS = 4      # worker -> manager: reservoir sample (npz)
HEARTBEAT = 5    # worker -> manager: liveness + observed block rate (JSON)
E_TRIAL = 6      # manager -> worker: DMC reference-energy feedback (f64)
STOP = 7         # manager -> worker: flush the partial block, then exit
ASSIGN = 8       # manager -> worker: sub-block lease re-sizing (JSON)
ERROR = 9        # worker -> manager: traceback (utf-8)
BYE = 10         # worker -> manager: graceful exit acknowledgement
PARAMS = 11      # manager -> worker: versioned wavefunction params (npz)

KIND_NAMES = {HELLO: 'hello', WELCOME: 'welcome', BLOCKS: 'blocks',
              WALKERS: 'walkers', HEARTBEAT: 'heartbeat',
              E_TRIAL: 'e_trial', STOP: 'stop', ASSIGN: 'assign',
              ERROR: 'error', BYE: 'bye', PARAMS: 'params'}


class PacketError(ValueError):
    """Unrecoverable framing violation (bad magic/version): drop the link."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
def frame(kind: int, payload: bytes = b'') -> bytes:
    """One wire frame: header (magic, version, kind, length, crc) + payload."""
    return _HEADER.pack(MAGIC, VERSION, kind, len(payload),
                        zlib.crc32(payload) & 0xffffffff) + payload


def unframe(data: bytes) -> tuple[int, bytes]:
    """Parse exactly one frame; raises ``PacketError`` on any violation.

    Used by the in-host forwarder tree where a packet is handed over as one
    bytes object (``submit_packet``); the streaming TCP path uses
    ``FrameReader`` instead.
    """
    if len(data) < HEADER_SIZE:
        raise PacketError(f'short frame: {len(data)} bytes')
    magic, version, kind, length, crc = _HEADER.unpack_from(data)
    if magic != MAGIC or version != VERSION:
        raise PacketError(f'bad magic/version {magic!r}/{version}')
    payload = data[HEADER_SIZE:]
    if len(payload) != length:
        raise PacketError(f'length mismatch: {len(payload)} != {length}')
    if zlib.crc32(payload) & 0xffffffff != crc:
        raise PacketError('CRC-32 mismatch')
    return kind, payload


class FrameReader:
    """Incremental frame parser over a TCP byte stream.

    ``feed`` raw socket bytes, iterate ``frames()``.  A frame whose CRC-32
    fails is *skipped* (its length is trusted for resync) and counted in
    ``corrupt`` — one flipped bit must not kill the connection.  A header
    with bad magic/version means the stream itself is garbage; that raises
    ``PacketError`` and the caller drops the connection.
    """

    def __init__(self):
        self._buf = bytearray()
        self.corrupt = 0

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def frames(self):
        """Yield every complete ``(kind, payload)`` frame buffered so far."""
        while len(self._buf) >= HEADER_SIZE:
            magic, version, kind, length, crc = _HEADER.unpack_from(self._buf)
            if magic != MAGIC or version != VERSION:
                raise PacketError(f'bad magic/version {magic!r}/{version}')
            if len(self._buf) < HEADER_SIZE + length:
                return                                   # wait for more bytes
            payload = bytes(self._buf[HEADER_SIZE:HEADER_SIZE + length])
            del self._buf[:HEADER_SIZE + length]
            if zlib.crc32(payload) & 0xffffffff != crc:
                self.corrupt += 1                        # skip, stay in sync
                continue
            yield kind, payload


# ---------------------------------------------------------------------------
# payload codecs
# ---------------------------------------------------------------------------
_BLOCK_FIXED = struct.Struct('>qqdddd')   # worker_id, block_id, weight,
#                                           e_mean, e2_mean, timestamp


def _pack_str(s: str) -> bytes:
    b = s.encode('utf-8')
    return struct.pack('>H', len(b)) + b


def _unpack_str(buf: memoryview, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from('>H', buf, off)
    off += 2
    return bytes(buf[off:off + n]).decode('utf-8'), off + n


def _pack_str32(s: str) -> bytes:
    # aux JSON needs a u32 length: an opt-vmc block carries O(P^2)
    # flattened moment entries (P ~ 100 -> hundreds of kB of JSON)
    b = s.encode('utf-8')
    return struct.pack('>I', len(b)) + b


def _unpack_str32(buf: memoryview, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from('>I', buf, off)
    off += 4
    return bytes(buf[off:off + n]).decode('utf-8'), off + n


def encode_blocks(blocks: list[BlockResult]) -> bytes:
    """Compact binary encoding of a block list (zlib-compressed)."""
    out = [struct.pack('>I', len(blocks))]
    for b in blocks:
        out.append(_pack_str(b.run_key))
        out.append(_pack_str(b.job))
        out.append(_BLOCK_FIXED.pack(b.worker_id, b.block_id, b.weight,
                                     b.e_mean, b.e2_mean, b.timestamp))
        out.append(_pack_str32(json.dumps(dict(b.aux))))
    return zlib.compress(b''.join(out))


def decode_blocks(payload: bytes) -> list[BlockResult]:
    """Inverse of ``encode_blocks`` (no pickle on the receive path)."""
    buf = memoryview(zlib.decompress(payload))
    (n,) = struct.unpack_from('>I', buf, 0)
    off = 4
    blocks = []
    for _ in range(n):
        run_key, off = _unpack_str(buf, off)
        job, off = _unpack_str(buf, off)
        wid, bid, w, e, e2, ts = _BLOCK_FIXED.unpack_from(buf, off)
        off += _BLOCK_FIXED.size
        aux_json, off = _unpack_str32(buf, off)
        blocks.append(BlockResult(run_key=run_key, worker_id=wid,
                                  block_id=bid, weight=w, e_mean=e,
                                  e2_mean=e2, aux=json.loads(aux_json),
                                  timestamp=ts, job=job))
    return blocks


def encode_walkers(walkers: np.ndarray, energies: np.ndarray) -> bytes:
    """Walker reservoir sample as compressed npz (pickle disabled)."""
    buf = io.BytesIO()
    np.savez_compressed(buf, walkers=np.asarray(walkers),
                        energies=np.asarray(energies))
    return buf.getvalue()


def decode_walkers(payload: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of ``encode_walkers``."""
    data = np.load(io.BytesIO(payload), allow_pickle=False)
    return data['walkers'], data['energies']


def encode_params(version: int, vec: np.ndarray) -> bytes:
    """Versioned wavefunction-parameter broadcast as npz (no pickle)."""
    buf = io.BytesIO()
    np.savez_compressed(buf, version=np.asarray(int(version), np.int64),
                        vec=np.asarray(vec, np.float64))
    return buf.getvalue()


def decode_params(payload: bytes) -> tuple[int, np.ndarray]:
    """Inverse of ``encode_params``."""
    data = np.load(io.BytesIO(payload), allow_pickle=False)
    return int(data['version']), data['vec']


def encode_json(obj) -> bytes:
    """Small control payloads (hello/welcome/heartbeat/assign) as JSON."""
    return json.dumps(obj).encode('utf-8')


def decode_json(payload: bytes):
    """Inverse of ``encode_json``."""
    return json.loads(payload.decode('utf-8'))
