"""Grid worker CLI of the PyTorch port: attach this host to a QMC manager.

Port of ``repro.launch.qmc_worker``: the multi-host half of ``--backend
grid`` (paper §V: workers join, leave, and die mid-run).  Point it at a
manager's listen address and it runs the standard block loop, shipping
CRC-validated binary block packets back over TCP with heartbeats,
exponential-backoff reconnect, and graceful stop-with-truncated-block-flush:

    PYTHONPATH=src python -m repro_torch.launch.qmc_worker \\
        --connect 127.0.0.1:7777 [--device cpu]

By default the sampler is built *on this host* from the declarative run
payload the manager ships in its WELCOME (system/method/tau/walkers — the
same fields a ``RunSpec`` holds), on ``--device`` (the GPU unless ``cpu``
is asked for; without a GPU the default raises).  No tensor crosses the
wire.  ``--sampler gauss[:k=v,...]`` substitutes the torch-free Gaussian
drill sampler (``runtime.testing``) for transport tests.

A spec worker imports torch and initialises its device before it
attaches (``prepare_device``).  Its closing line states its first
handshake's seconds, what the preparation took and the launches of each
CUDA kernel in this process (all 0 on the CPU, where the plain versions
run); ``closing_lines`` reads those lines back from a run's output.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import re
import sys
import threading
import time

from repro_torch.runtime.grid import GridWorkerClient


def parse_address(text: str) -> tuple[str, int]:
    """'host:port' -> (host, port)."""
    host, _, port = text.rpartition(':')
    if not host or not port.isdigit():
        raise ValueError(f'bad address {text!r} (expected host:port)')
    return host, int(port)


def sampler_from_payload(welcome: dict, device=None):
    """Build the physics sampler from the manager's WELCOME run payload,
    on ``device`` (``None``/``'cuda'``: the GPU, raising without one).

    Mirrors ``launch.spec.build_run``'s assembly: system catalog ->
    propagator registry -> generic ``BlockSampler``, with the payload's
    storage ``precision``.  Imported lazily so a ``--sampler gauss`` worker
    never pays the torch import.
    """
    spec = welcome.get('spec')
    if not spec:
        raise SystemExit(
            'manager shipped no run payload (engine-level manager without '
            'a RunSpec?) — pass --sampler gauss:... for transport drills')
    from repro_torch.core.driver import make_propagator
    from repro_torch.runtime.samplers import BlockSampler
    from repro_torch.systems import build_system

    eps = float(spec.get('screen_eps', -1.0))
    cfg, params = build_system(spec['system'],
                               n_det=int(spec.get('n_det', 1)),
                               ci_seed=int(spec.get('ci_seed', 0)),
                               screen_eps=(eps if eps >= 0 else None),
                               device=device)
    precision = str(spec.get('precision', 'fp32'))
    if precision != 'fp32':
        import dataclasses
        cfg = dataclasses.replace(cfg, precision=precision)
    prop = make_propagator(spec['method'], cfg, tau=float(spec['tau']),
                           e_trial=spec.get('e_trial'),
                           equil_steps=int(spec.get('equil_steps', 100)))
    return BlockSampler(prop, params,
                        n_walkers=int(spec.get('n_walkers', 32)),
                        steps=int(spec.get('steps', 50)), device=device)


def prepare_device(device=None) -> dict:
    """Import torch and initialise ``device`` before this worker attaches.

    Attached, a worker is declared dead after the manager's heartbeat
    timeout of silence (0.5 s in the fault drills), and its heartbeat
    thread is silent while another thread holds the GIL: ``import torch``
    loads its shared libraries, and ``torch.cuda.init`` sets up the
    driver, in calls that hold it.  Done before the HELLO, that time
    counts against the manager's boot timeout instead.  A device that
    cannot be reached is not reported here: it raises again where the
    sampler is built, after attaching, so the manager hears of it.

    Returns {'prepare_s': the seconds it took, 'gil_hold_s': the longest
    a thread that wakes every 10 ms went without running meanwhile, i.e.
    the silence a heartbeat thread would have had}."""
    gaps = [0.0]
    done = threading.Event()

    def _tick():
        last = time.perf_counter()
        while not done.wait(0.01):
            now = time.perf_counter()
            gaps.append(now - last)
            last = now
    ticker = threading.Thread(target=_tick, daemon=True)
    t0 = time.perf_counter()
    ticker.start()
    try:
        import torch
        from repro_torch.device import resolve_device
        try:
            dev = resolve_device(device)
        except RuntimeError:
            dev = None
        if dev is not None and dev.type == 'cuda':
            torch.cuda.init()
    finally:
        done.set()
        ticker.join()
    return {'prepare_s': time.perf_counter() - t0, 'gil_hold_s': max(gaps)}


class TimedWorkerClient(GridWorkerClient):
    """``GridWorkerClient`` that times each handshake: from its HELLO to
    the decoded WELCOME, which carries the run payload and the restart
    walkers (``handshakes``, seconds)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.handshakes: list[float] = []

    def _handshake(self, sock):
        t0 = time.perf_counter()
        out = super()._handshake(sock)
        self.handshakes.append(time.perf_counter() - t0)
        return out


def closing_line(client, facts: dict) -> str:
    """The line a worker prints when it leaves: its id, blocks and
    reconnects, then as JSON its first handshake's seconds and
    ``facts`` (a spec worker's ``prepare_device`` readings and the
    launches of each CUDA kernel in this process)."""
    hs = client.handshakes[0] if client.handshakes else None
    return (f'qmc_worker {client.worker_id}: {client.blocks_done} blocks '
            f'({client.reconnects} reconnects) '
            + json.dumps({'handshake_s': hs, **facts}))


def write_line(line: str) -> None:
    """Write ``line`` and its newline to standard output in one write.

    The workers of a grid run often share one stream.  ``print`` writes
    the text and the newline separately when Python runs unbuffered
    (``PYTHONUNBUFFERED``), and another worker's line can land between
    the two, gluing both onto one line."""
    sys.stdout.flush()
    data = (line + '\n').encode()
    while data:
        data = data[os.write(sys.stdout.fileno(), data):]


_CLOSING = re.compile(r'qmc_worker (\d+): (\d+) blocks \((\d+) '
                      r'reconnects\) (?=\{)')


def closing_lines(text: str) -> dict:
    """The closing lines of the workers whose output ``text`` holds:
    {worker id: {'blocks', 'reconnects', 'handshake_s', and for a spec
    worker 'prepare_s', 'gil_hold_s', 'launches'}}.  A line is found
    wherever it starts, and its JSON object is read up to its own end,
    so output of other processes glued onto the same line is passed by;
    a line whose object does not decode is left out."""
    decoder, out = json.JSONDecoder(), {}
    for m in _CLOSING.finditer(text):
        try:
            facts, _ = decoder.raw_decode(text, m.end())
        except json.JSONDecodeError:
            continue
        out[int(m[1])] = {'blocks': int(m[2]), 'reconnects': int(m[3]),
                          **facts}
    return out


def make_sampler(kind: str):
    """``--sampler`` -> a Sampler or None (None: build from run payload).

    ``gauss[:key=val,...]`` maps onto ``runtime.testing.GaussianSampler``
    keywords, e.g. ``gauss:delay=0.01,true_energy=-3.0``.
    """
    if kind == 'spec':
        return None
    name, _, opts = kind.partition(':')
    if name != 'gauss':
        raise SystemExit(f'unknown sampler {kind!r} (spec | gauss[:k=v,..])')
    from repro_torch.runtime.testing import GaussianSampler
    kw = {}
    for item in filter(None, opts.split(',')):
        k, _, v = item.partition('=')
        kw[k] = float(v)
    if 'n_walkers' in kw:
        kw['n_walkers'] = int(kw['n_walkers'])
    return GaussianSampler(**kw)


def main(argv=None) -> int:
    """Parse flags, attach to the manager, serve blocks until stopped."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--connect', required=True, metavar='HOST:PORT',
                    help="the manager's --listen address")
    ap.add_argument('--claim', type=int, default=None,
                    help='worker id to claim (used by manager-spawned '
                         'localhost workers; external workers omit it '
                         'and are adopted elastically)')
    ap.add_argument('--sampler', default='spec',
                    help="'spec' (build from the manager's run payload) "
                         "or 'gauss[:k=v,...]' (drill sampler)")
    ap.add_argument('--device', default=None,
                    help='cuda (default; raises without a GPU) or cpu: '
                         'where a spec sampler runs')
    ap.add_argument('--heartbeat', type=float, default=None,
                    help='heartbeat interval override (default: the '
                         'interval the manager advertises)')
    ap.add_argument('--max-retries', type=int, default=10,
                    help='consecutive failed connect attempts before '
                         'giving up (exponential backoff between tries)')
    ap.add_argument('--backoff', type=float, default=0.05,
                    help='initial reconnect backoff, seconds (doubles '
                         'per failure, capped by --backoff-max)')
    ap.add_argument('--backoff-max', type=float, default=2.0)
    ap.add_argument('--blocks', type=int, default=0,
                    help='leave gracefully after this many blocks '
                         '(0: serve until the manager says stop)')
    args = ap.parse_args(argv)

    sampler = make_sampler(args.sampler)
    facts = {} if sampler is not None else prepare_device(args.device)
    client = TimedWorkerClient(
        parse_address(args.connect), sampler=sampler,
        sampler_factory=functools.partial(sampler_from_payload,
                                          device=args.device),
        claim=args.claim, heartbeat_interval=args.heartbeat,
        max_retries=args.max_retries, backoff=args.backoff,
        backoff_max=args.backoff_max, max_blocks=args.blocks)
    client.run()
    if sampler is None:
        from repro_torch.kernels import launch_counters
        facts['launches'] = {k: c.n for k, c in launch_counters().items()}
    write_line(closing_line(client, facts))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
