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
"""
from __future__ import annotations

import argparse
import functools


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

    from repro_torch.runtime.grid import GridWorkerClient
    client = GridWorkerClient(
        parse_address(args.connect), sampler=make_sampler(args.sampler),
        sampler_factory=functools.partial(sampler_from_payload,
                                          device=args.device),
        claim=args.claim, heartbeat_interval=args.heartbeat,
        max_retries=args.max_retries, backoff=args.backoff,
        backoff_max=args.backoff_max, max_blocks=args.blocks)
    done = client.run()
    print(f'qmc_worker {client.worker_id}: {done} blocks '
          f'({client.reconnects} reconnects)')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
