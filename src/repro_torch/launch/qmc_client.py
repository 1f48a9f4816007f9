"""``qmc_client``: talk to a running ``qmc_serve`` (DESIGN.md §12).

Subcommands map one-to-one onto the service RPC surface:

  submit   — queue a new run (qmc_run-style spec flags); --wait/--watch
  status   — one status snapshot by run id or run key
  watch    — stream live block statistics until the run finishes
  extend   — continue a stored run key by N more blocks
  fork     — re-submit a stored spec with changed fields (fresh key,
             reservoir-seeded): ``--set tau=0.7 --set n_walkers=64``
  cancel   — stop a queued/running run
  list     — every run the service knows
  shutdown — ask the service process to exit

All traffic is the framed-JSON protocol of ``serve.protocol`` (CRC'd,
versioned, nothing unpickled).  Examples:

  python -m repro.launch.qmc_client --port 7747 submit --system h2 \
      --method vmc --blocks 20 --wait
  python -m repro.launch.qmc_client --port 7747 extend 97960be3 --blocks 10
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.spec import RunSpec, spec_to_payload
from repro_torch.serve import ServiceClient


def _fmt(run: dict) -> str:
    """One human line per status snapshot (energy may be unknown yet)."""
    e = run.get('energy')
    err = run.get('error_bar')
    stats = (f'E = {e:+.6f} +/- {err:.6f}' if e is not None
             and err is not None else 'E = (no blocks yet)')
    line = (f"{run['run_id']:>6} {run.get('run_key') or '--------':>8} "
            f"{run['state']:>9}  {run['n_blocks']:>5} blocks  {stats}")
    if run.get('detail'):
        line += f"\n  detail: {run['detail'].strip().splitlines()[-1]}"
    return line


def _parse_override(item: str) -> tuple[str, object]:
    """``field=value`` -> (field, typed value); values parse as JSON
    first (numbers/bools) and fall back to a bare string."""
    if '=' not in item:
        raise argparse.ArgumentTypeError(
            f'override {item!r} is not field=value')
    field, raw = item.split('=', 1)
    try:
        return field, json.loads(raw)
    except json.JSONDecodeError:
        return field, raw


def _spec_payload(args) -> dict:
    """Submit-subcommand flags -> validated spec payload."""
    spec = RunSpec(
        system=args.system, method=args.method, n_det=args.n_det,
        tau=args.tau, screen_eps=args.screen_eps, n_walkers=args.walkers,
        steps=args.steps, backend=args.backend, n_workers=args.workers,
        max_blocks=args.blocks, target_error=args.target_error,
        seed=args.seed)
    return spec_to_payload(spec)


def build_parser() -> argparse.ArgumentParser:
    """The full qmc_client argument surface (exposed for tests)."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, required=True,
                    help='qmc_serve port (printed at its startup)')
    sub = ap.add_subparsers(dest='cmd', required=True)

    sp = sub.add_parser('submit', help='queue a new run')
    sp.add_argument('--system', default='h2')
    sp.add_argument('--method',
                    choices=('vmc', 'dmc', 'sem-vmc', 'opt-vmc'),
                    default='vmc')
    sp.add_argument('--n-det', type=int, default=1)
    sp.add_argument('--tau', type=float, default=0.0)
    sp.add_argument('--screen-eps', type=float, default=-1.0)
    sp.add_argument('--backend',
                    choices=('thread', 'process', 'sim', 'grid'),
                    default='thread')
    sp.add_argument('--workers', type=int, default=2)
    sp.add_argument('--walkers', type=int, default=32)
    sp.add_argument('--steps', type=int, default=50)
    sp.add_argument('--blocks', type=int, default=20)
    sp.add_argument('--target-error', type=float, default=0.0)
    sp.add_argument('--seed', type=int, default=0)
    sp.add_argument('--wait', action='store_true',
                    help='block until the run finishes')
    sp.add_argument('--watch', action='store_true',
                    help='stream live block statistics until done')

    for name, hlp in (('status', 'one status snapshot'),
                      ('watch', 'stream live statistics'),
                      ('cancel', 'stop a queued/running run')):
        p = sub.add_parser(name, help=hlp)
        p.add_argument('run', help='run id (rN) or run key')

    p = sub.add_parser('extend', help='continue a stored run key')
    p.add_argument('run', help='run id (rN) or run key')
    p.add_argument('--blocks', type=int, default=10,
                   help='additional blocks to accumulate')
    p.add_argument('--wait', action='store_true')

    p = sub.add_parser('fork', help='re-submit a stored spec, changed')
    p.add_argument('run', help='parent run id or run key')
    p.add_argument('--set', dest='overrides', type=_parse_override,
                   action='append', default=[], metavar='FIELD=VALUE',
                   help='spec field override (repeatable); a changed '
                        'critical field yields a fresh run key')
    p.add_argument('--wait', action='store_true')

    sub.add_parser('list', help='every run the service knows')
    sub.add_parser('shutdown', help='ask the service to exit')
    return ap


def _watch(client: ServiceClient, run_id: str) -> dict:
    """Stream live events to stdout; returns the final status."""
    last = None
    for ev in client.watch(run_id):
        print(_fmt(ev), flush=True)
        last = ev
    return last


def main(argv=None):
    """Dispatch one subcommand against the service and print the result."""
    args = build_parser().parse_args(argv)
    with ServiceClient(args.host, args.port) as client:
        if args.cmd == 'submit':
            run = client.submit(_spec_payload(args))
            print(_fmt(run), flush=True)
            if args.watch:
                run = _watch(client, run['run_id'])
            elif args.wait:
                run = client.wait(run['run_id'])
                print(_fmt(run), flush=True)
        elif args.cmd == 'status':
            run = client.status(args.run)
            print(_fmt(run))
        elif args.cmd == 'watch':
            run = _watch(client, args.run)
        elif args.cmd == 'extend':
            run = client.extend(args.run, args.blocks)
            print(_fmt(run), flush=True)
            if args.wait:
                run = client.wait(run['run_id'])
                print(_fmt(run), flush=True)
        elif args.cmd == 'fork':
            run = client.fork(args.run, dict(args.overrides))
            print(_fmt(run), flush=True)
            if args.wait:
                run = client.wait(run['run_id'])
                print(_fmt(run), flush=True)
        elif args.cmd == 'cancel':
            run = client.cancel(args.run)
            print(_fmt(run))
        elif args.cmd == 'list':
            run = None
            for r in client.list():
                print(_fmt(r))
        else:                                    # shutdown
            client.shutdown()
            print('service shutting down')
            run = None
    if run is not None and run.get('state') == 'failed':
        return 1
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
