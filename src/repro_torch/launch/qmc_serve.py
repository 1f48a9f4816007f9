"""``qmc_serve``: launch the multi-tenant QMC service (DESIGN.md §12).

Stands up one ``QMCService`` engine over a durable database file and its
TCP front end, then blocks until a client sends ``shutdown`` (or the
process receives SIGINT/SIGTERM).  The database IS the service's state:
on startup the store is crash-recovered (sqlite WAL) and every stored
block is re-validated — a restart against the same ``--db`` file sees
every committed block and can ``extend``/``fork`` any stored run key.

  PYTHONPATH=src python -m repro.launch.qmc_serve \
      --db /tmp/qmc.sqlite --listen 127.0.0.1:7747 --pool 8

Clients talk to it with ``python -m repro.launch.qmc_client`` (submit /
status / watch / extend / fork / cancel).  ``--builder gaussian`` swaps
the physics for the jax-free sleep-bound sampler (CI smokes, throughput
benchmarks) — scheduling, transport, and durability are identical.
"""
from __future__ import annotations

import argparse
import signal
import threading

from repro_torch.serve import QMCService, QMCServiceServer, gaussian_builder


def main(argv=None):
    """Parse flags, recover the store, serve until shutdown."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--db', default='qmc_service.sqlite',
                    help='durable results store (the service state; '
                         'restarting against the same file recovers '
                         'every committed block)')
    ap.add_argument('--listen', default='127.0.0.1:0', metavar='HOST:PORT',
                    help='TCP listen address (port 0: ephemeral, printed '
                         'at startup)')
    ap.add_argument('--pool', type=int, default=4,
                    help='total worker pool shared fairly across all '
                         'concurrent runs')
    ap.add_argument('--max-active', type=int, default=0,
                    help='concurrent runs holding leases (0: one per '
                         'pool worker)')
    ap.add_argument('--quota-blocks', type=int, default=0,
                    help='per-run-key block quota (0: unlimited)')
    ap.add_argument('--poll-interval', type=float, default=0.05)
    ap.add_argument('--builder', choices=('real', 'gaussian'),
                    default='real',
                    help="spec compiler: 'real' physics (jax) or the "
                         "jax-free 'gaussian' drill sampler")
    args = ap.parse_args(argv)

    from repro_torch.launch.qmc_worker import parse_address
    host, port = parse_address(args.listen)
    builder = gaussian_builder if args.builder == 'gaussian' else None
    service = QMCService(db=args.db, total_workers=args.pool,
                         builder=builder, poll_interval=args.poll_interval,
                         max_active=args.max_active,
                         quota_blocks=args.quota_blocks)

    # crash recovery report: what survived in the store, and is it clean?
    report = service.store.validate_all()
    keys = service.store.run_keys()
    print(f'store {args.db}: schema v{service.store.schema_version}, '
          f'{len(keys)} run key(s), {report["checked"]} stored block(s), '
          f'{sum(report["rejects"].values())} invalid', flush=True)

    server = QMCServiceServer(service, host=host, port=port)
    server.start()
    h, p = server.address
    print(f'qmc_serve listening on {h}:{p} (pool={args.pool}, '
          f'builder={args.builder})', flush=True)

    stop = threading.Event()

    def _sig(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    while not (stop.is_set() or server.shutdown_requested.is_set()):
        stop.wait(0.2)
    print('qmc_serve: shutting down', flush=True)
    server.stop()
    service.close()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
