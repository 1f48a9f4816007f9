"""QMC launcher of the PyTorch port: argparse front over ``RunSpec``.

    manager -> data server (sqlite DB) -> forwarder tree -> workers

Flags map onto ``launch.spec.RunSpec`` fields; ``build_run`` assembles the
stack.  Runs on the GPU unless ``--device cpu`` is given (process and grid
workers too).  ``--backend`` picks the execution substrate: ``thread``
(default), ``process`` (one spawned OS process a worker), ``sim`` (the
simulated grid: ``--sim-latency``, ``--sim-drop``) or ``grid`` (the TCP
grid: the manager listens on ``--listen`` and ``repro_torch.launch
.qmc_worker`` processes attach, localhost ones started here unless
``--no-local-workers``):

  PYTHONPATH=src python -m repro_torch.launch.qmc_run --system smallest \
      --method sem-vmc --walkers 256 --workers 1 --steps 5 --blocks 4
  PYTHONPATH=src python -m repro_torch.launch.qmc_run --system b-strand \
      --method fused-vmc --screen-eps 1e-8 --walkers 256 --workers 1
  PYTHONPATH=src python -m repro_torch.launch.qmc_run --system h2 \
      --method dmc --backend process --workers 2 --device cpu

Exits non-zero when a worker died during the run.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.spec import (BACKEND_NAMES, METHODS, GridConfig,
                                     RunSpec, SimGridConfig, build_run)


def parse_spec(argv=None) -> RunSpec:
    """CLI flags -> RunSpec."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--system', default='h2',
                    help='h|h2|heh+|water|smallest|b-strand|b-strand-tz|'
                         '1ze7|1amb')
    ap.add_argument('--method', choices=METHODS, default='vmc',
                    help='vmc, dmc, sem-vmc and fused-vmc are ported')
    ap.add_argument('--n-det', type=int, default=1,
                    help='CI expansion size (1: single determinant)')
    ap.add_argument('--backend', choices=BACKEND_NAMES, default='thread',
                    help='execution substrate for the workers')
    ap.add_argument('--workers', type=int, default=2)
    ap.add_argument('--walkers', type=int, default=32,
                    help='walkers per worker')
    ap.add_argument('--steps', type=int, default=50,
                    help='MC generations per sub-block')
    ap.add_argument('--blocks', type=int, default=20)
    ap.add_argument('--target-error', type=float, default=0.0)
    ap.add_argument('--wall-clock', type=float, default=0.0)
    ap.add_argument('--tau', type=float, default=0.0)
    ap.add_argument('--screen-eps', type=float, default=-1.0,
                    help='AO screening tolerance of the cell-list '
                         'distance screening (negative: off; 0: drop only '
                         'exact zeros; e.g. 1e-8)')
    ap.add_argument('--device', default=None,
                    help='cuda (default; raises without a GPU) or cpu')
    ap.add_argument('--db', default=':memory:')
    ap.add_argument('--e-trial', type=float, default=None,
                    help='[dmc] initial reference energy E_T (default: '
                         '-0.5 Ha per electron)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--sim-latency', type=float, default=0.0,
                    help='[sim backend] seconds per worker->tree send')
    ap.add_argument('--sim-drop', type=float, default=0.0,
                    help='[sim backend] per-packet loss probability')
    ap.add_argument('--listen', default='127.0.0.1:0', metavar='HOST:PORT',
                    help='[grid backend] TCP listen address for workers '
                         '(port 0: ephemeral, printed at startup)')
    ap.add_argument('--no-local-workers', action='store_true',
                    help='[grid backend] do not spawn localhost workers; '
                         'wait for remote qmc_worker processes to attach')
    ap.add_argument('--heartbeat-timeout', type=float, default=2.0,
                    help='[grid backend] silence after which a worker is '
                         'declared dead (its lease is re-queued)')
    args = ap.parse_args(argv)
    from repro_torch.launch.qmc_worker import parse_address
    host, port = parse_address(args.listen)
    return RunSpec(
        system=args.system, method=args.method, n_det=args.n_det,
        tau=args.tau, e_trial=args.e_trial, screen_eps=args.screen_eps,
        n_walkers=args.walkers, steps=args.steps, backend=args.backend,
        n_workers=args.workers,
        grid=SimGridConfig(latency=args.sim_latency, drop_rate=args.sim_drop,
                           seed=args.seed),
        net=GridConfig(host=host, port=port,
                       heartbeat_timeout=args.heartbeat_timeout,
                       local_workers=not args.no_local_workers),
        device=args.device, max_blocks=args.blocks,
        target_error=args.target_error, wall_clock_limit=args.wall_clock,
        db=args.db, seed=args.seed)


def main(argv=None):
    """Parse flags, build the run, execute to completion, print stats."""
    spec = parse_spec(argv)
    run = build_run(spec)
    print(f'run_key={run.run_key} system={spec.system} '
          f'method={spec.method} backend={spec.backend} '
          f'device={run.sampler.device}: '
          f'{spec.n_workers} workers x {spec.n_walkers} walkers')
    if spec.backend == 'grid':
        host, port = run.backend.address
        print(f'grid listening on {host}:{port}; attach workers with: '
              f'python -m repro_torch.launch.qmc_worker --connect '
              f'{host}:{port}')
    avg = run.run()
    errors = run.worker_errors()
    for err in errors:
        print('WORKER ERROR:\n', err)
    print(avg)
    if errors:
        raise SystemExit(f'{len(errors)} worker(s) failed')
    return avg


if __name__ == '__main__':
    main()
