"""QMC launcher of the PyTorch port: argparse front over ``RunSpec``.

    manager -> data server (sqlite DB) -> forwarder tree -> workers

Flags map onto ``launch.spec.RunSpec`` fields; ``build_run`` assembles the
stack.  Runs on the GPU unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.qmc_run --system smallest \
      --method sem-vmc --walkers 256 --workers 1 --steps 5 --blocks 4
  PYTHONPATH=src python -m repro_torch.launch.qmc_run --system b-strand \
      --method fused-vmc --screen-eps 1e-8 --walkers 256 --workers 1

Exits non-zero when a worker died during the run.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.spec import BACKEND_NAMES, METHODS, RunSpec, build_run


def parse_spec(argv=None) -> RunSpec:
    """CLI flags -> RunSpec."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--system', default='h2',
                    help='h2|water|smallest|b-strand|b-strand-tz|1ze7|1amb')
    ap.add_argument('--method', choices=METHODS, default='vmc',
                    help='vmc, sem-vmc and fused-vmc are ported')
    ap.add_argument('--n-det', type=int, default=1,
                    help='CI expansion size (1: single determinant)')
    ap.add_argument('--backend', choices=BACKEND_NAMES, default='thread',
                    help='execution substrate (only thread is ported)')
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
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    return RunSpec(
        system=args.system, method=args.method, n_det=args.n_det,
        tau=args.tau, screen_eps=args.screen_eps,
        n_walkers=args.walkers, steps=args.steps, backend=args.backend,
        n_workers=args.workers, device=args.device, max_blocks=args.blocks,
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
