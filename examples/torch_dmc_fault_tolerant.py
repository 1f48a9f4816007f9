"""End-to-end production driver on the PyTorch/CUDA port: fault-tolerant
DMC through the full runtime (manager -> data server -> forwarder tree ->
workers), exercising every §V mechanism of the paper on a real molecule
(``examples/dmc_fault_tolerant.py`` is the same run on the JAX package):

  * one declarative ``RunSpec`` compiled by ``build_run`` (swap
    ``backend='thread'`` for ``'process'`` or ``'sim'`` to change the
    execution substrate without touching anything else);
  * a few hundred droppable block averages accumulated in the sqlite DB;
  * a worker hard-crash mid-run (its in-flight block is simply absent);
  * an elastic worker joining mid-run;
  * graceful stop: truncated blocks are flushed, not lost;
  * checkpoint/restart: a second run on the same DB resumes from the
    energy-stratified walker reservoir and extends the same averages.

The workers are threads of this process, all on one GPU (``--device
cpu``: on the CPU).  By default the crash and the join follow the JAX
version's sleeps (15 s, then 5 s); ``main(kill_at_blocks=k)`` instead
crashes worker 0 once the store holds k blocks and joins the replacement
once the crashed worker has stopped (after ``join_after`` more seconds).

    PYTHONPATH=src python examples/torch_dmc_fault_tolerant.py [--device cpu]
"""
import argparse
import tempfile
import time
from pathlib import Path

from repro_torch.launch.spec import RunSpec, build_run


# bound of each event-driven wait (seconds)
WAIT_TIMEOUT = 600.0


def _wait_for(cond, what: str) -> None:
    t_end = time.monotonic() + WAIT_TIMEOUT
    while not cond():
        if time.monotonic() > t_end:
            raise TimeoutError(f'no {what} after {WAIT_TIMEOUT:.0f} s')
        time.sleep(0.01)


def main(device=None, kill_after: float = 15.0, join_after: float = 5.0,
         extra_blocks: int = 100, max_blocks: int = 200,
         kill_at_blocks: int | None = None, db=None) -> dict:
    """Run 1 (crash, elastic join, graceful stop), then run 2 from the
    reservoir.  ``db``: the sqlite file (default: a fresh temporary one).
    Returns ``avg1``,
    ``avg2`` (``RunningAverage``), ``restarted`` (run 2's workers seeded
    from the reservoir), ``killed_running`` (whether the crashed worker
    still ran when run 1 ended), ``run_keys`` (both runs'), the store's
    block count at the crash, ``blocks_at_kill``, and ``t``, the
    ``time.monotonic()`` stamps of run 1's ``start``, ``kill``, ``join``
    and ``end``."""
    db_path = Path(db) if db is not None else (
        Path(tempfile.mkdtemp()) / 'h2_dmc.sqlite')
    spec = RunSpec(system='h2', method='dmc', e_trial=-1.17,
                   equil_steps=60, n_walkers=24, steps=25,
                   backend='thread', n_workers=4, subblocks_per_block=2,
                   max_blocks=max_blocks, poll_interval=0.1,
                   db=str(db_path), device=device)

    print(f'== run 1: 4 workers, target {max_blocks} blocks  (db: {db_path})')
    run = build_run(spec)
    mgr = run.manager
    t = dict(start=time.monotonic())
    mgr.start()

    def stored():
        return run.db.n_blocks(run.run_key)
    if kill_at_blocks is None:
        time.sleep(kill_after)
    else:
        _wait_for(lambda: stored() >= kill_at_blocks,
                  f'{kill_at_blocks} stored blocks')
    print('   !! hard-killing worker 0 (no flush — block dropped, no bias)')
    killed = mgr.workers[0]
    blocks_at_kill = stored()
    t['kill'] = time.monotonic()
    mgr.remove_worker(killed, graceful=False)
    if kill_at_blocks is not None:
        _wait_for(lambda: not killed.running, 'stop of worker 0')
    time.sleep(join_after)
    print('   ++ elastic join: adding a replacement worker')
    t['join'] = time.monotonic()
    mgr.add_worker()

    # the manager's run loop to the graceful stop, then the wait for its
    # worker threads (QMCRun.run: mgr.run() and the join of every worker)
    avg1 = run.run()
    t['end'] = time.monotonic()
    print(f'   run 1 done: {avg1}')
    assert not run.worker_errors(), run.worker_errors()

    print(f'== run 2: restart from the walker reservoir, +{extra_blocks} '
          'blocks')
    run2 = build_run(spec.replace(n_workers=2,
                                  max_blocks=avg1.n_blocks + extra_blocks))
    run2.manager.start()
    restarted = sum(w.init_walkers is not None for w in run2.manager.workers)
    print(f'   {restarted}/2 workers seeded from the checkpoint reservoir')
    avg2 = run2.run()
    print(f'   run 2 done: {avg2}')
    assert not run2.worker_errors(), run2.worker_errors()
    print(f'== final: E = {avg2.energy:+.5f} +/- {avg2.error:.5f} '
          f'(exact H2: -1.1745; {avg2.n_blocks} blocks survive crashes, '
          'elasticity, restart)')
    return dict(avg1=avg1, avg2=avg2, restarted=restarted,
                killed_running=killed.running,
                run_keys=(run.run_key, run2.run_key),
                blocks_at_kill=blocks_at_kill, t=t)


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    main(device=ap.parse_args().device)
