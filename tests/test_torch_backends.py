"""The port's execution backends and worker CLI, as the reference's
``tests/test_backends.py`` and ``tests/test_grid.py`` run them.

* the same small H2 ``RunSpec`` (``vmc`` and ``dmc``) completes on the
  ``thread``, ``process``, ``sim`` and ``grid`` substrates with
  ``device='cpu'`` and no worker error (``tests/test_backends.py:241``,
  ``tests/test_grid.py:359``), each energy within 3 sigma of the JAX
  package's on the same spec (thread backend);
* the simulated-grid chaos drill on a real sampler (worker crash,
  forwarder kill, packet loss) still converges, within 3 sigma of the
  reference's drill; a ``thread`` or ``sim`` run returns only after its
  worker threads end;
* the TCP grid's kill drill on a real sampler (3 ``qmc_worker`` processes,
  one SIGKILLed: declared dead, its lease requeued), within 3 sigma of the
  reference's thread run of the same spec; a grid worker resumed from a
  stored reservoir starts from its walkers bitwise; each worker's closing
  line states its kernel launches, and closing lines that share one
  stream are each read whole; a worker that joins after its
  forwarder died still reaches the store (``LiveTreeManager``).  The
  drills' heartbeat timeout is 5 s: the reference's 0.5 s drill fails
  on a loaded host.

The reference tests' fixed bands are not used for ``vmc``: their upper
edge (-1.00 Ha) is where this trial function's VMC energy lies (-1.0045
+/- 0.0136 for the port and -1.0083 +/- 0.0099 for the reference, 40-block
runs), so a short run's fluctuation decides them.  A run is compared with
the reference's run of the same spec instead.
* the grid backend starts the port's own ``qmc_worker`` (a Gaussian drill
  sampler through real TCP and subprocesses);
* the ``qmc_worker`` helpers, the payload's storage precision reaching
  the worker's sampler, and its refusal of a missing GPU;
* a ``BlockSampler`` pickles by value (CI, screening, DMC): the receiving
  side evaluates bitwise what the sender does, and a sampler that asked
  for the GPU refuses to come up on a host without one.
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from repro_torch.launch.spec import RunSpec, build_run  # noqa: E402
from repro_torch.runtime import (GridBackend, GridConfig,  # noqa: E402
                                 QMCManager, ResultDatabase, RunControl,
                                 SimGridConfig, make_backend)
from repro_torch.runtime.testing import GaussianSampler  # noqa: E402

H2 = dict(system='h2', n_workers=2, n_walkers=12, steps=10, max_blocks=6,
          equil_steps=30)
CHAOS = dict(system='h2', method='vmc', backend='sim', n_workers=3,
             n_walkers=12, steps=10, max_blocks=12)
CHAOS_GRID = dict(latency=0.001, drop_rate=0.1, seed=2,
                  worker_failures=((0, 1),), forwarder_failures=((1, 4),))
KILL = dict(system='h2', method='vmc', n_workers=3, n_walkers=12, steps=10,
            max_blocks=12)


@functools.lru_cache(maxsize=None)
def _jax_energy(kind):
    """The JAX package's run of the same spec: (energy, error)."""
    pytest.importorskip('jax')
    from repro.launch import spec as j_spec
    from repro.runtime import SimGridConfig as JSimGridConfig
    if kind == 'chaos':
        spec = j_spec.RunSpec(**CHAOS, grid=JSimGridConfig(**CHAOS_GRID))
    elif kind == 'kill':
        spec = j_spec.RunSpec(**KILL, backend='thread')
    else:
        spec = j_spec.RunSpec(**H2, method=kind, backend='thread')
    avg = j_spec.build_run(spec).run()
    return avg.energy, avg.error


def _within_3_sigma_of_jax(avg, kind):
    e_j, err_j = _jax_energy(kind)
    sigma = np.hypot(avg.error, err_j)
    assert np.isfinite(avg.energy) and sigma > 0
    assert abs(avg.energy - e_j) <= 3 * sigma, (avg, e_j, err_j)


@pytest.mark.parametrize('backend', ['thread', 'process', 'sim', 'grid'])
@pytest.mark.parametrize('method', ['vmc', 'dmc'])
def test_h2_runspec_on_every_backend(method, backend):
    """Every substrate completes the same small H2 RunSpec, DMC with E_T
    feedback on, within 3 sigma of the reference's run."""
    spec = RunSpec(**H2, method=method, backend=backend,
                   grid=SimGridConfig(latency=0.001, drop_rate=0.05, seed=1),
                   device='cpu')
    run = build_run(spec)
    avg = run.run()
    assert not run.worker_errors(), (backend, run.worker_errors())
    assert avg.n_blocks >= 6, (backend, avg)
    assert run.manager.control.e_trial_feedback == (method == 'dmc')
    _within_3_sigma_of_jax(avg, method)
    if backend == 'grid':
        workers = [h.proc.args for h in run.backend.handles]
        assert all(a[1:3] == ['-m', 'repro_torch.launch.qmc_worker']
                   and a[-2:] == ['--device', 'cpu'] for a in workers)


@pytest.mark.parametrize('backend', ['thread', 'sim'])
def test_thread_run_returns_after_its_workers_end(monkeypatch, backend):
    """A worker thread still inside a sub-block when the run stops (the
    ``thread`` and ``sim`` backends both run their workers as threads of
    this process): the manager's shutdown asks it to stop but waits only
    so long for it (10 s; 0.01 s here, against 1.5 s sub-blocks), and
    ``QMCRun.run`` returns only once it has ended, so nothing of the run
    computes after it returns."""
    import time
    from repro_torch.runtime.worker import Worker
    join = Worker.join
    monkeypatch.setattr(Worker, 'join',
                        lambda self, timeout=0.01: join(self, timeout))
    spec = RunSpec(system='h2', method='vmc', backend=backend, n_workers=1,
                   n_walkers=4, steps=2, subblocks_per_block=1, max_blocks=2,
                   device='cpu')
    run = build_run(spec)
    sub = run.sampler.run_subblock

    def _slow(*args, **kw):
        time.sleep(1.5)
        return sub(*args, **kw)
    monkeypatch.setattr(run.sampler, 'run_subblock', _slow)
    avg = run.run()
    assert avg.n_blocks >= 2 and np.isfinite(avg.energy)
    assert run.manager.workers
    assert not any(w.running for w in run.manager.workers)


def test_simgrid_chaos_drill_real_sampler_converges():
    """H2 VMC through a worker crash, a forwarder kill and 10 % packet
    loss still converges, as the reference's drill does."""
    spec = RunSpec(**CHAOS, device='cpu', grid=SimGridConfig(**CHAOS_GRID))
    avg = build_run(spec).run()
    assert avg.n_blocks >= 12
    _within_3_sigma_of_jax(avg, 'chaos')


def _await(cond, secs, what):
    import time
    deadline = time.monotonic() + secs
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def test_grid_kill_drill_real_sampler():
    """h2 ``vmc`` on 3 local ``qmc_worker --device cpu`` processes: once all
    are live and the store holds a block, one is SIGKILLed.  The heartbeat
    timeout declares it dead, with a reason, its lease is requeued, no
    other worker dies, and the survivors' energy is within 3 sigma of the
    reference's thread run of the same spec."""
    from repro_torch.launch.spec import LiveTreeManager
    from repro_torch.runtime.grid import DEAD, LIVE
    run = build_run(RunSpec(**KILL, backend='grid', device='cpu',
                            net=GridConfig(heartbeat_timeout=5.0)))
    mgr = run.manager
    assert isinstance(mgr, LiveTreeManager)
    mgr.start()
    _await(lambda: all(h.state == LIVE for h in mgr.workers)
           and mgr.db.n_blocks(run.run_key) > 0, 120, 'workers never came up')
    victim = mgr.workers[1]
    victim.crash()                              # SIGKILL + severed link
    _await(lambda: victim.state == DEAD, 60, 'the victim was never declared '
           'dead')
    avg = run.run()
    assert victim.dead_reason == 'heartbeat timeout'
    assert mgr.backend.stolen_requeued >= 1
    assert [e[2] for e in mgr.events if e[1] == 'dead'] == [1]
    assert [h.state for h in mgr.workers] == ['stopped', DEAD, 'stopped']
    assert not run.worker_errors(), run.worker_errors()
    assert avg.n_blocks >= KILL['max_blocks']
    _within_3_sigma_of_jax(avg, 'kill')


def test_grid_worker_resumes_from_the_stored_reservoir_bitwise(
        tmp_path, monkeypatch):
    """A worker that attaches to a run whose store holds a reservoir starts
    from walkers of it: the 16 restart walkers the manager draws arrive
    through the WELCOME's JSON bitwise, and the worker's first ensemble is
    exactly those walkers tiled to its width, evaluated bitwise as the
    manager's own sampler evaluates them."""
    import threading
    from repro_torch.launch import qmc_worker
    from repro_torch.launch.spec import spec_run_key
    from repro_torch.runtime.samplers import BlockSampler
    from repro_torch.systems import build_system
    spec = RunSpec(system='h2', method='vmc', backend='grid', n_workers=0,
                   n_walkers=40, steps=2, max_blocks=1, device='cpu',
                   db=str(tmp_path / 'resume.sqlite'),
                   net=GridConfig(local_workers=False, heartbeat_timeout=5.0))
    rng = np.random.default_rng(5)
    stored = rng.normal(size=(24, 2, 3)).astype(np.float32)
    store = ResultDatabase(spec.db)
    store.save_reservoir(spec_run_key(spec, *build_system('h2', device='cpu')),
                         stored, rng.normal(-1.1, 0.1, size=24))
    store.close()
    starts = []
    init_state = BlockSampler.init_state

    def _init_state(self, worker_id, seed, walkers=None):
        state = init_state(self, worker_id, seed, walkers)
        starts.append((self, walkers, state))
        return state
    monkeypatch.setattr(BlockSampler, 'init_state', _init_state)
    run = build_run(spec)
    host, port = run.backend.address
    manager = threading.Thread(target=run.run)
    manager.start()
    assert qmc_worker.main(['--connect', f'{host}:{port}', '--device', 'cpu',
                            '--blocks', '1']) == 0
    manager.join(60)
    assert not manager.is_alive() and not run.worker_errors()
    (sampler, got, (_, st, _)), = starts
    (h,) = run.manager.workers
    sent = np.asarray(h.init_walkers)
    assert sent.dtype == np.float32 and sent.shape == (16, 2, 3)
    assert {w.tobytes() for w in sent} <= {w.tobytes() for w in stored}
    assert np.asarray(got, np.float32).tobytes() == sent.tobytes()
    assert np.array_equal(got, sent.astype(np.float64))
    ens = sampler.driver.merge(st)
    tiled = np.concatenate([sent] * 3)[:40]           # 16 walkers to 40
    assert torch.equal(ens.r, torch.from_numpy(tiled))
    ref = run.sampler.driver.merge(
        init_state(run.sampler, h.worker_id, spec.seed, sent)[1])
    for k in ens._fields:
        assert torch.equal(getattr(ens, k), getattr(ref, k)), k


def test_qmc_worker_closing_line_states_kernel_launches(capfd):
    """Each spec worker process a grid run starts prints one closing line:
    its blocks, reconnects, first handshake and its launches of every
    CUDA kernel, all 0 on the CPU, where the plain versions run."""
    from repro_torch.kernels import launch_counters
    from repro_torch.launch.qmc_worker import closing_lines
    from repro_torch.runtime.grid import LIVE
    run = build_run(RunSpec(system='h2', method='vmc', backend='grid',
                            n_workers=2, n_walkers=8, steps=5, max_blocks=4,
                            device='cpu'))
    run.manager.start()
    _await(lambda: all(h.state == LIVE for h in run.manager.workers), 120,
           'workers never came up')
    run.run()
    lines = closing_lines(capfd.readouterr().out)
    assert sorted(lines) == [0, 1], lines
    for w, line in lines.items():
        assert line['launches'] == {k: 0 for k in launch_counters()}
        assert line['blocks'] == run.manager.workers[w].blocks_received
        assert line['reconnects'] == 0 and line['handshake_s'] > 0
        assert line['prepare_s'] >= line['gil_hold_s'] > 0


def test_closing_lines_glued_onto_one_line_are_each_read():
    """Two workers' closing lines that landed on one line, as unbuffered
    workers sharing a stream leave them (text, text, newline, newline),
    and one behind another process's unterminated output, are each read."""
    from repro_torch.launch.qmc_worker import closing_lines
    one = ('qmc_worker 0: 3 blocks (0 reconnects) {"handshake_s": 0.01, '
           '"launches": {"fused_sweep": 36, "sparse_mo": 28}}')
    two = ('qmc_worker 1: 2 blocks (1 reconnects) {"handshake_s": null, '
           '"launches": {"fused_sweep": 24, "sparse_mo": 19}}')
    text = f'start\n{one}{two}\n\nwarning: {{"x": 1}} partial {one}\n'
    lines = closing_lines(text)
    assert lines == {
        0: {'blocks': 3, 'reconnects': 0, 'handshake_s': 0.01,
            'launches': {'fused_sweep': 36, 'sparse_mo': 28}},
        1: {'blocks': 2, 'reconnects': 1, 'handshake_s': None,
            'launches': {'fused_sweep': 24, 'sparse_mo': 19}}}
    assert closing_lines('qmc_worker 2: 1 blocks (0 reconnects) {"a": \n'
                         ) == {}


def test_unbuffered_workers_sharing_a_stream_write_whole_lines(tmp_path):
    """``write_line`` writes a line with its newline at once: two
    unbuffered processes writing closing lines into one file leave every
    line whole, one to a line."""
    code = ('import sys\n'
            'from repro_torch.launch.qmc_worker import write_line\n'
            'for i in range(2000):\n'
            '    write_line(f"qmc_worker {sys.argv[1]}: {i} blocks '
            '(0 reconnects) {{\\"i\\": {i}}}")\n')
    env = dict(os.environ, PYTHONUNBUFFERED='1',
               PYTHONPATH=os.pathsep.join(filter(None, (
                   str(Path(__file__).resolve().parents[1] / 'src'),
                   os.environ.get('PYTHONPATH')))))
    log = tmp_path / 'shared.log'
    with open(log, 'wb') as f:
        procs = [subprocess.Popen([sys.executable, '-c', code, str(w)],
                                  stdout=f, env=env) for w in (0, 1)]
        assert [p.wait(timeout=120) for p in procs] == [0, 0]
    rows = log.read_text().split('\n')
    assert rows[-1] == '' and len(rows) == 4001
    seen = {0: [], 1: []}
    for row in rows[:-1]:
        w, rest = row.removeprefix('qmc_worker ').split(': ', 1)
        i = int(rest.split(' ', 1)[0])
        assert rest == f'{i} blocks (0 reconnects) {{"i": {i}}}', row
        seen[int(w)].append(i)
    assert seen == {0: list(range(2000)), 1: list(range(2000))}


def test_a_worker_that_joins_after_its_forwarder_died_reaches_the_store():
    """``build_run``'s manager attaches a worker that joins after the
    forwarder its id maps to was killed to a live ancestor, so its blocks
    reach the store (the runtime's ``QMCManager`` attaches it to the dead
    forwarder, which drops every block)."""
    from repro_torch.launch.spec import LiveTreeManager
    from repro_torch.runtime import ThreadBackend
    mgr = LiveTreeManager(GaussianSampler(delay=0.002), 'joiner',
                          RunControl(max_blocks=40, poll_interval=0.02),
                          db=ResultDatabase(), backend=ThreadBackend(3))
    mgr.start()
    mgr.kill_forwarder(1)
    late = mgr.add_worker()             # worker 3: forwarder 1 + 3 % 3
    avg = mgr.run()
    assert late.worker_id == 3 and not mgr.tree[1].alive
    assert late.forwarder is mgr.tree[0]
    assert sum(b.worker_id == 3 for b in mgr.db.blocks('joiner')) >= 1
    assert avg.n_blocks >= 40 and abs(avg.energy - (-3.0)) < 0.1


def test_grid_starts_the_ports_worker():
    """Two localhost workers of the port's ``qmc_worker`` (Gaussian drill
    sampler) attach over TCP and complete a run unbiased."""
    import time
    from repro_torch.runtime.grid import LIVE
    backend = GridBackend(2, net=GridConfig(
        worker_args=('--sampler', 'gauss:delay=0.005')))
    mgr = QMCManager(GaussianSampler(), 'g-port', RunControl(
        max_blocks=10, poll_interval=0.05), db=ResultDatabase(),
        backend=backend)
    mgr.start()
    deadline = time.monotonic() + 60.0
    while not all(h.state == LIVE for h in backend.handles):
        assert time.monotonic() < deadline, 'workers never came up'
        time.sleep(0.02)
    avg = mgr.run()
    assert not mgr.worker_errors(), mgr.worker_errors()
    assert avg.n_blocks >= 10
    assert abs(avg.energy - (-3.0)) < 0.1, avg
    assert len([e for e in mgr.events if e[1] == 'join']) == 2
    assert all(h.proc.args[2] == 'repro_torch.launch.qmc_worker'
               for h in backend.handles)


def test_make_backend_and_runspec_take_every_substrate():
    from repro_torch.runtime import (ProcessBackend, SimGridBackend,
                                     ThreadBackend)
    assert isinstance(make_backend('thread', 3), ThreadBackend)
    assert isinstance(make_backend('process', 2), ProcessBackend)
    sim = make_backend('sim', 2, grid=SimGridConfig(drop_rate=0.5))
    assert isinstance(sim, SimGridBackend) and sim.grid.drop_rate == 0.5
    grid = make_backend('grid', 0, net=GridConfig(heartbeat_timeout=9.0,
                                                  local_workers=False))
    try:
        assert isinstance(grid, GridBackend)
        assert grid.net.heartbeat_timeout == 9.0 and grid.address[1] > 0
    finally:
        grid.shutdown()
    for b in ('thread', 'process', 'sim', 'grid'):
        assert RunSpec(backend=b, method='dmc').backend == b
    with pytest.raises(ValueError, match='unknown backend'):
        make_backend('mpi', 2)


def test_qmc_run_flags_map_onto_the_spec():
    from repro_torch.launch.qmc_run import parse_spec
    spec = parse_spec(['--method', 'dmc', '--e-trial', '-1.1',
                       '--backend', 'grid', '--listen', '0.0.0.0:7777',
                       '--no-local-workers', '--heartbeat-timeout', '3',
                       '--sim-latency', '0.01', '--sim-drop', '0.2',
                       '--seed', '4'])
    assert (spec.method, spec.e_trial, spec.equil_steps) == ('dmc', -1.1,
                                                             100)
    assert (spec.net.host, spec.net.port, spec.net.local_workers,
            spec.net.heartbeat_timeout) == ('0.0.0.0', 7777, False, 3.0)
    assert (spec.grid.latency, spec.grid.drop_rate, spec.grid.seed) == (
        0.01, 0.2, 4)
    assert spec.resolved_tau() == 0.02


def test_qmc_worker_cli_helpers():
    from repro_torch.launch.qmc_worker import (make_sampler, parse_address,
                                               sampler_from_payload)
    from repro_torch.runtime.samplers import BlockSampler
    assert parse_address('10.0.0.1:7777') == ('10.0.0.1', 7777)
    with pytest.raises(ValueError):
        parse_address('no-port')
    s = make_sampler('gauss:delay=0.5,true_energy=-2.0,n_walkers=4')
    assert isinstance(s, GaussianSampler)
    assert s.delay == 0.5 and s.mu == -2.0 and s.n_walkers == 4
    assert make_sampler('spec') is None
    with pytest.raises(SystemExit):
        make_sampler('bogus')
    payload = dict(system='h2', method='dmc', n_det=1, ci_seed=0, tau=0.02,
                   e_trial=-1.1, equil_steps=3, n_walkers=4, steps=2,
                   screen_eps=-1.0)
    s = sampler_from_payload({'spec': payload}, device='cpu')
    assert isinstance(s, BlockSampler) and s.device.type == 'cpu'
    assert s.propagator.e_trial0 == -1.1 and s.driver.steps == 2
    s = sampler_from_payload({'spec': dict(payload, precision='bf16')},
                             device='cpu')
    assert s.propagator.cfg.precision == 'bf16'
    assert s.propagator.e_trial0 == -1.1 and s.driver.steps == 2
    with pytest.raises(SystemExit):
        sampler_from_payload({}, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            sampler_from_payload({'spec': payload})


def _sampler(name, method, **kw):
    from repro_torch.core.driver import make_propagator
    from repro_torch.runtime.samplers import BlockSampler
    from repro_torch.systems import build_system
    cfg, params = build_system(name, device='cpu', **kw)
    return BlockSampler(make_propagator(method, cfg, equil_steps=2), params,
                        n_walkers=6, steps=2, device='cpu')


@pytest.mark.parametrize('name,method,kw', [
    ('water', 'sem-vmc', dict(n_det=4)),
    ('smallest', 'fused-vmc', dict(screen_eps=1e-8)),
    ('h2', 'dmc', {})], ids=['ci', 'screened', 'dmc'])
def test_block_sampler_pickles_by_value(name, method, kw):
    """The sampler a spawned process worker receives evaluates bitwise what
    the sender's does, on the same walkers, and runs the same block."""
    from repro_torch.core.vmc import evaluate_ensemble, sample_positions
    s = _sampler(name, method, **kw)
    s2 = pickle.loads(pickle.dumps(s))
    assert s2.device == s.device and s2.n_walkers == s.n_walkers
    cfg, cfg2 = s.propagator.cfg, s2.propagator.cfg
    assert (cfg2.ci is None) == (cfg.ci is None)
    assert (cfg2.screening_t is None) == (cfg.screening_t is None)
    R = sample_positions(s.params, torch.Generator().manual_seed(1), 6,
                         cfg.n_elec)
    a = evaluate_ensemble(cfg, s.params, R)[0]
    b = evaluate_ensemble(cfg2, s2.params, R)[0]
    for k in a._fields:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    st, st2 = s.init_state(0, 3), s2.init_state(0, 3)
    (_, acc, walkers, _), (_, acc2, walkers2, _) = (s.run_subblock(st, 0),
                                                   s2.run_subblock(st2, 0))
    assert acc == acc2
    np.testing.assert_array_equal(walkers, walkers2)


def test_unpickled_sampler_refuses_a_missing_gpu():
    """A sampler shipped with device 'cuda' to a host without one raises;
    it never comes up on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the cuda device is valid here')
    from repro_torch.runtime.samplers import BlockSampler
    state = _sampler('h2', 'vmc').__getstate__()
    state['device'] = 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        BlockSampler.__new__(BlockSampler).__setstate__(state)


def test_first_cuda_linalg_call_is_made_once_across_worker_threads(
        monkeypatch):
    """``device.load_linalg``, which every ``BlockSampler.init_state``
    calls first: of worker threads that reach it at once for a CUDA
    device, one makes the process's first ``torch.linalg`` call and the
    others wait for it (torch raises "lazy wrapper should be called at
    most once" in a thread whose first call overlaps another's, as two
    ``thread``-backend workers of a fresh process did on the card); the
    CPU makes no call.  The call is counted, not run (no GPU here)."""
    import threading
    import time
    from repro_torch import device as t_device
    calls = []

    def fake_slogdet(a):
        calls.append(threading.get_ident())
        time.sleep(0.05)
    monkeypatch.setattr(t_device, '_linalg_loaded', False)
    monkeypatch.setattr(torch.linalg, 'slogdet', fake_slogdet)
    monkeypatch.setattr(torch, 'eye', lambda n, device=None: None)
    t_device.load_linalg('cpu')
    assert calls == []
    threads = [threading.Thread(target=t_device.load_linalg,
                                args=(torch.device('cuda'),))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and t_device._linalg_loaded
    t_device.load_linalg('cuda')
    assert len(calls) == 1
