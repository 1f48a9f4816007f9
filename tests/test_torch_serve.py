"""The run service of the PyTorch port (``repro_torch.serve``,
``repro_torch.launch.qmc_serve`` / ``qmc_client``) as the reference's
``tests/test_serve.py`` runs it, case for case: the scheduler, the engine
with the torch-free Gaussian builder, the protocol over real TCP, and the
``qmc_serve`` / ``qmc_client`` subprocesses with the SIGKILL drill.

Beyond the reference's cases:

* one real-physics run through ``default_builder`` on the CPU (h2
  ``fused-vmc --precision bf16``, ``device='cpu'``): finite and within 3
  sigma of the reference service's run of the same spec (without
  ``device``, which the reference has not);
* a ``fork`` of that run that changes ``precision``: a fresh run key,
  seeded from the parent's reservoir;
* the spec payload: ``spec_from_payload(spec_to_payload(s)) == s``, the
  reference's payload of a spec parses here into the port's spec, and a
  spec ``build_run`` registered reloads from the result store, the grid
  and net tuples included.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip('torch')

from repro_torch.launch.spec import (RunSpec, build_run,  # noqa: E402
                                     spec_from_payload, spec_to_payload)
from repro_torch.runtime import (GridConfig, ResultDatabase,  # noqa: E402
                                 SimGridConfig)
from repro_torch.serve import (QMCService, QMCServiceServer,  # noqa: E402
                               ServiceClient, ServiceError, fair_shares,
                               gaussian_builder)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'src')


def _spec(**kw):
    kw.setdefault('system', 'h2')
    kw.setdefault('method', 'vmc')
    kw.setdefault('n_workers', 2)
    kw.setdefault('max_blocks', 6)
    kw.setdefault('poll_interval', 0.02)
    return RunSpec(**kw)


@pytest.fixture()
def svc():
    s = QMCService(total_workers=4, builder=gaussian_builder,
                   poll_interval=0.02)
    yield s
    s.close()


# ---------------------------------------------------------------------------
# scheduler (pure)
# ---------------------------------------------------------------------------
def test_fair_shares_splits_evenly_with_remainder_to_earliest():
    assert fair_shares(4, {'a': 4, 'b': 4}) == {'a': 2, 'b': 2}
    assert fair_shares(5, {'a': 4, 'b': 4}) == {'a': 3, 'b': 2}


def test_fair_shares_caps_at_request_and_redistributes():
    assert fair_shares(8, {'a': 1, 'b': 4}) == {'a': 1, 'b': 4}
    assert fair_shares(3, {'a': 1, 'b': 4, 'c': 4}) == \
        {'a': 1, 'b': 1, 'c': 1}


def test_fair_shares_starves_latest_when_runs_exceed_pool():
    shares = fair_shares(2, {'a': 2, 'b': 2, 'c': 2})
    assert shares == {'a': 1, 'b': 1, 'c': 0}
    assert fair_shares(0, {'a': 2}) == {'a': 0}


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def test_two_concurrent_runs_share_the_pool_and_converge(svc):
    a = svc.submit(_spec(system='h2'))
    b = svc.submit(_spec(system='water', seed=3))
    sa, sb = svc.wait(a, 60), svc.wait(b, 60)
    assert sa['state'] == 'done' and sb['state'] == 'done'
    assert sa['run_key'] != sb['run_key']
    for s in (sa, sb):
        assert s['n_blocks'] >= 6
        assert abs(s['energy'] - (-3.0)) < 0.1       # Gaussian mean
    assert min(sa['n_blocks'], sb['n_blocks']) > 0


def test_extend_continues_the_stored_average(svc):
    a = svc.submit(_spec())
    sa = svc.wait(a, 60)
    key = sa['run_key']
    before = svc.store.running_average(key)
    c = svc.extend(key, 4)
    assert svc.store.running_average(key) == before
    sc = svc.wait(c, 60)
    assert sc['state'] == 'done'
    assert sc['run_key'] == key
    assert sc['n_blocks'] > before.n_blocks


def test_fork_gets_fresh_key_and_parent_reservoir(svc):
    a = svc.submit(_spec())
    sa = svc.wait(a, 60)
    key = sa['run_key']
    assert svc.store.load_reservoir(key) is not None
    d = svc.fork(key, tau=0.7)
    sd = svc.wait(d, 60)
    assert sd['state'] == 'done'
    assert sd['run_key'] != key
    assert sd['parent_key'] == key
    assert svc.store.load_reservoir(sd['run_key']) is not None


def test_cancel_running_and_queued(svc):
    a = svc.submit(_spec(max_blocks=100000))
    deadline = time.monotonic() + 30
    while svc.status(a)['n_blocks'] == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    svc.cancel(a)
    sa = svc.wait(a, 60)
    assert sa['state'] == 'cancelled'
    assert sa['n_blocks'] < 100000


def test_failed_build_reports_traceback():
    def broken_builder(spec, db):
        raise RuntimeError('no such wavefunction')

    s = QMCService(builder=broken_builder, poll_interval=0.02)
    try:
        a = s.submit(_spec())
        sa = s.wait(a, 30)
        assert sa['state'] == 'failed'
        assert 'no such wavefunction' in sa['detail']
    finally:
        s.close()


def test_subscribe_streams_stats_to_a_final_state(svc):
    a = svc.submit(_spec())
    q = svc.subscribe(a)
    events = []
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        ev = q.get(timeout=30)
        events.append(ev)
        if ev['state'] in ('done', 'failed', 'cancelled'):
            break
    assert events[-1]['state'] == 'done'
    assert any(ev['event'] == 'stats' for ev in events)


# ---------------------------------------------------------------------------
# protocol: server + client round trip (in-process, real TCP)
# ---------------------------------------------------------------------------
@pytest.fixture()
def served():
    service = QMCService(total_workers=4, builder=gaussian_builder,
                         poll_interval=0.02)
    server = QMCServiceServer(service)
    server.start()
    yield server
    server.stop()
    service.close()


def test_client_submit_status_list_wait(served):
    host, port = served.address
    with ServiceClient(host, port) as c:
        assert c.ping()['pong']
        run = c.submit(spec_to_payload(_spec()))
        run = c.wait(run['run_id'], 60)
        assert run['state'] == 'done'
        assert abs(run['energy'] - (-3.0)) < 0.1
        assert c.status(run['run_key'])['run_id'] == run['run_id']
        assert len(c.list()) == 1


def test_client_extend_fork_cancel_watch(served):
    host, port = served.address
    with ServiceClient(host, port) as c:
        run = c.submit(spec_to_payload(_spec()))
        events = list(c.watch(run['run_id']))
        assert events[-1]['event'] == 'final'
        assert events[-1]['state'] == 'done'
        key = events[-1]['run_key']

        ext = c.extend(key, 4)
        ext = c.wait(ext['run_id'], 60)
        assert ext['run_key'] == key and ext['state'] == 'done'

        fk = c.fork(key, {'tau': 0.7})
        fk = c.wait(fk['run_id'], 60)
        assert fk['run_key'] != key and fk['parent_key'] == key

        long = c.submit(spec_to_payload(_spec(max_blocks=100000)))
        c.cancel(long['run_id'])
        assert c.wait(long['run_id'], 60)['state'] == 'cancelled'


def test_client_errors_are_structured(served):
    host, port = served.address
    with ServiceClient(host, port) as c:
        with pytest.raises(ServiceError, match='unknown spec field'):
            c.submit({'bogus_field': 1})
        with pytest.raises(ServiceError, match='unknown run'):
            c.status('nope')
        with pytest.raises(ServiceError):
            c._rpc('not_an_op')


# ---------------------------------------------------------------------------
# full stack: qmc_serve + qmc_client subprocesses
# ---------------------------------------------------------------------------
def _start_server(db_path, extra=()):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'repro_torch.launch.qmc_serve', '--db',
         db_path, '--listen', '127.0.0.1:0', '--pool', '4', '--builder',
         'gaussian', '--poll-interval', '0.02', *extra],
        stdout=subprocess.PIPE, text=True, env=env)
    port = None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if 'listening on' in line:
            port = int(line.rsplit(':', 1)[1].split()[0])
            break
    assert port, 'qmc_serve never reported its port'
    return proc, port


def _client_cmd(port, *args):
    return [sys.executable, '-m', 'repro_torch.launch.qmc_client', '--port',
            str(port), *args]


def _client(port, *args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(_client_cmd(port, *args), capture_output=True,
                          text=True, timeout=120, env=env)


def test_two_clients_submit_extend_over_the_wire(tmp_path):
    db_path = str(tmp_path / 'serve.sqlite')
    proc, port = _start_server(db_path)
    try:
        env = dict(os.environ, PYTHONPATH=SRC)
        p1 = subprocess.Popen(
            _client_cmd(port, 'submit', '--system', 'h2', '--blocks', '6',
                        '--wait'), stdout=subprocess.PIPE, text=True, env=env)
        p2 = subprocess.Popen(
            _client_cmd(port, 'submit', '--system', 'water', '--seed', '3',
                        '--blocks', '6', '--wait'),
            stdout=subprocess.PIPE, text=True, env=env)
        out1, out2 = p1.communicate(timeout=120)[0], \
            p2.communicate(timeout=120)[0]
        assert p1.returncode == 0 and p2.returncode == 0
        assert 'done' in out1 and 'done' in out2
        assert 'E = -' in out1 and 'E = -' in out2

        r = _client(port, 'extend', 'r1', '--blocks', '4', '--wait')
        assert r.returncode == 0 and 'done' in r.stdout

        r = _client(port, 'list')
        assert r.stdout.count('done') == 3
        _client(port, 'shutdown')
        proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def test_sigkill_service_loses_no_committed_blocks(tmp_path):
    db_path = str(tmp_path / 'crash.sqlite')
    proc, port = _start_server(db_path)
    key = None
    try:
        r = _client(port, 'submit', '--blocks', '100000')
        assert r.returncode == 0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            r = _client(port, 'status', 'r1')
            if 'E = -' in r.stdout:
                key = r.stdout.split()[1]
                break
            time.sleep(0.1)
        assert key, 'no blocks committed before the drill'
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(30)
        if proc.poll() is None:                      # pragma: no cover
            proc.kill()

    db = ResultDatabase(db_path)
    n = db.n_blocks(key)
    assert n > 0
    report = db.validate_all(key)
    assert report['clean'] and report['rejects'] == {}
    assert db.get_run_spec(key) is not None
    db.close()

    proc2, port2 = _start_server(db_path)
    try:
        out = _client(port2, 'extend', key, '--blocks', '4', '--wait')
        assert out.returncode == 0 and 'done' in out.stdout
        db = ResultDatabase(db_path)
        assert db.n_blocks(key) > n - 1
        db.close()
        _client(port2, 'shutdown')
        proc2.wait(30)
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait(30)


# ---------------------------------------------------------------------------
# real physics through default_builder, on the CPU
# ---------------------------------------------------------------------------
REAL = dict(system='h2', method='fused-vmc', precision='bf16', n_workers=1,
            n_walkers=32, steps=10, max_blocks=8, seed=3, poll_interval=0.02)


@pytest.fixture(scope='module')
def real_service():
    """The port's service with ``default_builder`` and one finished h2
    ``fused-vmc --precision bf16`` run on the CPU."""
    s = QMCService(total_workers=2, poll_interval=0.02)
    rid = s.submit(RunSpec(**REAL, device='cpu'))
    status = s.wait(rid, 120)
    yield s, status
    s.close()


def test_default_builder_bf16_run_within_3_sigma_of_the_reference(
        real_service):
    pytest.importorskip('jax')
    from repro.launch.spec import RunSpec as JRunSpec
    from repro.serve import QMCService as JQMCService
    svc, t = real_service
    assert t['state'] == 'done', t['detail']
    assert t['n_blocks'] >= REAL['max_blocks']
    assert np.isfinite(t['energy']) and t['error_bar'] > 0
    run = svc._get(t['run_id']).run
    assert run.cfg.precision == 'bf16' and run.sampler.device.type == 'cpu'
    js = JQMCService(total_workers=2, poll_interval=0.02)
    try:
        j = js.wait(js.submit(JRunSpec(**REAL)), 300)
    finally:
        js.close()
    assert j['state'] == 'done', j['detail']
    sigma = np.hypot(t['error_bar'], j['error_bar'])
    assert abs(t['energy'] - j['energy']) <= 3 * sigma, (t, j)


def test_fork_that_changes_precision_gets_a_fresh_key(real_service):
    svc, parent = real_service
    assert parent['state'] == 'done', parent['detail']
    key = parent['run_key']
    child = svc.wait(svc.fork(key, precision='fp32', max_blocks=3), 120)
    assert child['state'] == 'done', child['detail']
    assert child['run_key'] not in (key, '') and child['parent_key'] == key
    assert svc._get(child['run_id']).run.cfg.precision == 'fp32'
    assert spec_from_payload(svc.store.get_run_spec(child['run_key'])) == \
        RunSpec(**dict(REAL, precision='fp32', max_blocks=3), device='cpu')
    assert svc.store.load_reservoir(child['run_key']) is not None
    assert np.isfinite(child['energy'])


# ---------------------------------------------------------------------------
# the spec payload
# ---------------------------------------------------------------------------
TUPLES = dict(grid=SimGridConfig(latency=0.01, seed=4,
                                 worker_failures=((0, 2), (1, 5)),
                                 forwarder_failures=((0, 3),)),
              net=GridConfig(port=7787, worker_args=('--sampler', 'gauss')))


@pytest.mark.parametrize('spec', [
    RunSpec(),
    RunSpec(system='water', method='fused-vmc', n_det=4, precision='fp16',
            screen_eps=1e-8, tau=0.4, device='cpu', seed=7, **TUPLES),
    RunSpec(method='opt-vmc', opt_solver='lm', e_trial=-1.1,
            ckpt_dir='ck', precision='bf16')], ids=['default', 'full', 'opt'])
def test_payload_round_trip(spec):
    import json
    payload = spec_to_payload(spec)
    assert json.loads(json.dumps(payload)) == payload
    assert spec_from_payload(json.loads(json.dumps(payload))) == spec


def test_reference_payload_parses_in_the_port():
    pytest.importorskip('jax')
    from repro.launch import spec as j_spec
    from repro.runtime import GridConfig as JGridConfig
    from repro.runtime import SimGridConfig as JSimGridConfig
    kw = dict(system='water', method='sem-vmc', n_det=4, precision='bf16',
              tau=0.4, seed=7, max_blocks=3)
    j = j_spec.RunSpec(**kw, grid=JSimGridConfig(
        worker_failures=((0, 2),)), net=JGridConfig(worker_args=('-x',)))
    t = spec_from_payload(j_spec.spec_to_payload(j))
    assert t == RunSpec(**kw, grid=SimGridConfig(worker_failures=((0, 2),)),
                        net=GridConfig(worker_args=('-x',)))
    assert set(spec_to_payload(t)) == set(j_spec.spec_to_payload(j)) | {
        'device'}
    with pytest.raises(ValueError, match='unknown spec field'):
        spec_from_payload(dict(spec_to_payload(t), mesh=2))


def test_build_run_registers_a_payload_that_reloads(tmp_path):
    """``build_run`` stores the JSON payload under the run key; after a
    round trip through the result store it rebuilds the same spec, the
    grid and net tuples included (what ``extend`` and ``fork`` reload)."""
    spec = RunSpec(system='h2', method='sem-vmc', precision='bf16',
                   n_workers=1, device='cpu', db=str(tmp_path / 'r.sqlite'),
                   **TUPLES)
    run = build_run(spec)
    key = run.run_key
    run.db.close()
    db = ResultDatabase(spec.db)
    try:
        assert spec_from_payload(db.get_run_spec(key)) == spec
    finally:
        db.close()


# ---------------------------------------------------------------------------
# the fused-sweep tuner under the service's threads
# ---------------------------------------------------------------------------
def test_tuner_measures_one_geometry_once_across_threads(tmp_path):
    """Two sampler threads ask for one uncached geometry at once: one
    thread measures (through a stubbed timer, on the CPU's plain sweep),
    the other waits for its value; the stub records one measurement."""
    import threading
    from repro_torch.kernels.fused_sweep import autotune
    timed = []

    def timer(fn):
        fn()
        timed.append(threading.get_ident())
        time.sleep(0.05)                 # hold the miss path open
        return 1.0 / len(timed)          # later candidates time faster

    def measure(n_e, W, candidates):
        return autotune._measure(n_e, W, candidates, timer=timer,
                                 device='cpu')
    path = tmp_path / 'tiles.json'
    go, got = threading.Barrier(2), []

    def ask():
        go.wait()
        got.append(autotune.best_threads(14, 3, path=path, measure=measure))
    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(timed) == 4 and len(set(timed)) == 1   # one measurement
    assert got == [512, 512]
    assert json.loads(path.read_text())['tiles'] == {'14|3|fp32|cuda': 512}


def test_tuner_cache_writes_from_threads_do_not_collide(tmp_path,
                                                        monkeypatch):
    """Each writer's temp file is its own (process and thread): two threads
    storing at once write two temp files, and leave one whole JSON
    document and no temp file."""
    import threading
    from repro_torch.kernels.fused_sweep import autotune
    path = tmp_path / 'tiles.json'
    real, temps = os.replace, []

    def replace(src, dst):
        temps.append(str(src))
        real(src, dst)
    monkeypatch.setattr(autotune.os, 'replace', replace)
    go = threading.Barrier(2)

    def write(i):
        go.wait()
        autotune._store_tiles(path, {f'{i}|3|fp32|cuda': 64})
    threads = [threading.Thread(target=write, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(temps) == 2 and len(set(temps)) == 2
    doc = json.loads(path.read_text())
    assert doc['schema'] == 1 and len(doc['tiles']) == 1
    assert not list(tmp_path.glob('*.tmp*'))
