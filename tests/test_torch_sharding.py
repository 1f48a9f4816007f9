"""Walker-axis sharding of the PyTorch port (``--shards N``) on the CPU.

The shards are threads of this process, each on ``cpu`` (torch has one
CPU device; the reference's own tests use virtual CPU devices).  Every
collective waits at most ``TIMEOUT`` seconds, so a deadlock fails one test
instead of stalling the run.

* ``Population`` collectives at 1, 2 and 4 shards against the plain
  reductions (gather exact, means rel 1e-6, a bool mean exact), and the
  exchange under a stress of eight threads and a short switch interval;
* one h2 ``vmc`` and one ``dmc`` block single-device against 8 shards (64
  walkers, 20 steps: the reference's ``_consistency_check``); water
  ``sem-vmc`` and ``fused-vmc`` (8 shards, 32 walkers, 5 sweeps) with the
  running inverses against a fresh recompute and the running logdet equal
  to the single-device one; water ``sem-vmc --n-det 4``
  and h2 ``opt-vmc``'s moments sharded against single.  Positions agree
  within ``POS_TOL`` (identical accept decisions: a flipped one moves a
  walker by ~0.5 bohr; the largest difference is printed, 0 on water,
  ~1e-6 on h2 where the dense GEMM rounds by batch size), statistics
  within rel 1e-5;
* one DMC generation with 2 and 4 shards under the reference's injected
  draws against ``repro.core.dmc.DMCPropagator.propagate`` on one device;
* ``core.vmc.vmc_step`` (the single-device helper) against the
  reference's under its draws;
* ``RunSpec(shards=2)`` on thread/sim and refused on process/grid,
  ``walkers_devices``, pickling, a shard that raises, ``qmc_run --shards``.
"""
import pickle
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.core import dmc as j_dmc  # noqa: E402
from repro.core import vmc as j_vmc  # noqa: E402
from repro.core.driver import Population as JPopulation  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402

from repro_torch.core import dmc as t_dmc  # noqa: E402
from repro_torch.core import sem as t_sem  # noqa: E402
from repro_torch.core import vmc as t_vmc  # noqa: E402
from repro_torch.core.driver import (EnsembleDriver, Population,  # noqa
                                     ShardGroup, WALKER_AXIS,
                                     make_propagator)
from repro_torch.launch.spec import RunSpec, build_run  # noqa: E402
from repro_torch.runtime.samplers import BlockSampler  # noqa: E402
from repro_torch.sharding import walkers_devices  # noqa: E402
from repro_torch.systems import build_system  # noqa: E402
from repro_torch.systems.convert import dmc_state_from_numpy  # noqa: E402

from test_torch_dmc import (_j, _j_evaluate, _jax_draws, _t,  # noqa: E402
                            _tol, _walkers, port_of)

TIMEOUT = 60.0     # seconds any shard waits at one collective
POS_TOL = 1e-5     # positions: far below one accepted move
STAT_RTOL = 1e-5


def _cpus(n):
    return ['cpu'] * n


def _in_shards(n, fn, timeout=TIMEOUT):
    """fn(pop) in n shard threads of one ShardGroup -> results by rank."""
    group = ShardGroup(n, timeout=timeout)
    out, errors = [None] * n, []

    def _run(k):
        try:
            out[k] = fn(Population(group, k))
        except BaseException as exc:  # noqa: BLE001  (re-raised below)
            errors.append(exc)
            group.abort()
    threads = [threading.Thread(target=_run, args=(k,), daemon=True)
               for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 5)
        assert not t.is_alive(), 'a shard thread did not finish'
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('n_shards', [1, 2, 4])
def test_population_collectives_match_plain_reductions(n_shards):
    g = torch.Generator().manual_seed(n_shards)
    W = 16
    x = torch.randn((W, 3, 2), generator=g)
    mask = torch.rand((W,), generator=g) < 0.5
    m = W // n_shards

    def _local(pop):
        k = pop.shard_index()
        sl = slice(k * m, (k + 1) * m)
        return dict(size=pop.size(x[sl]), gather=pop.gather(x[sl]),
                    tup=pop.gather((x[sl], mask[sl])),
                    mean=pop.mean(x[sl]), mean0=pop.mean0(x[sl]),
                    sum=pop.sum(x[sl]), bool=pop.mean(mask[sl]),
                    local=pop.take_local(torch.arange(W), m))
    if n_shards == 1:
        res = [_local(Population())]
    else:
        res = _in_shards(n_shards, _local)
    for k, r in enumerate(res):
        assert r['size'] == W
        assert torch.equal(r['gather'], x)
        assert torch.equal(r['tup'][0], x) and torch.equal(r['tup'][1], mask)
        np.testing.assert_allclose(r['mean'].numpy(), torch.mean(x).numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r['mean0'].numpy(),
                                   torch.mean(x, dim=0).numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r['sum'].numpy(), torch.sum(x).numpy(),
                                   rtol=1e-6, atol=1e-6)
        # a 0/1 mean over power-of-two walkers per shard is exact
        assert float(r['bool']) == float(mask.to(torch.float32).mean())
        assert torch.equal(r['local'], torch.arange(W)[k * m:(k + 1) * m])
        # every shard holds the same result
        assert torch.equal(r['mean'], res[0]['mean'])


def test_exchange_under_thread_stress():
    """Eight shards (more than the cores), 400 rounds, a switch interval
    of 1 us: every shard sees every shard's value of its own round, so a
    buffer written before all shards took the previous round would
    show."""
    n, rounds = 8, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        group = ShardGroup(n, timeout=TIMEOUT)
        bad = []

        def _run(k):
            for i in range(rounds):
                got = group.exchange(k, (k, i))
                if got != [(j, i) for j in range(n)]:
                    bad.append((k, i, got))
        threads = [threading.Thread(target=_run, args=(k,), daemon=True)
                   for k in range(n)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not bad, bad[:3]
    assert time.perf_counter() - t0 < TIMEOUT


# ---------------------------------------------------------------------------
# sharded blocks against single-device ones
# ---------------------------------------------------------------------------
def _block(prop, params, n_walkers, steps, n_shards, seed=0):
    devices = _cpus(n_shards) if n_shards > 1 else None
    drv = EnsembleDriver(prop, steps, devices=devices, timeout=TIMEOUT)
    g = torch.Generator().manual_seed(seed)
    st = drv.init(params, g, n_walkers)
    st, stats = drv.run_block(params, st, g)
    return drv, st, stats


def _assert_stats_close(a, b, tag, rtol=STAT_RTOL, atol=1e-6):
    for f in ('weight', 'e_mean', 'e2_mean'):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=rtol,
                                   atol=atol, err_msg=f'{tag} {f}')
    assert set(a.aux) == set(b.aux)
    for k in a.aux:
        np.testing.assert_allclose(b.aux[k], a.aux[k], rtol=rtol, atol=atol,
                                   err_msg=f'{tag} {k}')


def _compare(tag, drv1, st1, s1, drvn, stn, sn, **kw):
    e1, en = drv1.merge(st1), drvn.merge(stn)
    d = float(torch.max(torch.abs(e1.r - en.r)))
    print(f'{tag}: largest position difference {d:.3g} '
          f'(bitwise: {torch.equal(e1.r, en.r)})')
    assert d <= POS_TOL, f'{tag}: walker paths differ by {d}'
    assert torch.equal(e1.sign, en.sign)
    _assert_stats_close(s1, sn, tag, **kw)
    return e1, en


@pytest.mark.parametrize('method', ['vmc', 'dmc'])
def test_h2_block_sharded_matches_single_device(method):
    cfg, params = build_system('h2', device='cpu')
    prop = make_propagator(method, cfg, e_trial=-1.17, equil_steps=0)
    one = _block(prop, params, 64, 20, 1)
    eight = _block(prop, params, 64, 20, 8)
    assert isinstance(eight[1], list) and len(eight[1]) == 8
    assert all(EnsembleDriver._ensemble_part(s).r.shape[0] == 8
               for s in eight[1])
    _compare(f'h2 {method}', *one, *eight)


def _tracks_fresh(tag, cfg, params, ens, tol=1e-4):
    """The running inverses against a fresh recompute (the port's
    tolerance: minv within 1e-4 relative to the block's magnitude, the
    sign exact, on every walker).  The running logdet's distance from the
    fresh one (tolerance 1e-4 + 2e-6 relative) is printed: from a raw cold
    start one water walker of 32 passes it after 5 sweeps, in the
    single-device run alike (fp32 rounding of log|ratio| sums, DESIGN.md
    §6; ROADMAP Queue C), and the sharded logdet is asserted equal to the
    single-device one instead."""
    fresh = t_sem.evaluate_sem(cfg, params, ens.r)
    for f in ('minv_up', 'minv_dn'):
        a = getattr(ens, f).double()
        b = getattr(fresh, f).double()
        if a.numel():
            scale = max(float(b.abs().max()), 1.0)
            assert float((a - b).abs().max()) / scale <= tol, f
    assert torch.equal(ens.sign, fresh.sign)
    d = (ens.logdet - fresh.logdet).abs()
    over = d > tol + 2e-6 * fresh.logdet.abs()
    print(f'{tag}: running logdet vs fresh: largest {float(d.max()):.3g}, '
          f'{int(over.sum())} of {d.numel()} walkers beyond 1e-4 + 2e-6 rel')


@pytest.mark.parametrize('method,n_det', [('sem-vmc', 1), ('fused-vmc', 1),
                                          ('sem-vmc', 4)])
def test_water_sweeps_sharded_match_single_device(method, n_det):
    cfg, params = build_system('water', n_det=n_det, ci_seed=3,
                               device='cpu')
    prop = make_propagator(method, cfg)
    one = _block(prop, params, 32, 5, 1)
    eight = _block(prop, params, 32, 5, 8)
    tag = f'water {method} n_det={n_det}'
    e1, en = _compare(tag, *one, *eight)
    for f in ('minv_up', 'minv_dn', 'logdet', 'log_psi', 'e_loc', 'p_up',
              'rdet_up'):
        np.testing.assert_allclose(getattr(en, f).numpy(),
                                   getattr(e1, f).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f'{tag} {f}')
    _tracks_fresh(tag, prop.cfg, params, en)
    for st in eight[1]:
        assert st.sweeps == one[1].sweeps == 5


def test_opt_vmc_moments_sharded_match_single_device():
    cfg, params = build_system('h2', device='cpu')
    prop = make_propagator('opt-vmc', cfg)
    one = _block(prop, params, 32, 4, 1)
    four = _block(prop, params, 32, 4, 4)
    _compare('h2 opt-vmc', *one, *four)
    for k in ('opt_o', 'opt_eo', 'opt_oo', 'opt_oeo'):
        assert one[2].aux[k].shape == four[2].aux[k].shape
        assert np.all(np.isfinite(four[2].aux[k]))


# ---------------------------------------------------------------------------
# one DMC generation under the reference's draws
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module', params=['h2', 'water'])
def dmc_ref(request):
    cfg, params = j_build_system(request.param)
    R = _walkers(cfg, params, seed=7, n_draw=32)
    ens = _j_evaluate(cfg)(params, jnp.asarray(R))
    e_t = float(np.mean(_j(ens.e_loc)))
    hist = np.random.default_rng(1).normal(0, 0.01, 20).astype(np.float32)
    st = j_dmc.DMCState(ens=ens, log_w_hist=jnp.asarray(hist),
                        e_trial=jnp.float32(e_t))
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(key, st.ens.r.shape)
    prop_j = j_dmc.DMCPropagator(cfg, e_trial=0.0, tau=0.02)
    nxt, out = jax.jit(lambda p, s, k: prop_j.propagate(
        p, s, k, JPopulation()))(params, st, key)
    return request.param, cfg, params, st, draws, nxt, out


@pytest.mark.parametrize('n_shards', [2, 4])
def test_sharded_dmc_generation_matches_reference(dmc_ref, n_shards):
    name, cfg, params, st_j, (eta, u, u_r), nxt_j, out_j = dmc_ref
    tcfg, tparams = port_of(cfg, params)
    st_t = dmc_state_from_numpy(
        {k: _j(getattr(st_j.ens, k)) for k in st_j.ens._fields},
        _j(st_j.log_w_hist), _j(st_j.e_trial), device='cpu')
    drv = EnsembleDriver(t_dmc.DMCPropagator(tcfg, e_trial=0.0, tau=0.02),
                         1, devices=_cpus(n_shards), timeout=TIMEOUT)
    states, out_t = drv.step(tparams, drv.split(st_t),
                             (_t(eta), _t(u), _t(u_r)))
    assert len(states) == n_shards
    # the generation of test_torch_dmc's case (no Metropolis tie, no comb
    # point at a boundary): the same walkers survive, field by field
    merged = drv.merge(states)
    for k in merged._fields:
        rtol, atol = _tol(k)
        np.testing.assert_allclose(getattr(merged, k).numpy(),
                                   _j(getattr(nxt_j.ens, k)), rtol=rtol,
                                   atol=atol, err_msg=f'{name} {k}')
    for s in states:
        np.testing.assert_allclose(s.log_w_hist.numpy(),
                                   _j(nxt_j.log_w_hist), rtol=1e-5,
                                   atol=1e-6)
    for a, b, label in zip(out_t, out_j, ('e_loc', 'g_weight', 'accept',
                                          'crossed', 'mean_w')):
        np.testing.assert_allclose(a.numpy(), _j(b), rtol=1e-5,
                                   err_msg=f'{name} {label}')


@pytest.mark.parametrize('system,tau', [('h2', 0.6), ('water', 0.05)])
def test_vmc_step_matches_reference_under_its_draws(system, tau):
    cfg, params = j_build_system(system)
    tcfg, tparams = port_of(cfg, params)
    R = _walkers(cfg, params, seed=3, n_draw=32)
    ens_j = _j_evaluate(cfg)(params, jnp.asarray(R))
    key = jax.random.PRNGKey(5)

    def _draw(k):            # vmc.py's propose_diffusion, per walker key
        k_eta, k_u = jax.random.split(k)
        return (jax.random.normal(k_eta, R.shape[1:], jnp.float32),
                jax.random.uniform(k_u, ()))
    eta, u = jax.vmap(_draw)(JPopulation().walker_keys(key, R.shape[0]))
    nxt_j, acc_j = jax.jit(lambda p, e, k: j_vmc.vmc_step(
        cfg, p, e, k, tau))(params, ens_j, key)
    ens_t = t_vmc.evaluate_ensemble(tcfg, tparams, torch.from_numpy(R))[0]
    nxt_t, acc_t = t_vmc.vmc_step(tcfg, tparams, ens_t, None, tau,
                                  draws=(_t(eta), _t(u)))
    np.testing.assert_array_equal(acc_t.numpy(), _j(acc_j))
    assert 0 < int(acc_t.sum()) < R.shape[0]
    for k in nxt_t._fields:
        rtol, atol = _tol(k)
        np.testing.assert_allclose(getattr(nxt_t, k).numpy(),
                                   _j(getattr(nxt_j, k)), rtol=rtol,
                                   atol=atol, err_msg=f'{system} {k}')


# ---------------------------------------------------------------------------
# spec, devices, pickling, failures, CLI
# ---------------------------------------------------------------------------
def test_runspec_shards_only_on_thread_and_sim():
    for backend in ('thread', 'sim'):
        assert RunSpec(system='h2', shards=2, backend=backend).shards == 2
    for backend in ('process', 'grid'):
        with pytest.raises(ValueError, match='thread or sim'):
            RunSpec(system='h2', shards=2, backend=backend)
    RunSpec(system='h2', shards=1, backend='process')


def test_walkers_devices():
    assert WALKER_AXIS == 'walkers'
    assert walkers_devices(1, 'cpu') is None
    assert walkers_devices(None, 'cpu') is None
    assert walkers_devices(3, 'cpu') == [torch.device('cpu')] * 3
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match='local devices are visible'):
        walkers_devices(n, 'cuda')


def test_sharded_sampler_refuses_to_pickle():
    cfg, params = build_system('h2', device='cpu')
    prop = make_propagator('vmc', cfg)
    sharded = BlockSampler(prop, params, n_walkers=8, steps=2,
                           devices=walkers_devices(2, 'cpu'))
    with pytest.raises(TypeError, match='thread or sim'):
        pickle.dumps(sharded)
    with pytest.raises(TypeError, match='thread or sim'):
        pickle.dumps(sharded.driver)
    back = pickle.loads(pickle.dumps(BlockSampler(prop, params, n_walkers=8,
                                                  steps=2, device='cpu')))
    assert back.driver.n_shards == 1
    with pytest.raises(ValueError, match='not divisible'):
        sharded.driver.init(params, torch.Generator().manual_seed(0), 7)


class _Raises:
    """A propagator whose shard 1 raises at its second generation."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def init(self, *a):
        return self.inner.init(*a)

    def draw(self, gen, state):
        return self.inner.draw(gen, state)

    def propagate(self, params, state, gen, pop, draws=None):
        if pop.shard_index() == 1:
            self.calls += 1
            if self.calls == 2:
                raise FloatingPointError('shard 1 failed')
        return self.inner.propagate(params, state, gen, pop, draws)

    def block_stats(self, *a):
        return self.inner.block_stats(*a)


def test_a_shard_that_raises_is_reraised_without_a_hang():
    cfg, params = build_system('h2', device='cpu')
    prop = _Raises(make_propagator('vmc', cfg))
    drv = EnsembleDriver(prop, 5, devices=_cpus(4), timeout=TIMEOUT)
    g = torch.Generator().manual_seed(0)
    st = drv.init(params, g, 16)
    t0 = time.perf_counter()
    with pytest.raises(FloatingPointError, match='shard 1 failed'):
        drv.run_block(params, st, g)
    # the others stop at the aborted barrier, not at its timeout
    assert time.perf_counter() - t0 < TIMEOUT / 2
    assert not [t for t in threading.enumerate()
                if t.name.startswith('shard-')]


@pytest.mark.parametrize('backend', ['thread', 'sim'])
def test_sharded_run_through_the_manager(backend):
    run = build_run(RunSpec(system='h2', method='dmc', backend=backend,
                            shards=2, n_workers=2, n_walkers=8, steps=4,
                            max_blocks=2, subblocks_per_block=2,
                            equil_steps=4, device='cpu'))
    assert run.sampler.driver.n_shards == 2
    avg = run.run()
    assert not run.worker_errors()
    assert avg.n_blocks >= 2 and np.isfinite(avg.energy)


def test_qmc_run_shards_cli(capsys):
    from repro_torch.launch import qmc_run
    avg = qmc_run.main(['--system', 'h2', '--method', 'dmc', '--shards', '2',
                        '--device', 'cpu', '--walkers', '8', '--steps', '5',
                        '--blocks', '2'])
    out = capsys.readouterr().out
    assert 'x 2 shards' in out and 'E =' in out
    assert avg.n_blocks >= 2 and np.isfinite(avg.energy)
