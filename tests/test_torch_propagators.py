"""Propagators of the PyTorch port against the JAX package, move for move.

The port's propagators take their random numbers as optional inputs, so
these tests rebuild the reference's draws from its own keys (the
``fold_in``/``split`` layout of ``core/vmc.py::propose_diffusion`` and
``core/sem.py::_sweep_spin_block``) and feed them to the port: the accept
decisions must then be the same, move for move, except where a move's
margin |2 log ratio - log u| is below 1e-5 (fp32 summation order may tip
those either way; the tests report how many there were).  Water, 10 e-,
with ``method='kernel'`` on both sides (the JAX Pallas kernels in
interpret mode, the port's plain versions).
"""
import dataclasses
import functools
import re
import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.core import sem as j_sem  # noqa: E402
from repro.core import vmc as j_vmc  # noqa: E402
from repro.core.driver import Population as JPopulation  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402

from repro_torch.core import sem as t_sem  # noqa: E402
from repro_torch.core import vmc as t_vmc  # noqa: E402
from repro_torch.core.driver import Population  # noqa: E402
from repro_torch.launch import qmc_run  # noqa: E402
from repro_torch.systems.convert import from_numpy  # noqa: E402

W = 8
MARGIN = 1e-5


def port_of(cfg, params):
    """The port's (cfg, params) for a JAX (cfg, params), via numpy only."""
    basis = {f.name: np.asarray(getattr(cfg.basis, f.name))
             for f in dataclasses.fields(cfg.basis)}
    jas = {k: np.asarray(getattr(params.jastrow, k))
           for k in ('b_ee', 'b_en', 'a_en')}
    return from_numpy(basis, np.asarray(params.coords),
                      np.asarray(params.charges), np.asarray(params.mo),
                      jas, n_up=cfg.n_up, n_dn=cfg.n_dn, k_max=cfg.k_max,
                      method=cfg.method, ns_steps=cfg.ns_steps,
                      sem_refresh=cfg.sem_refresh, device='cpu')


@pytest.fixture(scope='module')
def water():
    cfg, params = j_build_system('water')
    cfg = dataclasses.replace(cfg, method='kernel')
    rng = np.random.default_rng(0)
    coords, charges = np.asarray(params.coords), np.asarray(params.charges)
    at = rng.choice(3, (W, cfg.n_elec), p=charges / charges.sum())
    R = (coords[at] + rng.normal(size=(W, cfg.n_elec, 3))).astype(np.float32)
    return cfg, params, port_of(cfg, params), R


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return np.asarray(x)


def test_vmc_step_same_accepts_under_jax_draws(water):
    cfg, params, (tcfg, tparams), R = water
    tau = 0.1
    key = jax.random.PRNGKey(5)
    ens_j, _ = j_vmc.evaluate_ensemble(cfg, params, jnp.asarray(R))
    new_j, lr_j, u_j = jax.jit(functools.partial(
        j_vmc.propose_diffusion, cfg, pop=JPopulation(), tau=tau))(
        params, ens_j, key)
    acc_j = np.log(_j(u_j)) < _j(lr_j)

    # vmc.py:90-95: per-walker key -> split -> normal eta, uniform u
    def _draw(k):
        k_eta, k_u = jax.random.split(k)
        return (jax.random.normal(k_eta, R.shape[1:], jnp.float32),
                jax.random.uniform(k_u, ()))
    eta, u = jax.vmap(_draw)(JPopulation().walker_keys(key, W))
    np.testing.assert_array_equal(_j(u), _j(u_j))

    prop = t_vmc.VMCPropagator(tcfg, tau=tau)
    ens_t, _ = t_vmc.evaluate_ensemble(tcfg, tparams, _t(R))
    merged, acc_t = prop.step(tparams, ens_t, None, Population(),
                              draws=(_t(eta), _t(u)))
    _, lr_t, _ = t_vmc.propose_diffusion(tcfg, tparams, ens_t, None,
                                         Population(), tau,
                                         draws=(_t(eta), _t(u)))
    margin = np.abs(np.log(_j(u)) - lr_t.numpy())
    close = margin < MARGIN
    print(f'vmc: {int(close.sum())} of {W} moves within the {MARGIN} margin')
    np.testing.assert_array_equal(acc_t.numpy()[~close], acc_j[~close])
    assert 0 < acc_j.sum() < W or acc_j.all()
    np.testing.assert_allclose(lr_t.numpy(), _j(lr_j), rtol=1e-4,
                               atol=1e-3)
    same = acc_t.numpy() == acc_j
    r_j = np.where(acc_j[:, None, None], _j(new_j.r), R)
    np.testing.assert_allclose(merged.r.numpy()[same], r_j[same], rtol=0,
                               atol=1e-5)


def _sem_draws(key, W, n_e):
    """sem.py:303-310: walker key -> fold_in(j) -> split -> normal(3,),
    uniform(); returns eta (W, n_e, 3), u (W, n_e)."""
    wkeys = JPopulation().walker_keys(key, W)

    def _one(k, j):
        ke, ku = jax.random.split(jax.random.fold_in(k, j))
        return (jax.random.normal(ke, (3,), jnp.float32),
                jax.random.uniform(ku, (), jnp.float32))
    eta, u = jax.vmap(lambda k: jax.vmap(lambda j: _one(k, j))(
        jnp.arange(n_e)))(wkeys)
    return np.asarray(eta), np.asarray(u)


def _check_sweep_accepts(R0, r_j, acc_t, mar_t):
    """Accepts from the JAX sweep (an electron moved or not) against the
    port's, walker by walker, up to the first near-tie in that walker."""
    moved_j = np.any(r_j != R0, axis=-1).T               # (n_e, W)
    acc_t, mar_t = acc_t.numpy(), np.abs(mar_t.numpy())
    ties = 0
    for w in range(R0.shape[0]):
        for j in range(R0.shape[1]):
            if mar_t[j, w] < MARGIN:
                ties += 1
                break                      # the rest of the walker may part
            assert acc_t[j, w] == moved_j[j, w], (w, j, mar_t[j, w])
    print(f'sem: {ties} walkers stopped at a move within {MARGIN}')
    return ties


@pytest.mark.parametrize('sweeps_before', [0, 7], ids=['corrector',
                                                       'refresh'])
def test_sem_sweep_same_accepts_under_jax_draws(water, sweeps_before):
    """One sem-vmc sweep: identical accepts; Minv within 1e-4 relative and
    logdet within 1e-4 after the corrector (sweep 1) and at the
    sem_refresh boundary (sweep 8 refreshes from a fresh inverse)."""
    cfg, params, (tcfg, tparams), R = water
    step = 0.4
    key = jax.random.PRNGKey(9)
    prop_j = j_sem.SEMVMCPropagator(cfg, step_size=step)
    ens_j = j_sem.evaluate_sem(cfg, params, jnp.asarray(R))
    st_j, out_j = jax.jit(functools.partial(prop_j.propagate,
                                            pop=JPopulation()))(
        params, j_sem.SEMState(ens=ens_j, sweeps=jnp.int32(sweeps_before)),
        key)

    eta, u = _sem_draws(key, W, cfg.n_elec)
    prop_t = t_sem.SEMVMCPropagator(tcfg, step_size=step)
    ens_t = t_sem.evaluate_sem(tcfg, tparams, _t(R))
    state_t = t_sem.SEMState(ens=ens_t, sweeps=sweeps_before)
    draws = (_t(eta), _t(u))
    *_, acc_t, mar_t = prop_t.sweep(tparams, state_t, None, draws)
    st_t, out_t = prop_t.propagate(tparams, state_t, None, Population(),
                                   draws)
    assert st_t.sweeps == (sweeps_before + 1) % cfg.sem_refresh
    ties = _check_sweep_accepts(R, _j(st_j.ens.r), acc_t, mar_t)
    assert 0.0 < float(out_t[2]) < 1.0
    if ties:
        return                             # trajectories may have parted
    np.testing.assert_allclose(st_t.ens.r.numpy(), _j(st_j.ens.r), rtol=0,
                               atol=1e-5)
    for f in ('minv_up', 'minv_dn'):
        a, b = getattr(st_t.ens, f).numpy(), _j(getattr(st_j.ens, f))
        assert np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0) <= 1e-4
    np.testing.assert_allclose(st_t.ens.logdet.numpy(), _j(st_j.ens.logdet),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(st_t.ens.sign.numpy(), _j(st_j.ens.sign))
    np.testing.assert_allclose(st_t.ens.e_loc.numpy(), _j(st_j.ens.e_loc),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('sweeps_before', [0, 7], ids=['corrector',
                                                       'refresh'])
def test_sem_corrector_keeps_running_logdet_refresh_resets_it(
        water, sweeps_before):
    """sem.py:641: a sweep between refreshes only refines the maintained
    inverses and keeps the running sign and logdet, so an offset put into
    one walker's logdet survives it; the refresh sweep takes both from a
    fresh slogdet.  Held against the reference's propagate on the same
    offset state (each side against its own fresh recompute, so the test
    holds even where a near-tie parts the trajectories)."""
    cfg, params, (tcfg, tparams), R = water
    step, offset = 0.4, 0.5
    key = jax.random.PRNGKey(9)
    bump = np.zeros(W, np.float32)
    bump[0] = offset
    prop_j = j_sem.SEMVMCPropagator(cfg, step_size=step)
    ens_j = j_sem.evaluate_sem(cfg, params, jnp.asarray(R))
    ens_j = ens_j._replace(logdet=ens_j.logdet + bump)
    st_j, _ = jax.jit(functools.partial(prop_j.propagate,
                                        pop=JPopulation()))(
        params, j_sem.SEMState(ens=ens_j, sweeps=jnp.int32(sweeps_before)),
        key)
    eta, u = _sem_draws(key, W, cfg.n_elec)
    prop_t = t_sem.SEMVMCPropagator(tcfg, step_size=step)
    ens_t = t_sem.evaluate_sem(tcfg, tparams, _t(R))
    ens_t = ens_t._replace(logdet=ens_t.logdet + _t(bump))
    st_t, _ = prop_t.propagate(
        tparams, t_sem.SEMState(ens=ens_t, sweeps=sweeps_before), None,
        Population(), (_t(eta), _t(u)))
    gap_j = _j(st_j.ens.logdet) - _j(
        j_sem.evaluate_sem(cfg, params, st_j.ens.r).logdet)
    gap_t = (st_t.ens.logdet
             - t_sem.evaluate_sem(tcfg, tparams, st_t.ens.r).logdet).numpy()
    want = bump if sweeps_before == 0 else np.zeros(W, np.float32)
    np.testing.assert_allclose(gap_j, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gap_t, want, rtol=0, atol=1e-4)


def test_dead_cold_start_walker_matches_reference(water):
    """A walker with an electron outside every atom's AO cutoff has a zero
    Slater column: both packages give it sign 0, log psi = -inf and a NaN
    local energy, and evaluate the other walkers as before.  Neither
    package redraws such a walker at a cold start."""
    cfg, params, (tcfg, tparams), R = water
    R = R.copy()
    R[0, 0] = (1e3, 0.0, 0.0)
    ens_j, st_j = j_vmc.evaluate_ensemble(cfg, params, jnp.asarray(R))
    ens_t, st_t = t_vmc.evaluate_ensemble(tcfg, tparams, _t(R))
    assert int(st_t.ao_count[0, 0]) == int(_j(st_j.ao_count)[0, 0]) == 0
    for ens in (ens_t, ens_j):
        assert float(ens.sign[0]) == 0.0
        assert float(ens.log_psi[0]) == -np.inf
        assert np.isnan(float(ens.e_loc[0]))
    np.testing.assert_allclose(ens_t.log_psi.numpy()[1:],
                               _j(ens_j.log_psi)[1:], rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(ens_t.e_loc.numpy()[1:], _j(ens_j.e_loc)[1:],
                               rtol=1e-4, atol=1e-3)
    sem_t = t_sem.evaluate_sem(tcfg, tparams, _t(R))
    sem_j = j_sem.evaluate_sem(cfg, params, jnp.asarray(R))
    assert float(sem_t.logdet[0]) == float(_j(sem_j.logdet)[0]) == -np.inf


def test_evaluate_sem_matches_jax(water):
    cfg, params, (tcfg, tparams), R = water
    ej = j_sem.evaluate_sem(cfg, params, jnp.asarray(R))
    et = t_sem.evaluate_sem(tcfg, tparams, _t(R))
    for f in ('minv_up', 'minv_dn'):
        a, b = getattr(et, f).numpy(), _j(getattr(ej, f))
        assert np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0) <= 1e-4
    np.testing.assert_allclose(et.logdet.numpy(), _j(ej.logdet), atol=1e-4)
    np.testing.assert_array_equal(et.sign.numpy(), _j(ej.sign))
    np.testing.assert_allclose(et.e_loc.numpy(), _j(ej.e_loc), rtol=1e-4,
                               atol=1e-3)


def test_sem_sweeps_track_fresh_recompute(water):
    """Port-only §6 contract: after k=3 < sem_refresh sweeps drawn from the
    port's own generator, the maintained state matches a fresh
    recompute (both spin blocks, the boundary electron j = n_up included)."""
    _, _, (tcfg, tparams), R = water
    from repro_torch.core.driver import EnsembleDriver
    prop = t_sem.SEMVMCPropagator(tcfg, step_size=0.4)
    drv = EnsembleDriver(prop, steps=3)
    gen = torch.Generator().manual_seed(0)
    st = drv.init(tparams, gen, W, walkers=R)
    st, stats = drv.run_block(tparams, st, gen)
    assert st.sweeps == 3 and 0.0 < stats.aux['accept'] < 1.0
    fresh = t_sem.evaluate_sem(tcfg, tparams, st.ens.r)
    for f in ('minv_up', 'minv_dn'):
        a, b = getattr(st.ens, f), getattr(fresh, f)
        assert float((a - b).abs().max() / b.abs().max().clamp(min=1.0)) \
            <= 1e-4
    assert float((st.ens.logdet - fresh.logdet).abs().max()) <= 1e-4


def test_qmc_run_cli_sem_vmc_on_cpu(tmp_path, capsys):
    db = tmp_path / 'water.sqlite'
    avg = qmc_run.main(['--system', 'water', '--method', 'sem-vmc',
                        '--device', 'cpu', '--workers', '1', '--walkers',
                        '8', '--steps', '3', '--blocks', '2', '--db',
                        str(db)])
    assert np.isfinite(avg.energy) and avg.n_blocks >= 2
    key = re.search(r'run_key=(\w+)', capsys.readouterr().out).group(1)
    with sqlite3.connect(db) as conn:
        n = conn.execute('SELECT COUNT(*) FROM blocks WHERE run_key=?',
                         (key,)).fetchone()[0]
    assert n >= 2
