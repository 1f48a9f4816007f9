"""DMC of the PyTorch port against the JAX package.

* ``reconfigure`` against ``repro.core.reconfig.reconfigure`` on
  hypothesis-drawn weights with the reference's uniform injected, and the
  reference's own property tests (``tests/test_reconfig.py``) on the port;
* one DMC generation (two, chained) against
  ``repro.core.dmc.DMCPropagator.propagate`` on h2, water and the
  ``smallest`` micro-peptide, from the same state and under the
  reference's draws (its ``split``/``walker_keys`` layout rebuilt here):
  accept, crossing and reconfiguration decisions identical (ties
  excepted and counted), the next ensemble within the evaluation
  tolerances of the parity tests, the weight history, global weight, the
  block's weighted means and the E_T feedback within rtol 1e-5;
* whole port runs as ``tests/test_vmc_dmc.py`` runs the reference's: H
  within 0.01 of -0.5, H2 below its VMC and within 0.06 of -1.174, a
  constant population, the same seed giving the same block;
* a DMC block syncs with the host once.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.core import dmc as j_dmc  # noqa: E402
from repro.core import reconfig as j_reconfig  # noqa: E402
from repro.core import vmc as j_vmc  # noqa: E402
from repro.core.driver import Population as JPopulation  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402

from repro_torch.core import dmc as t_dmc  # noqa: E402
from repro_torch.core import vmc as t_vmc  # noqa: E402
from repro_torch.core.driver import EnsembleDriver, Population  # noqa: E402
from repro_torch.core.jastrow import JastrowParams  # noqa: E402
from repro_torch.core.reconfig import (global_weight_update,  # noqa: E402
                                       reconfigure)
from repro_torch.systems.convert import (dmc_state_from_numpy,  # noqa: E402
                                         from_numpy)
from repro_torch.systems.molecule import (build_wavefunction, h2,  # noqa
                                          hydrogen)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # seeded cases instead
    given = None

MARGIN = 1e-5      # Metropolis threshold ties (|log u - log ratio|)
COMB_TIE = 1e-6    # a comb point this close (relative) to a boundary
W = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# reconfigure
# ---------------------------------------------------------------------------
def _comb_ties(w, u):
    """Walkers whose comb point lies within COMB_TIE (relative) of a
    cumulative boundary of the fp32 weights (either package's rounding of
    the cumsum may put it on either side)."""
    m = w.shape[0]
    cum = np.cumsum(w.astype(np.float64) / np.sum(w.astype(np.float64)))
    comb = (np.float64(u) + np.arange(m)) / m
    d = np.abs(comb[:, None] - cum[None, :]).min(axis=1)
    return d <= COMB_TIE * np.maximum(comb, 1e-30)


@functools.partial(jax.jit, static_argnums=0)
def _j_reconfigure_case(m, seed):
    """tests/test_reconfig.py's weights, the reference's indices, and the
    comb's one uniform as reconfig.py draws it."""
    key = jax.random.PRNGKey(seed)
    w = jax.random.uniform(jax.random.fold_in(key, 1), (m,)) + 1e-3
    return w, j_reconfig.reconfigure(key, w), jax.random.uniform(key, ())


def _check_reconfigure_matches_jax(m, seed):
    w, idx_j, u = _j_reconfigure_case(m, seed)
    idx_j = _j(idx_j)
    idx_t = reconfigure(_t(w), _t(u))
    assert idx_t.dtype == torch.int32 and idx_t.shape == (m,)
    ties = _comb_ties(_j(w), _j(u))
    np.testing.assert_array_equal(idx_t.numpy()[~ties], idx_j[~ties])
    return int(ties.sum())


if given is not None:
    @given(st.integers(min_value=2, max_value=64),
           st.integers(min_value=0, max_value=2 ** 31 - 1))
    @settings(max_examples=25, deadline=None)
    def test_reconfigure_matches_jax_under_its_uniform(m, seed):
        ties = _check_reconfigure_matches_jax(m, seed)
        if ties:
            print(f'reconfigure m={m} seed={seed}: {ties} comb ties')
else:
    @pytest.mark.parametrize('m,seed', [(2, 0), (7, 1), (32, 2), (64, 3),
                                        (45, 4), (3, 5)])
    def test_reconfigure_matches_jax_under_its_uniform(m, seed):
        ties = _check_reconfigure_matches_jax(m, seed)
        if ties:
            print(f'reconfigure m={m} seed={seed}: {ties} comb ties')


@pytest.mark.parametrize('m,seed', [(2, 0), (17, 1), (64, 2)])
def test_population_size_constant(m, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(m, generator=g) + 1e-3
    idx = reconfigure(w, torch.rand((), generator=g))
    assert idx.shape == (m,)
    assert bool(torch.all((idx >= 0) & (idx < m)))


@pytest.mark.parametrize('seed', range(4))
def test_systematic_resampling_copy_counts(seed):
    """copies_k in {floor(M p_k), ceil(M p_k)}."""
    m = 32
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(m, generator=g) + 0.05
    idx = reconfigure(w, torch.rand((), generator=g)).numpy()
    p = w.numpy() / np.sum(w.numpy())
    counts = np.bincount(idx, minlength=m)
    assert np.all(counts >= np.floor(m * p) - 1e-9)
    assert np.all(counts <= np.ceil(m * p) + 1e-9)


def test_expected_copies_unbiased():
    """E[copies_k] = M p_k across many independent reconfigurations."""
    m, trials = 16, 4000
    w = torch.as_tensor(np.random.default_rng(0).uniform(0.2, 2.0, m),
                        dtype=torch.float32)
    p = w.numpy() / float(torch.sum(w))
    u = torch.rand(trials, generator=torch.Generator().manual_seed(42))
    counts = np.stack([np.bincount(reconfigure(w, ui).numpy(), minlength=m)
                       for ui in u])
    np.testing.assert_allclose(counts.mean(axis=0), m * p, atol=0.05)


def test_uniform_weights_keep_everyone():
    idx = reconfigure(torch.ones(24), torch.tensor(0.37)).numpy()
    assert sorted(idx.tolist()) == list(range(24))


def test_global_weight_window_product():
    hist = torch.zeros(4)
    vals = [1.1, 0.9, 1.05, 0.98, 1.02]
    for v in vals:
        hist, gw = global_weight_update(hist, torch.tensor(v))
    np.testing.assert_allclose(float(gw), np.prod(vals[-4:]), rtol=1e-5)
    h_j = jnp.zeros(4)
    for v in vals:
        h_j, _ = j_reconfig.global_weight_update(h_j, jnp.float32(v))
    np.testing.assert_allclose(hist.numpy(), _j(h_j), rtol=1e-6)


# ---------------------------------------------------------------------------
# one generation against the reference
# ---------------------------------------------------------------------------
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


def _walkers(cfg, params, seed, n_draw):
    """W of ``n_draw`` seeded cold-start walkers, farthest from a node of
    Psi (smallest max |drift|, by the reference): near a node the fp32
    inverse loses digits on both sides alike (PERF.md section 2)."""
    rng = np.random.default_rng(seed)
    coords, charges = np.asarray(params.coords), np.asarray(params.charges)
    at = rng.choice(coords.shape[0], (n_draw, cfg.n_elec),
                    p=charges / charges.sum())
    R = (coords[at] + 1.2 * rng.normal(size=(n_draw, cfg.n_elec, 3))
         ).astype(np.float32)
    ens = _j_evaluate(cfg)(params, jnp.asarray(R))
    ok = np.isfinite(_j(ens.e_loc))
    order = np.argsort(np.where(ok, np.abs(_j(ens.drift)).max(axis=(1, 2)),
                                np.inf))
    return R[order[:W]]


def _j_evaluate(cfg):
    """The reference's ensemble evaluation, compiled once per config."""
    return jax.jit(lambda p, r: j_vmc.evaluate_ensemble(cfg, p, r)[0])


def _jax_draws(key, r_shape):
    """dmc.py:82-83 and vmc.py:93-98: split -> per-walker keys -> split ->
    normal eta, uniform u; reconfig.py:188 the comb's uniform."""
    kp, kr = jax.random.split(key)

    def _draw(k):
        k_eta, k_u = jax.random.split(k)
        return (jax.random.normal(k_eta, r_shape[1:], jnp.float32),
                jax.random.uniform(k_u, ()))
    eta, u = jax.vmap(_draw)(JPopulation().walker_keys(kp, r_shape[0]))
    return eta, u, jax.random.uniform(kr, ())


@pytest.fixture(scope='module', params=['h2', 'water', 'smallest'])
def dmc_case(request):
    cfg, params = j_build_system(request.param)
    R = _walkers(cfg, params, seed=7, n_draw=4 * W)
    ens = _j_evaluate(cfg)(params, jnp.asarray(R))
    # E_T at the ensemble's mean energy keeps the weights O(1); a
    # non-trivial history exercises the window
    e_t = float(np.mean(_j(ens.e_loc)))
    hist = np.random.default_rng(1).normal(0, 0.01, 20).astype(np.float32)
    st = j_dmc.DMCState(ens=ens, log_w_hist=jnp.asarray(hist),
                        e_trial=jnp.float32(e_t))
    return request.param, cfg, params, port_of(cfg, params), st


def _tol(name):
    """Evaluation tolerances of the parity tests (PERF.md section 2)."""
    return {'r': (0.0, 1e-5), 'log_psi': (2e-6, 1e-4), 'sign': (0.0, 0.0),
            'drift': (1e-4, 1e-4), 'e_loc': (1e-4, 1e-4)}[name]


def test_dmc_generation_matches_jax_under_its_draws(dmc_case, monkeypatch):
    name, cfg, params, (tcfg, tparams), st_j = dmc_case
    tau = 0.02
    # both packages' reconfiguration, spied on inside their propagate
    seen = {}

    def _spy(fn, side):
        def _wrapped(*a):
            idx = fn(*a)
            seen[side] = (*a, idx)
            return idx
        return _wrapped
    monkeypatch.setattr(j_dmc, 'reconfigure', _spy(j_reconfig.reconfigure,
                                                   'jax'))
    monkeypatch.setattr(t_dmc, 'reconfigure', _spy(reconfigure, 'torch'))
    prop_j = j_dmc.DMCPropagator(cfg, e_trial=0.0, tau=tau)
    prop_t = t_dmc.DMCPropagator(tcfg, e_trial=0.0, tau=tau)

    @jax.jit
    def step_j(params, st, key):
        nxt, out = prop_j.propagate(params, st, key, JPopulation())
        return nxt, out, seen['jax'][1], seen['jax'][2]
    propose_j = jax.jit(functools.partial(
        j_vmc.propose_diffusion, cfg, pop=JPopulation(), tau=tau))
    st_t = dmc_state_from_numpy(
        {k: _j(getattr(st_j.ens, k)) for k in st_j.ens._fields},
        _j(st_j.log_w_hist), _j(st_j.e_trial), device='cpu')
    outs_j, outs_t, ties = [], [], {'accept': 0, 'comb': 0}
    for gen_i in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(11), gen_i)
        eta, u, u_r = _jax_draws(key, st_j.ens.r.shape)
        # the Metropolis and fixed-node decisions, from the same state
        new_j, lr_j, u_j = propose_j(params, st_j.ens,
                                     jax.random.split(key)[0])
        np.testing.assert_array_equal(_j(u_j), _j(u))
        new_t, lr_t, _ = t_vmc.propose_diffusion(
            tcfg, tparams, st_t.ens, None, Population(), tau,
            draws=(_t(eta), _t(u)))
        cross_j = _j(new_j.sign) * _j(st_j.ens.sign) < 0
        cross_t = (new_t.sign * st_t.ens.sign < 0).numpy()
        np.testing.assert_array_equal(cross_t, cross_j)
        acc_j = (np.log(_j(u)) < _j(lr_j)) & ~cross_j
        acc_t = (torch.log(_t(u)) < lr_t).numpy() & ~cross_t
        tie = np.abs(np.log(_j(u)) - lr_t.numpy()) < MARGIN
        ties['accept'] += int(tie.sum())
        np.testing.assert_array_equal(acc_t[~tie], acc_j[~tie])

        nxt_j, out_j, w_j, idx_j = step_j(params, st_j, key)
        nxt_t, out_t = prop_t.propagate(tparams, st_t, None, Population(),
                                        draws=(_t(eta), _t(u), _t(u_r)))
        # the reconfiguration: the same walkers survive
        w_t, u_seen, idx_t = seen['torch']
        assert float(u_seen) == float(u_r)
        np.testing.assert_allclose(w_t.numpy(), _j(w_j), rtol=1e-5,
                                   atol=1e-7)
        comb = _comb_ties(_j(w_j), _j(u_r))
        ties['comb'] += int(comb.sum())
        np.testing.assert_array_equal(idx_t.numpy()[~comb],
                                      _j(idx_j)[~comb])
        # the next ensemble, within the evaluation tolerances
        for k in nxt_t.ens._fields:
            rtol, atol = _tol(k)
            np.testing.assert_allclose(getattr(nxt_t.ens, k).numpy(),
                                       _j(getattr(nxt_j.ens, k)), rtol=rtol,
                                       atol=atol, err_msg=f'{name} {k}')
        np.testing.assert_allclose(nxt_t.log_w_hist.numpy(),
                                   _j(nxt_j.log_w_hist), rtol=1e-5,
                                   atol=1e-6)
        # (mean E_L, g_weight, accept, crossed, mean w)
        for a, b, label in zip(out_t, out_j, ('e_loc', 'g_weight', 'accept',
                                               'crossed', 'mean_w')):
            np.testing.assert_allclose(a.numpy(), _j(b), rtol=1e-5,
                                       err_msg=f'{name} {label}')
        outs_j.append(out_j)
        outs_t.append(out_t)
        st_j, st_t = nxt_j, nxt_t
    print(f'dmc {name}: {ties["accept"]} Metropolis ties within {MARGIN}, '
          f'{ties["comb"]} comb points within {COMB_TIE} of a boundary')
    # the block's weighted means
    stk_j = tuple(jnp.stack(c) for c in zip(*outs_j))
    stk_t = tuple(torch.stack(c) for c in zip(*outs_t))
    bs_j = prop_j.block_stats(params, st_j, stk_j, JPopulation())
    bs_t = prop_t.block_stats(tparams, st_t, stk_t, Population())
    for k in ('weight', 'e_mean', 'e2_mean'):
        np.testing.assert_allclose(getattr(bs_t, k).numpy(),
                                   _j(getattr(bs_j, k)), rtol=1e-5,
                                   err_msg=k)
    for k in prop_t.aux_fields:
        np.testing.assert_allclose(bs_t.aux[k].numpy(), _j(bs_j.aux[k]),
                                   rtol=1e-5, err_msg=k)
    # E_T feedback from the block's energy
    e_est = float(bs_j.e_mean)
    et_j = j_dmc.update_e_trial(st_j, e_est).e_trial
    et_t = prop_t.feedback(st_t, e_est).e_trial
    assert et_t.dtype == torch.float32 and et_t.shape == ()
    np.testing.assert_allclose(et_t.numpy(), _j(et_j), rtol=1e-5)


def test_convert_carries_a_dmc_state(dmc_case):
    *_, st_j = dmc_case
    st_t = dmc_state_from_numpy(
        {k: _j(getattr(st_j.ens, k)) for k in st_j.ens._fields},
        _j(st_j.log_w_hist), _j(st_j.e_trial), device='cpu')
    for k in st_j.ens._fields:
        np.testing.assert_array_equal(getattr(st_t.ens, k).numpy(),
                                      _j(getattr(st_j.ens, k)))
    np.testing.assert_array_equal(st_t.log_w_hist.numpy(),
                                  _j(st_j.log_w_hist))
    assert st_t.e_trial.dtype == torch.float32 and st_t.e_trial.ndim == 0
    with pytest.raises(ValueError, match='missing'):
        dmc_state_from_numpy({'r': _j(st_j.ens.r)}, _j(st_j.log_w_hist), 0.0,
                             device='cpu')


# ---------------------------------------------------------------------------
# whole runs of the port (tests/test_vmc_dmc.py's settings)
# ---------------------------------------------------------------------------
def vmc_driver(cfg, steps, tau):
    return EnsembleDriver(t_vmc.VMCPropagator(cfg, tau=tau), steps)


def dmc_driver(cfg, steps, tau):
    # the running E_T lives in DMCState, so e_trial=0.0 here is inert
    return EnsembleDriver(t_dmc.DMCPropagator(cfg, e_trial=0.0, tau=tau),
                          steps)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope='module')
def h_wf():
    # no Jastrow e-n term for a 1-electron system, as the reference's fixture
    jz = JastrowParams(b_ee=torch.tensor(1.0), b_en=torch.tensor(1.0),
                       a_en=torch.tensor(0.0))
    return build_wavefunction(*hydrogen(), jastrow=jz, device='cpu')


def test_hydrogen_empty_spin_block(h_wf):
    """n_dn = 0 and no e-e pair: a finite, exact-orbital evaluation."""
    cfg, params = h_wf
    assert (cfg.n_up, cfg.n_dn) == (1, 0)
    ens = t_vmc.init_walkers(cfg, params, _gen(0), 16, spread=1.0)
    for k in ens._fields:
        assert bool(torch.all(torch.isfinite(getattr(ens, k)))), k
    assert ens.drift.shape == (16, 1, 3)


def test_dmc_hydrogen_exact(h_wf):
    """DMC is exact for a nodeless state: E -> -0.5 within stat error."""
    cfg, params = h_wf
    g = _gen(3)
    ens = t_vmc.init_walkers(cfg, params, g, 256, spread=1.0)
    ens, vstats = vmc_driver(cfg, steps=80, tau=0.35).run_block(params, ens,
                                                                g)
    st = t_dmc.init_dmc(ens, e_trial=vstats.e_mean, window=10)
    ddrv = dmc_driver(cfg, steps=150, tau=0.02)
    st, _ = ddrv.run_block(params, st, g)                  # equilibrate
    es = []
    for _ in range(4):
        st, ds = ddrv.run_block(params, st, g)
        st = t_dmc.update_e_trial(st, ds.e_mean)
        es.append(ds.e_mean)
    assert abs(np.mean(es) - (-0.5)) < 0.01, es


def test_dmc_h2_below_vmc():
    """DMC energy <= VMC energy for H2, and near the exact -1.174 Ha."""
    cfg, params = build_wavefunction(*h2(), device='cpu')
    g = _gen(7)
    ens = t_vmc.init_walkers(cfg, params, g, 192)
    vdrv = vmc_driver(cfg, steps=120, tau=0.25)
    ens, _ = vdrv.run_block(params, ens, g)                # equilibrate
    ens, vstats = vdrv.run_block(params, ens, g)
    e_vmc = vstats.e_mean
    st = t_dmc.init_dmc(ens, e_trial=e_vmc, window=10)
    ddrv = dmc_driver(cfg, steps=120, tau=0.02)
    for _ in range(3):                                     # equilibrate
        st, ds = ddrv.run_block(params, st, g)
        st = t_dmc.update_e_trial(st, ds.e_mean)
    es = []
    for _ in range(4):
        st, ds = ddrv.run_block(params, st, g)
        st = t_dmc.update_e_trial(st, ds.e_mean)
        es.append(ds.e_mean)
    e_dmc = float(np.mean(es))
    assert e_dmc < e_vmc + 0.005, (e_vmc, e_dmc)
    assert abs(e_dmc - (-1.174)) < 0.06, (e_vmc, e_dmc)


def test_population_is_constant_through_dmc():
    cfg, params = build_wavefunction(*h2(), device='cpu')
    ens = t_vmc.init_walkers(cfg, params, _gen(0), 64)
    st = t_dmc.init_dmc(ens, e_trial=-1.1)
    st2, _ = dmc_driver(cfg, steps=25, tau=0.02).run_block(params, st,
                                                           _gen(1))
    assert st2.ens.r.shape == ens.r.shape                  # constant M
    assert st2.log_w_hist.shape == (20,) and st2.e_trial.ndim == 0


def test_dmc_blocks_are_reproducible():
    """The same seed gives bitwise the same block, twice."""
    cfg, params = build_wavefunction(*h2(), device='cpu')
    prop = t_dmc.DMCPropagator(cfg, e_trial=-1.1, tau=0.02, equil_steps=5)
    out = []
    for _ in range(2):
        drv = EnsembleDriver(prop, 10)
        g = _gen(5)
        st = drv.init(params, g, 32)
        st, s = drv.run_block(params, st, g)
        out.append((s, st.ens.r.clone()))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])


def test_dmc_block_syncs_with_the_host_once(monkeypatch):
    """A DMC block reads the device once (the stacked transfer, with the
    device-tensor weight in it); VMC's host-float weight still works."""
    cfg, params = build_wavefunction(*h2(), device='cpu')
    g = _gen(2)
    st = t_dmc.init_dmc(t_vmc.init_walkers(cfg, params, g, 16), -1.1)
    drv = dmc_driver(cfg, steps=4, tau=0.02)
    calls = []
    for name in ('item', 'tolist', 'cpu', 'numpy', '__float__', '__bool__',
                 '__int__'):
        orig = getattr(torch.Tensor, name)

        def _spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, _spy)
    st, stats = drv.run_block(params, st, g)
    monkeypatch.undo()
    assert calls == ['tolist'], calls
    assert isinstance(stats.weight, float) and stats.weight > 0
    assert set(stats.aux) == {'accept', 'pop_weight', 'sign_flips'}
    _, vstats = vmc_driver(cfg, 3, 0.3).run_block(params, st.ens, g)
    assert vstats.weight == 3 * 16
