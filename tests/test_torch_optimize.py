"""Wavefunction optimization of the PyTorch port (``repro_torch.optimize``,
``repro_torch.train``) against the JAX package's, case by case as
``tests/test_optimize.py`` holds the reference.

* O = ∂ ln|Ψ| / ∂ p: the port's batched estimator (``o_batched``, one
  backward pass for the whole walker batch) and its per-walker form against
  central finite differences (h2, P = 3; h2 ``n_det=4``, P = 7), and
  against the reference's ``vmap(make_o_fn)`` on the same seeded walkers
  (h2, h2 ``n_det=4``, water, ``smallest`` ``n_det=100``), with the four
  moments.  Tolerance: rtol 1e-4, plus an atol of 1e-5 times the
  walker's largest |O| in the same part (Jastrow; CI), from fp32.  Walkers are
  picked away from nodes, as the other CI parity tests pick them.
* One ``OptVMCPropagator.propagate`` against the reference's under the
  reference's draws: identical accepts, the moments within rtol 1e-4.
* The solvers, a copy of the reference's, are bitwise equal on the same
  moments; SR and LM steps lower the correlated-sampling energy.
* The version protocol (stale and fractional stamps rejected, the sampler
  stamps its version), checkpoints read in both directions, and whole
  runs on the thread, process and grid backends (slow-marked where the
  reference's case is).
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.core import vmc as j_vmc  # noqa: E402
from repro.core import wavefunction as j_wf  # noqa: E402
from repro.core.driver import Population as JPopulation  # noqa: E402
from repro.optimize import estimators as j_est  # noqa: E402
from repro.optimize import solvers as j_solvers  # noqa: E402
from repro.optimize.propagator import (  # noqa: E402
    OptVMCPropagator as JOptVMCPropagator)
from repro.runtime.blocks import BlockResult as JBlockResult  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402

from repro_torch.core import vmc as t_vmc  # noqa: E402
from repro_torch.core.driver import (EnsembleDriver, Population,  # noqa: E402
                                     make_propagator)
from repro_torch.core.wavefunction import (log_psi,  # noqa: E402
                                           psi_state_batched)
from repro_torch.launch import qmc_run  # noqa: E402
from repro_torch.launch.spec import RunSpec, build_run  # noqa: E402
from repro_torch.optimize import (clip_vector, collect_moments,  # noqa: E402
                                  lm_update, make_o_fn, n_params,
                                  o_batched, opt_vector, params_from_vector,
                                  reweighted_energy, run_optimization,
                                  sr_matrices, sr_update, traced_vector)
from repro_torch.optimize.loop import OptResult  # noqa: E402
from repro_torch.optimize.propagator import OptVMCPropagator  # noqa: E402
from repro_torch.optimize.solvers import Moments  # noqa: E402
from repro_torch.runtime.blocks import (BlockAccumulator,  # noqa: E402
                                        BlockResult)
from repro_torch.runtime.samplers import BlockSampler  # noqa: E402
from repro_torch.systems import build_system  # noqa: E402
from repro_torch.systems.convert import from_numpy  # noqa: E402
from repro_torch.train import (latest_step, restore_checkpoint,  # noqa: E402
                               save_checkpoint)

CI_FIELDS = ('coeffs', 'holes_up', 'parts_up', 'holes_dn', 'parts_dn')
MOMENTS = ('o', 'eo', 'oo', 'oeo')


def port_of(cfg, params):
    """The port's (cfg, params) for a JAX (cfg, params), via numpy only."""
    basis = {f.name: np.asarray(getattr(cfg.basis, f.name))
             for f in dataclasses.fields(cfg.basis)}
    jas = {k: np.asarray(getattr(params.jastrow, k))
           for k in ('b_ee', 'b_en', 'a_en')}
    ci = None
    if cfg.ci is not None:
        ci = {f: np.asarray(getattr(cfg.ci, f)) for f in CI_FIELDS}
        ci['n_orb'] = cfg.ci.n_orb
    return from_numpy(basis, np.asarray(params.coords),
                      np.asarray(params.charges), np.asarray(params.mo),
                      jas, n_up=cfg.n_up, n_dn=cfg.n_dn, k_max=cfg.k_max,
                      method=cfg.method, ns_steps=cfg.ns_steps,
                      sem_refresh=cfg.sem_refresh, ci=ci, device='cpu')


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return np.asarray(x)


def positions(params, n_e, seed, n_walkers, spread=1.2):
    """Walkers around charge-weighted random nuclei (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    coords, charges = np.asarray(params.coords), np.asarray(params.charges)
    at = rng.choice(coords.shape[0], (n_walkers, n_e),
                    p=charges / charges.sum())
    return (coords[at] + spread * rng.normal(size=(n_walkers, n_e, 3))
            ).astype(np.float32)


def away_from_nodes(cfg, params, seed, n_walkers, n_draw):
    """The ``n_walkers`` of ``n_draw`` seeded walkers farthest from a node
    of Psi (smallest max |drift|, by the reference): near a node of a
    determinant or of the CI sum fp32 loses digits on both sides alike."""
    R = positions(params, cfg.n_elec, seed, n_draw)
    st = jax.jit(functools.partial(j_wf.psi_state_batched, cfg))(
        params, jnp.asarray(R))
    ok = np.isfinite(_j(st.e_loc))
    d = np.where(ok, np.abs(_j(st.drift)).max(axis=(1, 2)), np.inf)
    return R[np.argsort(d)[:n_walkers]]


def assert_o_close(got, want):
    """rtol 1e-4 plus an atol of 1e-5 times the walker's largest |O| in the
    same part: the three Jastrow derivatives (fp32 sums over up to n_e^2
    pair terms), and the CI derivatives R_I / S (every determinant's ratio
    comes from one fp32 table, so each carries an absolute error on the
    scale of the largest)."""
    atol = np.zeros_like(want)
    for part in (slice(0, 3), slice(3, None)):
        if want[:, part].size:
            atol[:, part] = 1e-5 * np.abs(want[:, part]).max(axis=1,
                                                             keepdims=True)
    err = np.abs(got - want)
    bad = err > atol + 1e-4 * np.abs(want)
    assert not bad.any(), (np.argwhere(bad)[:5], err.max(axis=0))


def _moments(O, E):
    """The four moments of a fixed sample, f64 on the host."""
    O, E = np.asarray(O, np.float64), np.asarray(E, np.float64)
    OO = O[:, :, None] * O[:, None, :]
    return dict(o=O.mean(0), eo=(O * E[:, None]).mean(0), oo=OO.mean(0),
                oeo=(OO * E[:, None, None]).mean(0))


def fd_gradient(cfg, params, vec, r, eps=1e-3):
    """Central finite difference of the port's ln|Psi| in the vector."""
    out = np.zeros_like(vec)
    for i in range(len(vec)):
        vp, vm = vec.copy(), vec.copy()
        vp[i] += eps
        vm[i] -= eps
        lp = log_psi(cfg, params_from_vector(cfg, params, vp), r)[1]
        lm = log_psi(cfg, params_from_vector(cfg, params, vm), r)[1]
        out[i] = (float(lp) - float(lm)) / (2 * eps)
    return out


def sample_moments(cfg, params, vec, R):
    """Direct (single-process) moment estimates on a fixed walker sample,
    with the batched estimator."""
    p = params_from_vector(cfg, params, vec)
    O = o_batched(cfg, p, R).numpy()
    E = psi_state_batched(cfg, p, R).e_loc.numpy()
    m = _moments(O, E)
    e = np.asarray(E, np.float64)
    return Moments(weight=float(len(E)), n_blocks=1, e=e.mean(),
                   e2=(e * e).mean(), **m)


def equilibrated_walkers(cfg, params, n_walkers=64, seed=5, subblocks=6):
    """Walker sample off the port's plain-VMC sampler (fixed seed)."""
    prop = make_propagator('vmc', cfg, tau=0.3)
    samp = BlockSampler(prop, params, n_walkers=n_walkers, steps=50,
                        device='cpu')
    state = samp.init_state(0, seed=seed)
    w = None
    for step in range(subblocks):
        state, _, w, _ = samp.run_subblock(state, step)
    return torch.as_tensor(w, dtype=torch.float32)


# ---------------------------------------------------------------------------
# parameter-derivative estimators vs finite differences
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('n_det,P', [(1, 3), (4, 7)], ids=['jastrow', 'ci'])
def test_o_matches_finite_difference(n_det, P):
    """O_i = d ln|Psi| / d p_i for the Jastrow parameters (h2) and the CI
    coefficients of a synthetic 4-det h2, per walker and batched."""
    cfg, params = build_system('h2', n_det=n_det, ci_seed=1, device='cpu')
    assert n_params(cfg) == P
    vec = opt_vector(cfg, params)
    rng = np.random.default_rng(n_det)
    R = torch.as_tensor(rng.normal(size=(3, cfg.n_elec, 3)),
                        dtype=torch.float32)
    o_fn = make_o_fn(cfg)
    O_b = o_batched(cfg, params, R).numpy()
    for w in range(3):
        fd = fd_gradient(cfg, params, vec, R[w])
        np.testing.assert_allclose(o_fn(vec, params, R[w]).numpy(), fd,
                                   atol=5e-3)
        np.testing.assert_allclose(O_b[w], fd, atol=5e-3)


def test_o_batched_screened_takes_one_screened_mo_pass(monkeypatch):
    """With ``screen_eps`` the CI ratios of O come from one pass of the
    screened MO pipeline (screened_mo on the card) and no unscreened one;
    O then matches finite differences of the screened ln|Psi| and, at
    eps = 1e-8, the unscreened O (water, 4 determinants, P = 7)."""
    from repro_torch.core import wavefunction
    cfg_s, params = build_system('water', n_det=4, ci_seed=1,
                                 screen_eps=1e-8, device='cpu')
    cfg_u, _ = build_system('water', n_det=4, ci_seed=1, device='cpu')
    assert wavefunction._screening_active(cfg_s) and n_params(cfg_s) == 7
    R = positions(params, cfg_u.n_elec, 6, 24)
    st = psi_state_batched(cfg_u, params, _t(R))
    d = st.drift.abs().amax(dim=(1, 2)).numpy()
    d[~np.isfinite(st.e_loc.numpy())] = np.inf
    R = _t(R[np.argsort(d)[:4]])
    calls = dict.fromkeys(('_mo_tensor_screened', 'eval_ao_rows',
                           'eval_ao_block'), 0)

    def _counted(mod, name):
        orig = getattr(mod, name)

        def _f(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, _f)
    _counted(wavefunction, '_mo_tensor_screened')
    _counted(wavefunction.aos, 'eval_ao_rows')
    _counted(wavefunction.aos, 'eval_ao_block')
    O_s = o_batched(cfg_s, params, R).numpy()
    assert calls == {'_mo_tensor_screened': 1, 'eval_ao_rows': 0,
                     'eval_ao_block': 0}
    monkeypatch.undo()
    vec = opt_vector(cfg_s, params)
    for w in range(R.shape[0]):
        np.testing.assert_allclose(O_s[w], fd_gradient(cfg_s, params, vec,
                                                       R[w]), atol=5e-3)
    assert_o_close(O_s, o_batched(cfg_u, params, R).numpy())


def test_opt_vector_roundtrip_and_clip():
    """vector -> params -> vector round-trips; clip enforces the domain."""
    cfg, params = build_system('h2', n_det=4, ci_seed=1, device='cpu')
    vec = opt_vector(cfg, params)
    p2 = params_from_vector(cfg, params, vec)
    np.testing.assert_allclose(torch.stack(list(p2.jastrow)).numpy(),
                               vec[:3], rtol=1e-6)
    np.testing.assert_allclose(p2.ci_coeffs.numpy(), vec[3:], rtol=1e-6)
    np.testing.assert_allclose(traced_vector(cfg, p2).numpy(), vec,
                               rtol=1e-6)
    assert traced_vector(cfg, p2).dtype == torch.float32
    bad = np.array([-3.0, 0.0, 1.0, 2.0, 0.0, 0.0, 0.0])
    clipped = clip_vector(cfg, bad)
    assert clipped[0] > 0 and clipped[1] > 0          # b's forced positive
    np.testing.assert_allclose(np.linalg.norm(clipped[3:]), 1.0, rtol=1e-9)


# ---------------------------------------------------------------------------
# O and moments against the reference, on the same walkers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('name,n_det,W', [('h2', 1, 8), ('h2', 4, 8),
                                          ('water', 1, 6),
                                          ('smallest', 100, 3)],
                         ids=['h2', 'h2-n_det4', 'water',
                              'smallest-n_det100'])
def test_o_and_moments_match_reference(name, n_det, W):
    cfg, params = j_build_system(name, n_det=n_det, ci_seed=1)
    tcfg, tparams = port_of(cfg, params)
    R = away_from_nodes(cfg, params, 3, W, 4 * W)
    vec = j_est.opt_vector(cfg, params)
    np.testing.assert_array_equal(opt_vector(tcfg, tparams), vec)
    O_j = _j(jax.jit(jax.vmap(j_est.make_o_fn(cfg), in_axes=(None, None, 0)))(
        jnp.asarray(vec, jnp.float32), params, jnp.asarray(R)))
    O_t = o_batched(tcfg, tparams, _t(R)).numpy()
    assert O_t.shape == (W, n_params(tcfg)) and O_t.dtype == np.float32
    assert_o_close(O_t, O_j)
    o_fn = make_o_fn(tcfg)
    assert_o_close(o_fn(vec, tparams, _t(R[0])).numpy()[None], O_j[:1])
    E_j = _j(j_wf.psi_state_batched(cfg, params, jnp.asarray(R)).e_loc)
    E_t = psi_state_batched(tcfg, tparams, _t(R)).e_loc.numpy()
    m_j, m_t = _moments(O_j, E_j), _moments(O_t, E_t)
    for k in MOMENTS:
        np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(m_j[k]).max(),
                                   err_msg=k)


def test_o_batched_never_builds_a_graph_through_the_mo_tensor(monkeypatch):
    """The MO tensor of the CI ratios is made without grad, so no gradient
    can reach an MO-product kernel."""
    from repro_torch.optimize import estimators
    cfg, params = build_system('h2', n_det=4, ci_seed=1, device='cpu')
    seen = []
    orig = estimators._mo_tensor_ensemble

    def _spy(*a):
        C, count = orig(*a)
        seen.append((torch.is_grad_enabled(), C.requires_grad))
        return C, count
    monkeypatch.setattr(estimators, '_mo_tensor_ensemble', _spy)
    R = torch.randn((4, cfg.n_elec, 3), generator=torch.Generator()
                    .manual_seed(0))
    O = o_batched(cfg, params, R)
    assert seen == [(False, False)]
    assert not O.requires_grad and O.grad_fn is None


# ---------------------------------------------------------------------------
# one generation against the reference, under its draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('name,n_det,tau', [('water', 1, 0.1),
                                            ('h2', 4, 1.0)],
                         ids=['water', 'h2-n_det4'])
def test_propagate_matches_reference_under_its_draws(name, n_det, tau):
    cfg, params = j_build_system(name, n_det=n_det, ci_seed=1)
    tcfg, tparams = port_of(cfg, params)
    W = 8
    R = away_from_nodes(cfg, params, 4, W, 4 * W)
    key = jax.random.PRNGKey(7)
    ens_j, _ = j_vmc.evaluate_ensemble(cfg, params, jnp.asarray(R))
    merged_j, out_j = jax.jit(functools.partial(
        JOptVMCPropagator(cfg, tau=tau).propagate, pop=JPopulation()))(
        params, ens_j, key)

    # vmc.py:90-95: per-walker key -> split -> normal eta, uniform u
    def _draw(k):
        k_eta, k_u = jax.random.split(k)
        return (jax.random.normal(k_eta, R.shape[1:], jnp.float32),
                jax.random.uniform(k_u, ()))
    eta, u = jax.vmap(_draw)(JPopulation().walker_keys(key, W))
    draws = (_t(eta), _t(u))
    ens_t, _ = t_vmc.evaluate_ensemble(tcfg, tparams, _t(R))
    _, lr_t, _ = t_vmc.propose_diffusion(tcfg, tparams, ens_t, None,
                                         Population(), tau, draws=draws)
    margin = np.abs(np.log(_j(u)) - lr_t.numpy())
    assert margin.min() > 1e-5, margin       # no near-tie on these walkers
    merged_t, out_t = OptVMCPropagator(tcfg, tau=tau).propagate(
        tparams, ens_t, None, Population(), draws=draws)
    acc_j = np.any(_j(merged_j.r) != R, axis=(1, 2))
    acc_t = np.any(merged_t.r.numpy() != R, axis=(1, 2))
    np.testing.assert_array_equal(acc_t, acc_j)
    assert 0 < acc_j.sum() < W
    assert float(out_t[2]) == pytest.approx(float(out_j[2]))
    for i, k in enumerate(MOMENTS, start=3):
        want = _j(out_j[i])
        np.testing.assert_allclose(out_t[i].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_opt_block_syncs_with_the_host_once(monkeypatch):
    """An opt-vmc block reads the device once: the moment arrays ride the
    block's one transfer and come back as host arrays."""
    cfg, params = build_system('h2', n_det=4, ci_seed=1, device='cpu')
    prop = OptVMCPropagator(cfg, tau=0.3)
    drv = EnsembleDriver(prop, 3)
    g = torch.Generator().manual_seed(2)
    st = drv.init(params, g, 8)
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
    assert stats.weight == 3 * 8
    assert stats.aux['opt_oo'].shape == (7, 7)
    assert stats.aux['opt_o'].shape == (7,)
    acc = BlockAccumulator.from_stats(stats)
    assert acc.aux['opt_oo/6/5'] == stats.aux['opt_oo'][6, 5]


# ---------------------------------------------------------------------------
# solvers: the same moments give the same bits
# ---------------------------------------------------------------------------
def _random_moments(cls, P, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(64, P))
    E = -1.0 + 0.1 * rng.normal(size=64)
    m = _moments(X, E)
    return cls(weight=64.0, n_blocks=3, e=float(E.mean()),
               e2=float((E * E).mean()), **m)


@pytest.mark.parametrize('P', [3, 7, 103])
def test_solvers_bitwise_equal_to_reference(P):
    vec = np.random.default_rng(P).normal(size=P)
    mt = _random_moments(Moments, P, P)
    mj = _random_moments(j_solvers.Moments, P, P)
    for a, b in zip(j_solvers.sr_matrices(mj), sr_matrices(mt)):
        assert np.array_equal(a, b)
    for kw in (dict(lr=0.1, damping=1e-2), dict(lr=0.3, damping=0.1,
                                                max_norm=0.01)):
        assert np.array_equal(sr_update(mt, vec, **kw),
                              j_solvers.sr_update(mj, vec, **kw))
    for kw in (dict(damping=1e-2), dict(damping=0.1, max_norm=0.5)):
        assert np.array_equal(lm_update(mt, vec, **kw),
                              j_solvers.lm_update(mj, vec, **kw))
    # collect_moments: the same blocks (one stale) in both packages
    rng = np.random.default_rng(P + 1)
    blocks = []
    for i, pv in enumerate((2.0, 2.0, 1.0)):
        aux = {'opt_pv': pv}
        for name, shape in (('opt_o', (P,)), ('opt_eo', (P,)),
                            ('opt_oo', (P, P)), ('opt_oeo', (P, P))):
            for idx in np.ndindex(shape):
                aux['/'.join([name, *map(str, idx)])] = float(rng.normal())
        blocks.append(dict(run_key='k', worker_id=0, block_id=i,
                           weight=10.0 + i, e_mean=-1.0 - i, e2_mean=2.0,
                           aux=aux))
    ct = collect_moments([BlockResult(**b) for b in blocks], P, 2)
    cj = j_solvers.collect_moments([JBlockResult(**b) for b in blocks], P, 2)
    assert ct.n_blocks == cj.n_blocks == 2
    for f in dataclasses.fields(cj):
        assert np.array_equal(getattr(ct, f.name), getattr(cj, f.name)), \
            f.name


# ---------------------------------------------------------------------------
# SR / LM solve on a fixed sample (deterministic, correlated sampling)
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def h2_sample():
    cfg, params = build_system('h2', device='cpu')
    vec = opt_vector(cfg, params)
    R = equilibrated_walkers(cfg, params)
    return cfg, params, vec, R, sample_moments(cfg, params, vec, R)


@pytest.mark.slow
def test_sr_step_lowers_reweighted_energy(h2_sample):
    """One damped SR step strictly lowers the correlated-sampling energy
    evaluated on the same fixed walker sample."""
    cfg, params, vec, R, m = h2_sample
    S, g = sr_matrices(m)
    assert np.all(np.linalg.eigvalsh(S) > -1e-6)      # metric is PSD
    e0 = reweighted_energy(cfg, params, vec, R)
    v1 = clip_vector(cfg, sr_update(m, vec, lr=0.1, damping=1e-2))
    e1 = reweighted_energy(cfg, params, v1, R)
    assert e1 < e0, (e0, e1)


@pytest.mark.slow
def test_lm_step_lowers_reweighted_energy(h2_sample):
    """The linear-method update off the same moments also descends."""
    cfg, params, vec, R, m = h2_sample
    e0 = reweighted_energy(cfg, params, vec, R)
    v1 = clip_vector(cfg, lm_update(m, vec, damping=0.1, max_norm=0.5))
    e1 = reweighted_energy(cfg, params, v1, R)
    assert e1 < e0, (e0, e1)


def test_reweighted_energy_matches_reference():
    """The correlated-sampling energy of a moved vector, both packages, on
    the same walkers."""
    cfg, params = j_build_system('h2', n_det=4, ci_seed=1)
    tcfg, tparams = port_of(cfg, params)
    R = away_from_nodes(cfg, params, 6, 8, 32)
    vec = j_est.opt_vector(cfg, params)
    v1 = j_est.clip_vector(cfg, vec + np.linspace(-0.1, 0.1, len(vec)))
    for v in (vec, v1):
        e_j = j_est.reweighted_energy(cfg, params, v, jnp.asarray(R))
        e_t = reweighted_energy(tcfg, tparams, v, _t(R))
        assert e_t == pytest.approx(e_j, rel=1e-5, abs=1e-5)


# ---------------------------------------------------------------------------
# stale-block rejection (the parameter-version protocol)
# ---------------------------------------------------------------------------
def _block(pv, weight=10.0, o=1.0):
    aux = {'opt_o/0': o, 'opt_eo/0': o, 'opt_oo/0/0': o, 'opt_oeo/0/0': o}
    if pv is not None:
        aux['opt_pv'] = pv
    return BlockResult(run_key='k', worker_id=0, block_id=0, weight=weight,
                       e_mean=-1.0, e2_mean=2.0, aux=aux)


def test_collect_moments_rejects_stale_blocks():
    """Blocks with a different, fractional, or missing version stamp never
    enter the solve; only exact current-version blocks are merged."""
    blocks = [_block(2.0, o=1.0), _block(2.0, o=3.0),   # current version
              _block(1.0, o=100.0),                     # stale
              _block(1.5, o=100.0),                     # merged across bump
              _block(None, o=100.0)]                    # unstamped (not opt)
    m = collect_moments(blocks, n_opt=1, version=2)
    assert m is not None and m.n_blocks == 2
    assert m.o[0] == pytest.approx(2.0)                 # mean of 1 and 3
    assert collect_moments(blocks, n_opt=1, version=7) is None


def test_cross_version_merge_produces_fractional_stamp():
    """The worker-side weighted merge of sub-blocks straddling a version
    bump yields a non-integer opt_pv — exactly what collect_moments
    rejects."""
    a = BlockAccumulator(10.0, -1.0, 2.0, {'opt_pv': 1.0})
    b = BlockAccumulator(10.0, -1.0, 2.0, {'opt_pv': 2.0})
    merged = a.merge(b)
    assert merged.aux['opt_pv'] == pytest.approx(1.5)
    assert merged.aux['opt_pv'] != 1.0 and merged.aux['opt_pv'] != 2.0


def test_sampler_stamps_current_version():
    """BlockSampler stamps opt_pv, and apply_params installs the vector as
    fp32 tensors on the sampler's device, then flips the version."""
    cfg, params = build_system('h2', device='cpu')
    prop = make_propagator('opt-vmc', cfg, tau=0.3)
    samp = BlockSampler(prop, params, n_walkers=8, steps=3, device='cpu')
    state = samp.init_state(0, seed=0)
    state, acc, _, _ = samp.run_subblock(state, 0)
    assert acc.aux['opt_pv'] == 0.0
    vec = opt_vector(cfg, params)
    vec[0] += 0.125
    samp.apply_params(3, vec)
    b_ee = samp.params.jastrow.b_ee
    assert b_ee.dtype == torch.float32 and b_ee.device.type == 'cpu'
    state, acc, _, _ = samp.run_subblock(state, 1)
    assert acc.aux['opt_pv'] == 3.0
    assert float(b_ee) == pytest.approx(1.125)
    # the moment arrays rode along as flattened scalar keys
    assert 'opt_o/0' in acc.aux and 'opt_oo/0/0' in acc.aux
    # a method without parameters to optimize stamps nothing
    plain = BlockSampler(make_propagator('vmc', cfg), params, n_walkers=8,
                         steps=3, device='cpu')
    _, acc, _, _ = plain.run_subblock(plain.init_state(0, seed=0), 0)
    assert 'opt_pv' not in acc.aux


def test_sampler_reevaluates_walkers_after_a_broadcast():
    """The first sub-block after apply_params starts from walkers evaluated
    under the new params (log|Psi|, drift, E_L), so its Metropolis ratios
    compare |Psi|^2 of one version; sub-blocks under an unchanged version
    evaluate nothing extra."""
    cfg, params = build_system('h2', device='cpu')
    prop = make_propagator('opt-vmc', cfg, tau=0.3)
    samp = BlockSampler(prop, params, n_walkers=8, steps=3, device='cpu')
    seen, calls = [], []
    run_block, reevaluate = samp.driver.run_block, prop.reevaluate
    samp.driver.run_block = (lambda p, st, gen:
                             seen.append((p, st)) or run_block(p, st, gen))
    prop.reevaluate = (lambda p, ens:
                       calls.append(p) or reevaluate(p, ens))
    state = samp.init_state(0, seed=0)
    state, _, _, _ = samp.run_subblock(state, 0)
    state, _, _, _ = samp.run_subblock(state, 1)
    assert calls == []
    vec = opt_vector(cfg, params)
    vec[:3] = (0.5, 0.25, 0.125)
    samp.apply_params(1, vec)
    state, acc, _, _ = samp.run_subblock(state, 2)
    state, _, _, _ = samp.run_subblock(state, 3)
    assert calls == [samp.params] and acc.aux['opt_pv'] == 1.0
    p, ens = seen[2]
    assert p is samp.params
    fresh = t_vmc.evaluate_ensemble(cfg, samp.params, ens.r)[0]
    stale = t_vmc.evaluate_ensemble(cfg, params, ens.r)[0]
    assert not torch.allclose(fresh.log_psi, stale.log_psi)
    for k in ('log_psi', 'drift', 'e_loc'):
        assert torch.equal(getattr(ens, k), getattr(fresh, k)), k


# ---------------------------------------------------------------------------
# checkpoints, in both directions
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_bitwise(tmp_path):
    """save -> restore reproduces the step-k vector bitwise and refuses a
    foreign run key."""
    d = str(tmp_path)
    vec = np.array([1.0, 2.0, np.pi], np.float64)
    save_checkpoint(d, 4, {'vec': vec}, run_key='abc')
    assert latest_step(d) == 4
    tree, k = restore_checkpoint(d, {'vec': np.zeros(3)}, run_key='abc')
    assert k == 4
    assert np.array_equal(tree['vec'], vec)            # bitwise
    with pytest.raises(ValueError, match='refusing'):
        restore_checkpoint(d, {'vec': np.zeros(3)}, run_key='other')


@pytest.mark.parametrize('writer', ['port', 'reference'])
def test_checkpoints_read_across_packages(tmp_path, writer):
    """A checkpoint one package writes, the other reads bitwise (nested
    dicts and lists included), under the same run-key guard."""
    save, restore = ((save_checkpoint, j_ckpt.restore_checkpoint)
                     if writer == 'port' else
                     (j_ckpt.save_checkpoint, restore_checkpoint))
    rng = np.random.default_rng(0)
    tree = {'vec': rng.normal(size=7), 'extra': {'a': np.arange(3),
                                                 'b': [np.float32(2.5),
                                                       rng.normal(size=2)]}}
    save(str(tmp_path), 2, tree, run_key='k1')
    save(str(tmp_path), 5, {'vec': np.ones(7), 'extra': tree['extra']},
         run_key='k1')
    like = {'vec': np.zeros(7), 'extra': {'a': np.zeros(3, np.int64),
                                          'b': [np.float32(0),
                                                np.zeros(2)]}}
    got, k = restore(str(tmp_path), like, step=2, run_key='k1')
    assert k == 2
    assert np.array_equal(got['vec'], tree['vec'])
    assert np.array_equal(got['extra']['a'], tree['extra']['a'])
    assert np.array_equal(got['extra']['b'][1], tree['extra']['b'][1])
    assert got['extra']['b'][0] == np.float32(2.5)
    assert restore(str(tmp_path), like)[1] == 5
    with pytest.raises(ValueError, match='refusing'):
        restore(str(tmp_path), like, run_key='k2')


# ---------------------------------------------------------------------------
# end-to-end optimization runs
# ---------------------------------------------------------------------------
def opt_spec(**kw):
    base = dict(system='h2', method='opt-vmc', backend='thread', n_workers=2,
                n_walkers=16, steps=10, subblocks_per_block=2, opt_steps=5,
                opt_blocks_per_step=4, seed=3, db=':memory:', device='cpu')
    base.update(kw)
    return RunSpec(**base)


@pytest.mark.slow
def test_opt_vmc_thread_end_to_end(tmp_path):
    """5 SR steps on H2 (thread backend): energy decreases modulo noise,
    every step checkpoints, and a second run resumes at the right step
    with bitwise-identical parameters."""
    ckpt = str(tmp_path / 'ckpt')
    db = str(tmp_path / 'run.sqlite')
    run = build_run(opt_spec(opt_steps=5, ckpt_dir=ckpt, db=db,
                             n_walkers=32, steps=20, opt_blocks_per_step=6))
    res = run.run()
    assert isinstance(res, OptResult)
    assert not run.worker_errors(), run.worker_errors()
    assert [s.step for s in res.steps] == [0, 1, 2, 3, 4]
    es = res.energies()
    assert es[-1] < es[0] - 0.02                 # net improvement
    # monotone modulo noise: each step improves or backtracks < 3 sigma
    for a, b in zip(res.steps, res.steps[1:]):
        assert b.energy < a.energy + 3 * max(a.error + b.error, 1e-3), es
    assert latest_step(ckpt) == 4                # checkpointed every step

    # resume: picks up at step 5 with the exact final vector of run 1
    run2 = build_run(opt_spec(opt_steps=7, ckpt_dir=ckpt, db=db,
                              n_walkers=32, steps=20, opt_blocks_per_step=6))
    res2 = run2.run()
    assert [s.step for s in res2.steps] == [5, 6]
    assert np.array_equal(res2.steps[0].vec, res.vec)  # bitwise restore


@pytest.mark.slow
def test_opt_vmc_ci_parameters_move():
    """Optimizing a synthetic multidet H2: CI coefficients actually move
    and stay unit-normalized (the gauge fix); the linear method too."""
    for solver in ('sr', 'lm'):
        run = build_run(opt_spec(n_det=4, opt_steps=2, opt_blocks_per_step=3,
                                 opt_solver=solver, sr_damping=0.1))
        res = run.run()
        assert not run.worker_errors(), run.worker_errors()
        v0, v1 = res.steps[0].vec, res.vec
        assert v0.shape == (7,)
        assert not np.allclose(v0[3:], v1[3:]), solver
        np.testing.assert_allclose(np.linalg.norm(v1[3:]), 1.0, rtol=1e-9)


def _wait_for_blocks_of(mgr, run, worker_id, what):
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        mgr.poll()
        if any(b.worker_id == worker_id for b in mgr.db.blocks(run.run_key)):
            return
        time.sleep(0.1)
    raise AssertionError(f'{what} never produced blocks')


def _stamps_of(run, worker_id):
    return {b.aux['opt_pv'] for b in run.db.blocks(run.run_key)
            if b.worker_id == worker_id and 'opt_pv' in b.aux}


@pytest.mark.slow
def test_opt_vmc_process_kill_and_replace_drill(monkeypatch):
    """Process backend: SIGKILL a worker between steps, add a replacement;
    the replacement boots with the *current* broadcast vector, so every
    block it ever stamps carries an integer version >= the version at its
    spawn.  The worker processes run torch on one thread each (the test
    run shares the host's cores with other test processes)."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    run = build_run(opt_spec(backend='process', opt_steps=4,
                             opt_blocks_per_step=3))
    state = {}

    def drill(step, mgr, vec):
        if step == 0:
            victim = mgr.workers[0]
            mgr.remove_worker(victim, graceful=False)
            state['new'] = mgr.add_worker().worker_id
            state['version'] = 1             # version broadcast at spawn
        if step == 3:                        # hold the run open until the
            _wait_for_blocks_of(mgr, run, state['new'],   # replacement
                                'replacement worker')     # contributes

    res = run_optimization(run, on_step=drill, step_timeout=120)
    assert len(res.steps) == 4
    pvs = _stamps_of(run, state['new'])
    assert pvs, 'replacement produced no stamped blocks'
    assert min(pvs) >= state['version'], pvs
    assert all(float(p).is_integer() for p in pvs), pvs


@pytest.mark.slow
def test_opt_vmc_grid_elastic_join_gets_current_params(monkeypatch):
    """Grid backend: an elastic worker joining mid-optimization receives
    the current parameter vector in its WELCOME — its first stamped block
    already carries the current (integer) version, never version 0.  The
    worker processes run torch on one thread each."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    run = build_run(opt_spec(backend='grid', opt_steps=4,
                             opt_blocks_per_step=3))
    state = {}

    def drill(step, mgr, vec):
        if step == 0:
            state['new'] = mgr.add_worker().worker_id
            state['version'] = 1
        if step == 3:
            _wait_for_blocks_of(mgr, run, state['new'], 'elastic worker')

    res = run_optimization(run, on_step=drill, step_timeout=120)
    assert len(res.steps) == 4
    assert not run.worker_errors(), run.worker_errors()
    pvs = _stamps_of(run, state['new'])
    assert pvs, 'elastic worker produced no stamped blocks'
    assert min(pvs) >= state['version'], pvs
    assert all(float(p).is_integer() for p in pvs), pvs


# ---------------------------------------------------------------------------
# spec / CLI wiring
# ---------------------------------------------------------------------------
def test_runspec_opt_validation():
    with pytest.raises(ValueError, match='opt_solver'):
        RunSpec(opt_solver='adam')
    with pytest.raises(ValueError, match='opt_steps'):
        RunSpec(opt_steps=0)
    s = RunSpec(method='opt-vmc', opt_solver='lm')
    assert s.resolved_tau() == pytest.approx(0.3)


def test_qmc_run_cli_parses_opt_flags():
    s = qmc_run.parse_spec(['--method', 'opt-vmc', '--opt-steps', '7',
                            '--opt-solver', 'lm', '--opt-lr', '0.2',
                            '--sr-damping', '0.05', '--opt-blocks', '9',
                            '--ckpt-dir', '/tmp/x'])
    assert s.method == 'opt-vmc' and s.opt_steps == 7
    assert s.opt_solver == 'lm' and s.opt_lr == pytest.approx(0.2)
    assert s.sr_damping == pytest.approx(0.05)
    assert s.opt_blocks_per_step == 9 and s.ckpt_dir == '/tmp/x'


def test_qmc_run_cli_optimizes_on_the_cpu(tmp_path, capsys):
    """``qmc_run --method opt-vmc --device cpu`` prints the trajectory and
    checkpoints every step."""
    ckpt = tmp_path / 'ckpt'
    res = qmc_run.main(['--system', 'h2', '--method', 'opt-vmc', '--device',
                        'cpu', '--workers', '2', '--walkers', '32',
                        '--steps', '20', '--opt-steps', '3', '--opt-blocks',
                        '3', '--ckpt-dir', str(ckpt)])
    out = capsys.readouterr().out
    assert isinstance(res, OptResult) and len(res.steps) == 3
    assert f'opt-vmc run {res.run_key}: 3 steps' in out
    assert out.count('(pv ') == 3
    assert latest_step(ckpt) == 2


def test_qmc_run_cli_refuses_to_optimize_on_the_cpu_unasked():
    """Without ``--device cpu`` the CLI wants the card, and raises on a host
    without one."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is valid here')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        qmc_run.main(['--system', 'h2', '--method', 'opt-vmc', '--workers',
                      '1', '--opt-steps', '1'])
