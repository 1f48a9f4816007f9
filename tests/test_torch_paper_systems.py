"""The paper's three larger systems in the PyTorch port against the JAX
package, on the CPU: the TZ beta-strand (``b-strand-tz``, 434 e-, f
shells), 1ZE7 (1056 e-) and 1AMB (1731 e-: 866 up, 865 down).

The generators of both packages give the same basis, nuclei, MOs and
screening budget; one finite 1ZE7 walker evaluates screened at eps = 1e-8
to the reference's value, also with ``--n-det 100``'s CI expansion (its
virtual MO rows and excitation lists bitwise the reference's); the TZ AO
block (f shells) matches the
reference's; the fused sweep's launch chooser takes its cluster route at
these block sizes (the global route with CI, at the threads per block
tuned on CI operands); a system with unequal spin blocks sweeps move for move
as the reference does; and the ensemble pass split into walker chunks
(``wavefunction.walker_chunks``) gives the unsplit pass's result.

Inputs are made with numpy from a seed and handed to both packages;
parameters go through ``systems/convert.py::from_numpy``.  Tolerances are
the parity rules of the other port tests: log psi 1e-4 + 2e-6 relative;
drift and E_L 1e-4 relative to the walker's scale; AO values rtol 1e-5;
accept decisions identical move for move except margins within 1e-5 of 0;
maintained inverses within 1e-4 of the walker's largest entry.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.core import aos as j_aos  # noqa: E402
from repro.core import screening as j_scr  # noqa: E402
from repro.core import sem as j_sem  # noqa: E402
from repro.core import wavefunction as j_wf  # noqa: E402
from repro.core.driver import Population as JPopulation  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402
from repro.systems.bench import (  # noqa: E402
    build_bench_wavefunction as j_bench_wf, make_bench_system as j_make,
    paper_system as j_paper_system)

from repro_torch.core import aos, screening, sem as t_sem  # noqa: E402
from repro_torch.core import wavefunction as t_wf  # noqa: E402
from repro_torch.core.driver import Population  # noqa: E402
from repro_torch.kernels.fused_sweep import autotune  # noqa: E402
from repro_torch.kernels.fused_sweep import kernel as fsk  # noqa: E402
from repro_torch.systems import build_system as t_build_system  # noqa: E402
from repro_torch.systems.bench import paper_system as t_paper_system  # noqa: E402,E501
from repro_torch.systems.convert import from_numpy  # noqa: E402

PAPER = ('b-strand-tz', '1ze7', '1amb')
EPS = 1e-8
MARGIN = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return np.asarray(x)


def port_of(cfg, params, method=None):
    """The port's (cfg, params) for a JAX (cfg, params), via numpy only;
    with screening the port builds its own structure at the reference's
    eps from the reference's build geometry."""
    basis = {f.name: np.asarray(getattr(cfg.basis, f.name))
             for f in dataclasses.fields(cfg.basis)}
    jas = {k: np.asarray(getattr(params.jastrow, k))
           for k in ('b_ee', 'b_en', 'a_en')}
    tcfg, tparams = from_numpy(
        basis, np.asarray(params.coords), np.asarray(params.charges),
        np.asarray(params.mo), jas, n_up=cfg.n_up, n_dn=cfg.n_dn,
        k_max=cfg.k_max, method=method or cfg.method, ns_steps=cfg.ns_steps,
        sem_refresh=cfg.sem_refresh, device='cpu')
    scr = cfg.screening
    if scr is not None:
        tcfg = dataclasses.replace(tcfg, screening=screening.build_screening(
            tcfg.basis, scr.coords, np.asarray(params.mo), eps=scr.eps))
    return tcfg, tparams


def positions(coords, charges, n_e, seed, n_walkers, spread=1.2):
    """Walkers around charge-weighted random nuclei (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    coords, charges = np.asarray(coords), np.asarray(charges)
    at = rng.choice(coords.shape[0], (n_walkers, n_e),
                    p=charges / charges.sum())
    return (coords[at] + spread * rng.normal(size=(n_walkers, n_e, 3))
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# the generators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('name', PAPER)
def test_paper_system_generators_match_reference(name):
    """Basis arrays, nuclei, spins and MOs of both generators equal; the
    screening structure at eps = 1e-8 gives the same AO budget and the
    same ``memory_budget`` at W = 256; f shells only in the TZ basis."""
    a, b = t_paper_system(name), j_paper_system(name)
    for f in dataclasses.fields(b.basis):
        np.testing.assert_array_equal(getattr(a.basis, f.name),
                                      getattr(b.basis, f.name), f.name)
    np.testing.assert_array_equal(a.mol.coords, b.mol.coords)
    np.testing.assert_array_equal(a.mol.charges, b.mol.charges)
    assert (a.mol.n_up, a.mol.n_dn) == (b.mol.n_up, b.mol.n_dn)
    np.testing.assert_array_equal(a.mos, b.mos)
    assert (int(a.basis.ao_pow.sum(axis=1).max()) == 3) == (name ==
                                                             'b-strand-tz')
    sa = screening.build_screening(a.basis, a.mol.coords, a.mos, eps=EPS)
    sb = j_scr.build_screening(b.basis, b.mol.coords, b.mos, eps=EPS)
    n_e = a.mol.n_up + a.mol.n_dn
    ma = screening.memory_budget(sa, a.basis, n_e, a.mos.shape[0], 256)
    mb = j_scr.memory_budget(sb, b.basis, n_e, b.mos.shape[0], 256)
    assert ma == mb
    assert ma['ao_budget'] == {'b-strand-tz': 744, '1ze7': 1072,
                               '1amb': 1392}[name]
    if name == '1amb':
        assert (a.mol.n_up, a.mol.n_dn) == (866, 865)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def ze7():
    """The reference's screened 1ZE7 and the port's copy of it."""
    cfg, params = j_build_system('1ze7', screen_eps=EPS)
    return cfg, params, port_of(cfg, params)


def test_1ze7_screened_walker_matches_reference(ze7):
    """One seeded finite 1ZE7 walker (1056 electrons, K = 1072 candidates)
    through the reference's ``psi_state`` and the port's, screened at eps
    = 1e-8: sign and active AO counts equal, log psi within 1e-4 + 2e-6
    relative, E_L within 1e-4 relative, drift within 1e-4 of its largest
    entry."""
    cfg, params, (tcfg, tparams) = ze7
    R = positions(params.coords, params.charges, cfg.n_elec, 3, 1)[0]
    sj = jax.jit(functools.partial(j_wf.psi_state, cfg))(params,
                                                         jnp.asarray(R))
    st = t_wf.psi_state(tcfg, tparams, _t(R))
    assert np.isfinite(_j(sj.log_psi)) and np.isfinite(_j(sj.e_loc))
    assert float(st.sign) == float(sj.sign)
    np.testing.assert_array_equal(st.ao_count.numpy(), _j(sj.ao_count))
    lp = float(_j(sj.log_psi))
    assert abs(float(st.log_psi) - lp) <= 1e-4 + 2e-6 * abs(lp)
    el = float(_j(sj.e_loc))
    assert abs(float(st.e_loc) - el) <= 1e-4 * abs(el)
    dj = _j(sj.drift)
    np.testing.assert_allclose(st.drift.numpy(), dj, rtol=1e-4,
                               atol=1e-4 * np.abs(dj).max())


CI_FIELDS = ('coeffs', 'holes_up', 'parts_up', 'holes_dn', 'parts_dn')


def test_1ze7_ci_walker_matches_reference():
    """``build_system('1ze7', n_det=100, screen_eps=1e-8)`` of both
    packages: n_orb = 792 (528 occupied + max(8, 528 // 2) virtual rows),
    the MO rows (the virtual ones included) and the excitation lists
    bitwise equal; one seeded finite walker through the reference's
    ``psi_state`` and the port's, screened: sign and active AO counts
    equal, the CI log psi within 1e-4 + 2e-6 relative, E_L within 1e-4
    relative."""
    cfg, params = j_build_system('1ze7', n_det=100, screen_eps=EPS)
    tcfg, tparams = t_build_system('1ze7', n_det=100, screen_eps=EPS,
                                   device='cpu')
    assert cfg.ci.n_orb == tcfg.ci.n_orb == 792
    assert tparams.mo.shape[0] == 792
    np.testing.assert_array_equal(tparams.mo.numpy(), _j(params.mo))
    for f in CI_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(tcfg.ci, f)),
                                      _j(getattr(cfg.ci, f)), f)
    R = positions(params.coords, params.charges, cfg.n_elec, 3, 1)[0]
    sj = jax.jit(functools.partial(j_wf.psi_state, cfg))(params,
                                                         jnp.asarray(R))
    st = t_wf.psi_state(tcfg, tparams, _t(R))
    assert np.isfinite(_j(sj.log_psi)) and np.isfinite(_j(sj.e_loc))
    assert float(st.sign) == float(sj.sign)
    np.testing.assert_array_equal(st.ao_count.numpy(), _j(sj.ao_count))
    lp = float(_j(sj.log_psi))
    assert abs(float(st.log_psi) - lp) <= 1e-4 + 2e-6 * abs(lp)
    el = float(_j(sj.e_loc))
    assert abs(float(st.e_loc) - el) <= 1e-4 * abs(el)


def test_tz_ao_block_with_f_shells_matches_reference():
    """The TZ beta-strand's AO values, gradients and Laplacians (its f
    shells included) at 32 electrons against the reference's
    ``eval_ao_block``, rtol 1e-5 (and 1e-5 of the block's largest entry);
    the active atoms equal."""
    cfg, params = j_build_system('b-strand-tz')
    tcfg, tparams = port_of(cfg, params)
    assert int(np.asarray(cfg.basis.ao_pow).sum(axis=1).max()) == 3
    R = positions(params.coords, params.charges, 32, 11, 1)[0]
    Bj, aj = j_aos.eval_ao_block(cfg.basis, params.coords, jnp.asarray(R))
    Bt, at = aos.eval_ao_block(tcfg.basis_t, tparams.coords, _t(R))
    np.testing.assert_array_equal(at.numpy(), _j(aj))
    Bj = _j(Bj)
    f_rows = np.asarray(cfg.basis.ao_pow).sum(axis=1) == 3
    assert np.abs(Bj[f_rows]).max() > 0
    np.testing.assert_allclose(Bt.numpy(), Bj, rtol=1e-5,
                               atol=1e-5 * np.abs(Bj).max())


def _close(got, want, field):
    """``got`` within 1e-6 of ``want`` (relative, and of its largest
    entry); empty fields (a single determinant's CI state) by shape."""
    assert got.shape == want.shape, field
    if want.numel():
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()),
                                   err_msg=field)


def test_walker_chunks_split_the_ensemble_pass_alike(monkeypatch):
    """With a budget that holds two walkers, the ensemble evaluation, the
    SEM state, the fused proposals' orbital values and a whole sem-vmc
    propagate (its refresh sweep) run on walker chunks in turn and give
    the unchunked results (screened water, walkers near the nuclei, where
    fp32 resolves every field: the batched LU of another batch size
    rounds alike there); a budget below one walker raises instead of
    dropping walkers."""
    cfg, params = t_build_system('water', screen_eps=EPS, device='cpu')
    R = _t(positions(params.coords, params.charges, cfg.n_elec, 5, 5,
                     spread=0.6))
    per = t_wf.eval_bytes_per_walker(cfg, params.mo.shape[0])
    whole = (t_wf.psi_state_batched(cfg, params, R),
             t_sem.evaluate_sem(cfg, params, R))

    def _budget(n_bytes):
        monkeypatch.setattr(t_wf, 'eval_budget_bytes',
                            lambda device: n_bytes)
    _budget(int(2.5 * per))
    chunks = t_wf.walker_chunks(cfg, params, 5)
    assert [(s.start, s.stop) for s in chunks] == [(0, 2), (2, 4), (4, 5)]
    split = (t_wf.psi_state_batched(cfg, params, R),
             t_sem.evaluate_sem(cfg, params, R))
    for a, b in zip(whole, split):
        for f, x, y in zip(a._fields, a, b):
            _close(y, x, f)
    fcfg = t_sem._fused_cfg(cfg)
    A_up, A_dn = t_sem._mo_blocks(fcfg, params)
    phis = t_sem._fused_phi_all(fcfg, params, A_up, A_dn, R)
    _budget(None)
    for x, y in zip(t_sem._fused_phi_all(fcfg, params, A_up, A_dn, R),
                    phis):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    prop = t_sem.SEMVMCPropagator(cfg)
    state = t_sem.SEMState(ens=whole[1], sweeps=7)
    g = torch.Generator().manual_seed(0)
    draws = t_sem.draw_sweep(g, R)
    ref, _ = prop.propagate(params, state, None, Population(), draws)
    _budget(int(2.5 * per))
    got, _ = prop.propagate(params, state, None, Population(), draws)
    for f, x, y in zip(ref.ens._fields, ref.ens, got.ens):
        _close(y, x, f)
    _budget(int(0.5 * per))
    with pytest.raises(RuntimeError, match='one walker'):
        t_wf.psi_state_batched(cfg, params, R)


# ---------------------------------------------------------------------------
# the fused sweep's route at these sizes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('n', [528, 865, 866])
@pytest.mark.parametrize('ci', [False, True])
def test_launch_shape_takes_the_global_route_at_paper_sizes(n, ci, tmp_path):
    """``launch_shape`` is a pure function of the sizes: at n = 528 (1ZE7),
    865 and 866 (1AMB's two blocks), at W = 256 on the H100, the same
    answer on every call: the cluster route (1ZE7 8 blocks a walker, 1AMB
    16), its rows on chip for the whole sweep.  With CI (the ``--n-det
    100`` widths: n + max(8, n // 2) orbitals) too, the expansion's held
    rows beside them, at the cluster size the tuner measures on CI
    operands of those widths where two sizes hold the block
    (``best_launch`` with ``ci``, cached under the key with
    ``|cluster|ci<n_orb>x<n_det>x<k>``; at 1AMB one size is left, taken
    without measuring); rank 9 keeps the global route at the threads per
    block tuned on CI operands (its key ``ci<n_orb>x<n_det>x9``), as the
    global route was the size's choice for every CI block past n = 256
    before the chain took them.  (The test's name is the one it had
    then.)"""
    n_e = 2 * n
    n_orb = n + max(8, n // 2)
    sizes = ((n, n_orb, n_e, n_orb, 100, True) if ci else (n, n, n_e))
    launch = {}
    if ci:
        path = tmp_path / 'tiles.json'
        seen = []

        def fake_measure(n_e, W, candidates):
            seen.append(tuple(candidates))
            return candidates[-1]
        launch = autotune.best_launch(n_e, 256, path=path,
                                      measure=fake_measure, card=fsk.H100,
                                      ci=(n_orb, 100, 2))
        assert launch == {'cluster': 16}
        tiles = json.loads(path.read_text())['tiles'] if seen else {}
        assert seen == ([(8, 16)] if n == 528 else [])
        assert tiles == ({f'{n_e}|256|fp32|cuda|cluster|ci{n_orb}x100x2': 16}
                         if n == 528 else {})
        rank9 = autotune.best_launch(n_e, 256, path=path,
                                     measure=lambda *a: a[2][0],
                                     card=fsk.H100, ci=(n_orb, 100, 9))
        assert rank9 == {'threads': 256}
        assert json.loads(path.read_text())['tiles'][
            f'{n_e}|256|fp32|cuda|ci{n_orb}x100x9'] == 256
        assert fsk.launch_shape(*sizes, walkers=256, k=9,
                                **rank9).route == 'global'
    shapes = {fsk.launch_shape(*sizes, walkers=256, **launch)
              for _ in range(3)}
    assert len(shapes) == 1
    (shape,) = shapes
    assert (shape.route, shape.cluster) == ('cluster',
                                            launch.get('cluster', 8 if n == 528
                                                       else 16))
    assert shape.threads // 32 * shape.rows >= -(-n // shape.cluster)
    assert shape.smem_bytes <= fsk.H100.optin


# ---------------------------------------------------------------------------
# unequal spin blocks
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def odd61():
    """A 61-electron peptide (31 up, 30 down) of the reference's
    generator, the port's copy through ``from_numpy``."""
    sys = j_make('t61', 61, seed=0)
    cfg, params = j_bench_wf(sys, method='sparse', k_max=sys.basis.n_ao)
    assert (cfg.n_up, cfg.n_dn) == (31, 30)
    return cfg, params, port_of(cfg, params, method='kernel')


def _sem_draws(key, W, n_e):
    """The reference's sweep draws (its sem.py per-walker, per-electron
    keys)."""
    wkeys = JPopulation().walker_keys(key, W)

    def _one(k, j):
        ke, ku = jax.random.split(jax.random.fold_in(k, j))
        return (jax.random.normal(ke, (3,), jnp.float32),
                jax.random.uniform(ku, (), jnp.float32))
    eta, u = jax.vmap(lambda k: jax.vmap(lambda j: _one(k, j))(
        jnp.arange(n_e)))(wkeys)
    return _j(eta), _j(u)


@pytest.mark.parametrize('method', ['sem-vmc', 'fused-vmc'])
def test_unequal_spin_blocks_sweep_as_the_reference(odd61, method):
    """One sem-vmc (each move through ``sem_move``) and one fused-vmc
    (``fused_sweep``) sweep of a 31 + 30 electron system, each package
    under the reference's draws: accepts move for move up to each walker's
    first near tie; then the maintained inverses of both blocks within
    1e-4 of the reference's (relative to the walker's largest entry), and
    log psi and E_L within the evaluation tolerance."""
    cfg, params, (tcfg, tparams) = odd61
    W, step = 4, 0.3
    R = positions(params.coords, params.charges, cfg.n_elec, 2, W)
    key = jax.random.PRNGKey(7)
    jcfg = j_sem._fused_cfg(cfg) if method == 'fused-vmc' else cfg
    prop_j = j_sem.SEMVMCPropagator(jcfg, step_size=step)
    ens_j = jax.jit(functools.partial(j_sem.evaluate_sem, cfg))(
        params, jnp.asarray(R))
    st_j, _ = jax.jit(functools.partial(prop_j.propagate,
                                        pop=JPopulation()))(
        params, j_sem.SEMState(ens=ens_j, sweeps=jnp.int32(0)), key)
    tc = t_sem._fused_cfg(tcfg) if method == 'fused-vmc' else tcfg
    prop_t = t_sem.SEMVMCPropagator(tc, step_size=step)
    state = t_sem.SEMState(ens=t_sem.evaluate_sem(tcfg, tparams, _t(R)),
                           sweeps=0)
    assert tuple(state.ens.minv_dn.shape) == (W, 30, 30)
    draws = tuple(_t(x) for x in _sem_draws(key, W, cfg.n_elec))
    *_, acc_t, mar_t = prop_t.sweep(tparams, state, None, draws)
    st_t, _ = prop_t.propagate(tparams, state, None, Population(), draws)
    moved = np.any(_j(st_j.ens.r) != R, axis=-1).T
    acc, mar = acc_t.numpy(), np.abs(mar_t.numpy())
    clean = []
    for w in range(W):
        tie = False
        for j in range(cfg.n_elec):
            if mar[j, w] < MARGIN:
                tie = True
                break
            assert acc[j, w] == moved[j, w], (w, j)
        if not tie:
            clean.append(w)
    assert 0 < acc.sum() < acc.size
    assert clean
    for f in ('minv_up', 'minv_dn'):
        a = getattr(st_t.ens, f).numpy()[clean]
        b = _j(getattr(st_j.ens, f))[clean]
        scale = np.abs(b).max(axis=(1, 2))
        assert np.all(np.abs(a - b).max(axis=(1, 2)) <= 1e-4 * scale), f
    lp = _j(st_j.ens.log_psi)[clean]
    assert np.all(np.abs(st_t.ens.log_psi.numpy()[clean] - lp)
                  <= 1e-4 + 2e-6 * np.abs(lp))
    el = _j(st_j.ens.e_loc)[clean]
    assert np.all(np.abs(st_t.ens.e_loc.numpy()[clean] - el)
                  <= 1e-4 * np.abs(el))
