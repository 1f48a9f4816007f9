"""Multideterminant wavefunctions of the PyTorch port against the JAX
package: ``core/multidet.py``, the CI branches of ``core/wavefunction.py``
and ``core/sem.py`` (per move and fused), ``kernels/multidet_ratio``
(its plain version, which the CPU runs), the small-determinant helpers of
``core/slater.py`` and the ``--n-det`` front door.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the parity rules of the other port tests, against the JAX
package's own output (not against the naive per-determinant oracle at
1e-5, which the reference itself misses: ROADMAP Queue C): log psi 1e-4 +
2e-6 relative; drift and E_L 1e-4 relative to the walker's scale; accept
decisions identical move for move except margins within 1e-5 of 0; the
maintained tables within the 1e-4 drift bound of a fresh recompute.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.core import multidet as j_md  # noqa: E402
from repro.core import sem as j_sem  # noqa: E402
from repro.core import wavefunction as j_wf  # noqa: E402
from repro.core.driver import Population as JPopulation  # noqa: E402
from repro.kernels.multidet_ratio.ref import (  # noqa: E402
    multidet_ratios_ref as j_ratios_ref)
from repro.runtime.database import critical_data_key as j_key  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402
from repro.systems.bench import synthetic_ci as j_synthetic_ci  # noqa: E402

from repro_torch.core import multidet, sem as t_sem, slater  # noqa: E402
from repro_torch.core import wavefunction as t_wf  # noqa: E402
from repro_torch.core.driver import EnsembleDriver, Population  # noqa: E402
from repro_torch.core.vmc import VMCPropagator  # noqa: E402
from repro_torch.kernels.multidet_ratio.ops import (  # noqa: E402
    multidet_ratios, normalized_excitations)
from repro_torch.kernels.multidet_ratio.ref import (  # noqa: E402
    multidet_ratios_ref)
from repro_torch.launch import qmc_run  # noqa: E402
from repro_torch.launch.spec import RunSpec, build_run  # noqa: E402
from repro_torch.systems import build_system as t_build_system  # noqa: E402
from repro_torch.systems.bench import synthetic_ci  # noqa: E402
from repro_torch.systems.convert import from_numpy  # noqa: E402
from repro_torch.systems.molecule import build_wavefunction, water  # noqa: E402

MARGIN = 1e-5
CI_FIELDS = ('coeffs', 'holes_up', 'parts_up', 'holes_dn', 'parts_dn')


def port_of(cfg, params, method='kernel'):
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
                      method=method, ns_steps=cfg.ns_steps,
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


def j_batched(cfg):
    return jax.jit(functools.partial(j_wf.psi_state_batched, cfg))


def away_from_nodes(cfg, params, seed, n_walkers, n_draw):
    """The ``n_walkers`` of ``n_draw`` seeded walkers farthest from a node
    of Psi (smallest max |drift|, by the reference), as
    ``tests/test_torch_wavefunction.py`` picks them: near a node of the
    reference determinant or of the CI sum (|S| << sum |c_I R_I|) fp32
    loses digits on both sides alike."""
    R = positions(params, cfg.n_elec, seed, n_draw)
    d = _j(j_batched(cfg)(params, jnp.asarray(R)).drift)
    return R[np.argsort(np.abs(d).max(axis=(1, 2)))[:n_walkers]]


@pytest.fixture(scope='module')
def water_ci():
    """Water with the reference's 6-determinant synthetic expansion."""
    cfg, params = j_build_system('water', n_det=6, ci_seed=3)
    return cfg, params, port_of(cfg, params)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------
def test_from_excitations_validates_and_matches_jax():
    for bad, msg in ((([7], [8]), 'not occupied'), (([0], [2]), 'not virtual'),
                     (([0, 0], [5, 6]), 'duplicate')):
        with pytest.raises(ValueError, match=msg):
            multidet.from_excitations([1., .1], [(bad, ([], []))], 5, 5, 9)
    exc = [(([0], [6]), ([], [])), (([1, 3], [5, 8]), ([2], [7]))]
    t = multidet.from_excitations([1., .2, -.1], exc, 5, 5, 9)
    j = j_md.from_excitations([1., .2, -.1], exc, 5, 5, 9)
    assert (t.n_det, t.k, t.n_orb) == (j.n_det, j.k, j.n_orb) == (3, 2, 9)
    for f in CI_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


def test_det_file_roundtrip():
    text = """
    # CISD-style toy file: coeff  up-occ | dn-occ
     1.00  0 1 | 0 1
    -0.20  0 3 | 0 1    # single: up 1 -> 3
     0.10  2 3 | 0 1    # double: up 0,1 -> 2,3
     0.05  0 1 | 1 2    # single: dn 0 -> 2
    """
    mdw = multidet.from_det_file(text, n_up=2, n_dn=2, n_orb=4)
    ref = j_md.from_det_file(text, n_up=2, n_dn=2, n_orb=4)
    for f in CI_FIELDS:
        np.testing.assert_array_equal(getattr(mdw, f), getattr(ref, f))
    assert mdw.n_det == 4 and mdw.k == 2
    # det 3 (dn rows [2, 1]: one inversion) picks up a -1 parity
    np.testing.assert_array_equal(mdw.coeffs,
                                  np.float32([1.0, -0.2, 0.1, -0.05]))
    assert mdw.holes_up[3, 0] == 2 and mdw.parts_up[3, 0] == 4
    with pytest.raises(ValueError, match='reference determinant'):
        multidet.from_det_file(' 1.0  1 2 | 0 1', 2, 2, 4)
    with pytest.raises(ValueError, match='occupation counts'):
        multidet.from_det_file(' 1.0  0 1 | 0 1\n 0.5  0 1 1 | 0 1', 2, 2, 4)


def test_row_parity_matches_sorted_determinant_convention():
    rng = np.random.default_rng(11)
    V = rng.standard_normal((8, 4))
    for holes, parts in ([(0,), (6,)], [(3,), (7,)], [(0, 2), (5, 7)],
                         [(1, 3), (4, 6)]):
        rows = list(range(4))
        for h, p in zip(holes, parts):
            rows[h] = p
        parity = multidet._row_parity(holes, parts, 4)
        assert parity == j_md._row_parity(holes, parts, 4)
        assert np.linalg.det(V[rows]) == pytest.approx(
            parity * np.linalg.det(V[sorted(rows)]), rel=1e-10)


@pytest.mark.parametrize('shape', [(5, 5, 7, 6, 3), (79, 79, 118, 100, 0),
                                   (4, 3, 9, 20, 1)])
def test_synthetic_ci_is_the_reference_draw(shape):
    n_up, n_dn, n_orb, n_det, seed = shape
    t = synthetic_ci(n_up, n_dn, n_orb, n_det, seed=seed)
    j = j_synthetic_ci(n_up, n_dn, n_orb, n_det, seed=seed)
    for f in CI_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    with pytest.raises(ValueError, match='distinct excitations'):
        synthetic_ci(1, 0, 2, 50, seed=0)


def test_catalog_builds_the_reference_ci_systems():
    """--n-det reaches the builders: the micro-peptide gains
    max(8, 79 // 2) = 39 virtual orbitals (n_orb = 118) and the
    reference's expansion; water its n_orb = 7 expansion."""
    for name, n_det, n_orb in (('smallest', 100, 118), ('water', 6, 7)):
        cfg_j, params_j = j_build_system(name, n_det=n_det, ci_seed=2)
        cfg_t, params_t = t_build_system(name, n_det=n_det, ci_seed=2,
                                         device='cpu')
        assert cfg_t.ci.n_orb == cfg_j.ci.n_orb == n_orb
        assert params_t.mo.shape[0] == n_orb
        np.testing.assert_allclose(params_t.mo.numpy(), _j(params_j.mo),
                                   rtol=1e-6, atol=1e-7)
        for f in CI_FIELDS:
            np.testing.assert_array_equal(getattr(cfg_t.ci, f),
                                          getattr(cfg_j.ci, f))
        assert cfg_t.ci_t.holes_up.dtype == torch.int64
        assert cfg_t.ci_t.holes_up_k.dtype == torch.int32
        assert cfg_t.ci_t.holes_up_k.shape == (n_det, 2)


# ---------------------------------------------------------------------------
# small determinants (slater.py)
# ---------------------------------------------------------------------------
def test_small_dets_and_rank_k_replacement_match_refactorization():
    rng = np.random.default_rng(4)
    n, k = 7, 3
    D = rng.standard_normal((n, n)) + 2.0 * np.eye(n)
    M = torch.tensor(np.linalg.inv(D), dtype=torch.float32)
    js = torch.tensor([1, 4, 6])
    Phi = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32)
    ratio, M2 = slater.det_ratio_rank_k(M, Phi, js)
    Dn = D.copy()
    for a, j in enumerate([1, 4, 6]):
        Dn[:, j] = Phi.numpy()[a]
    assert float(ratio) == pytest.approx(
        np.linalg.det(Dn) / np.linalg.det(D), rel=1e-4)
    np.testing.assert_allclose(M2.numpy(), np.linalg.inv(Dn), rtol=1e-3,
                               atol=1e-4)
    # one electron: the Sherman–Morrison special case
    Dn1 = D.copy()
    Dn1[:, 2] = Phi.numpy()[0]
    r1, M1 = slater.det_ratio_one_electron(M, Phi[0], 2)
    assert float(r1) == pytest.approx(np.linalg.det(Dn1) / np.linalg.det(D),
                                      rel=1e-4)
    np.testing.assert_allclose(M1.numpy(), np.linalg.inv(Dn1), rtol=1e-3,
                               atol=1e-4)
    for kk in (1, 2, 3, 4):
        T = rng.standard_normal((5, kk, kk)).astype(np.float32)
        d = slater.det_small(torch.from_numpy(T)).numpy()
        np.testing.assert_allclose(d, np.linalg.det(T), rtol=1e-5,
                                   atol=1e-6)
        inv = slater.inv_small(torch.from_numpy(T)).numpy()
        np.testing.assert_allclose(inv, np.linalg.inv(T), rtol=1e-3,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# n_det = 1 is the single-determinant pipeline
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def water_pair():
    """One water wavefunction with 7 MO rows: single-det config and the
    reference-only CI expansion."""
    mol, shells = water()
    cfg, params = build_wavefunction(mol, shells, n_orb=7, method='kernel')
    ci = multidet.from_excitations([1.0], [], mol.n_up, mol.n_dn, 7)
    return cfg, dataclasses.replace(cfg, ci=ci), params


def test_ndet1_evaluation_equals_single_det(water_pair):
    cfg1, cfgm, params = water_pair
    R = _t(positions(params, cfg1.n_elec, 0, 4))
    s1 = t_wf.psi_state_batched(cfg1, params, R)
    sm = t_wf.psi_state_batched(cfgm, params, R)
    for f in s1._fields:
        np.testing.assert_array_equal(getattr(s1, f).numpy(),
                                      getattr(sm, f).numpy(), err_msg=f)
    for a, b in zip(t_wf.log_psi(cfg1, params, R[0]),
                    t_wf.log_psi(cfgm, params, R[0])):
        assert float(a) == float(b)


@pytest.mark.parametrize('method', ['vmc', 'sem-vmc', 'fused-vmc'])
def test_ndet1_block_equals_single_det(water_pair, method):
    from repro_torch.core.driver import make_propagator
    cfg1, cfgm, params = water_pair
    outs = []
    for cfg in (cfg1, cfgm):
        prop = (VMCPropagator(cfg, tau=0.3) if method == 'vmc'
                else make_propagator(method, cfg, tau=0.4))
        drv = EnsembleDriver(prop, steps=3)
        st = drv.init(params, torch.Generator().manual_seed(0), 4)
        st, stats = drv.run_block(params, st, torch.Generator().manual_seed(1))
        ens = st.ens if hasattr(st, 'ens') else st
        outs.append((ens.r.numpy(), stats.e_mean))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


# ---------------------------------------------------------------------------
# evaluation against JAX
# ---------------------------------------------------------------------------
def _check_state(st, sj, tag):
    np.testing.assert_array_equal(st.sign.numpy(), _j(sj.sign))
    np.testing.assert_allclose(st.log_psi.numpy(), _j(sj.log_psi),
                               rtol=2e-6, atol=1e-4, err_msg=tag)
    for f in ('drift', 'e_loc', 'e_kin', 'e_pot'):
        got, want = getattr(st, f).numpy(), _j(getattr(sj, f))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * float(np.max(np.abs(want))),
                                   err_msg=f'{tag} {f}')


def test_psi_state_batched_ci_matches_jax_on_water(water_ci):
    cfg, params, (tcfg, tparams) = water_ci
    R = away_from_nodes(cfg, params, 1, 6, 12)
    _check_state(t_wf.psi_state_batched(tcfg, tparams, _t(R)),
                 j_batched(cfg)(params, jnp.asarray(R)), 'water n_det=6')
    sj, lj = j_wf.log_psi(cfg, params, jnp.asarray(R[0]))
    st, lt = t_wf.log_psi(tcfg, tparams, _t(R[0]))
    assert float(st) == float(sj) and abs(float(lt) - float(lj)) < 1e-4


def test_psi_state_batched_ci_matches_jax_on_smallest():
    """The micro-peptide at n_det = 100 (n_orb = 118): the 3 of 12 seeded
    walkers farthest from a node (smallest max |drift|, by the
    reference), as ``tests/test_torch_wavefunction.py`` picks them."""
    cfg, params = j_build_system('smallest', n_det=100)
    tcfg, tparams = port_of(cfg, params)
    R = away_from_nodes(cfg, params, 2, 3, 12)
    _check_state(t_wf.psi_state_batched(tcfg, tparams, _t(R)),
                 j_batched(cfg)(params, jnp.asarray(R)), 'smallest n_det=100')


def test_ci_corrections_match_jax(water_ci):
    cfg, params, (tcfg, tparams) = water_ci
    R = away_from_nodes(cfg, params, 5, 3, 8)
    C, _ = j_wf._mo_tensor_ensemble(cfg, params, jnp.asarray(R))
    up_j, _ = j_wf._ci_blocks(cfg, C)
    up_t = _t(up_j)
    blk_j = jax.vmap(lambda c: j_md.spin_block_ci(
        c, cfg.ci.holes_up, cfg.ci.parts_up))(up_j)
    blk_t = multidet.spin_block_ci(up_t, tcfg.ci_t.holes_up,
                                   tcfg.ci_t.parts_up)
    np.testing.assert_allclose(blk_t.ratios.numpy(), _j(blk_j.ratios),
                               rtol=1e-4, atol=1e-5)
    w = np.random.default_rng(0).random((3, cfg.ci.n_det)).astype(np.float32)
    cj = jax.vmap(lambda c, m, p, ww: j_md.ci_corrections(
        cfg.ci.holes_up, cfg.ci.parts_up, c, m, p, ww))(
        up_j, blk_j.minv, blk_j.table, jnp.asarray(w))
    ct = multidet.ci_corrections(tcfg.ci_t.holes_up, tcfg.ci_t.parts_up,
                                 up_t, blk_t.minv, blk_t.table, _t(w))
    np.testing.assert_allclose(ct.numpy(), _j(cj), rtol=1e-4,
                               atol=1e-4 * float(np.max(np.abs(_j(cj)))))


@pytest.mark.parametrize('max_exc', [1, 2], ids=['singles', 'doubles'])
def test_multidet_ratios_match_jax(max_exc):
    """The port's plain version (and the CPU dispatch) against JAX's
    oracle; the reference determinant's ratio is exactly 1."""
    rng = np.random.default_rng(0)
    W, n_up, n_dn, n_orb, n_det = 5, 5, 4, 11, 17
    ci = j_synthetic_ci(n_up, n_dn, n_orb, n_det, seed=0, max_exc=max_exc)
    assert ci.k == max_exc
    P = rng.standard_normal((W, n_orb, n_up)).astype(np.float32)
    g = rng.standard_normal((W, n_orb)).astype(np.float32)
    row = rng.standard_normal((W, n_up)).astype(np.float32)
    ro = rng.standard_normal((W, n_det)).astype(np.float32)
    rj, sj = j_ratios_ref(jnp.asarray(P), jnp.asarray(g), jnp.asarray(row),
                          ci.holes_up, ci.parts_up, ci.coeffs,
                          jnp.asarray(ro))
    args = (_t(P), _t(g), _t(row), ci.holes_up, ci.parts_up, ci.coeffs,
            _t(ro))
    for rt, st in (multidet_ratios_ref(*args), multidet_ratios(*args)):
        np.testing.assert_allclose(rt.numpy(), _j(rj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(st.numpy(), _j(sj), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(rt.numpy()[:, 0], np.ones(W))
    # the rank-2 padding the kernels take gives the same ratios
    h2, p2 = normalized_excitations(ci.holes_up, ci.parts_up, n_up, n_orb)
    r2, _ = multidet_ratios_ref(_t(P), _t(g), _t(row), h2, p2, ci.coeffs,
                                _t(ro))
    np.testing.assert_array_equal(r2.numpy(), multidet_ratios_ref(*args)[0])
    with pytest.raises(ValueError, match='rank'):
        normalized_excitations(np.zeros((3, 3), np.int32),
                               np.zeros((3, 3), np.int32), 5, 9)


# ---------------------------------------------------------------------------
# single-electron moves with CI
# ---------------------------------------------------------------------------
def _naive_ratios(C_blk, holes, parts, n_occ):
    """Every excited determinant factorized in float64: its ratio to the
    reference."""
    C = np.asarray(C_blk, np.float64)
    s0, l0 = np.linalg.slogdet(C[:n_occ, :, 0])
    out = []
    for d in range(holes.shape[0]):
        rows = list(range(n_occ))
        for a in range(holes.shape[1]):
            if holes[d, a] < n_occ:
                rows[holes[d, a]] = parts[d, a]
        sI, lI = np.linalg.slogdet(C[rows, :, 0])
        out.append(sI * s0 * np.exp(lI - l0))
    return np.array(out)


def test_sem_sweep_smw_ratios_track_fresh_slogdet(water_ci):
    """A full up-block sweep of Sherman–Morrison + rank-1 table updates:
    the carried ratios and table match a from-scratch recompute of the
    final configuration to 1e-4 of each block's scale."""
    _, _, (tcfg, tparams) = water_ci
    R = _t(positions(tparams, tcfg.n_elec, 7, 6))
    ens = t_sem.evaluate_sem(tcfg, tparams, R)
    draws = t_sem.draw_sweep(torch.Generator().manual_seed(9), R)
    A_up, _ = t_sem._mo_blocks(tcfg, tparams)
    carry = (ens.r.clone(), ens.minv_up.clone(), ens.sign, ens.logdet,
             ens.p_up, ens.rdet_up)
    (r2, _, _, _, P, rdet), acc, _ = t_sem._sweep_spin_block(
        tcfg, tparams, A_up, 0, tcfg.n_up, draws, 0.4, carry,
        ci_args=('up', ens.rdet_dn))
    assert 0 < int(acc.sum()) < acc.numel()
    Cw, _ = t_wf._mo_tensor_ensemble(tcfg, tparams, r2)
    up_all, _ = t_wf._ci_blocks(tcfg, Cw)
    fresh = np.stack([_naive_ratios(up_all[w].numpy(), tcfg.ci.holes_up,
                                    tcfg.ci.parts_up, tcfg.n_up)
                      for w in range(6)])
    scale = max(np.max(np.abs(fresh)), 1.0)
    assert np.max(np.abs(rdet.numpy() - fresh)) / scale <= 1e-4
    Vu = up_all[..., 0].double().numpy()
    P_fresh = np.einsum('wvh,whe->wve', Vu,
                        np.linalg.inv(Vu[:, :tcfg.n_up, :]))
    P_fresh[:, :tcfg.n_up] = np.eye(tcfg.n_up)[None]
    assert np.max(np.abs(P.numpy() - P_fresh)) / max(
        np.max(np.abs(P_fresh)), 1.0) <= 1e-4


def test_evaluate_sem_ci_matches_jax(water_ci):
    cfg, params, (tcfg, tparams) = water_ci
    R = positions(params, cfg.n_elec, 3, 6)
    ej = jax.jit(functools.partial(j_sem.evaluate_sem, cfg))(
        params, jnp.asarray(R))
    et = t_sem.evaluate_sem(tcfg, tparams, _t(R))
    for f in ('rdet_up', 'rdet_dn', 'p_up', 'p_dn', 'minv_up', 'log_psi',
              'e_loc'):
        a, b = getattr(et, f).numpy(), _j(getattr(ej, f))
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * max(np.max(np.abs(b)), 1.0),
                                   err_msg=f)


def _sem_draws(key, W, n_e):
    """The reference's sweep draws (sem.py:303-310 and :494-501)."""
    wkeys = JPopulation().walker_keys(key, W)

    def _one(k, j):
        ke, ku = jax.random.split(jax.random.fold_in(k, j))
        return (jax.random.normal(ke, (3,), jnp.float32),
                jax.random.uniform(ku, (), jnp.float32))
    eta, u = jax.vmap(lambda k: jax.vmap(lambda j: _one(k, j))(
        jnp.arange(n_e)))(wkeys)
    return _j(eta), _j(u)


@pytest.mark.parametrize('method', ['sem-vmc', 'fused-vmc'])
def test_ci_sweeps_same_accepts_under_jax_draws(water_ci, method):
    """sem-vmc (per move; each move through ``sem_move``) and
    fused-vmc with CI: one sweep of each package under the reference's
    draws, accepts move for move; then the rebuilt tables, ratios, log psi
    and E_L agree."""
    cfg, params, (tcfg, tparams) = water_ci
    W, step = 6, 0.4
    R = positions(params, cfg.n_elec, 4, W)
    key = jax.random.PRNGKey(2)
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
    draws = tuple(_t(x) for x in _sem_draws(key, W, cfg.n_elec))
    *_, acc_t, mar_t = prop_t.sweep(tparams, state, None, draws)
    st_t, _ = prop_t.propagate(tparams, state, None, Population(), draws)
    moved = np.any(_j(st_j.ens.r) != R, axis=-1).T
    acc, mar = acc_t.numpy(), np.abs(mar_t.numpy())
    ties = 0
    for w in range(W):
        for j in range(cfg.n_elec):
            if mar[j, w] < MARGIN:
                ties += 1
                break
            assert acc[j, w] == moved[j, w], (w, j)
    assert 0 < acc.sum() < acc.size
    if ties:
        return
    for f in ('rdet_up', 'rdet_dn', 'p_up', 'log_psi', 'e_loc'):
        a, b = getattr(st_t.ens, f).numpy(), _j(getattr(st_j.ens, f))
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * max(np.max(np.abs(b)), 1.0),
                                   err_msg=f)


@pytest.fixture(scope='module')
def peptide_ci3():
    """A 60-electron peptide with a hand-built expansion of excitation
    rank 3 (``from_excitations``): triples, a double and singles over 10
    virtual orbitals — what ``--n-det`` never draws, but a library caller
    can build (the reference's ``det_small`` takes any rank)."""
    from repro.systems.bench import (build_bench_wavefunction,
                                     extend_mos_virtual, make_bench_system)
    sys = make_bench_system('t60', 60, seed=0)
    cfg, params = build_bench_wavefunction(sys, method='sparse',
                                           k_max=sys.basis.n_ao)
    mos = extend_mos_virtual(sys, 10)
    n = cfg.n_up
    exc = [(([0, 4, 9], [n, n + 3, n + 7]), ([], [])),
           (([], []), ([2, 11, 20], [n + 1, n + 2, n + 9])),
           (([5, 6], [n + 4, n + 5]), ([1], [n + 6])),
           (([n - 1], [n]), ([], [])),
           (([], []), ([n - 2], [n + 8]))]
    coeffs = np.array([1.0, 0.21, -0.17, 0.12, 0.3, -0.25], np.float32)
    ci = j_md.from_excitations(coeffs, exc, n, cfg.n_dn, mos.shape[0])
    assert ci.k == 3
    cfg = dataclasses.replace(cfg, ci=ci, method='kernel')
    params = params._replace(mo=jnp.asarray(mos, jnp.float32))
    return cfg, params, port_of(cfg, params)


def test_rank3_fused_sweep_same_accepts_under_jax_draws(peptide_ci3):
    """Part of the fused path at excitation rank 3: one fused-vmc sweep of
    each package under the reference's draws (the port's 'fused-kernel'
    method, whose plain version ``fused_sweep_ref`` runs on the CPU; the
    kernel lists are the rank-3 ones), accepts move for move up to each
    walker's first near tie, then the rebuilt CI state agrees."""
    cfg, params, (tcfg, tparams) = peptide_ci3
    assert tcfg.ci_t.holes_up_k.shape == (6, 3)
    assert tcfg.ci_t.holes_up_k.dtype == torch.int32
    W, step = 4, 0.3
    R = away_from_nodes(cfg, params, 5, W, 12)
    key = jax.random.PRNGKey(4)
    prop_j = j_sem.SEMVMCPropagator(j_sem._fused_cfg(cfg), step_size=step)
    ens_j = jax.jit(functools.partial(j_sem.evaluate_sem, cfg))(
        params, jnp.asarray(R))
    st_j, _ = jax.jit(functools.partial(prop_j.propagate,
                                        pop=JPopulation()))(
        params, j_sem.SEMState(ens=ens_j, sweeps=jnp.int32(0)), key)
    prop_t = t_sem.SEMVMCPropagator(t_sem._fused_cfg(tcfg), step_size=step)
    assert prop_t.cfg.method == 'fused-kernel'
    state = t_sem.SEMState(ens=t_sem.evaluate_sem(tcfg, tparams, _t(R)),
                           sweeps=0)
    draws = tuple(_t(x) for x in _sem_draws(key, W, cfg.n_elec))
    *_, acc_t, mar_t = prop_t.sweep(tparams, state, None, draws)
    st_t, _ = prop_t.propagate(tparams, state, None, Population(), draws)
    moved = np.any(_j(st_j.ens.r) != R, axis=-1).T
    acc, mar = acc_t.numpy(), np.abs(mar_t.numpy())
    ties = 0
    for w in range(W):
        for j in range(cfg.n_elec):
            if mar[j, w] < MARGIN:
                ties += 1
                break
            assert acc[j, w] == moved[j, w], (w, j)
    assert 0 < acc.sum() < acc.size
    if ties:
        return
    for f in ('rdet_up', 'rdet_dn', 'log_psi', 'e_loc'):
        a, b = getattr(st_t.ens, f).numpy(), _j(getattr(st_j.ens, f))
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * max(np.max(np.abs(b)), 1.0),
                                   err_msg=f)


def test_rank3_sem_sweep_same_accepts_under_jax_draws(peptide_ci3):
    """The per-move path at excitation rank 3: one sem-vmc sweep of each
    package under the reference's draws (the reference routes rank > 2 to
    its plain ratios; the port's moves go through ``sem_move``, whose
    plain version runs on the CPU and whose kernel takes rank <= 8 on the
    card), accepts move for move up to each walker's first near tie, then
    the rebuilt CI state agrees."""
    cfg, params, (tcfg, tparams) = peptide_ci3
    assert cfg.ci.k == 3 and tcfg.ci_t.holes_up.shape == (6, 3)
    W, step = 4, 0.3
    R = away_from_nodes(cfg, params, 5, W, 12)
    key = jax.random.PRNGKey(6)
    prop_j = j_sem.SEMVMCPropagator(cfg, step_size=step)
    ens_j = jax.jit(functools.partial(j_sem.evaluate_sem, cfg))(
        params, jnp.asarray(R))
    st_j, _ = jax.jit(functools.partial(prop_j.propagate,
                                        pop=JPopulation()))(
        params, j_sem.SEMState(ens=ens_j, sweeps=jnp.int32(0)), key)
    prop_t = t_sem.SEMVMCPropagator(tcfg, step_size=step)
    state = t_sem.SEMState(ens=t_sem.evaluate_sem(tcfg, tparams, _t(R)),
                           sweeps=0)
    draws = tuple(_t(x) for x in _sem_draws(key, W, cfg.n_elec))
    *_, acc_t, mar_t = prop_t.sweep(tparams, state, None, draws)
    st_t, _ = prop_t.propagate(tparams, state, None, Population(), draws)
    moved = np.any(_j(st_j.ens.r) != R, axis=-1).T
    acc, mar = acc_t.numpy(), np.abs(mar_t.numpy())
    ties = 0
    for w in range(W):
        for j in range(cfg.n_elec):
            if mar[j, w] < MARGIN:
                ties += 1
                break
            assert acc[j, w] == moved[j, w], (w, j)
    assert 0 < acc.sum() < acc.size
    if ties:
        return
    for f in ('rdet_up', 'rdet_dn', 'log_psi', 'e_loc'):
        a, b = getattr(st_t.ens, f).numpy(), _j(getattr(st_j.ens, f))
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * max(np.max(np.abs(b)), 1.0),
                                   err_msg=f)


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------
def test_run_key_carries_the_expansion():
    """The CI coefficients and excitation lists are critical data, as in
    the reference; the key is the reference's plus impl='torch'."""
    with pytest.raises(ValueError, match='n_det'):
        RunSpec(n_det=0)
    run = build_run(RunSpec(system='h2', n_det=4, device='cpu', n_workers=1))
    ci = run.cfg.ci
    assert ci is not None and ci.n_det == 4
    key = j_key(system='h2', method='vmc', tau=0.3,
                mo=run.params.mo.numpy(), coords=run.params.coords.numpy(),
                ci_coeffs=np.asarray(ci.coeffs),
                ci_exc=np.concatenate([ci.holes_up, ci.parts_up,
                                       ci.holes_dn, ci.parts_dn], axis=1),
                impl='torch')
    assert run.run_key == key
    other = build_run(RunSpec(system='h2', n_det=4, device='cpu',
                              n_workers=1, seed=1))
    assert other.run_key != run.run_key


@pytest.mark.parametrize('method', ['sem-vmc', 'fused-vmc'])
def test_qmc_run_cli_n_det_on_cpu(tmp_path, capsys, method):
    avg = qmc_run.main(['--system', 'h2', '--method', method, '--n-det', '4',
                        '--device', 'cpu', '--workers', '1', '--walkers',
                        '8', '--steps', '5', '--blocks', '2', '--db',
                        str(tmp_path / 'md.sqlite')])
    assert avg.n_blocks >= 2 and np.isfinite(avg.energy)
    assert re.search(r'method=' + method, capsys.readouterr().out)
