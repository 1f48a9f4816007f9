"""Distance screening of the PyTorch port against the JAX package.

The cell-list structure (host numpy, built once), the per-electron
candidate lists, the screened AO values, the screened products, the whole
screened evaluation and the screened sweeps, each held against the
reference function on the same numpy inputs (``jax_enable_x64=False``):
water (10 e-), the micro-peptide ``smallest`` (158 e-) and the extended
chain ``synthetic_chain(434)``, whose local MOs switch MO support
screening on.

Tolerances: integers (candidate ids, activity) exact, except for points
within 1e-5 (relative) of an AO cutoff sphere or of a cell face, where the
fp32 comparison may tip either way in either package; AO values rtol 1e-5;
products 1e-5 of their max; the evaluation at the tolerances of
``tests/test_torch_wavefunction.py``; accept decisions identical except
moves within 1e-5 of the threshold (``tests/test_torch_propagators.py``).
"""
import dataclasses
import functools

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
from repro.core.mos import mo_products_screened as j_mps  # noqa: E402
from repro.runtime.database import critical_data_key as j_key  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402
from repro.systems.bench import (  # noqa: E402
    build_bench_wavefunction as j_bench_wf, synthetic_chain as j_chain)

from repro_torch.core import aos, screening, sem as t_sem  # noqa: E402
from repro_torch.core import wavefunction as t_wf  # noqa: E402
from repro_torch.core.driver import Population  # noqa: E402
from repro_torch.core.mos import mo_products_screened  # noqa: E402
from repro_torch.launch.spec import RunSpec, build_run  # noqa: E402
from repro_torch.systems import build_system as t_build_system  # noqa: E402
from repro_torch.systems.bench import (  # noqa: E402
    build_bench_wavefunction as t_bench_wf, synthetic_chain as t_chain)
from repro_torch.systems.convert import from_numpy  # noqa: E402

MARGIN = 1e-5
EDGE = 1e-5
W = 4


def port_of(cfg, params, method=None, mo_screen='auto'):
    """The port's (cfg, params) for a JAX (cfg, params), via numpy only.

    The port builds its own screening structure, at the reference's eps
    and from the reference's build geometry (float64 nuclei; ``params``
    carries them rounded to float32)."""
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
        coords = np.asarray(params.coords) if scr.exhaustive else scr.coords
        tcfg = dataclasses.replace(tcfg, screening=screening.build_screening(
            tcfg.basis, coords, np.asarray(params.mo), eps=scr.eps,
            mo_screen=mo_screen))
    return tcfg, tparams


_SYSTEMS = {}


def jax_system(name, eps):
    """The reference's screened (cfg, params), built once per test run;
    'chain158' with MO support screening forced on (as the reference's
    ``test_eps0_mo_screened_tensor_bitwise`` forces it)."""
    key = (name, eps)
    if key not in _SYSTEMS:
        if name == 'chain434':
            _SYSTEMS[key] = j_bench_wf(j_chain(434), method='sparse',
                                       screen_eps=eps)
        elif name == 'chain158':
            s = j_chain(158)
            cfg, params = j_bench_wf(s, method='sparse')
            scr = j_scr.build_screening(s.basis, s.mol.coords,
                                        np.asarray(params.mo), eps=eps,
                                        mo_screen=True)
            _SYSTEMS[key] = (dataclasses.replace(cfg, screening=scr), params)
        else:
            _SYSTEMS[key] = j_build_system(name, screen_eps=eps)
    return _SYSTEMS[key]


def positions(params, n_e, seed, n_walkers=W, spread=1.2):
    """Walkers around charge-weighted random nuclei (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    coords, charges = np.asarray(params.coords), np.asarray(params.charges)
    at = rng.choice(coords.shape[0], (n_walkers, n_e),
                    p=charges / charges.sum())
    return (coords[at] + spread * rng.normal(size=(n_walkers, n_e, 3))
            ).astype(np.float32)


def near_edges(scr, pts):
    """(N,) bool: a point within EDGE (relative) of a cell face of either
    cell list, or of the cutoff sphere of one of its candidate AOs or MOs
    (float64 on the host)."""
    p = np.asarray(pts, np.float64)
    near = np.zeros(p.shape[0], bool)
    for cl, center, reach2 in (
            (scr.ao_cells, None, None),
            (scr.mo_cells, scr.mo_center, scr.mo_reach2)):
        if cl is None:
            continue
        x = (p - cl.origin) / cl.h
        near |= np.any(np.abs(x - np.round(x)) < EDGE, axis=1)
        dims = np.asarray(cl.dims)
        c = np.clip(np.floor(x).astype(np.int64), 0, dims - 1)
        cid = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
        ids = cl.members[cid]
        if center is None:
            at = np.asarray(scr.coords)[scr.ao_atom[ids]]
            r2c = scr.ao_radius2[ids]
        else:
            at, r2c = center[ids], reach2[ids]
        r2 = np.sum((p[:, None] - at) ** 2, axis=-1)
        near |= np.any(cl.valid[cid] & (np.abs(r2 - r2c)
                                        <= EDGE * np.abs(r2c)), axis=1)
    return near


# ---------------------------------------------------------------------------
# host structures
# ---------------------------------------------------------------------------
def port_system(name, eps):
    """The port's own screened system (its builders, its generator)."""
    if name == 'chain434':
        return t_bench_wf(t_chain(434), method='sparse', screen_eps=eps,
                          device='cpu')
    return t_build_system(name, screen_eps=eps, device='cpu')


@pytest.mark.parametrize('name,eps', [('water', 0.0), ('water', 1e-8),
                                      ('smallest', 1e-8), ('chain434', 0.0),
                                      ('water', -1.0)])
def test_host_structures_equal_reference(name, eps):
    """The port's builders give the reference's structure, array for
    array; its device copy is pinned once, int32/float32."""
    cfg, _ = jax_system(name, eps)
    tcfg, _ = port_system(name, eps)
    a, b = tcfg.screening, cfg.screening
    assert (a.eps, a.exhaustive, a.n_rows) == (b.eps, b.exhaustive, b.n_rows)
    assert (a.ao_budget, a.mo_budget) == (b.ao_budget, b.mo_budget)
    if b.exhaustive:
        assert a.ao_cells is None and tcfg.screening_t is None
        return
    for f in ('ao_radius2', 'ao_atom', 'coords', 'mo_center', 'mo_reach2'):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if y is not None:
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)
    for f in ('ao_cells', 'mo_cells'):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if y is None:
            continue
        assert (x.h, x.dims, x.budget) == (y.h, y.dims, y.budget)
        for g in ('origin', 'members', 'valid'):
            np.testing.assert_array_equal(getattr(x, g), getattr(y, g))
    st = tcfg.screening_t
    assert st is a.tensors('cpu')
    assert st.ao_cells.members.dtype == torch.int32
    assert st.ao_radius2.dtype == torch.float32
    assert (st.mo_cells is None) == (b.mo_cells is None)
    if name == 'chain434':
        assert b.mo_budget > 0            # MO screening on for the chain


def test_structure_built_once_per_build_system_never_per_sweep():
    before = screening.build_count()
    cfg, params = t_build_system('water', screen_eps=0.0, device='cpu')
    assert screening.build_count() == before + 1
    R = torch.from_numpy(positions(params, cfg.n_elec, 5, 2))
    t_wf.psi_state_batched(cfg, params, R)
    for method in ('sem-vmc', 'fused-vmc'):
        c = t_sem._fused_cfg(cfg) if method == 'fused-vmc' else cfg
        prop = t_sem.SEMVMCPropagator(c)
        gen = torch.Generator().manual_seed(0)
        st = prop.init(params, gen, 2)
        prop.propagate(params, st, gen, Population())
    assert screening.build_count() == before + 1


# ---------------------------------------------------------------------------
# candidate lists and screened AO values
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('name,eps', [('water', 1e-8), ('smallest', 1e-8),
                                      ('chain434', 0.0)])
def test_candidate_lists_match_jax(name, eps):
    cfg, params = jax_system(name, eps)
    tcfg, _ = port_of(cfg, params)
    pts = positions(params, cfg.n_elec, 11, 2).reshape(-1, 3)
    keep = ~near_edges(cfg.screening, pts)
    assert keep.sum() >= 0.9 * keep.size
    ij, aj, cj = j_scr.active_ao_lists(cfg.screening, jnp.asarray(pts))
    it, at, ct = screening.active_ao_lists(tcfg.screening_t,
                                           torch.from_numpy(pts))
    assert it.dtype == torch.int32 and ct.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy()[keep], np.asarray(ij)[keep])
    np.testing.assert_array_equal(at.numpy()[keep], np.asarray(aj)[keep])
    np.testing.assert_array_equal(ct.numpy()[keep], np.asarray(cj)[keep])
    assert int(ct.max()) <= tcfg.screening.ao_budget
    if cfg.screening.mo_cells is not None:
        mj, vj = j_scr.active_mo_lists(cfg.screening, jnp.asarray(pts))
        mt, vt = screening.active_mo_lists(tcfg.screening_t,
                                           torch.from_numpy(pts))
        np.testing.assert_array_equal(mt.numpy()[keep], np.asarray(mj)[keep])
        np.testing.assert_array_equal(vt.numpy()[keep], np.asarray(vj)[keep])
        assert vt.numpy()[keep].any()


@pytest.mark.parametrize('name', ['water', 'smallest'])
def test_screened_ao_values_match_jax_and_the_dense_block(name):
    cfg, params = jax_system(name, 1e-8)
    tcfg, tparams = port_of(cfg, params)
    pts = positions(params, cfg.n_elec, 12, 1)[0]
    r_j, r_t = jnp.asarray(pts), torch.from_numpy(pts)
    ij, aj, _ = jax.jit(functools.partial(j_scr.active_ao_lists,
                                          cfg.screening))(r_j)
    # both packages evaluate on the reference's lists
    it, at = torch.from_numpy(np.array(ij)), torch.from_numpy(np.array(aj))
    Bj = np.asarray(jax.jit(functools.partial(
        j_aos.eval_ao_block_screened, cfg.basis))(params.coords, r_j, ij, aj))
    Bt = aos.eval_ao_block_screened(tcfg.basis_t, tparams.coords, r_t, it,
                                    at)
    np.testing.assert_allclose(Bt.numpy(), Bj, rtol=1e-5, atol=1e-6)
    vj = np.asarray(jax.jit(functools.partial(
        j_aos.eval_ao_values_screened, cfg.basis))(params.coords, r_j, ij,
                                                    aj))
    vt = aos.eval_ao_values_screened(tcfg.basis_t, tparams.coords, r_t, it,
                                     at)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-5, atol=1e-6)
    # every active slot is the port's own dense entry, bitwise; the rest 0
    act = at.numpy()
    B, _ = aos.eval_ao_block(tcfg.basis_t, tparams.coords, r_t)
    Bg = B.transpose(0, 1)[torch.arange(pts.shape[0])[:, None], it.long()]
    np.testing.assert_array_equal(Bt.numpy()[act], Bg.numpy()[act])
    assert np.all(Bt.numpy()[~act] == 0.0)
    V, _ = aos.eval_ao_values(tcfg.basis_t, tparams.coords, r_t)
    Vg = V.T[torch.arange(pts.shape[0])[:, None], it.long()]
    np.testing.assert_array_equal(vt.numpy()[act], Vg.numpy()[act])
    assert np.all(vt.numpy()[~act] == 0.0)


# ---------------------------------------------------------------------------
# screened products
# ---------------------------------------------------------------------------
def test_screened_products_match_jax():
    """mo_products_screened, gather_phi (an occupied panel of half the
    rows: active MOs beyond it dropped) and phi_from_packed on the chain's
    MO-screened structure, on the reference's lists and values."""
    cfg, params = jax_system('chain434', 0.0)
    tcfg, tparams = port_of(cfg, params)
    scr = cfg.screening
    pts = positions(params, cfg.n_elec, 13, 1)[0][:64]
    r_j = jnp.asarray(pts)

    @jax.jit
    def _lists(r):
        ij, aj, _ = j_scr.active_ao_lists(scr, r)
        return (ij, aj, *j_scr.active_mo_lists(scr, r),
                j_aos.eval_ao_block_screened(cfg.basis, params.coords, r, ij,
                                             aj))
    ij, aj, mj, vj, Bp = _lists(r_j)
    vals = Bp[..., 0]

    def t(x):
        return torch.from_numpy(np.array(x))
    A = np.asarray(params.mo)
    Cj = np.asarray(j_mps(params.mo, Bp, ij, mj, vj, chunk=32))
    Ct = mo_products_screened(t(A), t(Bp), t(ij), t(mj), t(vj), chunk=32)
    scale = float(np.abs(Cj).max())
    np.testing.assert_allclose(Ct.numpy(), Cj, rtol=0, atol=1e-5 * scale)
    # the dense product of the same packed values (no MO screening)
    dense = np.zeros((pts.shape[0], A.shape[1], 5), np.float64)
    np.add.at(dense, (np.arange(pts.shape[0])[:, None], np.asarray(ij)),
              np.asarray(Bp, np.float64))
    np.testing.assert_allclose(Ct.numpy(),
                               np.einsum('oa,eac->oec', A, dense),
                               rtol=0, atol=1e-5 * scale)
    for rows in (A.shape[0], A.shape[0] // 2):
        Ablk = A[:rows]
        pj = np.asarray(j_scr.gather_phi(jnp.asarray(Ablk), ij, vals, mj, vj,
                                         chunk=8))
        pt = screening.gather_phi(t(Ablk), t(ij), t(vals), t(mj), t(vj),
                                  chunk=8)
        pf = np.asarray(j_scr.phi_from_packed(jnp.asarray(Ablk), ij, vals,
                                              A.shape[1]))
        pft = screening.phi_from_packed(t(Ablk), t(ij), t(vals), A.shape[1])
        s = float(np.abs(pf).max())
        for got, want in ((pt, pj), (pft, pf), (pt, pf)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * s)


# ---------------------------------------------------------------------------
# the whole evaluation
# ---------------------------------------------------------------------------
def _away_from_nodes(cfg, params, seed, n_draw=12):
    R = positions(params, cfg.n_elec, seed, n_draw)
    jc = dataclasses.replace(cfg, method='dense', screening=None)
    d = np.asarray(jax.jit(functools.partial(j_wf.psi_state_batched, jc))(
        params, jnp.asarray(R)).drift)
    return R[np.argsort(np.abs(d).max(axis=(1, 2)))[:W]]


@pytest.mark.parametrize('name,eps,method', [
    ('water', 0.0, 'kernel'), ('water', 1e-6, 'kernel'),
    ('smallest', 0.0, 'sparse'), ('smallest', 1e-6, 'kernel')])
def test_psi_state_batched_screened_matches_jax(name, eps, method):
    """Field by field against the reference's screened evaluation.  On
    water the reference runs its Pallas ``screened_mo`` kernel (interpret
    mode) for 'kernel'; on the peptide the reference's packed sparse
    product stands for it (the same function), against the port's
    'kernel' route (``screened_mo_ref`` on the CPU)."""
    cfg, params = jax_system(name, eps)
    j_method = method if name == 'water' else 'sparse'
    cfg_j = dataclasses.replace(cfg, method=j_method)
    tcfg, tparams = port_of(cfg, params, method=method)
    R = _away_from_nodes(cfg, params, seed=2)
    sj = jax.jit(functools.partial(j_wf.psi_state_batched, cfg_j))(
        params, jnp.asarray(R))
    st = t_wf.psi_state_batched(tcfg, tparams, torch.from_numpy(R))
    keep = ~near_edges(cfg.screening, R.reshape(-1, 3)).reshape(W, -1).any(1)
    assert keep.sum() >= W - 1
    np.testing.assert_array_equal(st.sign.numpy(), np.asarray(sj.sign))
    np.testing.assert_array_equal(st.ao_count.numpy()[keep],
                                  np.asarray(sj.ao_count)[keep])
    np.testing.assert_allclose(st.log_psi.numpy(), np.asarray(sj.log_psi),
                               rtol=2e-6, atol=1e-4)
    for f in ('drift', 'e_loc', 'e_kin', 'e_pot'):
        got, want = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * float(np.max(np.abs(want))),
                                   err_msg=f'{name} {eps} {method} {f}')


@pytest.mark.parametrize('name,method', [('chain158', 'sparse'),
                                         ('chain434', 'sparse'),
                                         ('smallest', 'kernel')])
def test_screened_mo_tensor_ensemble_matches_jax(name, method):
    """The screened part of the evaluation, the ensemble MO tensor and the
    active counts, against the reference's: the doubly screened product on
    the chains (MO screening forced on at 158 electrons, on by itself at
    434), the port's 'kernel' route on the peptide against the
    reference's packed sparse product.  (The Slater tail of the chains is
    not compared: their cold-start determinants have condition numbers of
    1e7 to 1e16, and the reference's own screened and unscreened
    evaluations part there in log psi and sign.)"""
    cfg, params = jax_system(name, 0.0 if name != 'smallest' else 1e-6)
    tcfg, tparams = port_of(cfg, params, method=method,
                            mo_screen=True if name == 'chain158' else 'auto')
    assert (tcfg.screening.mo_cells is None) == (name == 'smallest')
    R = positions(params, cfg.n_elec, 4, 2)
    keep = ~near_edges(cfg.screening, R.reshape(-1, 3)).reshape(2, -1)
    Cj, cj = jax.jit(functools.partial(j_wf._mo_tensor_ensemble, cfg))(
        params, jnp.asarray(R))
    Ct, ct = t_wf._mo_tensor_ensemble(tcfg, tparams, torch.from_numpy(R))
    Cj, cj = np.asarray(Cj), np.asarray(cj)
    assert Ct.shape == Cj.shape
    np.testing.assert_array_equal(ct.numpy()[keep], cj[keep])
    per_e = np.abs(Cj).max(axis=(1, 3))                 # (W, n_e)
    err = np.abs(Ct.numpy() - Cj).max(axis=(1, 3))
    assert np.all(err[keep] <= 1e-5 * np.maximum(per_e[keep], 1e-30))


@pytest.mark.parametrize('method', ['sparse', 'kernel'])
def test_exhaustive_screening_is_bitwise_screening_off(method):
    cfg, params = t_build_system('smallest', device='cpu')
    cfg = dataclasses.replace(cfg, method=method)
    cfg_x = dataclasses.replace(
        cfg, screening=screening.build_screening(cfg.basis,
                                                 params.coords.numpy(),
                                                 params.mo.numpy(), eps=-1.0))
    assert cfg_x.screening.exhaustive and not t_wf._screening_active(cfg_x)
    R = torch.from_numpy(positions(params, cfg.n_elec, 6, 2))
    a = t_wf.psi_state_batched(cfg, params, R)
    b = t_wf.psi_state_batched(cfg_x, params, R)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_eps0_screened_evaluation_matches_unscreened():
    """eps = 0 drops only the dense path's exact zeros: the screened
    evaluation ('kernel' route) equals the unscreened one up to summation
    order, and the active counts are the unscreened ones."""
    cfg, params = t_build_system('smallest', device='cpu')
    cfg_s, _ = t_build_system('smallest', screen_eps=0.0, device='cpu')
    R = torch.from_numpy(positions(params, cfg.n_elec, 8, 2))
    Cd, cd = t_wf._mo_tensor_ensemble(cfg, params, R)
    Cs, cs = t_wf._mo_tensor_ensemble(cfg_s, params, R)
    assert torch.equal(cd, cs)
    scale = float(Cd.abs().max())
    assert float((Cd - Cs).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# sweeps under the reference's draws
# ---------------------------------------------------------------------------
def _sem_draws(key, W, n_e):
    """The reference's sweep draws (sem.py:303-310 and :494-501)."""
    wkeys = JPopulation().walker_keys(key, W)

    def _one(k, j):
        ke, ku = jax.random.split(jax.random.fold_in(k, j))
        return (jax.random.normal(ke, (3,), jnp.float32),
                jax.random.uniform(ku, (), jnp.float32))
    eta, u = jax.vmap(lambda k: jax.vmap(lambda j: _one(k, j))(
        jnp.arange(n_e)))(wkeys)
    return np.asarray(eta), np.asarray(u)


@pytest.mark.parametrize('method,eps', [('sem-vmc', 1e-6),
                                        ('fused-vmc', 1e-6)])
def test_screened_sweeps_same_accepts_under_jax_draws(method, eps):
    """One screened sweep of each package on water under the reference's
    draws ('kernel' on both sides: the Pallas kernels in interpret mode,
    the port's plain versions): accepts move for move, walker by walker up
    to its first near tie; then the energy pass agrees."""
    cfg, params = jax_system('water', eps)
    cfg = dataclasses.replace(cfg, method='kernel')
    tcfg, tparams = port_of(cfg, params)
    n_w, step = 8, 0.4
    R = positions(params, cfg.n_elec, 0, n_w, spread=1.0)
    key = jax.random.PRNGKey(9)
    jcfg = j_sem._fused_cfg(cfg) if method == 'fused-vmc' else cfg
    prop_j = j_sem.SEMVMCPropagator(jcfg, step_size=step)
    ens_j = jax.jit(functools.partial(j_sem.evaluate_sem, cfg))(
        params, jnp.asarray(R))
    st_j, _ = jax.jit(functools.partial(prop_j.propagate,
                                        pop=JPopulation()))(
        params, j_sem.SEMState(ens=ens_j, sweeps=jnp.int32(0)), key)
    tc = t_sem._fused_cfg(tcfg) if method == 'fused-vmc' else tcfg
    prop_t = t_sem.SEMVMCPropagator(tc, step_size=step)
    state = t_sem.SEMState(ens=t_sem.evaluate_sem(tcfg, tparams,
                                                  torch.from_numpy(R)),
                           sweeps=0)
    draws = tuple(torch.from_numpy(x) for x in _sem_draws(key, n_w,
                                                          cfg.n_elec))
    *_, acc_t, mar_t = prop_t.sweep(tparams, state, None, draws)
    st_t, _ = prop_t.propagate(tparams, state, None, Population(), draws)
    moved = np.any(np.asarray(st_j.ens.r) != R, axis=-1).T
    acc, mar = acc_t.numpy(), np.abs(mar_t.numpy())
    ties = 0
    for w in range(n_w):
        for j in range(cfg.n_elec):
            if mar[j, w] < MARGIN:
                ties += 1
                break
            assert acc[j, w] == moved[j, w], (w, j)
    assert 0 < acc.sum() < acc.size
    if ties:
        return
    for f in ('log_psi', 'e_loc'):
        a, b = getattr(st_t.ens, f).numpy(), np.asarray(getattr(st_j.ens, f))
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * max(np.max(np.abs(b)), 1.0),
                                   err_msg=f)


def test_screened_per_move_phi_uses_the_mo_lists_on_the_chain():
    """On the MO-screened chain the per-move and fused proposal values
    (``gather_phi``) equal the unscreened panel product up to fp32."""
    cfg, params = jax_system('chain434', 0.0)
    tcfg, tparams = port_of(cfg, params)
    assert tcfg.screening_t.mo_cells is not None
    cfg0 = dataclasses.replace(tcfg, screening=None)
    r = torch.from_numpy(positions(params, cfg.n_elec, 3, 2))
    A_up, A_dn = t_sem._mo_blocks(tcfg, tparams)
    got = t_sem._fused_phi_all(tcfg, tparams, A_up, A_dn, r)
    want = t_sem._fused_phi_all(cfg0, tparams, A_up, A_dn, r)
    one = t_sem._proposal_phi(tcfg, tparams.coords, A_up, r[:, 0])
    for g, w in zip(got + (one,), want + (want[0][:, 0],)):
        s = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * s


# ---------------------------------------------------------------------------
# front door
# ---------------------------------------------------------------------------
def test_run_key_screening_semantics():
    """Off and eps = 0 keep the unscreened key (the reference's rule);
    eps > 0 adds screen_eps; either way the reference's key plus
    impl='torch'."""
    base = RunSpec(system='water', device='cpu', n_workers=1, n_walkers=4,
                   max_blocks=1)
    run = build_run(base)
    k_off = run.run_key
    mo, coords = run.params.mo.numpy(), run.params.coords.numpy()
    ref = dict(system='water', method='vmc', tau=0.3, mo=mo, coords=coords)
    assert k_off == j_key(**ref, impl='torch')
    assert build_run(dataclasses.replace(base, screen_eps=0.0)).run_key \
        == k_off
    run_s = build_run(dataclasses.replace(base, screen_eps=1e-6))
    assert run_s.run_key != k_off
    assert run_s.run_key == j_key(**ref, screen_eps=1e-6, impl='torch')
    assert run_s.cfg.screening is not None and run_s.cfg.screening.eps == 1e-6
