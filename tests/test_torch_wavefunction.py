"""Evaluation pipeline of the PyTorch port against the JAX package.

AO block, values-only AOs, active-AO lists and packing, then the whole
ensemble evaluation ``psi_state_batched`` field by field for the dense,
sparse and kernel MO methods — on water (10 e-) and a two-residue peptide
(60 e-); one walker's ``psi_state``, ``make_batched`` and
the autodiff local-energy oracle.  The wavefunction is built once by the JAX package and carried
over as numpy data (``repro_torch.systems.convert``); walker positions are
made with numpy from a seed.
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
from repro.core import wavefunction as j_wf  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402
from repro.systems.bench import (build_bench_wavefunction,  # noqa: E402
                                 make_bench_system)

from repro_torch.core import aos, wavefunction as t_wf  # noqa: E402
from repro_torch.systems import build_system as t_build_system  # noqa: E402
from repro_torch.systems.convert import from_numpy  # noqa: E402

W = 4


def port_of(cfg, params, method=None):
    """The port's (cfg, params) for a JAX (cfg, params), via numpy only."""
    basis = {f.name: np.asarray(getattr(cfg.basis, f.name))
             for f in dataclasses.fields(cfg.basis)}
    jas = {k: np.asarray(getattr(params.jastrow, k))
           for k in ('b_ee', 'b_en', 'a_en')}
    return from_numpy(basis, np.asarray(params.coords),
                      np.asarray(params.charges), np.asarray(params.mo),
                      jas, n_up=cfg.n_up, n_dn=cfg.n_dn, k_max=cfg.k_max,
                      method=method or cfg.method, ns_steps=cfg.ns_steps,
                      sem_refresh=cfg.sem_refresh, device='cpu')


@pytest.fixture(scope='module', params=['water', 't60'])
def system(request):
    if request.param == 'water':
        cfg, params = j_build_system('water')
        cfg = dataclasses.replace(cfg, k_max=16)
    else:
        sys = make_bench_system('t60', 60, seed=0)
        cfg, params = build_bench_wavefunction(sys, method='sparse',
                                               k_max=sys.basis.n_ao)
    return request.param, cfg, params, away_from_nodes(cfg, params, seed=2)


def positions(params, n_e, seed=0, n_walkers=W, spread=1.2):
    """Walker positions around charge-weighted random nuclei (numpy,
    seeded; the cold-start distribution of ``vmc.sample_positions``)."""
    rng = np.random.default_rng(seed)
    coords, charges = np.asarray(params.coords), np.asarray(params.charges)
    at = rng.choice(coords.shape[0], (n_walkers, n_e),
                    p=charges / charges.sum())
    return (coords[at] + spread * rng.normal(size=(n_walkers, n_e, 3))
            ).astype(np.float32)


def away_from_nodes(cfg, params, seed, n_walkers=W, n_draw=16):
    """The ``n_walkers`` of ``n_draw`` candidate walkers farthest from a
    node of Psi (smallest max |drift|, by the reference).

    Near a node the fp32 Slater inverse loses digits in proportion to the
    condition number, on both sides alike; the 1e-4 contract of DESIGN.md
    §3 is about walkers away from it, which is where sampling keeps them.
    """
    R = positions(params, cfg.n_elec, seed=seed, n_walkers=n_draw)
    d = np.asarray(j_batched(dataclasses.replace(cfg, method='dense'))(
        params, jnp.asarray(R)).drift)
    return R[np.argsort(np.abs(d).max(axis=(1, 2)))[:n_walkers]]


def j_batched(cfg):
    """The reference's ensemble evaluation, compiled once per config."""
    return jax.jit(functools.partial(j_wf.psi_state_batched, cfg))


def test_convert_carries_the_wavefunction(system):
    _, cfg, params, _ = system
    tcfg, tparams = port_of(cfg, params)
    for f in dataclasses.fields(cfg.basis):
        np.testing.assert_array_equal(getattr(tcfg.basis, f.name),
                                      np.asarray(getattr(cfg.basis, f.name)))
    np.testing.assert_array_equal(tparams.mo.numpy(), np.asarray(params.mo))
    assert (tcfg.n_up, tcfg.n_dn, tcfg.k_max, tcfg.ns_steps) == \
        (cfg.n_up, cfg.n_dn, cfg.k_max, cfg.ns_steps)
    assert tcfg.basis_t.prim_exp.dtype == torch.float32
    assert tcfg.basis_t.ao_atom.dtype == torch.int64


def test_ao_block_values_and_lists_match_jax(system):
    _, cfg, params, _ = system
    tcfg, tparams = port_of(cfg, params)
    R = positions(params, cfg.n_elec)
    flat = R.reshape(-1, 3)
    # flat (n_ao, N, 5) and walker-shaped (W, n_ao, n_e, 5) layouts
    for r in (flat, R):
        Bj, aj = j_aos.eval_ao_block(cfg.basis, params.coords, jnp.asarray(r))
        Bt, at = aos.eval_ao_block(tcfg.basis, tparams.coords,
                                   torch.from_numpy(r))
        assert Bt.shape == Bj.shape
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=1e-5,
                                   atol=1e-6)
    vj, _ = j_aos.eval_ao_values(cfg.basis, params.coords, jnp.asarray(flat))
    vt, _ = aos.eval_ao_values(tcfg.basis_t, tparams.coords,
                               torch.from_numpy(flat))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-6)
    # active lists (scatter compaction) and packing: integers exact
    Bj, aj = j_aos.eval_ao_block(cfg.basis, params.coords, jnp.asarray(flat))
    Bt, at = aos.eval_ao_block(tcfg.basis_t, tparams.coords,
                               torch.from_numpy(flat))
    k_max = min(cfg.k_max, cfg.basis.n_ao)
    ij, valj, cj = j_aos.active_ao_indices(cfg.basis, aj, k_max)
    it, valt, ct = aos.active_ao_indices(tcfg.basis, at, k_max)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(valt.numpy(), np.asarray(valj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(aos.pack_b(Bt, it, valt).numpy(),
                               np.asarray(j_aos.pack_b(Bj, ij, valj)),
                               rtol=1e-5, atol=1e-6)


def test_active_lists_truncate_like_jax():
    """k_max below the active count: same truncated lists and true counts."""
    cfg, params = j_build_system('water')
    tcfg, _ = port_of(cfg, params)
    rng = np.random.default_rng(1)
    atom_active = rng.random((9, 3)) < 0.7
    ij, vj, cj = j_aos.active_ao_indices(cfg.basis, jnp.asarray(atom_active),
                                         3)
    it, vt, ct = aos.active_ao_indices(tcfg.basis,
                                       torch.from_numpy(atom_active), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize('method', ['dense', 'sparse', 'kernel'])
def test_psi_state_batched_matches_jax(system, method):
    name, cfg, params, R = system
    cfg = dataclasses.replace(cfg, method=method)
    tcfg, tparams = port_of(cfg, params)
    sj = j_batched(cfg)(params, jnp.asarray(R))
    st = t_wf.psi_state_batched(tcfg, tparams, torch.from_numpy(R))
    np.testing.assert_array_equal(st.sign.numpy(), np.asarray(sj.sign))
    np.testing.assert_array_equal(st.ao_count.numpy(), np.asarray(sj.ao_count))
    # fp32 inverse + one Newton–Schulz step on both sides (DESIGN.md §3):
    # 1e-4 absolute, plus ~16 fp32 ulps of |log_psi| (1.2e-4 is one ulp at
    # the peptide's |log_psi| ~ 1e3, summed over n_e^2 Jastrow pairs in
    # another order)
    np.testing.assert_allclose(st.log_psi.numpy(), np.asarray(sj.log_psi),
                               rtol=2e-6, atol=1e-4)
    for f in ('drift', 'e_loc', 'e_kin', 'e_pot'):
        got, want = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * float(np.max(np.abs(want))),
                                   err_msg=f'{name} {method} {f}')


def test_single_walker_log_psi_matches_jax():
    cfg, params = j_build_system('water')
    tcfg, tparams = port_of(cfg, params)
    r = positions(params, cfg.n_elec, seed=3, n_walkers=1)
    sgn_j, lp_j = jax.jit(functools.partial(j_wf.log_psi, cfg))(
        params, jnp.asarray(r[0]))
    sgn_t, lp_t = t_wf.log_psi(tcfg, tparams, torch.from_numpy(r[0]))
    assert float(sgn_t) == float(sgn_j)
    assert abs(float(lp_t) - float(lp_j)) < 1e-4
    st = t_wf.psi_state_batched(tcfg, tparams, torch.from_numpy(r))
    assert abs(float(lp_t) - float(st.log_psi[0])) < 1e-4


def test_port_catalog_builds_the_reference_systems():
    """The port's own builders give the reference's wavefunctions: water
    (dense product) and the micro-peptide (kernel product), also with
    distance screening (the structure itself is held to the reference's in
    ``tests/test_torch_screening.py``)."""
    cfg_j, params_j = j_build_system('water')
    cfg_t, params_t = t_build_system('water', device='cpu')
    assert cfg_t.method == 'dense'
    np.testing.assert_allclose(params_t.mo.numpy(), np.asarray(params_j.mo),
                               rtol=1e-6, atol=1e-7)
    cfg_t, params_t = t_build_system('smallest', device='cpu')
    cfg_j, params_j = j_build_system('smallest')
    assert (cfg_t.method, cfg_t.n_up, cfg_t.n_dn) == ('kernel', 79, 79)
    assert cfg_t.basis.n_ao == cfg_j.basis.n_ao == 346
    np.testing.assert_array_equal(params_t.mo.numpy(), np.asarray(params_j.mo))
    np.testing.assert_array_equal(params_t.coords.numpy(),
                                  np.asarray(params_j.coords))
    for name, eps in (('water', 0.0), ('smallest', 1e-8)):
        cfg_t, _ = t_build_system(name, screen_eps=eps, device='cpu')
        cfg_j, _ = j_build_system(name, screen_eps=eps)
        assert cfg_t.screening.eps == eps and not cfg_t.screening.exhaustive
        assert cfg_t.screening.ao_budget == cfg_j.screening.ao_budget
        assert t_wf._screening_active(cfg_t)
    cfg_t, _ = t_build_system('water', screen_eps=-1.0, device='cpu')
    assert cfg_t.screening.exhaustive and not t_wf._screening_active(cfg_t)


@pytest.mark.parametrize('method', ['dense', 'kernel'])
def test_psi_state_and_make_batched_match_jax(system, method):
    """One walker's ``psi_state`` and ``make_batched`` against the
    reference's: the first walker alone against its ``psi_state``, then
    ``make_batched`` and every walker's ``psi_state`` stacked against its
    ensemble pass."""
    name, cfg, params, R = system
    cfg = dataclasses.replace(cfg, method=method)
    tcfg, tparams = port_of(cfg, params)
    sj = j_batched(cfg)(params, jnp.asarray(R))
    one = t_wf.psi_state(tcfg, tparams, torch.from_numpy(R[0]))
    wj = jax.jit(functools.partial(j_wf.psi_state, cfg))(params,
                                                          jnp.asarray(R[0]))
    for f in ('log_psi', 'drift', 'e_loc'):
        want = np.asarray(getattr(wj, f))
        np.testing.assert_allclose(getattr(one, f).numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.max(np.abs(want))),
                                   err_msg=f'{name} {method} {f}')
    per_walker = [t_wf.psi_state(tcfg, tparams, torch.from_numpy(r))
                  for r in R]
    forms = {'make_batched': t_wf.make_batched(tcfg)(tparams,
                                                     torch.from_numpy(R)),
             'psi_state': t_wf.PsiState(*[torch.stack(f)
                                          for f in zip(*per_walker)])}
    for form, st in forms.items():
        np.testing.assert_array_equal(st.sign.numpy(), np.asarray(sj.sign))
        for f in ('log_psi', 'drift', 'e_loc'):
            want = np.asarray(getattr(sj, f))
            np.testing.assert_allclose(
                getattr(st, f).numpy(), want, rtol=1e-4,
                atol=1e-4 * float(np.max(np.abs(want))),
                err_msg=f'{name} {method} {form} {f}')


@pytest.mark.parametrize('name,n_det', [('h2', 1), ('water', 1),
                                        ('h2', 4)])
def test_local_energy_autodiff_matches_jax(name, n_det):
    """The autodiff oracle (gradient and Hessian diagonal of log|Psi| by
    torch autograd, on the CPU) against the reference's oracle and the
    analytic local energy, at the reference's own tolerance (5e-4)."""
    cfg, params = j_build_system(name, n_det=n_det, ci_seed=1)
    if n_det > 1:
        from repro_torch.systems import build_system as build
        tcfg, tparams = build(name, n_det=n_det, ci_seed=1, device='cpu')
    else:
        tcfg, tparams = port_of(cfg, params)
    r = np.random.default_rng(0).normal(scale=1.2, size=(cfg.n_elec, 3)
                                        ).astype(np.float32)
    e_ad = float(t_wf.local_energy_autodiff(tcfg, tparams,
                                            torch.from_numpy(r)))
    e_an = float(t_wf.psi_state(tcfg, tparams, torch.from_numpy(r)).e_loc)
    e_j = float(jax.jit(functools.partial(j_wf.local_energy_autodiff, cfg))(
        params, jnp.asarray(r)))
    np.testing.assert_allclose(e_ad, e_an, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(e_ad, e_j, rtol=5e-4, atol=5e-4)
