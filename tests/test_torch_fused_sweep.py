"""The fused single-electron-move sweep of the PyTorch port against the JAX
package: ``kernels/fused_sweep`` (the plain version the CPU runs),
``core/sem.py``'s fused path (``fused-vmc``) and the launch tuner.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its ``fused_sweep_ref`` scan (the reference's own oracle for
its Pallas kernel).  Tolerances: accept decisions identical except moves
whose margin 2 (log|ratio| + dJ) - log u is within 1e-5 of 0; r exact and
sign equal on the other walkers; Minv within 1e-5 of each walker's max
and logdet within 1e-5 of max(|logdet|, 1).  A Sherman–Morrison chain in
fp32 from a cold start moves some walkers' inverses by 1e-5 to O(1)
whatever the summation order (water included), so
the per-walker checks hold on the walkers whose fp32 sweep (the port's)
stays within 1e-5 of the same sweep in float64 (the ``FP32_SCOPE`` rule
of ``chip_smoke.py``), and over all walkers without a near tie the median
distance to JAX must stay within 3x the fp32 scale (the port's median
distance from its fp64 twin) — the rule ``chip_smoke.py`` holds the CUDA
kernel to.
"""
import dataclasses
import functools
import json
import re
import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.core import sem as j_sem  # noqa: E402
from repro.core.driver import Population as JPopulation  # noqa: E402
from repro.kernels.fused_sweep.ref import (  # noqa: E402
    fused_sweep_ref as j_fused_ref)
from repro.systems import build_system as j_build_system  # noqa: E402

from repro_torch.core import sem as t_sem  # noqa: E402
from repro_torch.core.driver import Population  # noqa: E402
from repro_torch.kernels.fused_sweep import autotune  # noqa: E402
from repro_torch.kernels.fused_sweep.ops import fused_sweep_block  # noqa: E402
from repro_torch.kernels.fused_sweep.ref import fused_sweep_ref  # noqa: E402
from repro_torch.launch import qmc_run  # noqa: E402
from repro_torch.systems.convert import from_numpy  # noqa: E402

MARGIN = 1e-5


def port_of(cfg, params, method=None):
    """The port's (cfg, params) for a JAX (cfg, params), via numpy only."""
    basis = {f.name: np.asarray(getattr(cfg.basis, f.name))
             for f in dataclasses.fields(cfg.basis)}
    jas = {k: np.asarray(getattr(params.jastrow, k))
           for k in ('b_ee', 'b_en', 'a_en')}
    ci = None
    if cfg.ci is not None:
        ci = {f: np.asarray(getattr(cfg.ci, f)) for f in (
            'coeffs', 'holes_up', 'parts_up', 'holes_dn', 'parts_dn')}
        ci['n_orb'] = cfg.ci.n_orb
    return from_numpy(basis, np.asarray(params.coords),
                      np.asarray(params.charges), np.asarray(params.mo),
                      jas, n_up=cfg.n_up, n_dn=cfg.n_dn, k_max=cfg.k_max,
                      method=method or cfg.method, ns_steps=cfg.ns_steps,
                      sem_refresh=cfg.sem_refresh, ci=ci, device='cpu')


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return np.asarray(x)


def cold_start(cfg, params, W, seed):
    """Electrons around charge-weighted random nuclei, from numpy."""
    rng = np.random.default_rng(seed)
    coords, charges = np.asarray(params.coords), np.asarray(params.charges)
    at = rng.choice(len(charges), (W, cfg.n_elec), p=charges / charges.sum())
    return (coords[at] + rng.normal(size=(W, cfg.n_elec, 3))
            ).astype(np.float32)


def block_operands(cfg, params, R, seed, step=0.3):
    """numpy draws for an up-block sweep: proposals of all electrons, e-n
    deltas and log u of the up block."""
    rng = np.random.default_rng(seed)
    W, n_up = R.shape[0], cfg.n_up
    r_prop = (R + step * rng.normal(size=R.shape)).astype(np.float32)
    en = (0.05 * rng.normal(size=(W, n_up))).astype(np.float32)
    logu = np.log(rng.uniform(1e-6, 1.0, (W, n_up))).astype(np.float32)
    return r_prop, en, logu


def _jax_sweep(cfg, params, R, r_prop, en, logu, b_ee):
    """JAX: evaluate_sem, the shared AO pass and the scan oracle, in one
    jit (traced once per shape)."""
    ens = j_sem.evaluate_sem(cfg, params, R)
    phi, _ = j_sem._fused_phi_all(cfg, params, *j_sem._mo_blocks(cfg, params),
                                  r_prop)
    state, acc = j_fused_ref(ens.r, ens.minv_up, ens.sign, ens.logdet, phi,
                             r_prop[:, :cfg.n_up], en, logu, b_ee, offset=0,
                             n_up=cfg.n_up)
    return ens, phi, state[:4], acc


@pytest.fixture(scope='module')
def water():
    cfg, params = j_build_system('water')
    return cfg, params, port_of(cfg, params, method='kernel')


@pytest.fixture(scope='module')
def smallest():
    cfg, params = j_build_system('smallest')
    return cfg, params, port_of(cfg, params, method='kernel')


def _both_refs(cfg, params, W, seed, logu_value=None):
    """One up-block sweep through JAX's scan oracle and the port's plain
    version on the same numpy operands (plus the port's fp64 twin)."""
    R = cold_start(cfg, params, W, seed)
    r_prop, en, logu = block_operands(cfg, params, R, seed + 1)
    if logu_value is not None:
        logu = np.full_like(logu, logu_value)
    b_ee = np.float32(params.jastrow.b_ee)
    ens, phi, (r_j, m_j, s_j, l_j), acc_j = jax.jit(
        functools.partial(_jax_sweep, cfg))(params, R, r_prop, en, logu,
                                            b_ee)
    ins = [_t(x) for x in (ens.r, ens.minv_up, ens.sign, ens.logdet, phi,
                           r_prop[:, :cfg.n_up], en, logu)]
    out = {}
    for dt in (torch.float32, torch.float64):
        args = [x.to(dt) for x in ins]
        out[dt] = fused_sweep_ref(*args, torch.tensor(float(b_ee), dtype=dt),
                                  offset=0, n_up=cfg.n_up)
    jax_out = tuple(_j(x) for x in (r_j, m_j, s_j, l_j, acc_j))
    return ens, r_prop[:, :cfg.n_up], jax_out, out[torch.float32], \
        out[torch.float64]


def _rel(x, ref):
    """Per-walker max |x - ref| relative to the walker's max |ref|."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    ax = tuple(range(1, ref.ndim))
    return np.max(np.abs(x - ref), axis=ax) / np.max(np.abs(ref), axis=ax)


def check_sweep(jax_out, port, port64):
    """Port's sweep against JAX's: the tolerances of the module docstring.
    Returns the number of moves within MARGIN of the threshold."""
    r_j, m_j, s_j, l_j, acc_j = jax_out
    (r_t, m_t, s_t, l_t, _, _), acc_t, mar_t = port
    acc_t, mar_t = acc_t.numpy(), np.abs(mar_t.numpy())
    tie = mar_t < MARGIN
    np.testing.assert_array_equal(acc_t[~tie], acc_j[~tie])
    clean = ~tie.any(axis=1)
    scale = _rel(m_t.numpy(), port64[0][1].numpy())   # fp32 vs fp64 twin
    assert np.median(_rel(m_t.numpy(), m_j)[clean]) <= max(
        3 * np.median(scale[clean]), 1e-6)
    clean &= scale <= 1e-5                                # FP32_SCOPE
    assert clean.sum() >= 1
    np.testing.assert_array_equal(r_t.numpy()[clean], r_j[clean])
    np.testing.assert_array_equal(s_t.numpy()[clean], s_j[clean])
    assert np.all(_rel(m_t.numpy(), m_j)[clean] <= 1e-5)
    dl = np.abs(l_t.numpy() - l_j) / np.maximum(np.abs(l_j), 1.0)
    assert np.all(dl[clean] <= 1e-5)
    return int(tie.sum())


@pytest.mark.parametrize('W', [5, 13])
def test_fused_sweep_ref_matches_jax_on_water(water, W):
    """Water (n = 5 per block), ragged walker counts included."""
    cfg, params, _ = water
    _, _, jax_out, port, port64 = _both_refs(cfg, params, W, seed=W)
    assert 0 < port[1].sum() < port[1].numel()
    check_sweep(jax_out, port, port64)


def test_fused_sweep_ref_matches_jax_on_smallest(smallest):
    """The micro-peptide's up block (n = 79) at W = 4."""
    cfg, params, _ = smallest
    _, _, jax_out, port, port64 = _both_refs(cfg, params, 4, seed=3)
    ties = check_sweep(jax_out, port, port64)
    print(f'smallest: {ties} moves within {MARGIN} of the threshold')


@pytest.mark.parametrize('logu', [1e30, -1e30], ids=['reject', 'accept'])
def test_all_reject_and_all_accept_sweeps(water, logu):
    """log u = +1e30 accepts nothing: the state passes through bitwise;
    -1e30 accepts every move: the electrons land on their proposals."""
    cfg, params, _ = water
    ens, r_prop, jax_out, port, port64 = _both_refs(cfg, params, 5, 2,
                                                    logu_value=logu)
    (r_t, m_t, s_t, l_t, _, _), acc_t, _ = port
    if logu > 0:
        assert not acc_t.any()
        for a, b in ((r_t, ens.r), (m_t, ens.minv_up), (s_t, ens.sign),
                     (l_t, ens.logdet)):
            np.testing.assert_array_equal(a.numpy(), _j(b))
    else:
        assert acc_t.all()
        np.testing.assert_array_equal(r_t.numpy()[:, :cfg.n_up], r_prop)
    check_sweep(jax_out, port, port64)


def test_fused_sweep_block_plain_path_leaves_inputs_alone(water):
    """On CPU tensors ``fused_sweep_block`` runs the plain loop, which
    returns new tensors and modifies nothing it is given (the CUDA kernel
    updates in place; the sweep clones its state once for it)."""
    _, _, (tcfg, tparams) = water
    R = torch.from_numpy(cold_start(tcfg, tparams, 4, 1))
    ens = t_sem.evaluate_sem(tcfg, tparams, R)
    before = [x.clone() for x in (ens.minv_up, ens.r, ens.sign, ens.logdet)]
    n = tcfg.n_up
    phi = torch.randn((4, n, n))
    out = fused_sweep_block(ens.minv_up, phi, ens.r, ens.r[:, :n] + 0.1,
                            torch.zeros(4, n), torch.full((4, n), -1.0),
                            ens.sign, ens.logdet, tparams.jastrow.b_ee,
                            offset=0, n_up=n, use_kernel=True)
    for a, b in zip((ens.minv_up, ens.r, ens.sign, ens.logdet), before):
        assert torch.equal(a, b)
    assert out[6].shape == (4, n) and out[7].shape == (4, n)


@pytest.mark.parametrize('system', ['water', 'smallest'])
def test_fused_phi_all_matches_jax(system, water, smallest):
    cfg, params, (tcfg, tparams) = {'water': water,
                                    'smallest': smallest}[system]
    rng = np.random.default_rng(4)
    R = cold_start(cfg, params, 3, 4) + 0.1 * rng.normal(
        size=(3, cfg.n_elec, 3)).astype(np.float32)
    pj = j_sem._fused_phi_all(cfg, params, *j_sem._mo_blocks(cfg, params),
                              jnp.asarray(R))
    pt = t_sem._fused_phi_all(tcfg, tparams,
                              *t_sem._mo_blocks(tcfg, tparams), _t(R))
    for a, b in zip(pt, pj):
        scale = np.max(np.abs(_j(b)))
        np.testing.assert_allclose(a.numpy(), _j(b), rtol=1e-5,
                                   atol=1e-6 * scale)


def _sem_draws(key, W, n_e):
    """sem.py:494-501 (and :303-310): walker key -> fold_in(j) -> split ->
    normal(3,), uniform(); returns eta (W, n_e, 3), u (W, n_e)."""
    wkeys = JPopulation().walker_keys(key, W)

    def _one(k, j):
        ke, ku = jax.random.split(jax.random.fold_in(k, j))
        return (jax.random.normal(ke, (3,), jnp.float32),
                jax.random.uniform(ku, (), jnp.float32))
    eta, u = jax.vmap(lambda k: jax.vmap(lambda j: _one(k, j))(
        jnp.arange(n_e)))(wkeys)
    return _j(eta), _j(u)


def _moved_accepts(R0, r_j, acc_t, mar_t):
    """JAX's accepts (an electron moved or not) against the port's, walker
    by walker up to the first near tie in that walker."""
    moved_j = np.any(r_j != R0, axis=-1).T               # (n_e, W)
    acc_t, mar_t = acc_t.numpy(), np.abs(mar_t.numpy())
    ties = 0
    for w in range(R0.shape[0]):
        for j in range(R0.shape[1]):
            if mar_t[j, w] < MARGIN:
                ties += 1
                break
            assert acc_t[j, w] == moved_j[j, w], (w, j, mar_t[j, w])
    return ties


STEP = 0.4


@pytest.fixture(scope='module')
def jax_fused_propagate(water):
    """JAX's fused-vmc propagate on water (the ``fused`` scan), jitted
    once for both cases."""
    prop = j_sem.SEMVMCPropagator(j_sem._fused_cfg(water[0]),
                                  step_size=STEP)
    return jax.jit(functools.partial(prop.propagate, pop=JPopulation()))


@pytest.mark.parametrize('sweeps_before', [0, 7], ids=['corrector',
                                                       'refresh'])
def test_fused_vmc_same_accepts_under_jax_draws(water, jax_fused_propagate,
                                                sweeps_before):
    """One fused-vmc sweep of each package from the same state under the
    reference's draws (JAX: the ``fused`` scan; the port: 'fused-kernel',
    its plain version on the CPU): accepts move for move, then the
    corrector (sweep 1) or the refresh (sweep 8) brings the same state."""
    cfg, params, (tcfg, tparams) = water
    W, step = 8, STEP
    R = cold_start(cfg, params, W, 0)
    key = jax.random.PRNGKey(9)
    ens_j = jax.jit(functools.partial(j_sem.evaluate_sem, cfg))(
        params, jnp.asarray(R))
    st_j, _ = jax_fused_propagate(
        params, j_sem.SEMState(ens=ens_j, sweeps=jnp.int32(sweeps_before)),
        key)
    draws = tuple(_t(x) for x in _sem_draws(key, W, cfg.n_elec))
    prop_t = t_sem.SEMVMCPropagator(t_sem._fused_cfg(tcfg), step_size=step)
    assert prop_t.cfg.method == 'fused-kernel'
    assert prop_t.cfg.mo_method == 'kernel'
    state_t = t_sem.SEMState(ens=t_sem.evaluate_sem(tcfg, tparams, _t(R)),
                             sweeps=sweeps_before)
    *_, acc_t, mar_t = prop_t.sweep(tparams, state_t, None, draws)
    st_t, out_t = prop_t.propagate(tparams, state_t, None, Population(),
                                   draws)
    ties = _moved_accepts(R, _j(st_j.ens.r), acc_t, mar_t)
    assert 0.0 < float(out_t[2]) < 1.0
    if ties:
        return
    # the proposals r + step * eta round alike up to XLA's contraction
    np.testing.assert_allclose(st_t.ens.r.numpy(), _j(st_j.ens.r), rtol=0,
                               atol=1e-5)
    for f in ('minv_up', 'minv_dn'):
        assert np.all(_rel(getattr(st_t.ens, f).numpy(),
                           _j(getattr(st_j.ens, f))) <= 1e-4)
    np.testing.assert_allclose(st_t.ens.logdet.numpy(), _j(st_j.ens.logdet),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(st_t.ens.sign.numpy(), _j(st_j.ens.sign))
    np.testing.assert_allclose(st_t.ens.e_loc.numpy(), _j(st_j.ens.e_loc),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('system', ['water', 'smallest'])
def test_fused_vmc_matches_port_sem_vmc_under_same_draws(system, water,
                                                         smallest):
    """The port's fused and per-move sweeps from one state under one set of
    draws: identical accepts away from the threshold (1e-3: the two paths
    round the e-e Jastrow delta and the updates differently)."""
    _, _, (tcfg, tparams) = {'water': water, 'smallest': smallest}[system]
    W = 6 if system == 'water' else 3
    R = torch.from_numpy(cold_start(tcfg, tparams, W, 7))
    state = t_sem.SEMState(ens=t_sem.evaluate_sem(tcfg, tparams, R),
                           sweeps=0)
    draws = t_sem.draw_sweep(torch.Generator().manual_seed(1), R)
    out = {}
    for name, cfg in (('per-move', tcfg), ('fused', t_sem._fused_cfg(tcfg))):
        out[name] = t_sem.SEMVMCPropagator(cfg).sweep(tparams, state, None,
                                                      draws)
    acc_f, mar_f = out['fused'][5], out['fused'][6]
    acc_p, mar_p = out['per-move'][5], out['per-move'][6]
    near = (torch.minimum(mar_f.abs(), mar_p.abs()) < 1e-3)
    stop = torch.cumsum(near.to(torch.int32), dim=0) > 0
    assert torch.equal(acc_f[~stop], acc_p[~stop])
    assert int((~stop).sum()) >= acc_f.numel() // 2
    assert 0 < int(acc_f.sum()) < acc_f.numel()


@pytest.mark.parametrize('n_det', [1, 6])
def test_fused_sweeps_track_fresh_recompute(n_det):
    """DESIGN.md §6 for the fused path: after k = 3 < sem_refresh fused-vmc
    sweeps from the port's own generator, the maintained inverses (and,
    with CI, the ratios the energy pass rebuilds from them) match a fresh
    recompute within 1e-4, both spin blocks."""
    from repro_torch.core.driver import EnsembleDriver, make_propagator
    from repro_torch.systems import build_system
    cfg, params = build_system('water', n_det=n_det, ci_seed=3,
                               device='cpu')
    prop = make_propagator('fused-vmc', cfg, tau=0.4)
    drv = EnsembleDriver(prop, steps=3)
    gen = torch.Generator().manual_seed(0)
    st = drv.init(params, gen, 8, walkers=cold_start(cfg, params, 8, 5))
    st, stats = drv.run_block(params, st, gen)
    assert st.sweeps == 3 and 0.0 < stats.aux['accept'] < 1.0
    fresh = t_sem.evaluate_sem(prop.cfg, params, st.ens.r)
    for f in ('minv_up', 'minv_dn', 'rdet_up', 'rdet_dn'):
        a, b = getattr(st.ens, f), getattr(fresh, f)
        if b.numel():
            assert float((a - b).abs().max()
                         / b.abs().max().clamp(min=1.0)) <= 1e-4, f
    assert float((st.ens.logdet - fresh.logdet).abs().max()) <= 1e-4


def test_fused_cfg_keeps_the_mo_product(water):
    """fused-vmc rewrites the propagator method, not the MO product: the
    post-sweep energy pass keeps 'kernel' (sparse_mo) or 'dense'."""
    from repro_torch.core.driver import make_propagator
    from repro_torch.core.wavefunction import _mo_product_method
    _, _, (tcfg, _) = water
    for method, want in (('kernel', ('fused-kernel', 'kernel')),
                         ('dense', ('fused', 'dense'))):
        cfg = make_propagator('fused-vmc',
                              dataclasses.replace(tcfg, method=method)).cfg
        assert (cfg.method, _mo_product_method(cfg)) == want
    assert _mo_product_method(dataclasses.replace(tcfg, method='fused')) \
        == 'sparse'


def _cli_energy(main, tmp_path, tag, extra=()):
    avg = main(['--system', 'h2', '--method', 'fused-vmc', '--workers', '1',
                '--walkers', '32', '--steps', '10', '--blocks', '6',
                '--seed', '3', '--db', str(tmp_path / f'{tag}.sqlite'),
                *extra])
    assert np.isfinite(avg.energy) and avg.n_blocks >= 6
    return avg


def test_qmc_run_fused_vmc_on_cpu_within_3_sigma_of_jax(tmp_path, capsys):
    """qmc_run --method fused-vmc --device cpu on h2 end to end (blocks in
    the store), its energy within 3 sigma of the JAX CLI run's."""
    from repro.launch.qmc_run import main as j_main
    t_avg = _cli_energy(qmc_run.main, tmp_path, 'torch',
                        ('--device', 'cpu'))
    key = re.search(r'run_key=(\w+)', capsys.readouterr().out).group(1)
    with sqlite3.connect(tmp_path / 'torch.sqlite') as conn:
        n = conn.execute('SELECT COUNT(*) FROM blocks WHERE run_key=?',
                         (key,)).fetchone()[0]
    assert n >= 6
    j_avg = _cli_energy(j_main, tmp_path, 'jax')
    sigma = np.hypot(t_avg.error, j_avg.error)
    assert abs(t_avg.energy - j_avg.energy) <= 3 * sigma, (t_avg, j_avg)


# ---------------------------------------------------------------------------
# launch tuner: measured once, cached, corruption-tolerant
# ---------------------------------------------------------------------------
def test_tuner_cache_hit_skips_measurement(tmp_path):
    calls = []

    def fake_measure(n_e, W, candidates):
        calls.append((n_e, W, tuple(candidates)))
        return candidates[-1]

    path = tmp_path / 'tiles.json'
    before = autotune.build_count()
    t1 = autotune.best_threads(158, 256, path=path, measure=fake_measure)
    assert len(calls) == 1 and autotune.build_count() == before + 1
    assert t1 == 512 and calls[0] == (158, 256, (64, 128, 256, 512))
    assert autotune.best_threads(158, 256, path=path,
                                 measure=fake_measure) == t1
    assert len(calls) == 1, 'cache hit re-measured'
    doc = json.loads(path.read_text())
    assert doc == {'schema': 1, 'tiles': {'158|256|fp32|cuda': 512}}


def test_tuner_key_spans_all_fields_and_keeps_other_entries(tmp_path):
    """Each of (n_e, W, dtype, backend) is its own entry; an entry of the
    reference's (another backend) in the same file survives."""
    calls = []
    path = tmp_path / 'tiles.json'
    path.write_text(json.dumps({'schema': 1,
                                'tiles': {'60|256|fp32|cpu': 16}}))

    def fake_measure(n_e, W, candidates):
        calls.append(None)
        return candidates[0]

    base = dict(n_e=10, W=32, dtype='fp32', backend='cuda')
    variants = [dict(base), dict(base, n_e=12), dict(base, W=64),
                dict(base, dtype='bf16'), dict(base, backend='other')]
    for kw in variants + variants:
        autotune.best_threads(kw['n_e'], kw['W'], kw['dtype'],
                              backend=kw['backend'], path=path,
                              measure=fake_measure)
    assert len(calls) == len(variants)
    tiles = json.loads(path.read_text())['tiles']
    assert len(tiles) == len(variants) + 1 and tiles['60|256|fp32|cpu'] == 16


@pytest.mark.parametrize('garbage', ['{not json', '[]',
                                     '{"schema": 0, "tiles": {"a": 4}}',
                                     '{"schema": 1, "tiles": 7}'],
                         ids=['corrupt', 'nondict', 'stale', 'badtiles'])
def test_tuner_corrupt_cache_remeasures(tmp_path, garbage):
    path = tmp_path / 'tiles.json'
    path.write_text(garbage)
    threads = autotune.best_threads(6, 8, path=path,
                                    measure=lambda n_e, W, c: c[1])
    assert threads == 128
    doc = json.loads(path.read_text())
    assert doc == {'schema': 1, 'tiles': {'6|8|fp32|cuda': 128}}


def test_tuner_env_override(tmp_path, monkeypatch):
    monkeypatch.setenv('REPRO_FUSED_TILE_CACHE', str(tmp_path / 'c.json'))
    assert autotune.cache_path() == tmp_path / 'c.json'
    autotune.best_threads(4, 2, measure=lambda n_e, W, c: c[0])
    assert json.loads((tmp_path / 'c.json').read_text())['tiles'] == {
        '4|2|fp32|cuda': 64}
    monkeypatch.delenv('REPRO_FUSED_TILE_CACHE')
    assert autotune.cache_path().name == 'fused_sweep_tiles.json'


def test_tuner_measurement_picks_the_fastest_with_injected_timer():
    """The measurement times every candidate through ``fused_sweep_block``
    (the plain loop on the CPU) and keeps the fastest."""
    times = iter([3.0, 1.0, 2.0, 4.0])
    seen = []

    def timer(fn):
        fn()
        seen.append(None)
        return next(times)
    best = autotune._measure(6, 3, (64, 128, 256, 512), timer=timer,
                             device='cpu')
    assert best == 128 and len(seen) == 4
    assert autotune.measured_times()['6|3|fp32|cuda'] == {
        64: 3.0, 128: 1.0, 256: 2.0, 512: 4.0}


def test_tuner_keeps_the_value_in_process(tmp_path):
    """After the first lookup a geometry's value comes from the process:
    later sweeps read no file, even one removed or corrupted since."""
    path = tmp_path / 'tiles.json'
    calls = []

    def fake_measure(n_e, W, candidates):
        calls.append(None)
        return candidates[2]
    assert autotune.best_threads(10, 4, path=path, measure=fake_measure) == 256
    path.write_text('{not json')
    assert autotune.best_threads(10, 4, path=path, measure=fake_measure) == 256
    path.unlink()
    assert autotune.best_threads(10, 4, path=path, measure=fake_measure) == 256
    assert len(calls) == 1
    other = tmp_path / 'other.json'
    assert autotune.best_threads(10, 4, path=other,
                                 measure=lambda n_e, W, c: c[0]) == 64


# ---------------------------------------------------------------------------
# route and launch shape: a pure function of the sizes
# ---------------------------------------------------------------------------
from repro_torch.kernels.fused_sweep import kernel as fs_kernel  # noqa: E402


@pytest.mark.parametrize('sizes,want', [
    ((79, 79, 158), dict(route='rows', per_row=1, reg=80, shared=0,
                         threads=96)),
    ((217, 217, 434), dict(route='rows', per_row=2, reg=64, shared=48,
                           threads=448)),
    ((866, 866, 1731), dict(route='global', per_row=0)),
    ((79, 118, 158, 118, 100, True), dict(route='rows', per_row=1, reg=80,
                                         p_start=96, threads=224)),
    ((225, 225, 450), dict(route='rows', per_row=2)),
    ((79, 579, 158, 579, 100, True), dict(route='shared')),
    ((257, 257, 514), dict(route='global')),
], ids=['smallest', 'b-strand', 'n866', 'smallest-ci', 'n225', 'wide-ci',
        'n257'])
def test_launch_shape_picks_the_route_by_size(sizes, want):
    """n = 79 keeps whole rows in registers, one thread a row; n = 217
    splits each row over two threads, part in shared memory; n = 866 and
    anything the SM cannot hold go to the global route; CI adds P's rows
    from the next warp."""
    shape = fs_kernel.launch_shape(*sizes)
    assert {k: getattr(shape, k) for k in want} == want
    if shape.route == 'rows':
        n = sizes[0]
        assert (shape.reg + shape.shared) * shape.per_row >= n
        assert shape.threads <= fs_kernel.rows_max_threads(shape.reg)
    assert shape.smem_bytes <= fs_kernel.H100.optin


@pytest.mark.parametrize('n,route', [(79, 'global'), (217, 'global'),
                                     (79, 'shared'), (217, 'shared')])
def test_launch_shape_honours_a_forced_route(n, route):
    shape = fs_kernel.launch_shape(n, n, 2 * n, route=route, threads=256)
    assert (shape.route, shape.threads, shape.per_row) == (route, 256, 0)


def test_launch_shape_per_row_and_refusals():
    """A tuned threads-per-row count is taken where it fits, else the size
    picks; a forced route that cannot hold the block raises."""
    assert fs_kernel.launch_shape(79, 79, 158, per_row=2).per_row == 2
    assert fs_kernel.launch_shape(217, 217, 434, per_row=1).shared == 224
    assert fs_kernel.launch_shape(217, 217, 434, per_row=4).per_row == 2
    with pytest.raises(ValueError, match='rows route cannot hold'):
        fs_kernel.launch_shape(217, 217, 434, route='rows', per_row=4)
    with pytest.raises(ValueError, match='shared memory'):
        fs_kernel.launch_shape(866, 866, 1731, route='shared')
    with pytest.raises(ValueError, match='threads=48'):
        fs_kernel.launch_shape(866, 866, 1731, threads=48)
    # at W = 256 on 132 SMs a tuned count that needs more waves yields
    ci = (79, 118, 158, 118, 100, True)
    assert fs_kernel.launch_shape(*ci, per_row=2).per_row == 2
    assert fs_kernel.launch_shape(*ci, per_row=2, walkers=256).per_row == 1
    assert fs_kernel.launch_shape(79, 79, 158, per_row=2,
                                  walkers=256).per_row == 2
    assert autotune.per_row_candidates(158) == (1, 2)
    assert autotune.per_row_candidates(434) == (1, 2)
    assert autotune.per_row_candidates(1732) == ()


# ---------------------------------------------------------------------------
# the rows route's tuner: its own key, old entries neither served nor lost
# ---------------------------------------------------------------------------
def test_tuner_stores_threads_per_row_under_its_own_key(tmp_path):
    calls = []

    def fake_measure(n_e, W, candidates):
        calls.append((n_e, W, tuple(candidates)))
        return candidates[1]
    path = tmp_path / 'tiles.json'
    assert autotune.best_per_row(158, 256, path=path,
                                 measure=fake_measure) == 2
    assert calls == [(158, 256, (1, 2))]
    assert json.loads(path.read_text()) == {
        'schema': 1, 'tiles': {'158|256|fp32|cuda|per_row': 2}}
    assert autotune.best_launch(158, 256, path=path,
                                measure=fake_measure) == {'per_row': 2}
    assert len(calls) == 1, 'cache hit re-measured'


def test_tuner_does_not_serve_an_old_kernel_entry_and_keeps_others(tmp_path):
    """An entry the first design stored (threads per block under the bare
    key) does not answer the rows route; it and the reference's entries
    of other backends stay in the file."""
    path = tmp_path / 'tiles.json'
    old = {'158|256|fp32|cuda': 512, '60|256|fp32|cpu': 16,
           '158|256|fp32|tpu': 8}
    path.write_text(json.dumps({'schema': 1, 'tiles': old}))
    calls = []

    def fake_measure(n_e, W, candidates):
        calls.append(candidates)
        return candidates[0]
    assert autotune.best_per_row(158, 256, path=path,
                                 measure=fake_measure) == 1
    assert len(calls) == 1
    assert json.loads(path.read_text())['tiles'] == dict(
        old, **{'158|256|fp32|cuda|per_row': 1})


def test_best_launch_takes_threads_per_block_where_rows_cannot(tmp_path):
    path = tmp_path / 'tiles.json'
    got = autotune.best_launch(1732, 8, path=path,
                               measure=lambda n_e, W, c: c[-1])
    assert got == {'threads': 512}
    assert json.loads(path.read_text())['tiles'] == {'1732|8|fp32|cuda': 512}
    with pytest.raises(ValueError, match='rows route cannot hold'):
        autotune.best_per_row(1732, 8, path=path)


def test_tuner_per_row_measurement_picks_the_fastest_with_injected_timer():
    """The rows tuner times each threads-per-row count through
    ``fused_sweep_block`` (the plain loop on the CPU)."""
    times = iter([2.0, 1.0])

    def timer(fn):
        fn()
        return next(times)
    assert autotune._measure(6, 3, (1, 2), timer=timer, device='cpu',
                             per_row=True) == 2
    assert autotune.measured_times()['6|3|fp32|cuda|per_row'] == {
        1: 2.0, 2: 1.0}


# ---------------------------------------------------------------------------
# forced counts, the tuner's candidates and the compiled shapes
# ---------------------------------------------------------------------------
def test_forced_rows_count_runs_however_many_waves_it_takes():
    """``route='rows'`` with ``per_row`` runs that count wherever it fits,
    even where another count needs fewer waves (the tuner forces each
    candidate this way); ``'auto'`` keeps to the fewest waves."""
    few = fs_kernel.Card(sms=1)
    ci = (79, 118, 158, 118, 100, True)
    waves = {t: fs_kernel.waves(fs_kernel.rows_launch(*ci, per_row=t,
                                                      card=few), 64, few)
             for t in (1, 2)}
    assert waves[2] > waves[1]
    forced = fs_kernel.launch_shape(*ci, route='rows', per_row=2,
                                    walkers=64, card=few)
    assert (forced.per_row, forced.reg) == (2, 48)
    assert fs_kernel.launch_shape(*ci, per_row=2, walkers=64,
                                  card=few).per_row == 1
    for W in (256, 512, 4096):
        for t in (1, 2):
            shape = fs_kernel.launch_shape(79, 79, 158, route='rows',
                                           per_row=t, walkers=W)
            assert shape.per_row == t


@pytest.mark.parametrize('W,want', [(256, (1, 2)), (512, (1, 2)),
                                    (4096, (1,))])
def test_tuner_measures_only_counts_the_route_runs(tmp_path, W, want):
    """The tuner's candidates are the counts ``launch_shape`` honours at
    its W (fewest waves: at n = 79 an H100 holds 5 blocks of 1 thread a
    row on an SM and 4 of 2); each is measured through the forced rows
    route and the winner is what ``'auto'`` then launches.  Where one count
    is left it is taken without measuring."""
    card = fs_kernel.H100
    assert autotune.per_row_candidates(158, W, card) == want
    seen = []

    def measure(n_e, W_, candidates):
        for t in candidates:
            seen.append(fs_kernel.launch_shape(
                79, 79, n_e, route='rows', per_row=t, walkers=W_,
                card=card).per_row)
        return candidates[-1]
    got = autotune.best_per_row(158, W, path=tmp_path / 't.json',
                                measure=measure, card=card)
    cands = autotune.per_row_candidates(158, W, card)
    assert seen == (list(cands) if len(cands) > 1 else [])
    assert fs_kernel.launch_shape(79, 79, 158, per_row=got, walkers=W,
                                  card=card).per_row == got
    one = fs_kernel.Card(sms=1, regs=24576)   # 2 blocks of T = 1, 1 of T = 2
    assert autotune.per_row_candidates(158, 64, one) == (1,)
    assert autotune.best_per_row(158, 64, path=tmp_path / 'u.json',
                                 measure=None, card=one) == 1
    assert not (tmp_path / 'u.json').exists()


def _variant_sizes(reg, sh, ci):
    """The largest block n <= 256 (CI: n_orb = n + 20, n_det = 50) and the
    threads per row at which the chooser takes the compiled (reg, sh)."""
    for n in range(256, 0, -1):
        sizes = ((n, n + 20, 2 * n, n + 20, 50, True) if ci
                 else (n, n, 2 * n))
        for t in fs_kernel.PER_ROW:
            x = fs_kernel.rows_launch(*sizes, per_row=t)
            if x is not None and (x.reg, x.shared) == (reg, sh):
                return sizes, t
    return None


def test_every_compiled_rows_shape_is_reached_by_a_size():
    """Each (R, S) the source compiles, with and without CI, is the
    chooser's pick at some block size (so the card tests, which run each
    one, cover every instantiation and none is dead); the lists are read
    from the source."""
    assert fs_kernel.VARIANTS == ((48, 0), (80, 0), (64, 48), (64, 64),
                                  (0, 224))
    assert set(fs_kernel.CI_VARIANTS) <= set(fs_kernel.VARIANTS)
    for ci, pairs in ((False, fs_kernel.VARIANTS),
                      (True, fs_kernel.CI_VARIANTS)):
        for reg, sh in pairs:
            assert _variant_sizes(reg, sh, ci) is not None, (reg, sh, ci)
    assert _variant_sizes(0, 224, True) is None
    assert (fs_kernel.PHI_RING, fs_kernel.RED_SLOTS) == (4, 32)
