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
from repro_torch.kernels.fused_sweep.ref import (  # noqa: E402
    fused_sweep_ref, p_replay_ref)
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


def test_tuner_ci_measurement_picks_the_fastest_with_injected_timer():
    """With CI widths the measurement sweeps CI operands (the table, the
    ratios, rank-k lists over the virtual orbitals) through
    ``fused_sweep_block`` (the plain loop on the CPU) at each threads per
    block and keys the times with ``ci<n_orb>x<n_det>x<k>``."""
    times = iter([3.0, 2.0, 1.0, 4.0])

    def timer(fn):
        fn()
        return next(times)
    assert autotune._measure(12, 3, (64, 128, 256, 512), timer=timer,
                             device='cpu', ci=(10, 5, 3)) == 256
    assert autotune.measured_times()['12|3|fp32|cuda|ci10x5x3'] == {
        64: 3.0, 128: 2.0, 256: 1.0, 512: 4.0}


def test_tuner_ci_cluster_measurement_keys_its_times_with_both_tags():
    """With CI widths and ``cluster`` the measurement sweeps the same CI
    operands at each cluster size and keys the times with
    ``cluster|ci<n_orb>x<n_det>x<k>``."""
    times = iter([2.0, 1.0])

    def timer(fn):
        fn()
        return next(times)
    assert autotune._measure(12, 3, (8, 16), timer=timer, device='cpu',
                             cluster=True, ci=(10, 5, 3)) == 16
    assert autotune.measured_times()['12|3|fp32|cuda|cluster|ci10x5x3'] == {
        8: 2.0, 16: 1.0}


def test_launch_counter_splits_its_count_by_variant():
    """A launch counts once in ``n`` and, when the wrapper names its
    variant (the fused sweep's route and CI, sem_move's CI), once in
    ``by``; ``reset`` clears both."""
    from repro_torch.kernels._build import LaunchCounter
    c = LaunchCounter()
    for v in ('global ci', 'global ci', 'cluster', None):
        c.add(v)
    assert c.n == 4 and c.by == {'global ci': 2, 'cluster': 1}
    c.reset()
    assert c.n == 0 and c.by == {}


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
    ((866, 866, 1731), dict(route='cluster', cluster=16, rows=7, reg=28,
                            shared=0, threads=256)),
    ((79, 118, 158, 118, 100, True), dict(route='rows', per_row=1, reg=80,
                                         p_start=96, threads=224)),
    ((225, 225, 450), dict(route='rows', per_row=2)),
    ((79, 579, 158, 579, 100, True), dict(route='shared')),
    ((257, 257, 514), dict(route='cluster', cluster=4, rows=16, reg=12,
                           shared=0, threads=160)),
], ids=['smallest', 'b-strand', 'n866', 'smallest-ci', 'n225', 'wide-ci',
        'n257'])
def test_launch_shape_picks_the_route_by_size(sizes, want):
    """n = 79 keeps whole rows in registers, one thread a row; n = 217
    splits each row over two threads, part in shared memory; single
    determinants the SM cannot hold (n = 257, 866) go to the cluster
    route, their rows spread over a cluster of blocks in registers (4 of
    65 rows, 16 rows a warp and 12 columns a lane; 16 of 55 rows, 7 rows a
    warp and 28 columns a lane); CI adds P's rows from the next warp, and
    CI tables no SM holds stay on the shared route."""
    shape = fs_kernel.launch_shape(*sizes)
    assert {k: getattr(shape, k) for k in want} == want
    n = sizes[0]
    if shape.route == 'rows':
        assert (shape.reg + shape.shared) * shape.per_row >= n
        assert shape.threads <= fs_kernel.rows_max_threads(shape.reg)
    if shape.route == 'cluster':
        assert shape.reg * shape.per_row >= n and shape.per_row == 32
        assert shape.threads <= fs_kernel.rows_max_threads(shape.rows
                                                           * shape.reg)
        assert shape.threads // 32 * shape.rows >= -(-n // shape.cluster)
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
    """Past what the rows route and the cluster route hold (n = 950: the
    cluster route's 32 lanes cover 896 columns) the tuned parameter is
    threads per block of the global route."""
    path = tmp_path / 'tiles.json'
    got = autotune.best_launch(1900, 8, path=path,
                               measure=lambda n_e, W, c: c[-1])
    assert got == {'threads': 512}
    assert json.loads(path.read_text())['tiles'] == {'1900|8|fp32|cuda': 512}
    with pytest.raises(ValueError, match='rows route cannot hold'):
        autotune.best_per_row(1900, 8, path=path)
    with pytest.raises(ValueError, match='cluster route cannot hold'):
        autotune.best_cluster(1900, 8, path=path)


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


# ---------------------------------------------------------------------------
# the cluster route: chooser, refusals and its tuner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('n,want', [
    (257, dict(cluster=4, rows=16, reg=12, threads=160)),
    (528, dict(cluster=8, rows=9, reg=20, threads=256)),
    (865, dict(cluster=16, rows=7, reg=28, threads=256)),
    (866, dict(cluster=16, rows=7, reg=28, threads=256)),
])
def test_launch_shape_takes_the_cluster_route_past_the_rows_route(n, want):
    """Single-determinant blocks past n = 256 (W = 256 on the H100) go to
    the smallest cluster that holds them: ceil(n / C) rows a block, in
    warps of K rows whose lanes hold L columns each, the compiled (K, L)
    that pads the row least; the same block sizes with the ``--n-det 100``
    CI widths take the cluster route too, the same shape with the most
    held rows such an expansion can name (200) in shared memory besides;
    a tuned cluster size is taken where it holds the block."""
    shape = fs_kernel.launch_shape(n, n, 2 * n, walkers=256)
    assert shape.route == 'cluster'
    assert {k: getattr(shape, k) for k in want} == want
    assert shape.smem_bytes <= fs_kernel.H100.optin
    n_orb = n + max(8, n // 2)
    ci = fs_kernel.launch_shape(n, n_orb, 2 * n, n_orb, 100, True,
                                walkers=256)
    assert ci.route == 'cluster'
    assert {k: getattr(ci, k) for k in want} == want
    assert shape.smem_bytes < ci.smem_bytes <= fs_kernel.H100.optin
    if n == 528:
        assert fs_kernel.launch_shape(n, n, 2 * n, cluster=16).cluster == 16
    assert fs_kernel.launch_shape(n, n, 2 * n, cluster=3).cluster == \
        want['cluster']


def test_forced_cluster_route_raises_where_it_cannot_hold_the_block():
    """A forced cluster route runs wherever a cluster holds the block (also
    at n = 79, which 'auto' leaves on the rows route, with CI too) and
    raises ``ValueError`` where none does: CI past rank 8 (the
    determinants' registers), CI whose held rows no cluster holds, n past
    896 (32 lanes of 28 columns), a cluster size too small for the rows
    or not offered."""
    assert fs_kernel.launch_shape(79, 79, 158, route='cluster').cluster == 2
    assert fs_kernel.launch_shape(79, 79, 158).route == 'rows'
    assert fs_kernel.launch_shape(79, 118, 158, 118, 100, True,
                                  route='cluster').cluster == 2
    for sizes, kw in (((79, 118, 158, 118, 100, True), dict(k=9)),
                      ((866, 1299, 1732, 1299, 100, True), dict(held=800)),
                      ((897, 897, 1794), {}),
                      ((866, 866, 1731), dict(cluster=8)),
                      ((528, 528, 1056), dict(cluster=3))):
        with pytest.raises(ValueError, match='cluster route cannot hold'):
            fs_kernel.launch_shape(*sizes, route='cluster', **kw)
    assert fs_kernel.launch_shape(950, 950, 1900).route == 'global'
    assert fs_kernel.CLUSTER_SIZES == (2, 4, 8, 16)
    assert fs_kernel.CLUSTER_VARIANTS == ((7, 28), (9, 20), (16, 12))


def test_cluster_smem_count_follows_the_source_layout():
    """The chooser's shared-memory count of the cluster route is the
    source's ``cluster_smem_floats``: the phi ring, the relayed row e + 1
    and row e's copy in each of the 3 exchange buffers, and the divided
    row (32 L each), per buffer the slots of the cluster's warps that hold
    e-e pairs (109 pairs a block: 4 warps), the ratio and row e + 1's u,
    the buffers' mbarriers, r', r before the move, the e-n deltas and log
    u (8 n), the block's positions; the inverse's rows are in registers."""
    assert fs_kernel.CLUSTER_BUFS == 3
    shape = fs_kernel.launch_shape(866, 866, 1731)
    f = ((fs_kernel.PHI_RING + 2 * 3 + 1) * 32 * shape.reg
         + 3 * (2 * 16 * 4 + 4) + 2 * 3 + 8 * 866 + 3 * 109)
    assert shape.smem_bytes == 4 * (-(-f // 4) * 4)


def test_tuner_measures_cluster_sizes_and_keeps_them_under_their_own_key(
        tmp_path):
    """At 1ZE7's blocks (n = 528) clusters of 8 and 16 hold the block: the
    tuner measures both and keeps the winner under the key with
    ``|cluster``, which ``best_launch`` then serves; at 1AMB's (n = 866)
    one size is left and is taken without measuring or storing; below
    n = 257 the rows route's parameter comes first."""
    path = tmp_path / 'tiles.json'
    calls = []

    def fake_measure(n_e, W, candidates):
        calls.append((n_e, W, tuple(candidates)))
        return candidates[-1]
    assert autotune.cluster_candidates(1056) == (8, 16)
    assert autotune.best_cluster(1056, 256, path=path,
                                 measure=fake_measure) == 16
    assert calls == [(1056, 256, (8, 16))]
    assert json.loads(path.read_text())['tiles'] == {
        '1056|256|fp32|cuda|cluster': 16}
    assert autotune.best_launch(1056, 256, path=path,
                                measure=fake_measure) == {'cluster': 16}
    assert len(calls) == 1, 'cache hit re-measured'
    assert autotune.cluster_candidates(1731) == (16,)
    assert autotune.best_launch(1731, 256, path=tmp_path / 'u.json',
                                measure=fake_measure) == {'cluster': 16}
    assert len(calls) == 1 and not (tmp_path / 'u.json').exists()
    assert 'per_row' in autotune.best_launch(434, 256, path=path,
                                             measure=lambda *a: a[2][0])


def test_tuner_cluster_measurement_picks_the_fastest_with_injected_timer():
    """The cluster tuner times each cluster size through
    ``fused_sweep_block`` (the plain loop on the CPU) and keeps the
    fastest."""
    times = iter([3.0, 1.0, 2.0])
    seen = []

    def timer(fn):
        fn()
        seen.append(None)
        return next(times)
    assert autotune._measure(6, 3, (2, 4, 8), timer=timer, device='cpu',
                             cluster=True) == 4
    assert len(seen) == 3
    assert autotune.measured_times()['6|3|fp32|cuda|cluster'] == {
        2: 3.0, 4: 1.0, 8: 2.0}


# ---------------------------------------------------------------------------
# the cluster route with CI: the held rows' maps and the replay of P
# ---------------------------------------------------------------------------
def _ci_block(n, n_orb, W, seed, mdw, spin='up'):
    """A well-conditioned spin block of n electrons with the CI expansion
    ``mdw`` over n_orb orbitals, numpy from a seed: Minv the inverse of
    D = I + 0.1 G / sqrt(n), the virtual orbitals 0.3 G, P and rdet as the
    path builds them, the proposals' phi the electron's own column plus
    noise (ratios O(1)).  Returns the operands of ``fused_sweep_ref`` and
    the lists (int64 and the kernels' padded int32)."""
    from repro_torch.core import multidet
    rng = np.random.default_rng(seed)

    def _n(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape))
                                .astype(np.float32))
    ci_t = multidet.pin(mdw, n, n, 'cpu')
    D = torch.eye(n) + _n(W, n, n, s=0.1 / np.sqrt(n))
    minv = torch.linalg.inv(D.double()).float()
    V = _n(W, n_orb - n, n, s=0.3)
    P = multidet.reference_table(torch.cat([D, V], dim=1), minv)
    holes, parts = getattr(ci_t, f'holes_{spin}'), getattr(ci_t,
                                                           f'parts_{spin}')
    phi = torch.cat([D.transpose(1, 2) + _n(W, n, n, s=0.3 / np.sqrt(n)),
                     V.transpose(1, 2) + _n(W, n, n_orb - n, s=0.1)], -1)
    r = _n(W, 2 * n, 3, s=2.0)
    return dict(
        r=r, minv=minv, sign=torch.ones(W), logdet=torch.zeros(W), phi=phi,
        r_prop=r[:, :n] + _n(W, n, 3, s=0.3), en=_n(W, n, s=0.05),
        logu=torch.from_numpy(np.log(rng.uniform(1e-6, 1.0, (W, n)))
                              .astype(np.float32)),
        P=P, rdet=multidet.det_ratios(P, holes, parts),
        r_other=1.0 + _n(W, ci_t.coeffs.shape[0], s=0.1), holes=holes,
        parts=parts, coeffs=ci_t.coeffs,
        lists_k=(getattr(ci_t, f'holes_{spin}_k'),
                 getattr(ci_t, f'parts_{spin}_k')))


def _rank_k_mdw(n, n_orb, k, seed, n_exc=24):
    """An expansion of the up block with excitations of rank 1..k."""
    from repro_torch.core.multidet import from_excitations
    rng = np.random.default_rng(seed)
    exc, seen = [((list(range(k)), list(range(n, n + k))), ([], []))], set()
    while len(exc) < n_exc:
        deg = int(rng.integers(1, k + 1))
        h = sorted(rng.choice(n, deg, replace=False).tolist())
        p = sorted((n + rng.choice(n_orb - n, deg, replace=False)).tolist())
        if repr((h, p)) not in seen:
            seen.add(repr((h, p)))
            exc.append(((h, p), ([], [])))
    coeffs = np.concatenate([[1.0], 0.2 * rng.choice([-1.0, 1.0], n_exc)])
    mdw = from_excitations(coeffs, exc, n, n, n_orb)
    assert mdw.k == k
    return mdw


def _sweep_rows(blk, moves=None, **kw):
    """The plain sweep of ``blk`` (its first ``moves`` electrons) with each
    move's new row; returns (state, accept, margin, rows (W, m, n))."""
    m = moves or blk['r_prop'].shape[1]
    rows = []
    state, acc, mar = fused_sweep_ref(
        blk['r'], blk['minv'], blk['sign'], blk['logdet'],
        blk['phi'][:, :m], blk['r_prop'][:, :m], blk['en'][:, :m],
        blk['logu'][:, :m], torch.ones(()), offset=0,
        n_up=blk['minv'].shape[1], P=kw.pop('P', blk['P']),
        rdet=blk['rdet'], rows_out=rows, **kw)
    return state, acc, mar, torch.stack(rows, dim=1)


def _water_ci_blocks():
    """Both spin blocks of a water --n-det 4 sweep from a cold start (the
    port's evaluation and fused pass on numpy draws): the down block
    starts from the up block's plain output, its r_other the up block's
    new rdet."""
    from repro_torch.systems import build_system
    cfg, params = build_system('water', n_det=4, ci_seed=2, device='cpu')
    R = torch.from_numpy(cold_start(cfg, params, 6, 11))
    ens = t_sem.evaluate_sem(cfg, params, R)
    rng = np.random.default_rng(12)
    r_prop = R + 0.3 * torch.from_numpy(rng.normal(size=R.shape)
                                        .astype(np.float32))
    logu = torch.from_numpy(np.log(rng.uniform(1e-6, 1.0, R.shape[:2]))
                            .astype(np.float32))
    en = t_sem._en_sum(params, r_prop) - t_sem._en_sum(params, R)
    phis = t_sem._fused_phi_all(cfg, params, *t_sem._mo_blocks(cfg, params),
                                r_prop)
    ci = cfg.ci_t
    n_up = cfg.n_up
    out, state, r_other = [], (R, ens.sign, ens.logdet), ens.rdet_dn
    for spin, off, sl, phi, P, rdet in (
            ('up', 0, slice(0, n_up), phis[0], ens.p_up, ens.rdet_up),
            ('dn', n_up, slice(n_up, cfg.n_elec), phis[1], ens.p_dn,
             ens.rdet_dn)):
        rows = []
        args = (getattr(ci, f'holes_{spin}'), getattr(ci, f'parts_{spin}'),
                ci.coeffs, r_other)
        res, acc, _ = fused_sweep_ref(
            state[0], getattr(ens, f'minv_{spin}'), state[1], state[2], phi,
            r_prop[:, sl], en[:, sl], logu[:, sl], params.jastrow.b_ee,
            offset=off, n_up=n_up, P=P, rdet=rdet, ci_args=args,
            rows_out=rows)
        out.append((P, torch.stack(rows, dim=1), phi, acc, res[4]))
        state, r_other = (res[0], res[2], res[3]), res[5]
    return out


@pytest.mark.parametrize('case', ['water-n_det4', 'rank2', 'rank3'])
def test_p_replay_ref_turns_the_start_table_into_the_sweeps_bitwise(case):
    """``p_replay_ref`` fed a sweep's rows (Minv[e] / ratio of each move)
    and accept flags turns the table P at the sweep's start into the P
    ``fused_sweep_ref`` returns, bit for bit (the same einsum for g, the
    same rank-1 update, product rounded first): water --n-det 4, both
    spin blocks, and synthetic blocks with n_orb > n at ranks 2 and 3.
    With a subset of the rows it updates those rows only, to the same
    values."""
    if case == 'water-n_det4':
        cases = _water_ci_blocks()
    else:
        k = int(case[-1])
        n, n_orb = 14, 30
        blk = _ci_block(n, n_orb, 5, 20 + k, _rank_k_mdw(n, n_orb, k, k))
        state, acc, mar, rows = _sweep_rows(blk, ci_args=(
            blk['holes'], blk['parts'], blk['coeffs'], blk['r_other']))
        cases = [(blk['P'], rows, blk['phi'], acc, state[4])]
        # the reference's scan on the same operands: its P within 1e-5 of
        # the walker's max of the replayed one, the same decisions
        j_state, j_acc = j_fused_ref(
            *(jnp.asarray(blk[f].numpy()) for f in (
                'r', 'minv', 'sign', 'logdet', 'phi', 'r_prop', 'en',
                'logu')), jnp.float32(1.0), offset=0, n_up=n,
            P=jnp.asarray(blk['P'].numpy()),
            rdet=jnp.asarray(blk['rdet'].numpy()), ci_args=(
                blk['holes'].numpy(), blk['parts'].numpy(),
                blk['coeffs'].numpy(), jnp.asarray(blk['r_other'].numpy())))
        assert not bool((mar.abs() < MARGIN).any())
        np.testing.assert_array_equal(acc.numpy(), _j(j_acc))
        assert np.all(_rel(p_replay_ref(blk['P'], rows, blk['phi'],
                                        acc).numpy(), _j(j_state[4]))
                      <= 1e-5)
    for P0, rows, phi, acc, want in cases:
        assert 0 < int(acc.sum()) < acc.numel()
        assert torch.equal(p_replay_ref(P0, rows, phi, acc), want)
        rep = torch.arange(1, P0.shape[1], 2)
        got = p_replay_ref(P0, rows, phi, acc, rep)
        assert torch.equal(got[:, ::2], P0[:, ::2])
        np.testing.assert_allclose(got[:, rep].numpy(), want[:, rep].numpy(),
                                   rtol=0, atol=1e-6 * float(
                                       want.abs().max()))


def _held_lists(parts, maps, n_orb):
    """The particle lists as indices of the held rows (a sentinel n_orb + s
    becomes D + s): the lists of a table that holds only those rows."""
    p = np.asarray(parts)
    slot = np.full(n_orb, -1)
    slot[maps['held']] = np.arange(maps['held'].size)
    return torch.from_numpy(np.where(p < n_orb, slot[np.minimum(p, n_orb - 1)],
                                     maps['held'].size + p - n_orb))


def _table_ext(P, p, h, n_orb, n):
    if p < n_orb:
        return P[p, h] if h < n else 0.0
    return 1.0 if h >= n and p - n_orb == h - n else 0.0


@pytest.mark.parametrize('name,n_up,n_dn,want', [
    ('1ze7', 528, 528, (66, 70)), ('1amb', 866, 865, (68, 76))])
def test_ci_maps_hold_the_paper_expansions_rows(name, n_up, n_dn, want):
    """The maps of 1ZE7's and 1AMB's seed-0 ``--n-det 100`` expansions
    (their sentinel-padded lists, as the kernels get them): 66–76 held
    rows a spin block, every determinant entry's place in the compact
    table giving P's sentinel-extended entry, each particle's slot, the
    replay's rows the rest.  A plain sweep of 40 moves on the held rows
    only (the lists remapped onto them, g from their rows) plus the replay
    of the others matches ``fused_sweep_ref`` on decisions (moves within
    1e-5 of the threshold excepted), rdet, Minv and every row of P within
    1e-5 of the walker's max (fp32 rounding: the einsums sum over other
    row sets)."""
    from repro_torch.core import multidet
    from repro_torch.kernels.fused_sweep import kernel as fsk
    from repro_torch.systems.bench import synthetic_ci
    n_orb = n_up + max(8, n_up // 2)
    mdw = synthetic_ci(n_up, n_dn, n_orb, 100, seed=0)
    ci_t = multidet.pin(mdw, n_up, n_dn, 'cpu')
    rng = np.random.default_rng(1)
    for spin, n, d_want in (('up', n_up, want[0]), ('dn', n_dn, want[1])):
        h = getattr(ci_t, f'holes_{spin}_k').numpy()
        p = getattr(ci_t, f'parts_{spin}_k').numpy()
        maps = fsk.ci_maps_np(h, p, n, n_orb)
        assert maps['held'].size == d_want
        assert np.array_equal(maps['held'], np.unique(p[p < n_orb]))
        assert np.array_equal(np.sort(np.concatenate(
            [maps['held'], maps['replay']])), np.arange(n_orb))
        P = rng.normal(size=(n_orb, n))
        tab = np.concatenate([[0.0, 1.0], P[maps['held'][maps['pair_slot']],
                                            maps['pair_hole']]])
        for d in range(h.shape[0]):
            for a in range(h.shape[1]):
                s = maps['pslot'][d, a]
                assert (s == -1) if p[d, a] >= n_orb else \
                    maps['held'][s] == p[d, a]
                for b in range(h.shape[1]):
                    assert tab[maps['ent'][d, a, b]] == _table_ext(
                        P, p[d, a], h[d, b], n_orb, n)
    maps = fsk.ci_maps_np(ci_t.holes_up_k.numpy(), ci_t.parts_up_k.numpy(),
                          n_up, n_orb)
    blk = _ci_block(n_up, n_orb, 2, 3, mdw)
    holes, parts = (x.long() for x in blk['lists_k'])
    args = (holes, parts, blk['coeffs'], blk['r_other'])
    (_, m_r, _, _, P_r, rd_r), acc_r, mar_r, _ = _sweep_rows(
        blk, 40, ci_args=args)
    held = torch.from_numpy(maps['held'])
    (_, m_h, _, _, P_h, rd_h), acc_h, mar_h, rows = _sweep_rows(
        blk, 40, P=blk['P'][:, held], p_rows=held, ci_args=(
            holes, _held_lists(parts, maps, n_orb), blk['coeffs'],
            blk['r_other']))
    tie = (mar_r.abs() < MARGIN) | (mar_h.abs() < MARGIN)
    assert torch.equal(acc_r[~tie], acc_h[~tie]) and not bool(tie.any())
    assert 0 < int(acc_h.sum()) < acc_h.numel()
    P = p_replay_ref(blk['P'], rows, blk['phi'][:, :40], acc_h,
                     torch.from_numpy(maps['replay']))
    P[:, held] = P_h
    for got, ref in ((P, P_r), (rd_h, rd_r), (m_h, m_r)):
        assert np.all(_rel(got.numpy(), ref.numpy()) <= 1e-5)


@pytest.mark.parametrize('sizes,kw', [
    ((528, 792, 1056, 792, 100, True), dict(k=9)),
    ((866, 1299, 1732, 1299, 100, True), dict(held=800)),
    ((866, 1299, 1732, 1299, 1000, True), {}),
    ((200, 300, 400, 300, 100, True), {}),
], ids=['rank9', 'held-rows-too-many', 'n_det1000', 'below-257'])
def test_launch_shape_keeps_the_global_route_where_the_chain_cannot(sizes,
                                                                    kw):
    """With CI the size's choice stays on the first design where the
    cluster route cannot take the block: past rank 8, where the held rows
    (800 of 1AMB's widths; any expansion of 1000 determinants may name
    all 1299) do not fit beside the cluster's staging, and below n = 257,
    where the first design keeps the CI blocks the rows route cannot hold
    (here its tables exceed the shared memory too)."""
    shape = fs_kernel.launch_shape(*sizes, walkers=256, **kw)
    assert shape.route == 'global'
    assert fs_kernel.cluster_shapes(*sizes, **kw) == [] or \
        sizes[0] < fs_kernel.CI_CLUSTER_FROM
