"""Mixed-precision storage of the PyTorch port against the JAX package.

With ``cfg.precision`` in ('bf16', 'fp16') the maintained sweep inverses
and CI P-tables REST in the low dtype and every move, corrector, refresh
and energy computes in fp32 (``core.sem._to_compute`` /
``_to_storage``).  Case for case as the reference's
``tests/test_precision.py``: the policy tables, fp32 structurally inert
(the casts return the tensor itself; an explicit 'fp32' walks bitwise like
the default), quantized state, the spin-boundary electron, h2 energies at
bf16/fp16 within 3 sigma of fp32, the run key, and the refusals.

In place of the reference's drift test (marginal: which walker leaves the
per-dtype bound depends on the machine), two checks:

* **One sweep against the reference under its draws**, water and water
  ``n_det=4``, W = 8, bf16 and fp16, per move (``sem-vmc``) and fused
  (``fused-vmc``): from the reference's quantized ``evaluate_sem``
  (handed over through float32 numpy, which is exact for bf16 and for
  fp16 x 16), one ``propagate`` of each package.  Accept decisions
  identical except moves within 1e-5 of the threshold; positions equal;
  every stored inverse and P-table entry within one step of the storage
  dtype at the reference's value (``torch.nextafter`` in that dtype); on
  the walkers without a near tie, as the fp32 parity tests hold them;
  logdet and the local energy within those tests' fp32 tolerances.
* **Drift against a fresh fp64 recompute** after ``sem_refresh - 1``
  sweeps: the stored inverses under ``slater.drift_tolerance``'s relative
  bound, in the reference's metric (relative to the spin block's largest
  entry over the walkers held), and the sign exact, on the walkers the
  policy resolves at every storage boundary of their path: the fresh
  fp32 inverse within ``FP32_SCOPE`` = 1e-5 of fp64 (``chip_smoke.py``'s
  rule), and the same rule at the storage precision (that inverse stored
  once and refined once within a tenth of the bound of fp64; an fp16
  entry past fp16's range x 16 stores inf, and one refinement of a
  rounded inverse does not converge on a block whose condition number
  exceeds the dtype's inverse roundoff).  The test prints how many
  walkers are in scope and fails if none are.

  The table's other half, the running logdet within an absolute bound, is
  printed and not asserted: it is not a bound of the policy.  The running
  logdet sums log|ratio| of moves whose ratios come from the quantized
  inverse, and the corrector refines the inverse but never the logdet, so
  one badly conditioned move on a walker's path (a ratio with
  cancellation, near a node) leaves an error of the storage dtype's
  roundoff times its condition.  Water, 6 cold starts x 8 walkers x 7
  sweeps, fp32-resolved walkers: 5 of 96 exceed the bf16 bound (0.2) and
  11 of 96 the fp16 one (0.025), while the same sweeps at fp32 stay within
  1e-5 of fp64; the reference exceeds it the same way (its own drift test
  fails on this half).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.core import sem as j_sem  # noqa: E402
from repro.core import slater as j_slater  # noqa: E402
from repro.core.driver import Population as JPopulation  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402

from repro_torch.core import sem as t_sem  # noqa: E402
from repro_torch.core import slater as t_slater  # noqa: E402
from repro_torch.core.driver import Population  # noqa: E402
from repro_torch.core.wavefunction import (_mo_tensor_ensemble,  # noqa: E402
                                           _slater_blocks)
from repro_torch.systems.convert import from_numpy  # noqa: E402

LOW = ('bf16', 'fp16')
W = 8
MARGIN = 1e-5
FP32_SCOPE = 1e-5
STORED = ('minv_up', 'minv_dn', 'p_up', 'p_dn')


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


def cold_start(cfg, W, seed, coords, charges):
    """Electrons around charge-weighted random nuclei, from numpy."""
    rng = np.random.default_rng(seed)
    at = rng.choice(len(charges), (W, cfg.n_elec), p=charges / charges.sum())
    return (coords[at] + rng.normal(size=(W, cfg.n_elec, 3))
            ).astype(np.float32)


def _f32(x):
    """A JAX array of any dtype (bf16 and fp16 included) as float32 numpy."""
    return np.array(jnp.asarray(x, jnp.float32))


def _sem_draws(key, W, n_e):
    """The reference's sweep draws (``sem.py`` per move and fused alike):
    walker key -> fold_in(j) -> split -> normal(3,), uniform()."""
    wkeys = JPopulation().walker_keys(key, W)

    def _one(k, j):
        ke, ku = jax.random.split(jax.random.fold_in(k, j))
        return (jax.random.normal(ke, (3,), jnp.float32),
                jax.random.uniform(ku, (), jnp.float32))
    eta, u = jax.vmap(lambda k: jax.vmap(lambda j: _one(k, j))(
        jnp.arange(n_e)))(wkeys)
    return torch.from_numpy(np.array(eta)), torch.from_numpy(np.array(u))


def _port_ensemble(ens_j, precision):
    """The reference's (quantized) SEMEnsemble as the port's: through
    float32 numpy, the stored fields back in the storage dtype (exact)."""
    dt = t_slater.storage_dtype(precision)
    return t_sem.SEMEnsemble(**{
        f: torch.from_numpy(_f32(getattr(ens_j, f))).to(
            dt if f in STORED else torch.float32)
        for f in t_sem.SEMEnsemble._fields})


def _steps(a, b):
    """|a - b| in steps of b's storage dtype at b (one step: the distance
    from b to the next representable value away from zero)."""
    up = torch.nextafter(b, torch.where(b < 0, -torch.inf, torch.inf)
                         .to(b.dtype))
    return ((a.double() - b.double()).abs()
            / (up.double() - b.double()).abs())


@pytest.fixture(scope='module')
def water_jax():
    return j_build_system('water')


@pytest.fixture(scope='module')
def water_t(water_jax):
    return port_of(*water_jax, method='kernel')


# ---------------------------------------------------------------------------
# policy tables, inertness, quantized state, refusals
# ---------------------------------------------------------------------------
def test_policy_tables_match_the_reference():
    assert t_slater.PRECISIONS == j_slater.PRECISIONS
    for p in t_slater.PRECISIONS:
        dt = t_slater.storage_dtype(p)
        assert str(dt).split('.')[-1] == jnp.dtype(
            j_slater.storage_dtype(p)).name
        assert t_slater.precision_bytes(p) == j_slater.precision_bytes(p) \
            == torch.empty((), dtype=dt).element_size()
        assert t_slater.drift_tolerance(p) == j_slater.drift_tolerance(p)
        for n_up, n_dn, w in ((79, 79, 256), (5, 5, 8), (1, 0, 3)):
            b = t_slater.precision_bytes(p)
            assert t_slater.state_bytes(n_up, n_dn, w, b) == \
                j_slater.state_bytes(n_up, n_dn, w, b)
    assert t_sem._FP16_SCALE == j_sem._FP16_SCALE == 16.0


def test_fp32_policy_is_structurally_inert(water_t):
    cfg, params = water_t
    assert cfg.precision == 'fp32'
    x = torch.ones((2, 3, 3))
    assert t_sem._to_compute(x, cfg) is x
    assert t_sem._to_storage(x, cfg) is x
    R = torch.from_numpy(cold_start(cfg, 4, 0, params.coords.numpy(),
                                    params.charges.numpy()))
    ens = t_sem.evaluate_sem(cfg, params, R)
    assert ens.minv_up.dtype == ens.minv_dn.dtype == torch.float32


@pytest.mark.parametrize('method', ['sem-vmc', 'fused-vmc'])
def test_fp32_spec_walks_bitwise_like_the_default(method):
    """A run whose spec spells out precision='fp32' gives, block for block,
    bitwise the sampler state of the default spec, under the same key."""
    from repro_torch.launch.spec import RunSpec, build_run
    states = []
    for kw in ({}, dict(precision='fp32')):
        run = build_run(RunSpec(system='water', method=method, n_walkers=4,
                                steps=2, n_workers=1, device='cpu', **kw))
        assert run.cfg.precision == 'fp32'
        s = run.sampler
        st = s.init_state(0, 1)
        st, *_ = s.run_subblock(st, 0)
        st, *_ = s.run_subblock(st, 1)
        states.append(st[1].ens)
    for a, b in zip(*states):
        assert torch.equal(a, b)


@pytest.mark.parametrize('precision', LOW)
def test_low_precision_state_is_quantized(water_jax, water_t, precision):
    """bf16/fp16 resting inverses carry the storage dtype; positions, sign
    and logdet stay float32; each stored entry is within one step of the
    reference's stored value on the same walkers."""
    cfg_j, params_j = water_jax
    cfg, params = water_t
    cfg = dataclasses.replace(cfg, precision=precision)
    R = cold_start(cfg, 4, 0, params.coords.numpy(), params.charges.numpy())
    ens = t_sem.evaluate_sem(cfg, params, torch.from_numpy(R))
    want = t_slater.storage_dtype(precision)
    assert ens.minv_up.dtype == want and ens.minv_dn.dtype == want
    for f in ('r', 'sign', 'logdet', 'log_psi', 'e_loc'):
        assert getattr(ens, f).dtype == torch.float32, f
    ref = _port_ensemble(j_sem.evaluate_sem(
        dataclasses.replace(cfg_j, precision=precision), params_j,
        jnp.asarray(R)), precision)
    for f in ('minv_up', 'minv_dn'):
        assert float(_steps(getattr(ens, f), getattr(ref, f)).max()) <= 1
    # one rounding of the fp32 state; the fp16 shift is exact both ways
    fresh = t_sem.evaluate_sem(dataclasses.replace(cfg, precision='fp32'),
                               params, torch.from_numpy(R))
    for f in ('minv_up', 'minv_dn'):
        stored = getattr(ens, f)
        assert torch.equal(stored, t_sem._to_storage(getattr(fresh, f), cfg))
        back = t_sem._to_compute(stored, cfg)
        assert back.dtype == torch.float32
        assert torch.equal(t_sem._to_storage(back, cfg), stored)


@pytest.mark.parametrize('precision', LOW)
def test_low_precision_multidet_tables_quantized(precision):
    from repro_torch.systems import build_system
    cfg, params = build_system('water', n_det=4, ci_seed=3, device='cpu')
    cfg = dataclasses.replace(cfg, precision=precision)
    R = torch.from_numpy(cold_start(cfg, 3, 0, params.coords.numpy(),
                                    params.charges.numpy()))
    ens = t_sem.evaluate_sem(cfg, params, R)
    want = t_slater.storage_dtype(precision)
    assert ens.p_up.dtype == want and ens.p_dn.dtype == want
    assert ens.rdet_up.dtype == ens.rdet_dn.dtype == torch.float32


def test_unknown_precision_and_sharding_are_refused(water_t):
    from repro_torch.launch.spec import RunSpec
    with pytest.raises(ValueError, match='precision'):
        RunSpec(system='h2', precision='fp8')
    with pytest.raises(ValueError, match='thread or sim'):
        RunSpec(system='h2', shards=2, backend='process')
    RunSpec(system='h2', shards=1)
    with pytest.raises(ValueError, match='precision'):
        dataclasses.replace(water_t[0], precision='fp8')


# ---------------------------------------------------------------------------
# the spin-boundary electron
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('precision', LOW)
def test_spin_boundary_electron_mixed_precision(water_jax, water_t,
                                                precision):
    """One trial of exactly electron j = n_up from quantized storage, the
    dn-block inverse read through the compute boundary: the same decision
    as the reference's under its draws, only that electron moves, and the
    inverse tracks a fresh fp64 one within the dtype's contract."""
    cfg_j, params_j = water_jax
    cfg, params = water_t
    cfg_j = dataclasses.replace(cfg_j, precision=precision)
    cfg = dataclasses.replace(cfg, precision=precision)
    R = cold_start(cfg, W, 3, params.coords.numpy(), params.charges.numpy())
    ens_j = j_sem.evaluate_sem(cfg_j, params_j, jnp.asarray(R))
    key = jax.random.PRNGKey(5)
    wkeys = JPopulation().walker_keys(key, W)
    _, A_dn_j = j_sem._mo_blocks(cfg_j, params_j)
    carry_j = (ens_j.r, j_sem._to_compute(ens_j.minv_dn, cfg_j), ens_j.sign,
               ens_j.logdet)
    (r_j, _, _, _), _ = j_sem._sweep_spin_block(
        cfg_j, params_j, A_dn_j, cfg.n_up, 1, wkeys, 0.5, carry_j)

    ens = _port_ensemble(ens_j, precision)
    assert ens.minv_dn.dtype == t_slater.storage_dtype(precision)
    _, A_dn = t_sem._mo_blocks(cfg, params)
    # the sweep's own buffers (a sweep may update them in place)
    carry = tuple(x.clone() for x in (
        ens.r, t_sem._to_compute(ens.minv_dn, cfg), ens.sign, ens.logdet))
    (r2, minv_dn, sign, logdet), acc, mar = t_sem._sweep_spin_block(
        cfg, params, A_dn, cfg.n_up, 1, _sem_draws(key, W, cfg.n_elec), 0.5,
        carry)
    moved = (r2.numpy() != R).any(-1)
    assert moved.any(), 'no move accepted'
    assert not np.delete(moved, cfg.n_up, axis=1).any()
    clear = mar[0].abs().numpy() >= MARGIN
    np.testing.assert_array_equal(moved[clear, cfg.n_up],
                                  (_f32(r_j) != R).any(-1)[clear, cfg.n_up])
    Cw, _ = _mo_tensor_ensemble(cfg, params, r2)
    D = _slater_blocks(cfg, Cw)[1][..., 0].double()
    exact = torch.linalg.inv(D)
    rel, abs_ld = t_slater.drift_tolerance(precision)
    assert float((minv_dn.double() - exact).abs().max()
                 / exact.abs().max().clamp(min=1.0)) <= rel
    fresh = t_sem.evaluate_sem(dataclasses.replace(cfg, precision='fp32'),
                               params, r2)
    assert float((logdet - fresh.logdet).abs().max()) <= abs_ld
    assert torch.equal(sign, fresh.sign)


# ---------------------------------------------------------------------------
# one sweep against the reference, under its draws
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def water_ci():
    cfg, params = j_build_system('water', n_det=4, ci_seed=3)
    return cfg, params, port_of(cfg, params, method='kernel')


@pytest.mark.parametrize('path', ['sem-vmc', 'fused-vmc'])
@pytest.mark.parametrize('precision', LOW)
@pytest.mark.parametrize('n_det', [1, 4], ids=['water', 'water-n_det4'])
def test_one_sweep_matches_the_reference_under_its_draws(
        water_jax, water_t, water_ci, n_det, precision, path):
    if n_det == 1:
        (cfg_j, params_j), (cfg, params) = water_jax, water_t
    else:
        cfg_j, params_j, (cfg, params) = water_ci
    cfg_j = dataclasses.replace(cfg_j, precision=precision)
    cfg = dataclasses.replace(cfg, precision=precision)
    if path == 'fused-vmc':
        cfg_j, cfg = j_sem._fused_cfg(cfg_j), t_sem._fused_cfg(cfg)
        assert cfg.method == 'fused-kernel'
    R = cold_start(cfg, W, 0, params.coords.numpy(), params.charges.numpy())
    key = jax.random.PRNGKey(9)
    ens_j = jax.jit(functools.partial(j_sem.evaluate_sem, cfg_j))(
        params_j, jnp.asarray(R))
    prop_j = j_sem.SEMVMCPropagator(cfg_j, step_size=0.4)
    st_j, _ = jax.jit(functools.partial(prop_j.propagate,
                                        pop=JPopulation()))(
        params_j, j_sem.SEMState(ens=ens_j, sweeps=jnp.int32(0)), key)

    state = t_sem.SEMState(ens=_port_ensemble(ens_j, precision), sweeps=0)
    draws = _sem_draws(key, W, cfg.n_elec)
    prop = t_sem.SEMVMCPropagator(cfg, step_size=0.4)
    *_, acc, mar = prop.sweep(params, state, None, draws)
    st, out = prop.propagate(params, state, None, Population(), draws)
    ens = st.ens

    # decisions, walker by walker up to the first near tie
    moved_j = (_f32(st_j.ens.r) != R).any(-1).T           # (n_e, W)
    tie = mar.abs().numpy() < MARGIN
    held = ~tie.any(0)
    assert held.sum() >= W // 2, f'{int((~held).sum())} walkers tied'
    np.testing.assert_array_equal(acc.numpy()[:, held], moved_j[:, held])
    assert 0.0 < float(out[2]) < 1.0
    print(f'{path} {precision} n_det={n_det}: {int(held.sum())} of {W} '
          f'walkers held (no move within {MARGIN})')

    np.testing.assert_allclose(ens.r.numpy()[held], _f32(st_j.ens.r)[held],
                               rtol=0, atol=1e-5)
    ref = _port_ensemble(st_j.ens, precision)
    for f in STORED:
        a, b = getattr(ens, f), getattr(ref, f)
        assert a.dtype == t_slater.storage_dtype(precision), f
        if not b.numel():
            continue
        assert bool(torch.isfinite(b[held]).all()), f
        worst = float(_steps(a[held], b[held]).max())
        assert worst <= 1, (f, worst)
    np.testing.assert_allclose(ens.logdet.numpy()[held],
                               _f32(st_j.ens.logdet)[held], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(ens.sign.numpy(), _f32(st_j.ens.sign))
    np.testing.assert_allclose(ens.e_loc.numpy()[held],
                               _f32(st_j.ens.e_loc)[held], rtol=1e-4,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# drift against a fresh fp64 recompute, on the walkers fp32 resolves
# ---------------------------------------------------------------------------
def _walker_rel(a, b):
    """Per walker max |a - b| relative to the walker's max |b| (float64)."""
    a, b = a.double(), b.double()
    return ((a - b).abs().flatten(1).amax(1)
            / b.abs().flatten(1).amax(1))


def _resolved(cfg, params, R):
    """Which walkers the policy can hold at R, and the fp64 state there.

    A walker is resolved when, in both spin blocks, its fresh fp32 inverse
    is within ``FP32_SCOPE`` of the fp64 inverse of the same fp32 matrix,
    and that inverse stored once in the policy's dtype and refined once
    (the corrector) is within a tenth of the policy's bound of fp64 (the
    same rule at the storage precision: an fp16 entry past its range
    stores inf, and a block so ill-conditioned that one refinement of the
    rounded inverse does not converge is out).  Returns (mask (W,),
    {block: fp64 inverse}, fp64 logdet, fp64 sign)."""
    Cw, _ = _mo_tensor_ensemble(cfg, params, R)
    fresh = t_sem.evaluate_sem(dataclasses.replace(cfg, precision='fp32'),
                               params, R)
    rel = t_slater.drift_tolerance(cfg.precision)[0]
    ok = torch.ones(R.shape[0], dtype=torch.bool)
    exact, ld64, sign64 = {}, 0.0, 1.0
    for f, blk in zip(('minv_up', 'minv_dn'), _slater_blocks(cfg, Cw)):
        D = blk[..., 0]
        exact[f] = torch.linalg.inv(D.double())
        s, ld = torch.linalg.slogdet(D.double())
        ld64, sign64 = ld64 + ld, sign64 * s
        m32 = getattr(fresh, f)
        held = t_slater.refine_inverse(D, t_sem._to_compute(
            t_sem._to_storage(m32, cfg), cfg))
        ok &= _walker_rel(m32, exact[f]) <= FP32_SCOPE
        ok &= _walker_rel(held, exact[f]) <= rel / 10
    return ok, exact, ld64, sign64


@pytest.mark.parametrize('path', ['sem-vmc', 'fused-vmc'])
@pytest.mark.parametrize('precision', LOW)
@pytest.mark.parametrize('n_det', [1, 4], ids=['water', 'water-n_det4'])
def test_drift_against_fp64_on_the_walkers_fp32_resolves(n_det, precision,
                                                         path):
    from repro_torch.core.driver import make_propagator
    from repro_torch.systems import build_system
    cfg, params = build_system('water', n_det=n_det, ci_seed=3, device='cpu')
    prop = make_propagator(path, dataclasses.replace(cfg, precision=precision),
                           tau=0.4)
    gen = torch.Generator().manual_seed(0)
    st = prop.init(params, gen, W, walkers=cold_start(
        cfg, W, 5, params.coords.numpy(), params.charges.numpy()))
    # in scope: resolved at every storage boundary of the walker's path
    scope = _resolved(prop.cfg, params, st.ens.r)[0]
    for _ in range(cfg.sem_refresh - 1):
        st, _ = prop.propagate(params, st, gen, Population())
        ok, exact, ld64, sign64 = _resolved(prop.cfg, params, st.ens.r)
        scope &= ok
    assert st.sweeps == cfg.sem_refresh - 1
    n_in = int(scope.sum())
    rel, abs_ld = t_slater.drift_tolerance(precision)
    dl = (st.ens.logdet.double() - ld64).abs()
    print(f'{path} {precision} n_det={n_det}: {n_in} of {W} walkers in '
          f'scope; running logdet vs fp64 (bound {abs_ld}, not asserted): '
          f'{[f"{x:.1e}" for x in dl.tolist()]}')
    assert n_in >= 1, 'no walker in scope'
    for f, b in exact.items():
        a = t_sem._to_compute(getattr(st.ens, f), prop.cfg).double()[scope]
        b = b[scope]
        assert float((a - b).abs().max()
                     / b.abs().max().clamp(min=1.0)) <= rel, f
    assert torch.equal(st.ens.sign.double()[scope], sign64[scope])


# ---------------------------------------------------------------------------
# whole runs and the run key
# ---------------------------------------------------------------------------
def _run(precision, **kw):
    from repro_torch.launch.spec import RunSpec, build_run
    spec = RunSpec(system='h2', method='fused-vmc', precision=precision,
                   max_blocks=4, n_walkers=8, steps=10, n_workers=1,
                   device='cpu', **kw)
    return build_run(spec).run()


@pytest.mark.parametrize('precision', LOW)
def test_h2_energy_within_3sigma_of_fp32(precision):
    ref = _run('fp32')
    low = _run(precision)
    assert np.isfinite(low.energy) and low.error > 0
    sigma = np.hypot(ref.error, low.error)
    assert abs(low.energy - ref.energy) <= 3.0 * sigma, \
        (precision, low.energy, ref.energy, sigma)


def test_precision_enters_run_key(tmp_path):
    """bf16/fp16/fp32 specs get three distinct keys; the fp32 key is the
    one a spec without the field had: no precision entry."""
    from repro_torch.launch.spec import RunSpec, build_run
    from repro_torch.runtime.database import critical_data_key
    keys = {}
    for p in ('fp32',) + LOW:
        run = build_run(RunSpec(system='h2', method='fused-vmc', precision=p,
                                max_blocks=1, n_walkers=4, steps=2,
                                n_workers=1, device='cpu',
                                db=str(tmp_path / f'{p}.sqlite')))
        keys[p] = run.run_key
        base = dict(system='h2', method='fused-vmc', tau=0.3,
                    mo=run.params.mo.numpy(),
                    coords=run.params.coords.numpy(), impl='torch')
        extra = {} if p == 'fp32' else dict(precision=p)
        assert run.run_key == critical_data_key(**base, **extra)
    assert len(set(keys.values())) == 3
    default = build_run(RunSpec(system='h2', method='fused-vmc',
                                n_workers=1, device='cpu'))
    assert default.run_key == keys['fp32']


def test_qmc_run_cli_takes_precision(capsys):
    from repro_torch.launch import qmc_run
    spec = qmc_run.parse_spec(['--precision', 'bf16', '--device', 'cpu'])
    assert spec.precision == 'bf16'
    assert qmc_run.parse_spec([]).precision == 'fp32'
    with pytest.raises(SystemExit):
        qmc_run.parse_spec(['--precision', 'fp8'])
    avg = qmc_run.main(['--system', 'h2', '--method', 'sem-vmc',
                        '--precision', 'fp16', '--device', 'cpu',
                        '--workers', '1', '--walkers', '8', '--steps', '3',
                        '--blocks', '2'])
    assert np.isfinite(avg.energy) and avg.n_blocks >= 2
