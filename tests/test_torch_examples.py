"""The ported examples (``examples/torch_quickstart.py``,
``examples/torch_dmc_fault_tolerant.py``) against the JAX package's
(``examples/quickstart.py``, ``examples/dmc_fault_tolerant.py``) on the
CPU.

* Quickstart, the MO paths: water built by both packages, one seeded
  walker; each of ``dense``, ``sparse`` (k_max 16) and ``kernel`` gives
  the port's E_L within rtol 1e-5 of the reference's for the same method
  (the reference's ``kernel`` is its Pallas kernel in interpret mode, the
  port's the ``sparse_mo`` kernel's plain version), and the port's three
  agree to 1e-5.
* Quickstart, the driver, cut to 64 walkers and 20 steps a block: every
  energy finite, one accept a block, E_T moved by each DMC feedback; the
  first VMC block's accept rate is the mean of its walkers' (replayed
  under the same generators) and within 3 sigma (over walkers) of the
  reference's at the same tau, walkers and steps.  DMC energies are not
  compared: at the script's tau = 0.25 both packages collapse (ROADMAP,
  "Faults of the reference").
* Without a GPU, both scripts raise unless asked for the CPU.
* Fault-tolerant: the script's spec and order of events in its
  event-driven form (worker 0 crashed once 4 blocks are stored, a worker
  joined once it has stopped, 16 blocks, then a restart for 8 more), and
  the reference's same spec and sequence through its ``build_run``: no
  worker errors, the crashed worker down, 2 of 2 restarted workers seeded
  from the reservoir, run 2 extending run 1's store, and the final
  energies within 3 sigma of each other.  Four thread workers share the
  GIL, which bounds the depth here: ~2 blocks/s on the port's side.
"""
import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')

from repro.core import vmc as j_vmc  # noqa: E402
from repro.core.wavefunction import psi_state as j_psi_state  # noqa: E402
from repro.launch.spec import RunSpec as JRunSpec  # noqa: E402
from repro.launch.spec import build_run as j_build_run  # noqa: E402
from repro.systems.molecule import build_wavefunction as j_build  # noqa: E402
from repro.systems.molecule import water as j_water  # noqa: E402
from repro_torch.core.vmc import VMCPropagator  # noqa: E402
from repro_torch.core.driver import Population  # noqa: E402
from repro_torch.systems.molecule import build_wavefunction, water  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WALKERS, STEPS, TAU = 64, 20, 0.25
# the fault-tolerant sequence's depth (the script's: 15 s, 5 s, 200, +100)
KILL_AT, MAX_BLOCKS, EXTRA = 4, 16, 8


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / 'examples' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


quickstart = _example('torch_quickstart')
fault_tolerant = _example('torch_dmc_fault_tolerant')


@pytest.mark.parametrize('example', ['quickstart', 'fault_tolerant'])
def test_examples_refuse_to_fall_back_to_cpu(example):
    """Without a GPU either script raises unless asked for the CPU (its
    CPU runs are the cases below)."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is valid here')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        {'quickstart': quickstart, 'fault_tolerant': fault_tolerant}[
            example].main()


@pytest.fixture(scope='module')
def both_waters():
    return (build_wavefunction(*water(), method='dense', device='cpu'),
            j_build(*j_water(), method='dense'))


def test_three_mo_paths_match_the_reference(both_waters):
    import dataclasses
    (cfg, params), (jcfg, jparams) = both_waters
    r = np.random.default_rng(0).normal(size=(cfg.n_elec, 3)) * 1.2
    r = r.astype(np.float32)
    got = quickstart.method_consistency(cfg, params, torch.from_numpy(r))
    assert list(got) == ['dense', 'sparse', 'kernel']
    for method, kw in quickstart.MO_PATHS:
        jc = dataclasses.replace(jcfg, method=method, **kw)
        want = float(j_psi_state(jc, jparams, r).e_loc)
        assert math.isfinite(want)
        np.testing.assert_allclose(got[method], want, rtol=1e-5,
                                   err_msg=method)
    np.testing.assert_allclose([got['sparse'], got['kernel']],
                               [got['dense']] * 2, rtol=1e-5)


def _port_first_block_accepts(cfg, params):
    """Per-walker accept fractions of the quickstart's first VMC block,
    replayed: its init and block generators (seeds 1 and 10), step by
    step as ``EnsembleDriver.run_block`` runs them."""
    prop = VMCPropagator(cfg, tau=TAU)
    ens = prop.init(params, quickstart._gen(1, 'cpu'), WALKERS)
    gen = quickstart._gen(10, 'cpu')
    acc = []
    for _ in range(STEPS):
        ens, a = prop.step(params, ens, gen, Population())
        acc.append(a.to(torch.float32).numpy())
    return np.mean(acc, axis=0)


def _reference_first_block_accepts(jcfg, jparams):
    """The reference's per-walker accept fractions over its first VMC
    block at the same tau, walkers and steps (its keys 1 and 10 + i)."""
    ens = j_vmc.VMCPropagator(jcfg, tau=TAU).init(
        jparams, jax.random.PRNGKey(1), WALKERS)
    step = jax.jit(functools.partial(j_vmc.vmc_step, jcfg, tau=TAU))
    acc = []
    for i in range(STEPS):
        ens, a = step(jparams, ens, jax.random.fold_in(
            jax.random.PRNGKey(10), i))
        acc.append(np.asarray(a, np.float32))
    return np.mean(acc, axis=0)


def test_quickstart_driver_and_its_first_vmc_accept(both_waters):
    (cfg, params), (jcfg, jparams) = both_waters
    out = quickstart.main(device='cpu', n_walkers=WALKERS, steps=STEPS,
                          vmc_blocks=2, dmc_blocks=2)
    assert sorted(out['e_loc']) == ['dense', 'kernel', 'sparse']
    assert len(out['vmc']) == 2 and len(out['dmc']) == 2
    for b in out['vmc'] + out['dmc']:
        assert math.isfinite(b['e']) and 0.0 <= b['accept'] <= 1.0, b
    for k in ('e_vmc', 'e_dmc', 'e_dmc_err'):
        assert math.isfinite(out[k]), (k, out[k])
    # E_T before each DMC block and after the last feedback: every
    # feedback moves it
    et = out['e_trial']
    assert len(et) == 3 and et[0] == pytest.approx(out['e_vmc'], rel=1e-6)
    assert all(a != b for a, b in zip(et, et[1:])), et

    a_t = _port_first_block_accepts(cfg, params)
    assert float(a_t.mean()) == pytest.approx(out['vmc'][0]['accept'],
                                              abs=1e-6)
    a_j = _reference_first_block_accepts(jcfg, jparams)
    sigma = math.hypot(a_t.std(ddof=1), a_j.std(ddof=1)) / math.sqrt(WALKERS)
    assert sigma > 0
    assert abs(a_t.mean() - a_j.mean()) <= 3 * sigma, (a_t.mean(),
                                                        a_j.mean(), sigma)


def _reference_fault_tolerant(db):
    """The JAX script's spec and order of events through the reference's
    ``build_run``, in the port's event-driven form."""
    spec = JRunSpec(system='h2', method='dmc', e_trial=-1.17,
                    equil_steps=60, n_walkers=24, steps=25,
                    backend='thread', n_workers=4, subblocks_per_block=2,
                    max_blocks=MAX_BLOCKS, poll_interval=0.1, db=str(db))
    run = j_build_run(spec)
    mgr = run.manager
    mgr.start()
    fault_tolerant._wait_for(
        lambda: run.db.n_blocks(run.run_key) >= KILL_AT, 'blocks')
    killed = mgr.workers[0]
    mgr.remove_worker(killed, graceful=False)
    fault_tolerant._wait_for(lambda: not killed.running, 'stop')
    mgr.add_worker()
    avg1 = mgr.run()
    errors1 = run.worker_errors()
    run2 = j_build_run(spec.replace(n_workers=2,
                                    max_blocks=avg1.n_blocks + EXTRA))
    run2.manager.start()
    restarted = sum(w.init_walkers is not None for w in run2.manager.workers)
    avg2 = run2.manager.run()
    for w in run.manager.workers + run2.manager.workers:
        w.join(None)
    return dict(avg1=avg1, avg2=avg2, restarted=restarted,
                run_keys=(run.run_key, run2.run_key),
                killed_running=killed.running,
                errors=errors1 + run2.worker_errors())


def test_fault_tolerant_sequence_matches_the_reference(tmp_path):
    out = fault_tolerant.main(device='cpu', kill_at_blocks=KILL_AT,
                              join_after=0.0, max_blocks=MAX_BLOCKS,
                              extra_blocks=EXTRA,
                              db=tmp_path / 'torch.sqlite')
    ref = _reference_fault_tolerant(tmp_path / 'jax.sqlite')
    assert not ref['errors'], ref['errors']
    for side in (out, ref):
        avg1, avg2 = side['avg1'], side['avg2']
        assert not side['killed_running']
        assert side['restarted'] == 2
        assert side['run_keys'][0] == side['run_keys'][1]   # one store
        assert avg1.n_blocks >= MAX_BLOCKS
        assert avg2.n_blocks >= avg1.n_blocks + EXTRA
        assert math.isfinite(avg2.energy) and avg2.error > 0
    assert out['blocks_at_kill'] >= KILL_AT
    t = out['t']
    assert t['start'] < t['kill'] <= t['join'] < t['end']
    sigma = math.hypot(out['avg2'].error, ref['avg2'].error)
    assert abs(out['avg2'].energy - ref['avg2'].energy) <= 3 * sigma, (
        out['avg2'], ref['avg2'])
