"""Whole runs of the port against the JAX package's, in distribution:
``qmc_run --method M --device cpu`` end to end and the reference's CLI on
the same settings, each energy within 3 sigma of the other's (the two
packages draw different random numbers, so only the distribution is
shared).  ``sem-vmc`` on h2, water, and water with a 4-determinant CI
expansion; ``fused-vmc`` on water and water with the 4-determinant
expansion; all-electron ``vmc`` on h2 and water (DMC's equilibration);
``dmc`` on h2 (with its cold-start equilibration and the manager's E_T
feedback).  Each case takes ~20 s on the CPU, most of it the reference's
compile.

All-electron ``vmc`` on water is the exception to one run a package: from
a cold start its walkers keep a heavy tail of local energies (a 10-e-
all-electron move around the O core), and the seed-to-seed scatter of a
run's energy is tens of times its block error bar in both packages (seeds
4-6 at tau 0.01, 8 blocks: -201.7, -51.9, -61.8 Ha against errors of
~1.5).  So that case runs three seeds on each side and holds the two means
to 3 sigma of their scatter across seeds.
"""
import numpy as np
import pytest

pytest.importorskip('torch')
pytest.importorskip('jax')

from repro.launch.qmc_run import main as j_main  # noqa: E402
from repro_torch.launch import qmc_run  # noqa: E402


def _energy(main, tmp_path, tag, system, extra, method='sem-vmc'):
    avg = main(['--system', system, '--method', method, '--workers', '1',
                '--walkers', '48', '--steps', '15', '--blocks', '8',
                '--seed', '3', '--db', str(tmp_path / f'{tag}.sqlite'),
                *extra])
    assert np.isfinite(avg.energy) and avg.n_blocks >= 8
    return avg


@pytest.mark.parametrize('system,extra', [('h2', ()), ('water', ()),
                                          ('water', ('--n-det', '4'))],
                         ids=['h2', 'water', 'water-n_det4'])
def test_qmc_run_sem_vmc_on_cpu_within_3_sigma_of_jax(tmp_path, system,
                                                      extra):
    t_avg = _energy(qmc_run.main, tmp_path, 'torch', system,
                    ('--device', 'cpu', *extra))
    j_avg = _energy(j_main, tmp_path, 'jax', system, extra)
    sigma = np.hypot(t_avg.error, j_avg.error)
    assert sigma > 0
    assert abs(t_avg.energy - j_avg.energy) <= 3 * sigma, (t_avg, j_avg)


@pytest.mark.parametrize('extra', [(), ('--n-det', '4')],
                         ids=['water', 'water-n_det4'])
def test_qmc_run_fused_vmc_on_cpu_within_3_sigma_of_jax(tmp_path, extra):
    t_avg = _energy(qmc_run.main, tmp_path, 'torch', 'water',
                    ('--device', 'cpu', *extra), 'fused-vmc')
    j_avg = _energy(j_main, tmp_path, 'jax', 'water', extra, 'fused-vmc')
    sigma = np.hypot(t_avg.error, j_avg.error)
    assert sigma > 0
    assert abs(t_avg.energy - j_avg.energy) <= 3 * sigma, (t_avg, j_avg)


@pytest.mark.parametrize('system,method', [('h2', 'vmc'), ('water', 'vmc'),
                                           ('h2', 'dmc')],
                         ids=['h2-vmc', 'water-vmc', 'h2-dmc'])
def test_qmc_run_vmc_dmc_on_cpu_within_3_sigma_of_jax(tmp_path, system,
                                                      method):
    if system == 'water':
        es = {}
        for tag, main, dev in (('torch', qmc_run.main, ('--device', 'cpu')),
                               ('jax', j_main, ())):
            es[tag] = [main(['--system', system, '--method', method,
                             '--workers', '1', '--walkers', '32',
                             '--steps', '10', '--blocks', '4',
                             '--seed', str(seed), '--tau', '0.01',
                             '--db', str(tmp_path / f'{tag}{seed}.sqlite'),
                             *dev]).energy for seed in (4, 5, 6)]
            assert np.all(np.isfinite(es[tag])), es
        t_e, j_e = (np.asarray(es[k]) for k in ('torch', 'jax'))
        sigma = np.hypot(t_e.std(ddof=1), j_e.std(ddof=1)) / np.sqrt(3)
        assert abs(t_e.mean() - j_e.mean()) <= 3 * sigma, es
        return
    t_avg = _energy(qmc_run.main, tmp_path, 'torch', system,
                    ('--device', 'cpu'), method)
    j_avg = _energy(j_main, tmp_path, 'jax', system, (), method)
    sigma = np.hypot(t_avg.error, j_avg.error)
    assert sigma > 0
    assert abs(t_avg.energy - j_avg.energy) <= 3 * sigma, (t_avg, j_avg)
