"""Whole ``sem-vmc`` runs of the port against the JAX package's, in
distribution: ``qmc_run --method sem-vmc --device cpu`` end to end and the
reference's CLI on the same settings, each energy within 3 sigma of the
other's (the two packages draw different random numbers, so only the
distribution is shared).  h2, water, and water with a 4-determinant CI
expansion; each case takes ~20 s on the CPU, most of it the reference's
compile.
"""
import numpy as np
import pytest

pytest.importorskip('torch')
pytest.importorskip('jax')

from repro.launch.qmc_run import main as j_main  # noqa: E402
from repro_torch.launch import qmc_run  # noqa: E402


def _energy(main, tmp_path, tag, system, extra):
    avg = main(['--system', system, '--method', 'sem-vmc', '--workers', '1',
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
