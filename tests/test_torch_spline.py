"""The tricubic MO-interpolation baseline of the PyTorch port
(``repro_torch.core.spline``) against the JAX package's.

* the reference's three cases (``tests/test_spline.py``) on the port:
  Catmull-Rom exact on quadratics, the molecular interpolation
  converging to the direct computation, the table outgrowing the MO
  coefficients;
* ``build_mo_grid`` and ``interp_mo_block`` on water against
  ``repro.core.spline``'s, 16^3 and 24^3 grids at seeded points: within
  1e-5 relative to the largest entry (each component).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.core import spline as j_spline  # noqa: E402
from repro.systems import build_system as j_build_system  # noqa: E402

from repro_torch.core import aos, mos, spline  # noqa: E402
from repro_torch.systems import build_system  # noqa: E402
from repro_torch.systems.molecule import (build_wavefunction,  # noqa: E402
                                          water)


def test_catmull_rom_reproduces_quadratics():
    """Catmull-Rom (finite-difference tangents) reproduces polynomials of
    degree <= 2 exactly: central differences are exact for quadratics."""
    n = 12
    ax = torch.linspace(-2.0, 2.0, n)
    X, Y, Z = torch.meshgrid(ax, ax, ax, indexing='ij')

    def f(x, y, z):
        return 0.3 * x * x - x * y + 0.5 * z * z + 2.0 * y - 1.0

    vals = f(X, Y, Z)[None]                      # (1, n, n, n)
    h = float(ax[1] - ax[0])
    grid = spline.MOGrid(values=vals, origin=torch.tensor([-2.0] * 3),
                         inv_h=torch.tensor([1.0 / h] * 3))
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-1.0, 1.0, (20, 3)),
                          dtype=torch.float32)
    C = spline.interp_mo_block(grid, pts)        # (1, 20, 5)
    assert C.shape == (1, 20, 5)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    np.testing.assert_allclose(C[0, :, 0], f(x, y, z), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(C[0, :, 1], 0.6 * x - y,       # d/dx
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(C[0, :, 4],                    # laplacian
                               np.full(20, 0.6 + 1.0), rtol=1e-2, atol=2e-2)


def test_molecular_interpolation_converges():
    """Away from nuclei, a fine grid approximates the direct computation."""
    mol, shells = water()
    cfg, params = build_wavefunction(mol, shells, method='dense',
                                     device='cpu')
    grid = spline.build_mo_grid(cfg.basis_t, params.coords, params.mo,
                                (56, 56, 56), margin=4.0, chunk=4096)
    # probe points >= 1 bohr away from every nucleus (valence region)
    rng = np.random.default_rng(1)
    pts = []
    while len(pts) < 12:
        p = rng.uniform(-2.5, 2.5, 3)
        if np.min(np.linalg.norm(mol.coords - p, axis=1)) > 1.0:
            pts.append(p)
    pts = torch.as_tensor(np.asarray(pts), dtype=torch.float32)

    C_int = spline.interp_mo_block(grid, pts)
    B, _ = aos.eval_ao_block(cfg.basis_t, params.coords, pts)
    C_dir = mos.mo_products_dense(params.mo, B)
    scale = float(torch.max(torch.abs(C_dir[..., 0])))
    err = float(torch.max(torch.abs(C_int[..., 0] - C_dir[..., 0])))
    assert err < 0.05 * scale, f'value err {err} vs scale {scale}'


def test_memory_footprint_scales_with_grid():
    """The paper's point: spline tables blow up memory; direct storage not."""
    mol, shells = water()
    cfg, params = build_wavefunction(mol, shells, method='dense',
                                     device='cpu')
    g1 = spline.build_mo_grid(cfg.basis_t, params.coords, params.mo,
                              (16, 16, 16))
    direct_bytes = params.mo.numel() * 4
    assert g1.memory_bytes == params.mo.shape[0] * 16 ** 3 * 4
    assert g1.memory_bytes > 4 * direct_bytes


@pytest.fixture(scope='module')
def water_pair():
    return j_build_system('water'), build_system('water', device='cpu')


def _rel_err(got, want):
    """Largest error of each trailing component, relative to that
    component's largest entry."""
    want = np.asarray(want)
    return [float(np.max(np.abs(got[..., i] - want[..., i]))
                  / np.max(np.abs(want[..., i])))
            for i in range(want.shape[-1])]


@pytest.mark.parametrize('n', [16, 24])
def test_grid_and_interpolation_match_jax(water_pair, n):
    (cfg, params), (tcfg, tparams) = water_pair
    g_j = j_spline.build_mo_grid(cfg.basis, params.coords, params.mo,
                                 (n, n, n))
    g_t = spline.build_mo_grid(tcfg.basis_t, tparams.coords, tparams.mo,
                               (n, n, n))
    assert g_t.values.shape == g_j.values.shape
    assert g_t.values.dtype == torch.float32
    assert g_t.memory_bytes == g_j.memory_bytes
    v_j = np.asarray(g_j.values)
    assert (np.max(np.abs(g_t.values.numpy() - v_j))
            <= 1e-5 * np.max(np.abs(v_j)))
    np.testing.assert_allclose(g_t.origin.numpy(), np.asarray(g_j.origin),
                               rtol=1e-6)
    np.testing.assert_allclose(g_t.inv_h.numpy(), np.asarray(g_j.inv_h),
                               rtol=1e-6)
    rng = np.random.default_rng(n)
    pts = rng.uniform(-3.0, 3.0, (64, 3)).astype(np.float32)
    C_j = np.asarray(j_spline.interp_mo_block(g_j, jnp.asarray(pts)))
    # a chunk smaller than the batch: the passes join in electron order
    C_t = spline.interp_mo_block(g_t, torch.from_numpy(pts), chunk=24)
    assert C_t.shape == C_j.shape
    assert max(_rel_err(C_t.numpy(), C_j)) <= 1e-5
