"""Kernel packages of the PyTorch port against the JAX package's kernels.

The port's public entry points run their plain PyTorch versions on CPU
tensors; the JAX side runs its Pallas kernels as its own tests run them on
the CPU (``interpret=True``) and its jnp oracles.  Inputs are made with
numpy from a seed and handed to both.  The CUDA kernels themselves run
only on a GPU: ``chip_smoke.py`` holds them against their plain versions
on the card, and ``tests/test_torch_cuda_kernels.py`` does so under
pytest there.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.kernels.sem_update.ops import sem_rank1_update as j_sem  # noqa: E402
from repro.kernels.sem_update.ref import sem_update_ref as j_sem_ref  # noqa: E402
from repro.kernels.sparse_mo.ops import (  # noqa: E402
    sparse_mo_products as j_smp, tile_block_ids as j_tile_block_ids)
from repro.kernels.sparse_mo.ref import mo_products_ref as j_mo_ref  # noqa: E402
from repro.kernels.screened_mo.ops import (  # noqa: E402
    screened_mo_products as j_scr_mo)
from repro.kernels.screened_mo.ref import (  # noqa: E402
    screened_mo_ref as j_scr_mo_ref)

from repro_torch.kernels.fused_sweep import kernel as fs_kernel  # noqa: E402
from repro_torch.kernels.multidet_ratio import kernel as mr_kernel  # noqa: E402
from repro_torch.kernels.screened_mo import kernel as scr_kernel  # noqa: E402
from repro_torch.kernels.screened_mo.ops import (  # noqa: E402
    screened_mo_products)
from repro_torch.kernels.screened_mo.ref import screened_mo_ref  # noqa: E402
from repro_torch.kernels.sem_update import kernel as su_kernel  # noqa: E402
from repro_torch.kernels.sem_update.ops import sem_rank1_update  # noqa: E402
from repro_torch.kernels.sem_update.ref import sem_update_ref  # noqa: E402
from repro_torch.kernels.sparse_mo import kernel as sm_kernel  # noqa: E402
from repro_torch.kernels.sparse_mo.ops import (  # noqa: E402
    sparse_mo_products, tile_block_ids)
from repro_torch.kernels.sparse_mo.ref import mo_products_ref  # noqa: E402
from repro_torch.kernels import mo_tile  # noqa: E402


def _window_case(seed, n_orb, n_ao, n_e, window):
    """Per-electron contiguous active-AO window (tests/test_sparse_mo_kernel
    .py's structured sparsity), from numpy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_orb, n_ao)).astype(np.float32)
    starts = rng.integers(0, max(n_ao - window, 1), n_e)
    ao = np.arange(n_ao)
    mask = (ao[None] >= starts[:, None]) & (ao[None] < starts[:, None] + window)
    B = rng.normal(size=(n_ao, n_e, 5)).astype(np.float32)
    B = np.where(mask.T[:, :, None], B, 0.0).astype(np.float32)
    return A, B, mask


def _random_case(seed, n_orb=24, n_ao=96, n_e=12, density=0.15):
    """Unstructured random masks (the worst case for tiling)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_orb, n_ao)).astype(np.float32)
    mask = rng.random((n_e, n_ao)) < density
    B = rng.normal(size=(n_ao, n_e, 5)).astype(np.float32)
    B = np.where(mask.T[:, :, None], B, 0.0).astype(np.float32)
    return A, B, mask


def _check_sparse(A, B, mask):
    C_jk = np.asarray(j_smp(jnp.asarray(A), jnp.asarray(B), jnp.asarray(mask),
                            tile_o=32, tile_k=32, tile_e=8))
    C_jr = np.asarray(j_mo_ref(jnp.asarray(A), jnp.asarray(B)))
    C_t = sparse_mo_products(torch.from_numpy(A), torch.from_numpy(B),
                             torch.from_numpy(mask)).numpy()
    C_tr = mo_products_ref(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    assert C_t.shape == C_jk.shape == (A.shape[0], B.shape[1], 5)
    atol = 1e-5 * float(np.max(np.abs(C_jr)))      # fp32 summation order
    for got in (C_t, C_tr):
        for want in (C_jk, C_jr):
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize('n_orb,n_ao,n_e,window', [
    (16, 64, 8, 16),       # tiny
    (96, 300, 50, 64),     # odd sizes: ragged tiles everywhere
    (128, 256, 32, 256),   # fully dense window
    (64, 512, 16, 8),      # very sparse
    (79, 404, 40, 140),    # micro-peptide widths
])
def test_sparse_mo_windowed_matches_jax(n_orb, n_ao, n_e, window):
    _check_sparse(*_window_case(0, n_orb, n_ao, n_e, window))


@pytest.mark.parametrize('seed', range(5))
def test_sparse_mo_random_masks_match_jax(seed):
    _check_sparse(*_random_case(seed))


def test_sparse_mo_all_zero_b_is_zero():
    A, B, mask = _window_case(3, 32, 96, 8, 16)
    B[:] = 0.0
    C = sparse_mo_products(torch.from_numpy(A), torch.from_numpy(B),
                           torch.from_numpy(mask))
    assert float(C.abs().max()) == 0.0


@pytest.mark.parametrize('tile_e,tile_k', [(16, 32), (8, 16), (4, 8)])
def test_tile_block_ids_cover_jax_active_tiles(tile_e, tile_k):
    """The port's tile lists hold exactly the active (e-tile, k-tile)
    pairs the JAX lists hold, and in the same ascending order."""
    _, _, mask = _window_case(4, 16, 128, 37, 24)
    n_kb = -(-128 // tile_k)
    ids_j, num_j = j_tile_block_ids(jnp.asarray(mask), tile_e=tile_e,
                                    tile_k=tile_k, max_kb=n_kb)
    ids_t, num_t = tile_block_ids(torch.from_numpy(mask), tile_e=tile_e,
                                  tile_k=tile_k, max_kb=n_kb)
    assert ids_t.dtype == torch.int32 and num_t.dtype == torch.int32
    np.testing.assert_array_equal(num_t.numpy(), np.asarray(num_j))
    for et in range(ids_t.shape[0]):
        k = int(num_t[et])
        np.testing.assert_array_equal(ids_t[et, :k].numpy(),
                                      np.asarray(ids_j)[et, :k])


def _sem_case(seed, W, n):
    rng = np.random.default_rng(seed)
    minv = rng.normal(size=(W, n, n)).astype(np.float32) * 10
    u = rng.normal(size=(W, n)).astype(np.float32)
    row = rng.normal(size=(W, n)).astype(np.float32)
    accept = rng.integers(0, 2, W).astype(bool)
    accept[0], accept[1] = False, True
    row[0] = np.nan                      # near-zero ratio on a rejected walker
    return minv, u, row, accept


@pytest.mark.parametrize('W,n', [(8, 4), (10, 6), (256, 79)])
def test_sem_update_matches_jax(W, n):
    minv, u, row, accept = _sem_case(W * 100 + n, W, n)
    for j in (0, n - 1):
        want_k = np.asarray(j_sem(jnp.asarray(minv), jnp.asarray(u),
                                  jnp.asarray(row), jnp.asarray(accept), j))
        want_r = np.asarray(j_sem_ref(jnp.asarray(minv), jnp.asarray(u),
                                      jnp.asarray(row), jnp.asarray(accept),
                                      j))
        args = (torch.from_numpy(minv), torch.from_numpy(u),
                torch.from_numpy(row), torch.from_numpy(accept), j)
        for got in (sem_update_ref(*args).numpy(),
                    sem_rank1_update(*args).numpy()):
            for want in (want_k, want_r):
                # rejected walkers and the replaced row: bitwise
                np.testing.assert_array_equal(got[~accept], minv[~accept])
                np.testing.assert_array_equal(got[~accept], want[~accept])
                np.testing.assert_array_equal(got[accept][:, j],
                                              want[accept][:, j])
                # the rest: relative 1e-6 to each walker's max |Minv| —
                # XLA may contract minv - u*row into an FMA, which rounds
                # the product once less than the separate multiply here
                g, w = got[accept], want[accept]
                scale = np.max(np.abs(w), axis=(1, 2), keepdims=True)
                assert np.all(np.abs(g - w) <= 1e-6 * scale)


def test_sem_update_plain_version_does_not_modify_input():
    minv, u, row, accept = _sem_case(1, 6, 5)
    t = torch.from_numpy(minv.copy())
    sem_rank1_update(t, torch.from_numpy(u), torch.from_numpy(row),
                     torch.from_numpy(accept), 2)
    np.testing.assert_array_equal(t.numpy(), minv)


def _screened_case(seed, n_orb, n_ao, n_e, K):
    """Packed candidate lists with ragged per-electron active counts
    (tests/test_screened_mo_kernel.py's cases), from numpy: ascending ids,
    padding id 0, inactive padding slots."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_orb, n_ao)).astype(np.float32)
    idx = np.zeros((n_e, K), np.int32)
    active = np.zeros((n_e, K), bool)
    for e in range(n_e):
        n_act = int(rng.integers(0, K + 1))
        cand = np.sort(rng.choice(n_ao, size=min(n_act, n_ao),
                                  replace=False))
        idx[e, :len(cand)] = cand
        active[e, :len(cand)] = True
    Bp = rng.normal(size=(n_e, K, 5)).astype(np.float32)
    return A, Bp, idx, active


def _check_screened(A, Bp, idx, active, Bp_port=None):
    """The port's entry point and plain version against the reference's
    Pallas kernel (interpret mode) and jnp oracle; 1e-5 of max |C| (fp32
    summation order)."""
    ja = [jnp.asarray(x) for x in (A, Bp, idx, active)]
    C_jk = np.asarray(j_scr_mo(*ja, tile_o=8, tile_k=8, tile_e=4))
    C_jr = np.asarray(j_scr_mo_ref(*ja))
    Bp_t = torch.from_numpy(Bp if Bp_port is None else Bp_port)
    ta = (torch.from_numpy(A), Bp_t, torch.from_numpy(idx),
          torch.from_numpy(active))
    C_t = screened_mo_products(*ta).numpy()
    C_r = screened_mo_ref(*ta, chunk=3).numpy()
    assert C_t.shape == C_jr.shape == (A.shape[0], idx.shape[0], 5)
    atol = 1e-5 * max(float(np.max(np.abs(C_jr))), 1e-30)
    for got in (C_t, C_r):
        for want in (C_jk, C_jr):
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    return C_t


@pytest.mark.parametrize('n_e,K', [(1, 1), (7, 13), (8, 24), (30, 65),
                                   (50, 200)])
def test_screened_mo_ragged_lists_match_jax(n_e, K):
    _check_screened(*_screened_case(1, 24, 96 if K < 96 else 300, n_e, K))


def test_screened_mo_all_inactive_rows_are_zero():
    A, Bp, idx, active = _screened_case(2, 32, 128, 12, 32)
    active[3] = False
    active[7] = False
    C = _check_screened(A, Bp, idx, active)
    assert np.all(C[:, 3] == 0.0) and np.all(C[:, 7] == 0.0)


@pytest.mark.parametrize('poison', [1e30, np.nan])
def test_screened_mo_inactive_values_cannot_leak(poison):
    """Garbage at inactive slots (1e30, NaN) does not reach C: the plain
    version zeroes it, the kernel never reads it."""
    A, Bp, idx, active = _screened_case(3, 16, 64, 8, 16)
    bad = np.where(active[..., None], Bp, np.float32(poison))
    C = _check_screened(A, Bp, idx, active, Bp_port=bad)
    assert np.all(np.isfinite(C))


@pytest.mark.parametrize('chunk', [1, 5, 64])
def test_screened_mo_chunked_equals_one_shot(chunk):
    """The electron-chunked plain version equals its one-shot gather
    bitwise (each electron's column is the same contraction)."""
    A, Bp, idx, active = (torch.from_numpy(x) for x in
                          _screened_case(4, 40, 150, 37, 48))
    one = screened_mo_ref(A, Bp, idx, active, chunk=0)
    got = screened_mo_ref(A, Bp, idx, active, chunk=chunk)
    assert torch.equal(got, one)


def test_screened_mo_on_a_real_screening_structure():
    """End to end on a bench system (tests/test_screened_mo_kernel.py's
    case): the port's entry point on its eps = 0 lists reproduces the
    unscreened dense MO tensor, and the reference's kernel on the same
    lists agrees."""
    from repro_torch.core import aos
    from repro_torch.core.screening import active_ao_lists
    from repro_torch.systems.bench import (build_bench_wavefunction,
                                           make_bench_system)
    s = make_bench_system('micro-peptide', n_elec=60, seed=5)
    cfg, params = build_bench_wavefunction(s, method='kernel',
                                           screen_eps=0.0)
    rng = np.random.default_rng(0)
    at = rng.integers(0, s.mol.coords.shape[0], s.mol.n_elec)
    r = torch.from_numpy((s.mol.coords[at] + rng.normal(
        scale=1.2, size=(s.mol.n_elec, 3))).astype(np.float32))
    idx, active, _ = active_ao_lists(cfg.screening_t, r)
    Bp = aos.eval_ao_block_screened(cfg.basis_t, params.coords, r, idx,
                                    active)
    B, _ = aos.eval_ao_block(cfg.basis_t, params.coords, r)
    C_dense = mo_products_ref(params.mo, B).numpy()
    C = _check_screened(params.mo.numpy(), Bp.numpy(), idx.numpy(),
                        active.numpy())
    np.testing.assert_allclose(C, C_dense, rtol=0,
                               atol=1e-5 * float(np.abs(C_dense).max()))


def _sparse_mo_cpu_call():
    A, B, mask = (torch.from_numpy(x) for x in _window_case(0, 8, 32, 16, 8))
    sm_kernel.sparse_mo_rows(mo_tile.transposed(A),
                             B.transpose(0, 1).contiguous(), mask,
                             torch.arange(16, dtype=torch.int32), 8)


def _sem_update_cpu_call():
    minv, u, row, accept = _sem_case(0, 4, 3)
    su_kernel.sem_update_inplace(torch.from_numpy(minv), torch.from_numpy(u),
                                 torch.from_numpy(row),
                                 torch.from_numpy(accept), 0)


def _fused_sweep_cpu_call():
    W, n = 3, 4
    f = torch.zeros
    fs_kernel.fused_sweep_inplace(f(W, n, n), f(W, n, n), f(W, 2 * n, 3),
                                  f(W, n, 3), f(W, n), f(W, n), f(W), f(W),
                                  f(()), offset=0, n_up=n)


def _multidet_ratio_cpu_call():
    W, n_orb, n_occ, n_det = 3, 7, 4, 5
    f = torch.zeros
    h = torch.zeros((n_det, 2), dtype=torch.int32)
    mr_kernel.multidet_ratio(f(W, n_orb, n_occ), f(W, n_orb), f(W, n_occ), h,
                             h, f(n_det), f(W, n_det))


def _screened_mo_cpu_call():
    A, Bp, idx, active = (torch.from_numpy(x) for x in
                          _screened_case(0, 8, 32, 4, 8))
    scr_kernel.screened_mo_matmul(mo_tile.transposed(A), Bp, idx, active,
                                  torch.arange(4, dtype=torch.int32), 8)


def _sem_move_cpu_call():
    W, n, n_e = 3, 4, 8
    f = torch.zeros
    su_kernel.sem_move_inplace(f(W, n, n), f(W, n), f(W, n_e, 3), f(W, 3),
                               f(W), f(W), f(W), f(W),
                               torch.zeros(W, dtype=torch.bool), f(W), 0, 0)


@pytest.mark.parametrize('name', ['sparse_mo', 'sem_update', 'sem_move',
                                  'fused_sweep', 'multidet_ratio',
                                  'screened_mo'])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """The CUDA wrappers launch or raise; they never compute on the CPU."""
    counter = {'sparse_mo': sm_kernel.COUNTER, 'sem_update': su_kernel.COUNTER,
               'sem_move': su_kernel.MOVE_COUNTER,
               'fused_sweep': fs_kernel.COUNTER,
               'multidet_ratio': mr_kernel.COUNTER,
               'screened_mo': scr_kernel.COUNTER}[name]
    with pytest.raises(ValueError, match='CUDA'):
        globals()[f'_{name}_cpu_call']()
    assert counter.n == 0


def test_fused_sweep_kernel_names_its_rank_cap():
    """The fused sweep kernel takes any excitation rank up to its cap
    (the reference's det has none); above the cap the wrapper raises and
    names it, before anything is launched."""
    W, n, n_orb, n_det = 2, 3, 12, 4
    f = torch.zeros
    for k in (fs_kernel.MAX_RANK + 1, 1):
        h = torch.zeros((n_det, k), dtype=torch.int32)
        ci = (f(W, n_orb, n), f(W, n_det), f(W, n_det), h, h, f(n_det))
        with pytest.raises(ValueError, match=f'rank <= {fs_kernel.MAX_RANK}'):
            fs_kernel.fused_sweep_inplace(
                f(W, n, n), f(W, n, n_orb), f(W, 2 * n, 3), f(W, n, 3),
                f(W, n), f(W, n), f(W), f(W), f(()), ci, offset=0, n_up=n)
    assert fs_kernel.COUNTER.n == 0
