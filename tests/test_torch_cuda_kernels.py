"""CUDA kernels of the PyTorch port against their plain versions, on the
card (marker ``cuda``; every test skips on a host without a GPU).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The CPU tests hold the plain versions against the JAX package
(``tests/test_torch_kernels.py``); these hold each kernel against its
plain version on the same card inputs, made with numpy from a seed.
Imports nothing of JAX, so that they run where only the port is
installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from repro_torch.kernels import mo_tile  # noqa: E402
from repro_torch.kernels.screened_mo import kernel as scr_kernel  # noqa: E402
from repro_torch.kernels.screened_mo.ops import (  # noqa: E402
    screened_mo_products)
from repro_torch.kernels.screened_mo.ref import screened_mo_ref  # noqa: E402
from repro_torch.kernels.sparse_mo import kernel as sm_kernel  # noqa: E402
from repro_torch.kernels.sparse_mo.ops import sparse_mo_rows  # noqa: E402
from repro_torch.kernels.sparse_mo.ref import sparse_mo_rows_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel runs only on the card')
    return torch.device('cuda')


def _screened_case(seed, n_orb, n_ao, n_e, K):
    """Packed candidate lists with ragged active counts (ascending ids,
    padding id 0, inactive padding slots), from numpy."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_orb, n_ao)).astype(np.float32)
    idx = np.zeros((n_e, K), np.int32)
    active = np.zeros((n_e, K), bool)
    for e in range(n_e):
        cand = np.sort(rng.choice(n_ao, size=int(rng.integers(0, K + 1)),
                                  replace=False))
        idx[e, :len(cand)] = cand
        active[e, :len(cand)] = True
    Bp = rng.normal(size=(n_e, K, 5)).astype(np.float32)
    return A, Bp, idx, active


@pytest.mark.parametrize('n_e,K', [(1, 1), (7, 13), (333, 200)])
def test_screened_mo_kernel_matches_its_plain_version(cuda_device, n_e, K):
    """Per electron within 1e-5 of the electron's max |C|; an electron
    with no active slot exactly zero; NaN at inactive slots does not
    leak; one launch counted."""
    A, Bp, idx, active = _screened_case(6, 217, 952, n_e, K)
    active[n_e // 2] = False
    Bp = np.where(active[..., None], Bp, np.float32(np.nan))
    A, Bp, idx, active = (torch.from_numpy(x).to(cuda_device)
                          for x in (A, Bp, idx, active))
    before = scr_kernel.COUNTER.n
    C = screened_mo_products(A, Bp, idx, active)
    assert scr_kernel.COUNTER.n == before + 1
    C_ref = screened_mo_ref(A, Bp, idx, active)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(C).all())
    assert bool((C[:, n_e // 2] == 0).all())
    scale = C_ref.abs().amax(dim=(0, 2)).clamp(min=1e-30)
    err = (C - C_ref).abs().amax(dim=(0, 2))
    assert bool((err <= 1e-5 * scale).all())


def _per_electron_ok(C, C_ref):
    scale = C_ref.abs().amax(dim=(0, 2)).clamp(min=1e-30)
    err = (C - C_ref).abs().amax(dim=(0, 2))
    return bool((err <= 1e-5 * scale).all())


def _rows_case(seed, n_orb, n_ao, n_e, density):
    """AO rows with NaN outside the mask, electron n_e // 2 with no active
    AO, a random tile key; numpy from a seed."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_orb, n_ao)).astype(np.float32)
    mask = rng.random((n_e, n_ao)) < density
    mask[n_e // 2] = False
    B = np.where(mask[..., None], rng.normal(size=(n_e, n_ao, 5)),
                 np.nan).astype(np.float32)
    key = rng.integers(0, 11, n_e).astype(np.int16)
    return A, B, mask, key


@pytest.mark.parametrize('n_e', [1, 45, 333])
def test_sparse_mo_kernel_matches_its_plain_version(cuda_device, n_e):
    """Ragged N, a random tile order, an electron with no active AO
    (exactly 0), NaN outside the active set (does not leak); one launch
    counted."""
    A, B, mask, key = (torch.from_numpy(x).to(cuda_device)
                       for x in _rows_case(8, 79, 346, n_e, 0.28))
    before = sm_kernel.COUNTER.n
    C = sparse_mo_rows(A, B, mask, key)
    assert sm_kernel.COUNTER.n == before + 1
    order = mo_tile.electron_order(key, n_e)
    C_ref = sparse_mo_rows_ref(A, B, mask, order)
    torch.cuda.synchronize()
    assert C.shape == (79, n_e, 5) and bool(torch.isfinite(C).all())
    assert bool((C[:, n_e // 2] == 0).all())
    assert _per_electron_ok(C, C_ref)


def _wide_packed(device, seed=4, n_orb=866, n_ao=3804, n_e=160, K=1392):
    """The 1amb's widths: ascending candidate ids, ~7 % active, three
    electrons with every slot active, one with none, NaN in inactive
    slots."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    A = torch.randn((n_orb, n_ao), generator=g, device=device)
    idx = torch.sort(torch.topk(torch.rand((n_e, n_ao), generator=g,
                                           device=device), K, dim=1).indices,
                     dim=1).values.to(torch.int32)
    act = torch.rand((n_e, K), generator=g, device=device) < 0.07
    act[:3] = True
    act[3] = False
    Bp = torch.randn((n_e, K, 5), generator=g, device=device)
    Bp = torch.where(act[..., None], Bp, torch.full_like(Bp, float('nan')))
    key = torch.randint(0, 40, (n_e,), generator=g, device=device)
    return A, Bp, idx, act, key


def _rows_of(idx, act, Bp, n_ao):
    """The same active sets as AO rows (N, n_ao, 5) with an (N, n_ao)
    mask."""
    N = idx.shape[0]
    mask = mo_tile.packed_mask(idx, act, n_ao)
    B = torch.zeros((N, n_ao, 5), device=idx.device)
    rows = torch.arange(N, device=idx.device)[:, None].expand_as(idx)
    B[rows[act], idx.long()[act]] = Bp[act]
    return B, mask


def test_mo_kernels_at_the_widest_paper_system(cuda_device):
    """n_ao = 3804, K = 1392, n_orb = 866 (the 1amb at eps = 1e-8): no
    launch refused; the lists of the three full electrons outgrow a window
    (lcap < 1392), and every window resumes the sums in order: within 1e-5
    of the plain version, the two kernels bit for bit equal, the electron
    with no slot exactly 0."""
    A, Bp, idx, act, key = _wide_packed(cuda_device)
    C = screened_mo_products(A, Bp, idx, act, key)
    C_ref = screened_mo_ref(A, Bp, idx, act)
    B, mask = _rows_of(idx, act, Bp, A.shape[1])
    C_rows = sparse_mo_rows(A, B, mask, key)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(C).all()) and bool((C[:, 3] == 0).all())
    assert _per_electron_ok(C, C_ref) and torch.equal(C_rows, C)
    assert scr_kernel.plan(866, 3804, 1392)['lcap'] < 1392


def test_mo_kernels_are_bitwise_equal_on_the_same_active_sets(cuda_device):
    """Both kernels sum each electron's active AOs in ascending order by
    fmaf, so on the same active sets (the packed lists and the rows they
    make) their C agree bit for bit, whatever the tile orders."""
    A, Bp, idx, act, key = _wide_packed(cuda_device, seed=6, n_orb=217,
                                        n_ao=952, n_e=333, K=200)
    B, mask = _rows_of(idx, act, Bp, A.shape[1])
    C_packed = screened_mo_products(A, Bp, idx, act, key)
    C_rows = sparse_mo_rows(A, B, mask, torch.flip(key, (0,)))
    torch.cuda.synchronize()
    assert torch.equal(C_packed, C_rows)
