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

from repro_torch.kernels.screened_mo import kernel as scr_kernel  # noqa: E402
from repro_torch.kernels.screened_mo.ops import (  # noqa: E402
    screened_mo_products)
from repro_torch.kernels.screened_mo.ref import screened_mo_ref  # noqa: E402

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
