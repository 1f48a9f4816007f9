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


def _sweep_case(device, n, W, seed, n_orb=0, n_det=0):
    """A well-conditioned spin block of n electrons (n_e = 2n): Minv the
    inverse of D = I + 0.1 G / sqrt(n), the proposals' phi the electron's
    own column plus noise (ratios O(1)); with n_det > 1 a synthetic CI
    expansion over n_orb orbitals, P and rdet built as the path builds
    them.  numpy from a seed."""
    from repro_torch.core import multidet
    from repro_torch.systems.bench import synthetic_ci
    rng = np.random.default_rng(seed)

    def _n(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape))
                                .astype(np.float32)).to(device)
    D = torch.eye(n, device=device) + _n(W, n, n, s=0.1 / np.sqrt(n))
    minv = torch.linalg.inv(D.double()).float().contiguous()
    phi = (D.transpose(1, 2) + _n(W, n, n, s=0.3 / np.sqrt(n))).contiguous()
    r = _n(W, 2 * n, 3, s=2.0)
    blk = dict(minv=minv, phi=phi, r=r,
               r_prop=(r[:, :n] + _n(W, n, 3, s=0.3)).contiguous(),
               en=_n(W, n, s=0.05),
               logu=torch.from_numpy(np.log(rng.uniform(1e-6, 1.0, (W, n)))
                                     .astype(np.float32)).to(device),
               sign=torch.ones(W, device=device),
               logdet=torch.zeros(W, device=device))
    if n_det > 1:
        ci_t = multidet.pin(synthetic_ci(n, n, n_orb, n_det, seed=seed), n,
                            n, device)
        V = _n(W, n_orb - n, n, s=0.3)
        P = multidet.reference_table(torch.cat([D, V], dim=1), minv)
        blk['phi'] = torch.cat([blk['phi'],
                                V.transpose(1, 2) + _n(W, n, n_orb - n,
                                                       s=0.1)],
                               dim=-1).contiguous()
        blk['ci'] = (P.contiguous(),
                     multidet.det_ratios(P, ci_t.holes_up, ci_t.parts_up)
                     .contiguous(), (1.0 + _n(W, n_det, s=0.1)).contiguous(),
                     ci_t.holes_up_k, ci_t.parts_up_k, ci_t.coeffs)
    return blk


def _sweep(blk, kernel, **launch):
    from repro_torch.kernels.fused_sweep.ops import fused_sweep_block
    ci = None
    if 'ci' in blk:
        P, rdet, ro, h, p, c = blk['ci']
        ci = (P.clone(), rdet.clone(), ro, h, p, c)
    return fused_sweep_block(
        blk['minv'].clone(), blk['phi'], blk['r'].clone(), blk['r_prop'],
        blk['en'], blk['logu'], blk['sign'].clone(), blk['logdet'].clone(),
        torch.ones((), device=blk['minv'].device), ci, offset=0,
        n_up=blk['minv'].shape[1], use_kernel=kernel, **launch)


def _sweeps_agree(out_k, out_p, near=1e-5, tol=1e-5, ltol=1e-5):
    """Identical decisions and r, sign on walkers with no near tie (a move
    whose margin is within ``near`` of 0); Minv, P, rdet within ``tol`` (a
    number, or one a walker) of the walker's max, logdet within ``ltol``
    of max(|logdet|, 1)."""
    r_k, m_k, s_k, l_k, p_k, d_k, a_k, g_k = out_k
    r_p, m_p, s_p, l_p, p_p, d_p, a_p, g_p = out_p
    clean = ~((g_k.abs() < near) | (g_p.abs() < near)).any(dim=1)
    assert int(clean.sum()) >= clean.numel() // 2
    assert torch.equal(a_k[clean], a_p[clean])
    assert torch.equal(r_k[clean], r_p[clean])
    assert torch.equal(s_k[clean], s_p[clean])
    assert bool(((l_k - l_p).abs()[clean]
                 <= ltol * l_p.abs()[clean].clamp(min=1.0)).all())
    t = tol[clean] if torch.is_tensor(tol) else tol
    for k, p in ((m_k, m_p), (p_k, p_p), (d_k, d_p)):
        if k is None:
            continue
        k, p = k.flatten(1)[clean], p.flatten(1)[clean]
        err = (k - p).abs().amax(dim=1)
        assert bool((err <= t * p.abs().amax(dim=1)).all())


@pytest.mark.parametrize('n,per_row', [(79, 1), (79, 2), (217, 2)])
def test_fused_sweep_rows_route_matches_its_plain_version(cuda_device, n,
                                                          per_row):
    """The rows route (the inverse's rows in registers) at the main path's
    n = 79 and the b-strand's n = 217 against the plain loop on the card;
    one launch counted."""
    from repro_torch.kernels.fused_sweep import kernel as fsk
    blk = _sweep_case(cuda_device, n, 16, seed=n + per_row)
    before = fsk.COUNTER.n
    out_k = _sweep(blk, True, route='rows', per_row=per_row)
    assert fsk.COUNTER.n == before + 1
    out_p = _sweep(blk, False)
    torch.cuda.synchronize()
    _sweeps_agree(out_k, out_p)


def _rows_variant_case(reg, sh, ci):
    """The largest block n <= 256 (CI: n_orb = n + 20, n_det = 50) and the
    threads per row at which the chooser takes the compiled (reg, sh)."""
    from repro_torch.kernels.fused_sweep import kernel as fsk
    for n in range(256, 0, -1):
        sizes = ((n, n + 20, 2 * n, n + 20, 50, True) if ci
                 else (n, n, 2 * n))
        for t in fsk.PER_ROW:
            x = fsk.rows_launch(*sizes, per_row=t)
            if x is not None and (x.reg, x.shared) == (reg, sh):
                return n, t
    raise AssertionError(f'no block size takes ({reg}, {sh}), ci={ci}')


def _compiled_rows_shapes():
    from repro_torch.kernels.fused_sweep import kernel as fsk
    return ([(r, s, False) for r, s in fsk.VARIANTS]
            + [(r, s, True) for r, s in fsk.CI_VARIANTS])


@pytest.mark.parametrize('reg,sh,ci', _compiled_rows_shapes(),
                         ids=lambda v: str(v))
def test_fused_sweep_every_compiled_rows_shape(cuda_device, reg, sh, ci):
    """Every (R, S) the source compiles for the rows route, with and
    without CI, at the largest block that takes it, against the plain loop
    on the card: decisions away from the margin fp32 resolves at this
    width (``_fp32_margin_scale``), Minv (and P, rdet)."""
    from repro_torch.kernels.fused_sweep import kernel as fsk
    n, t = _rows_variant_case(reg, sh, ci)
    blk = _sweep_case(cuda_device, n, 16, seed=reg + sh + n,
                      **(dict(n_orb=n + 20, n_det=50) if ci else {}))
    sizes = ((n, n + 20, 2 * n, n + 20, 50, True) if ci else (n, n, 2 * n))
    shape = fsk.launch_shape(*sizes, route='rows', per_row=t, walkers=16)
    assert (shape.reg, shape.shared, shape.per_row) == (reg, sh, t)
    before = fsk.COUNTER.n
    out_k = _sweep(blk, True, route='rows', per_row=t)
    assert fsk.COUNTER.n == before + 1
    out_p = _sweep(blk, False)
    torch.cuda.synchronize()
    _sweeps_agree(out_k, out_p, _fp32_margin_scale(blk, out_p))


def _fp32_margin_scale(blk, out_p):
    """The margin fp32 resolves on these inputs, the tie threshold of a
    block this wide: twice the plain fp32 sweep's largest margin distance
    from the same sweep in float64, over the walkers whose decisions the
    two share, and at least 1e-5.  (At n_e = 512 the e-e sums are ~200,
    so their fp32 rounding moves a margin by up to ~1e-4 with the order of
    summation, and a move that close to 0 may go either way.)"""
    def _d(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() \
            else x
    b64 = {k: _d(v) for k, v in blk.items() if k != 'ci'}
    if 'ci' in blk:
        b64['ci'] = tuple(_d(x) for x in blk['ci'])
    out_64 = _sweep(b64, False)
    same = (out_p[6] == out_64[6]).all(dim=1)
    assert bool(same.any())
    gap = (out_p[7].double() - out_64[7]).abs()[same].max()
    return max(1e-5, 2.0 * float(gap))


def test_fused_sweep_rows_route_with_ci(cuda_device):
    """CI at the main path's widths (n = 79, n_orb = 118, n_det = 100) on
    the rows route, P's rows with threads of their own, against the plain
    loop: decisions, Minv, P and rdet."""
    from repro_torch.kernels.fused_sweep import kernel as fsk
    blk = _sweep_case(cuda_device, 79, 16, seed=5, n_orb=118, n_det=100)
    assert fsk.launch_shape(79, 118, 158, 118, 100, True).route == 'rows'
    _sweeps_agree(_sweep(blk, True), _sweep(blk, False))


def test_fused_sweep_routes_agree(cuda_device):
    """At n = 79 all four routes run and agree with the plain loop (the
    cluster route forced: two blocks of 40 and 39 rows)."""
    blk = _sweep_case(cuda_device, 79, 8, seed=11)
    out_p = _sweep(blk, False)
    for route in ('rows', 'cluster', 'shared', 'global'):
        out_k = _sweep(blk, True, route=route)
        torch.cuda.synchronize()
        _sweeps_agree(out_k, out_p)


def _logdet_scale(blk, out_p):
    """logdet's tolerance past n = 256, where an fp32 chain of n moves
    resolves it more coarsely: 3x the plain fp32 sweep's median distance
    from the same sweep in float64 (relative to max(|logdet|, 1)), and at
    least 1e-5, as chip_smoke.py holds the paper systems' blocks."""
    if blk['minv'].shape[1] <= 256:
        return 1e-5

    def _d(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() \
            else x
    b64 = {k: _d(v) for k, v in blk.items() if k != 'ci'}
    if 'ci' in blk:
        b64['ci'] = tuple(_d(x) for x in blk['ci'])
    l64 = _sweep(b64, False)[3]
    d = (out_p[3].double() - l64).abs() / l64.abs().clamp(min=1.0)
    return max(1e-5, 3.0 * float(d.median()))


@pytest.mark.parametrize('n,cluster', [(257, 4), (384, 8), (528, 8),
                                       (528, 16), (640, 16), (865, 16),
                                       (866, 16)])
def test_fused_sweep_cluster_route_matches_its_plain_version(cuda_device, n,
                                                             cluster):
    """The cluster route (the rows spread over a cluster of blocks in
    registers, row e and the sums crossing through distributed shared
    memory) at every compiled (K, L) and cluster sizes 4 to 16, 1ZE7's
    n = 528 and 1AMB's 865 / 866 among them, against the plain loop on the
    card: decisions away from the margin fp32 resolves, Minv within 1e-5
    of the walker's max, logdet within ``_logdet_scale``; one launch
    counted."""
    from repro_torch.kernels.fused_sweep import kernel as fsk
    shape = fsk.launch_shape(n, n, 2 * n, route='cluster', cluster=cluster)
    assert (shape.route, shape.cluster) == ('cluster', cluster)
    blk = _sweep_case(cuda_device, n, 8, seed=n + cluster)
    before = fsk.COUNTER.n
    out_k = _sweep(blk, True, route='cluster', cluster=cluster)
    assert fsk.COUNTER.n == before + 1
    out_p = _sweep(blk, False)
    torch.cuda.synchronize()
    _sweeps_agree(out_k, out_p, near=_fp32_margin_scale(blk, out_p),
                  ltol=_logdet_scale(blk, out_p))


@pytest.mark.parametrize('logu,accept', [(1e30, False), (-1e30, True)],
                         ids=['all-reject', 'all-accept'])
def test_fused_sweep_cluster_route_all_reject_and_all_accept(cuda_device,
                                                             logu, accept):
    """Every move rejected leaves the state as it was, bit for bit; every
    move accepted lands each electron on its proposal and agrees with the
    plain loop (each block divides and updates on every move)."""
    blk = _sweep_case(cuda_device, 300, 4, seed=3)
    blk['logu'] = torch.full_like(blk['logu'], logu)
    out_k = _sweep(blk, True, route='cluster')
    torch.cuda.synchronize()
    assert bool((out_k[6] == accept).all())
    if not accept:
        for got, want in zip(out_k[:4], (blk['r'], blk['minv'], blk['sign'],
                                         blk['logdet'])):
            assert torch.equal(got, want)
        return
    assert torch.equal(out_k[0][:, :300], blk['r_prop'])
    _sweeps_agree(out_k, _sweep(blk, False), ltol=_logdet_scale(
        blk, _sweep(blk, False)))


def _move_sweep(blk, kernel):
    """One spin block's sweep move by move through ``sem_move`` (the
    kernel) or its plain version on the card: each move's proposal values
    and e-n delta from ``blk``, its e-e delta against the side's own
    current positions.  Returns what ``_sweep`` returns."""
    from repro_torch.kernels.fused_sweep.ref import _ee_sum
    from repro_torch.kernels.sem_update.ops import sem_move
    from repro_torch.kernels.sem_update.ref import sem_move_ref
    dev = blk['minv'].device
    W, n = blk['logu'].shape
    P = rdet = ci = None
    if 'ci' in blk:
        P, rdet, ro, h, p, c = blk['ci']
        P, rdet = P.clone(), rdet.clone()
        ci = (ro, h, p, c) if kernel else (ro, h.long(), p.long(), c)
    st = (blk['r'].clone(), blk['minv'].clone(), blk['sign'].clone(),
          blk['logdet'].clone(), P, rdet)
    acc = torch.zeros((n, W), dtype=torch.bool, device=dev)
    mar = torch.zeros((n, W), device=dev)
    one = torch.ones((), device=dev)
    for e in range(n):
        r = st[0]
        d_jas = (_ee_sum(r, e, blk['r_prop'][:, e], n, one)
                 - _ee_sum(r, e, r[:, e], n, one) + blk['en'][:, e])
        args = (blk['phi'][:, e], blk['r_prop'][:, e], d_jas,
                blk['logu'][:, e], e, e)
        if kernel:
            st = sem_move(st, *args, acc, mar, ci)
        else:
            st, acc[e], mar[e] = sem_move_ref(st, *args, ci)
    return (*st, acc.T, mar.T)


def _move_variants():
    from repro_torch.kernels.sem_update import kernel as suk
    return [(v, ci) for v in suk.MOVE_VARIANTS for ci in (False, True)]


@pytest.mark.parametrize('variant,ci', _move_variants(),
                         ids=lambda v: str(v))
def test_sem_move_every_compiled_variant(cuda_device, variant, ci):
    """Every (CPL, RPW) the source compiles, with and without CI, at the
    widest block the chooser gives it ((0, 0): n = 300, rows past one SM's
    shared memory), a block's sweep move by move against the plain version
    on the card; one launch a move counted; the chooser's shared memory
    and thread cap as the source counts them."""
    from repro_torch.kernels.sem_update import kernel as suk
    n = 32 * variant[0] if variant[1] else 300
    sizes = (n, n + 20, n + 20, 50, True) if ci else (n, n)
    shape = suk.move_shape(*sizes, optin=suk.device_optin(cuda_device))
    assert (shape.cpl, shape.rpw) == variant
    lib = suk._move_lib()
    assert lib.sem_move_max_threads(*variant) == suk.move_max_threads(
        *variant)
    assert lib.sem_move_smem_bytes(
        n, sizes[1], *((n + 20, 50, 1) if ci else (0, 0, 0)),
        shape.smem_rows) == shape.smem_bytes
    blk = _sweep_case(cuda_device, n, 8, seed=n + 7 * ci,
                      **(dict(n_orb=n + 20, n_det=50) if ci else {}))
    before = suk.MOVE_COUNTER.n
    out_k = _move_sweep(blk, True)
    assert suk.MOVE_COUNTER.n == before + n
    out_p = _move_sweep(blk, False)
    torch.cuda.synchronize()
    _sweeps_agree(out_k, out_p, _fp32_margin_scale(blk, out_p))


def _rank_k_case(device, k, n=79, n_orb=118, W=16, seed=31):
    """``_sweep_case`` with an expansion of excitation rank k (the port's
    ``from_excitations``): per determinant 1..k excitations of the up
    block."""
    from repro_torch.core import multidet
    rng = np.random.default_rng(seed)
    exc, seen = [], set()
    while len(exc) < 40:
        deg = int(rng.integers(1, k + 1))
        h = sorted(rng.choice(n, deg, replace=False).tolist())
        p = sorted((n + rng.choice(n_orb - n, deg, replace=False)).tolist())
        if repr((h, p)) not in seen:
            seen.add(repr((h, p)))
            exc.append(((h, p), ([], [])))
    exc[0] = ((list(range(k)), list(range(n, n + k))), ([], []))
    coeffs = np.concatenate([[1.0], 0.2 * rng.choice([-1.0, 1.0], 40)])
    mdw = multidet.from_excitations(coeffs, exc, n, n, n_orb)
    assert mdw.k == k
    ci_t = multidet.pin(mdw, n, n, device)
    blk = _sweep_case(device, n, W, seed, n_orb=n_orb, n_det=41)
    P = blk['ci'][0]
    blk['ci'] = (P, multidet.det_ratios(P, ci_t.holes_up, ci_t.parts_up)
                 .contiguous(), blk['ci'][2][:, :41].contiguous(),
                 ci_t.holes_up_k, ci_t.parts_up_k, ci_t.coeffs)
    return blk


def _rank_tolerance(blk, out_p, k):
    """The tables' bound at excitation rank k: 1e-5 of the walker's max up
    to rank 8; past it, per walker, 3x the plain fp32 sweep's own distance
    from the same sweep in float64 (over Minv, P and rdet), and at least
    1e-5: fp32 resolves a k x k determinant (k up to 39) only to that
    distance, whatever the order of the elimination."""
    if k <= 8:
        return 1e-5

    def _d(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() \
            else x
    b64 = {key: _d(v) for key, v in blk.items() if key != 'ci'}
    b64['ci'] = tuple(_d(x) for x in blk['ci'])
    out_64 = _sweep(b64, False)
    dist = torch.zeros(out_p[0].shape[0], dtype=torch.float64,
                       device=out_p[0].device)
    for i in (1, 4, 5):
        p, p64 = out_p[i].flatten(1).double(), out_64[i].flatten(1)
        dist = torch.maximum(dist, (p - p64).abs().amax(dim=1)
                             / p64.abs().amax(dim=1))
    return torch.clamp(3.0 * dist, min=1e-5)


@pytest.mark.parametrize('k', [3, 8, 9, 16, 39])
def test_sem_move_takes_any_ci_rank(cuda_device, k):
    """Excitation ranks 3 (cofactors), 8 (pivoted elimination in
    registers), 9, 16 and 39 (the same elimination in the device
    workspace; 39 = n_orb - n, the most an expansion over these orbitals
    has) in the kernel, against the plain version (past rank 8 the tables
    within ``_rank_tolerance``)."""
    blk = _rank_k_case(cuda_device, k)
    out_p = _move_sweep(blk, False)
    _sweeps_agree(_move_sweep(blk, True), out_p,
                  tol=_rank_tolerance(blk, out_p, k))


@pytest.mark.parametrize('route', ['rows', 'cluster', 'shared', 'global'])
@pytest.mark.parametrize('k', [3, 8, 9, 16, 39])
def test_fused_sweep_takes_any_ci_rank(cuda_device, k, route):
    """The fused sweep at excitation ranks 3, 8 (registers; on the cluster
    route the cofactors, then the elimination in a shared-memory slot), 9,
    16 and 39 (the device workspace) on each of its four CI routes,
    against the plain loop (past rank 8 the tables within
    ``_rank_tolerance``); one launch counted (on the cluster route also
    one of the replay).  The cluster route takes CI up to rank 8: forced
    past it, it raises and launches nothing."""
    from repro_torch.kernels.fused_sweep import kernel as fsk
    blk = _rank_k_case(cuda_device, k)
    before, replays = fsk.COUNTER.n, fsk.REPLAY_COUNTER.n
    if route == 'cluster' and k > 8:
        with pytest.raises(ValueError, match='cluster route cannot hold'):
            _sweep(blk, True, route=route)
        assert (fsk.COUNTER.n, fsk.REPLAY_COUNTER.n) == (before, replays)
        return
    out_k = _sweep(blk, True, route=route)
    assert fsk.COUNTER.n == before + 1
    assert fsk.REPLAY_COUNTER.n == replays + (route == 'cluster')
    out_p = _sweep(blk, False)
    torch.cuda.synchronize()
    _sweeps_agree(out_k, out_p, tol=_rank_tolerance(blk, out_p, k))


def _unequal_spin_case(device, n_up, n_dn, n_orb, k, W=16, seed=41):
    """The down block of an expansion over n_up > n_dn electrons whose up
    block holds one k-fold excitation (k > n_dn) and whose down block
    singles and doubles: ``from_excitations`` pads both blocks' lists to
    rank k, so the down block's lists carry k slots for its n_dn
    electrons.  ``_sweep_case`` at n = n_dn with those lists."""
    from repro_torch.core import multidet
    rng = np.random.default_rng(seed)
    exc, seen = [((list(range(k)), list(range(n_up, n_up + k))),
                  ([], []))], set()
    while len(exc) < 5:
        d = 1 + len(exc) % 2
        e = (([], []), (sorted(rng.choice(n_dn, d, replace=False).tolist()),
                        sorted((n_dn + rng.choice(n_orb - n_dn, d,
                                                  replace=False)).tolist())))
        if repr(e) not in seen:
            seen.add(repr(e))
            exc.append(e)
    coeffs = np.concatenate([[1.0], 0.2 * rng.choice([-1.0, 1.0], 5)])
    ci_t = multidet.pin(multidet.from_excitations(coeffs, exc, n_up, n_dn,
                                                  n_orb), n_up, n_dn, device)
    assert tuple(ci_t.holes_dn_k.shape) == (6, k) and k > n_dn
    blk = _sweep_case(device, n_dn, W, seed, n_orb=n_orb, n_det=6)
    P = blk['ci'][0]
    blk['ci'] = (P, multidet.det_ratios(P, ci_t.holes_dn, ci_t.parts_dn)
                 .contiguous(), blk['ci'][2], ci_t.holes_dn_k,
                 ci_t.parts_dn_k, ci_t.coeffs)
    return blk


@pytest.mark.parametrize('kernel', ['sem_move', 'fused_sweep'])
@pytest.mark.parametrize('n_up,n_dn,n_orb,k', [(3, 2, 6, 3),
                                               (12, 6, 30, 10)])
def test_down_block_lists_padded_past_its_electrons(cuda_device, kernel,
                                                    n_up, n_dn, n_orb, k):
    """Unequal spin blocks whose up block holds a k-fold excitation with
    k > n_dn (3 up / 2 down with an up triple, as a full-CI expansion of a
    boron atom has; 12 / 6 with a 10-fold one, in the device workspace):
    the down block's sweep in the kernel against the plain version (past
    rank 8 the tables within ``_rank_tolerance``)."""
    blk = _unequal_spin_case(cuda_device, n_up, n_dn, n_orb, k)
    fn = _move_sweep if kernel == 'sem_move' else _sweep
    out_k = fn(blk, True)
    out_p = fn(blk, False)
    torch.cuda.synchronize()
    _sweeps_agree(out_k, out_p, tol=_rank_tolerance(blk, out_p, k))


@pytest.mark.parametrize('n,cluster', [(300, 4), (528, 8), (528, 16),
                                       (866, 16)])
def test_fused_sweep_cluster_route_with_ci_matches_its_plain_version(
        cuda_device, n, cluster):
    """The cluster route with CI (rank 2, 100 determinants over n + n // 2
    orbitals: the ``--n-det 100`` widths of 1ZE7 and 1AMB at n = 528 and
    866) and the replay of P after it, against the plain loop: decisions,
    Minv, every row of P and rdet; one launch of each counted, the chain
    as 'cluster ci'."""
    from repro_torch.kernels.fused_sweep import kernel as fsk
    n_orb = n + n // 2
    blk = _sweep_case(cuda_device, n, 8, seed=n + cluster, n_orb=n_orb,
                      n_det=100)
    by, replays = fsk.COUNTER.by.get('cluster ci', 0), fsk.REPLAY_COUNTER.n
    out_k = _sweep(blk, True, route='cluster', cluster=cluster)
    assert fsk.COUNTER.by['cluster ci'] == by + 1
    assert fsk.REPLAY_COUNTER.n == replays + 1
    out_p = _sweep(blk, False)
    torch.cuda.synchronize()
    _sweeps_agree(out_k, out_p, near=_fp32_margin_scale(blk, out_p),
                  ltol=_logdet_scale(blk, out_p))


@pytest.mark.parametrize('logu,accept', [(1e30, False), (-1e30, True)],
                         ids=['all-reject', 'all-accept'])
def test_fused_sweep_cluster_route_with_ci_all_reject_and_all_accept(
        cuda_device, logu, accept):
    """With CI, every move rejected leaves the state, P and rdet included,
    as it was, bit for bit (the replay finds no move); every move
    accepted lands each electron on its proposal and agrees with the
    plain loop."""
    blk = _sweep_case(cuda_device, 300, 4, seed=4, n_orb=450, n_det=100)
    blk['logu'] = torch.full_like(blk['logu'], logu)
    out_k = _sweep(blk, True, route='cluster')
    torch.cuda.synchronize()
    assert bool((out_k[6] == accept).all())
    if not accept:
        for got, want in zip(out_k[:6], (blk['r'], blk['minv'], blk['sign'],
                                         blk['logdet'], *blk['ci'][:2])):
            assert torch.equal(got, want)
        return
    assert torch.equal(out_k[0][:, :300], blk['r_prop'])
    out_p = _sweep(blk, False)
    _sweeps_agree(out_k, out_p, ltol=_logdet_scale(blk, out_p))


@pytest.mark.parametrize('n_up,n_dn,n_orb,k', [(3, 2, 6, 3),
                                               (12, 6, 30, 8)])
def test_fused_sweep_cluster_route_with_ci_down_block_padded(
        cuda_device, n_up, n_dn, n_orb, k):
    """The cluster route with CI on a down block whose lists are padded
    past its electrons (an up excitation of rank k > n_dn): the sentinels'
    entries come from the compact table's constants, against the plain
    loop."""
    blk = _unequal_spin_case(cuda_device, n_up, n_dn, n_orb, k)
    out_k = _sweep(blk, True, route='cluster')
    out_p = _sweep(blk, False)
    torch.cuda.synchronize()
    _sweeps_agree(out_k, out_p)


def test_fused_sweep_p_replay_matches_its_plain_version(cuda_device):
    """The replay alone (``kernel.p_replay_inplace``) against
    ``ref.p_replay_ref`` on random rows, phi and flags, at each compiled
    (RW, J) of ``REPLAY_VARIANTS`` at the widest n it takes (32 J: 256,
    544, 896; every third row of P replayed, the others left alone bit
    for bit): within 1e-5 of the walker's max; one launch counted each;
    nothing launched for an empty row list."""
    from repro_torch.kernels.fused_sweep import kernel as fsk
    from repro_torch.kernels.fused_sweep.ref import p_replay_ref
    rng = np.random.default_rng(9)

    def _n(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape))
                                .astype(np.float32)).to(cuda_device)
    for n in (32 * j for _, j in fsk.REPLAY_VARIANTS):
        W, n_orb, ldr = 4, n + n // 2, -(-n // 4) * 4
        P, rows = _n(W, n_orb, n), _n(W, n, ldr, s=0.01)
        phi = _n(W, n, n_orb, s=0.05)
        acc = torch.from_numpy(rng.uniform(size=(W, n)) < 0.6).to(
            cuda_device)
        rep = torch.arange(0, n_orb, 3, dtype=torch.int32,
                           device=cuda_device)
        want = p_replay_ref(P, rows, phi, acc, rep.long())
        got, before = P.clone(), fsk.REPLAY_COUNTER.n
        fsk.p_replay_inplace(got, rows, phi, acc.to(torch.uint8), rep)
        torch.cuda.synchronize()
        assert fsk.REPLAY_COUNTER.n == before + 1
        assert torch.equal(got[:, 1::3], P[:, 1::3])
        assert torch.equal(got[:, 2::3], P[:, 2::3])
        err = (got - want).abs().amax(dim=(1, 2))
        assert bool((err <= 1e-5 * want.abs().amax(dim=(1, 2))).all())
        fsk.p_replay_inplace(got, rows, phi, acc, rep[:0])
        assert fsk.REPLAY_COUNTER.n == before + 1


def test_sem_move_rejected_walkers_write_nothing(cuda_device):
    """One move with CI in which walker 0 has NaN in row e and walker 1 a
    zero ratio (an infinite row): both rejected, their Minv, P, rdet, r,
    sign and logdet bitwise as they were."""
    from repro_torch.kernels.sem_update.ops import sem_move
    blk = _sweep_case(cuda_device, 79, 8, seed=3, n_orb=118, n_det=100)
    P, rdet, ro, h, p, c = blk['ci']
    minv = blk['minv'].clone()
    minv[0, 0] = float('nan')
    v = blk['phi'][:, 0].clone()
    v[1] = 0.0
    st0 = (blk['r'], minv, blk['sign'], blk['logdet'], P, rdet)
    st = tuple(x.clone() for x in st0)
    acc = torch.zeros((1, 8), dtype=torch.bool, device=cuda_device)
    mar = torch.zeros((1, 8), device=cuda_device)
    sem_move(st, v, blk['r_prop'][:, 0], torch.zeros(8, device=cuda_device),
             blk['logu'][:, 0], 0, 0, acc, mar, (ro, h, p, c))
    torch.cuda.synchronize()
    assert not acc[0, :2].any()
    for got, want in zip(st, st0):
        assert torch.equal(got[:2].contiguous().view(torch.int32),
                           want[:2].contiguous().view(torch.int32))


def _opt_o_card_vs_cpu(cuda_device, n_det, screen_eps=None):
    """opt-vmc's batched O on ``smallest`` on the card against the same
    estimator on the CPU, on 8 of 32 seeded walkers farthest from a node:
    rtol 1e-4 plus 1e-5 of the walker's largest |O| in each part (Jastrow;
    CI).  The CI ratios take one MO-product launch (screened_mo with
    ``screen_eps``, else sparse_mo); the Jastrow part none."""
    from repro_torch.core.wavefunction import psi_state_batched
    from repro_torch.optimize.estimators import n_params, o_batched
    from repro_torch.systems import build_system
    cfg_c, params_c = build_system('smallest', n_det=n_det,
                                   screen_eps=screen_eps, device='cpu')
    cfg_g, params_g = build_system('smallest', n_det=n_det,
                                   screen_eps=screen_eps, device=cuda_device)
    rng = np.random.default_rng(11)
    coords = params_c.coords.numpy()
    charges = params_c.charges.numpy()
    at = rng.choice(len(coords), (32, cfg_c.n_elec), p=charges / charges.sum())
    R = (coords[at] + 1.2 * rng.normal(size=(32, cfg_c.n_elec, 3))
         ).astype(np.float32)
    st = psi_state_batched(cfg_c, params_c, torch.from_numpy(R))
    d = st.drift.abs().amax(dim=(1, 2)).numpy()
    d[~np.isfinite(st.e_loc.numpy())] = np.inf
    R = R[np.argsort(d)[:8]]
    want = o_batched(cfg_c, params_c, torch.from_numpy(R)).numpy()
    before = (sm_kernel.COUNTER.n, scr_kernel.COUNTER.n)
    got = o_batched(cfg_g, params_g, torch.from_numpy(R).to(cuda_device))
    n_ci = 1 if n_det > 1 else 0
    assert (sm_kernel.COUNTER.n - before[0], scr_kernel.COUNTER.n
            - before[1]) == ((0, n_ci) if screen_eps else (n_ci, 0))
    got = got.cpu().numpy()
    assert got.shape == (8, n_params(cfg_c))
    atol = np.zeros_like(want)
    for part in (slice(0, 3), slice(3, None)):
        if want[:, part].size:
            atol[:, part] = 1e-5 * np.abs(want[:, part]).max(axis=1,
                                                             keepdims=True)
    assert np.all(np.abs(got - want) <= atol + 1e-4 * np.abs(want))


@pytest.mark.parametrize('n_det', [1, 100])
def test_opt_o_on_the_card_matches_the_cpu_path(cuda_device, n_det):
    """O on ``smallest`` (P = 3, and P = 103 with 100 determinants): card
    against CPU, one sparse_mo launch for the CI ratios."""
    _opt_o_card_vs_cpu(cuda_device, n_det)


def test_opt_o_screened_on_the_card_matches_the_cpu_path(cuda_device):
    """O on ``smallest`` with 100 determinants and ``--screen-eps 1e-8``:
    card against CPU, the CI ratios from one screened_mo launch and no
    sparse_mo launch."""
    _opt_o_card_vs_cpu(cuda_device, 100, screen_eps=1e-8)
