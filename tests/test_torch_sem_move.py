"""The per-move sweep's one call a move, ``kernels.sem_update.ops.sem_move``,
against the JAX package, and its launch chooser.

The plain version ``sem_move_ref`` (what the CPU runs, and what the CUDA
kernel ``csrc/sem_move.cu`` is held to on the card) is held against the
reference's move, ``repro.kernels.fused_sweep.ref._move_step``, on the same
seeded numpy inputs, with the Jastrow delta the reference computes handed
to both; with and without a CI expansion, at excitation ranks 2 and 3.
The chooser ``kernel.move_shape`` is a pure function of the sizes; the
kernel itself runs only on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.core import multidet as j_md  # noqa: E402
from repro.kernels.fused_sweep import ref as j_fs  # noqa: E402
from repro.systems.bench import synthetic_ci as j_synthetic_ci  # noqa: E402

from repro_torch.core import multidet  # noqa: E402
from repro_torch.kernels.sem_update import kernel as su_kernel  # noqa: E402
from repro_torch.kernels.sem_update.ops import sem_move  # noqa: E402
from repro_torch.kernels.sem_update.ref import sem_move_ref  # noqa: E402

MARGIN = 1e-5


def _rank3_ci(n, n_orb):
    """An expansion of excitation rank 3 over n_orb orbitals (reference
    builder ``from_excitations``): triples, a double and singles."""
    exc = [(([0, 2, 4], [n, n + 1, n + 3]), ([], [])),
           (([], []), ([1, 3, 5], [n + 2, n + 4, n + 5])),
           (([1, 6], [n + 1, n + 6]), ([0], [n + 3])),
           (([n - 1], [n]), ([], [])),
           (([], []), ([n - 2], [n + 7]))]
    coeffs = np.array([1.0, 0.21, -0.17, 0.12, 0.3, -0.25], np.float32)
    ci = j_md.from_excitations(coeffs, exc, n, n, n_orb)
    assert ci.k == 3
    return ci


def _move_case(seed, W, n, ci=None):
    """One spin block's state at a well-conditioned point (numpy, seeded):
    Minv the inverse of D = I + 0.1 G / sqrt(n), n_e = 2n electrons, each
    electron's proposal values its own column plus noise; with a CI
    expansion the virtual orbitals' values, the table P and the ratios as
    the path builds them."""
    rng = np.random.default_rng(seed)

    def _n(*shape, s=1.0):
        return (s * rng.normal(size=shape)).astype(np.float32)
    D = np.eye(n, dtype=np.float32) + _n(W, n, n, s=0.1 / np.sqrt(n))
    minv = np.linalg.inv(D.astype(np.float64)).astype(np.float32)
    case = dict(minv=minv, r=_n(W, 2 * n, 3, s=2.0),
                sign=np.ones(W, np.float32), logdet=_n(W, s=0.5),
                phi=np.swapaxes(D, 1, 2) + _n(W, n, n, s=0.3 / np.sqrt(n)),
                rp=_n(W, n, 3, s=0.3), en=_n(W, n, s=0.05),
                logu=np.log(rng.uniform(1e-6, 1.0, (W, n))).astype(
                    np.float32))
    case['rp'] += case['r'][:, :n]
    if ci is not None:
        n_orb = ci.n_orb
        V = _n(W, n_orb - n, n, s=0.3)
        P = multidet.reference_table(torch.from_numpy(np.concatenate(
            [D, V], axis=1)), torch.from_numpy(minv))
        case['phi'] = np.concatenate(
            [case['phi'], np.swapaxes(V, 1, 2) + _n(W, n, n_orb - n, s=0.1)],
            axis=-1)
        case['P'] = P.numpy()
        case['rdet'] = multidet.det_ratios(
            P, ci.holes_up, ci.parts_up).numpy()
        case['r_other'] = 1.0 + _n(W, ci.coeffs.shape[0], s=0.1)
    return case


def _jax_move(case, e, ci):
    """The reference's move e of the block (offset 0): its new state, its
    accepts and the Jastrow delta it used."""
    n = case['minv'].shape[1]
    r = jnp.asarray(case['r'])
    rp = jnp.asarray(case['rp'][:, e])
    b_ee = jnp.float32(1.0)
    d_jas = (j_fs._ee_sum(r, e, rp, n, b_ee, 2 * n)
             - j_fs._ee_sum(r, e, r[:, e], n, b_ee, 2 * n)
             + jnp.asarray(case['en'][:, e]))
    W = r.shape[0]
    P = jnp.asarray(case.get('P', np.zeros((W, 0, 0), np.float32)))
    rdet = jnp.asarray(case.get('rdet', np.zeros((W, 0), np.float32)))
    ci_args = None
    if ci is not None:
        ci_args = (jnp.asarray(ci.holes_up), jnp.asarray(ci.parts_up),
                   jnp.asarray(ci.coeffs), jnp.asarray(case['r_other']))
    state = (r, jnp.asarray(case['minv']), jnp.asarray(case['sign']),
             jnp.asarray(case['logdet']), P, rdet)
    new, acc = j_fs._move_step(state, e, jnp.asarray(case['phi'][:, e]), rp,
                               jnp.asarray(case['en'][:, e]),
                               jnp.asarray(case['logu'][:, e]), b_ee,
                               offset=0, n_up=n, n_occ=n, n_e_valid=2 * n,
                               ci_args=ci_args)
    return [np.asarray(x) for x in new], np.asarray(acc), np.asarray(d_jas)


def _port_move(case, e, d_jas, ci, dispatch=False):
    """The port's move e through ``sem_move_ref`` (or ``ops.sem_move``)."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    state = (t['r'], t['minv'], t['sign'], t['logdet'], t.get('P'),
             t.get('rdet'))
    cia = None
    if ci is not None:
        cia = (t['r_other'], torch.as_tensor(np.asarray(ci.holes_up)),
               torch.as_tensor(np.asarray(ci.parts_up)),
               torch.as_tensor(np.asarray(ci.coeffs)))
    args = (t['phi'][:, e], t['rp'][:, e], torch.from_numpy(np.array(d_jas)),
            t['logu'][:, e], e, e)
    if not dispatch:
        return sem_move_ref(state, *args, cia)
    W, n = case['logu'].shape
    acc = torch.zeros((n, W), dtype=torch.bool)
    margin = torch.zeros((n, W))
    state = sem_move(state, *args, acc, margin, cia)
    return state, acc, margin


def _ci_of(kind, n):
    if kind == 'single':
        return None
    if kind == 'rank2':
        return j_synthetic_ci(n, n, n + 9, 12, seed=4)
    return _rank3_ci(n, n + 9)


@pytest.mark.parametrize('kind', ['single', 'rank2', 'rank3'])
def test_sem_move_plain_version_matches_jax_move(kind):
    """Moves e = 0, n/2, n-1 of a block from the same state: identical
    decisions away from the threshold; Minv (and P, rdet) within 1e-5 of
    each walker's max; r and sign equal; logdet to fp32 rounding."""
    W, n = 24, 12
    ci = _ci_of(kind, n)
    case = _move_case({'single': 1, 'rank2': 2, 'rank3': 3}[kind], W, n, ci)
    seen = set()
    for e in (0, n // 2, n - 1):
        (r_j, m_j, s_j, l_j, p_j, d_j), acc_j, dj = _jax_move(case, e, ci)
        (r_t, m_t, s_t, l_t, p_t, d_t), acc_t, mar_t = _port_move(
            case, e, dj, ci)
        acc_t, mar_t = acc_t.numpy(), mar_t.numpy()
        clean = np.abs(mar_t) >= MARGIN
        np.testing.assert_array_equal(acc_t[clean], acc_j[clean])
        assert not np.any(acc_t & ~(mar_t > 0))      # accept: margin > 0
        if ci is None:
            np.testing.assert_array_equal(acc_t, mar_t > 0)
        seen.update(acc_t[clean].tolist())
        c = clean
        np.testing.assert_array_equal(r_t.numpy()[c], r_j[c])
        np.testing.assert_array_equal(s_t.numpy()[c], s_j[c])
        np.testing.assert_allclose(l_t.numpy()[c], l_j[c], rtol=1e-6,
                                   atol=1e-6)
        for got, want in ((m_t, m_j), (p_t, p_j), (d_t, d_j)):
            if got is None:
                continue
            got = got.numpy()[c].reshape(int(c.sum()), -1)
            want = want[c].reshape(int(c.sum()), -1)
            scale = np.abs(want).max(axis=1)
            assert np.all(np.abs(got - want).max(axis=1) <= 1e-5 * scale)
    assert seen == {True, False}, 'the case must accept and reject'


def test_sem_move_dispatch_on_the_cpu_writes_row_e():
    """On CPU tensors ``ops.sem_move`` runs the plain version: the same new
    state, and the move's accepts and margins in row e of the sweep's
    (n_blk, W) outputs, the other rows untouched."""
    W, n = 16, 10
    ci = _ci_of('rank2', n)
    case = _move_case(3, W, n, ci)
    e = 4
    _, _, dj = _jax_move(case, e, ci)
    (st_p, acc_p, mar_p) = _port_move(case, e, dj, ci)
    st_d, acc, margin = _port_move(case, e, dj, ci, dispatch=True)
    for a, b in zip(st_p, st_d):
        assert torch.equal(a, b)
    assert torch.equal(acc[e], acc_p) and torch.equal(margin[e], mar_p)
    others = [i for i in range(n) if i != e]
    assert not acc[others].any() and not margin[others].any()


def test_sem_move_plain_version_rejects_a_poisoned_walker():
    """A walker whose row e is NaN, and one whose proposal gives a zero
    ratio (with CI an infinite row_t), are rejected with their state
    unchanged."""
    W, n = 8, 10
    ci = _ci_of('rank2', n)
    case = _move_case(9, W, n, ci)
    case['minv'][0, 0] = np.nan
    case['phi'][1, 0] = 0.0
    (r, m, s, l, P, rdet), acc, _ = _port_move(case, 0, np.zeros(W,
                                                                 np.float32),
                                               ci)
    assert not acc[:2].any()
    for got, want in ((r, 'r'), (m, 'minv'), (s, 'sign'), (l, 'logdet'),
                      (P, 'P'), (rdet, 'rdet')):
        np.testing.assert_array_equal(got.numpy()[:2], case[want][:2])


# ---------------------------------------------------------------------------
# the launch chooser (pure function of the sizes)
# ---------------------------------------------------------------------------
def test_move_variants_are_read_from_the_source():
    """The compiled (CPL, RPW) list comes from ``MOVE_VARIANTS`` in
    ``csrc/sem_move.cu``: register variants by growing width, then (0, 0),
    which takes any n."""
    v = su_kernel.MOVE_VARIANTS
    assert v[-1] == (0, 0) and len(v) >= 2
    cpls = [c for c, r in v[:-1]]
    assert cpls == sorted(cpls) and all(r > 0 for _, r in v[:-1])
    src = (su_kernel._build.CSRC / 'sem_move.cu').read_text()
    for c, r in v:
        assert f'X({c}, {r})' in src


@pytest.mark.parametrize('n', [1, 31, 32, 33, 79, 96, 97, 128, 160, 217,
                               256, 257, 528, 866])
@pytest.mark.parametrize('ci', [False, True])
def test_move_shape_picks_the_narrowest_variant_that_holds_the_row(n, ci):
    n_orb, n_det = (n + 39, 100) if ci else (0, 0)
    shape = su_kernel.move_shape(n, n_orb if ci else n, n_orb, n_det, ci)
    regs = [v for v in su_kernel.MOVE_VARIANTS if v[1] and 32 * v[0] >= n]
    assert (shape.cpl, shape.rpw) == (regs[0] if regs else (0, 0))
    assert 32 <= shape.threads <= su_kernel.move_max_threads(shape.cpl,
                                                             shape.rpw)
    assert shape.threads % 32 == 0
    rows = n + n_orb
    over = max(0, rows - shape.rpw * shape.threads // 32)
    assert 0 <= shape.smem_rows <= over
    assert shape.smem_bytes == su_kernel.move_smem_bytes(
        n, n_orb if ci else n, n_orb, n_det, ci, shape.smem_rows)
    assert shape.smem_bytes <= su_kernel.OPTIN_H100
    if shape.smem_rows < over:     # the rest go to device memory: it's full
        assert shape.smem_bytes + 4 * n > su_kernel.OPTIN_H100


def test_move_shape_at_the_main_path_widths():
    """smallest (n = 79): 10 warps of 8 rows in registers, no overflow;
    with CI (n_orb = 118, n_det = 100) the table rows too, 25 warps; the
    b-strand (n = 217): 16 warps hold 128 rows, the other 89 in shared
    memory."""
    s = su_kernel.move_shape(79, 79)
    assert (s.cpl, s.rpw, s.threads, s.smem_rows) == (3, 8, 320, 0)
    s = su_kernel.move_shape(79, 118, 118, 100, True)
    assert (s.cpl, s.rpw, s.threads, s.smem_rows) == (3, 8, 800, 0)
    s = su_kernel.move_shape(217, 217)
    assert (s.cpl, s.rpw, s.threads, s.smem_rows) == (8, 8, 512, 89)


def test_move_shape_refuses_what_shared_memory_cannot_hold():
    """Rows that do not fit go to device memory, but the per-walker
    buffers (v, row e, g, the determinant ratios) must fit one block: an
    expansion too long for them raises before anything is launched."""
    with pytest.raises(ValueError, match='shared memory'):
        su_kernel.move_shape(79, 118, 118, 60000, True)


def test_move_max_threads_leave_each_thread_its_registers():
    for cpl, rpw in su_kernel.MOVE_VARIANTS:
        t = su_kernel.move_max_threads(cpl, rpw)
        assert t % 128 == 0 and 128 <= t <= 1024
        if rpw:
            need = rpw * cpl + rpw + cpl + 32
            assert t * need <= 65536


def test_sem_move_kernel_names_its_rank_cap():
    """The kernel takes any excitation rank up to its cap; above the cap
    (and below the padded rank 2) the wrapper raises and names it, before
    anything is launched."""
    W, n, n_orb, n_det = 2, 3, 12, 4
    f = torch.zeros
    before = su_kernel.MOVE_COUNTER.n
    for k in (su_kernel.MAX_RANK + 1, 1):
        h = torch.zeros((n_det, k), dtype=torch.int32)
        ci = (f(W, n_orb, n), f(W, n_det), f(W, n_det), h, h, f(n_det))
        with pytest.raises(ValueError, match=f'rank <= {su_kernel.MAX_RANK}'):
            su_kernel.sem_move_inplace(
                f(W, n, n), f(W, n_orb), f(W, 2 * n, 3), f(W, 3), f(W),
                f(W), f(W), f(W), torch.zeros(W, dtype=torch.bool), f(W), 0,
                0, ci)
    assert su_kernel.MOVE_COUNTER.n == before
