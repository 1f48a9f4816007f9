"""The electron tiles of the two MO-product kernels, on the CPU.

The CUDA kernels take the electrons in the order of a spatial key (the
nearest atom) and write each column back at its caller's index; their
plain versions (``sparse_mo_rows_ref``, ``screened_mo_ref`` with
``order``) do the same on the CPU.  Here: the order is a permutation, the
plain versions equal the dense oracle (and the JAX package's) under a
random order, inactive entries cannot leak, an electron with no active AO
gives an exactly zero column, the keys are what the AO pass and the
candidate lists say, and the nearest-atom order cuts the AO rows a tile
needs to under half of the walker-major order's on the paper's systems.
Inputs are made with numpy from a seed; tolerances are 1e-5 of max |C|
(fp32 summation order).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

jax.config.update('jax_enable_x64', False)

from repro.kernels.screened_mo.ref import (  # noqa: E402
    screened_mo_ref as j_scr_mo_ref)
from repro.kernels.sparse_mo.ref import mo_products_ref as j_mo_ref  # noqa: E402

from repro_torch.core import aos, screening  # noqa: E402
from repro_torch.core.vmc import sample_positions  # noqa: E402
from repro_torch.kernels import mo_tile  # noqa: E402
from repro_torch.kernels.screened_mo.ops import (  # noqa: E402
    screened_mo_products)
from repro_torch.kernels.screened_mo.ref import screened_mo_ref  # noqa: E402
from repro_torch.kernels.sparse_mo.ops import (  # noqa: E402
    sparse_mo_products, sparse_mo_rows)
from repro_torch.kernels.sparse_mo.ref import (  # noqa: E402
    mo_products_ref, sparse_mo_rows_ref)
from repro_torch.systems import build_system  # noqa: E402


def _rows_case(seed, n_orb=24, n_ao=96, n_e=45, density=0.2):
    """A (n_orb, n_ao), AO rows B (n_e, n_ao, 5) zero outside the mask,
    mask (n_e, n_ao) with electrons 0 and 7 empty, a random permutation."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_orb, n_ao)).astype(np.float32)
    mask = rng.random((n_e, n_ao)) < density
    mask[[0, 7]] = False
    B = np.where(mask[..., None], rng.normal(size=(n_e, n_ao, 5)),
                 0.0).astype(np.float32)
    perm = rng.permutation(n_e).astype(np.int32)
    return A, B, mask, perm


def _packed_case(seed, n_orb=24, n_ao=96, n_e=45, K=24):
    """Packed candidate lists (ascending ids, inactive padding), electrons
    0 and 7 with no active slot, a random permutation."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_orb, n_ao)).astype(np.float32)
    idx = np.zeros((n_e, K), np.int32)
    active = np.zeros((n_e, K), bool)
    for e in range(n_e):
        cand = np.sort(rng.choice(n_ao, size=int(rng.integers(0, K + 1)),
                                  replace=False))
        idx[e, :len(cand)] = cand
        active[e, :len(cand)] = True
    active[[0, 7]] = False
    Bp = rng.normal(size=(n_e, K, 5)).astype(np.float32)
    return A, Bp, idx, active, rng.permutation(n_e).astype(np.int32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    atol = 1e-5 * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize('kind', ['uint8 atoms', 'int16 atoms',
                                  'int64 random', 'ties', 'none'])
def test_electron_order_is_a_stable_permutation(kind):
    n = 1000
    rng = np.random.default_rng(0)
    key = {'uint8 atoms': torch.from_numpy(
               rng.integers(0, 256, n).astype(np.uint8)),
           'int16 atoms': torch.from_numpy(
               rng.integers(0, 3804, n).astype(np.int16)),
           'int64 random': torch.from_numpy(rng.integers(-5, 10 ** 9, n)),
           'ties': torch.zeros(n, dtype=torch.int32),
           'none': None}[kind]
    order = mo_tile.electron_order(key, n)
    assert order.dtype == torch.int32 and order.shape == (n,)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(n, dtype=torch.int32))
    if key is not None:
        k = key[order.long()].long()
        assert bool((k[1:] >= k[:-1]).all())
        same = k[1:] == k[:-1]       # stable: ties keep the caller's order
        assert bool((order[1:][same] > order[:-1][same]).all())
    else:
        assert torch.equal(order, torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize('n_atoms,dtype', [(43, torch.uint8),
                                           (256, torch.uint8),
                                           (257, torch.int16),
                                           (2 ** 15, torch.int16),
                                           (2 ** 15 + 1, torch.int32)])
def test_tile_key_is_the_narrowest_type_of_an_atom_index(n_atoms, dtype):
    assert aos.tile_key_dtype(n_atoms) is dtype
    assert torch.iinfo(dtype).max >= n_atoms - 1


def test_electron_order_refuses_a_key_of_the_wrong_length():
    with pytest.raises(ValueError, match='key'):
        mo_tile.electron_order(torch.zeros(5, dtype=torch.int16), 6)


@pytest.mark.parametrize('seed', range(4))
def test_sparse_rows_plain_version_matches_dense_oracle_in_any_order(seed):
    """Under a random tile order the plain version of the rows entry is
    the dense product (the port's oracle and the JAX package's)."""
    A, B, mask, perm = _rows_case(seed)
    C = sparse_mo_rows_ref(*(torch.from_numpy(x) for x in (A, B, mask,
                                                           perm)))
    B_jax_layout = np.ascontiguousarray(B.transpose(1, 0, 2))
    _close(C, mo_products_ref(torch.from_numpy(A),
                              torch.from_numpy(B_jax_layout)))
    _close(C, j_mo_ref(jnp.asarray(A), jnp.asarray(B_jax_layout)))
    assert bool((C[:, [0, 7]] == 0).all())


@pytest.mark.parametrize('poison', [np.nan, 1e30])
def test_sparse_rows_inactive_entries_cannot_leak(poison):
    A, B, mask, perm = _rows_case(11)
    bad = np.where(mask[..., None], B, np.float32(poison))
    t = [torch.from_numpy(x) for x in (A, bad, mask, perm)]
    C = sparse_mo_rows_ref(*t)
    assert bool(torch.isfinite(C).all())
    assert bool((C[:, [0, 7]] == 0).all())
    _close(C, sparse_mo_rows_ref(torch.from_numpy(A), torch.from_numpy(B),
                                 t[2], t[3]))


def test_sparse_rows_entry_follows_its_key_and_the_jax_layout_entry():
    """``sparse_mo_rows`` (the main path's entry) sorts by its key, and
    ``sparse_mo_products`` (the reference's layout) is the same product."""
    A, B, mask, _ = _rows_case(5)
    key = torch.from_numpy(np.random.default_rng(5).integers(
        0, 9, B.shape[0]).astype(np.int16))
    tA, tB, tm = (torch.from_numpy(x) for x in (A, B, mask))
    C = sparse_mo_rows(tA, tB, tm, key)
    assert torch.equal(C, sparse_mo_rows_ref(
        tA, tB, tm, mo_tile.electron_order(key, B.shape[0])))
    C2 = sparse_mo_products(tA, tB.transpose(0, 1).contiguous(), tm)
    _close(C2, C)
    assert C.shape == C2.shape == (A.shape[0], B.shape[0], 5)


@pytest.mark.parametrize('seed', range(3))
def test_screened_plain_version_matches_oracles_in_any_order(seed):
    """``screened_mo_ref`` in a random tile order equals its own
    caller-order result and the JAX package's oracle."""
    A, Bp, idx, active, perm = _packed_case(seed)
    t = [torch.from_numpy(x) for x in (A, Bp, idx, active)]
    C = screened_mo_ref(*t, order=torch.from_numpy(perm), chunk=7)
    _close(C, screened_mo_ref(*t))
    _close(C, j_scr_mo_ref(*(jnp.asarray(x) for x in (A, Bp, idx, active))))
    assert bool((C[:, [0, 7]] == 0).all())


@pytest.mark.parametrize('poison', [np.nan, 1e30])
def test_screened_inactive_slots_cannot_leak_in_any_order(poison):
    A, Bp, idx, active, perm = _packed_case(12)
    bad = np.where(active[..., None], Bp, np.float32(poison))
    key = torch.from_numpy(perm.astype(np.int16))
    C = screened_mo_products(torch.from_numpy(A), torch.from_numpy(bad),
                             torch.from_numpy(idx), torch.from_numpy(active),
                             key)
    assert bool(torch.isfinite(C).all())
    assert bool((C[:, [0, 7]] == 0).all())
    _close(C, screened_mo_ref(*(torch.from_numpy(x)
                                for x in (A, Bp, idx, active))))


def test_both_plain_versions_agree_on_the_same_active_sets():
    """The rows entry and the packed entry (K = n_ao slots, every id) give
    the same C: the kernels' shared arithmetic, on the CPU."""
    A, B, mask, perm = _rows_case(21)
    n_e, n_ao = mask.shape
    idx = np.broadcast_to(np.arange(n_ao, dtype=np.int32), (n_e, n_ao))
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (A, B, idx, mask, perm)]
    _close(screened_mo_ref(t[0], t[1], t[2], t[3], order=t[4]),
           sparse_mo_rows_ref(t[0], t[1], t[3], t[4]))


@pytest.mark.parametrize('n_orb,stage', [(1, (4, 1)), (79, (80, 1)),
                                         (118, (60, 2)), (217, (76, 3)),
                                         (866, (80, 11))])
def test_stage_width_and_padded_transpose(n_orb, stage):
    """Stages of at most 80 orbitals, a multiple of 4, as few as fit; the
    kernels' At is A transposed with zero columns to whole stages, made
    once per parameter tensor and remade after an in-place change."""
    assert mo_tile.stage_width(n_orb) == stage
    w, s = stage
    assert w % mo_tile.OPT == 0 and w <= mo_tile.MAX_STAGE
    assert w * s >= n_orb and (s == 1 or
                               -(-n_orb // (s - 1)) > mo_tile.MAX_STAGE)
    A = torch.randn((n_orb, 13))
    At = mo_tile.transposed(A)
    assert At.shape == (13, w * s) and At.is_contiguous()
    assert torch.equal(At[:, :n_orb], A.t()) and not At[:, n_orb:].any()
    assert mo_tile.transposed(A) is At
    A.mul_(2.0)
    assert torch.equal(mo_tile.transposed(A)[:, :n_orb], A.t())


def test_output_view_is_the_callers_layout():
    buf, C = mo_tile.output(7, 79, 'cpu')
    assert buf.shape == (7, mo_tile.padded_width(79), 5)
    assert C.shape == (79, 7, 5)
    buf.copy_(torch.arange(buf.numel(), dtype=torch.float32).reshape(
        buf.shape))
    assert torch.equal(C[3, 5], buf[5, 3])
    assert C.reshape(79, 7, 5).data_ptr() == buf.data_ptr()


def test_ao_rows_and_key_match_the_reference_layout():
    """``eval_ao_rows`` is ``eval_ao_block``'s (n_ao, N, 5) block
    transposed, bit for bit, and its key is each electron's nearest atom;
    ``active_ao_lists_keyed`` adds to ``active_ao_lists`` the nearest atom
    among the active candidates."""
    cfg, params = build_system('smallest', screen_eps=1e-8, device='cpu')
    gen = torch.Generator()
    gen.manual_seed(3)
    r = sample_positions(params, gen, 2, cfg.n_elec).reshape(-1, 3)
    B, aa, key = aos.eval_ao_rows(cfg.basis_t, params.coords, r)
    B_ref, aa_ref = aos.eval_ao_block(cfg.basis_t, params.coords, r)
    assert torch.equal(B, B_ref.transpose(0, 1)) and torch.equal(aa, aa_ref)
    d2 = ((r[:, None] - params.coords[None]) ** 2).sum(-1)
    assert key.dtype == torch.uint8
    assert torch.equal(key.long(), d2.argmin(dim=1))
    idx, act, cnt, near = screening.active_ao_lists_keyed(cfg.screening_t, r)
    idx0, act0, cnt0 = screening.active_ao_lists(cfg.screening_t, r)
    assert torch.equal(idx, idx0) and torch.equal(act, act0)
    assert torch.equal(cnt, cnt0) and near.dtype == torch.uint8
    atom = cfg.basis_t.ao_atom[idx.long()]
    dist = torch.where(act, d2.gather(1, atom), torch.inf)
    has = act.any(dim=1)
    want = atom.gather(1, dist.argmin(dim=1, keepdim=True))[:, 0]
    assert torch.equal(near.long()[has], want[has])


def _cold_start(name, eps=None):
    kw = {} if eps is None else dict(screen_eps=eps)
    cfg, params = build_system(name, device='cpu', **kw)
    gen = torch.Generator()
    gen.manual_seed(1234)
    r = sample_positions(params, gen, 256, cfg.n_elec).reshape(-1, 3)
    return cfg, params, r


@pytest.mark.parametrize('te', [16, 32])
@pytest.mark.parametrize('name,eps', [('smallest', None),
                                      ('b-strand', 1e-8)])
def test_nearest_atom_order_halves_the_rows_a_tile_needs(name, eps, te):
    """Seeded cold start at W = 256 (the chip run's): sorted by nearest
    atom, a tile of te electrons needs under half the AO rows it needs in
    the walker-major order (CPU counts: 153 against 342 at smallest, 117
    against 641 at the screened b-strand, te = 16)."""
    cfg, params, r = _cold_start(name, eps)
    n_ao = cfg.basis_t.n_ao
    if eps is None:
        d2 = ((r[:, None] - params.coords[None]) ** 2).sum(-1)
        mask = (d2 < cfg.basis_t.atom_radius2)[:, cfg.basis_t.ao_atom]
        key = d2.argmin(dim=1).to(aos.tile_key_dtype(d2.shape[1]))
    else:
        idx, act, _, key = screening.active_ao_lists_keyed(cfg.screening_t,
                                                           r)
        mask = mo_tile.packed_mask(idx, act, n_ao)
    N = r.shape[0]
    sorted_u = mo_tile.tile_unions(mask, mo_tile.electron_order(key, N), te)
    walker_u = mo_tile.tile_unions(mask, torch.arange(N), te)
    assert sorted_u.shape == walker_u.shape == (-(-N // te),)
    assert float(sorted_u.double().mean()) < 0.5 * float(
        walker_u.double().mean())
    assert int(sorted_u.max()) <= n_ao
