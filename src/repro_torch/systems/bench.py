"""Procedural analogues of the paper's five benchmark systems (Fig. 1).

Port of ``repro.systems.bench`` (numpy generators copied; the wavefunction
builder returns the port's config and tensors).  Peptide-like systems
matched to the paper's Table IV characteristics:

    system            N_elec  N_basis  N_basis/N   paper B-density
    smallest            158      404      2.56         36.2%
    beta-strand         434      963      2.22         14.8%
    beta-strand TZ      434     2934      6.76          8.2%
    1ZE7               1056     2370      2.24          5.7%
    1AMB               1731     3892      2.25          3.9%

Residues (N, C-alpha, C', O + hydrogens; 30 electrons each) sit on a
compact 3-D snake path; shell sets follow 6-31G*/cc-pVTZ patterns, so the
atomic screening radii — and hence the B sparsity — behave like the
paper's.  MO coefficients are generated localized, thresholded at 1e-5.
``synthetic_ci`` and ``extend_mos_virtual`` give the seeded CI expansions
of ``--n-det`` (Table X); ``synthetic_chain`` the growing extended chains
of the scaling curve (Table XIII), whose local MOs switch MO support
screening on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.basis import BasisSet, Shell, build_basis
from repro_torch.device import resolve_device
from repro_torch.systems.molecule import Molecule

# ---------------------------------------------------------------------------
# Element shell patterns (even-tempered, normalized later by build_basis).
# ---------------------------------------------------------------------------


def _even_tempered(a0: float, beta: float, n: int) -> tuple[float, ...]:
    return tuple(a0 * beta ** k for k in range(n))


def _contraction(n: int) -> tuple[float, ...]:
    """Smooth bell-shaped contraction weights (sum ~ 1)."""
    w = np.exp(-0.5 * ((np.arange(n) - (n - 1) / 2) / max(n / 3, 1)) ** 2)
    return tuple(float(x) for x in w / w.sum())


def shells_631gs(atom: int, z: float) -> list[Shell]:
    """6-31G*-like pattern: H -> 2 s shells; heavy -> 3s + 2p + 1d (15 AOs).

    The most diffuse exponent is chosen so the eps=1e-8 screening radius is
    ~5.8 bohr, reproducing the paper's measured "~140 active AOs per electron,
    constant in N" (Table IV).  Real 6-31G* diffuse exponents (~0.17) would
    give r~10 bohr; with no real PDB geometry the pair (spacing, radius) is
    what controls sparsity, and we tune it to the paper's observable.
    """
    if z < 1.5:  # hydrogen
        return [
            Shell(atom, 0, (18.73, 2.825, 0.640), (0.033, 0.235, 0.814)),
            Shell(atom, 0, (0.50,), (1.0,)),
        ]
    s = z / 6.0  # exponent scale vs carbon
    return [
        Shell(atom, 0, _even_tempered(3047.0 * s * s, 0.18, 6),
              _contraction(6)),                               # core s
        Shell(atom, 0, (7.87 * s, 1.88 * s, 0.66 * s),
              (-0.12, 0.44, 0.65)),                           # valence s
        Shell(atom, 0, (0.55 * s,), (1.0,)),                  # outer s
        Shell(atom, 1, (7.87 * s, 1.88 * s, 0.66 * s),
              (0.26, 0.55, 0.29)),                            # valence p
        Shell(atom, 1, (0.55 * s,), (1.0,)),                  # outer p
        Shell(atom, 2, (0.9 * s,), (1.0,))                    # polarization d
    ]


def shells_tz(atom: int, z: float) -> list[Shell]:
    """cc-pVTZ-like pattern: H -> 3s+2p+1d (15 AOs); heavy -> 5s+3p+2d+1f
    (42 AOs).  Slightly more diffuse tail than the DZ set (r ~ 6.8 bohr),
    mirroring the paper's TZ active-count jump (241 vs ~140)."""
    if z < 1.5:
        return [
            Shell(atom, 0, (33.87, 5.095, 1.159), (0.025, 0.190, 0.852)),
            Shell(atom, 0, (0.80,), (1.0,)),
            Shell(atom, 0, (0.42,), (1.0,)),
            Shell(atom, 1, (1.407,), (1.0,)),
            Shell(atom, 1, (0.52,), (1.0,)),
            Shell(atom, 2, (1.057,), (1.0,)),
        ]
    s = z / 6.0
    return [
        Shell(atom, 0, _even_tempered(8236.0 * s * s, 0.16, 6),
              _contraction(6)),
        Shell(atom, 0, (2.97 * s, 0.938 * s), (0.4, 0.65)),
        Shell(atom, 0, (0.70 * s,), (1.0,)),
        Shell(atom, 0, (0.52 * s,), (1.0,)),
        Shell(atom, 0, (0.40 * s,), (1.0,)),                  # diffuse tail s
        Shell(atom, 1, (9.44 * s, 2.00 * s, 0.66 * s), (0.1, 0.42, 0.58)),
        Shell(atom, 1, (0.55 * s,), (1.0,)),
        Shell(atom, 1, (0.40 * s,), (1.0,)),
        Shell(atom, 2, (1.097 * s,), (1.0,)),
        Shell(atom, 2, (0.55 * s,), (1.0,)),
        Shell(atom, 3, (0.90 * s,), (1.0,)),
    ]


# ---------------------------------------------------------------------------
# Geometry: compact 3-D snake of peptide-like residues.
# ---------------------------------------------------------------------------

# One residue backbone: N, C-alpha, C', O + 3 H (30 electrons, 4 heavy atoms)
_RESIDUE_OFFSETS = np.array([
    [0.0, 0.0, 0.0],      # N  (Z=7)
    [2.4, 0.9, 0.0],      # CA (Z=6)
    [3.4, -0.8, 1.9],     # C' (Z=6)
    [3.1, -2.9, 1.6],     # O  (Z=8)
    [-0.9, 1.1, 1.2],     # H on N
    [2.9, 2.2, -1.3],     # H on CA
    [5.0, 0.2, 2.6],      # H near C'
])
_RESIDUE_Z = np.array([7.0, 6.0, 6.0, 8.0, 1.0, 1.0, 1.0])
_RESIDUE_NELEC = int(_RESIDUE_Z.sum())  # 30


def _snake_path(n: int, spacing: float) -> np.ndarray:
    """n points on a boustrophedon walk through a near-cubic lattice."""
    side = max(1, round(n ** (1.0 / 3.0)))
    while side ** 3 < n:
        side += 1
    pts = []
    for iz in range(side):
        for iy in range(side):
            ys = iy if iz % 2 == 0 else side - 1 - iy
            for ix in range(side):
                xs = ix if ys % 2 == 0 else side - 1 - ix
                pts.append((xs, ys, iz))
                if len(pts) == n:
                    return np.asarray(pts, np.float64) * spacing
    return np.asarray(pts[:n], np.float64) * spacing


@dataclasses.dataclass(frozen=True)
class BenchSystem:
    name: str
    mol: Molecule
    basis: BasisSet
    mos: np.ndarray        # (n_orb, n_ao) localized coefficients, 'A' matrix
    a_density: float       # fraction of |a_ij| >= 1e-5 (paper Table IV)


def _localized_mos(rng: np.random.Generator, basis: BasisSet,
                   coords: np.ndarray, n_orb: int,
                   loc_length: float) -> np.ndarray:
    """Localized MO coefficients: Gaussian distance envelope + self-AO."""
    n_ao = basis.n_ao
    heavy = np.where(coords[:, 0] ** 2 >= 0)[0]  # all atoms usable as centers
    centers = heavy[np.linspace(0, len(heavy) - 1, n_orb).astype(int)]
    ao_atom = basis.ao_atom
    d = np.linalg.norm(coords[centers][:, None, :]
                       - coords[ao_atom][None, :, :], axis=-1)  # (orb, ao)
    envelope = np.exp(-(d / loc_length) ** 2)
    A = rng.standard_normal((n_orb, n_ao)) * envelope
    # dominant self-coefficient: first AO of the center atom
    first_ao = np.full(coords.shape[0], -1, np.int64)
    for j in range(n_ao - 1, -1, -1):
        first_ao[ao_atom[j]] = j
    A[np.arange(n_orb), first_ao[centers]] += 3.0
    # row-normalize so determinants stay in a sane log range, THEN apply
    # the paper's 1e-5 zero threshold (Table IV counts |a_ij| >= 1e-5).
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    A[np.abs(A) < 1e-5] = 0.0
    return A.astype(np.float32)


def _strand_path(n: int, spacing: float) -> np.ndarray:
    """n residue anchors along z — an extended beta-strand (paper Fig. 1)."""
    pts = np.zeros((n, 3))
    pts[:, 2] = np.arange(n) * spacing
    pts[:, 0] = 1.2 * ((-1) ** np.arange(n))      # slight zig-zag
    return pts


def make_bench_system(name: str, n_elec: int, basis_kind: str = '631gs',
                      geometry: str = 'compact', spacing: float = 7.0,
                      loc_length: float = 5.0, seed: int = 0) -> BenchSystem:
    """Build a peptide-like system with exactly n_elec electrons.

    geometry: 'compact' (3-D snake lattice — folded protein) or 'strand'
    (extended along z — the paper's beta-strand).
    """
    rng = np.random.default_rng(seed)
    n_res = n_elec // _RESIDUE_NELEC
    extra = n_elec - n_res * _RESIDUE_NELEC       # pad with H atoms (Z=1)
    n_anchor = n_res + (extra + 6) // 7
    if geometry == 'strand':
        anchors = _strand_path(n_anchor, 6.4)     # beta rise ~3.4 A
    else:
        anchors = _snake_path(n_anchor, spacing)

    coords, charges = [], []
    for r in range(n_res):
        jitter = rng.normal(scale=0.15, size=_RESIDUE_OFFSETS.shape)
        coords.append(anchors[r][None] + _RESIDUE_OFFSETS + jitter)
        charges.append(_RESIDUE_Z)
    for h in range(extra):                         # leftover H's on next anchors
        a = anchors[min(n_res + h // 7, len(anchors) - 1)]
        coords.append(a[None] + rng.normal(scale=1.5, size=(1, 3)))
        charges.append(np.array([1.0]))
    coords = np.concatenate(coords, axis=0)
    charges = np.concatenate(charges, axis=0)
    assert int(charges.sum()) == n_elec

    shell_fn = shells_tz if basis_kind == 'tz' else shells_631gs
    shells = []
    for a, z in enumerate(charges):
        shells += shell_fn(a, float(z))
    basis = build_basis(shells, coords.shape[0])

    n_up = (n_elec + 1) // 2
    n_dn = n_elec - n_up
    mol = Molecule(name, coords, charges, n_up, n_dn)
    A = _localized_mos(rng, basis, coords, n_up, loc_length)
    dens = float(np.mean(np.abs(A) >= 1e-5))
    return BenchSystem(name=name, mol=mol, basis=basis, mos=A,
                       a_density=dens)


# The paper's five systems (Table IV sizes).  The beta-strands are extended
# (Fig. 1), the PDB proteins compact.
PAPER_SYSTEMS = {
    'smallest':  dict(n_elec=158, basis_kind='631gs', geometry='compact',
                      seed=1),
    'b-strand':  dict(n_elec=434, basis_kind='631gs', geometry='strand',
                      seed=2),
    'b-strand-tz': dict(n_elec=434, basis_kind='tz', geometry='strand',
                        seed=2),
    '1ze7':      dict(n_elec=1056, basis_kind='631gs', geometry='compact',
                      seed=3),
    '1amb':      dict(n_elec=1731, basis_kind='631gs', geometry='compact',
                      seed=4),
}


def paper_system(name: str) -> BenchSystem:
    return make_bench_system(name, **PAPER_SYSTEMS[name])


def synthetic_chain(n_elec: int, basis_kind: str = '631gs',
                    loc_length: float = 3.5, seed: int = 0) -> BenchSystem:
    """Growing synthetic peptide chain for the scaling curve
    (``repro.systems.bench.synthetic_chain``): an extended beta-strand of
    ``n_elec // 30`` residues with MOs localized more tightly than the
    compact defaults, so that MO support screening (``core.screening``)
    finds genuinely local MOs and switches itself on."""
    return make_bench_system(f'chain-{n_elec}', n_elec,
                             basis_kind=basis_kind, geometry='strand',
                             loc_length=loc_length, seed=seed)


def synthetic_ci(n_up: int, n_dn: int, n_orb: int, n_det: int,
                 seed: int = 0, max_exc: int = 2):
    """Synthetic CI expansion: reference + random singles/doubles
    (``repro.systems.bench.synthetic_ci``, the same seeded draw).

    ``n_det`` determinants, excitation rank <= ``max_exc``, coefficients
    decaying from a dominant reference; excitations are sampled without
    replacement over both spin blocks.  Raises if the single/double space
    cannot host ``n_det`` determinants.
    """
    from repro_torch.core.multidet import from_excitations

    n_virt_up, n_virt_dn = n_orb - n_up, n_orb - n_dn
    rng = np.random.default_rng(seed + 7 * n_det)
    seen, excitations = set(), []
    attempts = 0
    while len(excitations) < n_det - 1:
        attempts += 1
        if attempts > 200 * n_det:
            raise ValueError(
                f'cannot draw {n_det - 1} distinct excitations from '
                f'n_orb={n_orb} (n_up={n_up}, n_dn={n_dn}); '
                f'increase the orbital set')
        kinds = ['su'] * (n_virt_up > 0) + ['sd'] * (n_dn and n_virt_dn > 0)
        if max_exc >= 2:
            kinds += (['du'] * (n_up >= 2 and n_virt_up >= 2)
                      + ['dd'] * (n_dn >= 2 and n_virt_dn >= 2)
                      + ['ss'] * (n_dn and n_virt_up > 0 and n_virt_dn > 0))
        if not kinds:
            raise ValueError(
                f'cannot draw any excitation from n_orb={n_orb} '
                f'(n_up={n_up}, n_dn={n_dn}): no virtual orbitals; '
                f'increase the orbital set')
        kind = kinds[rng.integers(len(kinds))]

        def _draw(n_occ, n_virt, deg):
            holes = sorted(rng.choice(n_occ, deg, replace=False).tolist())
            parts = sorted((n_occ + rng.choice(n_virt, deg, replace=False)
                            ).tolist())
            return holes, parts

        up, dn = ([], []), ([], [])
        if kind == 'su':
            up = _draw(n_up, n_virt_up, 1)
        elif kind == 'sd':
            dn = _draw(n_dn, n_virt_dn, 1)
        elif kind == 'du':
            up = _draw(n_up, n_virt_up, 2)
        elif kind == 'dd':
            dn = _draw(n_dn, n_virt_dn, 2)
        else:                                  # 'ss': single x single
            up = _draw(n_up, n_virt_up, 1)
            dn = _draw(n_dn, n_virt_dn, 1)
        key = (tuple(up[0]), tuple(up[1]), tuple(dn[0]), tuple(dn[1]))
        if key in seen:
            continue
        seen.add(key)
        excitations.append((up, dn))
    i = np.arange(1, n_det)
    signs = rng.choice([-1.0, 1.0], n_det - 1)
    coeffs = np.concatenate([[1.0], signs * 0.3 / (1.0 + 0.05 * i)])
    return from_excitations(coeffs, excitations, n_up, n_dn, n_orb)


def extend_mos_virtual(sys: BenchSystem, n_virt: int,
                       loc_length: float = 5.0,
                       seed: int = 1234) -> np.ndarray:
    """Stack ``n_virt`` extra localized virtual-orbital rows onto the
    occupied A matrix (``repro.systems.bench.extend_mos_virtual``)."""
    rng = np.random.default_rng(seed)
    extra = _localized_mos(rng, sys.basis, sys.mol.coords, n_virt,
                           loc_length)
    return np.concatenate([sys.mos, extra], axis=0)


def build_bench_wavefunction(sys: BenchSystem, method: str = 'kernel',
                             k_max: int = 512, n_det: int = 1,
                             ci_seed: int = 0,
                             screen_eps: float | None = None, device=None):
    """(config, params) for a BenchSystem on ``device`` (``None``: the
    card, raising without one; ``'cpu'`` on request); MOs are the
    generated A matrix (``repro.systems.bench.build_bench_wavefunction``).

    ``method='kernel'`` (the port's default) routes the MO product and the
    Sherman–Morrison update through the CUDA kernels on the card.
    ``n_det > 1`` attaches a ``synthetic_ci`` expansion and the
    ``max(8, n_up // 2)`` virtual MO rows it excites into (Table X).
    ``screen_eps`` (None = off) attaches the one-time cell-list
    ``Screening`` built at that AO tolerance (0.0: the exact zero structure
    only; < 0: exhaustive, routed to the unscreened pipeline) — the
    linear-scaling pipeline of DESIGN.md §11.
    """
    from repro_torch.core.jastrow import default_params
    from repro_torch.core.wavefunction import (WavefunctionConfig,
                                               WavefunctionParams)
    device = resolve_device(device)
    mos, ci = sys.mos, None
    if n_det > 1:
        n_virt = min(sys.basis.n_ao - sys.mol.n_up,
                     max(8, sys.mol.n_up // 2))
        mos = extend_mos_virtual(sys, n_virt)
        ci = synthetic_ci(sys.mol.n_up, sys.mol.n_dn, mos.shape[0],
                          n_det, seed=ci_seed)
    screening = None
    if screen_eps is not None:
        from repro_torch.core.screening import build_screening
        screening = build_screening(sys.basis, sys.mol.coords, mos,
                                    eps=screen_eps)
    cfg = WavefunctionConfig(
        basis=sys.basis, n_up=sys.mol.n_up, n_dn=sys.mol.n_dn,
        k_max=k_max, method=method, ci=ci, screening=screening,
        device=str(device))
    params = WavefunctionParams(
        coords=torch.as_tensor(sys.mol.coords, dtype=torch.float32
                               ).to(device),
        charges=torch.as_tensor(sys.mol.charges, dtype=torch.float32
                                ).to(device),
        mo=torch.as_tensor(mos, dtype=torch.float32).to(device),
        jastrow=default_params(device))
    return cfg, params
