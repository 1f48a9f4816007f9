"""Gaussian atomic basis sets with atomic-radius screening (paper §III).

A basis function (AO) is
    chi(r) = (x-Qx)^nx (y-Qy)^ny (z-Qz)^nz * g(|r-Q|),
    g(r)   = sum_k c_k exp(-gamma_k r^2).

All AO data is stored in flat padded arrays so the whole basis evaluates as a
single vectorized expression.  Every nucleus carries an *atomic radius*: the
distance beyond which every contracted radial part g centred on it is below
``EPS_AO`` — electrons farther than that contribute exact zeros for all AOs of
the atom (the sparsity the paper exploits).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

EPS_AO = 1.0e-8  # paper's epsilon for AO screening
MAX_POW = 3      # supports s, p, d, f angular factors

# double factorial table for normalization: (2n-1)!! for n = 0..MAX_POW
_DFACT = [1.0, 1.0, 3.0, 15.0]


def primitive_norm(gamma: float, n: tuple[int, int, int]) -> float:
    """L2 normalization constant of a Cartesian Gaussian primitive."""
    nx, ny, nz = n
    l = nx + ny + nz
    pref = (2.0 * gamma / math.pi) ** 0.75 * (4.0 * gamma) ** (l / 2.0)
    denom = math.sqrt(_DFACT[nx] * _DFACT[ny] * _DFACT[nz])
    return pref / denom


@dataclasses.dataclass(frozen=True)
class Shell:
    """One contracted shell: shared radial part, all Cartesian components."""

    atom: int
    l: int                      # total angular momentum (0=s, 1=p, 2=d, 3=f)
    exponents: tuple[float, ...]
    coefficients: tuple[float, ...]


def cartesian_components(l: int) -> list[tuple[int, int, int]]:
    """All (nx,ny,nz) with nx+ny+nz == l, in canonical order."""
    out = []
    for nx in range(l, -1, -1):
        for ny in range(l - nx, -1, -1):
            out.append((nx, ny, l - nx - ny))
    return out


@dataclasses.dataclass(frozen=True)
class BasisSet:
    """Flattened AO arrays (numpy, converted to jnp at trace time).

    Shapes: n_ao AOs, each with up to P primitives (zero-padded coeffs).
    """

    ao_atom: np.ndarray      # (n_ao,) int32 — owning nucleus
    ao_pow: np.ndarray       # (n_ao, 3) int32 — monomial powers
    prim_coeff: np.ndarray   # (n_ao, P) f32 — normalized contraction coeffs
    prim_exp: np.ndarray     # (n_ao, P) f32 — gaussian exponents (pad: 1.0)
    atom_radius2: np.ndarray  # (n_atoms,) f32 — squared screening radius
    shell_first_ao: np.ndarray  # (n_shells,) int32
    shell_atom: np.ndarray      # (n_shells,) int32

    @property
    def n_ao(self) -> int:
        """Total number of atomic orbitals."""
        return int(self.ao_atom.shape[0])

    @property
    def n_prim(self) -> int:
        """Padded primitive count per AO."""
        return int(self.prim_coeff.shape[1])


def _radius_for(exponents, coefficients, eps: float) -> float:
    """Distance beyond which |g(r)| < eps (conservative, monotone tail)."""
    r = 1.0

    def _g(r):
        return sum(abs(c) * math.exp(-min(a * r * r, 700.0))
                   for c, a in zip(coefficients, exponents))

    while _g(r) >= eps and r < 64.0:
        r *= 1.25
    return r


def build_basis(shells: Sequence[Shell], n_atoms: int,
                eps: float = EPS_AO) -> BasisSet:
    """Flatten shells into a BasisSet with screening radii."""
    max_prim = max(len(s.exponents) for s in shells)
    ao_atom, ao_pow, coeffs, exps = [], [], [], []
    shell_first, shell_atom = [], []
    radius2 = np.zeros((n_atoms,), np.float64)
    for s in shells:
        comps = cartesian_components(s.l)
        shell_first.append(len(ao_atom))
        shell_atom.append(s.atom)
        # screening radius ignores the polynomial factor: conservative enough
        # at eps=1e-8 (paper screens on the spherical part g only, as we do).
        r = _radius_for(s.exponents, s.coefficients, eps)
        radius2[s.atom] = max(radius2[s.atom], r * r)
        for n in comps:
            ao_atom.append(s.atom)
            ao_pow.append(n)
            c = np.zeros((max_prim,), np.float64)
            a = np.ones((max_prim,), np.float64)
            for k, (ck, ak) in enumerate(zip(s.coefficients, s.exponents)):
                c[k] = ck * primitive_norm(ak, n)
                a[k] = ak
            coeffs.append(c)
            exps.append(a)
    return BasisSet(
        ao_atom=np.asarray(ao_atom, np.int32),
        ao_pow=np.asarray(ao_pow, np.int32),
        prim_coeff=np.asarray(coeffs, np.float32),
        prim_exp=np.asarray(exps, np.float32),
        atom_radius2=radius2.astype(np.float32),
        shell_first_ao=np.asarray(shell_first, np.int32),
        shell_atom=np.asarray(shell_atom, np.int32),
    )


def ao_cutoff_radii(basis: BasisSet, eps: float) -> np.ndarray:
    """Per-AO screening radii at tolerance ``eps`` (paper §II's cutoffs).

    The contracted radial part of each AO decays monotonically past its
    outermost maximum, so there is a radius beyond which |g(r)| < eps for
    THAT shell alone — tighter than the per-atom ``atom_radius2`` (which is
    the max over the atom's shells at the fixed ``EPS_AO``).  Distance
    screening (``core.screening``) drops (electron, AO) pairs beyond these
    radii; the bound on what is dropped is |chi| <= eps * |poly| at the
    cutoff sphere (DESIGN.md §11 for the resulting log|Psi| bound).

    ``eps <= 0`` returns +inf radii (no tolerance cutoff — only the exact
    ``atom_radius2`` zero structure remains when the caller intersects with
    it).  Padding primitives (coefficient 0) contribute nothing.
    """
    if eps <= 0.0:
        return np.full((basis.n_ao,), np.inf, np.float64)
    out = np.empty((basis.n_ao,), np.float64)
    for j in range(basis.n_ao):
        keep = np.abs(basis.prim_coeff[j]) > 0
        out[j] = _radius_for(basis.prim_exp[j][keep].tolist(),
                             basis.prim_coeff[j][keep].tolist(), eps)
    return out


# ---------------------------------------------------------------------------
# Small built-in basis library (enough for tests + procedural benchmarks).
# Exponents/coefficients follow the STO-3G / 6-31G family patterns.
# ---------------------------------------------------------------------------

STO3G_H = [Shell(0, 0, (3.42525091, 0.62391373, 0.16885540),
                 (0.15432897, 0.53532814, 0.44463454))]

# 6-31G hydrogen: 3-primitive core + diffuse single primitive
H_631G = [
    Shell(0, 0, (18.7311370, 2.8253937, 0.6401217),
          (0.03349460, 0.23472695, 0.81375733)),
    Shell(0, 0, (0.1612778,), (1.0,)),
]


def sto3g_like(atom: int, zeta: float, l: int) -> Shell:
    """STO-3G style shell scaled to effective exponent ``zeta``."""
    base_exp = (2.227660584, 0.405771156, 0.109818)
    base_c = (0.154328967, 0.535328142, 0.444634542)
    return Shell(atom, l, tuple(a * zeta * zeta for a in base_exp), base_c)
