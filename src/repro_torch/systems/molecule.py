"""Molecule container + trial-wavefunction builders for real test systems.

Port of ``repro.systems.molecule`` (h, h2, heh+ and water; single
determinant or a CI expansion, with or without distance screening).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import basis as basis_mod
from repro_torch.core.basis import Shell, build_basis
from repro_torch.core.jastrow import JastrowParams, default_params
from repro_torch.core.wavefunction import (WavefunctionConfig,
                                           WavefunctionParams)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Molecule:
    name: str
    coords: np.ndarray          # (n_at, 3) bohr
    charges: np.ndarray         # (n_at,)
    n_up: int
    n_dn: int

    @property
    def n_elec(self) -> int:
        return self.n_up + self.n_dn


def hydrogen() -> tuple[Molecule, list[Shell]]:
    mol = Molecule('H', np.zeros((1, 3)), np.array([1.0]), 1, 0)
    return mol, list(basis_mod.H_631G)


def h2(bond: float = 1.401) -> tuple[Molecule, list[Shell]]:
    coords = np.array([[0.0, 0.0, -bond / 2], [0.0, 0.0, bond / 2]])
    mol = Molecule('H2', coords, np.array([1.0, 1.0]), 1, 1)
    shells = []
    for a in range(2):
        shells += [Shell(a, s.l, s.exponents, s.coefficients)
                   for s in basis_mod.H_631G]
    return mol, shells


def heh_plus(bond: float = 1.463) -> tuple[Molecule, list[Shell]]:
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, bond]])
    mol = Molecule('HeH+', coords, np.array([2.0, 1.0]), 1, 1)
    shells = [
        Shell(0, 0, (9.75393461, 1.77669115, 0.48084429),
              (0.15432897, 0.53532814, 0.44463454)),   # He STO-3G (zeta~1.69)
        Shell(1, 0, basis_mod.STO3G_H[0].exponents,
              basis_mod.STO3G_H[0].coefficients),
    ]
    return mol, shells


def water() -> tuple[Molecule, list[Shell]]:
    """H2O, STO-3G-quality shells (s/p on O, s on H). Geometry in bohr."""
    coords = np.array([
        [0.0, 0.0, 0.2217],
        [0.0, 1.4309, -0.8867],
        [0.0, -1.4309, -0.8867],
    ])
    mol = Molecule('H2O', coords, np.array([8.0, 1.0, 1.0]), 5, 5)
    shells = [
        # O 1s (STO-3G zeta=7.66)
        Shell(0, 0, (130.70932, 23.808861, 6.4436083),
              (0.15432897, 0.53532814, 0.44463454)),
        # O 2s
        Shell(0, 0, (5.0331513, 1.1695961, 0.3803890),
              (-0.09996723, 0.39951283, 0.70011547)),
        # O 2p
        Shell(0, 1, (5.0331513, 1.1695961, 0.3803890),
              (0.15591627, 0.60768372, 0.39195739)),
        Shell(1, 0, basis_mod.STO3G_H[0].exponents,
              basis_mod.STO3G_H[0].coefficients),
        Shell(2, 0, basis_mod.STO3G_H[0].exponents,
              basis_mod.STO3G_H[0].coefficients),
    ]
    return mol, shells


def build_wavefunction(mol: Molecule, shells, k_max: int = 0,
                       method: str = 'dense', jastrow: JastrowParams = None,
                       mos: np.ndarray = None, ns_steps: int = 1,
                       n_orb: int = 0, ci=None,
                       screen_eps: float | None = None, device=None):
    """Assemble (config, params) on ``device`` (``None``: the card, raising
    without one; ``'cpu'`` on request).  MOs default to the
    core-Hamiltonian guess (``core.integrals.core_guess_mos``).  ``n_orb``
    asks for that many MO rows (0: the occupied set; a CI expansion needs
    virtual orbitals too); ``ci`` is a ``multidet.MultiDetWavefunction``
    whose ``n_orb`` must match the MO rows.  ``screen_eps`` (None = off)
    attaches the cell-list ``Screening`` at that AO tolerance, as
    ``repro.systems.molecule.build_wavefunction`` does."""
    device = resolve_device(device)
    bas = build_basis(shells, mol.coords.shape[0])
    n_orb = max(n_orb, mol.n_up, mol.n_dn)
    if n_orb > bas.n_ao:
        raise ValueError(f'{n_orb} MOs requested from {bas.n_ao} AOs')
    if mos is None:
        from repro_torch.core.integrals import core_guess_mos
        mos = core_guess_mos(bas, mol.coords, mol.charges, n_orb)
    if ci is not None and ci.n_orb != np.asarray(mos).shape[0]:
        raise ValueError(f'CI expansion indexes {ci.n_orb} orbitals but '
                         f'params.mo has {np.asarray(mos).shape[0]} rows')
    screening = None
    if screen_eps is not None:
        from repro_torch.core.screening import build_screening
        screening = build_screening(bas, mol.coords, mos, eps=screen_eps)
    cfg = WavefunctionConfig(
        basis=bas, n_up=mol.n_up, n_dn=mol.n_dn, k_max=k_max,
        method=method, ns_steps=ns_steps, ci=ci, screening=screening,
        device=str(device))

    def _t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(device)
    params = WavefunctionParams(
        coords=_t(mol.coords), charges=_t(mol.charges), mo=_t(mos),
        jastrow=jastrow or default_params(device))
    return cfg, params
