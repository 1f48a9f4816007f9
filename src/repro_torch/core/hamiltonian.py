"""Coulomb potential terms of the molecular Hamiltonian (Born–Oppenheimer).

Port of ``repro.core.hamiltonian``:

    V(R) = - sum_{i,a} Z_a / r_ia  +  sum_{i<j} 1 / r_ij  +  sum_{a<b} Z_a Z_b / R_ab
"""
from __future__ import annotations

import torch


def potential_energy(r_elec: torch.Tensor, coords: torch.Tensor,
                     charges: torch.Tensor) -> torch.Tensor:
    """V(R) for r_elec (..., n_e, 3): e-n attraction + e-e and n-n
    repulsion.  Returns (...)."""
    n_e = r_elec.shape[-2]
    dev, dt = r_elec.device, r_elec.dtype
    eye = torch.eye(n_e, dtype=torch.bool, device=dev)

    dn = r_elec[..., :, None, :] - coords
    r_en = torch.sqrt(torch.sum(dn * dn, dim=-1) + 1e-20)
    v_en = -torch.sum(charges / r_en, dim=(-1, -2))

    de = r_elec[..., :, None, :] - r_elec[..., None, :, :]
    r_ee = torch.sqrt(torch.sum(de * de, dim=-1) + eye.to(dt))
    zero = torch.zeros((), dtype=dt, device=dev)
    v_ee = 0.5 * torch.sum(torch.where(eye, zero, 1.0 / r_ee), dim=(-1, -2))

    da = coords[:, None, :] - coords[None, :, :]
    n_a = coords.shape[0]
    eye_a = torch.eye(n_a, dtype=torch.bool, device=dev)
    r_aa = torch.sqrt(torch.sum(da * da, dim=-1) + eye_a.to(dt))
    v_nn = 0.5 * torch.sum(torch.where(
        eye_a, zero, charges[:, None] * charges[None, :] / r_aa))
    return v_en + v_ee + v_nn
