"""Jastrow factor J(R) (eq. 7): Padé e-e and e-n terms, analytic derivatives.

Port of ``repro.core.jastrow``:

    U_ee(r)  = a_ee * r / (1 + b_ee * r)     (a_ee = 0.5 anti-parallel,
                                              0.25 parallel: the cusps)
    U_en(r)  = -Z_alpha * a_en * r / (1 + b_en * r)

For a pair function u(r), with rhat = (r_i - r_j)/r:
grad_i u = u'(r) rhat, lap_i u = u''(r) + 2 u'(r)/r.  Every function takes
optional leading walker axes on ``r_elec``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class JastrowParams(NamedTuple):
    """Padé Jastrow parameters (0-d fp32 tensors; e-e cusps are fixed)."""

    b_ee: torch.Tensor
    b_en: torch.Tensor
    a_en: torch.Tensor


def default_params(device='cpu') -> JastrowParams:
    """b = 1 and a modest e-n strength, as the reference's defaults."""
    def _s(v):
        return torch.tensor(v, dtype=torch.float32, device=device)
    return JastrowParams(b_ee=_s(1.0), b_en=_s(1.0), a_en=_s(0.5))


def _pade(r, a, b):
    """u, u', u'' for u = a r / (1 + b r)."""
    d = 1.0 + b * r
    u = a * r / d
    up = a / (d * d)
    upp = -2.0 * a * b / (d * d * d)
    return u, up, upp


class JastrowState(NamedTuple):
    """J(R) and its per-electron derivatives."""

    value: torch.Tensor     # (...) J(R)
    grad: torch.Tensor      # (..., n_elec, 3)
    lap: torch.Tensor       # (..., n_elec)


def jastrow_state(params: JastrowParams, r_elec: torch.Tensor,
                  coords: torch.Tensor, charges: torch.Tensor,
                  n_up: int) -> JastrowState:
    """r_elec: (..., n_e, 3); coords: (n_at, 3); charges: (n_at,)."""
    n_e = r_elec.shape[-2]
    dev, dt = r_elec.device, r_elec.dtype
    eye = torch.eye(n_e, dtype=torch.bool, device=dev)

    # ---- electron-electron ----
    diff = r_elec[..., :, None, :] - r_elec[..., None, :, :]   # (.., i, j, 3)
    r2 = torch.sum(diff * diff, dim=-1)
    r = torch.sqrt(torch.where(eye, torch.ones((), dtype=dt, device=dev), r2))
    spin_up = torch.arange(n_e, device=dev) < n_up
    parallel = spin_up[:, None] == spin_up[None, :]
    a_ee = 0.5 - 0.25 * parallel.to(dt)           # exact 0.25 / 0.5
    u, up, upp = _pade(r, a_ee, params.b_ee)
    mask = (~eye).to(dt)
    val_ee = 0.5 * torch.sum(u * mask, dim=(-1, -2))
    rhat = diff / r[..., None]
    grad_ee = torch.sum((up * mask)[..., None] * rhat, dim=-2)
    lap_ee = torch.sum((upp + 2.0 * up / r) * mask, dim=-1)

    # ---- electron-nucleus ----
    diff_n = r_elec[..., :, None, :] - coords                  # (.., i, a, 3)
    rn = torch.sqrt(torch.sum(diff_n * diff_n, dim=-1) + 1e-20)
    a_en = -charges * params.a_en
    un, unp, unpp = _pade(rn, a_en, params.b_en)
    val_en = torch.sum(un, dim=(-1, -2))
    rhat_n = diff_n / rn[..., None]
    grad_en = torch.sum(unp[..., None] * rhat_n, dim=-2)
    lap_en = torch.sum(unpp + 2.0 * unp / rn, dim=-1)

    return JastrowState(value=val_ee + val_en, grad=grad_ee + grad_en,
                        lap=lap_ee + lap_en)


def jastrow_value(params: JastrowParams, r_elec, coords, charges, n_up):
    """Value-only path."""
    return jastrow_state(params, r_elec, coords, charges, n_up).value


def jastrow_delta_one_electron(params: JastrowParams, r_elec: torch.Tensor,
                               j: int, r_new: torch.Tensor, coords, charges,
                               n_up: int):
    """J(R with r_j -> r_new) - J(R): the single-electron-move ratio term.

    Only the pairs involving electron ``j`` change: O(n_e + n_at).
    r_elec: (..., n_e, 3); r_new: (..., 3).  Returns (...).
    """
    n_e = r_elec.shape[-2]
    dev, dt = r_elec.device, r_elec.dtype
    ar = torch.arange(n_e, device=dev)
    spin_up = ar < n_up
    a_ee = 0.5 - 0.25 * (spin_up == (j < n_up)).to(dt)
    other = (ar != j).to(dt)

    def _ee(rj):
        d = rj[..., None, :] - r_elec
        r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-20)   # guard self-term
        u, _, _ = _pade(r, a_ee, params.b_ee)
        return torch.sum(u * other, dim=-1)

    def _en(rj):
        d = rj[..., None, :] - coords
        rn = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-20)
        u, _, _ = _pade(rn, -charges * params.a_en, params.b_en)
        return torch.sum(u, dim=-1)

    r_old = r_elec[..., j, :]
    return _ee(r_new) - _ee(r_old) + _en(r_new) - _en(r_old)
