"""Carry a wavefunction over from the JAX package, as plain numpy data.

``from_numpy`` builds the port's ``(WavefunctionConfig, WavefunctionParams)``
from the reference's parameters handed over as numpy arrays and dicts —
never as JAX objects — so both packages evaluate the same wavefunction:

    basis     dict of the ``BasisSet`` fields (``ao_atom``, ``ao_pow``,
              ``prim_coeff``, ``prim_exp``, ``atom_radius2``,
              ``shell_first_ao``, ``shell_atom``)
    coords, charges, mo
    jastrow   dict with ``b_ee``, ``b_en``, ``a_en``
    config    ``n_up``, ``n_dn``, ``k_max``, ``method``, ``ns_steps``,
              ``sem_refresh``
    ci        optional dict of the ``MultiDetWavefunction`` fields
              (``coeffs``, ``holes_up``, ``parts_up``, ``holes_dn``,
              ``parts_dn``, ``n_orb``)

Dtypes are pinned (int32 indices, float32 values), as the reference's
``aos._basis_consts`` pins them.

``dmc_state_from_numpy`` does the same for a DMC generation's state: the
reference's ``DMCState`` handed over as numpy (the ``WalkerEnsemble``
fields, the weight history and E_T) becomes the port's ``DMCState``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.basis import BasisSet
from repro_torch.core.dmc import DMCState
from repro_torch.core.jastrow import JastrowParams
from repro_torch.core.multidet import MultiDetWavefunction
from repro_torch.core.vmc import WalkerEnsemble
from repro_torch.core.wavefunction import (WavefunctionConfig,
                                           WavefunctionParams)
from repro_torch.device import resolve_device

_BASIS_DTYPES = dict(ao_atom=np.int32, ao_pow=np.int32,
                     prim_coeff=np.float32, prim_exp=np.float32,
                     atom_radius2=np.float32, shell_first_ao=np.int32,
                     shell_atom=np.int32)


def basis_from_arrays(fields: dict) -> BasisSet:
    """A ``BasisSet`` from a dict of its fields (numpy arrays)."""
    missing = set(_BASIS_DTYPES) - set(fields)
    if missing:
        raise ValueError(f'basis fields missing: {sorted(missing)}')
    return BasisSet(**{k: np.asarray(fields[k], dt)
                       for k, dt in _BASIS_DTYPES.items()})


def from_numpy(basis: dict, coords, charges, mo, jastrow: dict, *,
               n_up: int, n_dn: int, k_max: int = 0, method: str = 'sparse',
               ns_steps: int = 1, sem_refresh: int = 8, ci: dict = None,
               device=None):
    """(WavefunctionConfig, WavefunctionParams) on ``device`` from numpy
    (``None``: the card, raising without one; ``'cpu'`` on request)."""
    device = resolve_device(device)
    mdw = None
    if ci is not None:
        mdw = MultiDetWavefunction(
            coeffs=np.asarray(ci['coeffs'], np.float32),
            **{k: np.asarray(ci[k], np.int32)
               for k in ('holes_up', 'parts_up', 'holes_dn', 'parts_dn')},
            n_orb=int(ci['n_orb']))
    cfg = WavefunctionConfig(
        basis=basis_from_arrays(basis), n_up=int(n_up), n_dn=int(n_dn),
        k_max=int(k_max), method=str(method),
        ns_steps=int(ns_steps), sem_refresh=int(sem_refresh), ci=mdw,
        device=str(device))

    def _t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)
    jas = JastrowParams(b_ee=_t(jastrow['b_ee']), b_en=_t(jastrow['b_en']),
                        a_en=_t(jastrow['a_en']))
    params = WavefunctionParams(coords=_t(coords), charges=_t(charges),
                                mo=_t(mo), jastrow=jas)
    return cfg, params


def dmc_state_from_numpy(ens: dict, log_w_hist, e_trial, device=None
                         ) -> DMCState:
    """The port's ``DMCState`` on ``device`` (``None``: the card, raising
    without one; ``'cpu'`` on request) from the reference's, as numpy.

    ``ens``: dict of the ``WalkerEnsemble`` fields (``r``, ``log_psi``,
    ``sign``, ``drift``, ``e_loc``); ``log_w_hist``: (window,) trailing log
    population weights; ``e_trial``: E_T (a 0-d fp32 tensor in the port).
    """
    missing = set(WalkerEnsemble._fields) - set(ens)
    if missing:
        raise ValueError(f'ensemble fields missing: {sorted(missing)}')
    device = resolve_device(device)

    def _t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return DMCState(ens=WalkerEnsemble(*[_t(ens[k])
                                         for k in WalkerEnsemble._fields]),
                    log_w_hist=_t(log_w_hist), e_trial=_t(e_trial))
