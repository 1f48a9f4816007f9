"""Slater-determinant part: inverse, log|det|, drift and Laplacian ratios.

Port of ``repro.core.slater`` (fp32 arithmetic; the storage policy
tables of the mixed-precision sweep state at the end).  Given the MO
tensor ``C: (n_orb_tot, n_elec, 5)`` with the first ``n_up`` rows/electrons
forming the spin-up block, computes per-electron grad_i log Det (eq. 14)
and (lap_i Det)/Det (eq. 15) through the inverse Slater matrix: fp32 plus
one Newton–Schulz refinement step (DESIGN.md §3).

``torch.linalg.slogdet``/``inv_ex`` stand where the reference leaves these
to XLA; ``inv_ex`` without error checks keeps the call free of a
device-to-host sync (a singular block gives inf/nan, as in JAX).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SlaterState(NamedTuple):
    """Both spin determinants' value/derivative summary for one walker."""

    sign: torch.Tensor       # () product of both spin signs
    logdet: torch.Tensor     # () sum of log|det| over spins
    grad: torch.Tensor       # (n_elec, 3) per-electron grad log Det
    lap_ratio: torch.Tensor  # (n_elec,) per-electron (lap Det)/Det


def refine_inverse(D: torch.Tensor, X: torch.Tensor, steps: int = 1):
    """Newton–Schulz: X <- X (2I - D X); quadratic convergence."""
    eye2 = 2.0 * torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    for _ in range(steps):
        X = X @ (eye2 - D @ X)
    return X


def ratios_from_inverse(C_blk: torch.Tensor, Minv: torch.Tensor):
    """Drift and Laplacian ratios (eqs. 14/15) from a maintained inverse.

    C_blk: (..., orb, elec, 5); Minv: (..., elec, orb).  Returns grad
    (..., elec, 3) and lap (..., elec).
    """
    grad = torch.einsum('...iej,...ei->...ej', C_blk[..., 1:4], Minv)
    lap = torch.einsum('...ie,...ei->...e', C_blk[..., 4], Minv)
    return grad, lap


def det_ratio_one_electron(Minv: torch.Tensor, phi_new: torch.Tensor,
                           j: int):
    """Sherman–Morrison determinant ratio for moving electron j
    (``repro.core.slater.det_ratio_one_electron``).

    Minv: (elec, orb) inverse Slater; phi_new: (orb,) new MO values at r_j'.
    Returns (ratio, updated Minv).
    """
    ratio = Minv[j] @ phi_new
    u = Minv @ phi_new                       # (elec,)
    row = Minv[j] / ratio                    # (orb,)
    Minv_new = Minv - torch.outer(u, row)
    Minv_new[j] = row
    return ratio, Minv_new


def det_small(T: torch.Tensor) -> torch.Tensor:
    """Determinant of small (..., k, k) blocks, batched
    (``repro.core.slater.det_small``): explicit cofactors for k <= 3 (exact
    on identity padding blocks), ``torch.linalg.det`` beyond."""
    k = T.shape[-1]
    if k == 0:
        return torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    if k == 1:
        return T[..., 0, 0]
    if k == 2:
        return T[..., 0, 0] * T[..., 1, 1] - T[..., 0, 1] * T[..., 1, 0]
    if k == 3:
        return (T[..., 0, 0] * (T[..., 1, 1] * T[..., 2, 2]
                                - T[..., 1, 2] * T[..., 2, 1])
                - T[..., 0, 1] * (T[..., 1, 0] * T[..., 2, 2]
                                  - T[..., 1, 2] * T[..., 2, 0])
                + T[..., 0, 2] * (T[..., 1, 0] * T[..., 2, 1]
                                  - T[..., 1, 1] * T[..., 2, 0]))
    return torch.linalg.det(T)


def inv_small(T: torch.Tensor, det: torch.Tensor | None = None,
              eps: float = 1e-20) -> torch.Tensor:
    """Inverse of small (..., k, k) blocks via the adjugate, batched
    (``repro.core.slater.inv_small``); near-singular blocks are guarded by
    ``eps`` (callers weight the result by the vanishing determinant)."""
    k = T.shape[-1]
    if det is None:
        det = det_small(T)
    safe = torch.where(torch.abs(det) > eps, det, torch.ones_like(det))
    if k == 1:
        return (1.0 / safe)[..., None, None] * torch.ones_like(T)
    if k == 2:
        adj = torch.stack([
            torch.stack([T[..., 1, 1], -T[..., 0, 1]], dim=-1),
            torch.stack([-T[..., 1, 0], T[..., 0, 0]], dim=-1),
        ], dim=-2)
        return adj / safe[..., None, None]
    return torch.linalg.inv(T)


def det_ratio_rank_k(Minv: torch.Tensor, Phi_new: torch.Tensor,
                     js: torch.Tensor):
    """Sherman–Morrison–Woodbury ratio for replacing k Slater columns
    (``repro.core.slater.det_ratio_rank_k``).

    Electrons ``js`` (k indices) get new orbital-value columns ``Phi_new``
    (k, orb): det(D')/det(D) = det(T), T[a, b] = M[js[a]] . Phi_new[b], and
    M' = M - (M Phi_new^T - I[:, js]) T^{-1} M[js, :].  Returns (ratio,
    updated Minv).
    """
    n = Minv.shape[0]
    k = js.shape[0]
    Mj = Minv[js, :]                          # (k, orb)
    T = Mj @ Phi_new.T
    ratio = det_small(T)
    U = Minv @ Phi_new.T                      # (elec, k)
    E = torch.zeros((n, k), dtype=Minv.dtype, device=Minv.device)
    E[js, torch.arange(k, device=Minv.device)] = 1.0
    Minv_new = Minv - (U - E) @ (inv_small(T, ratio) @ Mj)
    return ratio, Minv_new


def _spin_block(C_blk: torch.Tensor, ns_steps: int):
    """C_blk: (..., n, n, 5) one-spin block (orbital, electron, component).

    Leading axes batch (the walker axis of ``_spin_block_batched``)."""
    D = C_blk[..., 0]                                    # (orb, elec)
    sign, logdet = torch.linalg.slogdet(D)
    M, _ = torch.linalg.inv_ex(D)                        # (elec, orb)
    if ns_steps:
        M = refine_inverse(D, M, ns_steps)
    grad, lap = ratios_from_inverse(C_blk, M)
    return sign, logdet, grad, lap, M


def _spin_block_batched(C_blk: torch.Tensor, ns_steps: int):
    """Ensemble variant: C_blk (W, n, n, 5) -> sign (W,), logdet (W,),
    grad (W, n, 3), lap (W, n), M (W, n, n) in one batched pass."""
    return _spin_block(C_blk, ns_steps)


def slater_state(C: torch.Tensor, n_up: int, ns_steps: int = 1
                 ) -> SlaterState:
    """Assemble both spin determinants. C: (n_orb_tot, n_elec, 5)."""
    n_elec = C.shape[1]
    n_dn = n_elec - n_up
    su, lu, gu, qu, _ = _spin_block(C[:n_up, :n_up, :], ns_steps)
    if n_dn > 0:
        sd, ld, gd, qd, _ = _spin_block(C[n_up:, n_up:, :], ns_steps)
    else:
        sd = torch.ones_like(su); ld = torch.zeros_like(lu)
        gd = C.new_zeros((0, 3)); qd = C.new_zeros((0,))
    return SlaterState(sign=su * sd, logdet=lu + ld,
                       grad=torch.cat([gu, gd], dim=0),
                       lap_ratio=torch.cat([qu, qd], dim=0))


def state_bytes(n_up: int, n_dn: int, n_walkers: int = 1,
                bytes_per: int = 4) -> int:
    """Bytes of the maintained per-walker Slater state (paper idea ii.):
    one inverse per spin block plus the running sign/logdet scalars, all
    counted at ``bytes_per`` (``precision_bytes(cfg.precision)``; the
    4-scalar tail is noise next to the n^2 blocks)."""
    return n_walkers * bytes_per * (n_up * n_up + n_dn * n_dn + 4)


# --- mixed-precision storage policy (the reference's DESIGN.md §13) -------
# The maintained (W, n, n) inverses and CI P-tables may be STORED in a
# reduced dtype; every sweep upcasts to fp32, accumulates ratios/updates in
# fp32, and quantizes back at the storage boundary (``core.sem``).  Scalars
# (positions, sign, logdet, energies) always stay fp32.
PRECISIONS = ('fp32', 'bf16', 'fp16')
_STORAGE_DTYPES = {'fp32': torch.float32, 'bf16': torch.bfloat16,
                   'fp16': torch.float16}
_PRECISION_BYTES = {'fp32': 4, 'bf16': 2, 'fp16': 2}
# Per-dtype drift contract vs a fresh fp64 recompute between refreshes:
# (relative Minv error, absolute logdet error), the reference's table.
# fp32 keeps the §6 1e-4 bound; the reduced dtypes are bounded by the
# storage quantization step (bf16: 8-bit mantissa ~ 4e-3, fp16: 11-bit
# ~ 5e-4) times a random-walk accumulation factor over the
# <= sem_refresh * n_e moves between full refreshes.
_DRIFT_TOLERANCE = {'fp32': (1e-4, 1e-4), 'bf16': (4e-2, 2e-1),
                    'fp16': (5e-3, 2.5e-2)}


def storage_dtype(precision: str) -> torch.dtype:
    """Storage dtype of the maintained inverses / P-tables for a policy."""
    return _STORAGE_DTYPES[precision]


def precision_bytes(precision: str) -> int:
    """Bytes per element of the stored ensemble state for a policy."""
    return _PRECISION_BYTES[precision]


def drift_tolerance(precision: str) -> tuple[float, float]:
    """(relative Minv, absolute logdet) drift bound vs fp64 recompute."""
    return _DRIFT_TOLERANCE[precision]
