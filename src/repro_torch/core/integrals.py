"""One-electron Gaussian integrals (McMurchie–Davidson, host-side numpy f64).

Provides overlap S, kinetic T, and nuclear-attraction V matrices over the
flattened AO basis, used to build core-Hamiltonian guess MOs:

    h C = S C eps,   h = T + V,   occupy the lowest orbitals.

This is setup-time code (runs once per molecule, pure numpy); the QMC hot
path never touches it.  Supports s/p/d/f (MAX_POW = 3).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
from scipy.special import erf

from .basis import BasisSet


def _hermite_e(i: int, j: int, t: int, Qx: float, a: float, b: float) -> float:
    """Hermite expansion coefficient E_t^{ij} (recursion, host scalars)."""
    p = a + b
    q = a * b / p
    if t < 0 or t > i + j:
        return 0.0
    if i == j == t == 0:
        return math.exp(-q * Qx * Qx)
    if j == 0:  # decrement i
        return (_hermite_e(i - 1, j, t - 1, Qx, a, b) / (2 * p)
                - (q * Qx / a) * _hermite_e(i - 1, j, t, Qx, a, b)
                + (t + 1) * _hermite_e(i - 1, j, t + 1, Qx, a, b))
    return (_hermite_e(i, j - 1, t - 1, Qx, a, b) / (2 * p)
            + (q * Qx / b) * _hermite_e(i, j - 1, t, Qx, a, b)
            + (t + 1) * _hermite_e(i, j - 1, t + 1, Qx, a, b))


def _boys(m: int, t: float) -> float:
    """Boys function F_m(t)."""
    if t < 1e-12:
        return 1.0 / (2 * m + 1)
    if t < 30.0:
        # series F_M(t) = e^{-t} sum_k (2t)^k / (2M+1)(2M+3)...(2M+2k+1),
        # then stable downward recursion F_{m-1} = (2t F_m + e^{-t})/(2m-1).
        M = m + 12
        acc, term = 0.0, 0.0
        for k in range(0, 400):
            term = (1.0 / (2 * M + 1)) if k == 0 else term * (2 * t) / (2 * M + 2 * k + 1)
            acc += term
            if term < 1e-17 * acc:
                break
        F = acc * math.exp(-t)
        for mm in range(M, m, -1):
            F = (2 * t * F + math.exp(-t)) / (2 * mm - 1)
        return F
    # large t: F_0 asymptotic + upward recursion (stable for large t)
    F = 0.5 * math.sqrt(math.pi / t) * erf(math.sqrt(t))
    for mm in range(m):
        F = ((2 * mm + 1) * F - math.exp(-t)) / (2 * t)
    return F


def _hermite_coulomb(t: int, u: int, v: int, n: int, p: float,
                     PC: np.ndarray, memo: dict) -> float:
    key = (t, u, v, n)
    if key in memo:
        return memo[key]
    if t < 0 or u < 0 or v < 0:
        return 0.0
    if t == u == v == 0:
        val = ((-2.0 * p) ** n) * _boys(n, p * float(PC @ PC))
    elif t > 0:
        val = ((t - 1) * _hermite_coulomb(t - 2, u, v, n + 1, p, PC, memo)
               + PC[0] * _hermite_coulomb(t - 1, u, v, n + 1, p, PC, memo))
    elif u > 0:
        val = ((u - 1) * _hermite_coulomb(t, u - 2, v, n + 1, p, PC, memo)
               + PC[1] * _hermite_coulomb(t, u - 1, v, n + 1, p, PC, memo))
    else:
        val = ((v - 1) * _hermite_coulomb(t, u, v - 2, n + 1, p, PC, memo)
               + PC[2] * _hermite_coulomb(t, u, v - 1, n + 1, p, PC, memo))
    memo[key] = val
    return val


def _prim_overlap(a, la, A, b, lb, B):
    p = a + b
    pref = (math.pi / p) ** 1.5
    out = pref
    for x in range(3):
        out *= _hermite_e(la[x], lb[x], 0, A[x] - B[x], a, b)
    return out


def _prim_kinetic(a, la, A, b, lb, B):
    """T_ab = -1/2 <a|del^2|b> via angular-momentum shifts on b."""
    lb = tuple(lb)

    def _S(lbx):
        return _prim_overlap(a, la, A, b, lbx, B)

    term = b * (2 * sum(lb) + 3) * _S(lb)
    for x in range(3):
        up = list(lb); up[x] += 2
        term += -2.0 * b * b * _S(tuple(up))
        if lb[x] >= 2:
            dn = list(lb); dn[x] -= 2
            term += -0.5 * lb[x] * (lb[x] - 1) * _S(tuple(dn))
    return term


def _prim_nuclear(a, la, A, b, lb, B, C):
    p = a + b
    P = (a * np.asarray(A) + b * np.asarray(B)) / p
    PC = P - np.asarray(C)
    memo: dict = {}
    val = 0.0
    for t in range(la[0] + lb[0] + 1):
        Et = _hermite_e(la[0], lb[0], t, A[0] - B[0], a, b)
        if Et == 0.0:
            continue
        for u in range(la[1] + lb[1] + 1):
            Eu = _hermite_e(la[1], lb[1], u, A[1] - B[1], a, b)
            if Eu == 0.0:
                continue
            for v in range(la[2] + lb[2] + 1):
                Ev = _hermite_e(la[2], lb[2], v, A[2] - B[2], a, b)
                if Ev == 0.0:
                    continue
                val += Et * Eu * Ev * _hermite_coulomb(t, u, v, 0, p, PC, memo)
    return 2.0 * math.pi / p * val


def one_electron_matrices(basis: BasisSet, coords: np.ndarray,
                          charges: np.ndarray):
    """Return (S, T, V) over the flattened AO list. O(n_ao^2 * P^2) host work."""
    n = basis.n_ao
    S = np.zeros((n, n)); T = np.zeros((n, n)); V = np.zeros((n, n))
    ao_at = basis.ao_atom; pows = basis.ao_pow
    pc = basis.prim_coeff.astype(np.float64)
    pe = basis.prim_exp.astype(np.float64)
    for i in range(n):
        Ai = coords[ao_at[i]]; li = tuple(int(x) for x in pows[i])
        for j in range(i + 1):
            Bj = coords[ao_at[j]]; lj = tuple(int(x) for x in pows[j])
            s = t = v = 0.0
            for ka in range(pc.shape[1]):
                ca = pc[i, ka]
                if ca == 0.0:
                    continue
                for kb in range(pc.shape[1]):
                    cb = pc[j, kb]
                    if cb == 0.0:
                        continue
                    w = ca * cb
                    aa, bb = pe[i, ka], pe[j, kb]
                    s += w * _prim_overlap(aa, li, Ai, bb, lj, Bj)
                    t += w * _prim_kinetic(aa, li, Ai, bb, lj, Bj)
                    for c_at in range(coords.shape[0]):
                        v -= w * charges[c_at] * _prim_nuclear(
                            aa, li, Ai, bb, lj, Bj, coords[c_at])
            S[i, j] = S[j, i] = s
            T[i, j] = T[j, i] = t
            V[i, j] = V[j, i] = v
    return S, T, V


def core_guess_mos(basis: BasisSet, coords: np.ndarray, charges: np.ndarray,
                   n_occ: int) -> np.ndarray:
    """Lowest-eigenvalue core-Hamiltonian MOs: (n_occ, n_ao) coefficients."""
    import scipy.linalg as sla
    S, T, V = one_electron_matrices(basis, coords, charges)
    h = T + V
    eps, C = sla.eigh(h, S)
    return np.ascontiguousarray(C[:, :n_occ].T)
