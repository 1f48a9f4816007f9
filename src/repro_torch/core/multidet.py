"""Multideterminant wavefunctions: all determinants from ONE shared inverse.

Port of ``repro.core.multidet``.  A CI expansion

    Psi_det = sum_I  c_I  D_I^up  D_I^dn

is a reference determinant (I = 0) plus per-determinant hole/particle
lists.  Every excited determinant's ratio to the reference collapses onto
the shared maintained inverse ``M = D_ref^{-1}`` through one table

    P = V @ M        (n_orb, n_occ);  V[v, e] = phi_v(r_e), all orbitals

so that det(D_I)/det(D_ref) = det(T_I), T_I[a, b] = P[p_a, h_b] — a k×k
determinant of gathered entries.  Gradient and Laplacian ratios of the CI
sum come from the same table through the Woodbury form of each excited
inverse (``ci_corrections``; DESIGN.md §8).

Padding (static shapes): every excitation list is padded to the maximum
degree ``k`` with per-slot sentinels — pad slot ``a`` holds (hole =
n_occ + a, particle = n_orb + a) — and the tables are extended with k zero
rows/columns plus an identity corner (``extend_table``), so padded slots
contribute an exact identity factor and an n_det = 1 expansion reproduces
the single-determinant pipeline.

The excitation lists are host-side numpy (``MultiDetWavefunction``); the
evaluation functions take them as index tensors on the device
(``WavefunctionConfig.ci_t`` pins them once) or as numpy arrays.  Every
function takes leading batch axes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import slater


class MultiDetWavefunction(NamedTuple):
    """A CI expansion over a shared MO set (static excitation data).

    ``holes_*``/``parts_*`` are (n_det, k) int32 orbital indices; pad slot
    ``a`` holds the sentinels (n_occ_spin + a, n_orb + a).  Index 0 is the
    reference determinant (all padding).
    """

    coeffs: np.ndarray       # (n_det,) f32 CI coefficients, c_0 = reference
    holes_up: np.ndarray     # (n_det, k) i32, pad = n_up
    parts_up: np.ndarray     # (n_det, k) i32, pad = n_orb
    holes_dn: np.ndarray     # (n_det, k) i32, pad = n_dn
    parts_dn: np.ndarray     # (n_det, k) i32, pad = n_orb
    n_orb: int               # rows of the shared MO coefficient matrix

    @property
    def n_det(self) -> int:
        """Number of determinants (including the reference)."""
        return int(self.coeffs.shape[0])

    @property
    def k(self) -> int:
        """Padded excitation rank (max degree over the expansion)."""
        return int(self.holes_up.shape[1])


def from_excitations(coeffs, excitations, n_up: int, n_dn: int,
                     n_orb: int) -> MultiDetWavefunction:
    """Build an expansion from per-determinant (holes, parts) lists
    (``repro.core.multidet.from_excitations``).

    ``excitations``: one entry per determinant after the reference,
    ``((holes_up, parts_up), (holes_dn, parts_dn))``; ``coeffs`` includes
    the reference coefficient first.  Lists are validated (holes occupied,
    particles virtual, no duplicates) and sentinel-padded to the max degree.
    """
    coeffs = np.asarray(coeffs, np.float32)
    if coeffs.shape[0] != len(excitations) + 1:
        raise ValueError(f'{coeffs.shape[0]} coefficients for '
                         f'{len(excitations)} excitations + reference')
    k = max([1] + [max(len(up[0]), len(dn[0]))
                   for up, dn in excitations])

    def _pad(idx, base):
        idx = list(idx)
        return idx + [base + a for a in range(len(idx), k)]

    def _check(holes, parts, n_occ, spin):
        if len(holes) != len(parts):
            raise ValueError(f'{spin}: holes/particles length mismatch')
        if len(set(holes)) != len(holes) or len(set(parts)) != len(parts):
            raise ValueError(f'{spin}: duplicate hole/particle index')
        for h in holes:
            if not 0 <= h < n_occ:
                raise ValueError(f'{spin}: hole {h} not occupied '
                                 f'(n_occ={n_occ})')
        for p in parts:
            if not n_occ <= p < n_orb:
                raise ValueError(f'{spin}: particle {p} not virtual '
                                 f'(n_occ={n_occ}, n_orb={n_orb})')

    hu, pu = [_pad([], n_up)], [_pad([], n_orb)]   # det 0: the reference
    hd, pd = [_pad([], n_dn)], [_pad([], n_orb)]
    for (uh, up_), (dh, dp) in excitations:
        _check(uh, up_, n_up, 'up')
        _check(dh, dp, n_dn, 'dn')
        hu.append(_pad(uh, n_up)); pu.append(_pad(up_, n_orb))
        hd.append(_pad(dh, n_dn)); pd.append(_pad(dp, n_orb))
    return MultiDetWavefunction(
        coeffs=coeffs,
        holes_up=np.asarray(hu, np.int32), parts_up=np.asarray(pu, np.int32),
        holes_dn=np.asarray(hd, np.int32), parts_dn=np.asarray(pd, np.int32),
        n_orb=int(n_orb))


def _row_parity(holes, parts, n_occ: int) -> float:
    """Sign connecting the hole-row-replacement determinant to the
    sorted-occupation determinant (``repro.core.multidet._row_parity``):
    the parity of the permutation that sorts the replaced row list."""
    rows = list(range(n_occ))
    for h, p in zip(holes, parts):
        rows[h] = p
    inversions = sum(1 for i in range(len(rows))
                     for jj in range(i + 1, len(rows))
                     if rows[i] > rows[jj])
    return -1.0 if inversions % 2 else 1.0


def from_det_file(text: str, n_up: int, n_dn: int,
                  n_orb: int) -> MultiDetWavefunction:
    """Parse a determinant file (``repro.core.multidet.from_det_file``).

    One determinant per line: ``coeff  o1 o2 ... | o1 o2 ...`` (up block,
    ``|``, down block); blank lines and ``#`` comments are skipped.  The
    first determinant is the reference; the others become hole/particle
    substitutions, and the sorted-occupation sign convention of the file
    is folded into each stored coefficient (``_row_parity``).
    """
    dets = []
    for raw in text.splitlines():
        line = raw.split('#', 1)[0].strip()
        if not line:
            continue
        head, _, tail = line.partition('|')
        fields = head.split()
        coeff = float(fields[0])
        up_list = [int(x) for x in fields[1:]]
        dn_list = [int(x) for x in tail.split()]
        up_occ, dn_occ = frozenset(up_list), frozenset(dn_list)
        if (len(up_list) != n_up or len(dn_list) != n_dn
                or len(up_occ) != n_up or len(dn_occ) != n_dn):
            raise ValueError(f'det line {raw!r}: occupation counts '
                             f'{len(up_list)}/{len(dn_list)} (unique '
                             f'{len(up_occ)}/{len(dn_occ)}) != '
                             f'{n_up}/{n_dn}')
        dets.append((coeff, up_occ, dn_occ))
    if not dets:
        raise ValueError('determinant file holds no determinants')
    _, ref_up, ref_dn = dets[0]
    if ref_up != frozenset(range(n_up)) or ref_dn != frozenset(range(n_dn)):
        raise ValueError('reference determinant must occupy orbitals '
                         '0..n_occ-1 of each spin (the maintained-inverse '
                         'reference)')
    coeffs, excitations = [dets[0][0]], []
    for coeff, up_occ, dn_occ in dets[1:]:
        exc_up = (sorted(ref_up - up_occ), sorted(up_occ - ref_up))
        exc_dn = (sorted(ref_dn - dn_occ), sorted(dn_occ - ref_dn))
        parity = (_row_parity(*exc_up, n_up) * _row_parity(*exc_dn, n_dn))
        coeffs.append(coeff * parity)
        excitations.append((exc_up, exc_dn))
    return from_excitations(coeffs, excitations, n_up, n_dn, n_orb)


class CITensors(NamedTuple):
    """A ``MultiDetWavefunction`` pinned to one device, once: int64 index
    lists for the plain gathers, float32 coefficients, and for the CUDA
    kernels (``kernels.multidet_ratio``, ``kernels.fused_sweep``) the lists
    as int32, sentinel-padded to rank max(k, 2) (``*_k``)."""

    coeffs: torch.Tensor     # (n_det,) f32
    holes_up: torch.Tensor   # (n_det, k) i64
    parts_up: torch.Tensor
    holes_dn: torch.Tensor
    parts_dn: torch.Tensor
    holes_up_k: torch.Tensor   # (n_det, max(k, 2)) i32
    parts_up_k: torch.Tensor
    holes_dn_k: torch.Tensor
    parts_dn_k: torch.Tensor


def pin(mdw: MultiDetWavefunction, n_up: int, n_dn: int,
        device) -> CITensors:
    """The expansion's arrays as tensors on ``device``."""
    from repro_torch.kernels.multidet_ratio.ops import normalized_excitations

    def _i(x, dt=torch.int64):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    lists = {}
    for spin, n_occ in (('up', n_up), ('dn', n_dn)):
        holes = getattr(mdw, f'holes_{spin}')
        parts = getattr(mdw, f'parts_{spin}')
        lists[f'holes_{spin}'], lists[f'parts_{spin}'] = _i(holes), _i(parts)
        if mdw.k <= 2:
            holes, parts = normalized_excitations(holes, parts, n_occ,
                                                  mdw.n_orb)
        lists[f'holes_{spin}_k'] = _i(holes, torch.int32)
        lists[f'parts_{spin}_k'] = _i(parts, torch.int32)
    return CITensors(coeffs=_i(mdw.coeffs, torch.float32), **lists)


def _index(x, device) -> torch.Tensor:
    """An index list (tensor or numpy) as an int64 tensor on ``device``
    (no copy when it already is one)."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# Shared-inverse tables and determinant ratios
# ---------------------------------------------------------------------------
def reference_table(C_vals: torch.Tensor, Minv: torch.Tensor) -> torch.Tensor:
    """The shared ratio table P = V @ M for one spin block
    (``repro.core.multidet.reference_table``).

    C_vals: (..., n_orb, n_e) orbital values (occupied rows first); Minv:
    (..., n_e, n_e).  The occupied rows are emitted as an exact identity;
    only the virtual rows pay a GEMM.  Returns (..., n_orb, n_occ).
    """
    n_occ = Minv.shape[-1]
    eye = torch.eye(n_occ, dtype=Minv.dtype, device=Minv.device).expand(
        C_vals.shape[:-2] + (n_occ, n_occ))
    if C_vals.shape[-2] == n_occ:
        return eye.clone()
    P_virt = torch.einsum('...ve,...eh->...vh', C_vals[..., n_occ:, :], Minv)
    return torch.cat([eye, P_virt], dim=-2)


def extend_table(P: torch.Tensor, k: int) -> torch.Tensor:
    """Append k sentinel rows/columns (+ identity corner) to a
    (..., n_orb, n_occ) table (``repro.core.multidet.extend_table``)."""
    batch = P.shape[:-2]
    n_orb, n_occ = P.shape[-2:]
    out = P.new_zeros(batch + (n_orb + k, n_occ + k))
    out[..., :n_orb, :n_occ] = P
    out[..., n_orb:, n_occ:] = torch.eye(k, dtype=P.dtype, device=P.device)
    return out


def _pad_zero_rows(x: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """Append k zero slices along ``axis`` (sentinel index targets)."""
    shape = list(x.shape)
    shape[axis] = k
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def gather_t_blocks(P_ext: torch.Tensor, holes, parts) -> torch.Tensor:
    """The (..., n_det, k, k) blocks T_I[a, b] = P[p_a, h_b] of a
    sentinel-extended table (``repro.core.multidet.gather_t_blocks``)."""
    holes = _index(holes, P_ext.device)
    parts = _index(parts, P_ext.device)
    return P_ext[..., parts[:, :, None], holes[:, None, :]]


def det_ratios(P: torch.Tensor, holes, parts) -> torch.Tensor:
    """All determinants' ratios to the reference from the shared table
    (``repro.core.multidet.det_ratios``).  P: (..., n_orb, n_occ);
    returns (..., n_det), exactly 1 for the reference."""
    k = holes.shape[-1]
    return slater.det_small(gather_t_blocks(extend_table(P, k), holes,
                                            parts))


def ci_sum(coeffs, r_up: torch.Tensor, r_dn: torch.Tensor) -> torch.Tensor:
    """S = sum_I c_I R_I^up R_I^dn (``repro.core.multidet.ci_sum``)."""
    c = torch.as_tensor(coeffs, dtype=r_up.dtype, device=r_up.device)
    return torch.sum(c * r_up * r_dn, dim=-1)


def ci_log_sum(S: torch.Tensor):
    """(sign, guarded log|S|) of a CI sum — the near-node guard
    (``repro.core.multidet.ci_log_sum``): |S| floored at 1e-30, an exactly
    zero S reports sign +1."""
    safe = torch.where(torch.abs(S) > 1e-30, torch.abs(S),
                       torch.full_like(S, 1e-30))
    return torch.sign(torch.where(S == 0, torch.ones_like(S), S)), \
        torch.log(safe)


def ci_weights(coeffs, r_up: torch.Tensor, r_dn: torch.Tensor):
    """Normalized weights w_I = c_I R_I^up R_I^dn / S and S
    (``repro.core.multidet.ci_weights``)."""
    c = torch.as_tensor(coeffs, dtype=r_up.dtype, device=r_up.device)
    prod = c * r_up * r_dn
    S = torch.sum(prod, dim=-1)
    safe = torch.where(torch.abs(S) > 1e-30, S, torch.ones_like(S))
    return prod / safe[..., None], S


# ---------------------------------------------------------------------------
# CI-weighted gradient/Laplacian contractions (Woodbury, no excited inverse)
# ---------------------------------------------------------------------------
def ci_corrections(holes, parts, C_blk: torch.Tensor, Minv: torch.Tensor,
                   P: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """CI-weighted correction to the reference grad/lap contractions
    (``repro.core.multidet.ci_corrections``):

        corr = - w·Y·Z  +  w·dW·M_S  -  w·Y·(T−I)·dW

    with Y_I = M[:, S_I] T_I^{-1}, Z_I = (P dC)[p_I] − dC[h_I] and
    dW_I = dC_all[p_I] − dC[h_I]; no excited inverse is materialized.

    C_blk: (..., n_orb, n_e, 5); Minv: (..., n_e, n_e); P: (..., n_orb,
    n_occ); w: (..., n_det).  Returns (..., n_e, 4): grad_xyz, lap.
    """
    holes = _index(holes, C_blk.device)
    parts = _index(parts, C_blk.device)
    n_occ = Minv.shape[-1]
    k = holes.shape[-1]
    dC = C_blk[..., :n_occ, :, 1:5]                 # (..., n_occ, n_e, 4)

    Q = torch.einsum('...ph,...hec->...pec', P, dC)  # (..., n_orb, n_e, 4)
    Q_ext = _pad_zero_rows(Q, axis=-3, k=k)
    dC_ext = _pad_zero_rows(dC, axis=-3, k=k)
    dCall_ext = _pad_zero_rows(C_blk[..., 1:5], axis=-3, k=k)
    M_ext = _pad_zero_rows(Minv, axis=-1, k=k)

    dCh = dC_ext[..., holes, :, :]                  # (..., n_det, k, n_e, 4)
    dW = dCall_ext[..., parts, :, :] - dCh
    Z = Q_ext[..., parts, :, :] - dCh
    Mh = M_ext[..., :, holes].transpose(-3, -2)     # (..., n_det, n_e, k)

    T = gather_t_blocks(extend_table(P, k), holes, parts)
    Tinv = slater.inv_small(T)
    TmI = T - torch.eye(k, dtype=T.dtype, device=T.device)
    Y = torch.einsum('...dek,...dkl->...del', Mh, Tinv)

    term2 = torch.einsum('...d,...dek,...dkec->...ec', w, Y, Z)
    term3 = torch.einsum('...d,...dkec,...dek->...ec', w, dW, Mh)
    term4 = torch.einsum('...d,...deb,...dba,...daec->...ec', w, Y, TmI, dW)
    return -term2 + term3 - term4


class CISpinBlock(NamedTuple):
    """One spin block's shared-inverse summary (reference + table + ratios)."""

    sign: torch.Tensor       # (...,) reference determinant sign
    logdet: torch.Tensor     # (...,) reference log|det|
    grad: torch.Tensor       # (..., n_e, 3) reference grad contraction
    lap: torch.Tensor        # (..., n_e) reference lap contraction
    minv: torch.Tensor       # (..., n_e, n_e) inverse
    table: torch.Tensor      # (..., n_orb, n_occ) P = V @ M
    ratios: torch.Tensor     # (..., n_det) det(D_I)/det(D_ref)


def spin_block_ci(C_blk: torch.Tensor, holes, parts,
                  ns_steps: int = 1) -> CISpinBlock:
    """Factorize one spin block once and derive every determinant from it
    (``repro.core.multidet.spin_block_ci``).  C_blk: (..., n_orb, n_e, 5)."""
    n_e = C_blk.shape[-2]
    sign, logdet, grad, lap, M = slater._spin_block(
        C_blk[..., :n_e, :, :], ns_steps)
    P = reference_table(C_blk[..., 0], M)
    return CISpinBlock(sign=sign, logdet=logdet, grad=grad, lap=lap,
                       minv=M, table=P, ratios=det_ratios(P, holes, parts))


def ci_assemble(mdw, C_up: torch.Tensor, C_dn: torch.Tensor | None,
                ns_steps: int = 1, coeffs: torch.Tensor | None = None):
    """Full multideterminant Slater summary (``repro.core.multidet.
    ci_assemble``), batched over leading axes.

    ``mdw``: a ``MultiDetWavefunction`` or its pinned ``CITensors``.
    C_up/C_dn: (..., n_orb, n_e_spin, 5) (C_dn None when n_dn = 0).
    Returns (sign, logdet, grad, lap) of Psi_det with log|S| and sign(S)
    folded in.  ``coeffs`` overrides ``mdw.coeffs``.
    """
    c = mdw.coeffs if coeffs is None else coeffs
    up = spin_block_ci(C_up, mdw.holes_up, mdw.parts_up, ns_steps)
    dn = (spin_block_ci(C_dn, mdw.holes_dn, mdw.parts_dn, ns_steps)
          if C_dn is not None else None)
    r_dn = dn.ratios if dn is not None else torch.ones_like(up.ratios)
    w, S = ci_weights(c, up.ratios, r_dn)

    cu = ci_corrections(mdw.holes_up, mdw.parts_up, C_up, up.minv,
                        up.table, w)
    gu = up.grad + cu[..., :3]
    qu = up.lap + cu[..., 3]
    if dn is not None:
        cd = ci_corrections(mdw.holes_dn, mdw.parts_dn, C_dn, dn.minv,
                            dn.table, w)
        gd = dn.grad + cd[..., :3]
        qd = dn.lap + cd[..., 3]
        grad = torch.cat([gu, gd], dim=-2)
        lap = torch.cat([qu, qd], dim=-1)
        sign_ref = up.sign * dn.sign
        logdet_ref = up.logdet + dn.logdet
    else:
        grad, lap = gu, qu
        sign_ref, logdet_ref = up.sign, up.logdet

    sign_S, log_S = ci_log_sum(S)
    return sign_ref * sign_S, logdet_ref + log_S, grad, lap
