"""Atomic-orbital evaluation: values, gradients, Laplacians + sparsity lists.

Port of ``repro.core.aos``.  Produces the paper's B matrices

    B1[j, i] = chi_j(r_i)            (values)
    B2..B4   = d chi_j / dx,dy,dz    (gradients)
    B5       = laplacian chi_j       (Laplacians)

stacked as ``B: (n_ao, n_elec, 5)``, plus the per-electron active-AO index
lists that make B sparse (paper §III: AOs of atoms farther than the atomic
radius are exact zeros).  The public layouts are the JAX package's:
``(n_ao, N, 5)`` for flat input and ``(W, n_ao, n_e, 5)`` for walker
batches.  The screened variants (``eval_ao_block_screened``,
``eval_ao_values_screened``) evaluate only the candidate AOs of each
electron that ``core.screening`` lists, packed as (N, K, 5) / (N, K).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .basis import BasisSet, MAX_POW


class BasisTensors(NamedTuple):
    """``BasisSet`` constants on one device, dtypes pinned.

    ``BasisSet`` holds float64 numpy arrays and ``torch.from_numpy`` keeps
    float64, so the pins (int64 indices, fp32 values) are explicit, as
    ``repro.core.aos._basis_consts`` pins them.  Built once per
    configuration (``WavefunctionConfig.basis_t``): a host-to-device copy
    inside the sweep would stall the stream on every move.
    """

    ao_atom: torch.Tensor       # (n_ao,) int64
    ao_pow: torch.Tensor        # (n_ao, 3) int64
    prim_coeff: torch.Tensor    # (n_ao, P) f32
    prim_exp: torch.Tensor      # (n_ao, P) f32
    atom_radius2: torch.Tensor  # (n_atoms,) f32

    @property
    def n_ao(self) -> int:
        """Total number of atomic orbitals."""
        return int(self.ao_atom.shape[0])


def basis_tensors(basis: BasisSet, device) -> BasisTensors:
    """Pin a host ``BasisSet`` to (int64, int64, f32, f32, f32) on device."""
    def _t(x, dt):
        return torch.as_tensor(x).to(device=device, dtype=dt)
    return BasisTensors(_t(basis.ao_atom, torch.int64),
                        _t(basis.ao_pow, torch.int64),
                        _t(basis.prim_coeff, torch.float32),
                        _t(basis.prim_exp, torch.float32),
                        _t(basis.atom_radius2, torch.float32))


def _consts(basis, device) -> BasisTensors:
    if isinstance(basis, BasisTensors):
        return basis
    return basis_tensors(basis, device)


def _monomial_1d(x: torch.Tensor, n: torch.Tensor):
    """f(x)=x^n and df, d2f for integer n in [0, MAX_POW].

    x: (..., n_ao), n: (n_ao,) integer.  Derivative factors vanish for
    n == 0/1 (coefficients, not negative powers), as in the reference.
    """
    powers = [torch.ones_like(x)]
    for _ in range(MAX_POW):
        powers.append(powers[-1] * x)
    powers = torch.stack(powers, dim=-1)                  # (..., n_ao, P+1)
    nf = n.to(x.dtype)

    def _take(k):
        kk = torch.clamp(n + k, 0, MAX_POW).expand(x.shape)[..., None]
        return torch.gather(powers, -1, kk)[..., 0]

    f = _take(0)
    df = nf * _take(-1)
    d2f = nf * (nf - 1.0) * _take(-2)
    return f, df, d2f


def _ao_components(d: torch.Tensor, r2: torch.Tensor, ao_pow: torch.Tensor,
                   prim_c: torch.Tensor, prim_a: torch.Tensor):
    """Value, gradient and Laplacian of AOs at displacements ``d`` (..., 3)
    from their atoms, ``r2`` = |d|^2: (..., 5).  The basis constants
    broadcast against ``d`` (one row per AO for the dense block, one per
    candidate slot for the screened one), so both evaluate every element
    with the same arithmetic."""
    expo = torch.exp(-prim_a * r2[..., None])               # (..., P)
    g = torch.sum(prim_c * expo, dim=-1)
    gp = torch.sum(-prim_a * prim_c * expo, dim=-1)
    gpp = torch.sum(prim_a ** 2 * prim_c * expo, dim=-1)

    fs, dfs, d2fs = [], [], []
    for l in range(3):
        f, df, d2f = _monomial_1d(d[..., l], ao_pow[..., l])
        fs.append(f); dfs.append(df); d2fs.append(d2f)
    poly = fs[0] * fs[1] * fs[2]

    val = poly * g
    grads = []
    for l in range(3):
        others = fs[(l + 1) % 3] * fs[(l + 2) % 3]
        grads.append(dfs[l] * others * g + poly * 2.0 * d[..., l] * gp)
    lap = torch.zeros_like(val)
    for l in range(3):
        others = fs[(l + 1) % 3] * fs[(l + 2) % 3]
        x = d[..., l]
        lap = lap + (d2fs[l] * others * g
                     + 2.0 * dfs[l] * others * 2.0 * x * gp
                     + poly * (2.0 * gp + 4.0 * x * x * gpp))
    return torch.stack([val] + grads + [lap], dim=-1)


def _ao_values(d: torch.Tensor, r2: torch.Tensor, ao_pow: torch.Tensor,
               prim_c: torch.Tensor, prim_a: torch.Tensor) -> torch.Tensor:
    """AO values only at displacements ``d`` (..., 3), broadcast as in
    ``_ao_components``."""
    expo = torch.exp(-prim_a * r2[..., None])
    g = torch.sum(prim_c * expo, dim=-1)
    poly = torch.ones_like(g)
    for l in range(3):
        n = ao_pow[..., l]
        x = d[..., l]
        # value factor of the monomial table only
        f = torch.ones_like(x)
        for k in range(1, MAX_POW + 1):
            f = torch.where(n >= k, f * x, f)
        poly = poly * f
    return poly * g


def _eval_ao_rows(bt: BasisTensors, coords: torch.Tensor,
                  r_elec: torch.Tensor):
    """(N, n_ao, 5) AO block in the compute layout, the (N, n_atoms) mask
    and the squared electron-atom distances (N, n_atoms)."""
    dxyz_at = r_elec[..., None, :] - coords                 # (N, n_at, 3)
    r2_at = torch.sum(dxyz_at * dxyz_at, dim=-1)            # (N, n_at)
    atom_active = r2_at < bt.atom_radius2

    d = dxyz_at[..., bt.ao_atom, :]                         # (N, n_ao, 3)
    r2 = r2_at[..., bt.ao_atom]                             # (N, n_ao)
    B = _ao_components(d, r2, bt.ao_pow, bt.prim_coeff, bt.prim_exp)
    active = atom_active[..., bt.ao_atom]                   # (N, n_ao)
    B = torch.where(active[..., None], B, torch.zeros((), dtype=B.dtype,
                                                      device=B.device))
    return B, atom_active, r2_at


def eval_ao_block(basis, coords: torch.Tensor, r_elec: torch.Tensor):
    """Evaluate all AOs at electron positions.

    Args:
      basis: ``BasisSet`` (host numpy) or ``BasisTensors`` (on device).
      coords: (n_atoms, 3) nuclear positions.
      r_elec: (N, 3) electron positions, or a (W, n_e, 3) walker batch.

    Returns:
      B: (n_ao, N, 5) f32 for 2-D input, (W, n_ao, n_e, 5) for 3-D input —
        value, ddx, ddy, ddz, laplacian.
      atom_active: (N, n_atoms) / (W, n_e, n_atoms) bool.

    Both forms are the reference's layouts, one transpose copy of the
    block the AO pass computes as (N, n_ao, 5).  The MO-product kernels
    read that block as it is (``eval_ao_rows``), without the copy.
    """
    bt = _consts(basis, r_elec.device)
    if r_elec.ndim == 3:
        W, n_e, _ = r_elec.shape
        B, atom_active, _ = _eval_ao_rows(bt, coords, r_elec.reshape(-1, 3))
        B = B.reshape(W, n_e, bt.n_ao, 5).transpose(1, 2).contiguous()
        return B, atom_active.reshape(W, n_e, -1)
    B, atom_active, _ = _eval_ao_rows(bt, coords, r_elec)
    return B.transpose(0, 1).contiguous(), atom_active


def tile_key_dtype(n_atoms: int) -> torch.dtype:
    """The narrowest integer type of an atom index: the MO-product kernels
    sort electrons by nearest atom, and a radix sort takes one pass per key
    byte (uint8 up to 255 atoms, int16, then int32)."""
    if n_atoms <= 256:
        return torch.uint8
    return torch.int16 if n_atoms <= 2 ** 15 else torch.int32


def eval_ao_rows(basis, coords: torch.Tensor, r_elec: torch.Tensor):
    """All AOs at flat electron positions, in the AO pass's own layout.

    Args:
      basis: ``BasisSet`` or ``BasisTensors``.
      coords: (n_atoms, 3) nuclear positions.
      r_elec: (N, 3) electron positions (any walker-flattened batch).

    Returns:
      B: (N, n_ao, 5) f32 — electron-major rows, the layout the MO-product
        kernel reads (``kernels.sparse_mo.ops.sparse_mo_rows``);
        ``eval_ao_block`` returns its transpose.
      atom_active: (N, n_atoms) bool.
      nearest: (N,) index of each electron's nearest atom — the kernel's
        tile key (``kernels.mo_tile``) — in ``tile_key_dtype``.
    """
    bt = _consts(basis, r_elec.device)
    B, atom_active, r2_at = _eval_ao_rows(bt, coords, r_elec)
    return B, atom_active, torch.argmin(r2_at, dim=-1).to(
        tile_key_dtype(r2_at.shape[-1]))


def eval_ao_values(basis, coords: torch.Tensor, r_elec: torch.Tensor):
    """AO values only at a batch of points — the per-move fast path.

    r_elec: (N, 3).  Returns vals (n_ao, N) f32 (exact zeros outside atomic
    radii) and atom_active (N, n_atoms) bool.
    """
    bt = _consts(basis, r_elec.device)
    dxyz_at = r_elec[..., None, :] - coords
    r2_at = torch.sum(dxyz_at * dxyz_at, dim=-1)
    atom_active = r2_at < bt.atom_radius2
    d = dxyz_at[..., bt.ao_atom, :]
    r2 = r2_at[..., bt.ao_atom]
    val = _ao_values(d, r2, bt.ao_pow, bt.prim_coeff, bt.prim_exp)
    active = atom_active[..., bt.ao_atom]
    val = torch.where(active, val, torch.zeros((), dtype=val.dtype,
                                               device=val.device))
    return val.T, atom_active


def _candidate_geometry(bt: BasisTensors, coords: torch.Tensor,
                        r_elec: torch.Tensor, idx: torch.Tensor):
    """Per candidate slot: the displacement from its AO's atom, |d|^2, and
    the AO's constants gathered to (N, K, ...)."""
    i = idx.to(torch.int64)
    d = r_elec[..., None, :] - coords[bt.ao_atom[i]]        # (N, K, 3)
    r2 = torch.sum(d * d, dim=-1)                           # (N, K)
    return d, r2, bt.ao_pow[i], bt.prim_coeff[i], bt.prim_exp[i]


def eval_ao_block_screened(basis, coords: torch.Tensor, r_elec: torch.Tensor,
                           idx: torch.Tensor, active: torch.Tensor):
    """Screened AO evaluation: only the candidate (electron, AO) pairs
    (``repro.core.aos.eval_ao_block_screened``).

    The packed-CSR sibling of ``eval_ao_block``: value, gradient and
    Laplacian at each electron's candidate AOs — O(N * K) work and memory.
    The per-element arithmetic is ``_eval_ao_rows``'s (``_ao_components``
    on the same displacement and |d|^2), so an active slot equals the
    corresponding dense B entry bitwise.

    Args:
      basis: ``BasisSet`` or ``BasisTensors``.
      coords: (n_atoms, 3) nuclear positions.
      r_elec: (N, 3) electron positions (any walker-flattened batch).
      idx: (N, K) candidate AO ids (``screening.active_ao_lists``).
      active: (N, K) bool — inside-cutoff mask; inactive slots zero.

    Returns Bp: (N, K, 5) float32 packed values (zeros at inactive slots).
    """
    bt = _consts(basis, r_elec.device)
    Bp = _ao_components(*_candidate_geometry(bt, coords, r_elec, idx))
    return torch.where(active[..., None], Bp,
                       torch.zeros((), dtype=Bp.dtype, device=Bp.device))


def eval_ao_values_screened(basis, coords: torch.Tensor, r_elec: torch.Tensor,
                            idx: torch.Tensor, active: torch.Tensor):
    """Screened AO values only — the single-electron-move fast path
    (``repro.core.aos.eval_ao_values_screened``): ``eval_ao_values``
    restricted to each point's candidate list, O(K) per proposed move.
    Returns vals: (N, K), zeros at inactive slots."""
    bt = _consts(basis, r_elec.device)
    val = _ao_values(*_candidate_geometry(bt, coords, r_elec, idx))
    return torch.where(active, val, torch.zeros((), dtype=val.dtype,
                                                device=val.device))


def active_ao_indices(basis, atom_active: torch.Tensor, k_max: int,
                      ao_mask: torch.Tensor | None = None):
    """Per-electron padded active-AO index lists (paper's ``indices``).

    Args:
      atom_active: (n_e, n_atoms) bool.
      k_max: pad/truncate length.
      ao_mask: optional precomputed ``atom_active[:, ao_atom]`` (n_e, n_ao).

    Returns idx (n_e, k_max) int64 ascending, padded with 0; valid
    (n_e, k_max) bool; count (n_e,) int32 true active counts (may exceed
    k_max).
    """
    if ao_mask is None:
        ao_mask = atom_active[:, _consts(basis, atom_active.device).ao_atom]
    mask = ao_mask
    count = torch.sum(mask.to(torch.int32), dim=-1)
    n_e, n_ao = mask.shape
    # scatter-based stable compaction (DESIGN.md §2): active AO j lands at
    # its rank among the electron's active AOs; inactive and overflow AOs
    # go to a dump column that is sliced off.
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    pos = torch.where(mask & (pos < k_max), pos,
                      torch.full_like(pos, k_max))
    idx = torch.zeros((n_e, k_max + 1), dtype=torch.int64, device=mask.device)
    src = torch.arange(n_ao, device=mask.device).expand(n_e, n_ao)
    idx.scatter_(1, pos, src)
    idx = idx[:, :k_max]
    valid = (torch.arange(k_max, device=mask.device)[None, :]
             < torch.clamp(count, max=k_max)[:, None])
    return idx, valid, count


def pack_b(B: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor):
    """Gather B rows into the packed per-electron representation.

    B: (n_ao, n_e, 5) -> Bp: (n_e, k_max, 5) with zeros at padding.
    """
    n_e = B.shape[1]
    Bp = B[idx, torch.arange(n_e, device=B.device)[:, None], :]
    return torch.where(valid[..., None], Bp,
                       torch.zeros((), dtype=Bp.dtype, device=Bp.device))
