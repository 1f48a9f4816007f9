"""Distance-based AO/MO screening via O(n) cell lists (paper §II-§III).

Port of ``repro.core.screening``.  Gaussian AOs are local: an electron sees
only the AOs of nuclei within a cutoff radius, so the per-electron active
AO count is constant in system size and the AO->MO->Slater pipeline scales
sub-quadratically.

* Host side (numpy, copied from the reference as it is): the cell list
  (``CellList``, ``_build_cell_list``) — a uniform grid over the nuclei
  with edge ``h >= max cutoff radius`` whose cells hold the padded,
  ascending AO list of their 27-cell neighborhood — and ``build_screening``,
  which builds it once per wavefunction, with per-AO cutoffs at tolerance
  ``eps`` and, where the MOs are local enough, a second cell list over MO
  support centers (``mo_cells``).
* Device side (torch): the per-electron candidate lists
  (``active_ao_lists``, ``active_mo_lists``; ``active_ao_lists_keyed`` adds
  the MO-product kernel's tile key) and the per-move orbital
  values from packed AO values (``gather_phi``, ``phi_from_packed``).  They
  read the host arrays pinned to the device once per ``Screening``
  (``ScreeningTensors``, int32/float32, cached on the structure, as
  ``WavefunctionConfig.basis_t`` pins the basis): a host-to-device copy
  inside the sweep would stall the stream on every move.

``build_screening`` counts its calls (``build_count``), so tests can show
that the structure is built once at setup and never per sweep.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .aos import tile_key_dtype
from .basis import BasisSet, ao_cutoff_radii

# construction counter: tests assert one-time setup (no rebuilds per sweep)
_BUILD_COUNT = 0


def build_count() -> int:
    """Number of ``build_screening`` calls in this process (test hook)."""
    return _BUILD_COUNT


@dataclasses.dataclass(frozen=True)
class CellList:
    """Uniform grid with padded 27-neighborhood member lists.

    ``members[c]`` holds the ascending, zero-padded ids of every site whose
    own cell is within one cell of ``c`` along each axis; ``valid`` marks
    real entries.  ``h >= max site radius`` makes the clipped query exact.
    """

    origin: np.ndarray        # (3,) grid origin (min site corner)
    h: float                  # cell edge (bohr), >= max cutoff radius
    dims: tuple               # (nx, ny, nz) cell counts
    members: np.ndarray       # (n_cells, budget) int32, padded with 0
    valid: np.ndarray         # (n_cells, budget) bool
    budget: int               # padded row width (static CSR budget)


def _build_cell_list(points: np.ndarray, h: float,
                     pad_multiple: int = 8) -> CellList:
    """Cell list over ``points`` with edge ``h`` (host-side, build once)."""
    points = np.asarray(points, np.float64)
    origin = points.min(axis=0)
    h = float(max(h, 1e-6))
    dims = np.maximum(
        np.floor((points.max(axis=0) - origin) / h).astype(np.int64) + 1, 1)
    cell = np.clip(np.floor((points - origin) / h).astype(np.int64), 0,
                   dims - 1)
    nx, ny, nz = (int(d) for d in dims)
    cid = (cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]
    per_cell: dict[int, list[int]] = {}
    for i, c in enumerate(cid):
        per_cell.setdefault(int(c), []).append(i)
    n_cells = nx * ny * nz
    nbrs: list[np.ndarray] = []
    for cx in range(nx):
        for cy in range(ny):
            for cz in range(nz):
                got: list[int] = []
                for dx in (-1, 0, 1):
                    if not 0 <= cx + dx < nx:
                        continue
                    for dy in (-1, 0, 1):
                        if not 0 <= cy + dy < ny:
                            continue
                        for dz in (-1, 0, 1):
                            if not 0 <= cz + dz < nz:
                                continue
                            c = ((cx + dx) * ny + cy + dy) * nz + cz + dz
                            got += per_cell.get(c, [])
                nbrs.append(np.sort(np.asarray(got, np.int64)))
    budget = max(1, max(len(m) for m in nbrs))
    budget += (-budget) % pad_multiple
    members = np.zeros((n_cells, budget), np.int32)
    valid = np.zeros((n_cells, budget), bool)
    for c, m in enumerate(nbrs):
        members[c, :len(m)] = m
        valid[c, :len(m)] = True
    return CellList(origin=origin, h=h, dims=(nx, ny, nz), members=members,
                    valid=valid, budget=budget)


class CellTensors(NamedTuple):
    """A ``CellList`` on one device (float32 geometry, int32 members)."""

    origin: torch.Tensor      # (3,) f32
    h: torch.Tensor           # (3,) f32, the edge on every axis
    hi: torch.Tensor          # (3,) int32, dims - 1 (clip bound)
    strides: tuple            # (ny * nz, nz, 1) for the flat cell id
    members: torch.Tensor     # (n_cells, budget) int32
    valid: torch.Tensor       # (n_cells, budget) bool


class ScreeningTensors(NamedTuple):
    """The device copy of a non-exhaustive ``Screening`` (see
    ``Screening.tensors``)."""

    ao_cells: CellTensors
    ao_radius2: torch.Tensor        # (n_ao,) f32
    ao_atom: torch.Tensor           # (n_ao,) int32
    coords: torch.Tensor            # (n_atoms, 3) f32
    mo_cells: CellTensors | None
    mo_center: torch.Tensor | None  # (n_rows, 3) f32
    mo_reach2: torch.Tensor | None  # (n_rows,) f32
    n_ao: int


def _cell_tensors(cl: CellList, device) -> CellTensors:
    nx, ny, nz = cl.dims
    return CellTensors(
        origin=torch.as_tensor(cl.origin, dtype=torch.float32,
                               device=device),
        h=torch.full((3,), cl.h, dtype=torch.float32, device=device),
        hi=torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32,
                        device=device),
        strides=(ny * nz, nz, 1),
        members=torch.as_tensor(cl.members, dtype=torch.int32,
                                device=device),
        valid=torch.as_tensor(cl.valid, dtype=torch.bool, device=device))


@dataclasses.dataclass(frozen=True)
class Screening:
    """Precomputed screening structure, built ONCE at wavefunction setup.

    All fields are host numpy (``repro.core.screening.Screening``);
    ``tensors(device)`` gives their device copy, made once per device and
    kept on the structure.  ``exhaustive=True`` is the cutoff = infinity
    degenerate: the wavefunction code routes back to the unscreened
    pipeline, bitwise identical to screening off.
    """

    eps: float                 # AO tolerance (0: exact zero structure only)
    exhaustive: bool           # True -> no cutoff, use the dense pipeline
    ao_cells: CellList | None  # atom-grid cell list with AO member rows
    ao_radius2: np.ndarray | None   # (n_ao,) effective squared cutoffs
    ao_atom: np.ndarray | None      # (n_ao,) owning nucleus (basis copy)
    coords: np.ndarray | None       # (n_atoms, 3) nuclei (build geometry)
    mo_cells: CellList | None  # MO-center cell list (None: MO screen off)
    mo_center: np.ndarray | None    # (n_rows, 3) support centroids
    mo_reach2: np.ndarray | None    # (n_rows,) squared reach radii
    n_rows: int                # MO rows the structure was built for
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def ao_budget(self) -> int:
        """Static per-electron candidate-AO width (padded CSR row)."""
        return 0 if self.ao_cells is None else self.ao_cells.budget

    @property
    def mo_budget(self) -> int:
        """Static per-electron candidate-MO width (0: MO screening off)."""
        return 0 if self.mo_cells is None else self.mo_cells.budget

    def tensors(self, device) -> ScreeningTensors:
        """The structure's arrays on ``device`` (pinned on first use)."""
        if self.exhaustive:
            raise ValueError('an exhaustive Screening has no cell lists; '
                             'route to the unscreened pipeline')
        key = str(torch.device(device))
        got = self._on_device.get(key)
        if got is None:
            def _f(x):
                return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                       device=device)
            mo = self.mo_cells is not None
            got = ScreeningTensors(
                ao_cells=_cell_tensors(self.ao_cells, device),
                ao_radius2=_f(self.ao_radius2),
                ao_atom=torch.as_tensor(self.ao_atom, dtype=torch.int32,
                                        device=device),
                coords=_f(self.coords),
                mo_cells=_cell_tensors(self.mo_cells, device) if mo else None,
                mo_center=_f(self.mo_center) if mo else None,
                mo_reach2=_f(self.mo_reach2) if mo else None,
                n_ao=int(self.ao_radius2.shape[0]))
            self._on_device[key] = got
        return got


def build_screening(basis: BasisSet, coords, mo, eps: float = 0.0,
                    mo_screen: str | bool = 'auto') -> Screening:
    """Build the cell-list screening structure (host-side, one-time;
    ``repro.core.screening.build_screening``).

    Args:
      basis: the BasisSet (per-AO cutoffs derive from its primitives).
      coords: (n_atoms, 3) nuclear positions.
      mo: (n_rows, n_ao) MO coefficient matrix A — its exact-zero support
        defines the MO reach radii.
      eps: AO screening tolerance.  ``eps < 0`` -> exhaustive (cutoff
        infinity, routes to the dense pipeline bitwise); ``eps == 0`` ->
        drop only the dense path's exact zeros (``atom_radius2``);
        ``eps > 0`` -> per-AO radial cutoffs at that tolerance.
      mo_screen: True / False / 'auto' (disable when the candidate budget
        exceeds 3/4 of the rows — delocalized MOs, compact systems).

    Returns a frozen ``Screening``; attach it to
    ``WavefunctionConfig.screening``.
    """
    global _BUILD_COUNT
    _BUILD_COUNT += 1
    coords = np.asarray(coords, np.float64)
    A = np.asarray(mo)
    n_rows = int(A.shape[0])
    if eps < 0:
        return Screening(eps=float(eps), exhaustive=True, ao_cells=None,
                         ao_radius2=None, ao_atom=None, coords=None,
                         mo_cells=None, mo_center=None, mo_reach2=None,
                         n_rows=n_rows)

    ao_atom = np.asarray(basis.ao_atom, np.int64)
    atom_r = np.sqrt(np.asarray(basis.atom_radius2, np.float64))
    # effective per-AO radius: the tolerance cutoff, never beyond the atom
    # radius (the dense path zeroes there anyway -> screened subset dense)
    r_ao = np.minimum(ao_cutoff_radii(basis, eps), atom_r[ao_atom])
    h = float(r_ao.max())

    # atom-grid cell list, member rows expanded from atoms to their AOs
    atom_cl = _build_cell_list(coords, h)
    ao_of_atom: dict[int, list[int]] = {}
    for j, a in enumerate(ao_atom):
        ao_of_atom.setdefault(int(a), []).append(j)
    rows = []
    for c in range(atom_cl.members.shape[0]):
        atoms = atom_cl.members[c][atom_cl.valid[c]]
        aos = np.sort(np.concatenate(
            [np.asarray(ao_of_atom[int(a)], np.int64) for a in atoms]
            or [np.empty((0,), np.int64)]))
        rows.append(aos)
    budget = max(1, max(len(r) for r in rows))
    budget += (-budget) % 8
    members = np.zeros((len(rows), budget), np.int32)
    valid = np.zeros((len(rows), budget), bool)
    for c, m in enumerate(rows):
        members[c, :len(m)] = m
        valid[c, :len(m)] = True
    ao_cells = CellList(origin=atom_cl.origin, h=atom_cl.h,
                        dims=atom_cl.dims, members=members, valid=valid,
                        budget=budget)

    # MO support screening: center + reach from the exact-zero structure of
    # A.  Reach_m = max over support atoms of (dist(center, atom) + the
    # atom's largest AO cutoff) — beyond it every term A[m,j] * B[j,e] is
    # an exact zero of the DENSE path, so screening C rows is error-free.
    mo_cells = mo_center = mo_reach2 = None
    if mo_screen is True or mo_screen == 'auto':
        atom_r_eff = np.zeros_like(atom_r)
        np.maximum.at(atom_r_eff, ao_atom, r_ao)
        centers = np.zeros((n_rows, 3))
        reach = np.zeros((n_rows,))
        for m in range(n_rows):
            sup = np.unique(ao_atom[np.abs(A[m]) > 0])
            if len(sup) == 0:
                continue
            centers[m] = coords[sup].mean(axis=0)
            d = np.linalg.norm(coords[sup] - centers[m], axis=1)
            reach[m] = float((d + atom_r_eff[sup]).max())
        cl = _build_cell_list(centers, float(reach.max()))
        if mo_screen is True or cl.budget <= 0.75 * n_rows:
            mo_cells, mo_center = cl, centers
            mo_reach2 = (reach * reach)

    return Screening(eps=float(eps), exhaustive=False, ao_cells=ao_cells,
                     ao_radius2=(r_ao * r_ao), ao_atom=ao_atom.astype(
                         np.int32),
                     coords=coords, mo_cells=mo_cells, mo_center=mo_center,
                     mo_reach2=mo_reach2, n_rows=n_rows)


def _pinned(scr, device) -> ScreeningTensors:
    if isinstance(scr, ScreeningTensors):
        return scr
    return scr.tensors(device)


def _cell_ids(cl: CellTensors, r: torch.Tensor) -> torch.Tensor:
    """Map points ``r: (N, 3)`` to (clipped) flat cell ids (int64)
    (``repro.core.screening._cell_ids``)."""
    c = torch.floor((r - cl.origin) / cl.h).to(torch.int32)
    c = torch.minimum(torch.clamp(c, min=0), cl.hi).to(torch.int64)
    sx, sy, _ = cl.strides
    return c[..., 0] * sx + c[..., 1] * sy + c[..., 2]


def active_ao_lists(scr, r: torch.Tensor):
    """Per-point padded-CSR active-AO lists from the cell structure
    (``repro.core.screening.active_ao_lists``).

    Args:
      scr: a non-exhaustive ``Screening`` or its ``ScreeningTensors``.
      r: (N, 3) electron positions (any walker-flattened batch).

    Returns:
      idx:    (N, budget) int32 candidate AO ids (ascending, padded 0).
      active: (N, budget) bool — candidate is within its AO cutoff.
      count:  (N,) int32 active count (diagnostics; <= budget always).
    """
    idx, active, _, _ = _ao_lists(_pinned(scr, r.device), r)
    return idx, active, torch.sum(active.to(torch.int32), dim=-1,
                                  dtype=torch.int32)


def _ao_lists(st: ScreeningTensors, r: torch.Tensor):
    """(idx, active, atom, r2): the candidate lists with each slot's atom
    and squared distance to it, (N, budget) each."""
    cl = st.ao_cells
    cid = _cell_ids(cl, r)
    idx = cl.members[cid]                                 # (N, budget)
    cand = cl.valid[cid]
    atom = st.ao_atom[idx]                                # (N, budget)
    d = r[..., None, :] - st.coords[atom]
    r2 = torch.sum(d * d, dim=-1)
    active = cand & (r2 < st.ao_radius2[idx])
    return idx, active, atom, r2


def active_ao_lists_keyed(scr, r: torch.Tensor):
    """``active_ao_lists`` and each point's nearest atom among its active
    candidates' atoms: (idx, active, count, nearest (N,) in
    ``aos.tile_key_dtype``, as ``aos.eval_ao_rows`` gives it).

    The nearest atom is the MO-product kernel's tile key
    (``kernels.mo_tile``); it costs one reduction over the (N, budget)
    distances the lists compute anyway, O(N * budget) like the rest of the
    screened pipeline.  A point with no active candidate gets the atom of
    its first slot.
    """
    st = _pinned(scr, r.device)
    idx, active, atom, r2 = _ao_lists(st, r)
    far = torch.where(active, r2, torch.full_like(r2, float('inf')))
    slot = torch.argmin(far, dim=-1, keepdim=True)
    count = torch.sum(active.to(torch.int32), dim=-1, dtype=torch.int32)
    key = torch.gather(atom, -1, slot)[:, 0]
    return idx, active, count, key.to(tile_key_dtype(st.coords.shape[0]))


def active_mo_lists(scr, r: torch.Tensor):
    """Per-point active-MO candidate lists (exact support screening;
    ``repro.core.screening.active_mo_lists``).

    Returns ``(mo_idx, mo_valid)``, each (N, mo_budget); rows of A beyond
    their reach radius are exact zeros of the dense C (DESIGN.md §11).
    """
    st = _pinned(scr, r.device)
    cl = st.mo_cells
    cid = _cell_ids(cl, r)
    mo_idx = cl.members[cid]
    cand = cl.valid[cid]
    d = r[..., None, :] - st.mo_center[mo_idx]
    r2 = torch.sum(d * d, dim=-1)
    mo_valid = cand & (r2 < st.mo_reach2[mo_idx])
    return mo_idx, mo_valid


def gather_phi(A_blk: torch.Tensor, ao_idx: torch.Tensor, vals: torch.Tensor,
               mo_idx: torch.Tensor, mo_valid: torch.Tensor,
               chunk: int = 32) -> torch.Tensor:
    """Screened per-move orbital values phi = A_blk @ chi
    (``repro.core.screening.gather_phi``; a loop over walker chunks in
    place of the reference's ``lax.scan``).

    Only active (MO, AO) pairs are touched: per walker a double-gathered
    (K_mo, K_ao) panel of A contracts the packed AO values, and the active
    results scatter into the dense phi row (inactive MOs are exact zeros).
    ``A_blk`` may be an occupied-panel slice of the full row space; active
    MO ids beyond it are dropped.

    Args:
      A_blk: (n_rows, n_ao) MO panel.
      ao_idx: (W, K_ao) candidate AO ids; vals: (W, K_ao) packed AO values
        (zero at inactive slots).
      mo_idx / mo_valid: (W, K_mo) active-MO lists from
        ``active_mo_lists``.
      chunk: walker-block size bounding the gathered panel.

    Returns phi: (W, n_rows).
    """
    n_rows = A_blk.shape[0]
    W = vals.shape[0]
    mv = mo_valid & (mo_idx < n_rows)
    mi = torch.where(mv, mo_idx, torch.zeros_like(mo_idx)).to(torch.int64)
    ai = ao_idx.to(torch.int64)
    chunk = max(1, min(chunk, W))
    parts = []
    for s in range(0, W, chunk):
        m, ix = mi[s:s + chunk], ai[s:s + chunk]
        Asub = A_blk[m[:, :, None], ix[:, None, :]]       # (c, Kmo, Kao)
        p = torch.einsum('wmk,wk->wm', Asub, vals[s:s + chunk])
        parts.append(torch.where(mv[s:s + chunk], p, torch.zeros_like(p)))
    p = torch.cat(parts, dim=0)                           # (W, Kmo)
    phi = torch.zeros((W, n_rows), dtype=p.dtype, device=p.device)
    return phi.scatter_add_(1, mi, p)


def phi_from_packed(A_blk: torch.Tensor, ao_idx: torch.Tensor,
                    vals: torch.Tensor, n_ao: int) -> torch.Tensor:
    """Per-move phi without MO screening: scatter chi, one dense GEMM
    (``repro.core.screening.phi_from_packed``).

    The packed AO values scatter into a dense (W, n_ao) row — candidates
    are unique per point and padding slots carry zeros, so ``add`` places
    each value exactly once — and one GEMM against the panel gives every
    orbital value.
    """
    W = vals.shape[0]
    dense = torch.zeros((W, n_ao), dtype=vals.dtype, device=vals.device)
    dense.scatter_add_(1, ao_idx.to(torch.int64), vals)
    return dense @ A_blk.T


def memory_budget(scr: Screening, basis: BasisSet, n_e: int, n_rows: int,
                  n_walkers: int = 1, bytes_per: int = 4) -> dict:
    """Peak-memory budget of one MO-pipeline pass (paper idea ii.;
    ``repro.core.screening.memory_budget``).

    Dense path materializes B: (n_ao, W*n_e, 5) + C: (n_rows, W*n_e, 5);
    the screened path replaces B with the packed (W*n_e, budget, 5) CSR
    (+ int32 index rows) and, with MO screening, builds C's scattered
    active panel first.  Returns byte counts for both paths.
    """
    n = n_walkers * n_e
    n_ao = basis.n_ao
    dense_b = n_ao * n * 5 * bytes_per
    dense_c = n_rows * n * 5 * bytes_per
    kb = scr.ao_budget if not scr.exhaustive else n_ao
    packed_b = n * kb * 5 * bytes_per + n * kb * 4
    panel_c = (n * scr.mo_budget * 5 * bytes_per
               if scr.mo_budget else 0)
    return dict(dense_b_bytes=dense_b, dense_c_bytes=dense_c,
                packed_b_bytes=packed_b, screened_panel_bytes=panel_c,
                screened_c_bytes=dense_c, ao_budget=kb,
                mo_budget=scr.mo_budget,
                dense_total=dense_b + dense_c,
                screened_total=packed_b + panel_c + dense_c)
