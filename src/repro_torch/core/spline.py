"""Tricubic MO-interpolation baseline (the paper's Einspline comparison).

Port of ``repro.core.spline``.  Most QMC codes pre-tabulate each molecular
orbital on a regular 3-D grid and interpolate value/gradient/Laplacian per
electron (paper §IV.B.4, Table III).  The paper argues against this: the
memory grows as n_orb * nx*ny*nz while the direct computation needs only
the (A, basis) pair, and the interpolation is a gather, bound by memory
latency, where the recomputation is bound by arithmetic.  This module makes
that comparison concrete on the card:

* ``build_mo_grid``   — tabulate the MOs (values only) on a uniform grid,
  through the port's ``aos.eval_ao_block`` and ``mos.mo_products_dense``;
* ``interp_mo_block`` — tricubic (Catmull–Rom) interpolation of C1..C5 per
  electron, in the layout of ``mos.mo_products_*``.

Plain torch in fp32 on the coordinates' device: the reference computes it
in plain jnp, outside any Pallas kernel.  Catmull–Rom reproduces
quadratics without a spline-coefficient solve; Einspline's uniform
B-splines have the same stencil width, operation count and memory-traffic
pattern, so the cost comparison is faithful although the boundary
behaviour differs slightly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import aos, mos


class MOGrid(NamedTuple):
    """Regular-grid tabulation of all MOs (paper §IV's spline table)."""

    values: torch.Tensor    # (n_orb, nx, ny, nz) f32 — tabulated MO values
    origin: torch.Tensor    # (3,)
    inv_h: torch.Tensor     # (3,) 1/spacing

    @property
    def memory_bytes(self) -> int:
        """Size of the tabulated grid in bytes."""
        return self.values.numel() * self.values.element_size()


def build_mo_grid(basis, coords: torch.Tensor, mo: torch.Tensor,
                  shape: tuple[int, int, int], margin: float = 6.0,
                  chunk: int = 256) -> MOGrid:
    """Tabulate phi_i on a uniform grid covering the molecule + margin,
    ``chunk`` grid points a pass.  ``basis``: ``BasisSet`` or
    ``aos.BasisTensors``; the grid lives on ``coords``' device."""
    coords = coords.to(torch.float32)
    mo = mo.to(device=coords.device, dtype=torch.float32)
    lo = torch.min(coords, dim=0).values - margin
    hi = torch.max(coords, dim=0).values + margin
    axes = [torch.linspace(float(lo[d]), float(hi[d]), shape[d],
                           dtype=torch.float32, device=coords.device)
            for d in range(3)]
    X, Y, Z = torch.meshgrid(*axes, indexing='ij')
    pts = torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], dim=-1)

    n_orb = mo.shape[0]
    out = []
    for start in range(0, pts.shape[0], chunk):
        B, _ = aos.eval_ao_block(basis, coords, pts[start:start + chunk])
        out.append(mos.mo_products_dense(mo, B)[..., 0])    # (n_orb, g)
    vals = torch.cat(out, dim=1).reshape((n_orb,) + tuple(shape))
    h = (hi - lo) / (torch.tensor(shape, dtype=lo.dtype,
                                  device=lo.device) - 1.0)
    return MOGrid(values=vals, origin=lo, inv_h=1.0 / h)


def _cr_weights(t: torch.Tensor):
    """Catmull–Rom basis at fractional offset t for a [-1,0,1,2] stencil.

    Returns (w, dw, d2w) each of shape t.shape + (4,); derivatives are in
    stencil units (the caller multiplies by inv_h powers).
    """
    t2 = t * t
    t3 = t2 * t
    w = torch.stack([
        -0.5 * t3 + t2 - 0.5 * t,
        1.5 * t3 - 2.5 * t2 + 1.0,
        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
        0.5 * t3 - 0.5 * t2,
    ], dim=-1)
    dw = torch.stack([
        -1.5 * t2 + 2.0 * t - 0.5,
        4.5 * t2 - 5.0 * t,
        -4.5 * t2 + 4.0 * t + 0.5,
        1.5 * t2 - t,
    ], dim=-1)
    d2w = torch.stack([
        -3.0 * t + 2.0,
        9.0 * t - 5.0,
        -9.0 * t + 4.0,
        3.0 * t - 1.0,
    ], dim=-1)
    return w, dw, d2w


# (x, y, z) weight kinds of the seven contractions: value, three gradient
# components, the three second derivatives the Laplacian sums (0: w,
# 1: dw, 2: d2w)
_KINDS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
          (2, 0, 0), (0, 2, 0), (0, 0, 2))


def interp_mo_block(grid: MOGrid, r_elec: torch.Tensor,
                    chunk: int = 4096) -> torch.Tensor:
    """Tricubic interpolation of C: (n_orb, n_e, 5) at electron positions
    r_elec (n_e, 3).

    The 4x4x4 stencil gather per electron is the memory-latency hot spot
    the paper identifies; all orbitals share one stencil.  ``chunk``
    electrons a pass bound the gathered (n_orb, chunk, 64) block (at
    W = 256 on ``smallest`` one unchunked block would be ~0.8 GB)."""
    vals = grid.values
    n_orb, nx, ny, nz = vals.shape
    flat = vals.reshape(n_orb, nx * ny * nz)
    r = r_elec.to(device=vals.device, dtype=vals.dtype)
    u = (r - grid.origin[None, :]) * grid.inv_h[None, :]      # grid coords
    dims = torch.tensor([nx, ny, nz], dtype=u.dtype, device=u.device)
    base = torch.minimum(torch.clamp(torch.floor(u), min=1.0), dims - 3.0)
    t = u - base                                              # (n_e, 3)
    i0 = base.to(torch.int64) - 1                             # stencil start
    w, dw, d2w = _cr_weights(t)                               # (n_e, 3, 4)
    kinds = torch.stack([w, dw, d2w])                         # (3, n_e, 3, 4)
    # the seven (n_e, 64) weight stencils, (x, y, z) row-major like the
    # gathered block
    sx = kinds[[k[0] for k in _KINDS], :, 0]                  # (7, n_e, 4)
    sy = kinds[[k[1] for k in _KINDS], :, 1]
    sz = kinds[[k[2] for k in _KINDS], :, 2]
    stencil = (sx[..., :, None, None] * sy[..., None, :, None]
               * sz[..., None, None, :]).reshape(7, -1, 64)
    off = torch.arange(4, device=u.device)
    lin = (((i0[:, 0, None, None, None] + off[:, None, None]) * ny
            + (i0[:, 1, None, None, None] + off[None, :, None])) * nz
           + (i0[:, 2, None, None, None] + off[None, None, :]))
    lin = lin.reshape(-1, 64)                                 # (n_e, 64)
    ih = grid.inv_h
    out = []
    for s in range(0, lin.shape[0], chunk):
        idx = lin[s:s + chunk]
        block = flat[:, idx.reshape(-1)].reshape(n_orb, -1, 64)
        c = torch.einsum('oek,jek->oej', block, stencil[:, s:s + chunk])
        lap = (c[..., 4] * ih[0] ** 2 + c[..., 5] * ih[1] ** 2
               + c[..., 6] * ih[2] ** 2)
        out.append(torch.stack([c[..., 0], c[..., 1] * ih[0],
                                c[..., 2] * ih[1], c[..., 3] * ih[2], lap],
                               dim=-1))
    return torch.cat(out, dim=1)                              # (orb, n_e, 5)
