"""Plain PyTorch version of the batched multideterminant ratio kernel.

After a proposed single-electron move, every excited determinant's ratio to
the moved reference is a k×k determinant of the rank-1-updated table

    P' = P - g ⊗ row,      T'_I[a, b] = P'[p_a, h_b]

and the CI sum is S' = sum_I c_I det(T'_I) R_I^other.  This evaluates both
for the whole walker ensemble without materializing P': the gathered base
blocks get the gathered rank-1 correction.
"""
from __future__ import annotations

import torch

from repro_torch.core import multidet, slater


def multidet_ratios_ref(P: torch.Tensor, g: torch.Tensor, row: torch.Tensor,
                        holes, parts, coeffs, r_other: torch.Tensor):
    """All excitation ratios + CI sum for one move
    (``repro.kernels.multidet_ratio.ref.multidet_ratios_ref``).

    P: (W, n_orb, n_occ) table of this spin block (pre-move); g: (W, n_orb)
    ``P @ phi - v_new``; row: (W, n_occ) ``Minv[j] / ratio``; holes, parts:
    (n_det, k) sentinel-padded lists; coeffs: (n_det,); r_other: (W, n_det)
    the other spin block's ratios.  Returns (ratios (W, n_det), ci (W,)).
    """
    holes = multidet._index(holes, P.device)
    parts = multidet._index(parts, P.device)
    k = holes.shape[-1]
    P_ext = multidet.extend_table(P, k)
    g_ext = multidet._pad_zero_rows(g, axis=-1, k=k)
    row_ext = multidet._pad_zero_rows(row, axis=-1, k=k)
    Tg = multidet.gather_t_blocks(P_ext, holes, parts)   # (W, n_det, k, k)
    gp = g_ext[..., parts]                               # (W, n_det, k)
    rh = row_ext[..., holes]                             # (W, n_det, k)
    ratios = slater.det_small(Tg - gp[..., :, None] * rh[..., None, :])
    c = torch.as_tensor(coeffs, dtype=ratios.dtype, device=ratios.device)
    ci = torch.sum(c * ratios * r_other, dim=-1)
    return ratios, ci
