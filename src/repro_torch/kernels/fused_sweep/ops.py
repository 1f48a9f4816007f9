"""Dispatch for the fused single-electron-move sweep.

Port of ``repro.kernels.fused_sweep.ops``.  ``fused_sweep_block`` is the
entry point ``core.sem`` calls per spin block: a CPU tensor, or
``use_kernel=False``, runs the plain loop of ``ref.fused_sweep_ref``; a
CUDA tensor with ``use_kernel=True`` launches the CUDA kernel on the route
``kernel.launch_shape`` picks by size.  Nothing is padded: the TPU path
padded the matrix lanes to 128 and the walker axis to its tile (padding
walkers given log u = +1e30); one CUDA block per walker needs neither.
"""
from __future__ import annotations

from . import kernel
from .ref import fused_sweep_ref


def fused_sweep_block(minv, phi, r, r_prop, en_delta, logu, sign, logdet,
                      b_ee, ci_ops=None, *, offset: int, n_up: int,
                      use_kernel: bool = False, threads: int = 128,
                      route: str = 'auto', per_row: int | None = None):
    """One spin block's fused sweep
    (``repro.kernels.fused_sweep.ops.fused_sweep_block``).

    minv: (W, n, n) maintained inverse of this block; phi: (W, n, n_cols)
    proposal MO values (all orbitals with CI); r: (W, n_e, 3) current
    positions of both blocks; r_prop: (W, n, 3); en_delta/logu: (W, n);
    sign/logdet: (W,); b_ee: () tensor.  ``ci_ops``: None or (P, rdet,
    r_other, holes, parts, coeffs); the kernel takes the lists as int32,
    sentinel-padded to rank max(k, 2) (``WavefunctionConfig.ci_t.*_k``),
    up to ``kernel.MAX_RANK``.  ``route``, ``threads`` (shared and global
    routes) and ``per_row`` (rows route) as ``kernel.launch_shape`` takes
    them.

    The kernel updates minv, r, sign, logdet (and P, rdet) IN PLACE and
    returns them; the plain loop leaves its inputs untouched.  Returns
    (r, minv, sign, logdet, P, rdet, accept (W, n) bool, margin (W, n)).
    """
    if minv.device.type == 'cuda' and use_kernel:
        ci = None
        P = rdet = None
        if ci_ops is not None:
            P, rdet, r_other, holes, parts, coeffs = ci_ops
            ci = (P, rdet, r_other.contiguous(), holes, parts, coeffs)
        acc, margin, _ = kernel.fused_sweep_inplace(
            minv, phi.contiguous(), r, r_prop.contiguous(),
            en_delta.contiguous(), logu.contiguous(), sign, logdet, b_ee, ci,
            offset=offset, n_up=n_up, threads=threads, route=route,
            per_row=per_row)
        return r, minv, sign, logdet, P, rdet, acc, margin
    if minv.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {minv.device}')
    P = rdet = ci_args = None
    if ci_ops is not None:
        P, rdet, r_other, holes, parts, coeffs = ci_ops
        ci_args = (holes, parts, coeffs, r_other)
    (r, minv, sign, logdet, P, rdet), acc, margin = fused_sweep_ref(
        r, minv, sign, logdet, phi, r_prop, en_delta, logu, b_ee,
        offset=offset, n_up=n_up, P=P, rdet=rdet, ci_args=ci_args)
    return r, minv, sign, logdet, P, rdet, acc, margin


__all__ = ['fused_sweep_block', 'fused_sweep_ref']
