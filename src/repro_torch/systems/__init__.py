"""System catalog: named molecules + the paper's benchmark systems.

Port of ``repro.systems``.  ``build_system(name)`` resolves a name to
``(WavefunctionConfig, params)`` on a device: real molecules (``h2``,
``water``) get exact small-basis wavefunctions with the dense MO product;
paper bench names (``smallest``, ``b-strand``, ``1ze7``, ...) get the
synthetic peptide wavefunctions with ``method='kernel'``, so on the card
the MO product and the Sherman–Morrison update run the CUDA kernels.
``n_det > 1`` attaches a seeded synthetic CI expansion (and the virtual
orbitals it excites into) to either kind; ``screen_eps`` the cell-list
distance screening of ``core.screening`` (the ``screened_mo`` CUDA kernel
carries the MO product of a screened bench system on the card).
"""
from __future__ import annotations

from repro_torch.device import resolve_device

MOLECULES = ('h2', 'water')


def build_system(name: str, n_det: int = 1, ci_seed: int = 0,
                 screen_eps: float | None = None, device=None):
    """Resolve a system name to ``(WavefunctionConfig, params)``.

    ``device``: ``None``/``'cuda'`` (raises without a GPU) or ``'cpu'``.
    ``n_det``: CI expansion size (1 = single determinant); ``ci_seed``
    seeds the synthetic excitation draw (``systems.bench.synthetic_ci``).
    ``screen_eps`` (None = off) attaches the cell-list AO screening
    structure at that tolerance (``core.screening``) to either kind of
    system; 0.0 drops only exact zeros, negative values build the
    exhaustive (no-op) structure.
    """
    dev = resolve_device(device)
    if name in MOLECULES:
        from repro_torch.systems import molecule as mol
        m, shells = {'h2': mol.h2, 'water': mol.water}[name]()
        if n_det <= 1:
            return mol.build_wavefunction(m, shells, screen_eps=screen_eps,
                                          device=dev)
        from repro_torch.core.basis import build_basis
        from repro_torch.systems.bench import synthetic_ci
        n_ao = build_basis(shells, m.coords.shape[0]).n_ao
        n_orb = min(n_ao, max(m.n_up, m.n_dn) + 6)
        ci = synthetic_ci(m.n_up, m.n_dn, n_orb, n_det, seed=ci_seed)
        return mol.build_wavefunction(m, shells, n_orb=n_orb, ci=ci,
                                      screen_eps=screen_eps, device=dev)
    from repro_torch.systems.bench import (PAPER_SYSTEMS,
                                           build_bench_wavefunction,
                                           paper_system)
    if name not in PAPER_SYSTEMS:
        raise NotImplementedError(
            f'system {name!r} is not ported (ported: '
            f'{MOLECULES + tuple(PAPER_SYSTEMS)})')
    return build_bench_wavefunction(paper_system(name), method='kernel',
                                    n_det=n_det, ci_seed=ci_seed,
                                    screen_eps=screen_eps, device=dev)


__all__ = ['MOLECULES', 'build_system']
