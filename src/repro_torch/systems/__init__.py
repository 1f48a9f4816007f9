"""System catalog: named molecules + the paper's benchmark systems.

Port of ``repro.systems``.  ``build_system(name)`` resolves a name to
``(WavefunctionConfig, params)`` on a device: real molecules (``h2``,
``water``) get exact small-basis wavefunctions with the dense MO product;
paper bench names (``smallest``, ``b-strand``, ``1ze7``, ...) get the
synthetic peptide wavefunctions with ``method='kernel'``, so on the card
the MO product and the Sherman–Morrison update run the CUDA kernels.
Multideterminant expansions and distance screening are not ported yet.
"""
from __future__ import annotations

from repro_torch.device import resolve_device

MOLECULES = ('h2', 'water')


def build_system(name: str, n_det: int = 1, ci_seed: int = 0,
                 screen_eps: float | None = None, device=None):
    """Resolve a system name to ``(WavefunctionConfig, params)``.

    ``device``: ``None``/``'cuda'`` (raises without a GPU) or ``'cpu'``.
    ``n_det > 1`` and ``screen_eps`` raise ``NotImplementedError``.
    """
    if n_det > 1:
        raise NotImplementedError('multideterminant (n_det > 1) '
                                  'wavefunctions are not ported yet')
    if screen_eps is not None:
        raise NotImplementedError('distance screening (screen_eps) is not '
                                  'ported yet')
    dev = resolve_device(device)
    if name in MOLECULES:
        from repro_torch.systems import molecule as mol
        m, shells = {'h2': mol.h2, 'water': mol.water}[name]()
        return mol.build_wavefunction(m, shells, device=dev)
    from repro_torch.systems.bench import (PAPER_SYSTEMS,
                                           build_bench_wavefunction,
                                           paper_system)
    if name not in PAPER_SYSTEMS:
        raise NotImplementedError(
            f'system {name!r} is not ported (ported: '
            f'{MOLECULES + tuple(PAPER_SYSTEMS)})')
    return build_bench_wavefunction(paper_system(name), method='kernel',
                                    device=dev)


__all__ = ['MOLECULES', 'build_system']
