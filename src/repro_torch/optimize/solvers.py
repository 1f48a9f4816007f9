"""SR and linear-method parameter updates from accumulated block moments.

Blocks carrying the current parameter version (``opt_pv`` aux stamp) are
weighted-merged by the standard ``BlockAccumulator`` rule; the flattened
indexed aux keys are reassembled into the moment arrays and one damped
update is taken host-side in f64 (numpy only — P is tens to hundreds).

Stochastic reconfiguration (Sorella):

    S_ij = ⟨O_i O_j⟩ − ⟨O_i⟩⟨O_j⟩          (overlap / metric)
    g_i  = 2 (⟨O_i E_L⟩ − ⟨O_i⟩⟨E_L⟩)      (energy gradient)
    Δp   = −lr · (S + damping·I)⁻¹ g

Linear method (approximate: the ∂_j E_L term is dropped, so H̄ is built
from the same sampled moments SR uses plus ⟨O Oᵀ E_L⟩): diagonalize
S̄⁻¹H̄ in the {Ψ, ∂_iΨ} basis, take the lowest-real-eigenvalue vector x,
and step Δp = x[1:] / x[0].
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.runtime.blocks import BlockAccumulator

N_JASTROW = 3


def aux_array(aux, name: str, shape: tuple) -> np.ndarray:
    """Reassemble an array aux entry from its flattened indexed keys."""
    out = np.zeros(shape, np.float64)
    for idx in np.ndindex(shape):
        out[idx] = float(aux['/'.join([name, *map(str, idx)])])
    return out


@dataclasses.dataclass(frozen=True)
class Moments:
    """Merged block moments at one parameter version (all f64, host)."""

    weight: float
    n_blocks: int
    e: float                 # ⟨E_L⟩
    e2: float                # ⟨E_L²⟩
    o: np.ndarray            # (P,)   ⟨O⟩
    eo: np.ndarray           # (P,)   ⟨O E_L⟩
    oo: np.ndarray           # (P,P)  ⟨O Oᵀ⟩
    oeo: np.ndarray          # (P,P)  ⟨O Oᵀ E_L⟩

    @property
    def variance(self) -> float:
        """Population variance of E_L over the merged blocks."""
        return max(self.e2 - self.e * self.e, 0.0)


def collect_moments(blocks, n_opt: int, version: int) -> Moments | None:
    """Merge the blocks stamped with exactly this parameter version.

    A block whose ``opt_pv`` is missing, differs, or is fractional (two
    sub-blocks merged across a version change average to a non-integer
    stamp) is *rejected* — stale samples never contaminate the solve.
    Returns None when no block matches.
    """
    acc = BlockAccumulator()
    n = 0
    for b in blocks:
        if b.aux.get('opt_pv') != float(version):
            continue
        acc = acc.merge(BlockAccumulator(b.weight, b.e_mean, b.e2_mean,
                                         dict(b.aux)))
        n += 1
    if n == 0 or acc.weight <= 0.0:
        return None
    P = int(n_opt)
    return Moments(weight=acc.weight, n_blocks=n, e=acc.e_mean,
                   e2=acc.e2_mean,
                   o=aux_array(acc.aux, 'opt_o', (P,)),
                   eo=aux_array(acc.aux, 'opt_eo', (P,)),
                   oo=aux_array(acc.aux, 'opt_oo', (P, P)),
                   oeo=aux_array(acc.aux, 'opt_oeo', (P, P)))


def sr_matrices(m: Moments) -> tuple[np.ndarray, np.ndarray]:
    """(S, g): the SR overlap matrix and energy gradient."""
    S = m.oo - np.outer(m.o, m.o)
    g = 2.0 * (m.eo - m.e * m.o)
    return S, g


def sr_update(m: Moments, vec, lr: float = 0.1,
              damping: float = 1e-2, max_norm: float = 1.0) -> np.ndarray:
    """One damped stochastic-reconfiguration step from the moments.

    ``max_norm`` clamps the step length: near-singular overlap directions
    (damping only bounds them below) can otherwise throw the parameters
    out of the trust region of the quadratic model.
    """
    vec = np.asarray(vec, np.float64)
    S, g = sr_matrices(m)
    delta = -lr * np.linalg.solve(S + damping * np.eye(S.shape[0]), g)
    norm = float(np.linalg.norm(delta))
    if max_norm and norm > max_norm:
        delta *= max_norm / norm
    return vec + delta


def lm_update(m: Moments, vec, damping: float = 1e-2,
              max_norm: float = 1.0) -> np.ndarray:
    """One (approximate) linear-method step from the same moments.

    Builds the (P+1)×(P+1) generalized eigenproblem H̄ x = E S̄ x in the
    {Ψ, ΔO_i Ψ} basis (ΔO_i = O_i − ⟨O_i⟩), dropping the non-sampled
    ∂_j E_L contribution so H̄ is symmetric, and steps along the
    lowest-real-eigenvalue vector.  ``max_norm`` clamps the step length
    (the LM step is unregularized in scale where SR's lr is).
    """
    vec = np.asarray(vec, np.float64)
    P = m.o.shape[0]
    S = m.oo - np.outer(m.o, m.o)
    h0 = m.eo - m.e * m.o                         # ⟨E_L ΔO_j⟩
    Hb = np.zeros((P + 1, P + 1))
    Hb[0, 0] = m.e
    Hb[0, 1:] = h0
    Hb[1:, 0] = h0
    Hb[1:, 1:] = (m.oeo - np.outer(m.o, m.eo) - np.outer(m.eo, m.o)
                  + np.outer(m.o, m.o) * m.e)
    Sb = np.eye(P + 1)
    Sb[1:, 1:] = S + damping * np.eye(P)
    evals, evecs = np.linalg.eig(np.linalg.solve(Sb, Hb))
    delta = np.zeros(P)
    for i in np.argsort(evals.real):
        x = evecs[:, i].real
        if abs(x[0]) > 1e-8:
            delta = x[1:] / x[0]
            break
    norm = float(np.linalg.norm(delta))
    if max_norm and norm > max_norm:
        delta *= max_norm / norm
    return vec + delta
