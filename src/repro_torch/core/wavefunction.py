"""Trial wavefunction Psi_T = e^J * Det_up * Det_dn: assembly + local energy.

Port of ``repro.core.wavefunction`` (fp32), single determinant or a CI
expansion (``cfg.ci``, ``core.multidet``), with or without distance
screening (``cfg.screening``, ``core.screening``).  The pipeline per walker
batch (paper §II.C / §III):

    AOs B1..B5  ->  (sparsify)  ->  C_i = A B_i  ->  Slater inverse  ->
    drift (eq. 14), laplacian (eq. 15)  ->  E_L = -1/2 lap Psi/Psi + V

The MO product is 'dense' (one GEMM), 'sparse' (the paper's gather form)
or 'kernel' (the sparse CUDA kernel of ``kernels.sparse_mo`` on the AO
pass's rows; its plain version on the CPU), resolved by ``_mo_product_method``: ``method``
may also name a fused single-electron sweep ('fused', 'fused-kernel'),
which is a propagator selector, not an MO product.  With screening on,
each electron's candidate AOs come from the cell list, the AO block is
evaluated packed (N, K, 5), and the product is the screened CUDA kernel of
``kernels.screened_mo`` ('kernel'), the doubly screened gather (MO support
screening on) or the packed sparse gather.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from . import aos, mos, screening, slater
from .basis import BasisSet
from .hamiltonian import potential_energy
from .jastrow import JastrowParams, jastrow_state, jastrow_value

MO_METHODS = ('dense', 'sparse', 'kernel')
SWEEP_METHODS = ('fused', 'fused-kernel')


@dataclasses.dataclass(frozen=True)
class WavefunctionConfig:
    """Static configuration (the JAX trace-time config), closed shell:
    one MO block serves both spins (the reference's
    ``shared_orbitals=True``).

    ``basis_t`` is the basis pinned to ``device`` once, at construction
    (``aos.BasisTensors``); the hot path reads it, never the numpy arrays.
    """

    basis: BasisSet
    n_up: int
    n_dn: int
    k_max: int = 0                 # padded active-AO count; 0 -> dense
    method: str = 'sparse'         # 'dense' | 'sparse' | 'kernel' |
    #                                'fused' | 'fused-kernel' (the last two
    #                                select the fused sweep of core/sem.py;
    #                                the MO product then follows mo_method)
    mo_method: str = ''            # MO-product override ('' | MO_METHODS):
    #                                empty follows ``method``, except that
    #                                the fused methods fall back to 'sparse'
    ns_steps: int = 1              # Newton–Schulz refinement of the inverse
    sem_refresh: int = 8           # single-electron moves: full recompute
    #                                every this many sweeps, Newton–Schulz
    #                                corrector between (DESIGN.md §6)
    ci: object = None              # multidet.MultiDetWavefunction or None
    #                                (single determinant); params.mo then
    #                                carries the full orbital set (ci.n_orb
    #                                rows)
    screening: object = None       # screening.Screening or None.  When set
    #                                and not exhaustive, every AO->MO pass
    #                                runs the cell-list packed-CSR pipeline
    #                                (DESIGN.md §11); an exhaustive one
    #                                (eps < 0) routes to the unscreened
    #                                branches, bitwise.  Built once by
    #                                ``screening.build_screening``.
    precision: str = 'fp32'        # storage policy of the maintained SEM
    #                                inverses / CI P-tables: 'fp32' |
    #                                'bf16' | 'fp16' (``slater
    #                                .PRECISIONS``).  Reduced dtypes store
    #                                the (W, n, n) state low-width; every
    #                                sweep upcasts and computes in fp32
    #                                (``core.sem._to_compute`` /
    #                                ``_to_storage``).  'fp32' inserts no
    #                                cast at all.
    device: str = 'cpu'
    basis_t: aos.BasisTensors = dataclasses.field(init=False, repr=False,
                                                  compare=False)
    ci_t: object = dataclasses.field(init=False, repr=False, compare=False)
    screening_t: object = dataclasses.field(init=False, repr=False,
                                            compare=False)

    def __post_init__(self):
        if self.method not in MO_METHODS + SWEEP_METHODS:
            raise NotImplementedError(
                f'MO method {self.method!r} is not ported '
                f'(ported: {MO_METHODS + SWEEP_METHODS})')
        if self.precision not in slater.PRECISIONS:
            raise ValueError(f'unknown precision {self.precision!r} '
                             f'(choose from {slater.PRECISIONS})')
        if self.mo_method and self.mo_method not in MO_METHODS:
            raise ValueError(f'mo_method {self.mo_method!r} is not an MO '
                             f'product ({MO_METHODS})')
        object.__setattr__(self, 'basis_t',
                           aos.basis_tensors(self.basis, self.device))
        ci_t = None
        if self.ci is not None:
            from .multidet import pin
            ci_t = pin(self.ci, self.n_up, self.n_dn, self.device)
        object.__setattr__(self, 'ci_t', ci_t)
        object.__setattr__(self, 'screening_t',
                           self.screening.tensors(self.device)
                           if _screening_active(self) else None)

    @property
    def n_elec(self) -> int:
        """Total electron count (n_up + n_dn)."""
        return self.n_up + self.n_dn


class WavefunctionParams(NamedTuple):
    """Dynamic parameters, all on one device (the paper's 'A' is ``mo``)."""

    coords: torch.Tensor     # (n_at, 3)
    charges: torch.Tensor    # (n_at,)
    mo: torch.Tensor         # (n_rows, n_ao)
    jastrow: JastrowParams
    ci_coeffs: torch.Tensor | None = None   # (n_det,) override of cfg.ci's


class PsiState(NamedTuple):
    """Evaluation summary (leading walker axes, when batched)."""

    sign: torch.Tensor       # ()
    log_psi: torch.Tensor    # () log|Psi_T|
    drift: torch.Tensor      # (n_e, 3) grad log Psi_T
    e_loc: torch.Tensor      # () local energy
    e_kin: torch.Tensor      # ()
    e_pot: torch.Tensor      # ()
    ao_count: torch.Tensor   # (n_e,) active AOs per electron


def _screening_active(cfg: WavefunctionConfig) -> bool:
    """True when the cell-list screened pipeline is used
    (``repro.core.wavefunction._screening_active``): an exhaustive
    structure (cutoff = infinity) falls back to the unscreened branches,
    so the feature at infinite cutoff is bitwise inert."""
    return cfg.screening is not None and not cfg.screening.exhaustive


def _mo_product_method(cfg: WavefunctionConfig) -> str:
    """The MO-product pipeline ('dense' | 'sparse' | 'kernel') of the
    AO->MO tensor passes (``repro.core.wavefunction._mo_product_method``):
    ``cfg.mo_method`` when set; the fused sweep methods, which select a
    propagator and not a product, fall back to 'sparse'."""
    if cfg.mo_method:
        return cfg.mo_method
    if cfg.method in SWEEP_METHODS:
        return 'sparse'
    return cfg.method


def _mo_tensor_screened(cfg: WavefunctionConfig,
                        params: WavefunctionParams, r_elec: torch.Tensor,
                        chunk: int = 0):
    """Cell-list screened MO tensor: O(N * budget) instead of O(N * n_ao)
    (``repro.core.wavefunction._mo_tensor_screened``).

    Per-electron candidate AO lists from the structure built at setup, the
    AO block at those pairs only, then the product: the ``screened_mo``
    CUDA kernel for 'kernel' (its plain version on the CPU), its electron
    tiles sorted by nearest atom; the doubly
    screened gather when the structure carries MO reach radii; else the
    packed sparse gather.  r_elec: (N, 3).  Returns C (n_rows, N, 5) and
    the active AO count per electron (N,).
    """
    scr_t = cfg.screening_t
    kernel = _mo_product_method(cfg) == 'kernel'
    if kernel:
        idx, active, count, key = screening.active_ao_lists_keyed(scr_t,
                                                                  r_elec)
    else:
        idx, active, count = screening.active_ao_lists(scr_t, r_elec)
    Bp = aos.eval_ao_block_screened(cfg.basis_t, params.coords, r_elec, idx,
                                    active)
    if kernel:
        from repro_torch.kernels.screened_mo.ops import screened_mo_products
        C = screened_mo_products(params.mo, Bp, idx, active, key)
    elif scr_t.mo_cells is not None:
        mo_idx, mo_valid = screening.active_mo_lists(scr_t, r_elec)
        C = mos.mo_products_screened(params.mo, Bp, idx, mo_idx, mo_valid,
                                     chunk=chunk)
    else:
        C = mos.mo_products_sparse(params.mo, Bp, idx, chunk=chunk)
    return C, count


def _mo_tensor(cfg: WavefunctionConfig, params: WavefunctionParams,
               r_elec: torch.Tensor):
    """C: (n_rows, N, 5) for flat electrons r_elec (N, 3) + AO counts
    (one walker, for ``log_psi``)."""
    from repro_torch.kernels.sparse_mo.ops import sparse_mo_rows
    if _screening_active(cfg):
        return _mo_tensor_screened(cfg, params, r_elec)
    bt = cfg.basis_t
    method = _mo_product_method(cfg)
    if method == 'kernel':
        B, atom_active, key = aos.eval_ao_rows(bt, params.coords, r_elec)
        ao_mask = atom_active[:, bt.ao_atom]
        count = torch.sum(ao_mask, dim=-1).to(torch.int32)
        return sparse_mo_rows(params.mo, B, ao_mask, key), count
    B, atom_active = aos.eval_ao_block(bt, params.coords, r_elec)
    ao_mask = atom_active[:, bt.ao_atom]
    count = torch.sum(ao_mask, dim=-1).to(torch.int32)
    if method == 'dense' or cfg.k_max <= 0:
        return mos.mo_products_dense(params.mo, B), count
    idx, valid, _ = aos.active_ao_indices(bt, atom_active, cfg.k_max,
                                          ao_mask=ao_mask)
    Bp = aos.pack_b(B, idx, valid)
    return mos.mo_products_sparse(params.mo, Bp, idx), count


def _mo_tensor_ensemble(cfg: WavefunctionConfig, params: WavefunctionParams,
                        R: torch.Tensor):
    """Ensemble MO tensor: one pass over all walkers.

    R: (W, n_e, 3).  Returns Cw: (W, n_rows, n_e, 5) and count: (W, n_e).

      * dense  — one batched GEMM against the shared A;
      * sparse — per-electron gather flattened walker-major;
      * kernel — the AO pass runs on the flattened (W * n_e, 3) positions
        and the kernel reads its (W * n_e, n_ao, 5) rows as they are (no
        layout copy), in tiles of electrons sorted by nearest atom.

    With screening on, the screened pipeline runs on the flattened
    electrons (``_mo_tensor_screened``) and ``count`` is the active count.
    """
    from repro_torch.kernels.sparse_mo.ops import sparse_mo_rows
    W, n_e, _ = R.shape
    bt = cfg.basis_t
    method = _mo_product_method(cfg)
    n_rows = params.mo.shape[0]
    if _screening_active(cfg):
        C, count = _mo_tensor_screened(
            cfg, params, R.reshape(W * n_e, 3),
            chunk=mos.default_chunk(W * n_e, ensemble=True))
        return (C.reshape(n_rows, W, n_e, 5).transpose(0, 1),
                count.reshape(W, n_e))
    if method == 'kernel':
        B, atom_active, key = aos.eval_ao_rows(bt, params.coords,
                                               R.reshape(W * n_e, 3))
        ao_mask = atom_active[:, bt.ao_atom]                # (W*n_e, n_ao)
        count = torch.sum(ao_mask, dim=-1).to(torch.int32).reshape(W, n_e)
        C = sparse_mo_rows(params.mo, B, ao_mask, key)      # (rows, W*n_e, 5)
        return C.reshape(n_rows, W, n_e, 5).transpose(0, 1), count
    Bw, atom_active = aos.eval_ao_block(bt, params.coords, R)
    ao_mask = atom_active[..., bt.ao_atom]                  # (W, n_e, n_ao)
    count = torch.sum(ao_mask, dim=-1).to(torch.int32)
    if method == 'dense' or cfg.k_max <= 0:
        return torch.einsum('oa,waec->woec', params.mo, Bw), count
    idx, valid, _ = aos.active_ao_indices(
        bt, atom_active.reshape(W * n_e, -1), cfg.k_max,
        ao_mask=ao_mask.reshape(W * n_e, -1))
    B_flat = Bw.transpose(0, 1).reshape(Bw.shape[1], W * n_e, 5)
    Bp = aos.pack_b(B_flat, idx, valid)                     # (W*n_e, K, 5)
    C = mos.mo_products_sparse(params.mo, Bp, idx,
                               chunk=mos.default_chunk(W * n_e,
                                                       ensemble=True))
    return C.reshape(n_rows, W, n_e, 5).transpose(0, 1), count


def _slater_blocks(cfg: WavefunctionConfig, C: torch.Tensor):
    """Split C (..., rows, elec, 5) into the (..., orb, elec, 5) spin blocks."""
    return C[..., :cfg.n_up, :cfg.n_up, :], C[..., :cfg.n_dn, cfg.n_up:, :]


def _ci_blocks(cfg: WavefunctionConfig, C: torch.Tensor):
    """Full per-spin MO tensors (all ``cfg.ci.n_orb`` orbital rows) for the
    CI machinery (``repro.core.wavefunction._ci_blocks``): only the
    electron axis is split."""
    up = C[..., :cfg.ci.n_orb, :cfg.n_up, :]
    dn = (C[..., :cfg.ci.n_orb, cfg.n_up:, :] if cfg.n_dn > 0 else None)
    return up, dn


def _finish_state(cfg: WavefunctionConfig, params: WavefunctionParams,
                  C: torch.Tensor, r_elec: torch.Tensor,
                  count: torch.Tensor) -> PsiState:
    """Slater blocks -> drift/Laplacian ratios -> Jastrow -> local energy.

    C: (..., n_rows, n_e, 5); r_elec: (..., n_e, 3).  Leading walker axes
    batch every step (one batched slogdet/inverse over the ensemble; the
    reference vmaps the per-walker version).  With ``cfg.ci`` the Slater
    tail is the shared-inverse CI sum of ``core.multidet.ci_assemble``.
    """
    if cfg.ci is not None:
        from .multidet import ci_assemble
        up_all, dn_all = _ci_blocks(cfg, C)
        sign, logdet, sgrad, slap = ci_assemble(
            cfg.ci_t, up_all, dn_all, cfg.ns_steps, coeffs=params.ci_coeffs)
    else:
        up, dn = _slater_blocks(cfg, C)
        su, lu, gu, qu, _ = slater._spin_block(up, cfg.ns_steps)
        if cfg.n_dn > 0:
            sd, ld, gd, qd, _ = slater._spin_block(dn, cfg.ns_steps)
            sign, logdet = su * sd, lu + ld
            sgrad = torch.cat([gu, gd], dim=-2)
            slap = torch.cat([qu, qd], dim=-1)
        else:
            sign, logdet, sgrad, slap = su, lu, gu, qu

    jas = jastrow_state(params.jastrow, r_elec, params.coords,
                        params.charges, cfg.n_up)
    drift = sgrad + jas.grad
    # lap Psi / Psi = lapD/D + lapJ + |gradJ|^2 + 2 gradJ . gradD/D
    lap_psi_ratio = (slap + jas.lap
                     + torch.sum(jas.grad * jas.grad, dim=-1)
                     + 2.0 * torch.sum(jas.grad * sgrad, dim=-1))
    e_kin = -0.5 * torch.sum(lap_psi_ratio, dim=-1)
    e_pot = potential_energy(r_elec, params.coords, params.charges)
    return PsiState(sign=sign, log_psi=logdet + jas.value, drift=drift,
                    e_loc=e_kin + e_pot, e_kin=e_kin, e_pot=e_pot,
                    ao_count=count)


def psi_state(cfg: WavefunctionConfig, params: WavefunctionParams,
              r_elec: torch.Tensor) -> PsiState:
    """Full evaluation of one walker r_elec (n_e, 3): value, drift, local
    energy (``repro.core.wavefunction.psi_state``)."""
    C, count = _mo_tensor(cfg, params, r_elec)
    return _finish_state(cfg, params, C, r_elec, count)


def log_psi(cfg: WavefunctionConfig, params: WavefunctionParams,
            r_elec: torch.Tensor):
    """(sign, log|Psi|) of one walker r_elec (n_e, 3)."""
    C, _ = _mo_tensor(cfg, params, r_elec)
    jv = jastrow_value(params.jastrow, r_elec, params.coords,
                       params.charges, cfg.n_up)
    if cfg.ci is not None:
        from . import multidet
        ci = cfg.ci_t
        up_all, dn_all = _ci_blocks(cfg, C)
        up = multidet.spin_block_ci(up_all, ci.holes_up, ci.parts_up,
                                    cfg.ns_steps)
        if dn_all is not None:
            dn = multidet.spin_block_ci(dn_all, ci.holes_dn, ci.parts_dn,
                                        cfg.ns_steps)
            r_dn, sd, ld = dn.ratios, dn.sign, dn.logdet
        else:
            r_dn = torch.ones_like(up.ratios)
            sd, ld = torch.ones_like(up.sign), torch.zeros_like(up.logdet)
        coeffs = ci.coeffs if params.ci_coeffs is None else params.ci_coeffs
        S = multidet.ci_sum(coeffs, up.ratios, r_dn)
        sign_S, log_S = multidet.ci_log_sum(S)
        return up.sign * sd * sign_S, up.logdet + ld + log_S + jv
    up, dn = _slater_blocks(cfg, C)
    su, lu = torch.linalg.slogdet(up[..., 0])
    if cfg.n_dn > 0:
        sd, ld = torch.linalg.slogdet(dn[..., 0])
    else:
        sd, ld = torch.ones_like(su), torch.zeros_like(lu)
    return su * sd, lu + ld + jv


def local_energy_autodiff(cfg: WavefunctionConfig,
                          params: WavefunctionParams,
                          r_elec: torch.Tensor) -> torch.Tensor:
    """Autodiff oracle: E_L from the gradient and the Hessian's diagonal of
    log|Psi| at one walker r_elec (n_e, 3)
    (``repro.core.wavefunction.local_energy_autodiff``; tests only).

    Differentiates ``log_psi`` through autograd, so it runs where the MO
    product is plain torch: on the CPU, where the kernels' plain versions
    run.
    """
    def _f(x):
        return log_psi(cfg, params, x.reshape(r_elec.shape))[1]

    flat = r_elec.detach().reshape(-1)
    grad = torch.func.grad(_f)(flat)
    hdiag = torch.diagonal(torch.autograd.functional.hessian(_f, flat))
    e_kin = -0.5 * (torch.sum(hdiag) + torch.sum(grad * grad))
    return e_kin + potential_energy(r_elec, params.coords, params.charges)


# The working set of one ensemble evaluation, for sizing walker chunks.
# Peak device memory per byte of ``screening.memory_budget``'s total (the
# packed or dense AO block and the MO tensor): the AO pass's per-slot
# temporaries (the gathered exponents and coefficients, the monomial
# tables) come to several times the block it returns.  The b-strand at
# W = 256 measured 6.25 GB screened (eps 1e-8) against a 1.186 GB budget
# and 14.60 GB unscreened against 2.598 GB (5.27x and 5.62x; chip_smoke.py
# "[screened vs unscreened]" on an H100 80GB HBM3 at 700 W); the larger
# ratio is taken.
EVAL_PEAK_PER_BUDGET = 5.62
# (W, n_e, n_e) float tensors of the e-e Jastrow alive at its peak (the
# pair displacements and unit vectors, 3 each, and the products over them)
JASTROW_PAIR_FLOATS = 12
# Share of the card's memory one evaluation pass may take; the rest holds
# the run's state (inverses, P tables, proposals) and the allocator's slack
EVAL_MEMORY_SHARE = 0.5


# (W, n_e, n_e) and (W, n_e, n_at) float tensors alive at the peak of the
# O pass's autograd through ``jastrow_value``: the pass's distances
# (displacements 3, their squares 3, r^2), then the saved r, a r and 1 + b r
# with the gradient's own pair tensors in the backward pass
O_PAIR_FLOATS = 8


def _mo_pass_bytes_per_walker(cfg: WavefunctionConfig, n_rows: int) -> float:
    """``EVAL_PEAK_PER_BUDGET`` times ``screening.memory_budget`` (the
    screened total; unscreened the dense one) of one walker: the AO pass
    and the MO tensor of ``n_rows`` orbitals with what surrounds them."""
    n_e = cfg.n_elec
    if _screening_active(cfg):
        budget = screening.memory_budget(cfg.screening, cfg.basis, n_e,
                                         n_rows, 1)['screened_total']
    else:
        budget = (cfg.basis.n_ao + n_rows) * n_e * 5 * 4
    return EVAL_PEAK_PER_BUDGET * budget


def eval_bytes_per_walker(cfg: WavefunctionConfig, n_rows: int) -> float:
    """Predicted peak bytes of one walker's share of an ensemble
    evaluation: the MO pass (``_mo_pass_bytes_per_walker``) plus the e-e
    Jastrow's pair tensors."""
    return (_mo_pass_bytes_per_walker(cfg, n_rows)
            + JASTROW_PAIR_FLOATS * 4 * cfg.n_elec ** 2)


def o_bytes_per_walker(cfg: WavefunctionConfig, n_rows: int) -> float:
    """Predicted peak bytes of one walker's share of opt-vmc's O pass
    (``optimize.estimators.o_batched``): the larger of its two parts, which
    run one after the other: with CI the MO pass of the CI ratios
    (``_mo_pass_bytes_per_walker``, no grad), and the autograd through the
    Jastrow value, ``O_PAIR_FLOATS`` floats an e-e and an e-n pair."""
    n_e, n_at = cfg.n_elec, cfg.basis.atom_radius2.shape[0]
    jastrow = O_PAIR_FLOATS * 4.0 * n_e * (n_e + n_at)
    if cfg.ci is None:
        return jastrow
    return max(_mo_pass_bytes_per_walker(cfg, n_rows), jastrow)


def eval_budget_bytes(device) -> int | None:
    """Bytes one evaluation pass may take on ``device``:
    ``EVAL_MEMORY_SHARE`` of a card's memory; None (no limit) on the
    CPU."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return None
    return int(EVAL_MEMORY_SHARE
               * torch.cuda.get_device_properties(dev).total_memory)


def walker_chunks(cfg: WavefunctionConfig, params: WavefunctionParams,
                  n_walkers: int, per_walker=eval_bytes_per_walker) -> list:
    """The walker slices an ensemble pass evaluates one after the other:
    as few equal chunks as keep each within ``eval_budget_bytes`` at
    ``per_walker(cfg, n_rows)`` bytes a walker (an evaluation's by
    default; ``o_bytes_per_walker`` for the O pass); one slice when the
    batch fits (the pass is then the unchunked one).  Raises
    ``RuntimeError`` when not even one walker fits: the pass never drops
    walkers."""
    budget = eval_budget_bytes(params.coords.device)
    if budget is None or n_walkers <= 1:
        return [slice(0, n_walkers)]
    per = per_walker(cfg, params.mo.shape[0])
    cap = int(budget // per)
    if cap < 1:
        raise RuntimeError(
            f'one walker of {cfg.n_elec} electrons needs a predicted '
            f'{per / 1e9:.2f} GB for this pass; the pass may take '
            f'{budget / 1e9:.2f} GB on {params.coords.device}')
    n_chunks = -(-n_walkers // cap)
    size = -(-n_walkers // n_chunks)
    return [slice(i, min(i + size, n_walkers))
            for i in range(0, n_walkers, size)]


def _cat_walkers(parts: list):
    """Walker-major results of consecutive chunks joined along the walker
    axis: tensors, None, and tuples or NamedTuples of them, field by
    field."""
    first = parts[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        return torch.cat(parts, dim=0)
    fields = [_cat_walkers(list(xs)) for xs in zip(*parts)]
    return type(first)(*fields) if hasattr(first, '_fields') \
        else tuple(fields)


def over_walker_chunks(cfg: WavefunctionConfig, params: WavefunctionParams,
                       fn, *walker_args, per_walker=eval_bytes_per_walker):
    """``fn(*walker_args)`` on the ``walker_chunks`` of the walker axis in
    turn (sized by ``per_walker``), the results joined along it (one
    chunk: the call itself).  ``walker_args`` are walker-major tensors (or
    None); ``fn`` returns a walker-major tensor, None, or a tuple or
    NamedTuple of them."""
    chunks = walker_chunks(cfg, params, walker_args[0].shape[0], per_walker)
    if len(chunks) == 1:
        return fn(*walker_args)
    return _cat_walkers([fn(*(None if a is None else a[sl]
                              for a in walker_args)) for sl in chunks])


def psi_state_batched(cfg: WavefunctionConfig, params: WavefunctionParams,
                      R: torch.Tensor) -> PsiState:
    """Ensemble evaluation of a walker batch R: (W, n_e, 3).

    One AO pass and one MO product over the flattened W * n_e electrons,
    then one batched Slater/Jastrow/energy tail; every field grows a
    leading W axis.  Where the whole batch's working set exceeds the
    device's budget (``walker_chunks``), the same pass runs on equal
    walker chunks in turn.
    """
    def _pass(R):
        Cw, count = _mo_tensor_ensemble(cfg, params, R)
        return _finish_state(cfg, params, Cw, R, count)
    return over_walker_chunks(cfg, params, _pass, R)


def make_batched(cfg: WavefunctionConfig):
    """Walker-batch evaluator ``(params, R) -> PsiState`` for R: (W, n_e, 3)
    (``repro.core.wavefunction.make_batched``): the one flattened ensemble
    pass, ``psi_state_batched``.  The port has no one-walker-at-a-time
    batch path; ``psi_state`` evaluates a single walker."""
    return functools.partial(psi_state_batched, cfg)
