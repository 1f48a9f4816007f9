"""Single-electron-move VMC: Sherman–Morrison-updated Slater inverses.

Port of ``repro.core.sem``.  One ``propagate``
call is one sweep: every electron gets one Metropolis trial, batched over
the walker ensemble.  The determinant ratio of a move is one dot product
against the maintained inverse; an accepted move is a rank-1 update of the
(W, n, n) inverses.  Two sweep paths:

* per move (``sem-vmc``): per electron, the AO values at the proposed
  points and an O(n_e) Jastrow delta, then the rest of the move (ratio,
  decision, update) in one ``kernels.sem_update.ops.sem_move`` call — one
  CUDA kernel launch on the card, the plain version on the CPU;
* fused (``fused-vmc``, ``cfg.method`` 'fused' or 'fused-kernel'): all
  proposals, their MO values and the e-n Jastrow deltas in one batched pass
  (each electron is trialed once, at its sweep-start position), then the
  sequential accept/update algebra of each spin block in one call — the
  CUDA kernel of ``kernels.fused_sweep`` for 'fused-kernel'.

Multideterminant wavefunctions (``cfg.ci``) ride both: the ensemble also
keeps the shared ratio tables P = V @ Minv and every determinant's ratio;
a move's CI factor comes from the rank-1-updated table (the plain version
``kernels.multidet_ratio.ref``; on the card inside the ``sem_move`` and
``fused_sweep`` kernels, at any excitation rank the expansion has) and
an accepted move applies P <- P - g ⊗ row next to the
inverse update (DESIGN.md §8).

With distance screening (``cfg.screening``) the proposals' orbital values
come from each point's candidate AOs only (``core.screening``): the packed
AO values, then the doubly screened gather (``gather_phi``) when the
structure carries MO reach radii, else one scatter and GEMM
(``phi_from_packed``); the post-sweep energy pass runs the screened
evaluation of ``core.wavefunction``.

After the sweep one full MO tensor pass assembles the local energy through
the maintained inverses, with a Newton–Schulz corrector every sweep and a
full ``slogdet``/inverse refresh every ``cfg.sem_refresh`` sweeps
(DESIGN.md §6) — a host ``if`` on the sweep counter, in place of the
reference's ``lax.cond``.  Both paths draw their random numbers with
``draw_sweep`` (or take them injected), so for the same generator state
they consume the same ``eta``/``u``.  The sweep clones its state once, so
``propagate`` never modifies the state it is given although the kernels
update in place.

Mixed precision (``cfg.precision``, the reference's storage policy): with
'bf16' or 'fp16' the ensemble's (W, n, n) inverses and CI P-tables REST in
the low dtype, quantized once a sweep where ``_energy_ensemble`` builds the
ensemble (``_to_storage``); the sweep reads them back through
``_to_compute``, so every move, the corrector, the refresh and the energy
run in fp32, and both sweep kernels see fp32 buffers at every precision.
At 'fp32' both casts return the tensor itself.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import aos, multidet, screening, slater
from .driver import (BlockStats as DriverStats, Population, register_method,
                     restart_ensemble)
from .hamiltonian import potential_energy
from .jastrow import jastrow_delta_one_electron, jastrow_state
from .vmc import evaluate_ensemble, sample_positions
from .wavefunction import (SWEEP_METHODS, WavefunctionConfig,
                           WavefunctionParams, _ci_blocks,
                           _mo_tensor_ensemble, _screening_active,
                           _slater_blocks, over_walker_chunks)


class SEMEnsemble(NamedTuple):
    """Walker-major single-electron-move state.  With ``cfg.ci`` it also
    carries the shared tables and every determinant's ratio (zero-size
    tensors for a single determinant)."""

    r: torch.Tensor          # (W, n_e, 3)
    minv_up: torch.Tensor    # (W, n_up, n_up) running inverse (elec, orb)
    minv_dn: torch.Tensor    # (W, n_dn, n_dn)
    sign: torch.Tensor       # (W,) running sign of Det_up * Det_dn (ref det)
    logdet: torch.Tensor     # (W,) running sum of log|det| over spins (ref)
    log_psi: torch.Tensor    # (W,) logdet [+ log|CI sum|] + J
    e_loc: torch.Tensor      # (W,)
    p_up: torch.Tensor       # (W, n_orb, n_up) shared table (ci; else (W,0,0))
    p_dn: torch.Tensor       # (W, n_orb, n_dn)
    rdet_up: torch.Tensor    # (W, n_det) per-det ratios to the reference
    rdet_dn: torch.Tensor    # (W, n_det)


class SEMState(NamedTuple):
    """Driver state: walker ensemble + host sweep counter."""

    ens: SEMEnsemble
    sweeps: int              # sweeps since the last full refresh


def _mo_blocks(cfg: WavefunctionConfig, params: WavefunctionParams):
    """Per-spin MO coefficient panels (rows of the shared 'A' matrix); with
    ``cfg.ci`` both spins get the full orbital set (the move's CI factor
    needs the virtual orbitals too)."""
    if cfg.ci is not None:
        A_full = params.mo[:cfg.ci.n_orb]
        return A_full, A_full
    return params.mo[:cfg.n_up], params.mo[:cfg.n_dn]


def _ci_lists(cfg, spin: str, kernel: bool):
    """(holes, parts) of one spin: for the CUDA kernels the int32 lists
    sentinel-padded to rank max(k, 2), else the int64 lists."""
    ci = cfg.ci_t
    if kernel:
        return getattr(ci, f'holes_{spin}_k'), getattr(ci, f'parts_{spin}_k')
    return getattr(ci, f'holes_{spin}'), getattr(ci, f'parts_{spin}')


# the ensemble fields the storage policy quantizes
_STORED = ('minv_up', 'minv_dn', 'p_up', 'p_dn')
# fp16 resting state is stored with this exact power-of-two exponent
# shift (the reference's): inverse entries exceed float16's 65504 on the
# bench systems, so the raw cast would overflow to inf.  A power-of-two
# scale only moves the exponent — no mantissa error in either cast
# direction — and extends the representable range to ~1e6 (equilibrated
# `smallest` walkers hold up to ~2e3; its cold starts up to ~1e11, which
# still store inf).  bf16 carries the full fp32 exponent range and needs
# no shift.
_FP16_SCALE = 16.0


def _to_compute(x: torch.Tensor, cfg) -> torch.Tensor:
    """Storage -> fp32 compute dtype at the sweep/use boundary
    (``repro.core.sem._to_compute``).  At ``precision='fp32'`` this
    returns ``x`` itself: the policy inserts no cast and no copy."""
    if cfg.precision == 'fp32':
        return x
    x32 = x.to(torch.float32)
    return x32 * _FP16_SCALE if cfg.precision == 'fp16' else x32


def _to_storage(x: torch.Tensor, cfg) -> torch.Tensor:
    """fp32 compute -> storage dtype (``x`` itself at fp32)."""
    if cfg.precision == 'fp32':
        return x
    if cfg.precision == 'fp16':
        return (x * (1.0 / _FP16_SCALE)).to(torch.float16)
    return x.to(slater.storage_dtype(cfg.precision))


def _empty_ci_state(W, dtype, device):
    """Zero-size CI fields of the single-determinant ensemble."""
    return (torch.zeros((W, 0, 0), dtype=dtype, device=device),
            torch.zeros((W, 0, 0), dtype=dtype, device=device),
            torch.zeros((W, 0), dtype=dtype, device=device),
            torch.zeros((W, 0), dtype=dtype, device=device))


def _energy_ensemble(cfg: WavefunctionConfig, params: WavefunctionParams,
                     R, Cw, minv_up, minv_dn, sign, logdet) -> SEMEnsemble:
    """Assemble the SEM ensemble from maintained inverses (no inversion;
    ``repro.core.sem._energy_ensemble``).  With ``cfg.ci`` the tables and
    all determinant ratios are rebuilt from the same inverses and the
    drift/Laplacian become the CI-weighted contractions."""
    if cfg.ci is not None:
        ci = cfg.ci_t
        up_all, dn_all = _ci_blocks(cfg, Cw)
        p_up = multidet.reference_table(up_all[..., 0], minv_up)
        rdet_up = multidet.det_ratios(p_up, ci.holes_up, ci.parts_up)
        if cfg.n_dn > 0:
            p_dn = multidet.reference_table(dn_all[..., 0], minv_dn)
            rdet_dn = multidet.det_ratios(p_dn, ci.holes_dn, ci.parts_dn)
        else:
            p_dn = p_up.new_zeros(minv_dn.shape[:-2] + (0, 0))
            rdet_dn = torch.ones_like(rdet_up)
        w, S = multidet.ci_weights(ci.coeffs, rdet_up, rdet_dn)
        cu = multidet.ci_corrections(ci.holes_up, ci.parts_up, up_all,
                                     minv_up, p_up, w)
        gu, qu = slater.ratios_from_inverse(up_all[..., :cfg.n_up, :, :],
                                            minv_up)
        gu, qu = gu + cu[..., :3], qu + cu[..., 3]
        if cfg.n_dn > 0:
            cd = multidet.ci_corrections(ci.holes_dn, ci.parts_dn, dn_all,
                                         minv_dn, p_dn, w)
            gd, qd = slater.ratios_from_inverse(
                dn_all[..., :cfg.n_dn, :, :], minv_dn)
            gd, qd = gd + cd[..., :3], qd + cd[..., 3]
            sgrad = torch.cat([gu, gd], dim=1)
            slap = torch.cat([qu, qd], dim=1)
        else:
            sgrad, slap = gu, qu
        _, log_ci = multidet.ci_log_sum(S)
    else:
        up, dn = _slater_blocks(cfg, Cw)
        gu, qu = slater.ratios_from_inverse(up, minv_up)
        if cfg.n_dn > 0:
            gd, qd = slater.ratios_from_inverse(dn, minv_dn)
            sgrad = torch.cat([gu, gd], dim=1)
            slap = torch.cat([qu, qd], dim=1)
        else:
            sgrad, slap = gu, qu
        p_up, p_dn, rdet_up, rdet_dn = _empty_ci_state(
            R.shape[0], minv_up.dtype, minv_up.device)
        log_ci = torch.zeros_like(logdet)
    jas = jastrow_state(params.jastrow, R, params.coords, params.charges,
                        cfg.n_up)
    lap_ratio = (slap + jas.lap + torch.sum(jas.grad * jas.grad, dim=-1)
                 + 2.0 * torch.sum(jas.grad * sgrad, dim=-1))
    e_kin = -0.5 * torch.sum(lap_ratio, dim=-1)
    e_pot = potential_energy(R, params.coords, params.charges)
    # storage boundary: the (W, n, n) inverses and P-tables rest in the
    # precision policy's dtype; everything above computed in fp32
    return SEMEnsemble(r=R, minv_up=_to_storage(minv_up, cfg),
                       minv_dn=_to_storage(minv_dn, cfg), sign=sign,
                       logdet=logdet, log_psi=logdet + log_ci + jas.value,
                       e_loc=e_kin + e_pot, p_up=_to_storage(p_up, cfg),
                       p_dn=_to_storage(p_dn, cfg), rdet_up=rdet_up,
                       rdet_dn=rdet_dn)


def _fresh_inverses(cfg: WavefunctionConfig, up, dn):
    """Batched ``slogdet`` + inverse (+ Newton–Schulz) of both spin blocks
    -> (minv_up, minv_dn, sign, logdet)."""
    su, lu, _, _, mu = slater._spin_block_batched(up, cfg.ns_steps)
    if cfg.n_dn == 0:
        return mu, up.new_zeros((up.shape[0], 0, 0)), su, lu
    sd, ld, _, _, md = slater._spin_block_batched(dn, cfg.ns_steps)
    return mu, md, su * sd, lu + ld


def evaluate_sem(cfg: WavefunctionConfig, params: WavefunctionParams,
                 R: torch.Tensor) -> SEMEnsemble:
    """Full recompute of the SEM state for a walker batch R: (W, n_e, 3):
    fresh inverses of both spin blocks, then the shared energy assembly;
    on walker chunks in turn where the batch exceeds the device's budget
    (``wavefunction.over_walker_chunks``)."""
    def _pass(R):
        Cw, _ = _mo_tensor_ensemble(cfg, params, R)
        up, dn = _slater_blocks(cfg, Cw)
        return _energy_ensemble(cfg, params, R, Cw,
                                *_fresh_inverses(cfg, up, dn))
    return over_walker_chunks(cfg, params, _pass, R)


def _energy_pass(cfg, params, r, minv_up, minv_dn, sign, logdet,
                 refresh: bool) -> SEMEnsemble:
    """The post-sweep pass of a walker batch: one full MO tensor pass (the
    energy needs it, and its D blocks feed the corrector or the refresh
    that bound fp32 drift), then the energy assembly."""
    Cw, _ = _mo_tensor_ensemble(cfg, params, r)
    up, dn = _slater_blocks(cfg, Cw)
    if refresh:
        minv_up, minv_dn, sign, logdet = _fresh_inverses(cfg, up, dn)
    else:
        minv_up = slater.refine_inverse(up[..., 0], minv_up)
        if cfg.n_dn > 0:
            minv_dn = slater.refine_inverse(dn[..., 0], minv_dn)
    return _energy_ensemble(cfg, params, r, Cw, minv_up, minv_dn, sign,
                            logdet)


def draw_sweep(gen: torch.Generator, r: torch.Tensor):
    """One sweep's draws: eta (W, n_e, 3) proposal normals and u (W, n_e)
    uniforms; electron j's move reads eta[:, j] and u[:, j]."""
    eta = torch.randn(r.shape, generator=gen, dtype=r.dtype, device=r.device)
    u = torch.rand(r.shape[:2], generator=gen, dtype=r.dtype,
                   device=r.device)
    return eta, u


def _packed_phi(cfg, A_blk, a_idx, vals, mo_lists):
    """Orbital values from packed AO values: the doubly screened gather
    when the structure carries MO reach radii (``mo_lists`` given), else
    one scatter and GEMM."""
    if mo_lists is not None:
        return screening.gather_phi(A_blk, a_idx, vals, *mo_lists)
    return screening.phi_from_packed(A_blk, a_idx, vals, cfg.basis_t.n_ao)


def _proposal_phi(cfg, coords, A_blk, pts):
    """Orbital values of the panel ``A_blk`` at points pts (N, 3) -> (N,
    rows) (the per-move phi of ``repro.core.sem._sweep_spin_block``):
    screened, only each point's candidate AOs are evaluated; else all AOs
    and one GEMM."""
    if not _screening_active(cfg):
        vals, _ = aos.eval_ao_values(cfg.basis_t, coords, pts)   # (ao, N)
        return (A_blk @ vals).T
    scr_t = cfg.screening_t
    a_idx, a_act, _ = screening.active_ao_lists(scr_t, pts)
    vals = aos.eval_ao_values_screened(cfg.basis_t, coords, pts, a_idx,
                                       a_act)                   # (N, K)
    mo_lists = (screening.active_mo_lists(scr_t, pts)
                if scr_t.mo_cells is not None else None)
    return _packed_phi(cfg, A_blk, a_idx, vals, mo_lists)


def _sweep_spin_block(cfg, params, A_blk, offset, n_blk, draws, step_size,
                      carry, ci_args=None):
    """One Metropolis trial per electron of one spin block, all walkers
    (``repro.core.sem._sweep_spin_block``).

    ``carry`` is ``(r, minv, sign, logdet)``, the sweep's own buffers (on
    the card updated in place); ``minv`` is the running inverse of THIS
    spin block; electrons ``offset .. offset+n_blk-1`` go in order, so a
    later electron sees the earlier accepted moves of the same sweep.  With
    ``ci_args = (spin, r_other)`` the carry is ``(r, minv, sign, logdet, P,
    rdet)`` and ``A_blk`` the full orbital panel.  Per move the proposal's
    orbital values and Jastrow delta, then one ``sem_move`` call: the CUDA
    kernel on the card, its plain version on the CPU.  Returns the updated
    carry, the (n_blk, W) accept decisions and their (n_blk, W) margins
    ``2 (log|ratio| + log_ci + dJ) - log u`` (accept iff > 0), on the
    device.
    """
    from repro_torch.kernels.sem_update.ops import sem_move
    coords, charges = params.coords, params.charges
    eta_all, u_all = draws
    W, dev = carry[0].shape[0], carry[0].device
    ci_ops = None
    if ci_args is not None:
        spin, r_other = ci_args
        holes, parts = _ci_lists(cfg, spin, dev.type == 'cuda')
        ci_ops = (r_other, holes, parts, cfg.ci_t.coeffs)
        state = tuple(carry)
    else:
        state = (*carry, None, None)
    # log u of the block's moves, taken once
    logu = torch.log(torch.clamp(u_all[:, offset:offset + n_blk], min=1e-38))
    acc = torch.empty((n_blk, W), dtype=torch.bool, device=dev)
    margins = torch.empty((n_blk, W), dtype=carry[0].dtype, device=dev)
    for e in range(n_blk):
        j = offset + e
        r = state[0]
        r_new = r[:, j] + step_size * eta_all[:, j]
        v_all = _proposal_phi(cfg, coords, A_blk, r_new)  # (W, n_occ|n_orb)
        d_jas = jastrow_delta_one_electron(params.jastrow, r, j, r_new,
                                           coords, charges, cfg.n_up)
        state = sem_move(state, v_all, r_new, d_jas, logu[:, e], e, j, acc,
                         margins, ci_ops)
    return (state if ci_args is not None else state[:4]), acc, margins


def _fused_phi_all(cfg, params, A_up, A_dn, r_prop):
    """Proposal MO values of BOTH spin blocks from one shared AO pass
    (``repro.core.sem._fused_phi_all``): the AO values of all W * n_e
    proposals in one batch, then the panel product — one GEMM when one
    panel serves both blocks (closed shell, or CI).  Screened, the shared
    pass is the candidate lists and packed values of all proposals, then
    the per-spin ``gather_phi`` / ``phi_from_packed``.

    r_prop: (W, n_e, 3).  Returns (phi_up (W, n_up, cols), phi_dn
    (W, n_dn, cols) or None when n_dn == 0).  On walker chunks where the
    batch exceeds the device's budget (``over_walker_chunks``).
    """
    return over_walker_chunks(
        cfg, params,
        lambda r: _fused_phi_chunk(cfg, params, A_up, A_dn, r), r_prop)


def _fused_phi_chunk(cfg, params, A_up, A_dn, r_prop):
    """``_fused_phi_all`` of one walker chunk."""
    W, n_e = r_prop.shape[:2]
    n_up, n_dn = cfg.n_up, cfg.n_dn
    pts = r_prop.reshape(W * n_e, 3)
    if _screening_active(cfg):
        scr_t = cfg.screening_t
        a_idx, a_act, _ = screening.active_ao_lists(scr_t, pts)
        vals = aos.eval_ao_values_screened(cfg.basis_t, params.coords, pts,
                                           a_idx, a_act)
        per_point = [a_idx, vals]
        if scr_t.mo_cells is not None:
            per_point += list(screening.active_mo_lists(scr_t, pts))

        def _block(A_blk, sl, n_blk):
            ai, v, *mo = (x.reshape(W, n_e, -1)[:, sl].reshape(W * n_blk, -1)
                          for x in per_point)
            return _packed_phi(cfg, A_blk, ai, v,
                               mo or None).reshape(W, n_blk, -1)
        phi_up = _block(A_up, slice(0, n_up), n_up)
        phi_dn = (_block(A_dn, slice(n_up, n_e), n_dn) if n_dn > 0
                  else None)
        return phi_up, phi_dn
    vals, _ = aos.eval_ao_values(cfg.basis_t, params.coords, pts)  # (ao, N)
    if n_dn == 0:
        return (A_up @ vals).T.reshape(W, n_up, -1), None
    if A_up.shape == A_dn.shape:
        # one panel serves both blocks (both are leading rows of params.mo)
        phi = (A_up @ vals).T.reshape(W, n_e, -1)
        return phi[:, :n_up], phi[:, n_up:]
    chi = vals.T.reshape(W, n_e, -1)
    phi_up = torch.einsum('wea,oa->weo', chi[:, :n_up], A_up)
    phi_dn = torch.einsum('wea,oa->weo', chi[:, n_up:], A_dn)
    return phi_up, phi_dn


def _en_sum(params, pts):
    """Electron-nucleus Padé Jastrow sum per point (W, n, 3) -> (W, n)."""
    jas = params.jastrow
    d = pts[..., None, :] - params.coords
    rn = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-20)
    a = -params.charges * jas.a_en
    return torch.sum(a * rn / (1.0 + jas.b_en * rn), dim=-1)


def _fused_sweeps(cfg, params, ens, draws, step_size):
    """Both spin blocks' sweeps through the fused path
    (``repro.core.sem._fused_sweeps``).

    All proposals, their MO values (``_fused_phi_all``) and the e-n
    Jastrow deltas are computed in one batched pass; the sequential
    accept/update algebra runs as one ``fused_sweep_block`` call per spin
    block — the CUDA kernel for cfg.method == 'fused-kernel' on the card,
    its launch parameter from the measured tuner.  With CI the up block reads
    the down block's ratios and the down block the UPDATED up ratios.

    Returns (r, minv_up, minv_dn, sign, logdet, accept (n_e, W), margin
    (n_e, W)).
    """
    from repro_torch.kernels.fused_sweep.ops import fused_sweep_block
    W, n_e = ens.r.shape[:2]
    n_up, n_dn = cfg.n_up, cfg.n_dn
    A_up, A_dn = _mo_blocks(cfg, params)
    eta, u = draws
    r_prop = ens.r + step_size * eta
    logu = torch.log(torch.clamp(u, min=1e-38))
    en_delta = _en_sum(params, r_prop) - _en_sum(params, ens.r)

    kernel = cfg.method == 'fused-kernel' and ens.r.device.type == 'cuda'
    launch = {}
    if kernel:
        from repro_torch.kernels.fused_sweep.autotune import best_launch
        # keyed 'fp32' at every precision: the kernel is given the fp32
        # compute copy of the state (``_to_compute``), so its timing does
        # not depend on the storage policy (the reference keys its tuner by
        # cfg.precision because its kernel reads the stored dtype)
        launch = best_launch(n_e, W, 'fp32', ci=None if cfg.ci is None else (
            cfg.ci.n_orb, cfg.ci.n_det, cfg.ci_t.holes_up_k.shape[-1]))
    ci = cfg.ci_t

    def _ci_ops(spin, P, rdet, r_other):
        if ci is None:
            return None
        holes, parts = _ci_lists(cfg, spin, kernel)
        return (P, rdet, r_other, holes, parts, ci.coeffs)

    phi_up, phi_dn = _fused_phi_all(cfg, params, A_up, A_dn, r_prop)
    # the sweep's own buffers: the kernel updates them in place
    r, sign, logdet = ens.r.clone(), ens.sign.clone(), ens.logdet.clone()
    p_up, rdet_up = ens.p_up.clone(), ens.rdet_up.clone()
    r, minv_up, sign, logdet, _, rdet_up, acc, mar = fused_sweep_block(
        ens.minv_up.clone(), phi_up, r, r_prop[:, :n_up], en_delta[:, :n_up],
        logu[:, :n_up], sign, logdet, params.jastrow.b_ee,
        _ci_ops('up', p_up, rdet_up, ens.rdet_dn), offset=0, n_up=n_up,
        use_kernel=kernel, **launch)
    minv_dn = ens.minv_dn
    if n_dn > 0:
        r, minv_dn, sign, logdet, _, _, acc_dn, mar_dn = fused_sweep_block(
            ens.minv_dn.clone(), phi_dn, r, r_prop[:, n_up:],
            en_delta[:, n_up:], logu[:, n_up:], sign, logdet,
            params.jastrow.b_ee,
            _ci_ops('dn', ens.p_dn.clone(), ens.rdet_dn.clone(), rdet_up),
            offset=n_up, n_up=n_up, use_kernel=kernel, **launch)
        acc, mar = torch.cat([acc, acc_dn], 1), torch.cat([mar, mar_dn], 1)
    return r, minv_up, minv_dn, sign, logdet, acc.T, mar.T


def _own(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of a state field: the per-move sweep's own buffer."""
    return torch.clone(x, memory_format=torch.contiguous_format)


class SEMVMCPropagator:
    """Metropolis sampling of |Psi_T|^2 by single-electron sweeps (§II.A).

    Same |Psi_T|^2 target as ``VMCPropagator`` (statistics agree in
    distribution, not move for move), at O(n^2) per electron move.
    """

    aux_fields = ('accept', 'ao_fill', 'e_kin', 'e_pot')

    def __init__(self, cfg: WavefunctionConfig, step_size: float = 0.3,
                 spread: float = 1.5):
        """``step_size`` is the isotropic Gaussian proposal width (bohr)."""
        self.cfg = cfg
        self.step_size = float(step_size)
        self.spread = float(spread)

    def init(self, params, gen, n_walkers: int, walkers=None):
        """Cold start (sampled positions) or reservoir restart."""
        if walkers is not None:
            ens = restart_ensemble(
                walkers, n_walkers,
                lambda r: evaluate_sem(self.cfg, params, r),
                params.coords.device)
        else:
            r = sample_positions(params, gen, n_walkers, self.cfg.n_elec,
                                 self.spread)
            ens = evaluate_sem(self.cfg, params, r)
        return SEMState(ens=ens, sweeps=0)

    def draw(self, gen, state: SEMState):
        """One sweep's draws for the whole population: (eta, u)."""
        return draw_sweep(gen, state.ens.r)

    def sweep(self, params, state: SEMState, gen, draws=None):
        """The electron moves of one sweep, no energy pass.

        Returns (r, minv_up, minv_dn, sign, logdet, accept (n_e, W),
        margin (n_e, W)) — see ``_sweep_spin_block``."""
        cfg = self.cfg
        # compute boundary: the stored (possibly quantized) inverses and
        # P-tables in fp32; at precision='fp32' the stored tensors themselves
        ens = state.ens._replace(**{f: _to_compute(getattr(state.ens, f), cfg)
                                    for f in _STORED})
        if draws is None:
            draws = self.draw(gen, state)
        if cfg.method in SWEEP_METHODS:
            return _fused_sweeps(cfg, params, ens, draws, self.step_size)
        A_up, A_dn = _mo_blocks(cfg, params)
        ci = cfg.ci is not None
        # the sweep's own buffers: the kernel updates them in place
        carry = tuple(_own(x) for x in (ens.r, ens.minv_up, ens.sign,
                                        ens.logdet))
        if ci:
            carry += (_own(ens.p_up), _own(ens.rdet_up))
        out, acc, mar = _sweep_spin_block(
            cfg, params, A_up, 0, cfg.n_up, draws, self.step_size, carry,
            ci_args=('up', ens.rdet_dn) if ci else None)
        r, minv_up, sign, logdet = out[:4]
        minv_dn = ens.minv_dn
        if cfg.n_dn > 0:
            carry = (r, _own(ens.minv_dn), sign, logdet)
            if ci:
                carry += (_own(ens.p_dn), _own(ens.rdet_dn))
            out, acc_dn, mar_dn = _sweep_spin_block(
                cfg, params, A_dn, cfg.n_up, cfg.n_dn, draws,
                self.step_size, carry,
                ci_args=('dn', out[5]) if ci else None)
            r, minv_dn, sign, logdet = out[:4]
            acc, mar = torch.cat([acc, acc_dn]), torch.cat([mar, mar_dn])
        return r, minv_up, minv_dn, sign, logdet, acc, mar

    def propagate(self, params, state: SEMState, gen, pop: Population,
                  draws=None):
        """One sweep: n_e single-electron trials + energy + drift control.

        ``draws = (eta (W, n_e, 3), u (W, n_e))`` injects the sweep's
        random numbers (else drawn from ``gen``)."""
        cfg = self.cfg
        r, minv_up, minv_dn, sign, logdet, accept, _ = self.sweep(
            params, state, gen, draws)
        sweeps = state.sweeps + 1
        refresh = sweeps % cfg.sem_refresh == 0
        ens_new = over_walker_chunks(
            cfg, params, lambda *a: _energy_pass(cfg, params, *a, refresh),
            r, minv_up, minv_dn, sign, logdet)
        out = (pop.mean(ens_new.e_loc), pop.mean(ens_new.e_loc ** 2),
               pop.mean(accept))
        return SEMState(ens=ens_new, sweeps=sweeps % cfg.sem_refresh), out

    def block_stats(self, params, state: SEMState, outs,
                    pop: Population) -> DriverStats:
        """Reduce per-sweep outputs; sparsity/energy split from the final
        configuration (same convention as the all-electron VMC)."""
        e, e2, acc = outs
        ens = state.ens
        _, st = evaluate_ensemble(self.cfg, params, ens.r)
        w = float(e.shape[0] * pop.size(ens.r))
        return DriverStats(
            weight=w, e_mean=torch.mean(e), e2_mean=torch.mean(e2),
            aux=dict(accept=torch.mean(acc),
                     ao_fill=pop.mean(st.ao_count.to(torch.float32)),
                     e_kin=pop.mean(st.e_kin), e_pot=pop.mean(st.e_pot)))


# for sem-vmc the step size is a per-electron Gaussian proposal width,
# not a drift-diffusion time step
register_method('sem-vmc',
                lambda cfg, tau, e_trial, equil_steps:
                SEMVMCPropagator(cfg, step_size=tau),
                default_tau=0.3)


def _fused_cfg(cfg: WavefunctionConfig) -> WavefunctionConfig:
    """Route the sweep through the fused path (``repro.core.sem._fused_cfg``):
    'kernel' becomes 'fused-kernel' (one CUDA kernel call per spin block),
    anything else 'fused' (the plain loop).  The pre-rewrite method is kept
    in ``mo_method``, so the post-sweep energy pass keeps its MO product
    (``wavefunction._mo_product_method``)."""
    if cfg.method in SWEEP_METHODS:
        return cfg
    method = 'fused-kernel' if cfg.method == 'kernel' else 'fused'
    return dataclasses.replace(cfg, method=method,
                               mo_method=cfg.mo_method or cfg.method)


register_method('fused-vmc',
                lambda cfg, tau, e_trial, equil_steps:
                SEMVMCPropagator(_fused_cfg(cfg), step_size=tau),
                default_tau=0.3)
