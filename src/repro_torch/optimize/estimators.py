"""Parameter vector <-> wavefunction mapping and the O_i derivative estimator.

Port of ``repro.optimize.estimators``.  The optimization works on one flat
vector

    p = [b_ee, b_en, a_en, c_0 .. c_{n_det-1}]      (CI tail only with cfg.ci)

so the solvers (``optimize.solvers``) are plain dense linear algebra.  The
vector lives on the walkers' device as fp32 (``traced_vector``); the host
copy is f64 (``opt_vector``).

O_i(R) = ∂ ln|Ψ(R)| / ∂ p_i comes from autograd.  The MO coefficients are
not optimized, so the MO tensor does not depend on the vector, and no
gradient ever reaches an MO-product kernel: ``o_batched`` forms the MO
tensor (for the CI ratios) under ``torch.no_grad`` and differentiates only
the Jastrow value and the CI sum.  Each walker gets its own copy of the
vector as an autograd leaf, so one backward pass of Σ_w ln|Ψ_w| gives
every walker's row of O at once (the reference vmaps a per-walker
``jax.grad``, which cannot trace a ctypes-bound CUDA kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import multidet
from repro_torch.core.jastrow import JastrowParams, jastrow_value
from repro_torch.core.wavefunction import (_ci_blocks, _mo_tensor_ensemble,
                                           log_psi, psi_state_batched)

N_JASTROW = 3           # b_ee, b_en, a_en
B_MIN = 1e-2            # Padé denominators stay strictly positive


def n_params(cfg) -> int:
    """Length of the flat optimization vector for this wavefunction."""
    return N_JASTROW + (int(cfg.ci.n_det) if cfg.ci is not None else 0)


def opt_vector(cfg, params) -> np.ndarray:
    """Current flat parameter vector (host-side f64)."""
    j = params.jastrow
    head = [float(j.b_ee), float(j.b_en), float(j.a_en)]
    if cfg.ci is not None:
        ci = (params.ci_coeffs if params.ci_coeffs is not None
              else cfg.ci.coeffs)
        head.extend(np.asarray(torch.as_tensor(ci).cpu(), np.float64)
                    .reshape(-1).tolist())
    return np.asarray(head, np.float64)


def traced_vector(cfg, params) -> torch.Tensor:
    """Flat parameter vector as an fp32 tensor on the parameters' device."""
    j = params.jastrow
    head = torch.stack([torch.as_tensor(x, dtype=torch.float32)
                        for x in (j.b_ee, j.b_en, j.a_en)])
    if cfg.ci is None:
        return head
    ci = (params.ci_coeffs if params.ci_coeffs is not None
          else cfg.ci_t.coeffs)
    return torch.cat([head, torch.as_tensor(ci, dtype=torch.float32,
                                            device=head.device).reshape(-1)])


def params_from_vector(cfg, params, vec):
    """Rebuild ``WavefunctionParams`` from the flat vector (a tensor keeps
    its autograd graph; anything else becomes fp32 on the parameters'
    device)."""
    vec = torch.as_tensor(vec, dtype=torch.float32,
                          device=params.coords.device)
    jas = JastrowParams(b_ee=vec[0], b_en=vec[1], a_en=vec[2])
    ci = vec[N_JASTROW:] if cfg.ci is not None else None
    return params._replace(jastrow=jas, ci_coeffs=ci)


def apply_vector(cfg, params, vec):
    """Host-side install of an updated vector -> new WavefunctionParams."""
    return params_from_vector(cfg, params, np.asarray(vec, np.float64))


def clip_vector(cfg, vec) -> np.ndarray:
    """Project an updated vector back into the valid parameter domain.

    The Padé denominators b_ee/b_en must stay positive (a non-positive b
    puts a pole of U(r) at physical r); the CI tail is renormalized to
    unit norm — |Ψ| is invariant up to a constant under CI scaling, so
    this only pins the gauge the solvers drift along.
    """
    out = np.array(vec, np.float64, copy=True)
    out[0] = max(out[0], B_MIN)
    out[1] = max(out[1], B_MIN)
    if cfg.ci is not None and out.shape[0] > N_JASTROW:
        tail = out[N_JASTROW:]
        norm = float(np.linalg.norm(tail))
        if norm > 0.0:
            out[N_JASTROW:] = tail / norm
    return out


def make_o_fn(cfg):
    """Build O(vec, params, r) -> (P,): one walker's ∂ ln|Ψ| / ∂ p, by
    autograd through ``log_psi`` (``repro.optimize.estimators.make_o_fn``).

    No run path uses it: the propagator forms O with ``o_batched``.  It is
    the independent one-walker oracle the tests hold ``o_batched`` against.
    Autograd runs through the MO product here, so it runs on the CPU,
    where the kernels' plain versions run."""
    def o_fn(vec, params, r_elec):
        v = torch.as_tensor(vec, dtype=torch.float32,
                            device=params.coords.device)
        v = v.detach().clone().requires_grad_()
        lp = log_psi(cfg, params_from_vector(cfg, params, v), r_elec)[1]
        return torch.autograd.grad(lp, v)[0]
    return o_fn


def _ci_ratios(cfg, params, R):
    """Every determinant's ratios to the reference, per spin, at R (no
    grad): one batched MO tensor -> (r_up, r_dn), each (W, n_det)."""
    ci = cfg.ci_t
    with torch.no_grad():
        Cw, _ = _mo_tensor_ensemble(cfg, params, R)
        up_all, dn_all = _ci_blocks(cfg, Cw)
        r_up = multidet.spin_block_ci(up_all, ci.holes_up, ci.parts_up,
                                      cfg.ns_steps).ratios
        if dn_all is None:
            return r_up, torch.ones_like(r_up)
        r_dn = multidet.spin_block_ci(dn_all, ci.holes_dn, ci.parts_dn,
                                      cfg.ns_steps).ratios
    return r_up, r_dn


def o_batched(cfg, params, R: torch.Tensor) -> torch.Tensor:
    """O for a walker batch R: (W, n_e, 3) -> (W, P), fp32 on R's device.

    Each walker differentiates its own leaf copy of the vector: the Jastrow
    value with ``JastrowParams`` shaped (W, 1, 1) (no MO tensor needed),
    and with CI the log of the CI sum over the vector's tail and the CI
    ratios at R (computed without grad).  The determinants' own log|det|
    does not depend on the vector and is left out.  One backward pass of
    Σ_w ln|Ψ_w| gives every row.
    """
    W = R.shape[0]
    vec = traced_vector(cfg, params).detach()
    vec_w = vec.expand(W, vec.shape[0]).clone().requires_grad_()
    with torch.enable_grad():
        b = vec_w[:, :N_JASTROW].reshape(W, N_JASTROW, 1, 1)
        jas = JastrowParams(b_ee=b[:, 0], b_en=b[:, 1], a_en=b[:, 2])
        lp = jastrow_value(jas, R, params.coords, params.charges, cfg.n_up)
        if cfg.ci is not None:
            r_up, r_dn = _ci_ratios(cfg, params, R)
            S = multidet.ci_sum(vec_w[:, N_JASTROW:], r_up, r_dn)
            lp = lp + multidet.ci_log_sum(S)[1]
        (O,) = torch.autograd.grad(lp.sum(), vec_w)
    return O


def reweighted_energy(cfg, params, vec, R) -> float:
    """Correlated-sampling variational energy of the vector ``vec``.

    R: (W, n_e, 3) fixed samples drawn from |Ψ(params)|²; the energy of
    the trial state at ``vec`` is the importance-sampled estimate

        E(vec) = Σ w E_L' / Σ w,   w = |Ψ'(R)/Ψ(R)|²

    over the *same* configurations — the noise common to E(vec) and
    E(vec') cancels, so a parameter step can be tested deterministically
    (given the sample) for an energy decrease.
    """
    R = torch.as_tensor(R, dtype=torch.float32, device=params.coords.device)
    p1 = params_from_vector(cfg, params, vec)
    lp0 = psi_state_batched(cfg, params, R).log_psi
    st1 = psi_state_batched(cfg, p1, R)
    logw = 2.0 * (st1.log_psi - lp0)
    logw = logw - torch.max(logw)
    w = torch.exp(logw)
    return float(torch.sum(w * st1.e_loc) / torch.sum(w))
