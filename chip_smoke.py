#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the ``smallest`` micro-peptide, 158 e-, 346 AOs,
   W = 256 walkers) and at edge cases;
   then hold the whole evaluation and one sem-vmc sweep on the card
   against the same path on the CPU, on 64 seeded cold-start walkers;
3. run ``vmc`` through ``repro_torch.launch.qmc_run`` on ``smallest``;
4. run ``sem-vmc`` the same way (past one ``sem_refresh`` boundary), and
   check the maintained inverses against a fresh inverse after 7 sweeps;
5. check the launch counters of the two runs: every kernel of the path ran;
6. profile one vmc step and one sem-vmc sweep (wall vs device-busy time);
7. time each kernel, its plain version and the library call at the main
   path's shapes, beside the bound computed from this run's inputs.

Prints one ``{"kernels": [...]}`` line and, last, one line naming the
device.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / 'src'

# H100 SXM data-sheet peaks (dense, no sparsity): fp32 on the CUDA cores
# and HBM3 bandwidth; the bound of a kernel is the larger of the two times
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

SYSTEM = 'smallest'
WALKERS = 256

# The fp32 contracts checked here (card-vs-CPU parity, DESIGN.md §3; the
# 1e-4 drift of maintained inverses, §6) presume that fp32 resolves the
# quantity on the input at all.  One rule, fixed before any run, decides
# which walkers they are asserted on: a walker is in scope when the fp32
# value computed by the plain path agrees with an fp64 evaluation of the
# same fp32 inputs to a tenth of the contract (relative to the walker's
# own max).  Walkers outside (near a node of a spin block, or with an
# electron outside every AO cutoff) are counted and their readings
# printed, not asserted.
FP32_SCOPE = 1e-5


def _fail(msg: str) -> None:
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def _dev_us(e) -> float:
    """Self device time (us) of one profiler row."""
    return float(e.self_device_time_total)


def _device_ms(prof) -> float:
    """Summed device time of every kernel and copy a profile recorded."""
    return sum(_dev_us(e) for e in prof.key_averages()) / 1e3


def _time_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, wall ms) per call.  Device time is the kernels' own
    execution time from the profiler (CUPTI); wall time is CUDA events
    around back-to-back calls, which a short kernel cannot fill: there it
    measures the host's launch rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    wall = t0.elapsed_time(t1) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _device_ms(prof) / iters, wall


def _bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_card_and_build():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        _fail(f'nvidia-smi: {out.stderr.strip()}')
    print(out.stdout.strip().splitlines()[0])
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f'[build] {len(logs)} kernels in {time.perf_counter() - t0:.1f} s')
    for name, (secs, log) in logs.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if 'registers' in ln or 'spill' in ln]
        print(f'[build] {name}: {secs:.1f} s; ' + ' | '.join(usage))


def _main_path_inputs(torch, dev):
    """The main path's sparse-MO inputs: smallest at W=256, cold-start
    walker positions drawn from a seeded generator."""
    from repro_torch.core import aos
    from repro_torch.core.vmc import sample_positions
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    R = sample_positions(params, gen, WALKERS, cfg.n_elec)
    N = R.shape[0] * R.shape[1]
    B, atom_active = aos.eval_ao_block(cfg.basis_t, params.coords,
                                       R.reshape(N, 3))
    ao_mask = atom_active[:, cfg.basis_t.ao_atom]
    return cfg, params, R, B, ao_mask


def phase_kernels_vs_plain(torch, dev, rec):
    from repro_torch.kernels.sem_update.kernel import sem_update_inplace
    from repro_torch.kernels.sem_update.ref import sem_update_ref
    from repro_torch.kernels.sparse_mo import kernel as smk
    from repro_torch.kernels.sparse_mo.ops import tile_block_ids
    from repro_torch.kernels.sparse_mo.ref import (mo_products_ref,
                                                   sparse_mo_matmul_ref)
    _, tile_k, tile_e = smk.TILES

    def _sparse_case(label, A, B, mask):
        n_ao, n_e = B.shape[0], B.shape[1]
        ids, num = tile_block_ids(mask, tile_e=tile_e, tile_k=tile_k,
                                  max_kb=-(-n_ao // tile_k))
        B2 = B.reshape(n_ao, n_e * 5).contiguous()
        C = smk.sparse_mo_matmul(A.contiguous(), B2, ids, num)
        C_plain = sparse_mo_matmul_ref(A, B2, ids, num, tile_k=tile_k,
                                       tile_e=tile_e)
        C_dense = mo_products_ref(A, B).reshape(A.shape[0], n_e * 5)
        torch.cuda.synchronize()
        scale = max(float(C_plain.abs().max()), 1e-30)
        err = float((C - C_plain).abs().max())
        err_dense = float((C - C_dense).abs().max())
        tol = 1e-5 * scale
        print(f'[check] sparse_mo {label}: max|C - plain| = {err:.3e}, '
              f'max|C - dense| = {err_dense:.3e}, tol 1e-5*max|C| = '
              f'{tol:.3e}; active k-tiles {int(num.sum())}/'
              f'{num.numel() * ids.shape[1]}')
        if not (err <= tol and err_dense <= tol and torch.isfinite(C).all()):
            _fail(f'sparse_mo {label} disagrees with its plain version')
        return err, (A, B2, ids, num)

    # main path shapes: real AO block of smallest at W=256
    cfg, params, R, B, ao_mask = _main_path_inputs(torch, dev)
    err, main_inputs = _sparse_case(f'{SYSTEM} W={WALKERS}', params.mo, B,
                                    ao_mask)
    rec['sparse_mo'] = dict(max_abs_err=err, inputs=main_inputs,
                            count=ao_mask.sum(dim=1))
    # ragged shape: nothing a multiple of a tile; plus an all-inactive
    # electron tile whose C columns must come back exactly zero
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    n_orb, n_ao, n_e = 37, 101, 5 * tile_e + 3
    A = torch.randn((n_orb, n_ao), generator=g, device=dev)
    mask = torch.rand((n_e, n_ao), generator=g, device=dev) < 0.2
    mask[tile_e:2 * tile_e] = False
    B = torch.randn((n_ao, n_e, 5), generator=g, device=dev)
    B = B * mask.T[:, :, None]
    _sparse_case('ragged 37x101x83', A, B, mask)
    C = smk.sparse_mo_matmul(A, B.reshape(n_ao, -1).contiguous(),
                             *tile_block_ids(mask, tile_e=tile_e,
                                             tile_k=tile_k,
                                             max_kb=-(-n_ao // tile_k)))
    dead = C[:, tile_e * 5:2 * tile_e * 5]
    if float(dead.abs().max()) != 0.0:
        _fail('sparse_mo: an all-inactive electron tile is not exactly 0')
    print('[check] sparse_mo all-inactive tile: exactly 0')

    # sem_update at (W=256, n=79): mixed accepts, NaN row on a rejected
    # walker; replaced row and rejected walkers bitwise, the rest rtol 1e-6
    W, n = WALKERS, cfg.n_up
    minv = torch.randn((W, n, n), generator=g, device=dev) * 10.0
    u = torch.randn((W, n), generator=g, device=dev)
    row = torch.randn((W, n), generator=g, device=dev)
    accept = torch.rand((W,), generator=g, device=dev) < 0.5
    accept[0], accept[1] = False, True
    row[0] = float('nan')
    worst = 0.0
    for j in (0, n - 1):
        out = sem_update_inplace(minv.clone(), u, row, accept, j)
        ref = sem_update_ref(minv, u, row, accept, j)
        torch.cuda.synchronize()
        rej = ~accept
        if not torch.equal(out[rej], minv[rej]):
            _fail(f'sem_update j={j}: a rejected walker changed')
        if not torch.equal(out[accept][:, j], row[accept]):
            _fail(f'sem_update j={j}: replaced row is not bitwise the row')
        diff = (out - ref).abs()[accept]
        rel = float(diff.max() / ref[accept].abs().max())
        worst = max(worst, float(diff.max()))
        print(f'[check] sem_update j={j}: rejected + replaced row bitwise; '
              f'max rel err {rel:.3e} (tol 1e-6)')
        if not rel <= 1e-6:
            _fail(f'sem_update j={j} disagrees with its plain version')
    rec['sem_update'] = dict(max_abs_err=worst,
                             inputs=(minv, u, row, accept))


def _fp64_twin(params):
    """The same parameters in float64 (for an fp64 tail on fp32 MOs)."""
    return params._replace(
        coords=params.coords.double(), charges=params.charges.double(),
        mo=params.mo.double(),
        jastrow=type(params.jastrow)(*(x.double() for x in params.jastrow)))


def _rel(x, ref):
    """Per-walker max |x - ref| over the walker's entries, relative to the
    walker's max |ref| (float64 on the CPU)."""
    x, ref = x.detach().cpu().double(), ref.detach().cpu().double()
    dims = tuple(range(1, ref.dim()))
    if not dims:
        return (x - ref).abs() / ref.abs()
    return (x - ref).abs().amax(dim=dims) / ref.abs().amax(dim=dims)


def _drift_parts(cfg, params, C, R):
    """Slater part of the drift, Jastrow part, and the two inverses."""
    import torch
    from repro_torch.core import slater
    from repro_torch.core.jastrow import jastrow_state
    from repro_torch.core.wavefunction import _slater_blocks
    up, dn = _slater_blocks(cfg, C)
    *_, gu, _, mu = slater._spin_block(up, cfg.ns_steps)
    *_, gd, _, md = slater._spin_block(dn, cfg.ns_steps)
    jas = jastrow_state(params.jastrow, R, params.coords, params.charges,
                        cfg.n_up)
    return torch.cat((gu, gd), dim=-2), jas.grad, (mu, md)


def _q(x):
    """'median / max' of a per-walker reading."""
    import torch
    x = x.double()
    return f'{float(torch.median(x)):.2e} / {float(x.max()):.2e}'


def phase_card_vs_cpu(torch, dev, n_cand: int = 64, margin: float = 1e-3):
    """The main path on the card against the same path on the CPU, on
    ``n_cand`` seeded cold-start walkers of ``smallest``.  The CPU path
    runs the kernels' plain versions, which the CPU tests hold against
    the JAX package.

    Every candidate goes through ``psi_state_batched`` on both sides and
    is held to the parity tolerances (log psi rtol 2e-6 + 1e-4; drift and
    E_L rtol 1e-4 + 1e-4 of the walker's own max); the check is asserted
    on the candidates in ``FP32_SCOPE`` (CPU fp32 drift against an fp64
    Slater/Jastrow tail on the same MO tensor) and reported for all.  The
    drift error against fp64 is split into its parts (MO tensor, inverse,
    Slater drift, Jastrow drift) on each side.  Then one sem-vmc sweep
    under the same draws on the in-scope walkers: identical accepts in each
    walker up to its first move whose margin is under ``margin`` on
    either side."""
    from repro_torch.core.sem import SEMState, SEMVMCPropagator, evaluate_sem
    from repro_torch.core.vmc import sample_positions
    from repro_torch.core.wavefunction import (_finish_state,
                                               _mo_tensor_ensemble,
                                               _slater_blocks,
                                               psi_state_batched)
    from repro_torch.systems import build_system
    cpu = torch.device('cpu')
    sides = {d: build_system(SYSTEM, device=d) for d in (cpu, dev)}
    cfg, params = sides[cpu]
    gen = torch.Generator().manual_seed(21)
    R = sample_positions(params, gen, n_cand, cfg.n_elec)
    st = {d: psi_state_batched(*sides[d], R.to(d)) for d in sides}
    a, b = st[dev], st[cpu]

    # fp64 tail on the CPU's fp32 MO tensor: the scope rule
    C, count = _mo_tensor_ensemble(cfg, params, R)
    p64 = _fp64_twin(params)
    exact = _finish_state(cfg, p64, C.double(), R.double(), count)
    cpu_err = _rel(b.drift, exact.drift)
    scope = cpu_err <= FP32_SCOPE

    # per-walker parity of every candidate
    over = torch.zeros(n_cand, dtype=torch.float64)
    for f, rtol in (('log_psi', 2e-6), ('drift', 1e-4), ('e_loc', 1e-4)):
        x, y = getattr(a, f).cpu().double(), getattr(b, f).double()
        dims = tuple(range(1, y.dim()))
        ymax = y.abs().amax(dim=dims) if dims else y.abs()
        atol = 1e-4 if f == 'log_psi' else 1e-4 * ymax
        r = (x - y).abs() - rtol * y.abs()
        r = (r.amax(dim=dims) if dims else r) / atol
        over = torch.maximum(over, torch.nan_to_num(r, nan=torch.inf))
    same = ((a.sign.cpu() == b.sign)
            & (a.ao_count.cpu() == b.ao_count).all(dim=1))
    fail = (over > 1.0) | ~same
    bad = []
    if bool((fail & scope).any()):
        bad.append(f'{int((fail & scope).sum())} in-scope walkers')
    n_in = int(scope.sum())
    print(f'[card vs cpu] {SYSTEM}, {n_cand} cold-start candidates: '
          f'{n_in} in scope (CPU fp32 drift within {FP32_SCOPE} of fp64; '
          f'out of scope: CPU fp32 drift vs fp64 median/max '
          f'{_q(cpu_err[~scope].nan_to_num(nan=torch.inf))}); parity '
          f'failures: {int((fail & scope).sum())} of {n_in} in scope, '
          f'{int((fail & ~scope).sum())} of {n_cand - n_in} out of scope '
          f'(worst |diff|/tol {float(over.max()):.3g}; in scope '
          f'{float(over[scope].max()):.3g})')

    # where the card's drift error comes from, on the in-scope walkers
    Cd, _ = _mo_tensor_ensemble(*sides[dev], R.to(dev))
    sg64, jg64, (mu64, md64) = _drift_parts(cfg, p64, C.double(),
                                            R.double())
    scale = exact.drift.abs().amax(dim=(1, 2))
    parts = {}
    for d, (c_d, p_d) in (('card', (Cd, sides[dev][1])),
                          ('cpu', (C, params))):
        sg, jg, (mu, md) = _drift_parts(cfg, p_d, c_d, R.to(c_d.device))
        parts[d] = dict(
            inv=torch.maximum(_rel(mu, mu64), _rel(md, md64)),
            slater=(sg.cpu().double() - sg64).abs().amax(dim=(1, 2)) / scale,
            jastrow=(jg.cpu().double() - jg64).abs().amax(dim=(1, 2))
            / scale)
    # the card's MO tensor through an fp64 tail: what C alone moves
    sgC, _, _ = _drift_parts(cfg, p64, Cd.cpu().double(), R.double())
    c_only = (sgC - sg64).abs().amax(dim=(1, 2)) / scale
    c_rel = _rel(Cd.cpu(), C)
    vs64 = {'card': _rel(a.drift, exact.drift), 'cpu': cpu_err}
    print('[card vs cpu] drift error vs fp64 on the in-scope walkers '
          '(median / max, relative to each walker\'s max |drift|): total '
          + ', '.join(f'{d} {_q(vs64[d][scope])}' for d in vs64)
          + '; Slater part ' + ', '.join(
              f'{d} {_q(parts[d]["slater"][scope])}' for d in parts)
          + '; Jastrow part ' + ', '.join(
              f'{d} {_q(parts[d]["jastrow"][scope])}' for d in parts)
          + '; inverse vs fp64 ' + ', '.join(
              f'{d} {_q(parts[d]["inv"][scope])}' for d in parts)
          + f'; MO tensor card vs cpu {_q(c_rel[scope])}, its effect on '
          f'the Slater drift through an fp64 tail {_q(c_only[scope])}')

    keep = scope.nonzero().flatten()
    Rk = R[keep]
    draws = (torch.randn(Rk.shape, generator=gen),
             torch.rand(Rk.shape[:2], generator=gen))
    acc, mar = {}, {}
    for d, (c, p) in sides.items():
        prop = SEMVMCPropagator(c)
        state = SEMState(ens=evaluate_sem(c, p, Rk.to(d)), sweeps=0)
        *_, acc[d], mar[d] = prop.sweep(p, state, None,
                                        tuple(x.to(d) for x in draws))
    same = acc[dev].cpu() == acc[cpu]
    near = torch.minimum(mar[dev].abs().cpu(), mar[cpu].abs()) < margin
    # a walker's trajectories may part after its first near-tie
    stop = torch.cumsum(near.to(torch.int32), dim=0) > 0
    compared = int((~stop).sum())
    if not bool(same[~stop].all()):
        bad.append('sem-vmc accept decisions')
    if n_in == 0 or compared < same.numel() // 2:
        bad.append('fewer than half the sem-vmc moves compared')
    print(f'[card vs cpu] sem-vmc sweep on the {n_in} in-scope walkers: '
          f'accepts identical over {compared}/{same.numel()} moves '
          f'(walkers stop at a margin < {margin})')
    if bad:
        _fail(f'card vs CPU disagree: {", ".join(bad)}')


def _cold_start_seed(torch, dev, first: int = 3, tries: int = 8) -> int:
    """The first run seed from ``first`` whose cold start (worker 0, drawn
    as ``qmc_run`` draws it) has every walker finite.

    Neither package redraws a cold-start walker; one with an electron
    outside every atom's AO cutoff has a zero Slater column, log psi =
    -inf and a NaN energy, never moves, and makes every block average
    NaN, which the result store rejects (ROADMAP Queue C).  The skipped
    seeds and their dead walkers are printed."""
    from repro_torch.core.vmc import VMCPropagator
    from repro_torch.runtime.samplers import worker_seed
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    prop = VMCPropagator(cfg)
    for seed in range(first, first + tries):
        gen = torch.Generator(device=dev)
        gen.manual_seed(worker_seed(seed, 0))
        ens = prop.init(params, gen, WALKERS)
        dead = ~(torch.isfinite(ens.log_psi) & torch.isfinite(ens.e_loc))
        n_dead = int(dead.sum())
        print(f'[cold start] seed {seed}: {n_dead} of {WALKERS} walkers '
              f'not finite')
        if n_dead == 0:
            return seed
    _fail(f'no seed in {first}..{first + tries - 1} gives a finite cold '
          f'start')


def _counters():
    from repro_torch.kernels.sem_update import kernel as suk
    from repro_torch.kernels.sparse_mo import kernel as smk
    return {'sparse_mo': smk.COUNTER, 'sem_update': suk.COUNTER}


def _run_cli(method: str, steps: int, blocks: int, needs, seed: int,
             extra=()):
    from repro_torch.launch import qmc_run
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    avg = qmc_run.main(['--system', SYSTEM, '--method', method,
                        '--walkers', str(WALKERS), '--workers', '1',
                        '--steps', str(steps), '--blocks', str(blocks),
                        '--backend', 'thread', '--seed', str(seed),
                        '--wall-clock', '300', *extra])
    launches = {k: c.n for k, c in counters.items()}
    secs = time.perf_counter() - t0
    print(f'[{method}] {avg} in {secs:.1f} s; launches {launches}')
    if not (avg.n_blocks >= blocks and math.isfinite(avg.energy)):
        _fail(f'{method}: no finite energy from {avg.n_blocks} blocks')
    for k in needs:
        if launches[k] <= 0:
            _fail(f'{method}: kernel {k} was never launched on the path')
    return launches


def phase_sem_drift(torch, dev):
    """Maintained inverses after 7 sweeps (< sem_refresh = 8) against a
    fresh slogdet/inverse of the same configuration (DESIGN.md §6).

    Asserted per walker (max |dM| relative to the walker's max |M|,
    logdet relative, sign equal) on the walkers in ``FP32_SCOPE``: those
    whose fresh fp32 inverse agrees with an fp64 inverse of the same fp32
    matrices.  Printed for every walker: the reference's own metric (max
    |dM| over the ensemble relative to its max |M|, ``tests/test_sem.py``)
    and the readings of the walkers out of scope."""
    from repro_torch.core.driver import EnsembleDriver
    from repro_torch.core.sem import SEMVMCPropagator, evaluate_sem
    from repro_torch.core.wavefunction import (_mo_tensor_ensemble,
                                               _slater_blocks)
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    prop = SEMVMCPropagator(cfg, step_size=0.3)
    drv = EnsembleDriver(prop, steps=7)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    st = drv.init(params, gen, WALKERS)
    st, stats = drv.run_block(params, st, gen)
    if st.sweeps != 7:
        _fail(f'expected 7 sweeps since refresh, got {st.sweeps}')
    fresh = evaluate_sem(cfg, params, st.ens.r)
    Cw, _ = _mo_tensor_ensemble(cfg, params, st.ens.r)
    blocks = dict(zip(('minv_up', 'minv_dn'), _slater_blocks(cfg, Cw)))
    scope = torch.ones(WALKERS, dtype=torch.bool)
    err = {}
    for f, blk in blocks.items():
        a = getattr(st.ens, f).double()
        b = getattr(fresh, f).double()
        exact = torch.linalg.inv(blk[..., 0].double())
        scope &= (_rel(b, exact) <= FP32_SCOPE)
        err[f] = _rel(a, b)
        glob = float((a - b).abs().max() / b.abs().max().clamp(min=1.0))
        print(f'[sem drift] {f} after 7 sweeps, all {WALKERS} walkers: '
              f'max|dM|/max|M| vs fresh fp32 = {glob:.3e} (the reference\'s '
              f'metric; bound 1e-4); per walker vs fresh median/max '
              f'{_q(err[f].nan_to_num(nan=torch.inf))}; per walker vs fp64 '
              f'median/max {_q(_rel(a, exact).nan_to_num(nan=torch.inf))} '
              f'(fresh fp32 vs fp64 '
              f'{_q(_rel(b, exact).nan_to_num(nan=torch.inf))})')
    dl = _rel(st.ens.logdet, fresh.logdet)
    worst = torch.maximum(err['minv_up'], err['minv_dn'])
    sign_ok = (st.ens.sign == fresh.sign).cpu()
    n_in = int(scope.sum())
    out = ~scope
    print(f'[sem drift] {n_in} of {WALKERS} walkers in scope (fresh fp32 '
          f'inverse within {FP32_SCOPE} of fp64); in scope: max per-walker '
          f'|dM|/max|M| {float(worst[scope].max()):.3e}, logdet rel '
          f'{float(dl[scope].max()):.3e}, signs equal '
          f'{bool(sign_ok[scope].all())}; out of scope ({int(out.sum())}): '
          f'|dM|/max|M| '
          f'{[f"{x:.2e}" for x in worst[out].tolist()]}, logdet rel '
          f'{[f"{x:.2e}" for x in dl[out].tolist()]}, signs equal '
          f'{int(sign_ok[out].sum())}; accept {stats.aux["accept"]:.3f}')
    if n_in < WALKERS // 2:
        _fail(f'only {n_in} of {WALKERS} walkers in scope')
    if not (float(worst[scope].max()) <= 1e-4
            and float(dl[scope].max()) <= 1e-4
            and bool(sign_ok[scope].all())):
        _fail('maintained inverses drifted past the 1e-4 bound on walkers '
              'in scope')


def phase_layers(torch, dev):
    """Wall time, device-busy time and the heaviest kernels of one vmc
    step and one sem-vmc sweep at the main path's shapes."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.driver import Population
    from repro_torch.core.sem import SEMVMCPropagator
    from repro_torch.core.vmc import VMCPropagator
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    pop = Population()
    for label, prop in (('vmc step', VMCPropagator(cfg, tau=0.01)),
                        ('sem-vmc sweep', SEMVMCPropagator(cfg))):
        st = prop.init(params, gen, WALKERS)
        st, _ = prop.propagate(params, st, gen, pop)       # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st, _ = prop.propagate(params, st, gen, pop)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = _device_ms(prof)
        rows = sorted(prof.key_averages(), key=lambda e: -_dev_us(e))
        top = ', '.join(f'{e.key[:40]} {_dev_us(e) / 1e3:.3f} ms '
                        f'x{e.count}' for e in rows[:5])
        print(f'[layer] {label} at W={WALKERS}: wall {wall:.2f} ms, device '
              f'busy {busy:.2f} ms (idle {100 * (1 - busy / wall):.1f} %); '
              f'top: {top}')


def phase_timing(torch, dev, rec, launches):
    from repro_torch.kernels.sem_update.kernel import sem_update_inplace
    from repro_torch.kernels.sem_update.ref import sem_update_ref
    from repro_torch.kernels.sparse_mo import kernel as smk
    from repro_torch.kernels.sparse_mo.ref import sparse_mo_matmul_ref
    _, tile_k, tile_e = smk.TILES
    rows = []

    A, B2, ids, num = rec['sparse_mo']['inputs']
    n_orb, n_ao = A.shape
    n_cols = B2.shape[1]
    N = n_cols // 5
    ms, ms_wall = _time_ms(lambda: smk.sparse_mo_matmul(A, B2, ids, num))
    plain, _ = _time_ms(lambda: sparse_mo_matmul_ref(A, B2, ids, num,
                                                     tile_k=tile_k,
                                                     tile_e=tile_e))
    lib, _ = _time_ms(lambda: torch.matmul(A, B2))
    # what this data needs: each electron's active AOs only
    nnz = float(rec['sparse_mo']['count'].sum())
    flops = 2.0 * n_orb * 5.0 * nnz
    nbytes = 4.0 * (n_orb * n_ao + 5.0 * nnz + n_orb * n_cols)
    bound, by = _bound_ms(nbytes, flops)
    dense_gflop = 2.0 * n_orb * n_ao * n_cols / 1e9
    print(f'[time] sparse_mo (device): {ms:.4f} ms kernel (wall '
          f'{ms_wall:.4f}), {plain:.4f} ms plain, {lib:.4f} ms torch.matmul '
          f'dense; bound {bound:.4f} ms ({by}: '
          f'{flops / 1e9:.3f} GFLOP, {nbytes / 1e9:.4f} GB; dense would be '
          f'{dense_gflop:.3f} GFLOP); mean active AOs/electron '
          f'{nnz / N:.1f} of {n_ao}; active k-tiles '
          f'{int(num.sum())}/{num.numel() * ids.shape[1]}')
    rows.append(dict(
        name='sparse_mo', route='cuda',
        source='src/repro_torch/csrc/sparse_mo.cu',
        replaces='src/repro/kernels/sparse_mo/kernel.py:53',
        launches=launches['sparse_mo'],
        max_abs_err=rec['sparse_mo']['max_abs_err'], ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=lib))

    # the layout copy the kernel path keeps: (N, n_ao, 5) -> (n_ao, N, 5)
    cfg_rows = B2.reshape(n_ao, N, 5).transpose(0, 1).contiguous()
    t_tr, _ = _time_ms(lambda: cfg_rows.transpose(0, 1).contiguous())
    print(f'[time] B2d transpose (N, n_ao, 5) -> (n_ao, N, 5): {t_tr:.4f} '
          f'ms for {cfg_rows.numel() * 4 / 1e6:.1f} MB')
    del cfg_rows

    minv, u, row, accept = rec['sem_update']['inputs']
    W, n, _ = minv.shape
    j = n // 2
    buf = minv.clone()
    ms, ms_wall = _time_ms(lambda: sem_update_inplace(buf, u, row, accept,
                                                      j), iters=200)
    plain, _ = _time_ms(lambda: sem_update_ref(minv, u, row, accept, j),
                        iters=200)
    bmm, _ = _time_ms(lambda: torch.baddbmm(minv, u[:, :, None],
                                            row[:, None, :], alpha=-1.0),
                      iters=200)
    n_acc = float(accept.sum())
    nbytes = 4.0 * (2.0 * n_acc * n * n + 2.0 * W * n) + W
    flops = 2.0 * n_acc * n * n
    bound, by = _bound_ms(nbytes, flops)
    print(f'[time] sem_update (device): {ms:.4f} ms kernel (wall '
          f'{ms_wall:.4f}), {plain:.4f} ms plain, {bmm:.4f} ms torch.baddbmm of the rank-1 part (all walkers; no '
          f'single library call does the whole update); bound {bound:.4f} '
          f'ms ({by}: {nbytes / 1e6:.3f} MB for {int(n_acc)}/{W} accepted)')
    rows.append(dict(
        name='sem_update', route='cuda',
        source='src/repro_torch/csrc/sem_update.cu',
        replaces='src/repro/kernels/sem_update/kernel.py:50',
        launches=launches['sem_update'],
        max_abs_err=rec['sem_update']['max_abs_err'], ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=None))
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the GPU',
              file=sys.stderr)
        return 2
    if not (SRC / 'repro_torch').is_dir():
        print(f'chip_smoke: {SRC / "repro_torch"} not found; run from a '
              'checkout of the repository', file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    dev = resolve_device('cuda')
    t_start = time.perf_counter()

    phase_card_and_build()
    rec = {}
    phase_kernels_vs_plain(torch, dev, rec)
    phase_card_vs_cpu(torch, dev)
    # all-electron moves of 158 electrons: tau 0.3 (the method default)
    # accepts nothing at a cold start; 0.01 lets the walkers move
    seed = _cold_start_seed(torch, dev)
    vmc = _run_cli('vmc', steps=3, blocks=2, needs=('sparse_mo',), seed=seed,
                   extra=('--tau', '0.01'))
    sem = _run_cli('sem-vmc', steps=5, blocks=2,
                   needs=('sparse_mo', 'sem_update'), seed=seed)
    phase_sem_drift(torch, dev)
    launches = {'sparse_mo': vmc['sparse_mo'] + sem['sparse_mo'],
                'sem_update': sem['sem_update']}
    print(f'[launches] main path: vmc {vmc}, sem-vmc {sem}')
    phase_layers(torch, dev)
    rows = phase_timing(torch, dev, rec, launches)
    print(f'[done] {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
