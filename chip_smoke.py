#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the ``smallest`` micro-peptide, 158 e-, 346 AOs,
   W = 256 walkers; n_det = 100 for the CI kernels; the screened product
   on the ``b-strand``, 434 e-, 952 AOs, W = 256, at eps = 1e-8) and at
   edge cases (the fused sweep on its rows route and on the first
   design's shared route at n = 79, at n = 217 on the rows route at one
   and two threads a row and on the shared and global routes, at n = 866
   on the global route, on a well-conditioned synthetic CI sweep of both
   spin blocks,
   also at excitation ranks 3 and 5, and on a b-strand cold start; both
   MO products in tiles of electrons sorted by nearest atom, and on ragged
   shapes in a random order, electrons with no active AO and NaN in
   inactive entries; the screened product also at the 1amb's widths; the
   two MO products bitwise equal on the same active sets; the per-move
   kernel ``sem_move`` driving whole spin-block sweeps move by move on the
   main path's inputs, single determinant and n_det = 100, all-accept and
   all-reject, on synthetic blocks at n = 217, 256 and 866, CI ranks 2, 3
   and 8, every compiled variant with and without CI, and a move whose
   rejected walkers hold a NaN row and a zero ratio); then hold the
   whole evaluation and one sem-vmc
   sweep on the card against the same path on the CPU, on 64 seeded
   cold-start walkers, and the screened evaluation of the b-strand at
   eps = 0 against the unscreened one;
3. run ``vmc``, ``sem-vmc`` and ``fused-vmc`` through
   ``repro_torch.launch.qmc_run`` on ``smallest``, and ``sem-vmc`` and
   ``fused-vmc`` with ``--n-det 100``, each past one ``sem_refresh``
   boundary where it sweeps; then the three methods on ``b-strand
   --screen-eps 1e-8`` (resumed from a reservoir of finite cold-start
   walkers: every b-strand cold start has dead walkers); each run checks
   its launch counters: every kernel of its path ran (``sem_move`` on
   every sem-vmc run), the first designs ``sem_update`` and
   ``multidet_ratio`` on none (and, screened, ``sparse_mo`` did not);
4. one fused-vmc sweep against one sem-vmc sweep under the same draws
   (single determinant and n_det = 100), and the maintained inverses of
   both methods against a fresh inverse after 7 sweeps;
5. profile one vmc step, one sem-vmc sweep, one sem-vmc --n-det 100
   sweep and one fused-vmc sweep (wall vs device-busy time, launches a
   move) on ``smallest``, both sem-vmc sweeps also with each move made as
   PR 15 made it, and a screened vmc step and fused-vmc sweep and an
   unscreened vmc step on ``b-strand``, in the same run;
6. time each kernel, its plain version and the library call at the main
   path's shapes, beside the bound computed from this run's inputs; for
   the two MO products the ``ops`` call (the electron sort included) and
   the kernel alone, with the AO rows a tile needs (mean, p90, max); for
   the fused sweep also the CI variant and the b-strand's block, each
   beside the first design (shared route) in the same run, in SM cycles a
   move at the card's max clock too; for ``sem_move`` one move at n = 79,
   with CI (n_det = 100) and on the b-strand (n = 217).

Prints one ``{"kernels": [...]}`` line and, last, one line naming the
device.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import statistics
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
# the screened slice: the paper's beta-strand at its AO tolerance
BSTRAND = 'b-strand'
SCREEN_EPS = 1e-8

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


def _time_ms(fn, iters: int = 20, warmup: int = 3, minus=None):
    """(device ms, host ms) per call.

    Device time: CUDA events around ``iters`` back-to-back calls, queued
    behind a device-side wait (``torch.cuda._sleep``) longer than the host
    needs to issue them, so that the events bracket the device's work and
    not the host's launch rate, short kernels included.  (The profiler's
    per-kernel sums dropped launches late in this script's process: 3 of
    10 recorded for a 5 ms GEMM, where a fresh process recorded all ten.)
    ``minus``: a part of ``fn`` (a state copy) whose device time is
    subtracted.  Host time: the host clock around the same calls and a
    synchronise, i.e. what a caller that waits for each result sees."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * (1.5 * host + 2.0)))   # ~2e6 cycles per ms
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    dev = e0.elapsed_time(e1) / iters
    if minus is not None:
        dev -= _time_ms(minus, iters, warmup)[0]
    return dev, host / iters


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
    import torch
    # the fp32 contract (TF32 off): a 1024-deep fp32 product against fp64
    # is ~1e-6 relative in IEEE fp32, ~1e-3 in TF32
    g = torch.Generator(device='cuda')
    g.manual_seed(3)
    a = torch.randn((256, 1024), generator=g, device='cuda')
    b = torch.randn((1024, 2048), generator=g, device='cuda')
    c = a @ b
    c64 = a.double() @ b.double()
    rel = float((c.double() - c64).abs().max() / c64.abs().max())
    print(f'[numerics] python {sys.version.split()[0]}, torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}; matmul '
          f'allow_tf32={torch.backends.cuda.matmul.allow_tf32}, precision '
          f'{torch.get_float32_matmul_precision()!r}; fp32 matmul vs fp64: '
          f'max rel err {rel:.2e} (TF32 would give ~1e-3)')
    if not rel <= 1e-5:
        _fail(f'fp32 matmul is not IEEE fp32 (rel err {rel:.2e})')
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
    walker positions drawn from a seeded generator; the AO pass's rows
    (N, n_ao, 5), the (N, n_ao) mask and the nearest-atom tile key, as
    ``wavefunction._mo_tensor_ensemble`` makes them."""
    from repro_torch.core import aos
    from repro_torch.core.vmc import sample_positions
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    R = sample_positions(params, gen, WALKERS, cfg.n_elec)
    N = R.shape[0] * R.shape[1]
    B, atom_active, key = aos.eval_ao_rows(cfg.basis_t, params.coords,
                                           R.reshape(N, 3))
    ao_mask = atom_active[:, cfg.basis_t.ao_atom]
    return cfg, params, R, B, ao_mask, key


def phase_kernels_vs_plain(torch, dev, rec):
    from repro_torch.kernels import mo_tile
    from repro_torch.kernels.screened_mo import kernel as sck
    from repro_torch.kernels.sem_update.kernel import sem_update_inplace
    from repro_torch.kernels.sem_update.ref import sem_update_ref
    from repro_torch.kernels.sparse_mo import kernel as smk
    from repro_torch.kernels.sparse_mo.ref import (mo_products_ref,
                                                   sparse_mo_rows_ref)

    def _sparse_case(label, A, B, mask, order, poison=None):
        """The kernel on the AO rows B (N, n_ao, 5) in tile order ``order``
        against its plain version and the dense oracle, 1e-5 of max |C|;
        ``poison`` fills the inactive entries the kernel gets."""
        Bk = B if poison is None else torch.where(
            mask[..., None], B, torch.full_like(B, poison))
        C = smk.sparse_mo_rows(mo_tile.transposed(A), Bk, mask, order,
                               A.shape[0])
        C_plain = sparse_mo_rows_ref(A, B, mask, order)
        C_dense = mo_products_ref(A, B.transpose(0, 1))
        torch.cuda.synchronize()
        scale = max(float(C_plain.abs().max()), 1e-30)
        err = float((C - C_plain).abs().max())
        err_dense = float((C - C_dense).abs().max())
        tol = 1e-5 * scale
        empty = mask.sum(dim=1) == 0
        zero = bool((C[:, empty] == 0).all())
        print(f'[check] sparse_mo {label}: max|C - plain| = {err:.3e}, '
              f'max|C - dense| = {err_dense:.3e}, tol 1e-5*max|C| = '
              f'{tol:.3e}; {int(empty.sum())} electrons with no active AO, '
              f'exactly 0: {zero}')
        if not (err <= tol and err_dense <= tol and zero
                and torch.isfinite(C).all()):
            _fail(f'sparse_mo {label} disagrees with its plain version')
        return err, C

    # main path shapes: real AO rows of smallest at W=256, nearest-atom
    # order; then the screened kernel on the same active sets (K = n_ao
    # slots, idx = 0..n_ao-1): the two kernels bitwise equal
    cfg, params, R, B, ao_mask, key = _main_path_inputs(torch, dev)
    A = params.mo
    order = mo_tile.electron_order(key, B.shape[0])
    err, C = _sparse_case(f'{SYSTEM} W={WALKERS}', A, B, ao_mask, order)
    rec['sparse_mo'] = dict(max_abs_err=err, inputs=(A, B, ao_mask, key),
                            count=ao_mask.sum(dim=1))
    n_ao = A.shape[1]
    ids = torch.arange(n_ao, dtype=torch.int32, device=dev).expand(
        B.shape[0], n_ao).contiguous()
    C_s = sck.screened_mo_matmul(mo_tile.transposed(A), B, ids, ao_mask,
                                 order, A.shape[0])
    same = torch.equal(C_s, C)
    print(f'[check] sparse_mo and screened_mo on the same active sets '
          f'({SYSTEM} W={WALKERS}): bitwise equal {same}')
    if not same:
        _fail('sparse_mo and screened_mo differ on the same active sets')
    # ragged shape (nothing a multiple of a tile), a random order, electrons
    # with no active AO (exactly 0), NaN in every inactive entry
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    n_orb, n_ao, n_e = 37, 101, 5 * mo_tile.TE + 3
    A2 = torch.randn((n_orb, n_ao), generator=g, device=dev)
    mask = torch.rand((n_e, n_ao), generator=g, device=dev) < 0.2
    mask[::9] = False
    B2 = torch.randn((n_e, n_ao, 5), generator=g, device=dev)
    B2 = B2 * mask[..., None]
    perm = torch.randperm(n_e, generator=g, device=dev).to(torch.int32)
    _sparse_case(f'ragged 37x101, N={n_e}, random order', A2, B2, mask, perm,
                 poison=float('nan'))

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


def _per_electron_err(torch, C, C_ref):
    """(max over electrons of |C - C_ref| / max |C_ref| of the electron,
    max |C - C_ref|, electrons whose reference column is zero and whose
    column is not exactly zero).  C: (n_orb, N, 5)."""
    scale = C_ref.abs().amax(dim=(0, 2))
    err = (C - C_ref).abs().amax(dim=(0, 2))
    zero = scale == 0
    rel = torch.where(zero, torch.zeros_like(err), err / scale.clamp(
        min=1e-30))
    nonzero_dead = int((zero & (C.abs().amax(dim=(0, 2)) != 0)).sum())
    return float(rel.max()), float(err.max()), nonzero_dead


def _screened_inputs(torch, dev, R, eps):
    """The b-strand's screened (cfg, params) at ``eps`` and the packed
    inputs of its MO product at positions R (W, n_e, 3): (A, Bp, idx,
    active, count, key), as ``wavefunction._mo_tensor_screened`` makes
    them."""
    from repro_torch.core import aos, screening
    from repro_torch.systems import build_system
    cfg, params = build_system(BSTRAND, screen_eps=eps, device=dev)
    r = R.reshape(-1, 3)
    idx, active, count, key = screening.active_ao_lists_keyed(
        cfg.screening_t, r)
    Bp = aos.eval_ao_block_screened(cfg.basis_t, params.coords, r, idx,
                                    active)
    return cfg, params, (params.mo, Bp, idx, active, count, key)


def phase_screened_mo_vs_plain(torch, dev, rec, R):
    """The screened-product kernel against its plain version on the card:
    the b-strand at W = 256 from a cold start (R) at eps = 1e-8 in the
    nearest-atom tile order, and edge cases: ragged N and K in a random
    order, an electron with no active slot (its column exactly zero), NaN
    in inactive slots (must not leak), the 1amb's widths (n_ao = 3804,
    K = 1392, n_orb = 866: lists and unions of several windows).  Held
    per electron to 1e-5 of that electron's max |C| (the kernel and the
    chunked plain version sum in different orders)."""
    from repro_torch.kernels import mo_tile
    from repro_torch.kernels.screened_mo import kernel as sck
    from repro_torch.kernels.screened_mo.ops import screened_mo_products
    from repro_torch.kernels.screened_mo.ref import screened_mo_ref
    bad = []

    def _case(label, A, Bp, idx, active, poison=None, key=None):
        Bk = Bp if poison is None else torch.where(
            active[..., None], Bp, torch.full_like(Bp, poison))
        C = screened_mo_products(A, Bk, idx, active, key)
        C_plain = screened_mo_ref(A, Bp, idx, active)
        torch.cuda.synchronize()
        rel, err, dead = _per_electron_err(torch, C, C_plain)
        n_empty = int((active.sum(dim=1) == 0).sum())
        print(f'[check] screened_mo {label}: per-electron max |C - plain| '
              f'/ max |C| of the electron {rel:.3e} (tol 1e-5), max abs '
              f'{err:.3e}; {n_empty} electrons with no active slot, '
              f'{dead} of them not exactly 0')
        if not (rel <= 1e-5 and dead == 0 and bool(torch.isfinite(C).all())):
            bad.append(label)
        return err

    cfg, params, (A, Bp, idx, active, count, key) = _screened_inputs(
        torch, dev, R, SCREEN_EPS)
    N, K = idx.shape
    plan = sck.plan(A.shape[0], A.shape[1], K)
    print(f'[screened_mo] {BSTRAND} eps={SCREEN_EPS:g} W={WALKERS}: N={N} '
          f'electrons, K={K} candidates (budget), {int(count.sum())} '
          f'active pairs ({float(count.float().mean()):.1f} per electron, '
          f'max {int(count.max())}); tiles of {mo_tile.TE} electrons, plan '
          f'{plan}')
    err = _case(f'{BSTRAND} W={WALKERS} eps={SCREEN_EPS:g}', A, Bp, idx,
                active, key=key)
    rec['screened_mo'] = dict(max_abs_err=err,
                              inputs=(R, A, Bp, idx, active, count, key),
                              basis=cfg.basis, coords=params.coords)
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    n_orb, n_ao, n_e, k = 37, 101, 5 * mo_tile.TE + 3, 13
    A2 = torch.randn((n_orb, n_ao), generator=g, device=dev)
    idx2 = torch.sort(torch.randint(0, n_ao, (n_e, k), generator=g,
                                    device=dev), dim=1).values.to(torch.int32)
    act2 = torch.rand((n_e, k), generator=g, device=dev) < 0.6
    act2[3] = False
    Bp2 = torch.randn((n_e, k, 5), generator=g, device=dev)
    _case(f'ragged {n_orb}x{n_ao}, N={n_e}, K={k}, electron 3 empty, random '
          f'order', A2, Bp2, idx2, act2,
          key=torch.randint(0, 7, (n_e,), generator=g, device=dev))
    _case(f'{BSTRAND} with NaN in every inactive slot', A, Bp, idx, active,
          poison=float('nan'), key=key)
    # the 1amb's widths: 300 electrons over 3804 AOs with K = 1392 slots,
    # five of them with every slot active (lists of several windows)
    n_orb, n_ao, n_e, k = 866, 3804, 300, 1392
    A3 = torch.randn((n_orb, n_ao), generator=g, device=dev)
    idx3 = torch.sort(torch.topk(torch.rand((n_e, n_ao), generator=g,
                                            device=dev), k, dim=1).indices,
                      dim=1).values.to(torch.int32)
    act3 = torch.rand((n_e, k), generator=g, device=dev) < 0.07
    act3[:5] = True
    act3[5] = False
    Bp3 = torch.randn((n_e, k, 5), generator=g, device=dev)
    _case(f'wide {n_orb}x{n_ao}, N={n_e}, K={k}, plan '
          f'{sck.plan(n_orb, n_ao, k)}', A3, Bp3, idx3, act3,
          poison=float('nan'),
          key=torch.randint(0, 40, (n_e,), generator=g, device=dev))
    if bad:
        _fail('screened_mo disagrees with its plain version: '
              + '; '.join(bad))


def phase_screened_vs_unscreened(torch, dev, R):
    """The b-strand at W = 256 and eps = 0, one ``psi_state_batched``
    evaluation through ``sparse_mo`` (unscreened) and through
    ``screened_mo`` (screened): eps = 0 drops only the dense path's exact
    zeros, so they differ by summation order alone.  The MO tensors are
    held per electron to 1e-5 of the electron's max on every walker; the
    evaluation to the card-vs-CPU parity tolerances on the walkers in
    ``FP32_SCOPE`` (the unscreened fp32 drift within 1e-5 of an fp64
    Slater/Jastrow tail on the same MO tensor).  Prints both evaluations'
    device times and peak memory and ``memory_budget``'s bytes."""
    from repro_torch.core.screening import memory_budget
    from repro_torch.core.wavefunction import (_finish_state,
                                               _mo_tensor_ensemble,
                                               psi_state_batched)
    from repro_torch.systems import build_system
    sides = {'unscreened': build_system(BSTRAND, device=dev),
             'screened': build_system(BSTRAND, screen_eps=0.0, device=dev)}
    counters = _counters()
    out, times = {}, {}
    for name, (cfg, params) in sides.items():
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[name] = psi_state_batched(cfg, params, R)
        C, count = _mo_tensor_ensemble(cfg, params, R)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        launched = {k: c.n for k, c in counters.items() if c.n}
        ms, wall = _time_ms(lambda: psi_state_batched(cfg, params, R),
                            iters=3, warmup=1)
        times[name] = (ms, wall, peak, launched)
        out[name + ' C'] = (C, count)
    if not (times['unscreened'][3].get('sparse_mo') and
            times['screened'][3].get('screened_mo') and
            'sparse_mo' not in times['screened'][3]):
        _fail(f'eps=0 evaluation did not take the expected kernels: '
              f'{ {k: v[3] for k, v in times.items()} }')
    (Cu, cu), (Cs, cs) = out['unscreened C'], out['screened C']
    rel, err, dead = _per_electron_err(
        torch, Cs.transpose(0, 1).reshape(Cs.shape[1], -1, 5),
        Cu.transpose(0, 1).reshape(Cu.shape[1], -1, 5))
    cfg, params = sides['unscreened']
    exact = _finish_state(cfg, _fp64_twin(params), Cu.double(), R.double(),
                          cu)
    a, b = out['screened'], out['unscreened']
    scope = (_rel(b.drift, exact.drift) <= FP32_SCOPE).cpu()
    over = torch.zeros(R.shape[0], dtype=torch.float64)
    for f, rtol in (('log_psi', 2e-6), ('drift', 1e-4), ('e_loc', 1e-4)):
        x, y = getattr(a, f).cpu().double(), getattr(b, f).cpu().double()
        dims = tuple(range(1, y.dim()))
        ymax = y.abs().amax(dim=dims) if dims else y.abs()
        atol = 1e-4 if f == 'log_psi' else 1e-4 * ymax
        r = (x - y).abs() - rtol * y.abs()
        r = (r.amax(dim=dims) if dims else r) / atol
        over = torch.maximum(over, torch.nan_to_num(r, nan=torch.inf))
    bitwise = torch.equal(Cs, Cu)
    same = (a.sign.cpu() == b.sign.cpu()) & torch.equal(cs, cu)
    fail = (over > 1.0) | ~same
    n_in = int(scope.sum())
    scr = sides['screened'][0].screening
    mem = memory_budget(scr, cfg.basis, cfg.n_elec, params.mo.shape[0],
                        n_walkers=R.shape[0])
    print(f'[screened vs unscreened] {BSTRAND} W={R.shape[0]} eps=0 '
          f'(K={scr.ao_budget}): MO tensor per-electron max |dC|/max|C| '
          f'{rel:.3e} (tol 1e-5; max abs {err:.3e}; bitwise equal '
          f'{bitwise}), active counts equal '
          f'{torch.equal(cs, cu)}; {n_in} walkers in FP32_SCOPE, parity '
          f'failures {int((fail & scope).sum())} in scope, '
          f'{int((fail & ~scope).sum())} of {int((~scope).sum())} out of '
          f'scope (worst in scope |diff|/tol '
          f'{float(over[scope].max()) if n_in else 0.0:.3g})')
    for name, (ms, wall, peak, launched) in times.items():
        print(f'[screened vs unscreened] {name} psi_state_batched: '
              f'{ms:.3f} ms device, {wall:.3f} ms host clock, peak '
              f'{peak:.2f} GB above the inputs; kernels {launched}')
    print(f'[screened vs unscreened] memory_budget (fp32): dense B '
          f'{mem["dense_b_bytes"] / 1e9:.3f} GB + C '
          f'{mem["dense_c_bytes"] / 1e9:.3f} GB = '
          f'{mem["dense_total"] / 1e9:.3f} GB; packed B '
          f'{mem["packed_b_bytes"] / 1e9:.3f} GB + C = '
          f'{mem["screened_total"] / 1e9:.3f} GB')
    if not (rel <= 1e-5 and dead == 0 and torch.equal(cs, cu)
            and not bool((fail & scope).any())):
        _fail('screened and unscreened evaluations disagree at eps=0')


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


def _finite_cold_start(torch, dev, seed: int, n_det: int = 1):
    """(cfg, params, SEM ensemble) of ``SYSTEM`` at W = ``WALKERS`` from the
    cold start ``qmc_run`` draws for worker 0 of run ``seed``."""
    from repro_torch.core.sem import evaluate_sem
    from repro_torch.core.vmc import sample_positions
    from repro_torch.runtime.samplers import worker_seed
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, n_det=n_det, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(worker_seed(seed, 0))
    R = sample_positions(params, gen, WALKERS, cfg.n_elec)
    return cfg, params, evaluate_sem(cfg, params, R)


def _fused_blocks(torch, cfg, params, ens, gen, step: float = 0.3):
    """Both spin blocks' fused-sweep operands for ``ens`` (the batched pass
    of ``core/sem.py::_fused_sweeps``), one sweep's draws from ``gen``."""
    from repro_torch.core import sem
    eta, u = sem.draw_sweep(gen, ens.r)
    r_prop = ens.r + step * eta
    logu = torch.log(torch.clamp(u, min=1e-38))
    en = sem._en_sum(params, r_prop) - sem._en_sum(params, ens.r)
    phi_up, phi_dn = sem._fused_phi_all(cfg, params,
                                        *sem._mo_blocks(cfg, params), r_prop)
    n_up = cfg.n_up
    up, dn = slice(0, n_up), slice(n_up, cfg.n_elec)
    return [dict(spin='up', offset=0, minv=ens.minv_up, phi=phi_up,
                 r_prop=r_prop[:, up], en=en[:, up], logu=logu[:, up],
                 P=ens.p_up, rdet=ens.rdet_up, r_other=ens.rdet_dn),
            dict(spin='dn', offset=n_up, minv=ens.minv_dn, phi=phi_dn,
                 r_prop=r_prop[:, dn], en=en[:, dn], logu=logu[:, dn],
                 P=ens.p_dn, rdet=ens.rdet_dn, r_other=None)]


def _sweep_block(torch, blk, state, kernel: bool, *, n_up: int, b_ee,
                 cfg=None, route: str = 'auto', logu=None, r_other=None,
                 dtype=None, **launch):
    """One spin block through ``fused_sweep_block`` on copies of its
    inputs ``state = (r, sign, logdet)``: the CUDA kernel (``kernel``) or
    the plain version on the card (in ``dtype`` when given: the fp64 twin
    of the scope rule).  ``cfg`` carries the CI expansion, if any;
    ``launch`` the kernel's ``threads`` or ``per_row``."""
    from repro_torch.core.sem import _ci_lists
    from repro_torch.kernels.fused_sweep.ops import fused_sweep_block

    def _c(x):
        x = x.clone().contiguous()
        return x if dtype is None else x.to(dtype)
    ci_ops = None
    if cfg is not None and cfg.ci is not None:
        holes, parts = _ci_lists(cfg, blk['spin'], kernel)
        ro = blk['r_other'] if r_other is None else r_other
        ci_ops = (_c(blk['P']), _c(blk['rdet']), _c(ro), holes, parts,
                  _c(cfg.ci_t.coeffs))
    r, sign, logdet = state
    return fused_sweep_block(
        _c(blk['minv']), _c(blk['phi']), _c(r), _c(blk['r_prop']),
        _c(blk['en']), _c(blk['logu'] if logu is None else logu), _c(sign),
        _c(logdet), _c(b_ee), ci_ops, offset=blk['offset'], n_up=n_up,
        use_kernel=kernel, route=route, **launch)


def _compare_sweep(torch, label, out_k, out_p, out_64, strict: bool,
                   near: float = 1e-5, kernel: str = 'fused_sweep'):
    """Kernel (``kernel`` names it in the printed line) against plain
    version of one spin block's sweep.

    ``strict`` (well-conditioned inputs): on every walker with no move
    whose margin is within ``near`` of 0 on either side, identical accept
    decisions, equal r and sign, Minv, P and rdet within 1e-5 of the
    walker's max, logdet within 1e-5 of max(|logdet|, 1).

    Otherwise (a cold start of the main path, where a 79-move
    Sherman–Morrison chain in fp32 moves some walkers' inverses by 1e-4 to
    O(1) whatever the summation order) the scope rule of ``FP32_SCOPE``
    picks the walkers, by the plain fp32 sweep's distance from its fp64
    twin (the same sweep in float64 on the same fp32 inputs) in Minv, P
    and rdet, each relative to the walker's max:
    * within ``FP32_SCOPE`` (a tenth of the 1e-4 drift contract): identical
      decisions away from the threshold, equal r and sign, logdet within
      1e-5;
    * within ``FP32_SCOPE / 10`` (a tenth of this check's 1e-5): Minv, P
      and rdet of the kernel within 1e-5 of the plain version's, per
      walker;
    * over all tie-free walkers, the kernel's median distance from the
      plain version within 3x the plain version's median distance from
      the fp64 twin (the fp32 rounding scale of these inputs).

    Returns dict(abs=max |Minv - plain|, rel=max per-walker |Minv -
    plain| / max |Minv|, n=walkers, over the walkers whose tables were
    held per walker; ties=near-tie moves, bad=failures)."""
    r_k, m_k, s_k, l_k, p_k, d_k, a_k, g_k = out_k
    r_p, m_p, s_p, l_p, p_p, d_p, a_p, g_p = out_p
    tie = (g_k.abs() < near) | (g_p.abs() < near)           # (W, n)
    n_tie = int(tie.sum())
    tables = [('Minv', m_k, m_p, out_64[1])]
    for f, k, p, p64 in (('P', p_k, p_p, out_64[4]),
                         ('rdet', d_k, d_p, out_64[5])):
        if k is not None and k.numel():
            tables.append((f, k, p, p64))
    clean = ~tie.any(dim=1).cpu()
    scope, tight = clean.clone(), clean.clone()
    if not strict:
        for _, _, p, p64 in tables:
            e64 = _rel(p, p64)
            scope &= e64 <= FP32_SCOPE
            tight &= e64 <= FP32_SCOPE / 10
    n_clean, n_in, n_tight = int(clean.sum()), int(scope.sum()), \
        int(tight.sum())
    W = clean.numel()
    sc = scope.to(tie.device)
    bad = []
    diff = (a_k != a_p) & ~tie
    n_diff, n_diff_in = int(diff.sum()), int(diff[sc].sum())
    if n_diff_in:
        bad.append(f'{label}: {n_diff_in} accept decisions differ away '
                   f'from the threshold')
    if not (torch.equal(r_k[sc], r_p[sc]) and torch.equal(s_k[sc], s_p[sc])):
        bad.append(f'{label}: r or sign differ on walkers compared')
    dl_all = ((l_k - l_p).abs() / l_p.abs().clamp(min=1.0)).cpu().double()
    dl = float(dl_all[scope].max()) if n_in else 0.0
    if not dl <= 1e-5:
        bad.append(f'{label}: logdet past 1e-5 ({dl:.3e})')
    notes = []
    for f, k, p, p64 in tables:
        kp_all = _rel(k, p)
        kp, p64e = kp_all[clean], _rel(p, p64)[clean]
        held = float(kp_all[tight].max()) if n_tight else 0.0
        notes.append(f'{f} kernel vs plain {_q3(kp)} (held per walker: max '
                     f'{held:.2e}), plain vs fp64 {_q3(p64e)}')
        if not held <= 1e-5:
            bad.append(f'{label}: {f} past 1e-5 of the walker max on a '
                       f'walker held per walker ({held:.3e})')
        if not strict and not float(kp.median()) <= 3 * float(p64e.median()):
            bad.append(f'{label}: {f} kernel-vs-plain median '
                       f'{float(kp.median()):.3e} over 3x the fp32 scale '
                       f'{float(p64e.median()):.3e}')
    held_by = ('' if strict else f', {n_tight} with plain vs fp64 within '
               f'{FP32_SCOPE / 10:g} held per walker')
    print(f'[check] {kernel} {label}: accepts {int(a_p.sum())}/'
          f'{a_p.numel()} (kernel {int(a_k.sum())}); {n_tie} moves with '
          f'|margin| < {near}; {n_in} of {W} walkers compared exactly (no '
          f'tie' + ('' if strict else ', in FP32_SCOPE') + f'{held_by}): '
          f'decisions differing {n_diff_in} (on all walkers {n_diff}), '
          f'logdet max {dl:.3e} (on all tie-free '
          f'{float(dl_all[clean].max()):.3e}); per-walker rel err over the '
          f'{n_clean} tie-free walkers (median / p95 / max) '
          + '; '.join(notes) + ' (tol 1e-5 per walker held'
          + ('' if strict else '; kernel median <= 3x plain-vs-fp64 median')
          + ')')
    t = tight.to(tie.device)
    res = dict(abs=0.0, rel=0.0, n=n_tight, ties=n_tie, bad=bad)
    if n_tight:
        res['abs'] = float((m_k - m_p).abs()[t].max())
        res['rel'] = float(_rel(m_k, m_p)[tight].max())
    return res


def _q3(x):
    """'median / p95 / max' of a per-walker reading."""
    x = x.double()
    return (f'{float(x.median()):.2e} / {float(x.quantile(0.95)):.2e} / '
            f'{float(x.max()):.2e}')


def _rows_variant_size(fsk, reg: int, sh: int, ci: bool):
    """(n, threads per row): the largest block n <= 256 (CI: n_orb = n +
    20, n_det = 50) at which the rows route's chooser takes the compiled
    (reg, sh)."""
    for n in range(256, 0, -1):
        sizes = ((n, n + 20, 2 * n, n + 20, 50, True) if ci
                 else (n, n, 2 * n - 1))
        for t in fsk.PER_ROW:
            x = fsk.rows_launch(*sizes, per_row=t)
            if x is not None and (x.reg, x.shared) == (reg, sh):
                return n, t
    _fail(f'no block size takes the compiled rows shape ({reg}, {sh}), '
          f'ci={ci}')


def _synthetic_block(torch, dev, n: int, W: int, seed: int):
    """A well-conditioned spin block of n electrons (n_e = 2n - 1): Minv the
    inverse of I + 0.1 G/sqrt(n), proposals' phi the electron's own column
    plus noise, so every ratio stays O(1).  Returns (block, state)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def _n(*shape):
        return torch.randn(shape, generator=g, device=dev)
    D = torch.eye(n, device=dev) + 0.1 * _n(W, n, n) / math.sqrt(n)
    minv = torch.linalg.inv(D.double()).float()              # (elec, orb)
    phi = (D.transpose(1, 2) + 0.3 * _n(W, n, n) / math.sqrt(n)).contiguous()
    r = 2.0 * _n(W, 2 * n - 1, 3)
    blk = dict(spin='up', offset=0, minv=minv, phi=phi,
               r_prop=r[:, :n] + 0.3 * _n(W, n, 3), en=0.05 * _n(W, n),
               logu=torch.log(torch.rand((W, n), generator=g, device=dev)
                              .clamp(min=1e-6)))
    sd, ld = torch.linalg.slogdet(D.double())
    return blk, (r, sd.float(), ld.float())


def _rank_k_ci(n: int, n_orb: int, n_det: int, k: int, seed: int):
    """A CI expansion of excitation rank k (``from_excitations``): per
    determinant a random rank of 1..k in one spin block or split over
    both, over n_orb orbitals, coefficients decaying from the reference."""
    import numpy as np
    from repro_torch.core.multidet import from_excitations
    rng = np.random.default_rng(seed)
    seen, exc = set(), []
    while len(exc) < n_det - 1:
        up_k = int(rng.integers(0, k + 1))
        dn_k = int(rng.integers(0 if up_k else 1, k + 1))

        def _draw(deg):
            h = sorted(rng.choice(n, deg, replace=False).tolist())
            p = sorted((n + rng.choice(n_orb - n, deg, replace=False)
                        ).tolist())
            return h, p
        e = (_draw(up_k), _draw(dn_k))
        key = repr(e)
        if key not in seen:
            seen.add(key)
            exc.append(e)
    i = np.arange(1, n_det)
    coeffs = np.concatenate([[1.0], rng.choice([-1.0, 1.0], n_det - 1)
                             * 0.3 / (1.0 + 0.05 * i)])
    return from_excitations(coeffs, exc, n, n, n_orb)


def _synthetic_ci_blocks(torch, dev, n: int, n_orb: int, n_det: int,
                         W: int, seed: int, rank: int = 2):
    """Two well-conditioned spin blocks of n electrons each (n_e = 2n) with
    a CI expansion over n_orb orbitals (``synthetic_ci`` for rank 2, else
    ``_rank_k_ci``): per block the occupied orbitals at the electrons
    I + 0.1 G/sqrt(n), the virtual ones 0.3 G, P and rdet built from them
    as the path builds them (``multidet.reference_table``,
    ``det_ratios``), proposals' phi the electron's own column plus noise.
    Returns (cfg-like namespace with ``ci``/``ci_t``, [up block, dn
    block], state)."""
    from types import SimpleNamespace
    from repro_torch.core import multidet
    from repro_torch.systems.bench import synthetic_ci
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def _n(*shape):
        return torch.randn(shape, generator=g, device=dev)
    mdw = (synthetic_ci(n, n, n_orb, n_det, seed=seed) if rank == 2
           else _rank_k_ci(n, n_orb, n_det, rank, seed))
    ci_t = multidet.pin(mdw, n, n, dev)
    r = 2.0 * _n(W, 2 * n, 3)
    blocks, sign, logdet = [], 1.0, 0.0
    for spin, off in (('up', 0), ('dn', n)):
        D = torch.eye(n, device=dev) + 0.1 * _n(W, n, n) / math.sqrt(n)
        V = 0.3 * _n(W, n_orb - n, n)              # (virtual orb, elec)
        minv = torch.linalg.inv(D.double()).float()          # (elec, orb)
        P = multidet.reference_table(torch.cat([D, V], dim=1), minv)
        rdet = multidet.det_ratios(P, getattr(ci_t, f'holes_{spin}'),
                                   getattr(ci_t, f'parts_{spin}'))
        phi = torch.cat([D.transpose(1, 2) + 0.3 * _n(W, n, n) / math.sqrt(n),
                         V.transpose(1, 2) + 0.1 * _n(W, n, n_orb - n)],
                        dim=-1).contiguous()
        blocks.append(dict(
            spin=spin, offset=off, minv=minv, phi=phi,
            r_prop=r[:, off:off + n] + 0.3 * _n(W, n, 3),
            en=0.05 * _n(W, n), P=P, rdet=rdet,
            logu=torch.log(torch.rand((W, n), generator=g, device=dev)
                           .clamp(min=1e-6))))
        sd, ld = torch.linalg.slogdet(D.double())
        sign, logdet = sign * sd, logdet + ld
    blocks[0]['r_other'] = blocks[1]['rdet']
    blocks[1]['r_other'] = blocks[0]['rdet']
    return (SimpleNamespace(ci=mdw, ci_t=ci_t), blocks,
            (r, sign.float(), logdet.float()))


def phase_fused_vs_plain(torch, dev, rec, seed: int, bstrand=None):
    """The fused-sweep kernel against its plain version on the card:
    main-path shapes (smallest, W = 256, n = 79, both spin blocks, a cold
    start from the run seed), all-accept and all-reject sweeps, the CI
    variant at n_det = 100; well-conditioned synthetic blocks (ratios O(1))
    at n = 79 (W = 256; rows route, also forced to the shared route), n =
    217 (rows route at the tuned threads per row and at one thread a row,
    also forced to the shared and the global routes) and n = 866 (global
    route) at W = 8, and a synthetic CI
    sweep of both spin blocks at n = 79, n_orb = 118, n_det = 100 (W =
    256), each side's down block fed its own up block's output (the rdet
    the kernel wrote is the down block's r_other, as in the path), also
    with expansions of excitation rank 3 (cofactors in the kernel) and 5
    (pivoted elimination); every (R, S) the rows route is compiled for,
    with and without CI, at the largest block that takes it (W = 8); and
    the b-strand (n = 217, screened proposal
    values at eps = 1e-8) from ``bstrand`` = (cfg, params, SEM ensemble)
    of finite cold-start walkers."""
    from repro_torch.kernels.fused_sweep import autotune
    from repro_torch.kernels.fused_sweep import kernel as fsk
    bad, ties = [], 0
    main = dict(abs=0.0, rel=0.0, n=0)
    synth = 0.0

    def _tune(n_e):
        """The main path's tuned launch at n_e electrons and the first
        design's tuned threads per block (its shared or global route, timed
        beside the rows route); both tuners' candidates printed."""
        launch = autotune.best_launch(n_e, WALKERS)
        tables = autotune.best_threads(n_e, WALKERS)
        times = autotune.measured_times()
        for what, tag, pick in (
                ('threads per row', f'|{autotune.PER_ROW_TAG}',
                 launch.get('per_row')),
                ('threads per block of the first design', '', tables)):
            got = times.get(f'{n_e}|{WALKERS}|fp32|cuda{tag}')
            print(f'[tune] fused_sweep {what} at n_e={n_e}, W={WALKERS}: '
                  f'{pick}; candidates (least of 5 launches after 25 ms '
                  f'of them, CUDA events): '
                  + (', '.join(f'{k}: {v * 1e3:.4f} ms'
                               for k, v in got.items()) if got
                     else 'from the cache, not measured in this run'))
        return launch, tables

    launch, tables = _tune(2 * 79)
    if bstrand is not None:
        rec['fused_sweep_bstrand_launch'] = _tune(bstrand[0].n_elec)

    def _sides(blk, state, route, klaunch, prev=None, **kw):
        """Kernel (launched with ``klaunch``), plain and fp64-twin outputs
        of one block; with ``prev`` each side starts from its own earlier
        block's output."""
        outs = []
        for i, (kernel, dtype) in enumerate(((True, None), (False, None),
                                             (False, torch.float64))):
            extra = dict(kw)
            if prev is not None:
                o = prev[i]
                state, extra['r_other'] = (o[0], o[2], o[3]), o[5]
            if kernel:
                extra.update(klaunch)
            outs.append(_sweep_block(
                torch, blk, state, kernel, dtype=dtype,
                route=route if kernel else 'auto', **extra))
        torch.cuda.synchronize()
        return outs

    def _both(label, blk, state, route='auto', strict=False,
              is_main=False, prev=None, klaunch=None, **kw):
        nonlocal ties, synth
        outs = _sides(blk, state, route, launch if klaunch is None
                      else klaunch, prev, **kw)
        res = _compare_sweep(torch, label, *outs, strict)
        if is_main and res['n']:
            main['abs'] = max(main['abs'], res['abs'])
            main['rel'] = max(main['rel'], res['rel'])
            main['n'] += res['n']
        if strict and blk['minv'].shape[1] == 79:
            synth = max(synth, res['abs'])
        ties += res['ties']
        bad.extend(res['bad'])
        return outs

    for n_det in (1, 100):
        cfg, params, ens = _finite_cold_start(torch, dev, seed, n_det)
        gen = torch.Generator(device=dev)
        gen.manual_seed(77)
        blocks = _fused_blocks(torch, cfg, params, ens, gen)
        kw = dict(n_up=cfg.n_up, b_ee=params.jastrow.b_ee, cfg=cfg)
        tag = f'{SYSTEM} W={WALKERS}' + (f' n_det={n_det}' if n_det > 1
                                         else '')
        rec[f'fused_sweep_{n_det}'] = (cfg, params, blocks[0], ens)
        state, r_other = (ens.r, ens.sign, ens.logdet), None
        for blk in blocks:
            out_p = _both(f'{tag} {blk["spin"]} block', blk, state,
                          r_other=r_other, is_main=True, **kw)[1]
            # the down block starts where the plain up block ended
            state, r_other = (out_p[0], out_p[2], out_p[3]), out_p[5]
        if n_det > 1:
            continue
        blk = blocks[0]
        for label, lu in (('all-reject', 1e30), ('all-accept', -1e30)):
            logu = torch.full_like(blk['logu'], lu)
            out_k = _both(f'{tag} up block {label}', blk,
                          (ens.r, ens.sign, ens.logdet), logu=logu,
                          strict=label == 'all-reject', **kw)[0]
            if label == 'all-reject':
                same = all(torch.equal(a, b) for a, b in zip(
                    out_k[:4], (ens.r, blk['minv'], ens.sign, ens.logdet)))
                if out_k[6].any() or not same:
                    bad.append('all-reject sweep changed the state')
            elif not (out_k[6].all() and torch.equal(
                    out_k[0][:, :cfg.n_up], blk['r_prop'])):
                bad.append('all-accept sweep did not land on the proposals')

    ones = torch.ones((), device=dev)
    card = fsk.device_card(dev)
    first = dict(threads=tables)
    tuned_b = rec.get('fused_sweep_bstrand_launch', (launch, tables))[0]
    for n, W, cases in (
            (79, WALKERS, (('auto', launch), ('shared', first))),
            (217, 8, (('auto', tuned_b), ('rows', dict(per_row=1)),
                      ('shared', first), ('global', first))),
            (866, 8, (('auto', first),))):
        blk, state = _synthetic_block(torch, dev, n, W, seed=n)
        for route, kl in cases:
            shape = fsk.launch_shape(n, n, 2 * n - 1, route=route,
                                     walkers=W, card=card, **kl)
            nbytes = fsk.smem_bytes(n, n, 2 * n - 1, route=route,
                                    walkers=W, card=card, **kl)
            _both(f'synthetic n={n} W={W} {shape} ({nbytes} B shared)',
                  blk, state, route=route, strict=True, klaunch=kl, n_up=n,
                  b_ee=ones)
    for rank, n_det in ((2, 100), (3, 100), (5, 50)):
        cfg_s, (up, dn), state = _synthetic_ci_blocks(
            torch, dev, 79, 118, n_det, WALKERS, seed=101 + rank, rank=rank)
        if cfg_s.ci.k != rank or cfg_s.ci_t.holes_up_k.shape[1] != rank:
            _fail(f'synthetic CI expansion has rank {cfg_s.ci.k}, not {rank}')
        kw = dict(n_up=79, b_ee=ones, cfg=cfg_s)
        tag = (f'synthetic CI rank {rank} n=79 n_orb=118 n_det={n_det} '
               f'W={WALKERS}')
        prev = _both(f'{tag} up block', up, state, strict=True, **kw)
        _both(f'{tag} dn block (each side fed its own up block)', dn, None,
              strict=True, prev=prev, **kw)
    # every (R, S) the rows route is compiled for, with and without CI, at
    # the largest block n <= 256 that takes it (CI: n_orb = n + 20,
    # n_det = 50), W = 8
    for reg, sh, with_ci in ([(r, s, False) for r, s in fsk.VARIANTS]
                             + [(r, s, True) for r, s in fsk.CI_VARIANTS]):
        n, t = _rows_variant_size(fsk, reg, sh, with_ci)
        seed_v = 300 + reg + sh + n
        if with_ci:
            cfg_v, (blk, _), state = _synthetic_ci_blocks(
                torch, dev, n, n + 20, 50, 8, seed=seed_v)
            sizes, kw = ((n, n + 20, 2 * n, n + 20, 50, True),
                         dict(cfg=cfg_v))
        else:
            blk, state = _synthetic_block(torch, dev, n, 8, seed=seed_v)
            sizes, kw = (n, n, 2 * n - 1), {}
        shape = fsk.launch_shape(*sizes, route='rows', per_row=t, walkers=8,
                                 card=card)
        if (shape.reg, shape.shared) != (reg, sh):
            bad.append(f'compiled rows shape ({reg}, {sh}) ci={with_ci}: '
                       f'the chooser gave {shape}')
        _both(f'synthetic compiled rows shape ({reg}, {sh}) '
              f'{"with CI " if with_ci else ""}n={n} W=8 {shape}', blk,
              state, route='rows', strict=True, klaunch=dict(per_row=t),
              n_up=n, b_ee=ones, **kw)
    if bstrand is not None:
        cfg, params, ens = bstrand
        gen = torch.Generator(device=dev)
        gen.manual_seed(83)
        blocks = _fused_blocks(torch, cfg, params, ens, gen)
        rec['fused_sweep_bstrand'] = (cfg, params, blocks[0], ens)
        kw = dict(n_up=cfg.n_up, b_ee=params.jastrow.b_ee, cfg=cfg)
        state, r_other = (ens.r, ens.sign, ens.logdet), None
        for blk in blocks:
            out_p = _both(f'{BSTRAND} eps={SCREEN_EPS:g} W={WALKERS} '
                          f'{blk["spin"]} block', blk, state,
                          r_other=r_other, is_main=True, klaunch=tuned_b,
                          **kw)[1]
            state, r_other = (out_p[0], out_p[2], out_p[3]), out_p[5]
    rec['fused_sweep'] = dict(inputs=rec.pop('fused_sweep_1'),
                              max_abs_err=main['abs'], max_rel_err=main['rel'],
                              synthetic_max_abs_err=synth, launch=launch,
                              tables=tables, bstrand=rec.pop(
                                  'fused_sweep_bstrand_launch',
                                  (launch, tables)))
    print(f'[check] fused_sweep: {ties} near-tie moves in all cases; main '
          f'path (cold-start sweeps, single det and n_det = 100), over the '
          f'{main["n"]} block-walkers held per walker: max |Minv - plain| '
          f'{main["abs"]:.3e}, max per-walker |Minv - plain| / max |Minv| '
          f'{main["rel"]:.3e} (the kernels line\'s max_abs_err and '
          f'max_rel_err); well-conditioned synthetic blocks at n = 79: max '
          f'|Minv - plain| {synth:.3e} (synthetic_max_abs_err)')
    if bad:
        _fail('; '.join(bad))


def phase_multidet_vs_plain(torch, dev, rec, seed: int):
    """The multidet-ratio kernel against its plain version on the card at
    W = 256: n_det = 100 on a real move of the main path (smallest's CI
    state, the first electron's proposal) and n_det = 1000 on random
    tables.  Ratios within 1e-5 * max|ratio|; the CI sum within 1e-5 of
    sum_I |c_I ratio_I r_other_I| (its own scale)."""
    from repro_torch.kernels.multidet_ratio.kernel import multidet_ratio
    from repro_torch.kernels.multidet_ratio.ref import multidet_ratios_ref
    from repro_torch.systems.bench import synthetic_ci
    cfg, params, ens = _finite_cold_start(torch, dev, seed, 100)
    gen = torch.Generator(device=dev)
    gen.manual_seed(78)
    phi_all = _fused_blocks(torch, cfg, params, ens, gen)[0]['phi'][:, 0]
    phi = phi_all[:, :cfg.n_up]
    ratio = torch.sum(ens.minv_up[:, 0] * phi, dim=-1)
    P = ens.p_up.contiguous()
    ci_t = cfg.ci_t
    cases = [('n_det=100 main path', P,
              (torch.einsum('woh,wh->wo', P, phi) - phi_all).contiguous(),
              (ens.minv_up[:, 0] / ratio[:, None]).contiguous(),
              ci_t.holes_up_k, ci_t.parts_up_k, ci_t.coeffs,
              ens.rdet_dn.contiguous())]
    g = torch.Generator(device=dev)
    g.manual_seed(79)
    ci = synthetic_ci(cfg.n_up, cfg.n_dn, cfg.ci.n_orb, 1000, seed=5)
    W, n_orb, n_occ = P.shape

    def _n(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def _i(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)
    cases.append(('n_det=1000 random', _n(W, n_orb, n_occ), _n(W, n_orb),
                  _n(W, n_occ), _i(ci.holes_up), _i(ci.parts_up),
                  torch.as_tensor(ci.coeffs, device=dev), _n(W, 1000)))
    worst = 0.0
    for label, P_, g_, row_, h_, p_, c_, ro_ in cases:
        rk, sk = multidet_ratio(P_, g_, row_, h_, p_, c_, ro_)
        rp, sp = multidet_ratios_ref(P_, g_, row_, h_.long(), p_.long(), c_,
                                     ro_)
        torch.cuda.synchronize()
        err = float((rk - rp).abs().max())
        tol = 1e-5 * float(rp.abs().max())
        scale = torch.sum((c_ * rp * ro_).abs(), dim=-1)
        s_err = float(((sk - sp).abs() / scale).max())
        print(f'[check] multidet_ratio {label}: max|ratio - plain| '
              f'{err:.3e} (tol 1e-5*max|ratio| = {tol:.3e}); CI sum rel to '
              f'sum|terms| {s_err:.3e} (tol 1e-5); rank {h_.shape[1]}, '
              f'max|ratio| {float(rp.abs().max()):.3g}')
        if not (err <= tol and s_err <= 1e-5 and torch.isfinite(rk).all()):
            _fail(f'multidet_ratio {label} disagrees with its plain version')
        worst = max(worst, err)
        if label == 'n_det=100 main path':
            rec['multidet_ratio'] = dict(inputs=(P_, g_, row_, h_, p_, c_,
                                                 ro_))
    rec['multidet_ratio']['max_abs_err'] = worst


def _move_block(torch, blk, state, kernel: bool, *, n_up: int, b_ee,
                cfg=None, logu=None, r_other=None, dtype=None):
    """One spin block's per-move sweep through ``sem_move`` (``kernel``) or
    its plain version on the card (in ``dtype`` when given: the fp64 twin
    of the scope rule), on copies of the block's inputs ``state = (r,
    sign, logdet)``.  The proposals are the block's (``_fused_blocks``,
    ``_synthetic_block``): each move's phi and e-n delta precomputed, its
    e-e delta against that side's current positions, so the two sides see
    the same inputs until a decision parts them.  Returns (r, minv, sign,
    logdet, P, rdet, accept (W, n), margin (W, n)), as ``_sweep_block``."""
    from repro_torch.core.sem import _ci_lists
    from repro_torch.kernels.fused_sweep.ref import _ee_sum
    from repro_torch.kernels.sem_update.ops import sem_move
    from repro_torch.kernels.sem_update.ref import sem_move_ref

    def _c(x):
        x = x.clone().contiguous()
        return x if dtype is None else x.to(dtype)
    r, sign, logdet = (_c(x) for x in state)
    minv, phi, rp, en = (_c(blk[k]) for k in ('minv', 'phi', 'r_prop', 'en'))
    lu, bee = _c(blk['logu'] if logu is None else logu), _c(b_ee)
    P = rdet = ci = None
    if cfg is not None and cfg.ci is not None:
        holes, parts = _ci_lists(cfg, blk['spin'], kernel)
        P, rdet = _c(blk['P']), _c(blk['rdet'])
        ci = (_c(blk['r_other'] if r_other is None else r_other), holes,
              parts, _c(cfg.ci_t.coeffs))
    W, n = rp.shape[:2]
    acc = torch.empty((n, W), dtype=torch.bool, device=minv.device)
    mar = torch.empty((n, W), dtype=minv.dtype, device=minv.device)
    st = (r, minv, sign, logdet, P, rdet)
    for e in range(n):
        j = blk['offset'] + e
        cur = st[0]
        d_jas = (_ee_sum(cur, j, rp[:, e], n_up, bee)
                 - _ee_sum(cur, j, cur[:, j], n_up, bee) + en[:, e])
        if kernel:
            st = sem_move(st, phi[:, e], rp[:, e], d_jas, lu[:, e], e, j,
                          acc, mar, ci)
        else:
            st, acc[e], mar[e] = sem_move_ref(st, phi[:, e], rp[:, e], d_jas,
                                              lu[:, e], e, j, ci)
    return (*st, acc.T, mar.T)


def phase_sem_move_vs_plain(torch, dev, rec, seed: int):
    """The per-move kernel against its plain version on the card, each side
    driving one spin block's sweep move by move (``_move_block``): the main
    path's inputs (smallest, W = 256, n = 79, both spin blocks of a cold
    start from the run seed, single determinant and n_det = 100; asserted
    per walker as ``_compare_sweep`` does on a cold start), all-accept and
    all-reject sweeps; well-conditioned synthetic blocks at n = 217 and
    866 (past one SM's shared memory); synthetic CI sweeps of both spin
    blocks at n = 79, n_orb = 118 at excitation ranks 2, 3 and 8; every
    compiled (CPL, RPW) variant with and without CI at the widest block
    the chooser gives it (n = 32 CPL: 32 .. 256; (0, 0) at n = 300); and
    one move in which a rejected walker has NaN in its row e and
    another a zero ratio (CI: an infinite row_t): neither may change."""
    from repro_torch.kernels.sem_update import kernel as suk
    bad, ties = [], 0
    main = dict(abs=0.0, rel=0.0, n=0)

    def _both(label, blk, state, strict=False, is_main=False, prev=None,
              **kw):
        nonlocal ties
        outs = []
        for i, (kernel, dtype) in enumerate(((True, None), (False, None),
                                             (False, torch.float64))):
            extra, st = dict(kw), state
            if prev is not None:
                o = prev[i]
                st, extra['r_other'] = (o[0], o[2], o[3]), o[5]
            outs.append(_move_block(torch, blk, st, kernel, dtype=dtype,
                                    **extra))
        torch.cuda.synchronize()
        res = _compare_sweep(torch, label, *outs, strict, kernel='sem_move')
        if is_main and res['n']:
            main['abs'] = max(main['abs'], res['abs'])
            main['rel'] = max(main['rel'], res['rel'])
            main['n'] += res['n']
        ties += res['ties']
        bad.extend(res['bad'])
        return outs

    for n_det in (1, 100):
        cfg, params, ens = _finite_cold_start(torch, dev, seed, n_det)
        gen = torch.Generator(device=dev)
        gen.manual_seed(77)
        blocks = _fused_blocks(torch, cfg, params, ens, gen)
        kw = dict(n_up=cfg.n_up, b_ee=params.jastrow.b_ee, cfg=cfg)
        tag = f'{SYSTEM} W={WALKERS}' + (f' n_det={n_det}' if n_det > 1
                                         else '')
        rec[f'sem_move_{n_det}'] = (cfg, params, blocks[0], ens)
        state, r_other = (ens.r, ens.sign, ens.logdet), None
        for blk in blocks:
            shape = suk.move_shape(
                blk['minv'].shape[1], blk['phi'].shape[-1],
                *((cfg.ci.n_orb, cfg.ci.n_det, True) if n_det > 1 else ()),
                optin=suk.device_optin(dev))
            out_p = _both(f'{tag} {blk["spin"]} block {shape}', blk, state,
                          r_other=r_other, is_main=True, **kw)[1]
            state, r_other = (out_p[0], out_p[2], out_p[3]), out_p[5]
        if n_det > 1:
            continue
        blk = blocks[0]
        for label, lu in (('all-reject', 1e30), ('all-accept', -1e30)):
            logu = torch.full_like(blk['logu'], lu)
            out_k = _both(f'{tag} up block {label}', blk,
                          (ens.r, ens.sign, ens.logdet), logu=logu,
                          strict=label == 'all-reject', **kw)[0]
            if label == 'all-reject':
                same = all(torch.equal(a, b) for a, b in zip(
                    out_k[:4], (ens.r, blk['minv'], ens.sign, ens.logdet)))
                if out_k[6].any() or not same:
                    bad.append('sem_move all-reject sweep changed the state')
            elif not (out_k[6].all() and torch.equal(
                    out_k[0][:, :cfg.n_up], blk['r_prop'])):
                bad.append('sem_move all-accept sweep did not land on the '
                           'proposals')

    ones = torch.ones((), device=dev)
    optin = suk.device_optin(dev)
    for n, W in ((217, 32), (866, 8)):
        blk, state = _synthetic_block(torch, dev, n, W, seed=500 + n)
        _both(f'synthetic n={n} W={W} {suk.move_shape(n, n, optin=optin)}',
              blk, state, strict=True, n_up=n, b_ee=ones)
    for rank, n_det in ((2, 100), (3, 100), (8, 50)):
        cfg_s, (up, dn), state = _synthetic_ci_blocks(
            torch, dev, 79, 118, n_det, WALKERS, seed=601 + rank, rank=rank)
        if cfg_s.ci.k != rank or cfg_s.ci_t.holes_up_k.shape[1] != rank:
            _fail(f'synthetic CI expansion has rank {cfg_s.ci.k}, not {rank}')
        kw = dict(n_up=79, b_ee=ones, cfg=cfg_s)
        tag = (f'synthetic CI rank {rank} n=79 n_orb=118 n_det={n_det} '
               f'W={WALKERS}')
        prev = _both(f'{tag} up block', up, state, strict=True, **kw)
        _both(f'{tag} dn block (each side fed its own up block)', dn, None,
              strict=True, prev=prev, **kw)
    # every compiled variant at the widest block the chooser gives it, W = 8
    for variant in suk.MOVE_VARIANTS:
        n = 32 * variant[0] if variant[1] else 300
        for with_ci in (False, True):
            seed_v = 700 + 10 * variant[0] + variant[1] + n
            if with_ci:
                cfg_v, (blk, _), state = _synthetic_ci_blocks(
                    torch, dev, n, n + 20, 50, 8, seed=seed_v)
                kw, sizes = dict(cfg=cfg_v), (n, n + 20, n + 20, 50, True)
            else:
                blk, state = _synthetic_block(torch, dev, n, 8, seed=seed_v)
                kw, sizes = {}, (n, n)
            shape = suk.move_shape(*sizes, optin=optin)
            if (shape.cpl, shape.rpw) != variant:
                bad.append(f'sem_move: the chooser gave {shape} at n={n}, '
                           f'not the compiled variant {variant}')
            _both(f'synthetic compiled variant {variant} '
                  f'{"with CI " if with_ci else ""}n={n} W=8 {shape}', blk,
                  state, strict=True, n_up=n, b_ee=ones, **kw)
    bad.extend(_poisoned_move(torch, dev))
    rec['sem_move'] = dict(max_abs_err=main['abs'], max_rel_err=main['rel'])
    print(f'[check] sem_move: {ties} near-tie moves in all cases; main path '
          f'(cold-start sweeps, single det and n_det = 100), over the '
          f'{main["n"]} block-walkers held per walker: max |Minv - plain| '
          f'{main["abs"]:.3e}, max per-walker |Minv - plain| / max |Minv| '
          f'{main["rel"]:.3e} (the kernels line\'s max_abs_err and '
          f'max_rel_err)')
    if bad:
        _fail('; '.join(bad))


def _poisoned_move(torch, dev):
    """One move (e = 0) on synthetic blocks at n = 79 (W = 16), single
    determinant and CI (n_orb = 118, n_det = 100): walker 0 has NaN in row
    e of Minv (its ratio is NaN), walker 1 a zero proposal (ratio 0; with
    CI row_t = Minv[e] / 0).  Both must be rejected with their whole state
    bitwise unchanged; the others agree with the plain version.  Returns
    the failures."""
    from repro_torch.core.sem import _ci_lists
    from repro_torch.kernels.sem_update.ops import sem_move
    from repro_torch.kernels.sem_update.ref import sem_move_ref
    bad = []
    W = 16
    for with_ci in (False, True):
        if with_ci:
            cfg, (blk, _), (r, sign, logdet) = _synthetic_ci_blocks(
                torch, dev, 79, 118, 100, W, seed=801)
        else:
            cfg = None
            blk, (r, sign, logdet) = _synthetic_block(torch, dev, 79, W,
                                                      seed=802)
        minv = blk['minv'].contiguous().clone()
        minv[0, 0] = float('nan')
        v = blk['phi'][:, 0].clone()
        v[1] = 0.0
        rp, lu = blk['r_prop'][:, 0].contiguous(), blk['logu'][:, 0]
        d_jas = torch.zeros(W, device=dev)
        outs = []
        for kernel in (True, False):
            P = rdet = ci = None
            if with_ci:
                holes, parts = _ci_lists(cfg, 'up', kernel)
                P, rdet = blk['P'].clone(), blk['rdet'].clone()
                ci = (blk['r_other'].contiguous(), holes, parts,
                      cfg.ci_t.coeffs)
            st = (r.clone(), minv.clone(), sign.clone(), logdet.clone(), P,
                  rdet)
            acc = torch.empty((1, W), dtype=torch.bool, device=dev)
            mar = torch.empty((1, W), device=dev)
            if kernel:
                st = sem_move(st, v, rp, d_jas, lu, 0, 0, acc, mar, ci)
            else:
                st, acc[0], mar[0] = sem_move_ref(st, v, rp, d_jas, lu, 0, 0,
                                                  ci)
            outs.append((st, acc[0]))
        torch.cuda.synchronize()
        (st_k, a_k), (st_p, a_p) = outs
        before = (r, minv, sign, logdet) + ((blk['P'], blk['rdet'])
                                            if with_ci else ())
        # bit patterns: walker 0's NaN row must come back as it was
        kept = all(torch.equal(x[:2].contiguous().view(torch.int32),
                               y[:2].contiguous().view(torch.int32))
                   for x, y in zip(st_k[:len(before)], before))
        tag = 'CI ' if with_ci else ''
        ok_rest = (torch.equal(a_k[2:], a_p[2:]) and float(
            _rel(st_k[1][2:], st_p[1][2:]).max()) <= 1e-5)
        print(f'[check] sem_move {tag}poisoned move (walker 0 NaN row e, '
              f'walker 1 ratio 0): rejected {not bool(a_k[:2].any())}, '
              f'state of both bitwise unchanged {kept} (Minv, r, sign, '
              f'logdet{", P, rdet" if with_ci else ""}); the other walkers '
              f'match the plain version {ok_rest} ({int(a_k[2:].sum())}/'
              f'{W - 2} accepted)')
        if a_k[:2].any() or not kept or not ok_rest:
            bad.append(f'sem_move {tag}poisoned move')
    return bad


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
    from repro_torch.kernels.fused_sweep import kernel as fsk
    from repro_torch.kernels.multidet_ratio import kernel as mrk
    from repro_torch.kernels.sem_update import kernel as suk
    from repro_torch.kernels.sparse_mo import kernel as smk
    from repro_torch.kernels.screened_mo import kernel as sck
    return {'sparse_mo': smk.COUNTER, 'sem_update': suk.COUNTER,
            'sem_move': suk.MOVE_COUNTER, 'fused_sweep': fsk.COUNTER,
            'multidet_ratio': mrk.COUNTER, 'screened_mo': sck.COUNTER}


def _cli_args(method, steps, blocks, seed, system, extra):
    return ['--system', system, '--method', method,
            '--walkers', str(WALKERS), '--workers', '1',
            '--steps', str(steps), '--blocks', str(blocks),
            '--backend', 'thread', '--seed', str(seed),
            '--wall-clock', '300', *extra]


def _run_cli(method: str, steps: int, blocks: int, needs, seed: int,
             extra=(), system: str = SYSTEM, forbid=(), reservoir=None):
    """One ``qmc_run`` run; fails unless it ends with a finite energy, every
    kernel in ``needs`` launched and none in ``forbid``.  ``reservoir`` =
    (walkers, energies) numpy: the run resumes from it, stored first in a
    fresh result database under the run's key (the reference's restart
    path, paper §V.D), instead of a cold start."""
    from repro_torch.launch import qmc_run
    args = _cli_args(method, steps, blocks, seed, system, extra)
    if reservoir is not None:
        from repro_torch.launch.spec import spec_run_key
        from repro_torch.runtime import ResultDatabase
        from repro_torch.systems import build_system
        db = ROOT / 'build' / 'chip_smoke' / f'{system}-{method}.sqlite'
        db.parent.mkdir(parents=True, exist_ok=True)
        db.unlink(missing_ok=True)
        args += ['--db', str(db)]
        spec = qmc_run.parse_spec(args)
        store = ResultDatabase(str(db))
        store.save_reservoir(spec_run_key(spec, *build_system(
            system, screen_eps=spec.screening_eps(), device=spec.device)),
            *reservoir)
        store.close()
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    avg = qmc_run.main(args)
    launches = {k: c.n for k, c in counters.items()}
    secs = time.perf_counter() - t0
    label = ' '.join((method, *extra) if system == SYSTEM
                     else (system, method, *extra))
    print(f'[{label}] {avg} in {secs:.1f} s; launches {launches}')
    if not (avg.n_blocks >= blocks and math.isfinite(avg.energy)):
        _fail(f'{label}: no finite energy from {avg.n_blocks} blocks')
    for k in needs:
        if launches[k] <= 0:
            _fail(f'{label}: kernel {k} was never launched on the path')
    for k in forbid:
        if launches[k] != 0:
            _fail(f'{label}: kernel {k} was launched {launches[k]} times '
                  f'on a path that must not take it')
    return launches


def _finite_pool(torch, dev, cfg, params, first: int = 3, tries: int = 6):
    """WALKERS finite cold-start walkers of (cfg, params): the cold starts
    ``qmc_run`` draws for worker 0 of run seeds ``first``, ``first`` + 1,
    ..., pooled with their dead walkers dropped (a walker with an electron
    outside every AO cutoff has log psi = -inf; neither package redraws
    it, ROADMAP Queue C).  Prints each seed's dead walkers.  Returns
    (positions (W, n_e, 3), local energies (W,))."""
    from repro_torch.core.vmc import VMCPropagator
    from repro_torch.runtime.samplers import worker_seed
    prop = VMCPropagator(cfg)
    rs, es = [], []
    for seed in range(first, first + tries):
        gen = torch.Generator(device=dev)
        gen.manual_seed(worker_seed(seed, 0))
        ens = prop.init(params, gen, WALKERS)
        ok = torch.isfinite(ens.log_psi) & torch.isfinite(ens.e_loc)
        print(f'[cold start] {BSTRAND} eps={SCREEN_EPS:g} seed {seed}: '
              f'{int((~ok).sum())} of {WALKERS} walkers not finite')
        rs.append(ens.r[ok])
        es.append(ens.e_loc[ok])
        if sum(len(r) for r in rs) >= WALKERS:
            return torch.cat(rs)[:WALKERS], torch.cat(es)[:WALKERS]
    _fail(f'fewer than {WALKERS} finite walkers in {tries} cold starts')


def phase_fused_vs_permove(torch, dev, seed: int, n_det: int = 1,
                           near: float = 1e-3):
    """One fused-vmc sweep (CUDA fused_sweep kernel) and one sem-vmc sweep
    (per move: the CUDA sem_move kernel, CI included) from the same
    state under the same injected draws: accept decisions identical,
    walker by walker up to its first move whose margin is within ``near``
    of 0 on either side (the margin of ``phase_card_vs_cpu``: the two paths
    round the e-e Jastrow delta and the inverse updates differently),
    asserted on the walkers in ``FP32_SCOPE`` (fresh fp32 inverses of both
    spin blocks within 1e-5 of fp64; with CI also both tables, both
    ratio vectors and the CI sum S), at least half the walkers (a quarter
    with CI); the others are printed.  With ``n_det > 1`` the fused down
    block reads the determinant ratios the kernel wrote in the up block,
    so a wrong write-back shows here."""
    from repro_torch.core.sem import SEMVMCPropagator, SEMState, _fused_cfg
    from repro_torch.core.sem import draw_sweep
    from repro_torch.core.wavefunction import (_mo_tensor_ensemble,
                                               _slater_blocks)
    cfg, params, ens = _finite_cold_start(torch, dev, seed, n_det)
    Cw, _ = _mo_tensor_ensemble(cfg, params, ens.r)
    scope = torch.ones(WALKERS, dtype=torch.bool)
    inv64 = {}
    for f, blk in zip(('up', 'dn'), _slater_blocks(cfg, Cw)):
        inv64[f] = torch.linalg.inv(blk[..., 0].double())
        scope &= _rel(getattr(ens, f'minv_{f}'), inv64[f]) <= FP32_SCOPE
    if n_det > 1:
        # the CI state the decisions read: the tables, the ratios and
        # their sum S, whose cancellation can amplify rounding into log|S|
        from repro_torch.core import multidet
        from repro_torch.core.wavefunction import _ci_blocks
        ci, r64 = cfg.ci_t, {}
        for f, blk in zip(('up', 'dn'), _ci_blocks(cfg, Cw)):
            p64 = multidet.reference_table(blk[..., 0].double(), inv64[f])
            r64[f] = multidet.det_ratios(p64, getattr(ci, f'holes_{f}'),
                                         getattr(ci, f'parts_{f}'))
            scope &= _rel(getattr(ens, f'p_{f}'), p64) <= FP32_SCOPE
            scope &= _rel(getattr(ens, f'rdet_{f}'), r64[f]) <= FP32_SCOPE
        s64 = multidet.ci_sum(ci.coeffs.double(), r64['up'], r64['dn'])
        s32 = multidet.ci_sum(ci.coeffs, ens.rdet_up, ens.rdet_dn)
        scope &= _rel(s32, s64) <= FP32_SCOPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(81)
    draws = draw_sweep(gen, ens.r)
    state = SEMState(ens=ens, sweeps=0)
    acc, mar = {}, {}
    for label, c in (('per-move', cfg), ('fused', _fused_cfg(cfg))):
        *_, acc[label], mar[label] = SEMVMCPropagator(c).sweep(
            params, state, None, draws)
    torch.cuda.synchronize()
    same = (acc['fused'] == acc['per-move']).cpu()          # (n_e, W)
    tie = (torch.minimum(mar['fused'].abs(), mar['per-move'].abs())
           < near).cpu()
    stop = torch.cumsum(tie.to(torch.int32), dim=0) > 0
    ok_w = (same | stop).all(dim=0)
    compared = int((~stop[:, scope]).sum())
    n_in = int(scope.sum())
    tag = f' n_det={n_det}' if n_det > 1 else ''
    print(f'[fused vs per-move{tag}] one sweep at W={WALKERS} under the same '
          f'draws: {n_in} walkers in scope; accepts identical up to the '
          f'first near tie in {int(ok_w[scope].sum())} of them '
          f'({compared}/{same[:, scope].numel()} moves compared), out of '
          f'scope {int(ok_w[~scope].sum())} of {int((~scope).sum())}; '
          f'accept rate fused {float(acc["fused"].float().mean()):.4f}, '
          f'per-move {float(acc["per-move"].float().mean()):.4f}; '
          f'{int(tie.sum())} moves within {near} of the threshold')
    if n_in < WALKERS // (2 if n_det == 1 else 4) or not bool(
            ok_w[scope].all()):
        _fail(f'fused and per-move sweeps{tag} disagree on walkers in '
              f'scope')


def phase_sem_drift(torch, dev, method: str = 'sem-vmc'):
    """Maintained inverses after 7 sweeps (< sem_refresh = 8) of ``method``
    (sem-vmc or fused-vmc) against a fresh slogdet/inverse of the same
    configuration (DESIGN.md §6).

    Asserted per walker (max |dM| relative to the walker's max |M|,
    logdet relative, sign equal) on the walkers in ``FP32_SCOPE``: those
    whose fresh fp32 inverse agrees with an fp64 inverse of the same fp32
    matrices.  Printed for every walker: the reference's own metric (max
    |dM| over the ensemble relative to its max |M|, ``tests/test_sem.py``)
    and the readings of the walkers out of scope."""
    from repro_torch.core.driver import EnsembleDriver, make_propagator
    from repro_torch.core.sem import evaluate_sem
    from repro_torch.core.wavefunction import (_mo_tensor_ensemble,
                                               _slater_blocks)
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    prop = make_propagator(method, cfg, tau=0.3)
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
        print(f'[{method} drift] {f} after 7 sweeps, all {WALKERS} walkers: '
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
    print(f'[{method} drift] {n_in} of {WALKERS} walkers in scope (fresh fp32 '
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


def _pr15_move(state, v_all, r_new, d_jas, logu, e, j, acc, margin, ci=None,
               **launch):
    """A move as PR 15's sweep made it, in place of ``ops.sem_move`` (its
    arguments and results): the ratio, the logs, the margin, u, the row
    and the state updates as separate PyTorch launches around the first
    designs' two kernels, ``sem_update`` (the update) and, with CI of rank
    <= 2, ``multidet_ratio`` (higher ranks: their plain version).  Only
    ``phase_layers`` takes it, to time the sweep of the previous
    composition in the same run; log u comes taken once a block (PR 15
    took it each move: two launches a move fewer here)."""
    import torch
    from repro_torch.kernels.multidet_ratio.ops import multidet_ratios
    from repro_torch.kernels.multidet_ratio.ref import multidet_ratios_ref
    from repro_torch.kernels.sem_update.ops import sem_rank1_update
    r, minv, sign, logdet, P, rdet = state
    phi = v_all[:, :minv.shape[-1]]
    m_e = minv[:, e, :]
    ratio = torch.sum(m_e * phi, dim=-1)
    log_ratio = torch.log(torch.abs(ratio) + 1e-30)
    if ci is not None:
        r_other, holes, parts, coeffs = ci
        g_vec = torch.einsum('woh,wh->wo', P, phi) - v_all
        row_t = m_e / ratio[:, None]
        if holes.shape[-1] == 2:
            rdet_new, S_new = multidet_ratios(P, g_vec, row_t, holes, parts,
                                              coeffs, r_other)
        else:
            rdet_new, S_new = multidet_ratios_ref(
                P, g_vec, row_t, holes.long(), parts.long(), coeffs, r_other)
        S_old = torch.sum(coeffs * rdet * r_other, dim=-1)
        log_ci = (torch.log(torch.abs(S_new) + 1e-30)
                  - torch.log(torch.abs(S_old) + 1e-30))
        mar = 2.0 * (log_ratio + log_ci + d_jas) - logu
        accept = (mar > 0) & (torch.abs(ratio) > 1e-20)
    else:
        mar = 2.0 * (log_ratio + d_jas) - logu
        accept = mar > 0
    u_vec = torch.bmm(minv, phi[:, :, None])[..., 0]
    safe = torch.where(torch.abs(ratio) > 1e-20, ratio,
                       torch.ones_like(ratio))
    row = m_e / safe[:, None]
    minv = sem_rank1_update(minv, u_vec, row, accept, e)
    r[:, j] = torch.where(accept[:, None], r_new, r[:, j])
    logdet = logdet + torch.where(accept, log_ratio,
                                  torch.zeros_like(log_ratio))
    sign = sign * torch.where(accept, torch.sign(ratio),
                              torch.ones_like(ratio))
    if ci is not None:
        P = torch.where(accept[:, None, None],
                        P - g_vec[:, :, None] * row[:, None, :], P)
        rdet = torch.where(accept[:, None], rdet_new, rdet)
    acc[e] = accept
    margin[e] = mar
    return r, minv, sign, logdet, P, rdet


def phase_layers(torch, dev, pool):
    """Wall time, device-busy time and the heaviest kernels of one vmc
    step, one sem-vmc sweep and one fused-vmc sweep at the main path's
    shapes (``smallest``), one sem-vmc --n-det 100 sweep, and of a screened
    vmc step and fused-vmc sweep and an unscreened vmc step on the b-strand
    (from the finite walkers ``pool``), in the same run, with the launches
    issued a move (issued / n_e); both sem-vmc sweeps also with each move
    made as PR 15 made it (``_pr15_move`` in place of ``ops.sem_move``), in
    the order new, PR 15, PR 15, new; the b-strand's fused-vmc sweep also
    with the kernel forced to its first design (the shared route at its
    tuned threads per block), to set the two designs side by side end to
    end."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.driver import Population, make_propagator
    from repro_torch.core.vmc import VMCPropagator
    from repro_torch.kernels.fused_sweep import autotune
    from repro_torch.kernels.sem_update import ops as su_ops
    from repro_torch.systems import build_system
    tuned = autotune.best_launch
    move = su_ops.sem_move

    def _first_design(n_e, W, *a, **k):
        return {'route': 'shared', 'threads': autotune.best_threads(n_e, W)}
    cfg, params = build_system(SYSTEM, device=dev)
    cfg_ci, params_ci = build_system(SYSTEM, n_det=100, device=dev)
    cfg_s, params_s = build_system(BSTRAND, screen_eps=SCREEN_EPS,
                                   device=dev)
    cfg_u, params_u = build_system(BSTRAND, device=dev)
    walkers = pool.cpu().numpy()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    pop = Population()
    tag = f'{BSTRAND} eps={SCREEN_EPS:g}'
    old = ', each move as PR 15 made it'
    sem_cells = []
    for tag_s, c, pp in (('', cfg, params), (' --n-det 100', cfg_ci,
                                             params_ci)):
        lab = f'sem-vmc{tag_s} sweep at W={WALKERS}'
        sem_cells += [(lab + sfx, make_propagator('sem-vmc', c), pp, None)
                      for sfx in ('', old, old, '')]
    for label, prop, p, w in (
            (f'vmc step at W={WALKERS}', VMCPropagator(cfg, tau=0.01),
             params, None),
            *sem_cells,
            (f'fused-vmc sweep at W={WALKERS}',
             make_propagator('fused-vmc', cfg), params, None),
            (f'{tag} vmc step', VMCPropagator(cfg_s, tau=0.01), params_s,
             walkers),
            (f'{tag} fused-vmc sweep', make_propagator('fused-vmc', cfg_s),
             params_s, walkers),
            (f'{tag} fused-vmc sweep, fused_sweep forced to its first '
             f'design', make_propagator('fused-vmc', cfg_s), params_s,
             walkers),
            (f'{BSTRAND} unscreened vmc step', VMCPropagator(cfg_u, tau=0.01),
             params_u, walkers)):
        gen.manual_seed(5)       # the cells of one kind start alike
        autotune.best_launch = (_first_design if 'first design' in label
                                else tuned)
        su_ops.sem_move = _pr15_move if old in label else move
        try:
            st = prop.init(p, gen, WALKERS, w)
            st, _ = prop.propagate(p, st, gen, pop)        # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                st, _ = prop.propagate(p, st, gen, pop)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            autotune.best_launch = tuned
            su_ops.sem_move = move
        busy = _device_ms(prof)
        rows = sorted(prof.key_averages(), key=lambda e: -_dev_us(e))
        top = ', '.join(f'{e.key[:40]} {_dev_us(e) / 1e3:.3f} ms '
                        f'x{e.count}' for e in rows[:5])
        # completeness: device records against the runtime's launches and
        # async copies (the profiler has dropped records in a long run)
        issued = sum(e.count for e in rows if e.key in (
            'cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
            'cuLaunchKernelEx', 'cudaMemcpyAsync', 'cudaMemsetAsync'))
        recorded = sum(e.count for e in rows if _dev_us(e) > 0)
        # the MO-product kernels (mo_tile::tile_kernel<...Source>)
        mo = [e for e in rows if 'tile_kernel' in e.key]
        mo_ms = sum(_dev_us(e) for e in mo) / 1e3
        per = {}
        for name in ('fused_sweep', 'sem_move'):
            ks = [e for e in rows if name in e.key and _dev_us(e) > 0]
            per[name] = (f'{name} {sum(_dev_us(e) for e in ks) / 1e3:.3f} '
                         f'ms x{sum(e.count for e in ks)}')
        print(f'[layer] {label}: wall {wall:.2f} ms, device '
              f'busy {busy:.2f} ms (idle {100 * (1 - busy / wall):.1f} %; '
              f'{recorded} device records for {issued} launches and '
              f'copies issued, {issued / prop.cfg.n_elec:.1f} a move); MO '
              f'product {mo_ms:.3f} ms x{sum(e.count for e in mo)}; '
              f'{per["fused_sweep"]}; {per["sem_move"]}; top: {top}')
    # the host clock alone (no profiler), the two compositions in turns
    for tag_s, c, pp in (('', cfg, params), (' --n-det 100', cfg_ci,
                                             params_ci)):
        prop = make_propagator('sem-vmc', c)
        gen.manual_seed(5)
        st = prop.init(pp, gen, WALKERS)
        walls = {'new': [], 'PR 15': []}
        try:
            for i in range(7):
                for comp in (('new', 'PR 15') if i % 2 else ('PR 15', 'new')):
                    su_ops.sem_move = move if comp == 'new' else _pr15_move
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    prop.propagate(pp, st, gen, pop)
                    torch.cuda.synchronize()
                    if i:                          # round 0 warms up
                        walls[comp].append((time.perf_counter() - t0) * 1e3)
        finally:
            su_ops.sem_move = move
        print(f'[layer wall] sem-vmc{tag_s} sweep at W={WALKERS}, host clock '
              f'without the profiler, 6 sweeps of each composition in '
              f'turns from one state: ' + '; '.join(
                  f'{k} median {statistics.median(v):.2f} ms, min '
                  f'{min(v):.2f} ms ({", ".join(f"{x:.1f}" for x in v)})'
                  for k, v in walls.items()))


def _union_stats(torch, mask, order):
    """'mean m, p90 p, max x' of the AO rows a tile of the kernels needs
    (the union of its electrons' active sets) in ``order``."""
    from repro_torch.kernels import mo_tile
    u = mo_tile.tile_unions(mask, order).double()
    return (f'mean {float(u.mean()):.1f}, p90 {float(u.quantile(0.9)):.0f}, '
            f'max {int(u.max())}')


def phase_timing(torch, dev, rec, launches):
    from repro_torch.kernels import mo_tile
    from repro_torch.kernels.sem_update.kernel import sem_update_inplace
    from repro_torch.kernels.sem_update.ref import sem_update_ref
    from repro_torch.kernels.sparse_mo import kernel as smk
    from repro_torch.kernels.sparse_mo.ops import sparse_mo_rows
    from repro_torch.kernels.sparse_mo.ref import sparse_mo_rows_ref
    rows = []

    A, B, mask, key = rec['sparse_mo']['inputs']
    n_orb, n_ao = A.shape
    N = B.shape[0]
    At = mo_tile.transposed(A)
    order = mo_tile.electron_order(key, N)
    # the ops call (the sort included), the kernel alone, the sort alone
    ms, ms_wall = _time_ms(lambda: sparse_mo_rows(A, B, mask, key))
    kern, _ = _time_ms(lambda: smk.sparse_mo_rows(At, B, mask, order, n_orb))
    sort, _ = _time_ms(lambda: mo_tile.electron_order(key, N))
    plain, _ = _time_ms(lambda: sparse_mo_rows_ref(A, B, mask, order))
    # the library call: the dense product of A and the (n_ao, 5N) block
    B2d = B.transpose(0, 1).reshape(n_ao, N * 5).contiguous()
    lib, _ = _time_ms(lambda: torch.matmul(A, B2d))
    # what this data needs: each electron's active AOs only
    nnz = float(rec['sparse_mo']['count'].sum())
    flops = 2.0 * n_orb * 5.0 * nnz
    nbytes = 4.0 * (n_orb * n_ao + 5.0 * nnz + n_orb * N * 5)
    bound, by = _bound_ms(nbytes, flops)
    dense_gflop = 2.0 * n_orb * n_ao * N * 5 / 1e9
    print(f'[time] sparse_mo (device, {SYSTEM} W={WALKERS}): {ms:.4f} ms '
          f'ops call (host {ms_wall:.4f}; the nearest-atom sort '
          f'{sort:.4f}), {kern:.4f} ms kernel alone, {plain:.4f} ms plain, '
          f'{lib:.4f} ms torch.matmul dense; bound {bound:.4f} ms ({by}: '
          f'{flops / 1e9:.3f} GFLOP, {nbytes / 1e9:.4f} GB; dense would be '
          f'{dense_gflop:.3f} GFLOP); {flops / kern / 1e9:.2f} TFLOP/s '
          f'achieved by the kernel; mean active AOs/electron {nnz / N:.1f} '
          f'of {n_ao}; AO rows per {mo_tile.TE}-electron tile: sorted '
          f'{_union_stats(torch, mask, order)}, walker-major '
          f'{_union_stats(torch, mask, torch.arange(N, device=dev))}; plan '
          f'{smk.plan(n_orb, n_ao)}')
    rows.append(dict(
        name='sparse_mo', route='cuda',
        source='src/repro_torch/csrc/sparse_mo.cu',
        replaces='src/repro/kernels/sparse_mo/kernel.py:53',
        launches=launches['sparse_mo'],
        max_abs_err=rec['sparse_mo']['max_abs_err'], ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=lib))

    # the layout copy the kernel path no longer makes
    t_tr, _ = _time_ms(lambda: B.transpose(0, 1).contiguous())
    print(f'[time] B2d transpose (N, n_ao, 5) -> (n_ao, N, 5): not made on '
          f'the kernel path any more (the kernel reads the AO pass\'s rows); '
          f'it would take {t_tr:.4f} ms for {B.numel() * 4 / 1e6:.1f} MB')
    del B2d

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
    print(f'[time] sem_update (device): {ms:.4f} ms kernel (host '
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
    rows.append(_time_sem_move(torch, rec, launches))
    rows.append(_time_fused_sweep(torch, rec, launches))
    rows.append(_time_multidet_ratio(torch, rec, launches))
    rows.append(_time_screened_mo(torch, rec, launches))
    return rows


def _time_sem_move(torch, rec, launches):
    """One sem_move launch (a move of all walkers, W = 256) on the main
    path's cold-start state: smallest at n = 79 (the kernels line's row),
    with CI at n_det = 100 (n_orb = 118) and the b-strand's n = 217 (both
    printed); each beside its plain version on the card, the PyTorch calls
    that do the most of it (torch.bmm for u, torch.baddbmm for the update,
    with CI the einsum of the table pass; no single call does the move)
    and the bound from the move's own accepts."""
    from repro_torch.kernels.fused_sweep.ref import _ee_sum
    from repro_torch.kernels.sem_update import kernel as suk
    from repro_torch.kernels.sem_update.ops import sem_move
    from repro_torch.kernels.sem_update.ref import sem_move_ref
    out = {}
    cases = [('smallest', rec['sem_move_1'], False),
             ('CI', rec['sem_move_100'], True)]
    if 'fused_sweep_bstrand' in rec:
        cases.append((BSTRAND, rec['fused_sweep_bstrand'], False))
    for label, (cfg, params, blk, ens), with_ci in cases:
        e = j = 0
        W, n, _ = blk['minv'].shape
        v = blk['phi'][:, e]
        rp = blk['r_prop'][:, e].contiguous()
        b_ee = params.jastrow.b_ee
        d_jas = (_ee_sum(ens.r, j, rp, cfg.n_up, b_ee)
                 - _ee_sum(ens.r, j, ens.r[:, j], cfg.n_up, b_ee)
                 + blk['en'][:, e]).contiguous()
        lu = blk['logu'][:, e]
        src = [ens.r, blk['minv'], ens.sign, ens.logdet]
        ci = ci_p = None
        if with_ci:
            src += [blk['P'], blk['rdet']]
            ci_t = cfg.ci_t
            ro = blk['r_other'].contiguous()
            ci = (ro, ci_t.holes_up_k, ci_t.parts_up_k, ci_t.coeffs)
            ci_p = (ro, ci_t.holes_up, ci_t.parts_up, ci_t.coeffs)
        bufs = [x.clone().contiguous() for x in src]
        acc = torch.empty((1, W), dtype=torch.bool, device=v.device)
        mar = torch.empty((1, W), device=v.device)

        def _restore():
            for b, x in zip(bufs, src):
                b.copy_(x)

        def _state():
            return tuple(bufs) + ((None, None) if not with_ci else ())

        def _kernel():
            _restore()
            sem_move(_state(), v, rp, d_jas, lu, e, j, acc, mar, ci)
        _kernel()
        torch.cuda.synchronize()
        n_acc = float(acc.sum())
        ms, wall = _time_ms(_kernel, iters=50, minus=_restore)
        plain, _ = _time_ms(lambda: sem_move_ref(
            (ens.r.clone(), *src[1:], *(() if with_ci else (None, None))),
            v, rp, d_jas, lu, e, j, ci_p), iters=20)
        minv, phi = blk['minv'], v[:, :n].contiguous()
        row = minv[:, e].contiguous()

        def _library():
            u = torch.bmm(minv, phi[:, :, None])
            torch.baddbmm(minv, u, row[:, None, :], alpha=-1.0)
            if with_ci:
                torch.einsum('woh,wh->wo', blk['P'], phi)
        lib, _ = _time_ms(_library, iters=50)
        n_cols = v.shape[1]
        n_orb = blk['P'].shape[1] if with_ci else 0
        n_det = blk['rdet'].shape[1] if with_ci else 0
        # each input read once, each output written once: Minv (and P) of
        # every walker read, of the accepted ones written; v, the move's
        # vectors; with CI the ratios read and, accepted, written
        nbytes = 4.0 * (W * n * n + n_acc * n * n + W * n_cols + 8 * W
                        + (W + n_acc) * n_orb * n
                        + (3 * W + n_acc) * n_det)
        flops = 2.0 * W * (n * n + n_orb * n) + 2.0 * n_acc * (n * n
                                                                 + n_orb * n)
        bound, by = _bound_ms(nbytes, flops)
        shape = suk.move_shape(n, n_cols, n_orb, n_det, with_ci,
                               optin=suk.device_optin(v.device))
        print(f'[time] sem_move {label} (device, one move, W={W}, n={n}'
              + (f', n_orb={n_orb}, n_det={n_det}' if with_ci else '')
              + f', {int(n_acc)}/{W} accepted): {ms:.4f} ms kernel (host '
              f'{wall:.4f} with the state copy), {shape}; {plain:.4f} ms '
              f'plain; {lib:.4f} ms torch.bmm (u) + torch.baddbmm (the '
              f'update)' + (' + the einsum of the table pass' if with_ci
                           else '')
              + f' (no single library call does the move); bound '
              f'{bound:.4f} ms ({by}: {nbytes / 1e6:.3f} MB, '
              f'{flops / 1e9:.4f} GFLOP)')
        out[label] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                          library_ms=lib)
    row = out['smallest']
    return dict(
        name='sem_move', route='cuda',
        source='src/repro_torch/csrc/sem_move.cu',
        replaces='src/repro/kernels/sem_update/kernel.py:50 + '
                 'src/repro/kernels/multidet_ratio/kernel.py:60',
        launches=launches['sem_move'],
        max_abs_err=rec['sem_move']['max_abs_err'],
        max_rel_err=rec['sem_move']['max_rel_err'], **row,
        ci_ms=out['CI']['ms'], ci_plain_ms=out['CI']['plain_ms'],
        ci_bound_ms=out['CI']['bound_ms'],
        ci_library_ms=out['CI']['library_ms'],
        **({'bstrand_ms': out[BSTRAND]['ms'],
            'bstrand_plain_ms': out[BSTRAND]['plain_ms'],
            'bstrand_bound_ms': out[BSTRAND]['bound_ms'],
            'bstrand_library_ms': out[BSTRAND]['library_ms']}
           if BSTRAND in out else {}))


def _time_screened_mo(torch, rec, launches):
    """screened_mo at the main path's inputs (b-strand, W = 256, eps =
    1e-8, cold start): the ops call (the sort included) and the kernel
    alone, its plain version, and the library call it is meant to beat:
    torch.matmul of A against the dense unscreened B2d of the same
    electrons."""
    from repro_torch.core import aos
    from repro_torch.kernels import mo_tile
    from repro_torch.kernels.screened_mo import kernel as sck
    from repro_torch.kernels.screened_mo.ops import screened_mo_products
    from repro_torch.kernels.screened_mo.ref import screened_mo_ref
    R, A, Bp, idx, active, count, key = rec['screened_mo']['inputs']
    n_orb, n_ao = A.shape
    N, K = idx.shape
    At = mo_tile.transposed(A)
    order = mo_tile.electron_order(key, N)
    ms, ms_wall = _time_ms(lambda: screened_mo_products(A, Bp, idx, active,
                                                        key))
    kern, _ = _time_ms(lambda: sck.screened_mo_matmul(At, Bp, idx, active,
                                                      order, n_orb))
    sort, _ = _time_ms(lambda: mo_tile.electron_order(key, N))
    plain, _ = _time_ms(lambda: screened_mo_ref(A, Bp, idx, active),
                        iters=5, warmup=1)
    unions = _union_stats(torch, mo_tile.packed_mask(idx, active, n_ao),
                          order)
    # the dense unscreened AO block of the same electrons (2.1 GB)
    B, _ = aos.eval_ao_block(aos.basis_tensors(
        rec['screened_mo']['basis'], A.device), rec['screened_mo']['coords'],
        R.reshape(-1, 3))
    B2 = B.reshape(n_ao, N * 5)
    del B
    lib, lib_wall = _time_ms(lambda: torch.matmul(A, B2), iters=10)
    # the library call's result against the kernel's: they differ by the
    # AO values the eps cutoffs drop (bounded by eps |poly| per value)
    C_lib = torch.matmul(A, B2).reshape(n_orb, N, 5)
    C_k = sck.screened_mo_matmul(At, Bp, idx, active, order, n_orb)
    torch.cuda.synchronize()
    lib_rel = float((C_lib - C_k).abs().max() / C_k.abs().max())
    del B2, C_lib, C_k
    torch.cuda.empty_cache()
    nnz = float(count.sum())
    flops = 2.0 * n_orb * 5.0 * nnz
    # each input read once (A, the active Bp values, idx, the mask), C
    # written once
    nbytes = (4.0 * (n_orb * n_ao + 5.0 * nnz + N * K + n_orb * N * 5)
              + N * K)
    bound, by = _bound_ms(nbytes, flops)
    dense_gflop = 2.0 * n_orb * n_ao * N * 5 / 1e9
    print(f'[time] screened_mo (device, {BSTRAND} W={WALKERS} '
          f'eps={SCREEN_EPS:g}): {ms:.4f} ms ops call (host {ms_wall:.4f}; '
          f'the nearest-atom sort {sort:.4f}), {kern:.4f} ms kernel alone, '
          f'{plain:.4f} ms plain, {lib:.4f} ms torch.matmul of A against '
          f'the dense B2d ({dense_gflop:.1f} GFLOP, host {lib_wall:.4f} '
          f'ms, {dense_gflop / lib:.1f} TFLOP/s; max |C_lib - C| / max |C| '
          f'{lib_rel:.2e}, the values the eps cutoffs drop); bound '
          f'{bound:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, '
          f'{nbytes / 1e9:.4f} GB); {nnz / N:.1f} active of K={K} '
          f'candidates per electron; {flops / kern / 1e9:.2f} TFLOP/s '
          f'achieved by the kernel; AO rows per {mo_tile.TE}-electron tile: '
          f'{unions}; plan {sck.plan(n_orb, n_ao, K)}')
    return dict(
        name='screened_mo', route='cuda',
        source='src/repro_torch/csrc/screened_mo.cu',
        replaces='src/repro/kernels/screened_mo/kernel.py:61',
        launches=launches['screened_mo'],
        max_abs_err=rec['screened_mo']['max_abs_err'], ms=ms,
        plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib)


def _sm_clock_mhz() -> float:
    """The card's max SM clock (MHz), as nvidia-smi reports it."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def _time_fused_sweep(torch, rec, launches):
    """One fused_sweep launch (the up block of a sweep at the main path's
    shapes: smallest, W = 256, n = 79) at the tuned launch, its plain
    version on the card, and the largest piece one PyTorch call does: the
    torch.bmm of u = Minv phi for one move of all walkers.  Beside it, in
    the same run: the CI variant (n_det = 100) and the b-strand's up block
    (n = 217), each also through the first design (shared route at its
    tuned threads per block), and the b-strand at one and two threads a
    row; cycles a move at the card's max SM clock."""
    from repro_torch.kernels.fused_sweep.kernel import (device_card,
                                                        fused_sweep_inplace,
                                                        launch_shape)
    from repro_torch.kernels.fused_sweep.ref import fused_sweep_ref
    cfg, params, blk, ens = rec['fused_sweep']['inputs']
    launch, tables = rec['fused_sweep']['launch'], rec['fused_sweep']['tables']
    b_ee = params.jastrow.b_ee
    mhz = _sm_clock_mhz()
    card = device_card('cuda')

    def _timed(blk, ens, n_up, b_ee, ci=None, **kl):
        """(device ms, host ms with the state copy, accept flags, route,
        shape) of one launch on copies of the block's state."""
        src = [blk['minv'], ens.r, ens.sign, ens.logdet]
        if ci is not None:
            src += [blk['P'], blk['rdet']]
        bufs = [x.clone() for x in src]
        ins = [blk[k].contiguous() for k in ('phi', 'r_prop', 'en', 'logu')]

        def _restore():
            for b, x in zip(bufs, src):
                b.copy_(x)

        def _kernel():
            _restore()
            cia = None if ci is None else (bufs[4], bufs[5], *ci)
            return fused_sweep_inplace(bufs[0], ins[0], bufs[1], *ins[1:],
                                       bufs[2], bufs[3], b_ee, cia, offset=0,
                                       n_up=n_up, **kl)
        acc, _, route = _kernel()
        ms, wall = _time_ms(_kernel, minus=_restore)
        W, n, n_cols = ins[0].shape
        shape = launch_shape(
            n, n_cols, ens.r.shape[1], *(() if ci is None else (
                blk['P'].shape[1], blk['rdet'].shape[1], True)), walkers=W,
            card=card, **kl)
        return ms, wall, acc, route, shape

    def _line(label, n, ms, shape, first_ms, first_threads):
        return (f'[time] fused_sweep {label} (device, one spin block, n={n}, '
                f'W={WALKERS}): {ms:.4f} ms kernel, {ms * mhz * 1e3 / n:.0f} '
                f'cycles a move at {mhz:.0f} MHz, {shape}; first design '
                f'(route shared, {first_threads} threads/block) '
                f'{first_ms:.4f} ms, {first_ms * mhz * 1e3 / n:.0f} cycles a '
                f'move')

    ms, ms_wall, acc, route, shape = _timed(blk, ens, cfg.n_up, b_ee,
                                            **launch)
    n_acc = float(acc.sum())
    W, n, _ = blk['minv'].shape
    n_e = ens.r.shape[1]
    first_ms = _timed(blk, ens, cfg.n_up, b_ee, route='shared',
                      threads=tables)[0]

    # the CI variant at n_det = 100 (printed, not a row of its own)
    cfg_ci, _, blk_ci, ens_ci = rec.pop('fused_sweep_100')
    ci_t = cfg_ci.ci_t
    ci = (blk_ci['r_other'].contiguous(), ci_t.holes_up_k, ci_t.parts_up_k,
          ci_t.coeffs)
    ms_ci, _, _, _, shape_ci = _timed(blk_ci, ens_ci, cfg_ci.n_up, b_ee, ci,
                                      **launch)
    first_ci = _timed(blk_ci, ens_ci, cfg_ci.n_up, b_ee, ci, route='shared',
                      threads=tables)[0]
    print(_line(f'CI variant n_det={ci_t.coeffs.shape[0]} '
                f'n_orb={cfg_ci.ci.n_orb}', n, ms_ci, shape_ci, first_ci,
                tables))
    # the b-strand's up block (n = 217, W = 256; printed, not a row)
    cfg_b, params_b, blk_b, ens_b = rec.pop('fused_sweep_bstrand')
    launch_b, tables_b = rec['fused_sweep']['bstrand']
    bee_b = params_b.jastrow.b_ee
    ms_b, _, acc_b, _, shape_b = _timed(blk_b, ens_b, cfg_b.n_up, bee_b,
                                        **launch_b)
    first_b = _timed(blk_b, ens_b, cfg_b.n_up, bee_b, route='shared',
                     threads=tables_b)[0]
    n_b = blk_b['minv'].shape[1]
    print(_line(f'{BSTRAND} ({int(acc_b.sum())}/{acc_b.numel()} accepted)',
                n_b, ms_b, shape_b, first_b, tables_b))
    for t in (1, 2):
        ms_t, _, _, _, shape_t = _timed(blk_b, ens_b, cfg_b.n_up, bee_b,
                                        route='rows', per_row=t)
        print(f'[time] fused_sweep {BSTRAND} rows route at {t} thread(s) a '
              f'row: {ms_t:.4f} ms, {ms_t * mhz * 1e3 / n_b:.0f} cycles a '
              f'move, {shape_t}')
    plain, plain_wall = _time_ms(lambda: fused_sweep_ref(
        ens.r, blk['minv'], ens.sign, ens.logdet, blk['phi'], blk['r_prop'],
        blk['en'], blk['logu'], b_ee, offset=0, n_up=cfg.n_up), iters=3,
        warmup=1)
    lib, _ = _time_ms(lambda: torch.bmm(blk['minv'],
                                        blk['phi'][:, 0, :, None]),
                      iters=200)
    # each input read once, each output written once; operations: per move
    # the ratio (2n) and two e-e Pade sums over n_e (~12 flops a pair), per
    # accepted move u = Minv phi and the rank-1 update (4 n^2)
    nbytes = 4.0 * (2 * W * n * n + W * n * n + 2 * W * n_e * 3
                    + W * n * 3 + 2 * W * n + 4 * W + W * n) + W * n
    flops = W * n * (2.0 * n + 24.0 * n_e) + n_acc * 4.0 * n * n
    bound, by = _bound_ms(nbytes, flops)
    print(_line(f'{SYSTEM} (route {route})', n, ms, shape, first_ms, tables)
          + f'; host with the state copy {ms_wall:.4f} ms; {plain:.4f} ms '
          f'plain (device; host {plain_wall:.2f} ms), {lib:.4f} ms '
          f'torch.bmm of one move\'s u = Minv phi (no single library call '
          f'does the sweep); bound {bound:.4f} ms ({by}: {nbytes / 1e6:.3f} '
          f'MB, {flops / 1e9:.4f} GFLOP for {int(n_acc)}/{W * n} accepted '
          f'moves), {bound * mhz * 1e3 / n:.0f} cycles a move')
    return dict(
        name='fused_sweep', route='cuda',
        source='src/repro_torch/csrc/fused_sweep.cu',
        replaces='src/repro/kernels/fused_sweep/kernel.py:95',
        launches=launches['fused_sweep'],
        max_abs_err=rec['fused_sweep']['max_abs_err'], ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=lib,
        max_rel_err=rec['fused_sweep']['max_rel_err'],
        synthetic_max_abs_err=rec['fused_sweep']['synthetic_max_abs_err'],
        ci_ms=ms_ci, bstrand_ms=ms_b, first_design_ms=first_ms,
        first_design_ci_ms=first_ci, first_design_bstrand_ms=first_b)


def _time_multidet_ratio(torch, rec, launches):
    """multidet_ratio at the main path's move (W = 256, n_det = 100), its
    plain version, and the largest piece one PyTorch call does: the
    determinants of the gathered (W, n_det, 2, 2) blocks."""
    from repro_torch.core import multidet
    from repro_torch.kernels.multidet_ratio.kernel import multidet_ratio
    from repro_torch.kernels.multidet_ratio.ref import multidet_ratios_ref
    P, g, row, h2, p2, c, ro = rec['multidet_ratio']['inputs']
    hl, pl = h2.long(), p2.long()
    W, n_orb, n_occ = P.shape
    n_det = c.shape[0]
    ms, ms_wall = _time_ms(lambda: multidet_ratio(P, g, row, h2, p2, c, ro),
                           iters=200)
    plain, _ = _time_ms(lambda: multidet_ratios_ref(P, g, row, hl, pl, c, ro),
                        iters=50)
    T = (multidet.gather_t_blocks(multidet.extend_table(P, 2), hl, pl)
         - multidet._pad_zero_rows(g, -1, 2)[..., pl][..., :, None]
         * multidet._pad_zero_rows(row, -1, 2)[..., hl][..., None, :])
    lib, _ = _time_ms(lambda: torch.linalg.det(T), iters=50)
    # what the data needs: the table, g and row entries the lists touch
    hs, ps = h2.cpu().tolist(), p2.cpu().tolist()
    pairs = {(p, h) for hh, pp in zip(hs, ps) for p in pp for h in hh
             if p < n_orb and h < n_occ}
    g_used = {p for pp in ps for p in pp if p < n_orb}
    r_used = {h for hh in hs for h in hh if h < n_occ}
    nbytes = (4.0 * W * (len(pairs) + len(g_used) + len(r_used))
              + 20.0 * n_det + 4.0 * W * (2 * n_det + 1))
    flops = 14.0 * W * n_det
    bound, by = _bound_ms(nbytes, flops)
    print(f'[time] multidet_ratio (device, W={W}, n_det={n_det}): {ms:.4f} '
          f'ms kernel (host {ms_wall:.4f}), {plain:.4f} ms plain, {lib:.4f} '
          f'ms torch.linalg.det of the gathered 2x2 blocks (no single '
          f'library call does the gathers and the CI sum); bound '
          f'{bound:.4f} ms ({by}: {nbytes / 1e6:.3f} MB, {len(pairs)} table '
          f'entries per walker)')
    return dict(
        name='multidet_ratio', route='cuda',
        source='src/repro_torch/csrc/multidet_ratio.cu',
        replaces='src/repro/kernels/multidet_ratio/kernel.py:60',
        launches=launches['multidet_ratio'],
        max_abs_err=rec['multidet_ratio']['max_abs_err'], ms=ms,
        plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib)


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
    # the fused-sweep tuner's cache stays inside the checkout (build/)
    os.environ.setdefault('REPRO_FUSED_TILE_CACHE', str(
        ROOT / 'build' / 'repro_torch' / 'fused_sweep_tiles.json'))
    from repro_torch.device import resolve_device
    dev = resolve_device('cuda')
    t_start = time.perf_counter()

    phase_card_and_build()
    rec = {}
    phase_kernels_vs_plain(torch, dev, rec)
    seed = _cold_start_seed(torch, dev)
    # the b-strand: a cold start (dead walkers and all) for the product
    # checks, and a pool of finite cold-start walkers for the sweeps
    from repro_torch.core.sem import evaluate_sem
    from repro_torch.core.vmc import sample_positions
    from repro_torch.systems import build_system
    cfg_b, params_b = build_system(BSTRAND, screen_eps=SCREEN_EPS,
                                   device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    R_b = sample_positions(params_b, gen, WALKERS, cfg_b.n_elec)
    phase_screened_mo_vs_plain(torch, dev, rec, R_b)
    phase_screened_vs_unscreened(torch, dev, R_b)
    pool, pool_e = _finite_pool(torch, dev, cfg_b, params_b)
    phase_fused_vs_plain(torch, dev, rec, seed, bstrand=(
        cfg_b, params_b, evaluate_sem(cfg_b, params_b, pool)))
    phase_multidet_vs_plain(torch, dev, rec, seed)
    phase_sem_move_vs_plain(torch, dev, rec, seed)
    phase_card_vs_cpu(torch, dev)
    # all-electron moves of 158 electrons: tau 0.3 (the method default)
    # accepts nothing at a cold start; 0.01 lets the walkers move
    # the first designs of the per-move kernels launch on no path
    old = ('sem_update', 'multidet_ratio')
    runs = {
        'vmc': _run_cli('vmc', steps=3, blocks=2, needs=('sparse_mo',),
                        seed=seed, extra=('--tau', '0.01'), forbid=old),
        'sem-vmc': _run_cli('sem-vmc', steps=5, blocks=2,
                            needs=('sparse_mo', 'sem_move'), seed=seed,
                            forbid=old),
        'fused-vmc': _run_cli('fused-vmc', steps=5, blocks=2,
                              needs=('sparse_mo', 'fused_sweep'), seed=seed,
                              forbid=old + ('sem_move',)),
        'sem-vmc --n-det 100': _run_cli(
            'sem-vmc', steps=2, blocks=2, needs=('sparse_mo', 'sem_move'),
            seed=seed, extra=('--n-det', '100'), forbid=old),
        'fused-vmc --n-det 100': _run_cli(
            'fused-vmc', steps=5, blocks=2,
            needs=('sparse_mo', 'fused_sweep'), seed=seed,
            extra=('--n-det', '100'), forbid=old + ('sem_move',)),
    }
    # the screened slice: b-strand at eps = 1e-8, 2 blocks x 4 sub-blocks
    # x 2 steps (16 sweeps: past the sem_refresh boundary at 8), resumed
    # from the finite cold-start walkers
    reservoir = (pool.cpu().numpy(), pool_e.cpu().numpy())
    screen = ('--screen-eps', f'{SCREEN_EPS:g}')
    for method, tau, needs in (
            ('vmc', ('--tau', '0.01'), ('screened_mo',)),
            ('sem-vmc', (), ('screened_mo', 'sem_move')),
            ('fused-vmc', (), ('screened_mo', 'fused_sweep'))):
        runs[f'{BSTRAND} {method}'] = _run_cli(
            method, steps=2, blocks=2, needs=needs, seed=seed,
            extra=screen + tau, system=BSTRAND, forbid=('sparse_mo',) + old,
            reservoir=reservoir)
    phase_fused_vs_permove(torch, dev, seed)
    phase_fused_vs_permove(torch, dev, seed, n_det=100)
    phase_sem_drift(torch, dev, 'sem-vmc')
    phase_sem_drift(torch, dev, 'fused-vmc')
    launches = {k: sum(r[k] for r in runs.values()) for k in _counters()}
    print(f'[launches] main path: ' + '; '.join(f'{m} {r}'
                                                for m, r in runs.items()))
    phase_layers(torch, dev, pool)
    rows = phase_timing(torch, dev, rec, launches)
    print(f'[done] {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
