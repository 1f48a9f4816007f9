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
   and two threads a row and on the shared and global routes, at n = 528
   on the cluster route at 8 and 16 blocks a walker, at n = 866 on the
   cluster and the global routes, on a well-conditioned synthetic CI
   sweep of both
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
   walkers: every b-strand cold start has dead walkers); then ``dmc`` on
   ``smallest`` (also ``--n-det 100``) and on the screened b-strand
   (resumed from the same reservoir), each printing its mean weight,
   global weight, accept rate and sign-flip fraction; each run checks
   its launch counters: every kernel of its path ran (``sem_move`` on
   every sem-vmc run), the first designs ``sem_update`` and
   ``multidet_ratio`` on none (and, screened, ``sparse_mo`` did not; on
   a dmc run no per-move kernel); then ``smallest`` ``dmc`` on the
   ``process`` backend with one worker process and with two sharing the
   card (each must deliver blocks), blocks/s of both;
4. one fused-vmc sweep against one sem-vmc sweep under the same draws
   (single determinant and n_det = 100), and the maintained inverses of
   both methods against a fresh inverse after 7 sweeps;
   then ``[opt-vmc]``: equilibrate ``smallest`` (fused-vmc, W = 256, from
   the same cold start), hold opt-vmc's batched O = d ln|Psi| / dp on the
   card against the CPU path and an fp64 central difference (P = 3 and,
   with n_det = 100, P = 103), run ``qmc_run --method opt-vmc`` from the
   equilibrated walkers (P = 3: 3 SR steps; P = 103: 2 SR steps, then one
   linear-method step resumed from their checkpoint; tau 0.01), each
   checked for finite moments, b >= B_MIN, a unit CI tail and its launch
   counters (sparse_mo only), h2 descending by 0.02 Ha in 4 SR steps, 2
   steps on the ``process`` backend (integer version stamps), the
   ``[layer]`` rows of an opt-vmc step and block (the O pass's share, the
   host's work on a block's moments, the solver), and from the same
   walkers vmc, sem-vmc and fused-vmc energies (sem-vmc held to fused-vmc
   within 4 sigma) and the fused sweep's per-walker CI check;
   then ``[grid]``: the TCP grid backend with ``qmc_worker`` processes on
   the card, ``smallest`` fused-vmc from the equilibrated walkers (run
   1: ``qmc_run --backend grid --workers 2`` as a subprocess; run 2: the
   reference's chaos drill, 3 workers at a 0.5 s heartbeat timeout and
   10 % packet loss, worker 0 SIGKILLed and forwarder 1 killed, then an
   external ``qmc_worker --connect`` joins), ``dmc`` over the grid and
   h2 ``opt-vmc`` over the grid, each worker's closing line holding its
   kernel launches, the energies within 4 sigma of ``equilibrated
   fused-vmc``; then ``[sim]``: the simulated grid's drill (3 thread
   workers, a worker crash, a forwarder kill, 10 % packet loss) at the
   same width in this process; then ``[examples]``: the reference's two
   example drivers as ported (``examples/torch_quickstart.py`` at its own
   depth, its three MO-product paths held to each other and to the CPU,
   ``sparse_mo`` launched by the ``kernel`` path only;
   ``examples/torch_dmc_fault_tolerant.py`` event-driven on ``cuda:0``:
   crash, elastic join, graceful stop, restart from the reservoir);
   then ``[precision]``: the storage policy on ``smallest`` (sem-vmc and
   fused-vmc at fp32, bf16 and fp16, from the cold start and from the
   equilibrated walkers; fused-vmc --n-det 100 at fp32 and bf16 from
   both) and the screened b-strand fused-vmc at fp32 and bf16,
   ``PRECISION_SWEEPS`` sweeps each under the same draws: stored dtypes and bytes, the drift of the
   stored inverses against fp64 on the walkers the policy resolves at
   every storage boundary (asserted from the equilibrated walkers), the
   sweep's host-clock and device time beside fp32's, the kernel
   launches; then ``[serve]``: a ``QMCService`` on the card with a pool
   of 2 runs ``smallest`` fused-vmc --precision bf16 and h2 vmc,
   ``SERVE_BLOCKS`` blocks each, at once and one after the other, twice
   each in the order
   at once, after, after, at once (blocks/s), one extend, one fork and
   the cancel of a queued run, and a ``qmc_serve`` process takes an h2 run
   from ``qmc_client`` over TCP and is shut down; then ``[shards]``:
   walker-axis sharding, one shard against two shards of ``cuda:0`` under
   one generator seed on ``smallest`` at W = 256 (``fused-vmc``, also
   --n-det 100; ``sem-vmc``, --n-det 100 at one sweep; ``dmc``;
   ``opt-vmc`` P = 3 from the equilibrated walkers; the screened b-strand
   ``fused-vmc`` from its reservoir): one block each (BlockStats rel
   1e-5, moments 1e-4; every kernel of the method launched under shards,
   the evaluation kernel twice the single shard's count; the block wall
   of both, which on one card measures the threads and collectives, not
   scaling) and the same generations one by one under the same draws
   (decisions identical at W and W/2, ties within 1e-5 counted, walkers
   outside FP32_SCOPE excepted and printed; the largest position
   difference); ``qmc_run --shards 2`` refused on a one-card machine; a
   ``QMCManager`` on the thread backend over a sampler on [cuda:0,
   cuda:0] delivering blocks; then ``[spline]``: the ``smallest`` MOs on
   the reference's 48^3 grid (its bytes), ``interp_mo_block`` against
   the direct path (AO rows + ``sparse_mo``) at 158 and 40 448 electrons
   (CUDA events), the card's interpolation against the CPU's within 1e-5
   of the largest entry; then ``[ci rank]``: ``sem_move`` and
   ``fused_sweep`` (rows, shared and global routes) against their plain
   versions at CI excitation ranks 9, 16 and 39 (past the 8 the
   registers hold: the elimination in a device workspace) on smallest's
   CI widths, each timed beside rank 8, both kernels on unequal spin
   blocks whose lists are padded past the down block's electrons (3 up /
   2 down at rank 3, 12 / 6 at rank 10), and one sem-vmc and one
   fused-vmc block through ``core/driver.py`` with a user expansion
   holding a rank-12 excitation; then ``[paper systems]``:
   ``b-strand-tz`` (f shells), ``1ze7`` and ``1amb`` (866 up, 865 down)
   at eps = 1e-8 and W = 256: the predicted and measured peak memory of
   one evaluation (walker chunks where it would not fit), the card
   against the CPU on the 4 best conditioned of 32 finite walkers (and
   the fp64 tail on the card's MO tensor where fp64 resolves it),
   ``fused_sweep`` and ``sem_move`` against their plain versions for one
   sweep of both spin blocks on the system's walkers and, held per
   walker, on all 256 walkers of synthetic blocks of its shapes,
   ``qmc_run`` fused-vmc, sem-vmc, dmc (and vmc on ``b-strand-tz``) from
   a reservoir of finite cold-start walkers with their launch counters;
   then ``[paper systems ci]``: ``1ze7`` and ``1amb`` with
   ``--n-det 100`` (n_orb = 792, 1299) from the same reservoirs: the
   predicted and measured peak of one evaluation and of one opt-vmc O
   pass at P = 103 and P = 3 (walker chunks), the chunked O against
   unchunked calls, the screened product at the n_orb rows, O on the
   card against the CPU path at 1ze7, the fused sweep's tuner on CI
   operands, ``fused_sweep`` (the cluster route with CI and the replay of
   P after it) and ``sem_move`` with CI held per walker on synthetic
   blocks of the systems' widths, the replay alone against its plain
   version, and timed (chain, replay, total, the global route beside),
   ``qmc_run`` fused-vmc, sem-vmc, dmc (1ze7) and opt-vmc (P = 103; P = 3
   on 1amb) with the launches by route and CI (run alone, also a
   ``[layer]`` row a run);
5. profile one vmc step, one sem-vmc sweep, one sem-vmc --n-det 100
   sweep and one fused-vmc sweep (wall vs device-busy time, launches a
   move) on ``smallest``, both sem-vmc sweeps also on the host clock
   alone, and a screened vmc step and fused-vmc sweep and an
   unscreened vmc step on ``b-strand``, and one dmc generation on both
   systems (with the reconfiguration's own device time), in the same
   run;
6. time each kernel, its plain version and the library call at the main
   path's shapes, beside the bound computed from this run's inputs; for
   the two MO products the ``ops`` call (the electron sort included) and
   the kernel alone, with the AO rows a tile needs (mean, p90, max); for
   the fused sweep also the CI variant and the b-strand's block, each
   beside the first design (shared route) in the same run, in SM cycles a
   move at the card's max clock too; for ``sem_move`` one move at n = 79,
   with CI (n_det = 100) and on the b-strand (n = 217).

Prints one ``{"kernels": [...]}`` line and, last, one line naming the
device.  ``[clock]`` lines give the seconds since the start after each
group of phases.  ``python3 chip_smoke.py ci-rank paper-systems`` (or
``paper-systems-ci``, ``grid sim``, ``examples``) runs the build and the
named phases
alone (a trial of them; no result lines).
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import threading
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
# Depths cut to keep the script within its time limit as the paper
# systems joined (widths unchanged; the earlier values in brackets):
# blocks of each run of the service's two schedules (20, then 6 until
# [paper systems ci] came); blocks of each run from the equilibrated
# walkers (8); host-clock sweeps in [layer wall] (6, then 3); sweeps a
# [precision] cell (7)
SERVE_BLOCKS = 4
EQ_BLOCKS = 4
LAYER_WALL_ROUNDS = 2
# launches of the cluster route on the same inputs held bitwise equal
CLUSTER_REPEATS = 16
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


# the runtime calls that put work on the card: launches and async copies
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
               'cuLaunchKernelEx', 'cudaMemcpyAsync', 'cudaMemsetAsync')


class Trace:
    """One profile's device records, read from the profiler's raw records:
    ``busy`` (ms, the summed device time of every kernel and copy),
    ``by_name`` ({name: [ms, count]}), ``issued`` (launches and copies the
    runtime took), ``recorded`` (device records).  ``key_averages`` gives
    the same sums, but first builds an event tree, which took about a
    minute for a sem-vmc sweep of 1amb's 300 000 launches."""

    def __init__(self, prof):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.busy, self.by_name, self.issued, self.recorded = 0.0, {}, 0, 0
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == cuda:
                ms = e.duration_ns() / 1e6
                self.busy += ms
                self.recorded += 1
                x = self.by_name.setdefault(name, [0.0, 0])
                x[0] += ms
                x[1] += 1
            elif name in LAUNCH_CALLS:
                self.issued += 1

    def part(self, key: str):
        """(ms, count) of the device records whose name holds ``key``."""
        xs = [v for k, v in self.by_name.items() if key in k]
        return sum(v[0] for v in xs), sum(v[1] for v in xs)

    def top(self, k: int = 5) -> str:
        """The ``k`` heaviest names, 'name ms xcount'."""
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:k]
        return ', '.join(f'{n[:40]} {ms:.3f} ms x{c}' for n, (ms, c) in rows)


def _once_ms(torch, fn):
    """(device ms, host ms, result) of one call of ``fn`` between CUDA
    events, after a synchronise: for calls of 0.1 s and more, where
    ``_time_ms``'s repeated calls and device-side wait would take several
    times the call."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3, out


def _in_background(fn):
    """Start ``fn()``, work on the CPU only, on a thread of its own (torch's
    CPU operations release the GIL, so the card's work goes on beside it);
    returns a callable that waits for it and gives its result or raises
    its exception."""
    from concurrent.futures import ThreadPoolExecutor
    ex = ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(fn)
    ex.shutdown(wait=False)
    return fut.result


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


def _parity(torch, a, b):
    """Per walker, the card's PsiState ``a`` against the CPU's ``b``: the
    largest |diff| over its tolerance (log psi rtol 2e-6 + 1e-4; drift and
    E_L rtol 1e-4 + 1e-4 of the walker's own max; NaN counts as inf) and
    whether sign and the active AO counts are equal."""
    over = torch.zeros(b.sign.shape[0], dtype=torch.float64)
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
    return over, same


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

    over, same = _parity(torch, a, b)
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
                   near: float = 1e-5, kernel: str = 'fused_sweep',
                   held_elsewhere: str = ''):
    """Kernel (``kernel`` names it in the printed line) against plain
    version of one spin block's sweep.

    ``strict`` (well-conditioned inputs): on every walker with no move
    whose margin is within ``near`` of 0 on either side, identical accept
    decisions, equal r and sign, Minv, P and rdet within 1e-5 of the
    walker's max, logdet within ``ltol`` of max(|logdet|, 1): 1e-5 up to
    n = 256; past it, where fp32 resolves a chain's logdet more coarsely,
    the larger of 1e-5 and 3x the median over the tie-free walkers of the
    plain version's own distance from its fp64 twin (each accepted move
    adds a log|ratio| carrying the inverse's fp32 drift: at n = 866 the
    plain version sits ~2e-6 to 5e-5 from fp64).

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
      the fp64 twin (the fp32 rounding scale of these inputs);
    * at least one walker within ``FP32_SCOPE``: a comparison that holds
      no walker fails, unless ``held_elsewhere`` names the strict check
      that holds the kernel at the same shapes (the paper systems' cold
      starts, where fp32 resolves no walker's 528- to 866-move chain).

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
    bad, unheld = [], ''
    if not strict and not n_in:
        if held_elsewhere:
            unheld = (f'; no walker in FP32_SCOPE: held per walker by '
                      f'{held_elsewhere}')
        else:
            bad.append(f'{label}: no walker in FP32_SCOPE, so no decision '
                       f'or table was held per walker')
    diff = (a_k != a_p) & ~tie
    n_diff, n_diff_in = int(diff.sum()), int(diff[sc].sum())
    if n_diff_in:
        bad.append(f'{label}: {n_diff_in} accept decisions differ away '
                   f'from the threshold')
    if not (torch.equal(r_k[sc], r_p[sc]) and torch.equal(s_k[sc], s_p[sc])):
        bad.append(f'{label}: r or sign differ on walkers compared')
    dl_all = ((l_k - l_p).abs() / l_p.abs().clamp(min=1.0)).cpu().double()
    dl = float(dl_all[scope].max()) if n_in else 0.0
    l64 = out_64[3]
    dl64 = ((l_p.double() - l64.double()).abs()
            / l64.double().abs().clamp(min=1.0)).cpu()[clean]
    ltol = 1e-5
    if strict and n_clean and m_p.shape[-1] > 256:
        ltol = max(ltol, 3.0 * float(dl64.median()))
    if not dl <= ltol:
        bad.append(f'{label}: logdet past {ltol:.2e} ({dl:.3e})')
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
          f'logdet max {dl:.3e} (tol {ltol:.2e}; plain vs fp64 median '
          f'{float(dl64.median()) if n_clean else 0.0:.2e}; on all tie-free '
          f'{float(dl_all[clean].max()):.3e}); per-walker rel err over the '
          f'{n_clean} tie-free walkers (median / p95 / max) '
          + '; '.join(notes) + ' (tol 1e-5 per walker held'
          + ('' if strict else '; kernel median <= 3x plain-vs-fp64 median')
          + ')' + unheld)
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
                         W: int, seed: int, rank: int = 2, mdw=None):
    """``_synthetic_pair`` of two blocks of n electrons each (n_e = 2n)
    with a CI expansion over n_orb orbitals: ``mdw`` when given, else
    ``synthetic_ci`` for rank 2, else ``_rank_k_ci``."""
    from repro_torch.systems.bench import synthetic_ci
    if mdw is None:
        mdw = (synthetic_ci(n, n, n_orb, n_det, seed=seed) if rank == 2
               else _rank_k_ci(n, n_orb, n_det, rank, seed))
    return _synthetic_pair(torch, dev, n, n, W, seed, mdw)


def _synthetic_pair(torch, dev, n_up: int, n_dn: int, W: int, seed: int,
                    mdw=None):
    """Two well-conditioned spin blocks of n_up and n_dn electrons (n_e =
    n_up + n_dn, the down block at offset n_up): per block the occupied
    orbitals at the electrons I + 0.1 G/sqrt(n), the proposals' phi the
    electron's own column plus noise.  With a CI expansion ``mdw`` over
    mdw.n_orb orbitals also the virtual ones 0.3 G, and P and rdet built
    from them as the path builds them (``multidet.reference_table``,
    ``det_ratios``).  Returns (cfg-like namespace with ``ci``/``ci_t``,
    [up block, dn block], state)."""
    from types import SimpleNamespace
    from repro_torch.core import multidet
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def _n(*shape):
        return torch.randn(shape, generator=g, device=dev)
    ci_t = None if mdw is None else multidet.pin(mdw, n_up, n_dn, dev)
    r = 2.0 * _n(W, n_up + n_dn, 3)
    blocks, sign, logdet = [], 1.0, 0.0
    for spin, off, n in (('up', 0, n_up), ('dn', n_up, n_dn)):
        D = torch.eye(n, device=dev) + 0.1 * _n(W, n, n) / math.sqrt(n)
        minv = torch.linalg.inv(D.double()).float()          # (elec, orb)
        blk = dict(spin=spin, offset=off, minv=minv)
        if mdw is None:
            blk['phi'] = (D.transpose(1, 2)
                          + 0.3 * _n(W, n, n) / math.sqrt(n)).contiguous()
        else:
            V = 0.3 * _n(W, mdw.n_orb - n, n)          # (virtual orb, elec)
            P = multidet.reference_table(torch.cat([D, V], dim=1), minv)
            blk['P'], blk['rdet'] = P, multidet.det_ratios(
                P, getattr(ci_t, f'holes_{spin}'),
                getattr(ci_t, f'parts_{spin}'))
            blk['phi'] = torch.cat(
                [D.transpose(1, 2) + 0.3 * _n(W, n, n) / math.sqrt(n),
                 V.transpose(1, 2) + 0.1 * _n(W, n, mdw.n_orb - n)],
                dim=-1).contiguous()
        blk.update(r_prop=r[:, off:off + n] + 0.3 * _n(W, n, 3),
                   en=0.05 * _n(W, n),
                   logu=torch.log(torch.rand((W, n), generator=g, device=dev)
                                  .clamp(min=1e-6)))
        blocks.append(blk)
        sd, ld = torch.linalg.slogdet(D.double())
        sign, logdet = sign * sd, logdet + ld
    if mdw is not None:
        blocks[0]['r_other'] = blocks[1]['rdet']
        blocks[1]['r_other'] = blocks[0]['rdet']
    return (SimpleNamespace(ci=mdw, ci_t=ci_t), blocks,
            (r, sign.float(), logdet.float()))


def _held_walkers(W: int, m: int) -> list:
    """``m`` of ``W`` walkers for the plain versions to repeat: walker
    s i + (i mod s) for i < m, s = W // m, so that the subset meets every
    run of s consecutive walkers and every residue of the walker index mod
    s (a fault that depends on a walker's place in its wave of blocks
    cannot hide in one residue)."""
    s = W // m
    return [s * i + i % s for i in range(m)]


def _pair_check(torch, kernel: str, tag: str, cfg, blocks, state,
                strict: bool, *, n_up: int, b_ee, launch=None,
                held_elsewhere: str = '', plain_walkers: int = 0):
    """Both spin blocks of ``blocks`` through ``kernel`` ('fused_sweep',
    with ``launch`` when given, or 'sem_move'), its plain version and that
    version's fp64 twin, each held by ``_compare_sweep``.  Every side
    sweeps the down block from the kernel's up block: its r, sign and
    logdet and, with CI, its rdet as r_other.  With ``plain_walkers`` the
    kernel sweeps every walker and the plain version and its twin the
    ``_held_walkers`` of them (one block or cluster a walker: a walker's
    result does not depend on the others).  Returns the failures."""
    fn = _sweep_block if kernel == 'fused_sweep' else _move_block
    kw = dict(n_up=n_up, b_ee=b_ee, cfg=cfg)
    W = blocks[0]['minv'].shape[0]
    held = (torch.tensor(_held_walkers(W, plain_walkers),
                         device=blocks[0]['minv'].device)
            if plain_walkers else None)

    def _head(x):
        return (x[held] if held is not None and torch.is_tensor(x)
                and x.dim() and x.shape[0] == W else x)
    bad, r_other = [], None
    for blk in blocks:
        out_k = fn(torch, blk, state, True, r_other=r_other, **kw,
                   **(launch or {}))
        sub = {k: _head(v) for k, v in blk.items()}
        outs = [tuple(_head(x) for x in out_k)] + [
            fn(torch, sub, tuple(_head(x) for x in state), False,
               r_other=_head(r_other), dtype=dt, **kw)
            for dt in (None, torch.float64)]
        torch.cuda.synchronize()
        bad += _compare_sweep(
            torch, f'{tag} {blk["spin"]} block n={blk["minv"].shape[1]} '
            f'at offset {blk["offset"]}', *outs, strict, kernel=kernel,
            held_elsewhere=held_elsewhere)['bad']
        state, r_other = (out_k[0], out_k[2], out_k[3]), out_k[5]
        del outs
    return bad


def phase_fused_vs_plain(torch, dev, rec, seed: int, bstrand=None):
    """The fused-sweep kernel against its plain version on the card:
    main-path shapes (smallest, W = 256, n = 79, both spin blocks, a cold
    start from the run seed), all-accept and all-reject sweeps, the CI
    variant at n_det = 100; well-conditioned synthetic blocks (ratios O(1))
    at n = 79 (W = 256; rows route, also forced to the shared route), n =
    217 (rows route at the tuned threads per row and at one thread a row,
    also forced to the shared and the global routes), n = 528 (cluster
    route at 8 and 16 blocks a walker) and n = 866 (cluster route, also
    forced to the global route) at W = 8, the cluster route
    ``CLUSTER_REPEATS`` times on the same inputs (bitwise equal), and a
    synthetic CI
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
            (528, 8, (('cluster', dict(cluster=8)),
                      ('cluster', dict(cluster=16)))),
            (866, 8, (('auto', {}), ('global', first)))):
        blk, state = _synthetic_block(torch, dev, n, W, seed=n)
        for route, kl in cases:
            shape = fsk.launch_shape(n, n, 2 * n - 1, route=route,
                                     walkers=W, card=card, **kl)
            nbytes = fsk.smem_bytes(n, n, 2 * n - 1, route=route,
                                    walkers=W, card=card, **kl)
            _both(f'synthetic n={n} W={W} {shape} ({nbytes} B shared)',
                  blk, state, route=route, strict=True, klaunch=kl, n_up=n,
                  b_ee=ones)
    # the cluster route again and again on the same inputs: every output
    # bitwise the first's (its blocks' exchange is asynchronous, so a
    # hazard shows as runs that differ; staging Minv over the mbarriers
    # did, at 528 with clusters of 16)
    for n, c in ((528, 8), (528, 16), (866, 16)):
        blk, state = _synthetic_block(torch, dev, n, 8, seed=n)
        outs = [_sweep_block(torch, blk, state, True, n_up=n, b_ee=ones,
                             route='cluster', cluster=c)
                for _ in range(CLUSTER_REPEATS)]
        differ = sum(not all(torch.equal(o[i], outs[0][i])
                             for i in (0, 1, 2, 3, 6, 7)) for o in outs[1:])
        print(f'[check] fused_sweep cluster route n={n} W=8 clusters of {c}: '
              f'{differ} of {CLUSTER_REPEATS - 1} repeats differ from the '
              f'first (r, Minv, sign, logdet, decisions, margins)')
        if differ:
            bad.append(f'cluster route n={n} C={c} not deterministic')
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
    from repro_torch.kernels import launch_counters
    return launch_counters()


def _cli_args(method, steps, blocks, seed, system, extra):
    return ['--system', system, '--method', method,
            '--walkers', str(WALKERS), '--workers', '1',
            '--steps', str(steps), '--blocks', str(blocks),
            '--backend', 'thread', '--seed', str(seed),
            '--wall-clock', '300', *extra]


def _run_cli(method: str, steps: int, blocks: int, needs, seed: int,
             extra=(), system: str = SYSTEM, forbid=(), reservoir=None,
             tag: str = '', avgs=None, subblocks: int | None = None,
             built=None):
    """One ``qmc_run`` run; fails unless it ends with a finite energy, every
    kernel in ``needs`` launched and none in ``forbid``.  ``reservoir`` =
    (walkers, energies) numpy: the run resumes from it, stored first in a
    fresh result database under the run's key (the reference's restart
    path, paper §V.D), instead of a cold start.  ``tag`` prefixes the
    printed label; ``avgs``, a dict, receives the final average under the
    label.  ``subblocks``: the run's sub-blocks a block, set on the
    ``RunSpec`` that ``qmc_run.parse_spec`` makes of the flags, which
    ``build_run`` then runs as ``qmc_run.main`` does (the CLI's block is 4
    sub-blocks).  ``built``: the run's (cfg, params) for the reservoir's
    key (``_store_reservoir``)."""
    from repro_torch.launch import qmc_run
    args = _cli_args(method, steps, blocks, seed, system, extra)
    label = ' '.join((method, *extra) if system == SYSTEM
                     else (system, method, *extra))
    label = f'{tag} {label}' if tag else label
    if subblocks is not None:
        label += f' ({subblocks} sub-block{"s" * (subblocks > 1)} a block)'
    db = None
    if reservoir is not None or method == 'dmc':
        db = ROOT / 'build' / 'chip_smoke' / (
            label.replace(' ', '_').replace('-', '') + '.sqlite')
        db.parent.mkdir(parents=True, exist_ok=True)
        db.unlink(missing_ok=True)
        args += ['--db', str(db)]
    if reservoir is not None:
        _store_reservoir(args, db, reservoir, built)
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    before = set(threading.enumerate())
    if subblocks is None:
        avg = qmc_run.main(args)
    else:
        from repro_torch.launch.spec import build_run
        run = build_run(dataclasses.replace(qmc_run.parse_spec(args),
                                            subblocks_per_block=subblocks))
        avg = run.run()
        if run.worker_errors():
            _fail(f'{label}: worker errors {run.worker_errors()}')
    # the run returns once its workers have ended (QMCRun.run); a thread
    # it started and left running would launch on the card, and count, in
    # whatever comes next
    alive = [t.name for t in set(threading.enumerate()) - before
             if t.is_alive() and not isinstance(t, threading._DummyThread)]
    if alive:
        _fail(f'{label}: threads of the run still running after it '
              f'returned: {alive}')
    launches = {k: c.n for k, c in counters.items()}
    secs = time.perf_counter() - t0
    print(f'[{label}] {avg} in {secs:.1f} s; launches {launches}')
    if not (avg.n_blocks >= blocks and math.isfinite(avg.energy)):
        _fail(f'{label}: no finite energy from {avg.n_blocks} blocks')
    if method == 'dmc':
        _dmc_stats(label, db, steps, subblocks or 4)
    for k in needs:
        if launches[k] <= 0:
            _fail(f'{label}: kernel {k} was never launched on the path')
    for k in forbid:
        if launches[k] != 0:
            _fail(f'{label}: kernel {k} was launched {launches[k]} times '
                  f'on a path that must not take it')
    if avgs is not None:
        avgs[label] = avg
    return launches


def _store_reservoir(args, db, reservoir, built=None) -> None:
    """Store ``reservoir`` = (walkers, energies) numpy in the fresh result
    database ``db`` under the run key of the ``qmc_run`` flags ``args``:
    the run resumes from it (the reference's restart path, paper §V.D)
    instead of a cold start.  ``built``: the run's (cfg, params), when the
    caller holds them, for the key in place of a rebuild."""
    from repro_torch.launch import qmc_run
    _store_spec_reservoir(qmc_run.parse_spec(args), db, reservoir, built)


def _store_spec_reservoir(spec, db, reservoir, built=None) -> None:
    """``_store_reservoir`` for a ``RunSpec``."""
    from repro_torch.launch.spec import spec_run_key
    from repro_torch.runtime import ResultDatabase
    from repro_torch.systems import build_system
    store = ResultDatabase(str(db))
    store.save_reservoir(spec_run_key(spec, *(built or build_system(
        spec.system, n_det=spec.n_det, ci_seed=spec.seed,
        screen_eps=spec.screening_eps(), device=spec.device))), *reservoir)
    store.close()


def _dmc_stats(label, db, steps: int, subblocks: int = 4):
    """Print a DMC run's mean weight, global weight a generation (its
    blocks' summed global weights over their generations), accept rate and
    sign-flip fraction, from the blocks in its result store; fails unless
    all are finite."""
    from repro_torch.runtime import ResultDatabase
    store = ResultDatabase(str(db))
    (key,) = store.run_keys()
    blocks = store.blocks(key)
    store.close()
    wsum = sum(b.weight for b in blocks)
    stats = {k: sum(b.weight * b.aux[k] for b in blocks) / wsum
             for k in ('pop_weight', 'accept', 'sign_flips')}
    stats['global_weight'] = wsum / (len(blocks) * subblocks * steps)
    print(f'[{label}] mean weight {stats["pop_weight"]:.6g}, global weight '
          f'a generation {stats["global_weight"]:.6g}, accept rate '
          f'{stats["accept"]:.6g}, sign-flip fraction '
          f'{stats["sign_flips"]:.6g} ({len(blocks)} blocks; block weights '
          + ', '.join(f'{b.weight:.4g}' for b in blocks) + ')')
    bad = [k for k, v in stats.items() if not math.isfinite(v)]
    if bad:
        _fail(f'{label}: {bad} not finite')
    return stats


def _rate_together(blocks, workers):
    """Blocks/s of a run's ``blocks`` while every one of ``workers``
    delivers: the blocks stamped after the last worker's first block and
    up to the first worker's last, over that window (the blocks' own time
    stamps, so the workers' staggered start-up stays out of it).  Returns
    (rate or None where there is no such window, a printable summary,
    blocks per worker)."""
    stamps = {}
    for b in blocks:
        stamps.setdefault(b.worker_id, []).append(b.timestamp)
    counts = {w: len(stamps.get(w, ())) for w in workers}
    if min(counts.values()) == 0:
        return None, f'blocks per worker {counts}', counts
    lo = max(min(t) for t in stamps.values())
    hi = min(max(t) for t in stamps.values())
    inside = sum(lo < x <= hi for t in stamps.values() for x in t)
    t0 = min(min(t) for t in stamps.values())
    first = {w: round(min(t) - t0, 2) for w, t in sorted(stamps.items())}
    text = f'blocks per worker {counts}, first blocks at {first} s; '
    if hi <= lo or inside == 0:
        return None, text + 'no window in which every worker delivered', \
            counts
    rate = inside / (hi - lo)
    return rate, text + (f'{rate:.4f} blocks/s over the {hi - lo:.2f} s '
                         f'every worker delivered ({inside} blocks)'), counts


def phase_process_backend(seed: int, reservoir, extra=(), steps: int = 5,
                          secs: float = 25.0):
    """``dmc`` on ``smallest`` through ``qmc_run --backend process``: one
    worker process, then two sharing the card, each run for ``secs``
    seconds of wall clock (a block target could be met by the first
    worker before the second, which starts seconds later, delivers),
    resumed from ``reservoir`` = (walkers, energies) of finite cold-start
    walkers (a cold start of two workers with no dead walker is rare: ~2
    of 256 walkers a worker are dead at seeds 3-10).
    Fails on any worker error or a worker that delivers no block.  The
    launch counters live in the children, so these runs are checked by
    their blocks and energies.  Prints blocks/s of each while every worker
    delivers: the blocks stamped after the last worker's first block and
    up to the first worker's last, over that window (the blocks' own time
    stamps, so the children's staggered start-up stays out of it)."""
    from repro_torch.launch import qmc_run
    from repro_torch.runtime import ResultDatabase
    rates = {}
    for n in (1, 2):
        label = f'process backend, {n} worker process' + ('es' if n > 1
                                                          else '')
        db = ROOT / 'build' / 'chip_smoke' / f'process{n}.sqlite'
        db.parent.mkdir(parents=True, exist_ok=True)
        db.unlink(missing_ok=True)
        args = ['--system', SYSTEM, '--method', 'dmc', '--backend',
                'process', '--workers', str(n), '--walkers', str(WALKERS),
                '--steps', str(steps), '--blocks', '100000',
                '--seed', str(seed), '--wall-clock', str(secs),
                '--db', str(db), *extra]
        _store_reservoir(args, db, reservoir)
        t0 = time.perf_counter()
        try:
            avg = qmc_run.main(args)
        except SystemExit as e:
            _fail(f'{label}: {e}')
        secs = time.perf_counter() - t0
        store = ResultDatabase(str(db))
        (key,) = store.run_keys()
        blocks = store.blocks(key)
        store.close()
        rate, text, counts = _rate_together(blocks, range(n))
        if not math.isfinite(avg.energy) or min(counts.values()) < 2:
            _fail(f'{label}: blocks per worker {counts}, {avg}')
        if rate is None:
            _fail(f'{label}: the workers never delivered together '
                  f'(blocks per worker {counts})')
        rates[n] = rate
        print(f'[{label}] {avg} in {secs:.1f} s; {text} ({steps} '
              f'generations x 4 sub-blocks a block)')
    print(f'[process backend] blocks/s, 2 worker processes against 1 on '
          f'one card: {rates[2]:.4f} / {rates[1]:.4f} = '
          f'{rates[2] / rates[1]:.3f}x')
    return rates


def _finite_pool(torch, dev, cfg, params, first: int = 3, tries: int = 6,
                 tag: str = f'{BSTRAND} eps={SCREEN_EPS:g}'):
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
        print(f'[cold start] {tag} seed {seed}: '
              f'{int((~ok).sum())} of {WALKERS} walkers not finite')
        rs.append(ens.r[ok])
        es.append(ens.e_loc[ok])
        if sum(len(r) for r in rs) >= WALKERS:
            print(f'[cold start] {tag}: {WALKERS} finite walkers from '
                  f'{len(rs)} cold start(s) of {WALKERS}, '
                  f'{len(rs) * WALKERS - sum(len(r) for r in rs)} dead '
                  f'walkers dropped')
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


# ---------------------------------------------------------------------------
# [opt-vmc]: wavefunction optimization on equilibrated walkers
# ---------------------------------------------------------------------------
EQUIL_SWEEPS = 200            # fused-vmc sweeps from the cold start
OPT_BLOCKS = 2                # blocks per opt-vmc step on smallest


def _equilibrate(torch, dev, seed: int):
    """``fused-vmc`` on ``smallest`` at W = ``WALKERS`` from the cold start
    ``qmc_run`` draws for worker 0 of run ``seed``, ``EQUIL_SWEEPS`` sweeps;
    prints the ensemble's mean E_L and accept rate every 25 sweeps.
    Returns the final (positions (W, n_e, 3), local energies (W,)); fails
    unless every walker is finite."""
    from repro_torch.core.driver import Population, make_propagator
    from repro_torch.runtime.samplers import worker_seed
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    prop = make_propagator('fused-vmc', cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(worker_seed(seed, 0))
    st = prop.init(params, gen, WALKERS)
    pop = Population()
    trace = []
    t0 = time.perf_counter()
    for i in range(1, EQUIL_SWEEPS + 1):
        st, out = prop.propagate(params, st, gen, pop)
        if i % 25 == 0:
            trace.append(f'{i}: {float(out[0]):.2f} ({float(out[2]):.3f})')
    secs = time.perf_counter() - t0
    ens = st.ens
    ok = torch.isfinite(ens.e_loc) & torch.isfinite(ens.log_psi)
    print(f'[opt-vmc] equilibration: fused-vmc on {SYSTEM}, W={WALKERS}, '
          f'{EQUIL_SWEEPS} sweeps from the cold start of seed {seed} in '
          f'{secs:.1f} s; mean E_L (accept rate) after sweep '
          + ', '.join(trace) + f'; {int((~ok).sum())} walkers not finite')
    if not bool(ok.all()):
        _fail('equilibrated walkers are not all finite')
    return ens.r, ens.e_loc


def _o_over(got, want, rtol: float = 1e-4, scale: float = 1e-5,
            cols=slice(None)):
    """Per-walker worst |got - want| / (rtol |want| + scale x the walker's
    largest |want| in the same part: the three Jastrow derivatives; the CI
    derivatives R_I / S, whose ratios share one fp32 table), over the
    columns ``cols``.  float64 on the CPU; > 1 fails the contract."""
    import torch
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    atol = torch.zeros_like(want)
    for part in (slice(0, 3), slice(3, None)):
        if want[:, part].numel():
            atol[:, part] = scale * want[:, part].abs().amax(
                dim=1, keepdim=True)
    over = (got - want).abs() / (rtol * want.abs() + atol).clamp(min=1e-300)
    return over[:, cols].nan_to_num(nan=float('inf')).amax(dim=1)


def _o_fd64(torch, cfg, params, R, h: float = 1e-5):
    """O by an fp64 central difference of ln|Psi| in the parameter vector,
    on the CPU, at the fp32 MO tensor of the plain path (the MO tensor does
    not depend on the vector): the Jastrow value in fp64 at b_ee, b_en, a_en
    +- h, and with CI ln|S| at c_I +- h |S| / max|R| over ratios R_I =
    r_up r_dn of an fp64 factorization of the same MO tensor."""
    from repro_torch.core import multidet
    from repro_torch.core.jastrow import JastrowParams, jastrow_value
    from repro_torch.core.wavefunction import _ci_blocks, _mo_tensor_ensemble
    from repro_torch.optimize.estimators import N_JASTROW, opt_vector
    vec = torch.as_tensor(opt_vector(cfg, params), dtype=torch.float64)
    p64 = _fp64_twin(params)
    R64 = R.double()
    cols = []
    for i in range(N_JASTROW):
        lp = []
        for sgn in (1.0, -1.0):
            v = vec.clone()
            v[i] += sgn * h
            lp.append(jastrow_value(JastrowParams(*v[:N_JASTROW]), R64,
                                    p64.coords, p64.charges, cfg.n_up))
        cols.append((lp[0] - lp[1]) / (2 * h))
    if cfg.ci is not None:
        ci = cfg.ci_t
        C, _ = _mo_tensor_ensemble(cfg, params, R)
        up_all, dn_all = _ci_blocks(cfg, C.double())
        r_up = multidet.spin_block_ci(up_all, ci.holes_up, ci.parts_up,
                                      cfg.ns_steps).ratios
        r_dn = multidet.spin_block_ci(dn_all, ci.holes_dn, ci.parts_dn,
                                      cfg.ns_steps).ratios
        Rd = r_up * r_dn                                    # (W, n_det)
        S = torch.sum(vec[N_JASTROW:] * Rd, dim=-1, keepdim=True)
        step = h * S.abs() / Rd.abs().amax(dim=-1, keepdim=True)
        d = step * Rd
        cols.append(((S + d).abs().log() - (S - d).abs().log())
                    / (2 * step))
        return torch.cat([torch.stack(cols[:N_JASTROW], dim=1), cols[-1]],
                         dim=1)
    return torch.stack(cols, dim=1)


def phase_opt_o_checks(torch, dev, R_eq, n_cand: int = 64,
                       n_fd: int = 4):
    """opt-vmc's batched O on the card against the same estimator on the
    CPU (the plain path), on ``n_cand`` equilibrated walkers, single
    determinant (P = 3) and n_det = 100 (P = 103), and against an fp64
    central difference (``_o_fd64``).  The contract: rtol 1e-4 plus 1e-5 of
    the walker's largest |O| in the part (``_o_over``).  A walker is in
    scope (``FP32_SCOPE``'s rule) when the CPU's fp32 O meets a tenth of the
    contract against the fp64 difference; the card is held on those, and
    on ``n_fd`` of them against the fp64 difference directly.  The CI
    ratios take one sparse_mo launch on the card, or with n_det = 100 and
    eps = 1e-8 (``--screen-eps``) one screened_mo launch and no sparse_mo
    one; the Jastrow part none."""
    from repro_torch.kernels.screened_mo import kernel as sck
    from repro_torch.kernels.sparse_mo import kernel as smk
    from repro_torch.optimize.estimators import n_params, o_batched
    from repro_torch.systems import build_system
    cpu = torch.device('cpu')
    R = R_eq[:n_cand].detach()
    n_cand = R.shape[0]
    bad = []
    for n_det, eps in ((1, None), (100, None), (100, 1e-8)):
        sides = {d: build_system(SYSTEM, n_det=n_det, screen_eps=eps,
                                 device=d)
                 for d in (cpu, dev)}
        P = n_params(sides[cpu][0])
        tag = f'P={P}' + (f' eps={eps:g}' if eps is not None else '')
        before = (smk.COUNTER.n, sck.COUNTER.n)
        O_g = o_batched(*sides[dev], R.to(dev))
        torch.cuda.synchronize()
        n_launch = (smk.COUNTER.n - before[0], sck.COUNTER.n - before[1])
        O_c = o_batched(*sides[cpu], R.cpu())
        fd = _o_fd64(torch, *sides[cpu], R.cpu())
        cpu_vs_64 = _o_over(O_c, fd, rtol=1e-5, scale=1e-6)
        scope = cpu_vs_64 <= 1.0
        card_vs_cpu = _o_over(O_g, O_c)
        card_vs_64 = _o_over(O_g, fd)
        idx = scope.nonzero().flatten()[:n_fd]
        n_in = int(scope.sum())
        fd_worst = float(card_vs_64[idx].max()) if len(idx) else float('nan')
        print(f'[opt-vmc] O on the card vs the CPU path, {SYSTEM} {tag} on '
              f'{n_cand} equilibrated walkers: {n_in} in scope (CPU fp32 O '
              f'within a tenth of the contract of an fp64 central '
              f'difference); worst |diff|/tol on them {float(card_vs_cpu[scope].max()) if n_in else float("nan"):.3g} '
              f'(all walkers {float(card_vs_cpu.max()):.3g}); card vs fp64 '
              f'on {len(idx)} in-scope walkers {fd_worst:.3g} (all walkers '
              f'{float(card_vs_64.max()):.3g}); CPU vs fp64 over all '
              f'{float(cpu_vs_64.max()):.3g} of a tenth; sparse_mo, '
              f'screened_mo launches {n_launch}; |O| max per part '
              + ', '.join(f'{float(O_g[:, s].abs().max()):.4g}'
                          for s in (slice(0, 3), slice(3, None))
                          if O_g[:, s].numel()))
        if O_g.shape != (n_cand, P) or not bool(torch.isfinite(O_g).all()):
            bad.append(f'{tag}: O not finite or of shape {tuple(O_g.shape)}')
        if n_in < n_fd or len(idx) < n_fd:
            bad.append(f'{tag}: only {n_in} walkers in scope')
        if bool((card_vs_cpu[scope] > 1.0).any()):
            bad.append(f'{tag}: card vs CPU past the contract on '
                       f'{int((card_vs_cpu[scope] > 1.0).sum())} walkers')
        if not fd_worst <= 1.0:
            bad.append(f'{tag}: card vs fp64 difference past the contract')
        n_ci = 1 if n_det > 1 else 0
        if n_launch != ((0, n_ci) if eps is not None else (n_ci, 0)):
            bad.append(f'{tag}: {n_launch} sparse_mo, screened_mo launches '
                       f'for one O')
    if bad:
        _fail('opt-vmc O checks: ' + '; '.join(bad))


def _run_opt(label: str, seed: int, db, ckpt, *, opt_steps: int,
             solver: str = 'sr', extra=(), reservoir=None, steps: int = 3):
    """One ``qmc_run --method opt-vmc`` run on ``smallest`` (thread backend,
    one worker, W = ``WALKERS``, tau 0.01, ``OPT_BLOCKS`` blocks a step,
    checkpoints in ``ckpt``, the result store ``db``), resumed from
    ``reservoir`` when given (else from the store's own reservoir); checked
    by ``_check_opt``.  Returns (OptResult, launches)."""
    from repro_torch.launch import qmc_run
    from repro_torch.runtime import ResultDatabase
    args = ['--system', SYSTEM, '--method', 'opt-vmc',
            '--walkers', str(WALKERS), '--workers', '1',
            '--steps', str(steps), '--backend', 'thread',
            '--seed', str(seed), '--tau', '0.01',
            '--opt-steps', str(opt_steps), '--opt-solver', solver,
            '--opt-blocks', str(OPT_BLOCKS), '--ckpt-dir', str(ckpt),
            '--db', str(db), '--wall-clock', '300', *extra]
    if reservoir is not None:
        _store_reservoir(args, db, reservoir)
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    try:
        res = qmc_run.main(args)
    except SystemExit as e:
        _fail(f'{label}: {e}')
    secs = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    store = ResultDatabase(str(db))
    (key,) = store.run_keys()
    blocks = store.blocks(key)
    store.close()
    _check_opt(label, res, secs, launches, blocks)
    return res, launches


def _check_opt(label: str, res, secs: float, launches: dict, blocks, *,
               needs_moves: bool = False, mo_kernel: str = 'sparse_mo'):
    """Print an opt-vmc run's steps (energy, error, variance, blocks,
    accept rate, vector) and its stored blocks; fails unless every stored
    moment and energy is finite, b_ee and b_en >= B_MIN, the CI tail has
    unit norm after a step, ``mo_kernel`` launched (with 'screened_mo'
    sparse_mo did not) and no per-move kernel did, and with
    ``needs_moves`` unless every step's accept rate is above 0."""
    import numpy as np
    from repro_torch.optimize.estimators import B_MIN, N_JASTROW
    stamped = [b for b in blocks if 'opt_pv' in b.aux]
    bad = []
    for s in res.steps:
        v = s.vec
        cur = [b for b in stamped if b.aux['opt_pv'] == float(s.version)]
        acc = (sum(b.weight * b.aux['accept'] for b in cur)
               / sum(b.weight for b in cur))
        print(f'[opt-vmc] {label} step {s.step} (pv {s.version}): E = '
              f'{s.energy:+.6f} +/- {s.error:.6f}, variance '
              f'{s.variance:.6g}, {s.n_blocks} blocks, accept rate '
              f'{acc:.4g}, |vec| {float(np.linalg.norm(v)):.6f} (b_ee '
              f'{v[0]:.6f}, b_en {v[1]:.6f}, a_en {v[2]:.6f}'
              + (f', |c| {float(np.linalg.norm(v[N_JASTROW:])):.6f}'
                 if len(v) > N_JASTROW else '') + ')')
        if not all(math.isfinite(x) for x in (s.energy, s.variance)):
            bad.append(f'step {s.step} energy not finite')
        if needs_moves and not acc > 0:
            bad.append(f'step {s.step} accepted no move')
    v = res.vec
    print(f'[opt-vmc] {label}: {len(res.steps)} steps in {secs:.1f} s, '
          f'final vector b_ee {v[0]:.6f}, b_en {v[1]:.6f}, a_en {v[2]:.6f}'
          + (f', |c| {float(np.linalg.norm(v[N_JASTROW:])):.9f}'
             if len(v) > N_JASTROW else '') + f'; launches {launches}')
    for s_vec in [s.vec for s in res.steps[1:]] + [v]:
        if not (s_vec[0] >= B_MIN and s_vec[1] >= B_MIN):
            bad.append(f'b_ee or b_en under B_MIN: {s_vec[:3]}')
        if len(s_vec) > N_JASTROW and not abs(
                np.linalg.norm(s_vec[N_JASTROW:]) - 1.0) <= 1e-9:
            bad.append('CI tail not unit norm')
    n_keys = {len(b.aux) for b in stamped}
    nonfinite = sum(not all(math.isfinite(x) for x in (
        b.e_mean, b.e2_mean, *b.aux.values())) for b in stamped)
    print(f'[opt-vmc] {label}: {len(stamped)} stamped blocks in the store '
          f'(aux keys a block {sorted(n_keys)}), stamps '
          f'{sorted({b.aux["opt_pv"] for b in stamped})}; {nonfinite} with a '
          f'moment or energy not finite')
    if nonfinite or not stamped:
        bad.append(f'{nonfinite} stored blocks with a non-finite moment')
    if launches[mo_kernel] <= 0:
        bad.append(f'{mo_kernel} never launched')
    for k in (('sem_move', 'fused_sweep', 'sem_update', 'multidet_ratio')
              + (('sparse_mo',) if mo_kernel == 'screened_mo' else ())):
        if launches[k]:
            bad.append(f'{k} launched {launches[k]} times')
    if bad:
        _fail(f'{label}: ' + '; '.join(bad))


def _run_opt_from_walkers(label: str, seed: int, walkers, *, tau: float,
                          opt_steps: int, steps: int = 3):
    """``opt-vmc`` on ``smallest`` through ``build_run`` and
    ``run_optimization`` (thread backend, one worker, W = ``WALKERS``, SR,
    ``OPT_BLOCKS`` blocks a step) started from every one of ``walkers``:
    the worker is added with them before ``run_optimization`` starts the
    manager, where a restart from the reservoir would tile 16 of them.
    Checks as ``_check_opt`` with ``needs_moves``: at this tau the
    all-electron moves must be accepted, so the moments come from a
    sample that moves under the broadcast parameters."""
    from repro_torch.launch.spec import RunSpec, build_run
    from repro_torch.optimize import run_optimization
    run = build_run(RunSpec(
        system=SYSTEM, method='opt-vmc', n_walkers=WALKERS, n_workers=1,
        steps=steps, backend='thread', seed=seed, tau=tau,
        opt_steps=opt_steps, opt_blocks_per_step=OPT_BLOCKS, db=':memory:',
        wall_clock_limit=300))
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    run.manager.add_worker(init_walkers=walkers)
    res = run_optimization(run)
    secs = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    errors = run.worker_errors()
    if errors:
        _fail(f'{label}: worker errors {errors[:1]}')
    _check_opt(label, res, secs, launches, run.db.blocks(run.run_key),
               needs_moves=True)
    return res, launches


def phase_opt_h2_and_process():
    """``opt-vmc`` on h2 on the card: 4 SR steps (5 until [paper systems
    ci] came) with the sizes of the CPU end-to-end test (2 thread workers,
    32 walkers, 20 steps x 2 sub-blocks, 6 blocks a step), failing unless
    the last energy is below the first
    by 0.02 Ha; then 2 steps on the ``process`` backend with 2 worker
    processes on the card (one sub-block a block, so no block straddles a
    version change), failing unless every stamped block has an integer
    opt_pv and no worker died."""
    import numpy as np
    from repro_torch.launch.spec import RunSpec, build_run
    from repro_torch.optimize import run_optimization
    base = dict(system='h2', method='opt-vmc', n_workers=2, n_walkers=32,
                seed=3, db=':memory:')
    t0 = time.perf_counter()
    run = build_run(RunSpec(**base, backend='thread', steps=20,
                            subblocks_per_block=2, opt_steps=4,
                            opt_blocks_per_step=6))
    res = run.run()
    errors = run.worker_errors()
    es = res.energies()
    print(f'[opt-vmc] h2, thread backend, 2 workers on the card, '
          f'{len(res.steps)} SR steps in {time.perf_counter() - t0:.1f} s: '
          f'E = '
          + ', '.join(f'{s.energy:+.5f} +/- {s.error:.5f}'
                      for s in res.steps)
          + f'; final vector {np.round(res.vec, 6).tolist()}')
    if errors or not es[-1] < es[0] - 0.02:
        _fail(f'h2 opt-vmc did not descend by 0.02 Ha ({es}; '
              f'{len(errors)} worker errors {errors[:1]})')
    t0 = time.perf_counter()
    run = build_run(RunSpec(**base, backend='process', steps=10,
                            subblocks_per_block=1, opt_steps=2,
                            opt_blocks_per_step=3))
    res = run_optimization(run, step_timeout=300)
    errors = run.worker_errors()
    stamps = {}
    for b in run.db.blocks(run.run_key):
        if 'opt_pv' in b.aux:
            stamps.setdefault(b.worker_id, []).append(b.aux['opt_pv'])
    print(f'[opt-vmc] h2, process backend, 2 worker processes on the card, '
          f'2 SR steps in {time.perf_counter() - t0:.1f} s: E = '
          + ', '.join(f'{s.energy:+.5f} +/- {s.error:.5f}'
                      for s in res.steps)
          + f'; stamps by worker {dict(sorted(stamps.items()))}')
    flat = [p for v in stamps.values() for p in v]
    if errors or not flat or not all(float(p).is_integer() for p in flat):
        _fail(f'process backend opt-vmc: stamps {stamps}, '
              f'{len(errors)} worker errors {errors[:1]}')


def phase_opt_layers(torch, dev, R_eq):
    """One opt-vmc step on ``smallest`` at W = ``WALKERS`` from the
    equilibrated walkers, single determinant (P = 3) and n_det = 100
    (P = 103): wall, device busy, idle, launches a move and the MO
    product (profiler), the O pass alone (CUDA events) and its share of
    the step's device time; then one block of 3 steps and its host side:
    the aux keys, flattening (``from_stats``), merging 4 sub-blocks, the
    wire round trip, storing it, and the solver's host time a step
    (``collect_moments`` of ``OPT_BLOCKS`` blocks, then ``sr_update`` and
    ``lm_update``)."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.driver import EnsembleDriver, Population
    from repro_torch.optimize import (OptVMCPropagator, collect_moments,
                                      lm_update, o_batched, opt_vector,
                                      sr_update)
    from repro_torch.runtime import ResultDatabase
    from repro_torch.runtime.blocks import BlockAccumulator
    from repro_torch.runtime.packets import decode_blocks, encode_blocks
    from repro_torch.systems import build_system
    pop = Population()
    walkers = R_eq.cpu().numpy()
    for n_det in (1, 100):
        cfg, params = build_system(SYSTEM, n_det=n_det, device=dev)
        prop = OptVMCPropagator(cfg, tau=0.01)
        P = prop.n_opt
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        st = prop.init(params, gen, WALKERS, walkers)
        st, _ = prop.propagate(params, st, gen, pop)           # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st, _ = prop.propagate(params, st, gen, pop)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        tr = Trace(prof)
        busy, issued, top = tr.busy, tr.issued, tr.top()
        mo_ms, mo_n = tr.part('tile_kernel')
        o_ms, o_host = _time_ms(lambda: o_batched(cfg, params, st.r),
                                iters=10)
        label = f'opt-vmc step at W={WALKERS} (P = {P})'
        print(f'[layer] {label}: wall {wall:.2f} ms, device busy '
              f'{busy:.2f} ms (idle {100 * (1 - busy / wall):.1f} %; '
              f'{issued / cfg.n_elec:.1f} launches and copies a move); MO '
              f'product {mo_ms:.3f} ms x{mo_n}; the O '
              f'pass alone {o_ms:.3f} ms device, {o_host:.3f} ms host '
              f'clock ({100 * o_ms / busy:.1f} % of the step\'s device '
              f'time); top: {top}')
        # one block and what the host does with it
        drv = EnsembleDriver(prop, 3)
        t0 = time.perf_counter()
        st, stats = drv.run_block(params, st, gen)
        t_block = time.perf_counter() - t0

        def _host(fn, n=5):
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn()
            return out, (time.perf_counter() - t0) / n * 1e3
        acc, t_flat = _host(lambda: BlockAccumulator.from_stats(stats))
        acc = dataclasses.replace(acc, aux={**acc.aux, 'opt_pv': 0.0})
        merged, t_merge = _host(lambda: acc.merge(acc).merge(acc).merge(acc))
        blk = merged.to_block('k', 0, 0)
        _, t_wire = _host(lambda: decode_blocks(encode_blocks([blk])))
        db = ROOT / 'build' / 'chip_smoke' / f'opt_host{P}.sqlite'
        db.unlink(missing_ok=True)
        store = ResultDatabase(str(db))
        t0 = time.perf_counter()
        store.append([blk])
        t_store = (time.perf_counter() - t0) * 1e3
        store.close()
        blocks = [dataclasses.replace(blk, block_id=i)
                  for i in range(OPT_BLOCKS)]
        m, t_collect = _host(lambda: collect_moments(blocks, P, 0))
        vec = opt_vector(cfg, params)
        _, t_sr = _host(lambda: sr_update(m, vec))
        _, t_lm = _host(lambda: lm_update(m, vec))
        print(f'[layer] opt-vmc block host side (P = {P}): a block of 3 '
              f'steps {t_block * 1e3:.2f} ms wall (its one transfer '
              f'included); {len(blk.aux)} aux keys; from_stats '
              f'{t_flat:.3f} ms, merging 4 sub-blocks {t_merge:.3f} ms, '
              f'wire encode + decode {t_wire:.3f} ms, storing it '
              f'{t_store:.3f} ms; solver a step: collect_moments of '
              f'{OPT_BLOCKS} blocks {t_collect:.3f} ms, sr_update '
              f'{t_sr:.3f} ms, lm_update {t_lm:.3f} ms (host clock, the '
              f'chip host\'s CPU)')


def _equilibrated_ci_sweep_check(torch, dev, R_eq):
    """The fused-sweep kernel with CI (n_det = 100) against its plain
    version on the equilibrated walkers, both spin blocks, under
    ``_compare_sweep``'s scope rule: the per-walker 1e-5 check of Minv, P
    and rdet, which no cold-start walker with CI qualified for.  Prints
    how many block-walkers were held per walker; fails on any failure of
    the rule."""
    from repro_torch.core.sem import evaluate_sem
    from repro_torch.kernels.fused_sweep import autotune
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, n_det=100, device=dev)
    ens = evaluate_sem(cfg, params, R_eq)
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    blocks = _fused_blocks(torch, cfg, params, ens, gen)
    launch = autotune.best_launch(cfg.n_elec, WALKERS)
    state, r_other = (ens.r, ens.sign, ens.logdet), None
    held, bad = 0, []
    for blk in blocks:
        outs = [_sweep_block(torch, blk, state, kernel, n_up=cfg.n_up,
                             b_ee=params.jastrow.b_ee, cfg=cfg,
                             r_other=r_other, dtype=dtype,
                             **(launch if kernel else {}))
                for kernel, dtype in ((True, None), (False, None),
                                      (False, torch.float64))]
        torch.cuda.synchronize()
        res = _compare_sweep(torch, f'equilibrated {SYSTEM} W={WALKERS} '
                             f'n_det=100 {blk["spin"]} block', *outs,
                             strict=False)
        held += res['n']
        bad += res['bad']
        out_p = outs[1]
        state, r_other = (out_p[0], out_p[2], out_p[3]), out_p[5]
    print(f'[check] fused_sweep with CI on {WALKERS} equilibrated walkers: '
          f'{held} block-walkers held per walker to 1e-5 (a cold start held '
          f'none)')
    if bad:
        _fail('; '.join(bad))


def phase_opt_vmc(torch, dev, seed: int, runs: dict):
    """Equilibrate ``smallest``, check O on the card, run opt-vmc from the
    equilibrated walkers (P = 3: 3 SR steps; P = 103: 2 SR steps, then one
    LM step resumed from their checkpoint), on h2 (descent) and on the
    process backend, profile its step and block, then ROADMAP Queue C 1 on
    the card: vmc, sem-vmc and fused-vmc energies from the same walkers
    (``EQ_BLOCKS`` blocks each: 4, cut from 8 for the script's time
    limit), sem-vmc held to fused-vmc within 4 sigma, and
    the per-walker CI check of the fused sweep on them.  Adds its qmc_run
    runs to ``runs``.  Returns the equilibrated state (``_equilibrated``)."""
    R_eq, E_eq = _equilibrate(torch, dev, seed)
    phase_opt_o_checks(torch, dev, R_eq)
    reservoir = (R_eq.cpu().numpy(), E_eq.cpu().numpy())
    out = ROOT / 'build' / 'chip_smoke'
    out.mkdir(parents=True, exist_ok=True)
    for tag, extra, plan in (
            ('P=3', (), (('sr', 3),)),
            ('P=103', ('--n-det', '100'), (('sr', 2), ('lm', 3)))):
        db, ckpt = out / f'opt_{tag[2:]}.sqlite', out / f'opt_ckpt_{tag[2:]}'
        db.unlink(missing_ok=True)
        if ckpt.exists():
            for f in ckpt.iterdir():
                f.unlink()
        for i, (solver, n_steps) in enumerate(plan):
            label = f'smallest {tag} {solver}'
            _, launches = _run_opt(label, seed, db, ckpt, opt_steps=n_steps,
                                   solver=solver, extra=extra,
                                   reservoir=reservoir if i == 0 else None)
            runs[f'opt-vmc {tag} {solver}'] = launches
    _, runs['opt-vmc P=3 sr tau 1e-3'] = _run_opt_from_walkers(
        f'smallest P=3 sr tau 1e-3 from all {WALKERS} walkers', seed,
        R_eq.cpu().numpy(), tau=1e-3, opt_steps=2)
    phase_opt_h2_and_process()
    phase_opt_layers(torch, dev, R_eq)
    # ROADMAP Queue C 1 on the card, from the same equilibrated walkers
    old = ('sem_update', 'multidet_ratio')
    avgs = {}
    tag = 'equilibrated'
    runs[f'{tag} vmc'] = _run_cli(
        'vmc', steps=3, blocks=EQ_BLOCKS, needs=('sparse_mo',), seed=seed,
        extra=('--tau', '0.01'), forbid=old, reservoir=reservoir, tag=tag,
        avgs=avgs)
    runs[f'{tag} sem-vmc'] = _run_cli(
        'sem-vmc', steps=2, blocks=EQ_BLOCKS, needs=('sparse_mo', 'sem_move'),
        seed=seed, forbid=old, reservoir=reservoir, tag=tag, avgs=avgs)
    runs[f'{tag} fused-vmc'] = _equilibrated_fused_vmc(seed, reservoir, avgs)
    a, b = avgs[f'{tag} sem-vmc'], avgs[f'{tag} fused-vmc']
    sigma = math.hypot(a.error, b.error)
    print(f'[queue C 1] {SYSTEM} from {WALKERS} equilibrated walkers: '
          + '; '.join(f'{k[len(tag) + 1:]} {v.energy:+.4f} +/- '
                      f'{v.error:.4f} ({v.n_blocks} blocks)'
                      for k, v in avgs.items())
          + f'; sem-vmc - fused-vmc = {a.energy - b.energy:+.4f} = '
          f'{(a.energy - b.energy) / sigma:+.2f} sigma (combined error '
          f'{sigma:.4f})')
    if not (sigma > 0 and abs(a.energy - b.energy) <= 4 * sigma):
        _fail('sem-vmc and fused-vmc disagree past 4 sigma on equilibrated '
              'walkers')
    _equilibrated_ci_sweep_check(torch, dev, R_eq)
    _accept_by_tau(torch, dev, R_eq)
    return dict(R=R_eq, E=E_eq, fused=b)


def _equilibrated_fused_vmc(seed: int, reservoir, avgs):
    """``equilibrated fused-vmc``: ``EQ_BLOCKS`` blocks of 2 sweeps a
    sub-block on the thread backend, resumed from ``reservoir``; its
    average lands in ``avgs``.  Returns its launches."""
    return _run_cli(
        'fused-vmc', steps=2, blocks=EQ_BLOCKS,
        needs=('sparse_mo', 'fused_sweep'), seed=seed,
        forbid=('sem_update', 'multidet_ratio', 'sem_move'),
        reservoir=reservoir, tag='equilibrated', avgs=avgs)


def _equilibrated(torch, dev, seed: int, runs: dict, eq: dict) -> dict:
    """``eq``, the start and the yardstick of [grid] and [sim]: [opt-vmc]'s
    equilibrated walkers ``R`` and their energies ``E`` (on the card) and
    the ``equilibrated fused-vmc`` average from them (``fused``).  When
    [opt-vmc] did not run (phases run alone) they are made here, as it
    makes them, into ``eq``."""
    if not eq:
        R_eq, E_eq = _equilibrate(torch, dev, seed)
        avgs = {}
        runs['equilibrated fused-vmc'] = _equilibrated_fused_vmc(
            seed, (R_eq.cpu().numpy(), E_eq.cpu().numpy()), avgs)
        eq.update(R=R_eq, E=E_eq, fused=avgs['equilibrated fused-vmc'])
    return eq


def _accept_by_tau(torch, dev, R_eq, taus=(0.01, 1e-3, 1e-4), steps=5):
    """The all-electron (vmc) accept rate from the equilibrated walkers at
    a few time steps: ``steps`` generations each, W = ``WALKERS``."""
    from repro_torch.core.driver import Population
    from repro_torch.core.vmc import VMCPropagator
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    pop = Population()
    rates = []
    for tau in taus:
        prop = VMCPropagator(cfg, tau=tau)
        gen = torch.Generator(device=dev)
        gen.manual_seed(9)
        st = prop.init(params, gen, WALKERS, R_eq.cpu().numpy())
        acc = []
        for _ in range(steps):
            st, out = prop.propagate(params, st, gen, pop)
            acc.append(out[2])
        rates.append(f'tau {tau:g}: {float(torch.stack(acc).mean()):.4g}')
    print(f'[queue C 1] all-electron (vmc) accept rate from the '
          f'{WALKERS} equilibrated walkers, {steps} steps each: '
          + ', '.join(rates))


# -- the paper's §V substrates on the card: the TCP grid and the sim drill --
FIRST_DESIGNS = ('sem_update', 'multidet_ratio')


def _env_with_src():
    """This process's environment with ``src`` on ``PYTHONPATH`` (and the
    fused-sweep tuner's cache, ``REPRO_FUSED_TILE_CACHE``, as set here)."""
    env = dict(os.environ)
    env['PYTHONPATH'] = str(SRC) + (os.pathsep + env['PYTHONPATH']
                                    if env.get('PYTHONPATH') else '')
    return env


@contextlib.contextmanager
def _stdout_to(path):
    """Point file descriptor 1 at ``path`` (appending) while the block
    runs: the worker processes a grid backend starts meanwhile inherit
    it, so their closing lines land there."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, 'ab') as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _wait_for(cond, secs: float, what: str) -> None:
    t_end = time.monotonic() + secs
    while not cond():
        if time.monotonic() > t_end:
            raise TimeoutError(f'no {what} after {secs:.0f} s')
        time.sleep(0.02)


def _worker_lines(label: str, log, ids, needs, forbid) -> dict:
    """The closing lines (``qmc_worker.closing_lines``) of workers ``ids``
    in the file ``log``, printed; fails unless each is there, launched
    every kernel in ``needs`` and none in ``forbid``.  Returns
    {worker id: launches}."""
    from repro_torch.launch.qmc_worker import closing_lines
    text = Path(log).read_text(errors='replace')
    lines = closing_lines(text)
    out, bad = {}, []
    for w in ids:
        c = lines.get(w)
        if c is None or 'launches' not in c:
            bad.append(f'worker {w} printed no closing line with launches')
            continue
        n = c['launches']
        print(f'[{label}] worker {w}: {c["blocks"]} blocks, '
              f'{c["reconnects"]} reconnects; torch import and CUDA init '
              f'{c["prepare_s"]:.2f} s before attaching (the GIL held up to '
              f'{c["gil_hold_s"]:.3f} s meanwhile), handshake '
              f'{c["handshake_s"] * 1e3:.2f} ms; launches {n}')
        bad += [f'worker {w} never launched {k}' for k in needs if n[k] <= 0]
        bad += [f'worker {w} launched {k} {n[k]} times' for k in forbid
                if n[k]]
        out[w] = n
    if bad:
        print(text[-4000:])
        _fail(f'[{label}] ' + '; '.join(bad))
    return out


def _within_4_sigma(label: str, avg, ref, ref_label: str) -> None:
    sigma = math.hypot(avg.error, ref.error)
    print(f'[{label}] {avg}; {ref_label} {ref}; difference '
          f'{avg.energy - ref.energy:+.4f} = '
          f'{(avg.energy - ref.energy) / sigma:+.2f} sigma')
    if not (math.isfinite(avg.energy) and sigma > 0
            and abs(avg.energy - ref.energy) <= 4 * sigma):
        _fail(f'[{label}] energy not within 4 sigma of {ref_label}')


def _grid_spawn(seed: int, reservoir, ref, out):
    """[grid] run 1: ``qmc_run --backend grid --workers 2`` as a
    subprocess, its two ``qmc_worker`` processes spawned by the backend,
    every process's output in one log.  Fails unless it exits 0, both
    workers delivered and printed launches of ``fused_sweep`` and
    ``sparse_mo`` (no first design, no ``sem_move``) and the energy lies
    within 4 sigma of ``ref`` (``equilibrated fused-vmc``).  Returns (its
    average, blocks/s while both deliver or None, {worker: launches})."""
    from repro_torch.runtime import ResultDatabase
    label = 'grid spawn'
    db, log = out / 'grid_spawn.sqlite', out / 'grid_spawn.log'
    db.unlink(missing_ok=True)
    args = ['--system', SYSTEM, '--method', 'fused-vmc', '--backend', 'grid',
            '--workers', '2', '--walkers', str(WALKERS), '--steps', '2',
            '--blocks', str(EQ_BLOCKS), '--seed', str(seed),
            '--wall-clock', '300', '--db', str(db)]
    _store_reservoir(args, db, reservoir)
    t0 = time.perf_counter()
    with open(log, 'wb') as f:
        try:
            rc = subprocess.run(
                [sys.executable, '-m', 'repro_torch.launch.qmc_run', *args],
                stdout=f, stderr=subprocess.STDOUT, env=_env_with_src(),
                timeout=300).returncode
        except subprocess.TimeoutExpired:
            rc = 'timeout'
    secs = time.perf_counter() - t0
    if rc != 0:
        print(log.read_text(errors='replace')[-4000:])
        _fail(f'[{label}] qmc_run exited {rc}')
    store = ResultDatabase(str(db))
    (key,) = store.run_keys()
    avg, blocks = store.running_average(key), store.blocks(key)
    store.close()
    rate, text, counts = _rate_together(blocks, (0, 1))
    print(f'[{label}] qmc_run --backend grid --workers 2, {WALKERS} walkers '
          f'a worker, {EQ_BLOCKS} blocks of 2 sweeps x 4 sub-blocks: {avg} '
          f'in {secs:.1f} s (process start to exit); {text}')
    if min(counts.values()) < 1:
        _fail(f'[{label}] a worker delivered no block: {counts}')
    launches = _worker_lines(label, log, (0, 1), ('fused_sweep', 'sparse_mo'),
                             FIRST_DESIGNS + ('sem_move',))
    _within_4_sigma(label, avg, ref, 'equilibrated fused-vmc')
    return avg, rate, launches


def _grid_drill(torch, seed: int, reservoir, out):
    """[grid] run 2, the reference's chaos drill on the card: 3 local
    workers (heartbeat timeout 0.5 s, 10 % of block packets dropped, drop
    seed 7); once all are live and the store holds a block, worker 0 is
    SIGKILLed and forwarder 1 killed, then one external ``qmc_worker
    --connect`` joins.  The run stops once worker 0 is declared dead, a
    packet was dropped, both survivors delivered after the kill and the
    external worker delivered 2 blocks.  Fails unless worker 0 alone was
    declared dead, a lease was requeued, the external worker was adopted
    and delivered, and every live worker printed launches of
    ``fused_sweep`` and ``sparse_mo`` (no first design, no
    ``sem_move``).  Returns (its average, {worker: launches})."""
    import numpy as np
    from repro_torch.launch.spec import RunSpec, build_run
    from repro_torch.runtime import GridConfig
    from repro_torch.runtime.grid import DEAD, LIVE
    label = 'grid drill'
    db, log = out / 'grid_drill.sqlite', out / 'grid_drill.log'
    ext_log = out / 'grid_external.log'
    for f in (db, log, ext_log):
        f.unlink(missing_ok=True)
    spec = RunSpec(system=SYSTEM, method='fused-vmc', backend='grid',
                   n_workers=3, n_walkers=WALKERS, steps=2, seed=seed,
                   max_blocks=100000, wall_clock_limit=240, db=str(db),
                   net=GridConfig(heartbeat_timeout=0.5, drop_rate=0.1,
                                  drop_seed=7))
    _store_spec_reservoir(spec, db, reservoir)
    run = build_run(spec)
    mgr, backend, key = run.manager, run.backend, run.run_key
    host, port = backend.address
    seen = {}

    def stored(w, after=0.0):
        return sum(b.worker_id == w and b.timestamp > after
                   for b in mgr.db.blocks(key))

    def drill():
        try:
            _wait_for(lambda: len(mgr.workers) == 3 and all(
                h.state == LIVE for h in mgr.workers)
                and mgr.db.n_blocks(key) > 0, 180,
                'three live workers and a stored block')
            seen['free_before'] = torch.cuda.mem_get_info()[0]
            seen['kill'], seen['kill_wall'] = time.monotonic(), time.time()
            mgr.workers[0].crash()
            mgr.kill_forwarder(1)
            seen['ext_start'] = time.time()
            with open(ext_log, 'wb') as f:
                seen['ext'] = subprocess.Popen(
                    [sys.executable, '-m', 'repro_torch.launch.qmc_worker',
                     '--connect', f'{host}:{port}'], stdout=f,
                    stderr=subprocess.STDOUT, env=_env_with_src())
            _wait_for(lambda: mgr.workers[0].state == DEAD, 30,
                      'death of worker 0')
            seen['free_after'] = torch.cuda.mem_get_info()[0]
            _wait_for(lambda: len(mgr.workers) == 4 and stored(3) >= 2
                      and backend.packets_dropped() > 0
                      and min(stored(w, seen['kill_wall'])
                              for w in (1, 2)) > 0, 180,
                      'two blocks of the external worker, a dropped packet '
                      'and blocks of both survivors after the kill')
        except Exception as e:          # failed below, after the run
            seen['error'] = repr(e)
        finally:
            mgr.request_stop()

    watcher = threading.Thread(target=drill, daemon=True)
    t0 = time.perf_counter()
    with _stdout_to(log):
        mgr.start()
        watcher.start()
        avg = run.run()
    watcher.join(10)
    ext = seen.get('ext')
    if ext is not None:
        try:
            ext.wait(timeout=30)
        except subprocess.TimeoutExpired:
            ext.kill()
            ext.wait()
    secs = time.perf_counter() - t0
    blocks = mgr.db.blocks(key)
    counts = {w.worker_id: sum(b.worker_id == w.worker_id for b in blocks)
              for w in mgr.workers}
    states = {w.worker_id: (w.state, w.dead_reason) for w in mgr.workers}
    dead = [(e[2], e[3], e[0]) for e in mgr.events if e[1] == 'dead']
    print(f'[{label}] {avg} in {secs:.1f} s; workers {states}; blocks per '
          f'worker {counts}; packets dropped {backend.packets_dropped()}, '
          f'leases requeued {backend.stolen_requeued}, served '
          f'{backend.stolen_served}; dead events '
          f'{[(w, r) for w, r, _ in dead]}; events '
          f'{[(e[1], e[2]) for e in mgr.events]}')
    bad = []
    if 'error' in seen:
        bad.append(seen['error'])
    if run.worker_errors():
        bad.append(f'worker errors {run.worker_errors()[:1]}')
    victim = mgr.workers[0]
    if not (victim.state == DEAD and victim.dead_reason):
        bad.append(f'worker 0 not declared dead: {states[0]}')
    if [w for w, _, _ in dead] != [0]:
        bad.append(f'dead events {dead}: only worker 0 was killed')
    if backend.stolen_requeued < 1 or backend.packets_dropped() <= 0:
        bad.append('no lease requeued or no packet dropped')
    if len(mgr.workers) < 4 or counts.get(3, 0) < 1:
        bad.append(f'the external worker was not adopted or delivered '
                   f'nothing ({len(mgr.workers)} workers, {counts})')
    if ext is None or ext.returncode != 0:
        bad.append(f'the external worker exited '
                   f'{None if ext is None else ext.returncode}')
    if bad:
        for f in (log, ext_log):
            if f.exists():
                print(f.read_text(errors='replace')[-3000:])
        _fail(f'[{label}] ' + '; '.join(bad))
    t_dead = next(t for w, _, t in dead if w == 0) - seen['kill']
    first = min(b.timestamp for b in blocks if b.worker_id == 3)
    gib = 2 ** 30
    walkers = np.asarray(victim.init_walkers)
    print(f'[{label}] SIGKILL of worker 0 to its dead event {t_dead:.3f} s '
          f'(heartbeat timeout 0.5 s); external worker start to its first '
          f'stored block {first - seen["ext_start"]:.2f} s (interpreter, '
          f'torch import, CUDA context, kernel libraries, the tuner from '
          f'its cache, the sampler and its first block); free device '
          f'memory {seen["free_before"] / gib:.2f} GiB before the kill, '
          f'{seen["free_after"] / gib:.2f} GiB at the dead event; blocks of '
          f'worker 1 / 2 after the kill {stored(1, seen["kill_wall"])} / '
          f'{stored(2, seen["kill_wall"])}; WELCOME restart walkers '
          f'{walkers.shape} ({len(json.dumps(walkers.tolist()))} bytes of '
          f'JSON)')
    launches = _worker_lines(label, log, (1, 2), ('fused_sweep', 'sparse_mo'),
                             FIRST_DESIGNS + ('sem_move',))
    launches.update(_worker_lines(
        f'{label} external', ext_log, (3,), ('fused_sweep', 'sparse_mo'),
        FIRST_DESIGNS + ('sem_move',)))
    return avg, launches


def _grid_run(label: str, spec, out, needs, forbid):
    """One in-process ``build_run(spec).run()`` on the grid backend with
    its workers' output in a log; fails on a worker error or a worker
    declared dead, and checks their closing lines.  Returns (the run,
    its result, {worker: launches}, seconds)."""
    from repro_torch.launch.spec import build_run
    from repro_torch.runtime.grid import DEAD
    log = out / f'{label.replace(" ", "_")}.log'
    log.unlink(missing_ok=True)
    run = build_run(spec)
    t0 = time.perf_counter()
    with _stdout_to(log):
        res = run.run()
    secs = time.perf_counter() - t0
    dead = [w.worker_id for w in run.manager.workers if w.state == DEAD]
    if run.worker_errors() or dead:
        print(log.read_text(errors='replace')[-4000:])
        _fail(f'[{label}] worker errors {run.worker_errors()[:1]}, dead '
              f'workers {dead}')
    ids = [w.worker_id for w in run.manager.workers]
    return run, res, _worker_lines(label, log, ids, needs, forbid), secs


def phase_grid(torch, dev, seed: int, runs: dict, pool, eq: dict):
    """[grid]: the TCP grid backend with ``qmc_worker`` processes on the
    card, from [opt-vmc]'s equilibrated walkers (stored as each run's
    reservoir): run 1 ``qmc_run`` spawns 2 workers (``_grid_spawn``),
    run 2 the fault drill (``_grid_drill``), run 3 ``dmc`` over the grid
    (2 workers, E_TRIAL packets; one block of 5 generations, cut from 2
    for the script's time limit, from
    ``pool`` = (positions, energies) of finite cold-start walkers), run 4
    h2 ``opt-vmc`` (dense MO product: no kernel; P = 3,
    2 SR steps, 2 workers, one sub-block a block; PARAMS packets).
    Adds each worker's launches to ``runs``."""
    from repro_torch.launch.spec import RunSpec
    eq = _equilibrated(torch, dev, seed, runs, eq)
    reservoir = (eq['R'].cpu().numpy(), eq['E'].cpu().numpy())
    out = ROOT / 'build' / 'chip_smoke'
    out.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    per_move = FIRST_DESIGNS + ('sem_move', 'fused_sweep')
    avg1, rate, got = _grid_spawn(seed, reservoir, eq['fused'], out)
    runs.update({f'grid spawn worker {w}': n for w, n in got.items()})
    avg2, got = _grid_drill(torch, seed, reservoir, out)
    runs.update({f'grid drill worker {w}': n for w, n in got.items()})
    _within_4_sigma('grid drill', avg2, avg1, 'grid spawn')
    # DMC over the grid: E_TRIAL packets between blocks
    label = 'grid dmc'
    db = out / 'grid_dmc.sqlite'
    db.unlink(missing_ok=True)
    spec = RunSpec(system=SYSTEM, method='dmc', backend='grid', n_workers=2,
                   n_walkers=WALKERS, steps=5, max_blocks=1, seed=seed,
                   wall_clock_limit=300, db=str(db))
    _store_spec_reservoir(spec, db, (pool[0].cpu().numpy(),
                                     pool[1].cpu().numpy()))
    run, avg, got, secs = _grid_run(label, spec, out, ('sparse_mo',),
                                    per_move)
    print(f'[{label}] 2 workers, {avg} in {secs:.1f} s')
    if not (avg.n_blocks >= 1 and math.isfinite(avg.energy)):
        _fail(f'[{label}] no finite energy from {avg.n_blocks} blocks')
    _dmc_stats(label, db, steps=5)
    runs.update({f'{label} worker {w}': n for w, n in got.items()})
    # opt-vmc over the grid: PARAMS packets, one version a block; h2 is a
    # molecule of the catalog, whose MO product is the dense one: no kernel
    label = 'grid opt-vmc'
    spec = RunSpec(system='h2', method='opt-vmc', backend='grid',
                   n_workers=2, n_walkers=32, steps=10, subblocks_per_block=1,
                   opt_steps=2, opt_blocks_per_step=3, seed=3, db=':memory:',
                   wall_clock_limit=300)
    run, res, got, secs = _grid_run(label, spec, out, (),
                                    tuple(_counters()))
    stamps = {}
    for b in run.db.blocks(run.run_key):
        if 'opt_pv' in b.aux:
            stamps.setdefault(b.worker_id, []).append(b.aux['opt_pv'])
    print(f'[{label}] h2, 2 worker processes on the card, 2 SR steps in '
          f'{secs:.1f} s: E = ' + ', '.join(
              f'{s.energy:+.5f} +/- {s.error:.5f}' for s in res.steps)
          + f'; stamps by worker {dict(sorted(stamps.items()))}')
    flat = [v for vs in stamps.values() for v in vs]
    if len(res.steps) != 2 or not flat or not all(
            float(v).is_integer() for v in flat):
        _fail(f'[{label}] {len(res.steps)} steps, stamps {stamps}')
    runs.update({f'{label} worker {w}': n for w, n in got.items()})
    print(f'[grid] phase {time.perf_counter() - t_phase:.1f} s; blocks/s of '
          f'2 grid workers while both delivered: '
          + ('not measured (no common window)' if rate is None
             else f'{rate:.4f}'))


def phase_sim(torch, dev, seed: int, runs: dict, eq: dict):
    """[sim]: the simulated grid in this process at the card's width, the
    CPU drill's settings (3 thread workers behind lossy links, 10 %
    packet loss, worker 0 crashed after its first block, forwarder 1
    killed at the store's 4th), ``smallest`` fused-vmc from [opt-vmc]'s
    equilibrated walkers, 12 blocks.  Fails unless fused_sweep and
    sparse_mo launched (no first design), a packet was dropped, both
    failures fired, the energy is within 4 sigma of ``equilibrated
    fused-vmc`` and no worker thread outlives ``run()``."""
    from repro_torch.launch.spec import RunSpec, build_run
    from repro_torch.runtime import SimGridConfig
    eq = _equilibrated(torch, dev, seed, runs, eq)
    label = 'sim'
    db = ROOT / 'build' / 'chip_smoke' / 'sim.sqlite'
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    spec = RunSpec(system=SYSTEM, method='fused-vmc', backend='sim',
                   n_workers=3, n_walkers=WALKERS, steps=2, max_blocks=12,
                   seed=seed, wall_clock_limit=300, db=str(db),
                   grid=SimGridConfig(latency=0.001, drop_rate=0.1, seed=2,
                                      worker_failures=((0, 1),),
                                      forwarder_failures=((1, 4),)))
    _store_spec_reservoir(spec, db, (eq['R'].cpu().numpy(),
                                     eq['E'].cpu().numpy()))
    counters = _counters()
    for c in counters.values():
        c.reset()
    before = set(threading.enumerate())
    t0 = time.perf_counter()
    run = build_run(spec)
    avg = run.run()
    secs = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    alive = [t.name for t in set(threading.enumerate()) - before
             if t.is_alive() and not isinstance(t, threading._DummyThread)]
    workers = [w.worker_id for w in run.manager.workers if w.running]
    fired = sorted(run.backend._fired)
    counts = {w.worker_id: w.blocks_done for w in run.manager.workers}
    print(f'[{label}] {SYSTEM} fused-vmc, 3 thread workers x {WALKERS} '
          f'walkers behind simulated links: {avg} in {secs:.1f} s; blocks '
          f'done per worker {counts}; packets dropped '
          f'{run.backend.packets_dropped()}; failures fired {fired}; '
          f'launches {launches}')
    bad = []
    if run.worker_errors():
        bad.append(f'worker errors {run.worker_errors()[:1]}')
    if alive or workers:
        bad.append(f'threads {alive} / workers {workers} still running '
                   f'after run() returned')
    bad += [f'{k} never launched' for k in ('fused_sweep', 'sparse_mo')
            if launches[k] <= 0]
    bad += [f'{k} launched {launches[k]} times'
            for k in FIRST_DESIGNS + ('sem_move',) if launches[k]]
    if run.backend.packets_dropped() <= 0 or fired != [('f', 1), ('w', 0)]:
        bad.append('no packet dropped, or a failure did not fire')
    if avg.n_blocks < 12:
        bad.append(f'{avg.n_blocks} blocks')
    if bad:
        _fail(f'[{label}] ' + '; '.join(bad))
    _within_4_sigma(label, avg, eq['fused'], 'equilibrated fused-vmc')
    runs['sim fused-vmc'] = launches


# the fault-tolerant example's event-driven depth on the card: worker 0
# crashed once this many blocks are stored, run 1 to this many blocks, run
# 2 this many more (the script's defaults: 15 s and 5 s of sleeps, 200
# blocks, +100).  Four thread workers on one card delivered 0.35-0.62
# blocks/s (PERF.md §7), so 8, 40, +20 took 98 s: cut to fit the phase's
# 30 s
FT_KILL_AT, FT_MAX_BLOCKS, FT_EXTRA = 2, 6, 3


def _example(name: str):
    """``examples/<name>.py`` of this checkout, imported as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / 'examples' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quickstart(torch, dev, runs: dict) -> list:
    """``examples/torch_quickstart.py`` at its own depth (the reference's:
    256 walkers, 3 VMC blocks, 1 + 4 DMC blocks of 60 steps) through its
    ``main``; then its walker (drawn on the card from the same generator)
    through each MO-product path alone: ``kernel`` launches sparse_mo,
    ``dense`` and ``sparse`` do not, the three E_L agree to 1e-5
    relative, and the card's ``kernel`` E_L equals the CPU's (the plain
    version of sparse_mo) on the same walker to 1e-5 relative.  Returns
    the failures."""
    from repro_torch.systems.molecule import build_wavefunction, water
    qs = _example('torch_quickstart')
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    out = qs.main(device=dev)
    secs = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    runs['examples quickstart'] = launches
    bad = []
    for kind in ('vmc', 'dmc'):
        for i, b in enumerate(out[kind]):
            print(f'[examples] quickstart {kind} block {i}: E = '
                  f'{b["e"]:+.6f}, accept {b["accept"]:.4f}, '
                  f'{b["secs"] * 1e3:.1f} ms')
            if not math.isfinite(b['e']):
                bad.append(f'quickstart {kind} block {i}: E = {b["e"]}')
    print(f'[examples] quickstart: E(VMC) {out["e_vmc"]:+.6f}, E(DMC) '
          f'{out["e_dmc"]:+.6f} +/- {out["e_dmc_err"]:.6f}, E_T '
          f'{", ".join(f"{e:+.4f}" for e in out["e_trial"])}; {secs:.2f} s; '
          f'launches {launches}')
    if launches['sparse_mo'] <= 0:
        bad.append('quickstart: sparse_mo never launched')
    bad += [f'quickstart: {k} launched {n} times' for k, n in launches.items()
            if k != 'sparse_mo' and n]
    cfg, params = build_wavefunction(*water(), method='dense', device=dev)
    r = torch.randn((cfg.n_elec, 3), generator=qs._gen(0, dev),
                    device=dev) * 1.2
    e_card, by_path = {}, {}
    for path in qs.MO_PATHS:
        for c in counters.values():
            c.reset()
        e_card.update(qs.method_consistency(cfg, params, r, paths=(path,)))
        by_path[path[0]] = counters['sparse_mo'].n
    cfg_c, params_c = build_wavefunction(*water(), method='dense',
                                         device='cpu')
    e_cpu = qs.method_consistency(cfg_c, params_c, r.cpu(),
                                  paths=(('kernel', {}),))['kernel']

    def _gap(x, ref):
        return abs(x - ref) / abs(ref)
    spread = max(_gap(e_card[m], e_card['dense']) for m in e_card)
    vs_cpu = _gap(e_card['kernel'], e_cpu)
    vs_main = max(_gap(e_card[m], out['e_loc'][m]) for m in e_card)
    print(f'[examples] quickstart MO paths on the card: '
          + ', '.join(f'{m} {e:+.6f} (sparse_mo launches {by_path[m]})'
                      for m, e in e_card.items())
          + f'; largest relative gap {spread:.2e}; kernel vs the CPU\'s '
          f'plain path {e_cpu:+.6f} ({vs_cpu:.2e}); vs main\'s {vs_main:.2e}')
    if by_path['kernel'] <= 0 or by_path['dense'] or by_path['sparse']:
        bad.append(f'quickstart: sparse_mo launches by path {by_path}')
    if not (spread <= 1e-5 and vs_cpu <= 1e-5 and vs_main <= 1e-5):
        bad.append(f'quickstart: E_L paths {spread:.2e}, card vs cpu '
                   f'{vs_cpu:.2e}, vs main {vs_main:.2e} (limit 1e-5)')
    return bad


def _fault_tolerant(torch, runs: dict) -> list:
    """``examples/torch_dmc_fault_tolerant.py`` in its event-driven form
    on ``cuda:0`` (four thread workers; ``FT_*`` depth): the time from the
    crash to the join, blocks/s before and after the crash, run 2's
    workers seeded from the reservoir.  The script asserts that no worker
    raised.  Returns the failures."""
    ft = _example('torch_dmc_fault_tolerant')
    db = ROOT / 'build' / 'chip_smoke' / 'examples_fault_tolerant.sqlite'
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    counters = _counters()
    for c in counters.values():
        c.reset()
    before = set(threading.enumerate())
    out = ft.main(device='cuda:0', kill_at_blocks=FT_KILL_AT, join_after=0.0,
                  max_blocks=FT_MAX_BLOCKS, extra_blocks=FT_EXTRA, db=db)
    runs['examples fault-tolerant'] = {k: c.n for k, c in counters.items()}
    alive = [t.name for t in set(threading.enumerate()) - before
             if t.is_alive() and not isinstance(t, threading._DummyThread)]
    t, avg1, avg2 = out['t'], out['avg1'], out['avg2']
    k = out['blocks_at_kill']
    print(f'[examples] fault-tolerant h2 dmc, 4 thread workers on cuda:0: '
          f'{k} blocks stored at the crash, {k / (t["kill"] - t["start"]):.2f} '
          f'blocks/s before it (from the start, worker start-up included), '
          f'{(avg1.n_blocks - k) / (t["end"] - t["kill"]):.2f} after it (to '
          f'the graceful stop); crash to join {t["join"] - t["kill"]:.3f} s; '
          f'run 1 {avg1} in {t["end"] - t["start"]:.2f} s; run 2 '
          f'{out["restarted"]}/2 seeded from the reservoir, {avg2}; '
          f'launches {runs["examples fault-tolerant"]}')
    bad = []
    if out['restarted'] != 2 or out['killed_running']:
        bad.append(f'fault-tolerant: {out["restarted"]}/2 seeded, crashed '
                   f'worker running {out["killed_running"]}')
    if not (math.isfinite(avg2.energy)
            and avg2.n_blocks >= avg1.n_blocks + FT_EXTRA):
        bad.append(f'fault-tolerant: run 2 {avg2} after run 1 {avg1}')
    if alive:
        bad.append(f'fault-tolerant: threads {alive} still running')
    return bad


def phase_examples(torch, dev, runs: dict):
    """[examples]: the two ported example scripts on the card
    (``_quickstart``, ``_fault_tolerant``); fails on any failure of
    either."""
    t0 = time.perf_counter()
    bad = _quickstart(torch, dev, runs)
    t1 = time.perf_counter()
    bad += _fault_tolerant(torch, runs)
    t2 = time.perf_counter()
    print(f'[examples] quickstart {t1 - t0:.1f} s, fault-tolerant '
          f'{t2 - t1:.1f} s, phase {t2 - t0:.1f} s')
    if bad:
        _fail('[examples] ' + '; '.join(bad))


def _layer_line(torch, label, prop, p, st, gen, pop, warmup: bool = True):
    """One ``[layer]`` line: ``prop`` propagates ``st`` once as a warm-up
    (unless the caller ran the same path just before: ``warmup=False``),
    then once under the profiler; wall by the host clock around a
    synchronised call, device busy the profiler's summed kernel time, the
    launches issued a move, the MO product's and the per-move kernels'
    share, with DMC the reconfiguration alone by CUDA events, and the
    heaviest kernels.  Returns the state."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.dmc import DMCPropagator, reconfigure_ensemble
    if warmup:
        st, _ = prop.propagate(p, st, gen, pop)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, _ = prop.propagate(p, st, gen, pop)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    tr = Trace(prof)
    busy = tr.busy
    mo_ms, mo_n = tr.part('tile_kernel')
    per = {}
    for name in ('fused_sweep', 'sem_move'):
        ms, count = tr.part(name)
        per[name] = f'{name} {ms:.3f} ms x{count}'
    reconf = ''
    if isinstance(prop, DMCPropagator):
        # the reconfiguration (cumsum, searchsorted, the five gathers)
        # alone, on this generation's ensemble, by CUDA events
        ens = st.ens
        w = torch.rand(ens.r.shape[0], generator=gen,
                       device=ens.r.device) * 4.0
        u_r = torch.rand((), generator=gen, device=ens.r.device)
        r_ms, _ = _time_ms(lambda: reconfigure_ensemble(ens, w, u_r, pop))
        reconf = (f'; reconfiguration {r_ms:.4f} ms '
                  f'({100 * r_ms / busy:.2f} % of the device busy time)')
    print(f'[layer] {label}: wall {wall:.2f} ms, device '
          f'busy {busy:.2f} ms (idle {100 * (1 - busy / wall):.1f} %; '
          f'{tr.recorded} device records for {tr.issued} launches and '
          f'copies issued, {tr.issued / prop.cfg.n_elec:.1f} a move); MO '
          f'product {mo_ms:.3f} ms x{mo_n}; {per["fused_sweep"]}; '
          f'{per["sem_move"]}{reconf}; top: {tr.top()}')
    return st


def phase_layers(torch, dev, pool):
    """Wall time, device-busy time and the heaviest kernels of one vmc
    step, one sem-vmc sweep and one fused-vmc sweep at the main path's
    shapes (``smallest``), one sem-vmc --n-det 100 sweep, and of a screened
    vmc step and fused-vmc sweep and an unscreened vmc step on the b-strand
    (from the finite walkers ``pool``), in the same run, with the launches
    issued a move (issued / n_e); both sem-vmc sweeps also on the host
    clock alone, ``LAYER_WALL_ROUNDS`` sweeps after one to warm up; the
    b-strand's fused-vmc sweep also with the kernel forced to its first
    design (the shared route at its tuned threads per block), to set the
    two designs side by side end to end."""
    from repro_torch.core.driver import Population, make_propagator
    from repro_torch.core.vmc import VMCPropagator
    from repro_torch.kernels.fused_sweep import autotune
    from repro_torch.systems import build_system
    tuned = autotune.best_launch

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
    sem_cells = [(f'sem-vmc{tag_s} sweep at W={WALKERS}',
                  make_propagator('sem-vmc', c), pp, None)
                 for tag_s, c, pp in (('', cfg, params),
                                      (' --n-det 100', cfg_ci, params_ci))]
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
             params_u, walkers),
            # one DMC generation (no cold-start equilibration here: the
            # layer is the generation, not the start)
            (f'dmc generation at W={WALKERS}',
             make_propagator('dmc', cfg, equil_steps=0), params, None),
            (f'{tag} dmc generation',
             make_propagator('dmc', cfg_s, equil_steps=0), params_s,
             walkers)):
        gen.manual_seed(5)       # the cells of one kind start alike
        autotune.best_launch = (_first_design if 'first design' in label
                                else tuned)
        try:
            _layer_line(torch, label, prop, p, prop.init(p, gen, WALKERS, w),
                        gen, pop)
        finally:
            autotune.best_launch = tuned
    # the host clock alone (no profiler)
    for tag_s, c, pp in (('', cfg, params), (' --n-det 100', cfg_ci,
                                             params_ci)):
        prop = make_propagator('sem-vmc', c)
        gen.manual_seed(5)
        st = prop.init(pp, gen, WALKERS)
        walls = []
        for i in range(LAYER_WALL_ROUNDS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prop.propagate(pp, st, gen, pop)
            torch.cuda.synchronize()
            if i:                                  # sweep 0 warms up
                walls.append((time.perf_counter() - t0) * 1e3)
        print(f'[layer wall] sem-vmc{tag_s} sweep at W={WALKERS}, host clock '
              f'without the profiler, {LAYER_WALL_ROUNDS} sweeps from one '
              f'state: median {statistics.median(walls):.2f} ms, min '
              f'{min(walls):.2f} ms ({", ".join(f"{x:.1f}" for x in walls)})')


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
    rows.append(_replay_row(launches))
    rows.append(_time_multidet_ratio(torch, rec, launches))
    rows.append(_time_screened_mo(torch, rec, launches))
    return rows


def _move_times(torch, blk, r, sign, logdet, n_up: int, b_ee, ci_t=None,
                iters: int = 50):
    """The first move (e = 0) of ``blk`` through one sem_move launch (all
    walkers, on copies of the state, by ``_time_ms``), its plain version
    on the card, the PyTorch calls that do the most of it (torch.bmm for
    u, torch.baddbmm for the update, with CI the einsum of the table
    pass; no single call does the move) and the bound from the move's own
    accepts.  ``ci_t``: the expansion's ``CITensors`` (the up block's
    lists).  Returns a dict of the readings."""
    from repro_torch.kernels.fused_sweep.ref import _ee_sum
    from repro_torch.kernels.sem_update import kernel as suk
    from repro_torch.kernels.sem_update.ops import sem_move
    from repro_torch.kernels.sem_update.ref import sem_move_ref
    e, j = 0, blk['offset']
    with_ci = ci_t is not None
    W, n, _ = blk['minv'].shape
    v = blk['phi'][:, e]
    rp = blk['r_prop'][:, e].contiguous()
    d_jas = (_ee_sum(r, j, rp, n_up, b_ee) - _ee_sum(r, j, r[:, j], n_up, b_ee)
             + blk['en'][:, e]).contiguous()
    lu = blk['logu'][:, e]
    src = [r, blk['minv'], sign, logdet]
    ci = ci_p = None
    if with_ci:
        src += [blk['P'], blk['rdet']]
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
    ms, wall = _time_ms(_kernel, iters=iters, minus=_restore)
    plain, _ = _time_ms(lambda: sem_move_ref(
        (r.clone(), *src[1:], *(() if with_ci else (None, None))),
        v, rp, d_jas, lu, e, j, ci_p), iters=20)
    minv, phi = blk['minv'], v[:, :n].contiguous()
    row = minv[:, e].contiguous()

    def _library():
        u = torch.bmm(minv, phi[:, :, None])
        torch.baddbmm(minv, u, row[:, None, :], alpha=-1.0)
        if with_ci:
            torch.einsum('woh,wh->wo', blk['P'], phi)
    lib, _ = _time_ms(_library, iters=iters)
    n_cols = v.shape[1]
    n_orb = blk['P'].shape[1] if with_ci else 0
    n_det = blk['rdet'].shape[1] if with_ci else 0
    # each input read once, each output written once: Minv (and P) of
    # every walker read, of the accepted ones written; v, the move's
    # vectors; with CI the ratios read and, accepted, written
    nbytes = 4.0 * (W * n * n + n_acc * n * n + W * n_cols + 8 * W
                    + (W + n_acc) * n_orb * n
                    + (3 * W + n_acc) * n_det)
    flops = 2.0 * W * (n * n + n_orb * n) + 2.0 * n_acc * (n * n + n_orb * n)
    bound, by = _bound_ms(nbytes, flops)
    shape = suk.move_shape(n, n_cols, n_orb, n_det, with_ci,
                           optin=suk.device_optin(v.device))
    return dict(ms=ms, wall=wall, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, n_acc=int(n_acc), W=W, n=n,
                n_orb=n_orb, n_det=n_det, nbytes=nbytes, flops=flops,
                shape=shape)


def _move_line(label, t, with_ci: bool) -> str:
    """The [time] line of one ``_move_times`` reading."""
    return (f'[time] sem_move {label} (device, one move, W={t["W"]}, '
            f'n={t["n"]}' + (f', n_orb={t["n_orb"]}, n_det={t["n_det"]}'
                             if with_ci else '')
            + f', {t["n_acc"]}/{t["W"]} accepted): {t["ms"]:.4f} ms kernel '
            f'(host {t["wall"]:.4f} with the state copy), {t["shape"]}; '
            f'{t["plain_ms"]:.4f} ms plain; {t["library_ms"]:.4f} ms '
            f'torch.bmm (u) + torch.baddbmm (the update)'
            + (' + the einsum of the table pass' if with_ci else '')
            + f' (no single library call does the move); bound '
            f'{t["bound_ms"]:.4f} ms ({t["bound_by"]}: '
            f'{t["nbytes"] / 1e6:.3f} MB, {t["flops"] / 1e9:.4f} GFLOP)')


def _time_sem_move(torch, rec, launches):
    """One sem_move launch (a move of all walkers, W = 256) on the main
    path's cold-start state: smallest at n = 79 (the kernels line's row),
    with CI at n_det = 100 (n_orb = 118) and the b-strand's n = 217 (both
    printed); each beside its plain version on the card, the PyTorch calls
    that do the most of it and the bound (``_move_times``)."""
    out = {}
    cases = [('smallest', rec['sem_move_1'], False),
             ('CI', rec['sem_move_100'], True)]
    if 'fused_sweep_bstrand' in rec:
        cases.append((BSTRAND, rec['fused_sweep_bstrand'], False))
    for label, (cfg, params, blk, ens), with_ci in cases:
        t = _move_times(torch, blk, ens.r, ens.sign, ens.logdet, cfg.n_up,
                        params.jastrow.b_ee, cfg.ci_t if with_ci else None)
        print(_move_line(label, t, with_ci))
        out[label] = {k: t[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                        'bound_by', 'library_ms')}
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
           if BSTRAND in out else {}),
        paper_ci_moves={tag: rows['sem_move']
                        for tag, rows in PAPER_CI_TIMES.items()})


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


def _fused_times(torch, blk, ens, n_up: int, b_ee, ci=None, iters=20,
                 warmup=3, **kl):
    """(device ms, host ms with the state copy, accept flags, route, shape)
    of one fused_sweep launch of ``blk`` on copies of its state (``ens``:
    r, sign, logdet), by ``_time_ms``; with ``iters=1, warmup=0`` (a
    launch of 0.1 s and more, past n = 256) the one launch by ``_once_ms``,
    the state copied before it.  ``ci`` = (r_other, holes,
    parts, coeffs) of the kernel's lists; ``kl`` the launch."""
    from repro_torch.kernels.fused_sweep.kernel import (device_card,
                                                        fused_sweep_inplace,
                                                        launch_shape)
    src = [blk['minv'], ens.r, ens.sign, ens.logdet]
    if ci is not None:
        src += [blk['P'], blk['rdet']]
    bufs = [torch.clone(x, memory_format=torch.contiguous_format)
            for x in src]
    ins = [blk[k].contiguous() for k in ('phi', 'r_prop', 'en', 'logu')]

    def _restore():
        for b, x in zip(bufs, src):
            b.copy_(x)

    def _kernel():
        _restore()
        cia = None if ci is None else (bufs[4], bufs[5], *ci)
        return fused_sweep_inplace(bufs[0], ins[0], bufs[1], *ins[1:],
                                   bufs[2], bufs[3], b_ee, cia,
                                   offset=blk['offset'], n_up=n_up, **kl)
    if iters == 1 and warmup == 0:
        cia = None if ci is None else (bufs[4], bufs[5], *ci)
        _restore()
        ms, wall, (acc, _, route) = _once_ms(torch, lambda: (
            fused_sweep_inplace(bufs[0], ins[0], bufs[1], *ins[1:], bufs[2],
                                bufs[3], b_ee, cia, offset=blk['offset'],
                                n_up=n_up, **kl)))
    else:
        acc, _, route = _kernel()
        ms, wall = _time_ms(_kernel, iters=iters, warmup=warmup,
                            minus=_restore)
    W, n, n_cols = ins[0].shape
    shape = launch_shape(
        n, n_cols, ens.r.shape[1], *(() if ci is None else (
            blk['P'].shape[1], blk['rdet'].shape[1], True)), walkers=W,
        card=device_card(blk['minv'].device), **kl)
    return ms, wall, acc, route, shape


def _fused_work(W: int, n: int, n_e: int, n_acc: float, n_orb: int = 0,
                n_det: int = 0, k: int = 2, held: int = 0):
    """(bytes, fp32 operations) one spin block's sweep must move and do:
    each input read once, each output written once; per move the ratio
    (2n) and two e-e Pade sums over n_e (~12 flops a pair), per accepted
    move u = Minv phi and the rank-1 update (4 n^2).  With CI (``n_orb``
    orbitals, ``n_det`` determinants of rank ``k`` naming ``held``
    distinct particles): phi over all n_orb orbitals, the table P read and
    written, the ratios rdet read and written and r_other read, the lists
    and coefficients; per move the ratios need g only at the particles'
    rows (2 held n) and each determinant's k x k determinant (~2 k^3); per
    accepted move P's update needs g at the other rows (2 (n_orb - held)
    n) and the rank-1 update of all of them (2 n_orb n).  (``held`` =
    n_orb gives the count this function made before the cluster route
    took CI: g over all n_orb rows on every move, 2 n_orb n, which no
    design needs: a rejected move reads P only where the determinants
    do.)"""
    cols = n_orb or n
    nbytes = 4.0 * (2 * W * n * n + W * n * cols + 2 * W * n_e * 3
                    + W * n * 3 + 2 * W * n + 4 * W + W * n) + W * n
    flops = W * n * (2.0 * n + 24.0 * n_e) + n_acc * 4.0 * n * n
    if n_orb:
        nbytes += 4.0 * (2 * W * n_orb * n + 3 * W * n_det + n_det
                         + 2 * n_det * k)
        flops += (W * n * (2.0 * held * n + 2.0 * k ** 3 * n_det)
                  + n_acc * (2.0 * (n_orb - held) * n + 2.0 * n_orb * n))
    return nbytes, flops


def _replay_work(W: int, n: int, n_rep: int, n_orb: int, n_acc: float):
    """(bytes, fp32 operations) of the replay of P: its n_rep rows read
    and written once, each accepted move's row (n) and phi (n_orb) read
    once, the flags; per accepted move and row g (2n) and the update
    (2n)."""
    nbytes = 4.0 * (2 * W * n_rep * n + n_acc * (n + n_orb) + n_rep) + W * n
    return nbytes, n_acc * 4.0 * n_rep * n


@contextlib.contextmanager
def _replay_split(torch, fsk, keep: bool = False):
    """While open, ``fused_sweep_inplace``'s replay launches between CUDA
    events (its device time apart from the chain's); with ``keep`` each
    call's inputs (P as the chain left it, the rows, phi, the flags, the
    rows replayed) and its output are kept.  Yields the list of calls."""
    orig = fsk.p_replay_inplace
    calls = []

    def _timed(P, rows, phi, acc, rep):
        rec = dict(e0=torch.cuda.Event(enable_timing=True),
                   e1=torch.cuda.Event(enable_timing=True))
        if keep:
            rec.update(P0=P.clone(), rows=rows, phi=phi, acc=acc, rep=rep)
        rec['e0'].record()
        orig(P, rows, phi, acc, rep)
        rec['e1'].record()
        if keep:
            rec['P'] = P.clone()
        calls.append(rec)
    fsk.p_replay_inplace = _timed
    try:
        yield calls
    finally:
        fsk.p_replay_inplace = orig


def _replay_row(launches):
    """The kernels line's row of ``fused_sweep_p_replay``, the cluster
    route's second kernel with CI: its time, bound and plain version at
    the first paper system's up block of [paper systems ci] (1ze7 at
    n_det = 100: the main path that launches it), the other blocks' times
    beside them, the largest error of the replay alone against
    ``p_replay_ref`` over all blocks.  No single PyTorch call computes the
    replay (a chain of rank-1 updates whose g each needs the last)."""
    if not PAPER_CI_TIMES:
        _fail('[time] fused_sweep_p_replay: [paper systems ci] timed no block')
    tag, blocks = next(iter(PAPER_CI_TIMES.items()))
    up = blocks['fused_sweep up']
    every = [b for rows in PAPER_CI_TIMES.values() for k, b in rows.items()
             if k.startswith('fused_sweep')]
    print(f'[time] fused_sweep_p_replay {tag} n_det={CI_DETS} up block '
          f'(device, W={WALKERS}, n={up["n"]}): {up["replay_ms"]:.4f} ms, '
          f'plain {up["replay_plain_ms"]:.2f} ms, bound '
          f'{up["replay_bound_ms"]:.4f} ms ({up["replay_bound_by"]})')
    return dict(
        name='fused_sweep_p_replay', route='cuda',
        source='src/repro_torch/csrc/fused_sweep.cu',
        replaces='src/repro/kernels/fused_sweep/kernel.py:95',
        launches=launches['fused_sweep_p_replay'],
        max_abs_err=max(b['replay_abs_err'] for b in every),
        max_rel_err=max(b['replay_rel_err'] for b in every),
        ms=up['replay_ms'], plain_ms=up['replay_plain_ms'],
        bound_ms=up['replay_bound_ms'], bound_by=up['replay_bound_by'],
        library_ms=None,
        paper_ci_blocks={t: {k: rows[k]['replay_ms'] for k in rows
                             if k.startswith('fused_sweep')}
                         for t, rows in PAPER_CI_TIMES.items()})


def _time_fused_sweep(torch, rec, launches):
    """One fused_sweep launch (the up block of a sweep at the main path's
    shapes: smallest, W = 256, n = 79) at the tuned launch, its plain
    version on the card, and the largest piece one PyTorch call does: the
    torch.bmm of u = Minv phi for one move of all walkers.  Beside it, in
    the same run: the CI variant (n_det = 100) and the b-strand's up block
    (n = 217), each also through the first design (shared route at its
    tuned threads per block), and the b-strand at one and two threads a
    row; cycles a move at the card's max SM clock."""
    from repro_torch.kernels.fused_sweep.ref import fused_sweep_ref
    cfg, params, blk, ens = rec['fused_sweep']['inputs']
    launch, tables = rec['fused_sweep']['launch'], rec['fused_sweep']['tables']
    b_ee = params.jastrow.b_ee
    mhz = _sm_clock_mhz()

    def _timed(blk, ens, n_up, b_ee, ci=None, **kl):
        return _fused_times(torch, blk, ens, n_up, b_ee, ci, **kl)

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
    nbytes, flops = _fused_work(W, n, n_e, n_acc)
    bound, by = _bound_ms(nbytes, flops)
    for tag, rows in PAPER_CI_TIMES.items():
        up = rows['fused_sweep up']
        print(f'[time] fused_sweep {tag} n_det={CI_DETS} up block (n='
              f'{up["n"]}, synthetic; from [paper systems ci]): '
              f'{up["ms"]:.4f} ms kernels (chain {up["chain_ms"]:.4f}, '
              f'replay {up["replay_ms"]:.4f}; global route '
              f'{up["global_ms"]:.4f}), {up["plain_ms"]:.2f} ms plain, '
              f'{up["library_ms"]:.4f} ms torch.bmm of one move\'s u + the '
              f'einsum of its table pass; bound {up["bound_ms"]:.4f} ms')
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
        first_design_ci_ms=first_ci, first_design_bstrand_ms=first_b,
        paper_ci_blocks={tag: {k: v for k, v in rows.items()
                               if k.startswith('fused_sweep')}
                         for tag, rows in PAPER_CI_TIMES.items()})


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


PRECISION_SWEEPS = 4          # inside one refresh period (sem_refresh = 8)


def _storage_resolved(torch, cfg, params, R):
    """Which walkers the storage policy ``cfg.precision`` can hold at R,
    and the fp64 state there: in both spin blocks the fresh fp32 inverse
    within ``FP32_SCOPE`` of the fp64 inverse of the same fp32 matrix, and
    that inverse stored once in the policy's dtype and refined once (the
    corrector) within a tenth of ``slater.drift_tolerance`` of fp64 (the
    same rule at the storage precision: an fp16 entry past fp16's range
    x 16 stores inf; one refinement of a rounded inverse does not converge
    on a block whose condition number passes the dtype's inverse
    roundoff).  Returns (mask (W,) on the CPU, {block: fp64 inverse},
    fp64 logdet, fp64 sign)."""
    import dataclasses
    from repro_torch.core import slater
    from repro_torch.core.sem import _to_compute, _to_storage, evaluate_sem
    from repro_torch.core.wavefunction import (_mo_tensor_ensemble,
                                               _slater_blocks)
    Cw, _ = _mo_tensor_ensemble(cfg, params, R)
    fresh = evaluate_sem(dataclasses.replace(cfg, precision='fp32'), params,
                         R)
    rel = slater.drift_tolerance(cfg.precision)[0]
    ok = torch.ones(R.shape[0], dtype=torch.bool)
    exact = {}
    ld64 = torch.zeros(R.shape[0], dtype=torch.float64)
    sign64 = torch.ones(R.shape[0], dtype=torch.float64)
    for f, blk in zip(('minv_up', 'minv_dn'), _slater_blocks(cfg, Cw)):
        D = blk[..., 0]
        exact[f] = torch.linalg.inv(D.double()).cpu()
        s, ld = torch.linalg.slogdet(D.double())
        ld64 += ld.cpu()
        sign64 *= s.cpu()
        m32 = getattr(fresh, f)
        held = slater.refine_inverse(D, _to_compute(_to_storage(m32, cfg),
                                                    cfg))
        ok &= _rel(m32, exact[f]) <= FP32_SCOPE
        ok &= _rel(held, exact[f]) <= rel / 10
    return ok, exact, ld64, sign64


def _precision_run(torch, dev, cfg, params, method, precision, gen,
                   walkers):
    """``PRECISION_SWEEPS`` sweeps of ``method`` at ``precision`` from the
    generator's cold start (or ``walkers``).  Returns the propagator, the
    end state and a record: the per-sweep host-clock median, one profiled
    sweep's device busy time and launches, the per-sweep energy means, the
    kernels' launch counts, and the walkers ``_storage_resolved`` at every
    storage boundary of their path (checked between the timed sweeps)
    with the fp64 state at the end."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.driver import Population, make_propagator
    prop = make_propagator(method, dataclasses.replace(
        cfg, precision=precision), tau=0.3)
    pop = Population()
    st = prop.init(params, gen, WALKERS, walkers)
    scope = _storage_resolved(torch, prop.cfg, params, st.ens.r)[0]
    counters = _counters()
    for c in counters.values():
        c.reset()
    walls, means = [], []
    busy = issued = None
    for k in range(PRECISION_SWEEPS):
        torch.cuda.synchronize()
        if k == 3:                   # one sweep under the profiler
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                st, out = prop.propagate(params, st, gen, pop)
                torch.cuda.synchronize()
            tr = Trace(prof)
            busy, issued = tr.busy, tr.issued
        else:
            t0 = time.perf_counter()
            st, out = prop.propagate(params, st, gen, pop)
            torch.cuda.synchronize()
            if k:                    # sweep 0 builds and tunes
                walls.append((time.perf_counter() - t0) * 1e3)
        means.append(float(out[0]))
        launches = {n: c.n for n, c in counters.items()}
        ok, exact, ld64, sign64 = _storage_resolved(torch, prop.cfg, params,
                                                    st.ens.r)
        scope &= ok
        for n, c in counters.items():    # the check launches no sweep
            c.n = launches[n]
    return prop, st, dict(wall=statistics.median(walls), busy=busy,
                          issued=issued, means=means, launches=launches,
                          scope=scope, exact=exact, ld64=ld64, sign64=sign64)


def _precision_check(torch, label, prop, st, rec, precision, held: bool):
    """Stored dtypes and bytes, energies, and the drift of the stored
    inverses against a fresh fp64 recompute on the walkers in scope (the
    policy resolves them at every storage boundary of their path,
    ``_storage_resolved``), asserted where ``held`` under
    ``slater.drift_tolerance`` in the reference's metric (relative to the
    block's largest entry over those walkers), with at least one walker in
    scope.  The running logdet against
    fp64 is printed, not asserted: the policy does not bound it (one badly
    conditioned move on a walker's path leaves the storage roundoff times
    its condition in the running sum, which the corrector never refines;
    ``tests/test_torch_precision.py``).  Energies must be finite on every
    walker, except at fp16 on walkers out of scope (an entry past fp16's
    range stores inf, as the reference's policy does)."""
    from repro_torch.core import slater
    from repro_torch.core.sem import _to_compute
    cfg, ens = prop.cfg, st.ens
    want = slater.storage_dtype(precision)
    dtypes = {f: str(getattr(ens, f).dtype).split('.')[-1]
              for f in ('minv_up', 'minv_dn', 'p_up', 'p_dn')}
    if any(getattr(ens, f).dtype != want for f in dtypes):
        _fail(f'[precision] {label}: stored dtypes {dtypes}, want {want}')
    inv_bytes = ens.minv_up.nbytes + ens.minv_dn.nbytes
    p_bytes = ens.p_up.nbytes + ens.p_dn.nbytes
    policy = slater.state_bytes(cfg.n_up, cfg.n_dn, WALKERS,
                                slater.precision_bytes(precision))
    scope = rec['scope']
    n_in = int(scope.sum())
    rel, abs_ld = slater.drift_tolerance(precision)
    worst = 0.0
    for f, b in rec['exact'].items():
        a = _to_compute(getattr(ens, f), cfg).double().cpu()[scope]
        b = b[scope]
        if b.numel():
            worst = max(worst, float((a - b).abs().max()
                                     / b.abs().max().clamp(min=1.0)))
    dl = (ens.logdet.double().cpu() - rec['ld64']).abs()
    sign_ok = bool((ens.sign.double().cpu() == rec['sign64'])[scope].all())
    finite = torch.isfinite(ens.e_loc).cpu()
    print(f'[precision] {label}: stored {dtypes}; inverses {inv_bytes} B '
          f'({inv_bytes / 1e6:.2f} MB; slater.state_bytes {policy} B), '
          f'P-tables {p_bytes} B ({p_bytes / 1e6:.2f} MB); E_L finite on '
          f'{int(finite.sum())} of {WALKERS} walkers, per-sweep means '
          f'{", ".join(f"{x:.2f}" for x in rec["means"])}; {n_in} walkers '
          f'in scope (resolved at every storage boundary): stored inverses '
          f'vs fp64 {worst:.3e} (bound {rel:g}'
          + ('' if held else ', printed only') +
          f'), signs equal {sign_ok}, running logdet vs fp64 median/max '
          + (_q(dl[scope]) if n_in else '-') +
          f' ({int((dl[scope] > abs_ld).sum())} over {abs_ld:g}, not '
          f'asserted)')
    if held and n_in == 0:
        _fail(f'[precision] {label}: no walker in scope')
    if held and not (worst <= rel and sign_ok):
        _fail(f'[precision] {label}: stored inverses drifted past '
              f'{rel:g} on walkers in scope ({worst:.3e})')
    ok = finite | ~scope if precision == 'fp16' else finite
    if not bool(ok.all()):
        _fail(f'[precision] {label}: {int((~ok).sum())} walkers with '
              f'no finite local energy')
    return inv_bytes + p_bytes


def phase_precision(torch, dev, seed: int, pool, R_eq, runs: dict):
    """Mixed-precision storage on the card: ``smallest`` at W = 256 from
    the run's cold start (worker 0 of ``seed``) and from the equilibrated
    walkers ``R_eq``, sem-vmc and fused-vmc at fp32, bf16 and fp16;
    fused-vmc --n-det 100 at fp32 and bf16; the screened b-strand
    fused-vmc at fp32 and bf16 from the finite walkers ``pool``; each
    ``PRECISION_SWEEPS`` sweeps under the same draws (one generator state
    per cell; 4, cut from 7 for the script's time limit).
    Prints stored dtypes and bytes, the drift
    of the stored inverses against fp64 on the walkers fp32 resolves, the
    sweep's host-clock median and one profiled sweep's device busy time
    and launches beside fp32's, and each run's kernel launches (added to
    ``runs``).  At fp16 a walker whose inverse leaves fp16's range (x 16)
    stores inf, as the reference's policy does: its energies are counted,
    not asserted.  The drift is asserted on the single-determinant bf16
    and fp16 cells from the equilibrated walkers.  From a cold start, and
    with the CI expansion, it is printed only: there the policy loses the
    inverse on some walkers in the middle of a sweep while every sweep end
    looks resolved (an update by a small ratio amplifies the storage
    roundoff, and one refinement of the result does not converge; with CI
    the quantized P-tables also let the CI sum accept moves whose
    reference-determinant ratio is near zero).  The peptide's cold-start
    blocks are ill-conditioned (largest |Minv| up to 1e11 on
    ``smallest``).  The reference's policy does the same on the CPU
    (ROADMAP Queue C)."""
    import dataclasses
    from repro_torch.runtime.samplers import worker_seed
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    cfg_ci, params_ci = build_system(SYSTEM, n_det=100, device=dev)
    cfg_b, params_b = build_system(BSTRAND, screen_eps=SCREEN_EPS,
                                   device=dev)
    walkers_b = pool.cpu().numpy()
    all3 = ('fp32', 'bf16', 'fp16')
    walkers_eq = R_eq.cpu().numpy()
    two = ('fp32', 'bf16')
    cells = [(m, cfg, params, m, all3, None, False)
             for m in ('sem-vmc', 'fused-vmc')]
    cells += [('fused-vmc --n-det 100', cfg_ci, params_ci, 'fused-vmc', two,
               None, False),
              (f'{BSTRAND} eps={SCREEN_EPS:g} fused-vmc', cfg_b, params_b,
               'fused-vmc', two, walkers_b, False)]
    cells += [(f'equilibrated {m}', cfg, params, m, all3, walkers_eq, True)
              for m in ('sem-vmc', 'fused-vmc')]
    cells += [('equilibrated fused-vmc --n-det 100', cfg_ci, params_ci,
               'fused-vmc', two, walkers_eq, False)]
    for name, c, p, method, precisions, walkers, held in cells:
        base = None
        for precision in precisions:
            gen = torch.Generator(device=dev)
            gen.manual_seed(worker_seed(seed, 0))      # the same draws
            label = f'{name} --precision {precision}'
            prop, st, rec = _precision_run(torch, dev, c, p, method,
                                           precision, gen, walkers)
            if precision == 'fp32':
                base = rec
            nbytes = _precision_check(torch, label, prop, st, rec,
                                      precision,
                                      held and precision != 'fp32')
            launches = rec['launches']
            kernel = 'fused_sweep' if method == 'fused-vmc' else 'sem_move'
            print(f'[precision] {label}: sweep wall median {rec["wall"]:.2f} '
                  f'ms (fp32 {base["wall"]:.2f}), device busy '
                  f'{rec["busy"]:.2f} ms (fp32 {base["busy"]:.2f}), '
                  f'{rec["issued"]} launches and copies a sweep (fp32 '
                  f'{base["issued"]}); state {nbytes / 1e6:.2f} MB; '
                  f'launches {launches}')
            if launches[kernel] <= 0:
                _fail(f'[precision] {label}: {kernel} never launched')
            runs[f'precision {label}'] = launches


def _serve_spec(**kw):
    from repro_torch.launch.spec import RunSpec
    kw.setdefault('n_workers', 1)
    kw.setdefault('poll_interval', 0.05)
    kw.setdefault('wall_clock_limit', 120.0)
    return RunSpec(**kw)


def phase_serve(torch, seed: int, runs: dict):
    """The run service on the card.  In process: a ``QMCService`` with the
    real builder and a pool of 2 runs ``smallest`` fused-vmc --precision
    bf16 (seed ``seed``: a cold start with no dead walker) and h2 vmc,
    ``SERVE_BLOCKS`` blocks each (4, cut from 20 for the script's time
    limit), at once and one after the other, in the order
    at once, after, after, at once (total blocks/s of each schedule, two
    ratios);
    the first service also makes one ``extend``, one ``fork`` that changes
    tau, and one ``cancel`` of a queued run.  Over the wire: a
    ``qmc_serve`` process on 127.0.0.1:0 takes one h2 run from
    ``qmc_client`` and is stopped."""
    from repro_torch.serve import QMCService
    out_dir = ROOT / 'build' / 'chip_smoke'
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = {
        f'{SYSTEM} fused-vmc --precision bf16': _serve_spec(
            system=SYSTEM, method='fused-vmc', precision='bf16', seed=seed,
            n_walkers=WALKERS, steps=5, max_blocks=SERVE_BLOCKS),
        'h2 vmc': _serve_spec(system='h2', method='vmc', seed=seed,
                              n_walkers=WALKERS, steps=10,
                              max_blocks=SERVE_BLOCKS)}
    counters = _counters()

    def _report(svc, rid, label, t0):
        s = svc.wait(rid, 300)
        secs = time.perf_counter() - t0
        print(f'[serve] {label}: {s["state"]}, {s["n_blocks"]} blocks, E = '
              f'{s["energy"]} +/- {s["error_bar"]} in {secs:.1f} s '
              f'(key {s["run_key"]})')
        if s['state'] != 'done' or s['energy'] is None or not math.isfinite(
                s['energy']):
            _fail(f'[serve] {label}: {s["state"]} without a finite energy: '
                  f'{s["detail"][-2000:]}')
        return s

    rates = {'concurrent': [], 'one after the other': []}
    order = ('concurrent', 'one after the other', 'one after the other',
             'concurrent')
    for rep, schedule in enumerate(order):
        label = f'{schedule} ({rep + 1} of {len(order)})'
        db = out_dir / f'serve_{rep}.sqlite'
        for p in out_dir.glob(db.name + '*'):
            p.unlink()
        for c in counters.values():
            c.reset()
        svc = QMCService(db=str(db), total_workers=2, poll_interval=0.05)
        try:
            t0 = time.perf_counter()
            done = {}
            if schedule == 'concurrent':
                ids = {k: svc.submit(s) for k, s in specs.items()}
                if rep == 0:
                    # a third run queued behind the two, cancelled before
                    # it starts
                    queued = svc.submit(_serve_spec(
                        system='h2', method='vmc', n_walkers=64,
                        max_blocks=1000))
                    c = svc.cancel(queued)
                    if c['state'] != 'cancelled' or c['n_blocks']:
                        _fail(f'[serve] cancel of a queued run: {c}')
                    print(f'[serve] queued run {queued} cancelled before it '
                          f'ran')
                for k, rid in ids.items():
                    done[k] = _report(svc, rid, f'{label}: {k}', t0)
            else:
                for k, s in specs.items():
                    done[k] = _report(svc, svc.submit(s), f'{label}: {k}',
                                      t0)
            secs = time.perf_counter() - t0
            n = sum(s['n_blocks'] for s in done.values())
            rates[schedule].append(n / secs)
            launches = {k: c.n for k, c in counters.items()}
            print(f'[serve] {label}: {n} blocks in {secs:.1f} s, '
                  f'{n / secs:.4f} blocks/s; launches {launches}')
            for k in ('sparse_mo', 'fused_sweep'):
                if launches[k] <= 0:
                    _fail(f'[serve] {label}: {k} never launched')
            runs[f'serve {label}'] = launches
            if rep == 0:
                key = done[f'{SYSTEM} fused-vmc --precision bf16']['run_key']
                for c in counters.values():
                    c.reset()
                t1 = time.perf_counter()
                ext = _report(svc, svc.extend(key, 1), 'extend by 1 block',
                              t1)
                if ext['run_key'] != key or \
                        ext['n_blocks'] <= done[f'{SYSTEM} fused-vmc '
                                                f'--precision bf16'][
                                                    'n_blocks']:
                    _fail(f'[serve] extend: {ext}')
                h2_key = done['h2 vmc']['run_key']
                fk = _report(svc, svc.fork(h2_key, tau=0.5, max_blocks=3),
                             'fork h2 vmc at tau 0.5', time.perf_counter())
                if fk['run_key'] in (h2_key, '') or fk['parent_key'] != h2_key:
                    _fail(f'[serve] fork: {fk}')
                launches = {k: c.n for k, c in counters.items()}
                print(f'[serve] extend and fork: launches {launches}')
                runs['serve extend, fork'] = launches
        finally:
            svc.close()
    conc, seq = rates['concurrent'], rates['one after the other']
    # pairs in time order: (1st at once, 2nd after), (4th at once, 3rd after)
    pairs = [conc[0] / seq[0], conc[1] / seq[1]]
    print(f'[serve] total blocks/s, concurrent against one after the other: '
          f'{sum(conc) / 2:.4f} ({conc[0]:.4f}, {conc[1]:.4f}) against '
          f'{sum(seq) / 2:.4f} ({seq[0]:.4f}, {seq[1]:.4f}): '
          f'{sum(conc) / sum(seq):.3f}x, pairs {pairs[0]:.3f}x and '
          f'{pairs[1]:.3f}x')
    _serve_over_the_wire(out_dir)


def _serve_over_the_wire(out_dir):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    db = out_dir / 'serve_wire.sqlite'
    for p in out_dir.glob(db.name + '*'):
        p.unlink()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, '-m', 'repro_torch.launch.qmc_serve', '--db',
         str(db), '--listen', '127.0.0.1:0', '--pool', '1'],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        port = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            print(f'[serve wire] qmc_serve: {line.strip()}')
            if 'listening on' in line:
                port = int(line.rsplit(':', 1)[1].split()[0])
                break
        if port is None:
            _fail('[serve wire] qmc_serve never reported its port')

        def _client(*args):
            r = subprocess.run(
                [sys.executable, '-m', 'repro_torch.launch.qmc_client',
                 '--port', str(port), *args], capture_output=True,
                text=True, timeout=300, env=env)
            for ln in r.stdout.strip().splitlines():
                print(f'[serve wire] qmc_client {args[0]}: {ln}')
            return r
        r = _client('submit', '--system', 'h2', '--walkers', '64',
                    '--steps', '10', '--blocks', '3', '--workers', '1',
                    '--seed', '3', '--wait')
        if r.returncode != 0 or 'done' not in r.stdout \
                or 'E = -' not in r.stdout:
            _fail(f'[serve wire] submit: rc {r.returncode}, '
                  f'{r.stdout[-1000:]} {r.stderr[-2000:]}')
        _client('shutdown')
        proc.wait(60)
        print(f'[serve wire] qmc_serve exited {proc.returncode} after '
              f'{time.perf_counter() - t0:.1f} s')
        if proc.returncode != 0:
            _fail(f'[serve wire] qmc_serve exited {proc.returncode}')
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


SHARD_TIE = 1e-5     # |margin| within which a flipped decision is a tie


def _shard_rows(draws, k: int, m: int):
    """Shard k's rows of whole-population draws (0-d draws: every
    shard's)."""
    return tuple(d if d.ndim == 0 else d[k * m:(k + 1) * m] for d in draws)


def _decisions(torch, prop, params, st, draws):
    """One generation's accept decisions and margins from ``st`` under
    ``draws``, without advancing: (W, n_e) for the sweeps (each electron's
    move, from ``prop.sweep``), (W,) for the all-electron methods (log
    ratio - log u, crossings rejected in DMC)."""
    from repro_torch.core.driver import Population
    from repro_torch.core.sem import SEMVMCPropagator
    from repro_torch.core.vmc import propose_diffusion
    if isinstance(prop, SEMVMCPropagator):
        *_, acc, mar = prop.sweep(params, st, None, draws)
        return acc.T, mar.T
    ens = st.ens if hasattr(st, 'ens') else st
    new, lr, u = propose_diffusion(prop.cfg, params, ens, None, Population(),
                                   prop.tau, draws[:2])
    mar = lr - torch.log(u)
    acc = mar > 0
    if hasattr(st, 'ens'):
        acc &= ~(new.sign * ens.sign < 0)
    return acc, mar


def _fp32_scope(torch, cfg, params, R):
    """FP32_SCOPE at walker positions R: both spin blocks' fresh fp32
    inverses within FP32_SCOPE of the fp64 inverse of the same fp32
    matrix and, with a CI expansion, the fresh fp32 CI sum S within
    FP32_SCOPE (relative) of S from those fp64 inverses (near a node of
    the CI sum log|S| loses digits, ROADMAP "fp32 limits").  -> (W,) bool
    on the CPU."""
    from repro_torch.core import multidet
    from repro_torch.core.sem import evaluate_sem
    from repro_torch.core.wavefunction import (_ci_blocks,
                                               _mo_tensor_ensemble,
                                               _slater_blocks)
    Cw, _ = _mo_tensor_ensemble(cfg, params, R)
    fresh = evaluate_sem(cfg, params, R)
    ok = torch.ones(R.shape[0], dtype=torch.bool)
    exact = {}
    for f, blk in zip(('minv_up', 'minv_dn'), _slater_blocks(cfg, Cw)):
        exact[f] = torch.linalg.inv(blk[..., 0].double())
        ok &= _rel(getattr(fresh, f), exact[f]) <= FP32_SCOPE
    if cfg.ci is not None:
        ci = cfg.ci_t
        rdet = [multidet.det_ratios(
            multidet.reference_table(blk[..., 0].double(), exact[f]),
            holes, parts)
            for f, blk, holes, parts in zip(
                ('minv_up', 'minv_dn'), _ci_blocks(cfg, Cw),
                (ci.holes_up, ci.holes_dn), (ci.parts_up, ci.parts_dn))]
        s64 = multidet.ci_sum(ci.coeffs.double(), *rdet)
        s32 = multidet.ci_sum(ci.coeffs, fresh.rdet_up, fresh.rdet_dn)
        ok &= ((s32.double() - s64).abs() / s64.abs()).cpu() <= FP32_SCOPE
    return ok


def _stats_gap(s1, s2, moments: bool):
    """BlockStats entries of two blocks that differ beyond rel 1e-5
    (opt-vmc's moments: 1e-4 of the moment's largest entry)."""
    import numpy as np
    bad = [f for f in ('weight', 'e_mean', 'e2_mean')
           if not math.isclose(getattr(s1, f), getattr(s2, f),
                               rel_tol=1e-5, abs_tol=1e-6)]
    for k, v in s1.aux.items():
        tol = 1e-4 if moments and k.startswith('opt_') else 1e-5
        v, w = np.asarray(v, np.float64), np.asarray(s2.aux[k], np.float64)
        err = float(np.max(np.abs(w - v))) / max(float(np.max(np.abs(v))),
                                                 1e-6)
        if not err <= tol:
            bad.append(f'{k} ({err:.3g})')
    return bad


def _shard_case(torch, dev, label, cfg, params, method, steps, seed, *,
                tau=0.0, walkers=None, needs=(), evaluation='sparse_mo',
                moments=False):
    """One [shards] cell: ``method`` on one shard and on two shards of
    ``dev``, from the same start and generator seed.

    (1) One block each through ``EnsembleDriver.run_block``, after a
    warm-up block (the fused sweep's tuner measures its W/2 miss there):
    launches of every kernel in ``needs`` under shards, ``evaluation``'s
    at twice the single shard's count, the wall time of each block.
    (2) The same ``steps`` generations again through
    ``EnsembleDriver.step`` under the block's draws: each generation's
    decisions taken from the single-shard state at W and from each
    shard's state at W/2 must be identical, except ties within SHARD_TIE
    of the threshold on either side (counted); each walker's E_L after
    each generation within rel 1e-4 (the parity tolerance; beyond 1e-5
    printed).  A walker with a flipped decision, or an E_L beyond rel 1e-5
    outside FP32_SCOPE, is dropped from the later comparisons; a flip
    beyond the tie margin or an E_L beyond 1e-4 fails the phase unless
    the walker is outside FP32_SCOPE there (counted and printed: near a
    node of a determinant or of the CI sum the fp32 result depends on the
    batch's arithmetic: cuBLAS takes other kernels at W/2).  (3) The two
    blocks' BlockStats within rel 1e-5 (opt-vmc's moments 1e-4), unless a
    walker left the comparison outside FP32_SCOPE.
    Returns the launches of the 2-shard block."""
    from repro_torch.core.driver import EnsembleDriver, make_propagator
    from repro_torch.runtime.samplers import worker_seed
    prop = make_propagator(method, cfg, tau=tau, equil_steps=0)
    scope_cfg = prop.cfg
    counters = _counters()

    def _gen():
        g = torch.Generator(device=dev)
        g.manual_seed(worker_seed(seed, 0))
        return g

    drivers = {1: EnsembleDriver(prop, steps),
               2: EnsembleDriver(prop, steps, devices=[dev, dev])}
    stats, secs, launches = {}, {}, {}
    for n, drv in drivers.items():
        g = _gen()
        drv.run_block(params, drv.init(params, g, WALKERS, walkers), g)
        g = _gen()
        st = drv.init(params, g, WALKERS, walkers)
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        _, stats[n] = drv.run_block(params, st, g)
        torch.cuda.synchronize()
        secs[n] = time.perf_counter() - t0
        launches[n] = {k: c.n for k, c in counters.items()}
    missing = [k for k in needs if launches[2][k] <= 0]
    if missing:
        _fail(f'[shards] {label}: {missing} never launched under shards')
    if launches[2][evaluation] != 2 * launches[1][evaluation]:
        _fail(f'[shards] {label}: {evaluation} launched '
              f'{launches[2][evaluation]} times under 2 shards, '
              f'{launches[1][evaluation]} under 1')

    # the block's generations again, one by one, under its draws
    d1, d2 = drivers[1], drivers[2]
    g = _gen()
    st1 = d1.init(params, g, WALKERS, walkers)
    st2 = d2.init(params, _gen(), WALKERS, walkers)
    m = WALKERS // 2
    live = torch.ones(WALKERS, dtype=torch.bool)
    n_dec = n_tie = 0
    dropped = []                      # (generation, walker)
    errors = []
    for gi in range(steps):
        draws = prop.draw(g, st1)
        acc1, mar1 = _decisions(torch, prop, params, st1, draws)
        dec2 = [_decisions(torch, d2.propagators()[k], params, s,
                           _shard_rows(draws, k, m))
                for k, s in enumerate(st2)]
        acc2 = torch.cat([a for a, _ in dec2])
        mar2 = torch.cat([b for _, b in dec2])
        per = acc1.numel() // WALKERS
        flip = ((acc1 != acc2).reshape(WALKERS, per).cpu()
                & live[:, None])
        # a tie: the decision is within SHARD_TIE of its threshold on
        # either side (the two batch sizes round differently)
        near = torch.minimum(mar1.abs(), mar2.abs()).reshape(WALKERS, per)
        tie = flip & (near.cpu() <= SHARD_TIE)
        n_dec += int(live.sum()) * per
        n_tie += int(tie.sum())
        off = flip.any(dim=1) & ~tie.any(dim=1)
        if bool(off.any()):
            e1, e2 = d1.merge(st1), d2.merge(st2)
            scope = _fp32_scope(torch, scope_cfg, params, e1.r)
            for w in off.nonzero().flatten().tolist():
                j = int(flip[w].nonzero()[0])
                gap = max(float(_rel(a[w:w + 1], b[w:w + 1]).max())
                          for a, b in zip(e1, e2)
                          if a.is_floating_point() and a.numel()
                          and a.dim() > 1 and bool(b[w].abs().max() > 0))
                print(f'[shards] {label}: generation {gi} walker {w}: '
                      f'move {j} margin {float(mar1.reshape(WALKERS, per)[w, j]):.4g}'
                      f' at W, {float(mar2.reshape(WALKERS, per)[w, j]):.4g} at '
                      f'W/2; in FP32_SCOPE {bool(scope[w])}; largest '
                      f'relative state difference before it {gap:.3g}')
            if bool((off & scope).any()):
                errors.append(f'generation {gi}: decisions of walkers '
                              f'{(off & scope).nonzero().flatten().tolist()}'
                              f' in FP32_SCOPE differ outside the '
                              f'{SHARD_TIE:g} margin')
            dropped += [(gi, int(w)) for w in (off & ~scope).nonzero()]
        hit = flip.any(dim=1)
        if method == 'dmc' and bool(hit.any()):
            live[:] = False    # the comb passes a flip on to other walkers
        else:
            live &= ~hit
        st1, _ = d1.step(params, st1, draws)
        st2, _ = d2.step(params, st2, draws)
        e1, e2 = d1.merge(st1), d2.merge(st2)
        de = ((e1.e_loc - e2.e_loc).abs()
              / e1.e_loc.abs().clamp(min=1.0)).cpu()
        if bool(((de > 1e-5) & live).any()):
            scope = _fp32_scope(torch, scope_cfg, params, e1.r)
            bad = (de > 1e-4) & live & scope
            if bool(bad.any()):
                errors.append(f'generation {gi}: E_L of walkers '
                              f'{bad.nonzero().flatten().tolist()} in '
                              f'FP32_SCOPE differ by up to '
                              f'{float(de[bad].max()):.3g} (rel)')
            out = (de > 1e-5) & live & ~scope
            print(f'[shards] {label}: generation {gi}: E_L beyond rel 1e-5 '
                  f'on {int(((de > 1e-5) & live & scope).sum())} compared '
                  f'walkers in FP32_SCOPE (largest '
                  f'{float((de * (live & scope)).max()):.3g}) and '
                  f'{int(out.sum())} outside (largest '
                  f'{float((de * out).max()):.3g})')
            dropped += [(gi, int(w)) for w in out.nonzero()]
            live &= ~out
    r1, r2 = d1.merge(st1).r.cpu(), d2.merge(st2).r.cpu()
    dr = (float((r1 - r2)[live].abs().max()) if bool(live.any())
          else float('nan'))
    if errors:
        _fail(f'[shards] {label}: ' + '; '.join(errors))
    gap = _stats_gap(stats[1], stats[2], moments)
    if gap and not dropped:
        _fail(f'[shards] {label}: BlockStats of 1 and 2 shards differ: {gap}')
    s1, s2 = stats[1], stats[2]
    print(f'[shards] {label}: BlockStats E {s1.e_mean:.6f} / {s2.e_mean:.6f}'
          f', accept {s1.aux["accept"]:.6f} / {s2.aux["accept"]:.6f} at 1 / '
          f'2 shards' + (f' (beyond rel 1e-5: {gap})' if gap else
                         ' (within rel 1e-5)')
          + f'; decisions over {steps} generations: {n_dec} compared, '
          f'identical but {n_tie} ties within {SHARD_TIE:g}; walkers '
          f'dropped outside FP32_SCOPE (generation, walker): '
          f'{dropped or "none"}; largest position difference {dr:.3g} over '
          f'{int(live.sum())} walkers; launches 1 shard {launches[1]}, 2 '
          f'shards {launches[2]}; block wall {secs[1] * 1e3:.1f} ms at 1 '
          f'shard, {secs[2] * 1e3:.1f} ms at 2 on one card ({steps} '
          f'generations; not a scaling number: two shards on one card '
          f'measure the threads and collectives)')
    return launches[2]


def phase_shards(torch, dev, seed: int, runs: dict, R_eq, bstrand):
    """[shards]: walker-axis sharding on the card, one shard against two
    shards of ``cuda:0`` (``_shard_case``) on ``smallest`` at W = 256 from
    the seed's cold start: fused-vmc (also --n-det 100), sem-vmc (2
    sweeps; --n-det 100 one), dmc; opt-vmc P = 3 from the equilibrated
    walkers; the screened b-strand fused-vmc from its finite walkers.
    Then ``qmc_run --shards 2`` on a one-card machine must raise the
    reference's "only 1 local devices" error, and a ``QMCManager`` on the
    thread backend over a sampler on [cuda:0, cuda:0] must deliver
    blocks.  Adds the 2-shard blocks' launches to ``runs``."""
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    cfg_ci, params_ci = build_system(SYSTEM, n_det=100, ci_seed=seed,
                                     device=dev)
    cfg_b, params_b, pool = bstrand
    t0 = time.perf_counter()
    cases = (
        ('fused-vmc', cfg, params, 'fused-vmc', 2, {},
         ('sparse_mo', 'fused_sweep')),
        ('fused-vmc --n-det 100', cfg_ci, params_ci, 'fused-vmc', 2, {},
         ('sparse_mo', 'fused_sweep')),
        ('sem-vmc', cfg, params, 'sem-vmc', 2, {}, ('sparse_mo', 'sem_move')),
        ('sem-vmc --n-det 100', cfg_ci, params_ci, 'sem-vmc', 1, {},
         ('sparse_mo', 'sem_move')),
        ('dmc', cfg, params, 'dmc', 3, {}, ('sparse_mo',)),
        ('opt-vmc P=3', cfg, params, 'opt-vmc', 2,
         dict(tau=0.01, walkers=R_eq, moments=True), ('sparse_mo',)),
        (f'{BSTRAND} fused-vmc eps={SCREEN_EPS:g}', cfg_b, params_b,
         'fused-vmc', 2, dict(walkers=pool, evaluation='screened_mo'),
         ('screened_mo', 'fused_sweep')),
    )
    for label, c, p, method, steps, kw, needs in cases:
        runs[f'[shards] {label}'] = _shard_case(
            torch, dev, label, c, p, method, steps, seed, needs=needs, **kw)

    from repro_torch.launch import qmc_run
    if torch.cuda.device_count() == 1:
        try:
            qmc_run.main(_cli_args('dmc', 2, 1, seed, SYSTEM,
                                   ('--shards', '2')))
        except ValueError as exc:
            if 'only 1 local devices' not in str(exc):
                _fail(f'[shards] qmc_run --shards 2: {exc}')
            print(f'[shards] qmc_run --shards 2 on one card raises: {exc}')
        else:
            _fail('[shards] qmc_run --shards 2 ran on a one-card machine')
    else:
        print(f'[shards] {torch.cuda.device_count()} cards: the one-card '
              f'refusal of qmc_run --shards 2 is not checked')

    from repro_torch.core.driver import make_propagator
    from repro_torch.runtime import (QMCManager, ResultDatabase, RunControl,
                                     make_backend)
    from repro_torch.runtime.samplers import BlockSampler
    sampler = BlockSampler(make_propagator('fused-vmc', cfg), params,
                           n_walkers=WALKERS, steps=2, devices=[dev, dev])
    mgr = QMCManager(sampler, 'shards-thread',
                     RunControl(max_blocks=2, subblocks_per_block=2,
                                wall_clock_limit=120),
                     db=ResultDatabase(':memory:'), seed=seed,
                     backend=make_backend('thread', 1))
    counters = _counters()
    for c in counters.values():
        c.reset()
    t1 = time.perf_counter()
    avg = mgr.run()
    secs = time.perf_counter() - t1
    errors = mgr.worker_errors()
    launches = {k: c.n for k, c in counters.items()}
    print(f'[shards] QMCManager, thread backend, sampler on [{dev}, {dev}]: '
          f'{avg} in {secs:.1f} s; launches {launches}')
    if errors or avg.n_blocks < 2 or not math.isfinite(avg.energy):
        _fail(f'[shards] the sharded sampler delivered {avg.n_blocks} '
              f'blocks; errors {errors}')
    runs['[shards] QMCManager thread'] = launches
    print(f'[shards] phase {time.perf_counter() - t0:.1f} s')


def phase_spline(torch, dev, R):
    """[spline]: the paper's Table III on the card.  Tabulate the
    ``smallest`` MOs on the reference's (48, 48, 48) grid (bytes: n_orb x
    48^3 x 4), time ``interp_mo_block`` against the direct path (the AO
    rows and the ``sparse_mo`` kernel, ``wavefunction._mo_tensor``) on the
    same electrons, one configuration (158 e-) and W = 256 (40 448 e-),
    with CUDA events; hold the card's interpolation against the CPU's
    within 1e-5 of each component's largest entry."""
    from repro_torch.core import spline
    from repro_torch.core.wavefunction import _mo_tensor
    from repro_torch.systems import build_system
    cfg, params = build_system(SYSTEM, device=dev)
    shape = (48, 48, 48)
    t0 = time.perf_counter()
    grid = spline.build_mo_grid(cfg.basis_t, params.coords, params.mo, shape,
                                chunk=4096)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_orb = params.mo.shape[0]
    if grid.memory_bytes != n_orb * math.prod(shape) * 4:
        _fail(f'[spline] grid holds {grid.memory_bytes} bytes')
    print(f'[spline] {SYSTEM} MO grid {shape}: {n_orb} orbitals, '
          f'{grid.memory_bytes} B ({grid.memory_bytes / 2 ** 20:.2f} MiB; '
          f'the MO coefficients {params.mo.numel() * 4} B), built in '
          f'{build_s:.2f} s')
    grid_cpu = spline.MOGrid(*[t.cpu() for t in grid])
    for label, pts in (('one configuration', R[0]),
                       (f'W = {R.shape[0]}', R.reshape(-1, 3))):
        pts = pts.contiguous()
        c_int = spline.interp_mo_block(grid, pts)
        c_dir, _ = _mo_tensor(cfg, params, pts)
        c_cpu = spline.interp_mo_block(grid_cpu, pts.cpu())
        ref = c_cpu.numpy()
        err = max(float(abs(c_int.cpu().numpy()[..., i] - ref[..., i]).max()
                        / abs(ref[..., i]).max()) for i in range(5))
        if not err <= 1e-5:
            _fail(f'[spline] {label}: card vs CPU interpolation {err:.3g}')
        vs_dir = float((c_int[..., 0] - c_dir[..., 0]).abs().max()
                       / c_dir[..., 0].abs().max())
        t_int = _time_ms(lambda: spline.interp_mo_block(grid, pts))
        t_dir = _time_ms(lambda: _mo_tensor(cfg, params, pts))
        print(f'[spline] {label} ({pts.shape[0]} e-): interp_mo_block '
              f'{t_int[0]:.4f} ms device ({t_int[1]:.4f} ms host), direct '
              f'(AO rows + sparse_mo) {t_dir[0]:.4f} ms device '
              f'({t_dir[1]:.4f} ms host), ratio {t_int[0] / t_dir[0]:.3f}; '
              f'card vs CPU interpolation {err:.3g} of the largest entry; '
              f'interpolated values vs direct {vs_dir:.3g} of the largest')


# ---------------------------------------------------------------------------
# [ci rank]: CI excitations of any rank in the per-move kernels
# ---------------------------------------------------------------------------
# ranks past the registers' 8, up to 39 = n_orb - n on smallest's widths
CI_RANKS = (9, 16, 39)
# the three sides a sweep check compares: kernel, plain, plain in fp64
SIDES = ((True, None), (False, None), (False, 'float64'))


def _rank_k_up(n: int, n_orb: int, k: int, seed: int, n_exc: int = 40):
    """The expansion of ``tests/test_torch_cuda_kernels.py::_rank_k_case``:
    ``n_exc`` distinct excitations of 1..k electrons of the up block, the
    first of exactly k (so the lists are padded to rank k), coefficients 1
    and +-0.2."""
    import numpy as np
    from repro_torch.core.multidet import from_excitations
    rng = np.random.default_rng(seed)
    exc, seen = [], set()
    while len(exc) < n_exc:
        deg = int(rng.integers(1, k + 1))
        h = sorted(rng.choice(n, deg, replace=False).tolist())
        p = sorted((n + rng.choice(n_orb - n, deg, replace=False)).tolist())
        if repr((h, p)) not in seen:
            seen.add(repr((h, p)))
            exc.append(((h, p), ([], [])))
    exc[0] = ((list(range(k)), list(range(n, n + k))), ([], []))
    coeffs = np.concatenate([[1.0], 0.2 * rng.choice([-1.0, 1.0], n_exc)])
    return from_excitations(coeffs, exc, n, n, n_orb)


def _unequal_ci(n_up: int, n_dn: int, n_orb: int, k: int, seed: int):
    """An expansion over n_up > n_dn electrons with one k-fold excitation
    of the up block (k > n_dn) and four singles and doubles of the down
    block: ``from_excitations`` pads both blocks' lists to rank k, so the
    down block's lists carry k slots for its n_dn electrons (the
    sentinels fill the rest)."""
    import numpy as np
    from repro_torch.core.multidet import from_excitations
    rng = np.random.default_rng(seed)
    exc, seen = [((list(range(k)), list(range(n_up, n_up + k))),
                  ([], []))], set()
    while len(exc) < 5:
        d = 1 + len(exc) % 2
        e = (([], []), (sorted(rng.choice(n_dn, d, replace=False).tolist()),
                        sorted((n_dn + rng.choice(n_orb - n_dn, d,
                                                  replace=False)).tolist())))
        if repr(e) not in seen:
            seen.add(repr(e))
            exc.append(e)
    coeffs = np.concatenate([[1.0], 0.2 * rng.choice([-1.0, 1.0], 5)])
    return from_excitations(coeffs, exc, n_up, n_dn, n_orb)


def _three_sides(torch, fn, blk, state, **kw):
    """``fn`` (``_sweep_block`` or ``_move_block``) on the kernel, the plain
    version and its fp64 twin, each from ``state``."""
    outs = [fn(torch, blk, state, kernel,
               dtype=None if dt is None else getattr(torch, dt), **kw)
            for kernel, dt in SIDES]
    torch.cuda.synchronize()
    return outs


def phase_ci_rank(torch, dev, seed: int, runs: dict, pool_s):
    """``[ci rank]``: the per-move kernels at excitation ranks past the 8
    their registers hold (the elimination then runs in a device workspace,
    ``csrc/ci_ratio.cuh``).  On well-conditioned synthetic up blocks at
    smallest's CI widths (n = 79, n_orb = 118, W = 256) with the
    expansions of ``_rank_k_up`` (41 determinants) at ranks 9, 16 and 39:
    ``sem_move`` driving the sweep move by move against ``sem_move_ref``,
    and ``fused_sweep`` on its rows, shared and global routes against the
    plain loop, per walker where fp32 resolves the tables
    (``_compare_sweep``'s scope rule: at rank 39 the plain version's own
    determinants sit up to ~1e-5 from fp64); then one move of ``sem_move``
    and one up-block sweep of ``fused_sweep`` (its size's route) timed at
    ranks 8, 9 and 16.  Then a user expansion built with
    ``multidet.from_excitations`` over smallest's 118 orbitals that holds
    a rank-12 excitation (with singles and doubles) runs one sem-vmc and
    one fused-vmc block through ``core/driver.py`` at W = 256 from the
    finite walkers ``pool_s`` (``--n-det`` draws only singles and
    doubles, so this is not a CLI run): finite energies, ``sem_move`` or
    ``fused_sweep`` launched.  Between them, both kernels on both blocks
    of unequal spin blocks whose up block holds a k-fold excitation with
    k above the down block's electrons (3 up / 2 down at rank 3, 12 / 6
    at rank 10; ``_unequal_ci``): every block's lists are padded to the
    one rank k."""
    import dataclasses
    from types import SimpleNamespace
    import numpy as np
    from repro_torch.core import multidet
    from repro_torch.core.driver import EnsembleDriver, make_propagator
    from repro_torch.systems import build_system
    t0 = time.perf_counter()
    bad = []
    ones = torch.ones((), device=dev)
    times = {}
    for k in (8,) + CI_RANKS:
        mdw = _rank_k_up(79, 118, k, seed=31 + k)
        cfg_k, (up, _), state = _synthetic_ci_blocks(
            torch, dev, 79, 118, mdw.n_det, WALKERS, seed=900 + k, mdw=mdw)
        if tuple(cfg_k.ci_t.holes_up_k.shape) != (mdw.n_det, k):
            _fail(f'[ci rank] the expansion is padded to '
                  f'{tuple(cfg_k.ci_t.holes_up_k.shape)}, not rank {k}')
        kw = dict(n_up=79, b_ee=ones, cfg=cfg_k)
        tag = f'CI rank {k} n=79 n_orb=118 n_det={mdw.n_det} W={WALKERS}'
        if k in CI_RANKS:
            # held by the scope rule: fp32 resolves a k x k determinant
            # only to the plain version's own distance from fp64 (at rank
            # 39 up to ~1e-5 of the walker's largest ratio)
            res = _compare_sweep(torch, f'{tag} up block',
                                 *_three_sides(torch, _move_block, up, state,
                                               **kw), False,
                                 kernel='sem_move')
            bad.extend(res['bad'])
            plain = _three_sides(torch, _sweep_block, up, state, **kw)[1:]
            for route in ('rows', 'shared', 'global'):
                out_k = _sweep_block(torch, up, state, True, route=route,
                                     **kw)
                torch.cuda.synchronize()
                res = _compare_sweep(torch, f'{tag} up block route {route}',
                                     out_k, *plain, False)
                bad.extend(res['bad'])
        if k > 16:              # timed at 8, 9 and 16
            continue
        ci_k = (up['r_other'].contiguous(), cfg_k.ci_t.holes_up_k,
                cfg_k.ci_t.parts_up_k, cfg_k.ci_t.coeffs)
        r, sign, logdet = state
        mv = _move_times(torch, up, r, sign, logdet, 79, ones, cfg_k.ci_t,
                         iters=20)
        fs = _fused_times(torch, up, SimpleNamespace(
            r=r, sign=sign, logdet=logdet), 79, ones, ci_k, iters=10)
        times[k] = (mv['ms'], fs[0], fs[3])
        print(_move_line(f'CI rank {k}', mv, True))
    # unequal spin blocks whose lists are padded past the down block's
    # electrons: 3 up / 2 down with an up triple (as a boron atom's full
    # CI has; the cofactors), 12 / 6 with a 10-fold one (the workspace);
    # both blocks, both kernels
    for n_up, n_dn, n_orb, k in ((3, 2, 6, 3), (12, 6, 30, 10)):
        mdw = _unequal_ci(n_up, n_dn, n_orb, k, seed=k)
        cfg_u, blocks_u, state_u = _synthetic_pair(
            torch, dev, n_up, n_dn, WALKERS, seed=950 + k, mdw=mdw)
        if tuple(cfg_u.ci_t.holes_dn_k.shape) != (mdw.n_det, k):
            _fail(f'[ci rank] the down block\'s lists are padded to '
                  f'{tuple(cfg_u.ci_t.holes_dn_k.shape)}, not rank {k}')
        for kernel in ('sem_move', 'fused_sweep'):
            bad += _pair_check(
                torch, kernel, f'CI rank {k} over {n_up} up / {n_dn} down '
                f'electrons, n_orb={n_orb} n_det={mdw.n_det} W={WALKERS}',
                cfg_u, blocks_u, state_u, k <= 8, n_up=n_up, b_ee=ones)
    print('[time] CI route (device, W=256, n=79, n_orb=118, 41 '
          'determinants): ' + '; '.join(
              f'rank {k}: sem_move one move {m:.4f} ms, fused_sweep one up '
              f'block {f:.4f} ms (route {rt})'
              for k, (m, f, rt) in times.items())
          + ' (ranks up to 8 in registers, above in the device workspace)')
    # a user expansion with a rank-12 excitation through core/driver.py
    cfg_ci, params = build_system(SYSTEM, n_det=100, device=dev)
    n, n_orb = cfg_ci.n_up, cfg_ci.ci.n_orb
    rng = np.random.default_rng(12)
    exc = [((list(range(n - 12, n)), list(range(n, n + 12))), ([], []))]
    for i in range(15):
        d = 1 + i % 2
        exc.append(((sorted(rng.choice(n, d, replace=False).tolist()),
                     sorted((n + rng.choice(n_orb - n, d, replace=False))
                            .tolist())),
                    (sorted(rng.choice(n, 1).tolist()),
                     sorted((n + rng.choice(n_orb - n, 1)).tolist()))))
    coeffs = np.concatenate([[1.0], 0.05 * rng.choice([-1.0, 1.0], 16)])
    mdw = multidet.from_excitations(coeffs, exc, n, cfg_ci.n_dn, n_orb)
    cfg = dataclasses.replace(cfg_ci, ci=mdw)
    if cfg.ci_t.holes_up_k.shape[1] != 12:
        _fail(f'[ci rank] user expansion padded to rank '
              f'{cfg.ci_t.holes_up_k.shape[1]}, not 12')
    for method, kernel in (('sem-vmc', 'sem_move'),
                           ('fused-vmc', 'fused_sweep')):
        counters = _counters()
        for c in counters.values():
            c.reset()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        drv = EnsembleDriver(make_propagator(method, cfg), steps=2)
        t1 = time.perf_counter()
        st = drv.init(params, gen, WALKERS, pool_s.cpu().numpy())
        st, stats = drv.run_block(params, st, gen)
        launches = {k: c.n for k, c in counters.items()}
        runs[f'ci rank 12 {method}'] = launches
        print(f'[ci rank] {method} on {SYSTEM} with a user expansion of '
              f'{mdw.n_det} determinants padded to rank 12 (one 12-fold '
              f'excitation of the up block, singles and doubles), one '
              f'block of 2 sweeps at W={WALKERS} through core/driver.py: '
              f'E {stats.e_mean:.6f}, accept {stats.aux["accept"]:.4f} in '
              f'{time.perf_counter() - t1:.1f} s; launches {launches}')
        if not (math.isfinite(stats.e_mean)
                and launches[kernel] > 0):
            bad.append(f'{method} with the rank-12 expansion: E '
                       f'{stats.e_mean}, {kernel} launched '
                       f'{launches[kernel]} times')
        if launches['sem_update'] or launches['multidet_ratio']:
            bad.append(f'{method}: a first design launched on the path')
    print(f'[ci rank] phase {time.perf_counter() - t0:.1f} s')
    if bad:
        _fail('[ci rank] ' + '; '.join(bad))


# ---------------------------------------------------------------------------
# [paper systems]: the paper's three larger systems end to end
# ---------------------------------------------------------------------------
# the beta-strand in its TZ basis (f shells) and the two PDB peptides,
# screened at the paper's AO tolerance
PAPER = ('b-strand-tz', '1ze7', '1amb')
# walkers of each held against the CPU path (~5 s a walker there at 1amb),
# the best conditioned of the first PAPER_CAND_WALKERS
PAPER_CPU_WALKERS = 4
PAPER_CAND_WALKERS = 32
# walkers of each cold start whose sweep the plain versions and their fp64
# twins repeat (the kernels sweep all 256)
PAPER_PLAIN_WALKERS = 64


def _screened_work(n_orb: int, n_ao: int, N: int, K: int, nnz: float):
    """(bytes, fp32 operations) of one screened MO product: each input read
    once (A, the active Bp values, idx, the mask), C written once."""
    flops = 2.0 * n_orb * 5.0 * nnz
    nbytes = (4.0 * (n_orb * n_ao + 5.0 * nnz + N * K + n_orb * N * 5)
              + N * K)
    return nbytes, flops


def _paper_product_times(torch, tag, cfg, params, R):
    """screened_mo on the packed inputs of the walkers R (one evaluation
    chunk): the ops call (the sort included), its plain version, and the
    library call on the same values: torch.matmul of A against the packed
    block scattered to a dense (n_ao, N * 5) B2d (the inactive entries
    zero, so the same function); the bound from the active pairs."""
    from repro_torch.core import aos, screening
    from repro_torch.kernels.screened_mo.ops import screened_mo_products
    from repro_torch.kernels.screened_mo.ref import screened_mo_ref
    pts = R.reshape(-1, 3)
    idx, active, count, key = screening.active_ao_lists_keyed(
        cfg.screening_t, pts)
    Bp = aos.eval_ao_block_screened(cfg.basis_t, params.coords, pts, idx,
                                    active)
    A = params.mo
    n_orb, n_ao = A.shape
    N, K = idx.shape
    ms, wall = _time_ms(lambda: screened_mo_products(A, Bp, idx, active,
                                                     key), iters=5)
    plain = _once_ms(torch, lambda: screened_mo_ref(A, Bp, idx, active))[0]
    B = torch.zeros((N, n_ao, 5), device=A.device)
    B.scatter_add_(1, idx.long()[..., None].expand(N, K, 5),
               torch.where(active[..., None], Bp, torch.zeros_like(Bp)))
    B2 = B.permute(1, 0, 2).reshape(n_ao, N * 5)
    del B
    lib, _ = _time_ms(lambda: torch.matmul(A, B2), iters=3)
    C_k = screened_mo_products(A, Bp, idx, active, key)
    rel = float((torch.matmul(A, B2).reshape(n_orb, N, 5) - C_k).abs().max()
                / C_k.abs().max())
    del B2, C_k
    torch.cuda.empty_cache()
    nnz = float(count.sum())
    nbytes, flops = _screened_work(n_orb, n_ao, N, K, nnz)
    bound, by = _bound_ms(nbytes, flops)
    print(f'[time] screened_mo {tag} (device, {R.shape[0]} walkers, '
          f'N={N} electrons, K={K}, {nnz / N:.1f} active a electron): '
          f'{ms:.4f} ms ops call (host {wall:.4f}), {plain:.4f} ms plain, '
          f'{lib:.4f} ms torch.matmul of A against the scattered dense B2d '
          f'(max |C_lib - C| / max |C| {rel:.2e}); bound {bound:.4f} ms '
          f'({by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e9:.4f} GB)')


def _paper_card_vs_cpu(torch, tag, name, st, pool):
    """The card's evaluation of ``PAPER_CPU_WALKERS`` finite walkers
    (``st``, from the batched pass) against the port's CPU path on the
    same positions: the best conditioned of the first
    ``PAPER_CAND_WALKERS`` (the least distance between the card's fp32
    drift and an fp64 tail on the card's MO tensor), per walker with the
    tolerances of ``_parity``,
    asserted on the walkers in ``FP32_SCOPE`` (CPU fp32 drift against an
    fp64 tail on the CPU's own MO tensor); on every walker E_pot (no
    wavefunction in it) within 1e-5 and the MO tensor (the AO pass, f
    shells included, and the screened product, before the determinants
    whose conditioning a cold start spoils) within 1e-5 of each
    electron's largest entry; and the evaluation's tail (Slater, Jastrow,
    energy) in float64 on the card's MO tensor, on the card and on the
    CPU, with the tolerances of ``_parity`` (log psi, sign, drift and E_L
    of the card's code), held on the walkers fp64 resolves: those whose
    card tail (log psi, drift, E_L) moves by at most 1e-4 relative when
    the MO tensor is perturbed by 1e-12 relative, so that fp64's own
    rounding (an LU's backward error ~1e-13 at these sizes) moves it by
    ~1e-5, a tenth of the tolerances (a cold start of the TZ beta-strand
    has walkers near a node that even fp64 does not resolve).  At least
    one walker must be resolved.  The CPU side runs on a thread of its own
    (``_in_background``) while the caller goes on with the card; returns
    a callable that waits for it, holds the two sides and gives the
    failures."""
    from repro_torch.core.wavefunction import (_finish_state,
                                               _mo_tensor_ensemble)
    from repro_torch.systems import build_system
    cpu = torch.device('cpu')
    m = PAPER_CPU_WALKERS
    cfg_d, params_d = build_system(name, screen_eps=SCREEN_EPS,
                                   device=pool.device)
    p64 = _fp64_twin(params_d)
    cand = pool[:PAPER_CAND_WALKERS]
    C_cand, count_cand = _mo_tensor_ensemble(cfg_d, params_d, cand)
    d32 = _rel(st.drift[:PAPER_CAND_WALKERS],
               _finish_state(cfg_d, p64, C_cand.double(), cand.double(),
                             count_cand).drift)
    del C_cand
    pick = torch.argsort(d32)[:m]
    walkers = pool[pick.to(pool.device)]
    R = walkers.cpu()
    C_card, count_card = _mo_tensor_ensemble(cfg_d, params_d, walkers)
    C_card_c, count_card_c = C_card.cpu(), count_card.cpu()

    def _cpu_side():
        cfg_c, params_c = build_system(name, screen_eps=SCREEN_EPS,
                                       device=cpu)
        t0 = time.perf_counter()
        C, count = _mo_tensor_ensemble(cfg_c, params_c, R)
        c_err = _per_electron_err(
            torch, C_card_c.transpose(0, 1).reshape(C.shape[1], -1, 5),
            C.transpose(0, 1).reshape(C.shape[1], -1, 5))[0]
        b = _finish_state(cfg_c, params_c, C, R, count)
        secs = time.perf_counter() - t0
        p64_c = _fp64_twin(params_c)
        exact = _finish_state(cfg_c, p64_c, C.double(), R.double(), count)
        tail_cpu = _finish_state(cfg_c, p64_c, C_card_c.double(),
                                 R.double(), count_card_c)
        return c_err, b, secs, exact, tail_cpu
    wait = _in_background(_cpu_side)
    C64 = C_card.double()
    tail_card = _finish_state(cfg_d, p64, C64, walkers.double(), count_card)
    g = torch.Generator(device=pool.device)
    g.manual_seed(7)
    C_pert = C64 * (1.0 + 1e-12 * torch.randn(
        C64.shape, generator=g, device=pool.device, dtype=torch.float64))
    pert = _finish_state(cfg_d, p64, C_pert, walkers.double(), count_card)
    sens = torch.stack([_rel(getattr(pert, f), getattr(tail_card, f))
                        for f in ('log_psi', 'drift', 'e_loc')]).amax(dim=0)
    resolved = sens <= 1e-4
    a = type(st)(*[x[pick.to(x.device)] for x in st])
    del C_card, C64, C_pert, pert
    return lambda: _paper_card_vs_cpu_hold(torch, tag, m, pick, d32, a,
                                           tail_card, sens, resolved, wait)


def _paper_card_vs_cpu_hold(torch, tag, m, pick, d32, a, tail_card, sens,
                            resolved, wait):
    """The second half of ``_paper_card_vs_cpu``: waits for the CPU side,
    prints the reading and returns the failures."""
    c_err, b, secs, exact, tail_cpu = wait()
    over64, same64 = _parity(torch, tail_card, tail_cpu)
    over, same = _parity(torch, a, b)
    cpu_err = _rel(b.drift, exact.drift)
    scope = cpu_err <= FP32_SCOPE
    fail = (over > 1.0) | ~same
    e_pot = (a.e_pot.cpu().double() - b.e_pot.double()).abs() \
        / b.e_pot.double().abs()
    counts = (a.ao_count.cpu() != b.ao_count).sum(dim=1)
    print(f'[card vs cpu] {tag}: {m} finite walkers, the best conditioned '
          f'of {PAPER_CAND_WALKERS} (walkers {pick.tolist()}; card fp32 '
          f'drift vs fp64 {[f"{x:.2e}" for x in d32[pick].tolist()]}, over '
          f'all candidates median {float(d32.median()):.2e}) (CPU path '
          f'{secs:.1f} s); {int(scope.sum())} in FP32_SCOPE (CPU fp32 drift '
          f'vs fp64 '
          f'{[f"{x:.2e}" for x in cpu_err.tolist()]}); |diff|/tol per '
          f'walker {[f"{x:.3g}" for x in over.tolist()]}, signs equal '
          f'{(a.sign.cpu() == b.sign).tolist()}, electrons whose active AO '
          f'count differs {counts.tolist()}; E_L card '
          f'{[f"{x:.4f}" for x in a.e_loc.tolist()]}, cpu '
          f'{[f"{x:.4f}" for x in b.e_loc.tolist()]}; E_pot rel '
          f'{float(e_pot.max()):.2e}; MO tensor per electron max |dC| / '
          f'max |C| {c_err:.2e} (tol 1e-5); fp64 tail on the card\'s MO '
          f'tensor: moved by a 1e-12 perturbation of it (relative) '
          f'{[f"{x:.2e}" for x in sens.tolist()]}, so {int(resolved.sum())} '
          f'resolved by fp64 (at most 1e-4); card vs cpu |diff|/tol per '
          f'walker {[f"{x:.3g}" for x in over64.tolist()]}, signs and AO '
          f'counts equal {same64.tolist()}')
    bad = []
    if not bool(resolved.any()):
        bad.append(f'{tag}: fp64 resolves none of the {m} walkers')
    if not bool(((over64 <= 1.0) & same64)[resolved].all()):
        bad.append(f'{tag}: the fp64 tail on the card disagrees with the '
                   f'CPU\'s on the same MO tensor on a resolved walker')
    if bool((fail & scope).any()):
        bad.append(f'{tag}: {int((fail & scope).sum())} in-scope walkers '
                   f'disagree with the CPU path')
    if not float(e_pot.max()) <= 1e-5:
        bad.append(f'{tag}: E_pot card vs cpu {float(e_pot.max()):.2e}')
    if not c_err <= 1e-5:
        bad.append(f'{tag}: MO tensor card vs cpu {c_err:.2e}')
    return bad


def _paper_system(torch, dev, name: str, seed: int, runs: dict):
    """One system of ``phase_paper_systems``; returns the failures."""
    from repro_torch.core import screening, wavefunction as wf
    from repro_torch.core.sem import evaluate_sem
    from repro_torch.kernels.fused_sweep import autotune
    from repro_torch.kernels.fused_sweep import kernel as fsk
    from repro_torch.systems import build_system
    bad = []
    cfg, params = build_system(name, screen_eps=SCREEN_EPS, device=dev)
    n_rows, n_e = params.mo.shape[0], cfg.n_elec
    tag = f'{name} eps={SCREEN_EPS:g}'
    # memory: the prediction first
    mb = screening.memory_budget(cfg.screening, cfg.basis, n_e, n_rows,
                                 WALKERS)
    per = wf.eval_bytes_per_walker(cfg, n_rows)
    chunks = wf.walker_chunks(cfg, params, WALKERS)
    size = chunks[0].stop - chunks[0].start
    jas = wf.JASTROW_PAIR_FLOATS * 4.0 * n_e ** 2 * WALKERS
    print(f'[paper systems] {tag}: {n_e} e- ({cfg.n_up} up, {cfg.n_dn} '
          f'down), {cfg.basis.n_ao} AOs, {n_rows} MOs, K={mb["ao_budget"]} '
          f'candidates; memory_budget at W={WALKERS}: packed B '
          f'{mb["packed_b_bytes"] / 1e9:.3f} GB + C '
          f'{mb["screened_c_bytes"] / 1e9:.3f} GB = '
          f'{mb["screened_total"] / 1e9:.3f} GB (dense '
          f'{mb["dense_total"] / 1e9:.3f} GB); predicted peak of one '
          f'evaluation of all {WALKERS}: {wf.EVAL_PEAK_PER_BUDGET} x the '
          f'budget + the Jastrow pairs {jas / 1e9:.3f} GB = '
          f'{per * WALKERS / 1e9:.2f} GB; one pass may take '
          f'{wf.eval_budget_bytes(dev) / 1e9:.2f} GB -> {len(chunks)} '
          f'chunk(s) of {size} walkers, predicted {per * size / 1e9:.2f} GB '
          f'each')
    t0 = time.perf_counter()
    pool, pool_e = _finite_pool(torch, dev, cfg, params, tag=tag, tries=12)
    PAPER_RESERVOIRS[name] = (pool, pool_e)
    print(f'[paper systems] {tag}: reservoir of {WALKERS} finite cold-start '
          f'walkers in {time.perf_counter() - t0:.1f} s')
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = wf.psi_state_batched(cfg, params, pool)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    finite = bool((torch.isfinite(st.e_loc) & torch.isfinite(st.log_psi))
                  .all())
    print(f'[paper systems] {tag}: one evaluation of the {WALKERS} finite '
          f'walkers in {secs:.2f} s ({len(chunks)} chunk(s)); '
          f'torch.cuda.max_memory_allocated {peak / 1e9:.2f} GB, '
          f'{(peak - base) / 1e9:.2f} GB above the {base / 1e9:.2f} GB held '
          f'before (predicted {per * size / 1e9:.2f} GB a chunk: measured / '
          f'predicted {(peak - base) / (per * size):.3f}); all finite '
          f'{finite}; mean E_L {float(st.e_loc.mean()):.4f}')
    if not finite:
        bad.append(f'{tag}: the evaluation of finite walkers is not finite')
    card_vs_cpu = _paper_card_vs_cpu(torch, tag, name, st, pool)
    del st
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ens = evaluate_sem(cfg, params, pool)
    torch.cuda.synchronize()
    print(f'[paper systems] {tag}: evaluate_sem (fresh inverses) peak '
          f'{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above '
          f'{base / 1e9:.2f} GB')
    # the sweeps against their plain versions, both spin blocks
    t0 = time.perf_counter()
    launch = autotune.best_launch(n_e, WALKERS)
    got = {k: v for k, v in autotune.measured_times().items()
           if k.startswith(f'{n_e}|{WALKERS}|')}
    print(f'[tune] fused_sweep at n_e={n_e}, W={WALKERS}: {launch} in '
          f'{time.perf_counter() - t0:.1f} s (the tuner\'s first use; one '
          f'candidate left is taken unmeasured); candidates (CUDA events; '
          f'one launch after an untimed one where that takes over 0.1 s, '
          f'else the least of 5 after 25 ms of them): '
          + ('; '.join(f'{key}: ' + ', '.join(
              f'{k}: {v * 1e3:.4f} ms' for k, v in c.items())
              for key, c in got.items()) if got
             else 'none measured in this run'))
    gen = torch.Generator(device=dev)
    gen.manual_seed(83)
    blocks = _fused_blocks(torch, cfg, params, ens, gen)
    kw = dict(n_up=cfg.n_up, b_ee=params.jastrow.b_ee, cfg=cfg)
    m = PAPER_PLAIN_WALKERS

    def _head(x):
        return (x[:m] if torch.is_tensor(x) and x.dim()
                and x.shape[0] == WALKERS else x)
    held = (f'the synthetic blocks of {cfg.n_up} and {cfg.n_dn} electrons '
            f'at W={WALKERS} below')
    for kernel, fn in (('fused_sweep', _sweep_block),
                       ('sem_move', _move_block)):
        t0 = time.perf_counter()
        state = (ens.r, ens.sign, ens.logdet)
        for blk in blocks:
            n = blk['minv'].shape[1]
            # the kernel on all W walkers (one block a walker: a walker's
            # result does not depend on W), the plain version and its
            # fp64 twin on the first m
            out_k = fn(torch, blk, state, True, **kw,
                       **(launch if kernel == 'fused_sweep' else {}))
            sub = {k: _head(v) for k, v in blk.items()}
            outs = [tuple(_head(x) for x in out_k)] + [
                fn(torch, sub, tuple(_head(x) for x in state), False,
                   dtype=None if dt is None else getattr(torch, dt), **kw)
                for _, dt in SIDES[1:]]
            torch.cuda.synchronize()
            res = _compare_sweep(torch, f'{tag} W={WALKERS} {blk["spin"]} '
                                 f'block n={n} (the plain version on the '
                                 f'first {m})', *outs, False, kernel=kernel,
                                 held_elsewhere=held)
            bad.extend(res['bad'])
            # every side's down block starts where the kernel's up block
            # ended
            state = (out_k[0], out_k[2], out_k[3])
            del outs, out_k
        print(f'[paper systems] {tag}: {kernel} against its plain version '
              f'(and fp64 twin), both spin blocks, in '
              f'{time.perf_counter() - t0:.1f} s')
    # both kernels held per walker (strict) on well-conditioned synthetic
    # blocks of this system's spin blocks: W = 256, n_up and n_dn, the
    # down block at offset n_up, the fused sweep on the tuned launch (the
    # cluster route past n = 256)
    t0 = time.perf_counter()
    card = fsk.device_card(dev)
    routes = [fsk.launch_shape(n, n, n_e, walkers=WALKERS, card=card,
                               **launch).route
              for n in (cfg.n_up, cfg.n_dn)]
    if any(n > 256 and rt != 'cluster'
           for n, rt in zip((cfg.n_up, cfg.n_dn), routes)):
        bad.append(f'{tag}: fused_sweep routes {routes} at n_up={cfg.n_up}, '
                   f'n_dn={cfg.n_dn}; past n = 256 the cluster route')
    syn_cfg, syn, syn_state = _synthetic_pair(torch, dev, cfg.n_up, cfg.n_dn,
                                              WALKERS, seed=n_e)
    ones = torch.ones((), device=dev)
    for kernel in ('fused_sweep', 'sem_move'):
        bad += _pair_check(
            torch, kernel, f'{tag} synthetic W={WALKERS} (route '
            f'{"/".join(routes) if kernel == "fused_sweep" else "-"})',
            syn_cfg, syn, syn_state, True, n_up=cfg.n_up, b_ee=ones,
            launch=launch if kernel == 'fused_sweep' else None)
    del syn, syn_state
    print(f'[paper systems] {tag}: fused_sweep and sem_move held per walker '
          f'on synthetic blocks of {cfg.n_up} and {cfg.n_dn} electrons in '
          f'{time.perf_counter() - t0:.1f} s')
    del blocks, ens
    torch.cuda.empty_cache()
    # runs through qmc_run, resumed from the reservoir
    reservoir = (pool.cpu().numpy(), pool_e.cpu().numpy())
    screen = ('--screen-eps', f'{SCREEN_EPS:g}')
    old = ('sparse_mo', 'sem_update', 'multidet_ratio')
    # (method, blocks, sub-blocks a block, extra flags, needs, forbids),
    # one step a sub-block: fused-vmc one block of 9 sweeps, past the
    # sem_refresh boundary at 8; sem-vmc one block of 2 sweeps (host-paced,
    # ~170 launches a move); dmc and vmc 2 blocks of 2 generations.  Cut
    # for the script's time limit when [paper systems ci] came (before in
    # brackets): sem-vmc on 1ze7 and 1amb 1 sweep (1ze7 9, 1amb 2; a
    # host-paced sweep 4.4 and 6.8 s); on 1amb, whose sweeps take longest,
    # fused-vmc 2 sweeps (9; the cluster route goes past the refresh on
    # 1ze7) and dmc one block (2)
    amb, big = name == '1amb', name != 'b-strand-tz'
    cells = [('fused-vmc', 1, 2 if amb else 9, (), ('fused_sweep',),
              ('sem_move',)),
             ('sem-vmc', 1, 1 if big else 2, (), ('sem_move',),
              ('fused_sweep',)),
             ('dmc', 1 if amb else 2, 2, (), (), ('sem_move', 'fused_sweep'))]
    if name == 'b-strand-tz':
        cells.append(('vmc', 2, 2, ('--tau', '0.01'), (),
                      ('sem_move', 'fused_sweep')))
    for method, blocks_n, sub, extra, needs, forbid in cells:
        runs[f'{name} {method}'] = _run_cli(
            method, steps=1, blocks=blocks_n, subblocks=sub,
            needs=('screened_mo',) + needs, seed=seed, extra=screen + extra,
            system=name, forbid=old + forbid, reservoir=reservoir,
            built=(cfg, params))
    return bad + card_vs_cpu()


def phase_paper_systems(torch, dev, seed: int, runs: dict, pool_s=None):
    """``[paper systems]``: the paper's beta-strand in its TZ basis (434
    e-, 2856 AOs with f shells), 1ZE7 (1056 e-, 2322 AOs) and 1AMB (1731
    e-: 866 up, 865 down, 3804 AOs), each screened at eps = 1e-8 (K =
    744, 1072, 1392 candidates) at W = 256.  Per system: the predicted
    peak of one evaluation (``wavefunction.eval_bytes_per_walker``, from
    ``screening.memory_budget``) and the walker chunks it gives; a
    reservoir of 256 finite cold-start walkers (cold starts drawn until
    256 are finite, the dead ones dropped and counted); one evaluation of
    them with its ``torch.cuda.max_memory_allocated``; the card against
    the CPU path on ``PAPER_CPU_WALKERS`` of them (``_paper_card_vs_cpu``:
    the best conditioned, and the fp64 tail; its CPU side runs beside the
    card's work that follows, held at the end); the fresh SEM state; the
    fused-sweep tuner at these sizes (its first-use cost); ``fused_sweep``
    and ``sem_move`` on all 256 walkers
    against their plain versions (and fp64 twins) on the first
    ``PAPER_PLAIN_WALKERS``, for one sweep of both spin blocks (n = 217;
    528; 866 and 865; each down block from the kernel's up block), by the
    scope rule of a cold start (``_compare_sweep``; at 1ze7 and 1amb fp32
    resolves no such walker, so those readings name the strict check
    next); both kernels held strictly, per walker, on all 256 walkers of
    well-conditioned synthetic blocks of the same shapes
    (``_synthetic_pair``: n_up and n_dn, the down block at offset n_up,
    the fused sweep on the tuned launch, whose route past n = 256 must be
    the cluster route); then through ``qmc_run``'s path (``_run_cli``, the
    block's sub-blocks set on the RunSpec) resumed from the reservoir:
    fused-vmc one block of 9 sweeps, past the sem_refresh boundary at 8
    (1amb 2), sem-vmc one block of 2 sweeps (1ze7 and 1amb 1), dmc 2
    blocks of 2 generations (1amb one), and on the TZ beta-strand vmc 2 blocks of 2
    steps, each checking its launch counters (screened_mo ran, sparse_mo
    and the first designs did not, the method's per-move kernel did).
    The kernels' times at these sizes are in PERF.md §6; this phase
    checks.  A DMC population that collapses is
    recorded, not failed."""
    t_phase = time.perf_counter()
    bad = []
    for name in PAPER:
        t0 = time.perf_counter()
        bad += _paper_system(torch, dev, name, seed, runs)
        torch.cuda.empty_cache()
        print(f'[paper systems] {name}: {time.perf_counter() - t0:.1f} s')
    print(f'[paper systems] phase {time.perf_counter() - t_phase:.1f} s')
    if bad:
        _fail('[paper systems] ' + '; '.join(bad))


# ---------------------------------------------------------------------------
# [paper systems ci]: --n-det 100 and opt-vmc on 1ze7 and 1amb
# ---------------------------------------------------------------------------
# the two peptides with the CI expansion of ``--n-det 100`` (the synthetic
# rank-2 expansion over max(8, n_up // 2) virtual rows, seeded by the run
# seed as qmc_run seeds it)
PAPER_CI = ('1ze7', '1amb')
CI_DETS = 100
# walkers of the synthetic CI blocks that the plain versions and their
# fp64 twins repeat, ``_held_walkers``: 0, 17, 34, ..., 255 (the kernels
# sweep all 256; the plain versions' sweeps with CI on all 256 at 1amb
# do not fit the script's time limit)
PAPER_CI_PLAIN_WALKERS = 16
# the reservoirs of finite cold-start walkers [paper systems] drew ({name:
# (walkers, energies)} on the card); [paper systems ci] resumes from them
PAPER_RESERVOIRS: dict = {}
# fused_sweep's cluster route with CI (chain, replay, the global route
# beside) and sem_move with CI at the paper systems' widths ([paper systems
# ci]), for the kernels line
PAPER_CI_TIMES: dict = {}


def _measured(torch, fn):
    """(result, seconds, peak bytes above what was held before, bytes
    held before) of ``fn()`` on the card."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base, base)


def _paper_ci_memory(torch, tag, cfg, params, cfg1, params1, pool):
    """One evaluation of the reservoir ``pool`` with CI, one O pass at P =
    3 + n_det (CI) and one at P = 3 (``cfg1``, the single determinant),
    each with its predicted working set a walker
    (``wavefunction.eval_bytes_per_walker``, ``o_bytes_per_walker``), the
    walker chunks that gives and the predicted bytes a chunk beside the
    measured ``torch.cuda.max_memory_allocated`` above what was held
    before; fails unless every measured peak is under
    ``eval_budget_bytes`` and every result finite.  Then the rows of the
    chunked O at P = 3 + n_det against one unchunked call on a chunk's
    worth of walkers across the first chunk boundary (the same batch
    size: the same batched LU and GEMM), per walker within 1e-6 (the CPU
    test's tolerance, by ``_o_over``), CI columns included.  Returns (the
    failures, that chunked O)."""
    from repro_torch.core import wavefunction as wf
    from repro_torch.optimize.estimators import n_params, o_batched
    budget = wf.eval_budget_bytes(pool.device)
    bad, O_ci = [], None
    for label, c, p, per_fn, fn in (
            (f'one evaluation (n_det={CI_DETS})', cfg, params,
             wf.eval_bytes_per_walker,
             lambda: wf.psi_state_batched(cfg, params, pool)),
            (f'one O pass at P={n_params(cfg)}', cfg, params,
             wf.o_bytes_per_walker, lambda: o_batched(cfg, params, pool)),
            (f'one O pass at P={n_params(cfg1)}', cfg1, params1,
             wf.o_bytes_per_walker, lambda: o_batched(cfg1, params1, pool))):
        per = per_fn(c, p.mo.shape[0])
        chunks = wf.walker_chunks(c, p, WALKERS, per_fn)
        size = chunks[0].stop - chunks[0].start
        out, secs, peak, base = _measured(torch, fn)
        vals = (out.e_loc, out.log_psi) if hasattr(out, 'e_loc') else (out,)
        finite = all(bool(torch.isfinite(v).all()) for v in vals)
        print(f'[paper systems ci] {tag}: {label} of the {WALKERS} reservoir '
              f'walkers: predicted {per / 1e9:.4f} GB a walker -> '
              f'{len(chunks)} chunk(s) of {size}, {per * size / 1e9:.2f} GB '
              f'a chunk; measured in {secs:.2f} s, '
              f'torch.cuda.max_memory_allocated {peak / 1e9:.2f} GB above the '
              f'{base / 1e9:.2f} GB held before (measured / predicted '
              f'{peak / (per * size):.3f}; the pass may take '
              f'{budget / 1e9:.2f} GB); all finite {finite}'
              + (f'; mean E_L {float(out.e_loc.mean()):.4f}'
                 if hasattr(out, 'e_loc') else
                 f'; shape {tuple(out.shape)}'))
        if not peak < budget:
            bad.append(f'{tag}: {label} peaked at {peak / 1e9:.2f} GB, over '
                       f'the {budget / 1e9:.2f} GB a pass may take')
        if not finite:
            bad.append(f'{tag}: {label} is not finite')
        if c is cfg and per_fn is wf.o_bytes_per_walker:
            O_ci = out
        del out
        torch.cuda.empty_cache()
    chunks = wf.walker_chunks(cfg, params, WALKERS, wf.o_bytes_per_walker)
    size = chunks[0].stop - chunks[0].start
    win = slice(size // 2, size // 2 + size)
    O_win = o_batched(cfg, params, pool[win])
    over = _o_over(O_win, O_ci[win], rtol=1e-6, scale=1e-6)
    print(f'[paper systems ci] {tag}: the chunked O at P={n_params(cfg)} '
          f'({len(chunks)} chunks of {size}) against one unchunked call on '
          f'walkers {win.start}..{win.stop - 1}: worst |diff| / (1e-6 |O| '
          f'+ 1e-6 x the walker\'s largest |O| in the part) '
          f'{float(over.max()):.3g}, {int((O_win != O_ci[win]).any(1).sum())}'
          f' of {size} rows not bitwise equal')
    if not bool((over <= 1.0).all()):
        bad.append(f'{tag}: {int((over > 1.0).sum())} rows of the chunked O '
                   f'differ from the unchunked call past 1e-6')
    return bad, O_ci


def _paper_ci_o_check(torch, tag, name, seed, cfg, params, pool):
    """opt-vmc's O at P = 3 + n_det on the card against the CPU path on
    the first ``PAPER_CPU_WALKERS`` reservoir walkers, under
    ``phase_opt_o_checks``' contract (``_o_over``: rtol 1e-4 plus 1e-5 of
    the walker's largest |O| in the part): the Jastrow columns on every
    walker; the CI columns on the walkers whose CPU fp32 O is within a
    tenth of the contract of an fp64 central difference (``_o_fd64``,
    ``FP32_SCOPE``'s rule).  At a cold start of these sizes none may
    qualify; the line then names the checks that hold the CI columns.
    The same walkers' rows of ``O_all``, the chunked pass over all 256,
    against the card's unchunked call on them at 1e-6: the Jastrow
    columns must agree; the CI columns are read (a batch of 4 and one of
    128 may take different GEMM and LU kernels, whose fp32 rounding these
    walkers' ill-conditioned blocks magnify; ``_paper_ci_memory`` holds
    them at one batch size).  The CPU side starts on a thread of its own
    (``_in_background``); returns a callable that takes ``O_all``, waits
    for it and gives the failures."""
    from repro_torch.optimize.estimators import o_batched
    from repro_torch.systems import build_system
    cpu = torch.device('cpu')
    R = pool[:PAPER_CPU_WALKERS]
    R_c = R.cpu()

    def _cpu_side():
        cfg_c, params_c = build_system(name, n_det=CI_DETS, ci_seed=seed,
                                       screen_eps=SCREEN_EPS, device=cpu)
        t0 = time.perf_counter()
        O_c = o_batched(cfg_c, params_c, R_c)
        fd = _o_fd64(torch, cfg_c, params_c, R_c)
        return O_c, fd, time.perf_counter() - t0
    wait = _in_background(_cpu_side)
    return lambda O_all: _paper_ci_o_hold(torch, tag, cfg, params, R, O_all,
                                          wait)


def _paper_ci_o_hold(torch, tag, cfg, params, R, O_all, wait):
    """The second half of ``_paper_ci_o_check``: the card's O, the CPU
    side's when it is done, the reading and the failures."""
    from repro_torch.optimize.estimators import N_JASTROW, o_batched
    O_g = o_batched(cfg, params, R)
    O_c, fd, secs = wait()
    jas, cis = slice(0, N_JASTROW), slice(N_JASTROW, None)
    jas_over = _o_over(O_g, O_c, cols=jas)
    ci_over = _o_over(O_g, O_c, cols=cis)
    rows = O_all[:R.shape[0]]
    jas_chunk = _o_over(rows, O_g, rtol=1e-6, scale=1e-6, cols=jas)
    ci_chunk = _o_over(rows, O_g, rtol=1e-6, scale=1e-6, cols=cis)
    print(f'[paper systems ci] {tag}: the chunked O\'s rows of these '
          f'walkers against the unchunked call, |diff| / (1e-6 |O| + 1e-6 x '
          f'the walker\'s largest |O| in the part) per walker: Jastrow '
          f'columns {[f"{x:.3g}" for x in jas_chunk.tolist()]}, CI columns '
          f'{[f"{x:.3g}" for x in ci_chunk.tolist()]}')
    cpu_vs_64 = _o_over(O_c, fd, rtol=1e-5, scale=1e-6, cols=cis)
    scope = cpu_vs_64 <= 1.0
    n_in = int(scope.sum())
    held = ('' if n_in else
            '; no walker in scope: the CI columns are held per walker by '
            '[opt-vmc]\'s O checks at P = 103 (the same estimator on '
            'smallest\'s equilibrated walkers) and their inputs here by '
            '[paper systems]\' MO tensor card vs CPU (1e-5 per electron)')
    print(f'[paper systems ci] {tag}: O on the card vs the CPU path on '
          f'{R.shape[0]} reservoir walkers (CPU O and fp64 difference '
          f'{secs:.1f} s): Jastrow columns |diff|/tol per walker '
          f'{[f"{x:.3g}" for x in jas_over.tolist()]}; CI columns '
          f'{[f"{x:.3g}" for x in ci_over.tolist()]}, {n_in} walker(s) in '
          f'scope (CPU fp32 O within a tenth of the contract of the fp64 '
          f'difference: {[f"{x:.3g}" for x in cpu_vs_64.tolist()]}); |O| '
          f'max per part '
          + ', '.join(f'{float(O_g[:, c].abs().max()):.4g}'
                      for c in (jas, cis)) + held)
    bad = []
    if not bool(torch.isfinite(O_g).all()):
        bad.append(f'{tag}: O on the card not finite')
    if not bool((jas_over <= 1.0).all()):
        bad.append(f'{tag}: Jastrow columns of O past the contract')
    if not bool((jas_chunk <= 1.0).all()):
        bad.append(f'{tag}: the chunked O\'s Jastrow columns differ from '
                   f'the unchunked call past 1e-6')
    if bool((ci_over[scope] > 1.0).any()):
        bad.append(f'{tag}: CI columns of O past the contract on '
                   f'{int((ci_over[scope] > 1.0).sum())} walkers in scope')
    return bad


def _paper_ci_kernels(torch, dev, tag, cfg, n_e):
    """``fused_sweep`` (tuned on CI operands: the cluster route with CI,
    the chain, then the replay of the rows of P it did not hold) and
    ``sem_move`` with the system's own CI expansion on well-conditioned
    synthetic blocks of its spin blocks (``_synthetic_pair``: W = 256,
    n_up and n_dn, the virtual orbitals, P and rdet as the path builds
    them), held per walker (strict: decisions, Minv, every row of P,
    rdet, logdet) against the plain versions and their fp64 twins on
    ``PAPER_CI_PLAIN_WALKERS`` of the 256 (``_held_walkers``); then timed a
    spin block (fused_sweep, each block: the chain and the replay apart,
    the global route in the same run, the bound; the plain versions on the
    up block) and a move (sem_move, the up block's first), each with its
    bound, and the replay alone held against ``p_replay_ref`` on the rows
    the chain wrote.  Returns the failures."""
    from types import SimpleNamespace
    from repro_torch.kernels.fused_sweep import autotune
    from repro_torch.kernels.fused_sweep import kernel as fsk
    from repro_torch.kernels.fused_sweep.ref import (fused_sweep_ref,
                                                     p_replay_ref)
    ci = (cfg.ci.n_orb, cfg.ci.n_det, cfg.ci_t.holes_up_k.shape[-1])
    t0 = time.perf_counter()
    launch = autotune.best_launch(n_e, WALKERS, ci=ci)
    cands = autotune.measured_times().get(
        f'{n_e}|{WALKERS}|fp32|cuda|{autotune.CLUSTER_TAG}|'
        f'{autotune._ci_tag(ci)}', {})
    print(f'[tune] fused_sweep with CI at n_e={n_e}, W={WALKERS}, n_orb='
          f'{ci[0]}, n_det={ci[1]}, rank {ci[2]}: {launch} in '
          f'{time.perf_counter() - t0:.1f} s (first use); candidates (CUDA '
          f'events on synthetic CI operands, the chain and the replay): '
          + (', '.join(f'clusters of {k}: {v * 1e3:.2f} ms'
                       for k, v in cands.items())
             or 'one size holds the block, not measured'))
    card = fsk.device_card(dev)
    syn_cfg, blocks, state = _synthetic_pair(torch, dev, cfg.n_up, cfg.n_dn,
                                             WALKERS, seed=n_e + 1,
                                             mdw=cfg.ci)
    maps = [fsk.ci_maps(getattr(syn_cfg.ci_t, f'holes_{blk["spin"]}_k'),
                        getattr(syn_cfg.ci_t, f'parts_{blk["spin"]}_k'),
                        blk['minv'].shape[1], ci[0]) for blk in blocks]
    routes = [fsk.launch_shape(blk['minv'].shape[1], ci[0], n_e, ci[0],
                               ci[1], True, walkers=WALKERS, card=card,
                               k=ci[2], held=m.n_held, pairs=m.n_pairs,
                               **launch).route
              for blk, m in zip(blocks, maps)]
    print(f'[paper systems ci] {tag}: the expansion names '
          f'{[m.n_held for m in maps]} particles (held rows, up / down) at '
          f'{[m.n_pairs for m in maps]} (particle, hole) entries')
    bad = []
    if routes != ['cluster', 'cluster']:
        bad.append(f'{tag}: fused_sweep with CI takes routes {routes}; the '
                   f'cluster route past n = 256')
    ones = torch.ones((), device=dev)
    t0 = time.perf_counter()
    for kernel in ('fused_sweep', 'sem_move'):
        bad += _pair_check(
            torch, kernel, f'{tag} n_det={ci[1]} synthetic W={WALKERS} '
            f'(route {"/".join(routes) if kernel == "fused_sweep" else "-"})',
            syn_cfg, blocks, state, True, n_up=cfg.n_up, b_ee=ones,
            launch=launch if kernel == 'fused_sweep' else None,
            plain_walkers=PAPER_CI_PLAIN_WALKERS)
    print(f'[paper systems ci] {tag}: fused_sweep and sem_move with CI held '
          f'per walker on synthetic blocks of {cfg.n_up} and {cfg.n_dn} '
          f'electrons in {time.perf_counter() - t0:.1f} s')
    r, sign, logdet = state
    sides = SimpleNamespace(r=r, sign=sign, logdet=logdet)
    ci_t = syn_cfg.ci_t
    rows = {}
    for blk, m in zip(blocks, maps):
        n, spin = blk['minv'].shape[1], blk['spin']
        lists = (blk['r_other'].contiguous(), getattr(ci_t, f'holes_{spin}_k'),
                 getattr(ci_t, f'parts_{spin}_k'), ci_t.coeffs)
        # the chain and the replay, then again with the replay's inputs
        # kept (it is held alone against p_replay_ref on the rows the chain
        # wrote), then the first design's global route in the same run
        with _replay_split(torch, fsk) as calls:
            ms, _, acc, route, shape = _fused_times(
                torch, blk, sides, cfg.n_up, ones, lists, iters=1, warmup=0,
                **launch)
        ms_replay = calls[0]['e0'].elapsed_time(calls[0]['e1'])
        with _replay_split(torch, fsk, keep=True) as calls:
            _fused_times(torch, blk, sides, cfg.n_up, ones, lists, iters=1,
                         warmup=0, **launch)
        rp = calls[0]
        ms_global = _fused_times(torch, blk, sides, cfg.n_up, ones, lists,
                                 iters=1, warmup=0, route='global',
                                 threads=256)[0]
        n_acc = float(acc.sum())
        nbytes, flops = _fused_work(WALKERS, n, n_e, n_acc, *ci,
                                    held=m.n_held)
        bound, by = _bound_ms(nbytes, flops)
        # the earlier count: g over all n_orb rows on every move
        bound_all = _bound_ms(*_fused_work(WALKERS, n, n_e, n_acc, *ci,
                                           held=ci[0]))[0]
        rb, rf = _replay_work(WALKERS, n, m.replay.shape[0], ci[0], n_acc)
        r_bound, r_by = _bound_ms(rb, rf)
        # the replay alone against its plain version on 16 walkers
        held_w = torch.tensor(_held_walkers(WALKERS, PAPER_CI_PLAIN_WALKERS),
                              device=dev)
        want = p_replay_ref(rp['P0'][held_w], rp['rows'][held_w],
                            rp['phi'][held_w], rp['acc'][held_w].bool(),
                            rp['rep'].long())
        got = rp['P'][held_w]
        rel = float(((got - want).abs().amax(dim=(1, 2))
                     / want.abs().amax(dim=(1, 2))).max())
        abs_err = float((got - want).abs().max())
        print(f'[check] fused_sweep_p_replay {tag} {spin} block alone '
              f'(the {m.replay.shape[0]} rows the chain did not hold, on the '
              f'rows it wrote, {PAPER_CI_PLAIN_WALKERS} walkers) against '
              f'p_replay_ref: max |P - plain| {abs_err:.3e}, per-walker rel '
              f'{rel:.3e} (tol 1e-5)')
        if not rel <= 1e-5:
            bad.append(f'{tag} {spin}: the replay alone {rel:.3e} from '
                       f'p_replay_ref')
        replay_plain = None
        if spin == 'up':     # the replay's plain version, all walkers
            replay_plain = _once_ms(torch, lambda: p_replay_ref(
                rp['P0'], rp['rows'], rp['phi'], rp['acc'].bool(),
                rp['rep'].long()))[0]
        del calls, rp, want, got
        row = dict(n=n, ms=ms, chain_ms=ms - ms_replay, replay_ms=ms_replay,
                   global_ms=ms_global, bound_ms=bound, bound_by=by,
                   bound_all_rows_ms=bound_all,
                   replay_bound_ms=r_bound, replay_bound_by=r_by,
                   replay_abs_err=abs_err, replay_rel_err=rel,
                   accepted=n_acc / acc.numel(), threads=shape.threads,
                   cluster=shape.cluster, held=m.n_held,
                   replay_plain_ms=replay_plain)
        line = (f'[time] fused_sweep {tag} n_det={ci[1]} {spin} block '
                f'(device, one spin block, n={n}, n_orb={ci[0]}, W={WALKERS}, '
                f'{int(n_acc)}/{acc.numel()} accepted, synthetic): {ms:.4f} '
                f'ms, {ms / n:.4f} ms a move, route {route} ({m.n_held} held '
                f'rows): chain {ms - ms_replay:.4f} ms, replay '
                f'{ms_replay:.4f} ms ({m.replay.shape[0]} rows; bound '
                f'{r_bound:.4f} ms, {r_by}), {shape}; the global route in '
                f'the same run {ms_global:.4f} ms ({ms_global / ms:.2f}x); '
                f'bound {bound:.4f} ms ({by}: {nbytes / 1e6:.3f} MB, '
                f'{flops / 1e9:.4f} GFLOP; {bound_all:.4f} ms counting g '
                f'over all {ci[0]} rows every move); kernel / bound '
                f'{ms / bound:.1f}')
        if spin == 'up':
            # one call between CUDA events: its ~50 launches a move are
            # issued as the device runs them (host-paced)
            row['plain_ms'] = _once_ms(torch, lambda: fused_sweep_ref(
                r, blk['minv'], sign, logdet, blk['phi'], blk['r_prop'],
                blk['en'], blk['logu'], ones, offset=0, n_up=cfg.n_up,
                P=blk['P'], rdet=blk['rdet'], ci_args=(
                    ci_t.holes_up, ci_t.parts_up, ci_t.coeffs,
                    blk['r_other'])))[0]
            # the largest pieces PyTorch calls do of one move: u = Minv
            # phi (torch.bmm) and the CI table pass (the einsum over P)
            minv, phi = blk['minv'], blk['phi'][:, 0, :n].contiguous()

            def _library():
                torch.bmm(minv, phi[:, :, None])
                torch.einsum('woh,wh->wo', blk['P'], phi)
            row['library_ms'] = _time_ms(_library, iters=20)[0]
            line += (f'; plain version {row["plain_ms"]:.2f} ms (one call '
                     f'between CUDA events, host-paced), the replay\'s '
                     f'{replay_plain:.2f} ms; '
                     f'{row["library_ms"]:.4f} ms torch.bmm of one move\'s u '
                     f'+ the einsum of its table pass (no single library '
                     f'call does the sweep)')
            mv = _move_times(torch, blk, r, sign, logdet, cfg.n_up, ones,
                             ci_t, iters=10)
            print(_move_line(f'{tag} n_det={ci[1]} up block, synthetic', mv,
                             True))
            rows['sem_move'] = {k: mv[k] for k in (
                'n', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                'n_acc')}
        rows[f'fused_sweep {spin}'] = row
        print(line)
    PAPER_CI_TIMES[tag] = rows
    del blocks, state
    torch.cuda.empty_cache()
    return bad


def _profiled_run(torch, label: str, moves: int, fn):
    """``fn()`` (a whole run) under the profiler: one ``[layer] run`` line
    with its wall by the host clock, its device busy time (every kernel
    and copy of the process, the run's worker thread included), the idle
    share, and the launches issued over ``moves`` (electrons x sweeps or
    generations; the run's set-up evaluations included).  Returns what
    ``fn`` returns."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    tr = Trace(prof)
    chain = [tr.part(f'fused_sweep_{r}') for r in ('rows', 'cluster',
                                                   'tables')]
    replay = tr.part('fused_sweep_p_replay')
    print(f'[layer] {label}, the whole run: wall {wall:.1f} ms, device busy '
          f'{tr.busy:.1f} ms (idle {100 * (1 - tr.busy / wall):.1f} %; '
          f'{tr.recorded} device records for {tr.issued} launches and copies '
          f'issued, {tr.issued / moves:.1f} a move; reading the profile '
          f'{time.perf_counter() - t0 - wall / 1e3:.1f} s); fused_sweep '
          f'{sum(x[0] for x in chain):.3f} ms x{sum(x[1] for x in chain)}, '
          f'its replay {replay[0]:.3f} ms x{replay[1]}; top: {tr.top()}')
    return out


def _run_paper_opt(label: str, name: str, seed: int, reservoir, *,
                   n_det: int, opt_steps: int, built=None):
    """``qmc_run --method opt-vmc`` on a paper system (screened, SR, tau
    0.01, W = ``WALKERS``, one worker, one block of one step a parameter
    step: the RunSpec's sub-blocks set to 1, built and run as
    ``qmc_run.main`` does), resumed from ``reservoir``; checked by
    ``_check_opt`` (screened_mo launched, sparse_mo and every per-move
    kernel not).  ``built`` as ``_run_cli`` takes it.  Returns the
    launches."""
    import shutil
    from repro_torch.launch import qmc_run
    from repro_torch.launch.spec import build_run
    out = ROOT / 'build' / 'chip_smoke' / label.replace(' ', '_')
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    db = out / 'runs.sqlite'
    args = ['--system', name, '--method', 'opt-vmc',
            '--walkers', str(WALKERS), '--workers', '1', '--steps', '1',
            '--backend', 'thread', '--seed', str(seed), '--tau', '0.01',
            '--opt-steps', str(opt_steps), '--opt-solver', 'sr',
            '--opt-blocks', '1', '--ckpt-dir', str(out / 'ckpt'),
            '--db', str(db), '--wall-clock', '600',
            '--screen-eps', f'{SCREEN_EPS:g}', '--n-det', str(n_det)]
    _store_reservoir(args, db, reservoir, built)
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    run = build_run(dataclasses.replace(qmc_run.parse_spec(args),
                                        subblocks_per_block=1))
    res = run.run()
    secs = time.perf_counter() - t0
    if run.worker_errors():
        _fail(f'{label}: worker errors {run.worker_errors()[:1]}')
    launches = {k: c.n for k, c in counters.items()}
    _check_opt(label, res, secs, launches, run.db.blocks(run.run_key),
               mo_kernel='screened_mo')
    return launches


def _paper_ci_system(torch, dev, name: str, seed: int, runs: dict,
                     measure: bool):
    """One system of ``phase_paper_systems_ci``; returns the failures."""
    from repro_torch.core import screening, wavefunction as wf
    from repro_torch.core.driver import Population, make_propagator
    from repro_torch.kernels.fused_sweep import kernel as fsk
    from repro_torch.kernels.sem_update import kernel as suk
    from repro_torch.systems import build_system
    t_sys = time.perf_counter()

    def _at(what):
        print(f'[paper systems ci] {name}: {what} done at '
              f'{time.perf_counter() - t_sys:.1f} s', flush=True)
    cfg, params = build_system(name, n_det=CI_DETS, ci_seed=seed,
                               screen_eps=SCREEN_EPS, device=dev)
    cfg1, params1 = build_system(name, screen_eps=SCREEN_EPS, device=dev)
    n_e, n_orb = cfg.n_elec, cfg.ci.n_orb
    tag = f'{name} eps={SCREEN_EPS:g}'
    if name not in PAPER_RESERVOIRS:
        # alone: the reservoir [paper systems] draws, the same way
        PAPER_RESERVOIRS[name] = _finite_pool(torch, dev, cfg1, params1,
                                              tag=tag, tries=12)
    pool, pool_e = PAPER_RESERVOIRS[name]
    K, K1 = (screening.memory_budget(c.screening, c.basis, n_e, rows,
                                     1)['ao_budget']
             for c, rows in ((cfg, n_orb), (cfg1, cfg.n_up)))
    print(f'[paper systems ci] {tag} --n-det {CI_DETS}: n_orb={n_orb} '
          f'({n_orb - cfg.n_up} virtual rows), K={K} candidates (single '
          f'determinant: K={K1}), '
          f'{cfg.ci.n_det} determinants, excitation lists of rank '
          f'{cfg.ci.k} (padded to {cfg.ci_t.holes_up_k.shape[-1]} for the '
          f'kernels); resumed from the {WALKERS} finite cold-start walkers '
          f'of [paper systems]')
    # at 1ze7 O against the CPU path, whose CPU side starts here and runs
    # beside the card's work below
    o_check = (_paper_ci_o_check(torch, tag, name, seed, cfg, params, pool)
               if name == '1ze7' else None)
    bad, O_all = _paper_ci_memory(torch, tag, cfg, params, cfg1, params1,
                                  pool)
    # screened_mo at the CI widths (n_orb rows), one evaluation chunk
    _paper_product_times(torch, f'{tag} n_det={CI_DETS}', cfg, params,
                         pool[wf.walker_chunks(cfg, params, WALKERS)[0]])
    _at('memory, screened_mo')
    bad += _paper_ci_kernels(torch, dev, tag, cfg, n_e)
    _at('kernels')
    if o_check is not None:
        bad += o_check(O_all)
        _at('O against the CPU path')
    del O_all
    # runs through qmc_run, resumed from the reservoir: (method, sub-blocks
    # of one step in the run's one block, needs, forbids); 1ze7's fused-vmc
    # 9 sweeps, past the sem_refresh boundary at 8 (the P tables' refresh)
    reservoir = (pool.cpu().numpy(), pool_e.cpu().numpy())
    flags = ('--screen-eps', f'{SCREEN_EPS:g}', '--n-det', str(CI_DETS))
    old = ('sparse_mo',) + FIRST_DESIGNS
    cells = [('fused-vmc', 9 if name == '1ze7' else 2, ('fused_sweep',),
              ('sem_move',)),
             ('sem-vmc', 1, ('sem_move',), ('fused_sweep',))]
    if name == '1ze7':
        cells.append(('dmc', 2, (), ('sem_move', 'fused_sweep')))
    for method, sub, needs, forbid in cells:
        def _run():
            return _run_cli(method, steps=1, blocks=1, subblocks=sub,
                            needs=('screened_mo',) + needs, seed=seed,
                            extra=flags, system=name, forbid=old + forbid,
                            reservoir=reservoir, built=(cfg, params))
        # sem-vmc: ~360 launches a move; reading a whole run's profile
        # took 14-34 s, so its [layer] row is one sweep after the run
        whole = measure and method != 'sem-vmc'
        launches = (_profiled_run(
            torch, f'{tag} {method} --n-det {CI_DETS} run ({sub} '
            f'{"generations" if method == "dmc" else "sweeps"})',
            n_e * sub, _run) if whole else _run())
        by = {'fused_sweep': dict(fsk.COUNTER.by),
              'sem_move': dict(suk.MOVE_COUNTER.by)}
        if measure and method == 'sem-vmc':
            prop = make_propagator('sem-vmc', cfg)
            gen = torch.Generator(device=dev)
            gen.manual_seed(5)
            _layer_line(torch, f'{tag} n_det={CI_DETS} sem-vmc sweep at '
                        f'W={WALKERS}', prop, params,
                        prop.init(params, gen, WALKERS, reservoir[0]), gen,
                        Population(), warmup=False)
        print(f'[paper systems ci] {tag} {method} --n-det {CI_DETS}: '
              f'launches by route and CI {by}')
        want = {'fused-vmc': ('fused_sweep', 'cluster ci'),
                'sem-vmc': ('sem_move', 'ci')}.get(method)
        if want and by[want[0]] != {want[1]: launches[want[0]]}:
            bad.append(f'{tag} {method}: {want[0]} launched as {by[want[0]]}'
                       f', not all {want[1]!r}')
        # the replay once after every chain, and only there
        if launches['fused_sweep_p_replay'] != (
                launches['fused_sweep'] if method == 'fused-vmc' else 0):
            bad.append(f'{tag} {method}: fused_sweep_p_replay launched '
                       f'{launches["fused_sweep_p_replay"]} times for '
                       f'{launches["fused_sweep"]} chains')
        runs[f'{name} {method} --n-det {CI_DETS}'] = launches
        _at(method)
    for n_det, steps in ((CI_DETS, 2 if name == '1ze7' else 1),) + (
            ((1, 1),) if name == '1amb' else ()):
        label = f'{name} opt-vmc --n-det {n_det}'

        def _opt():
            return _run_paper_opt(
                label, name, seed, reservoir, n_det=n_det, opt_steps=steps,
                built=(cfg, params) if n_det > 1 else (cfg1, params1))
        runs[label] = (_profiled_run(
            torch, f'{tag} opt-vmc P={3 + (n_det if n_det > 1 else 0)} run '
            f'({steps} SR step(s) of one generation)', n_e * steps, _opt)
            if measure else _opt())
        _at(f'opt-vmc --n-det {n_det}')
    torch.cuda.empty_cache()
    return bad


def phase_paper_systems_ci(torch, dev, seed: int, runs: dict,
                           measure: bool = False):
    """``[paper systems ci]``: 1ZE7 and 1AMB with ``--n-det 100`` (n_orb =
    792 and 1299: the virtual rows of ``build_bench_wavefunction``) and
    ``opt-vmc``, screened at eps = 1e-8, W = 256, resumed from the
    reservoir of finite cold-start walkers [paper systems] drew (drawn
    here the same way when the phase runs alone).  Per system: n_orb, K
    and the excitation rank; one evaluation, one O pass at P = 103 and one
    at P = 3, each with its predicted working set, its walker chunks and
    its measured peak, which must stay under ``eval_budget_bytes``, and
    the chunked O held against an unchunked call (``_paper_ci_memory``);
    screened_mo at the n_orb rows on one evaluation chunk
    (``_paper_product_times``); at 1ZE7 O on the card against the CPU
    path, its CPU side beside the card's work (``_paper_ci_o_check``);
    the fused-sweep tuner on CI operands and
    fused_sweep (the cluster route with CI and its replay) and sem_move
    with the system's expansion held per walker on synthetic blocks of its
    widths, then timed
    (``_paper_ci_kernels``); through ``qmc_run`` with ``--n-det 100``:
    fused-vmc (1ZE7 one block of 9 sweeps, past the refresh at 8; 1AMB 2),
    sem-vmc one sweep, dmc on 1ZE7 one block of 2 generations, opt-vmc P =
    103 (1ZE7 2 SR steps, 1AMB 1) and on 1AMB P = 3 (1 step), each
    checking its launch counters (screened_mo launched, sparse_mo and the
    first designs not; fused_sweep all on the cluster route with CI, each
    chain followed by one replay, sem_move all with CI).  With ``measure`` (the phase run alone:
    ``python3 chip_smoke.py paper-systems-ci``) each run also gives a
    ``[layer]`` row: profiled as a whole (``_profiled_run``), sem-vmc one
    sweep after its run; the full run leaves them out for its time limit.
    A DMC population that collapses is recorded, not failed."""
    t_phase = time.perf_counter()
    bad = []
    for name in PAPER_CI:
        t0 = time.perf_counter()
        bad += _paper_ci_system(torch, dev, name, seed, runs, measure)
        torch.cuda.empty_cache()
        print(f'[paper systems ci] {name}: {time.perf_counter() - t0:.1f} s')
    print(f'[paper systems ci] phase {time.perf_counter() - t_phase:.1f} s')
    if bad:
        _fail('[paper systems ci] ' + '; '.join(bad))


# the phases ``python3 chip_smoke.py <phase> ...`` runs alone after the
# build (a trial of new phases; with no arguments the script runs every
# phase, and only that run prints the result lines)
# (each takes torch, the device, the run seed, the runs dict, the pool of
# finite cold-start walkers of ``smallest`` with their energies, and the
# equilibrated state ``_equilibrated`` fills once)
ALONE = {'ci-rank': lambda t, d, s, r, pool, eq: phase_ci_rank(
             t, d, s, r, pool[0]),
         'paper-systems': lambda t, d, s, r, pool, eq: phase_paper_systems(
             t, d, s, r, pool[0]),
         'paper-systems-ci': lambda t, d, s, r, pool, eq:
             phase_paper_systems_ci(t, d, s, r, measure=True),
         'grid': lambda *a: phase_grid(*a),
         'sim': lambda t, d, s, r, pool, eq: phase_sim(t, d, s, r, eq),
         'examples': lambda t, d, s, r, pool, eq: phase_examples(t, d, r)}


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

    def _clock(label):
        print(f'[clock] {label}: {time.perf_counter() - t_start:.1f} s',
              flush=True)
    only = sys.argv[1:]
    unknown = set(only) - set(ALONE)
    if unknown:
        print(f'chip_smoke: unknown phases {sorted(unknown)} (these run '
              f'alone: {sorted(ALONE)})', file=sys.stderr)
        return 2
    phase_card_and_build()
    _clock('build')
    if only:
        # the named phases alone, after the build: a trial of new phases
        seed = _cold_start_seed(torch, dev)
        from repro_torch.systems import build_system
        cfg_s, params_s = build_system(SYSTEM, device=dev)
        pool = _finite_pool(torch, dev, cfg_s, params_s, tag=SYSTEM)
        runs, eq = {}, {}
        for name in only:
            ALONE[name](torch, dev, seed, runs, pool, eq)
            _clock(name)
        print(f'[done] {time.perf_counter() - t_start:.1f} s (phases '
              f'{", ".join(only)} alone; no result line)')
        return 0
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
    _clock('kernels against their plain versions, card vs cpu')
    # all-electron moves of 158 electrons: tau 0.3 (the method default)
    # accepts nothing at a cold start; 0.01 lets the walkers move
    # the first designs of the per-move kernels launch on no path
    old = ('sem_update', 'multidet_ratio')
    # (sem-vmc: 3 steps a sub-block, cut from 5 for the script's time
    # limit; 24 sweeps, past the sem_refresh boundary)
    runs = {
        'vmc': _run_cli('vmc', steps=3, blocks=2, needs=('sparse_mo',),
                        seed=seed, extra=('--tau', '0.01'), forbid=old),
        'sem-vmc': _run_cli('sem-vmc', steps=3, blocks=2,
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
    # fixed-node DMC (constant-population reconfiguration, E_T feedback
    # between blocks) at the reference's default E_T (-0.5 Ha/electron):
    # one evaluation a generation, so the MO product's kernel and no
    # per-move kernel; the b-strand resumed from the finite walkers
    per_move = old + ('sem_move', 'fused_sweep')
    runs['dmc'] = _run_cli('dmc', steps=3, blocks=2, needs=('sparse_mo',),
                           seed=seed, forbid=per_move)
    runs['dmc --n-det 100'] = _run_cli(
        'dmc', steps=3, blocks=2, needs=('sparse_mo',), seed=seed,
        extra=('--n-det', '100'), forbid=per_move)
    runs[f'{BSTRAND} dmc'] = _run_cli(
        'dmc', steps=2, blocks=2, needs=('screened_mo',), seed=seed,
        extra=screen, system=BSTRAND, forbid=('sparse_mo',) + per_move,
        reservoir=reservoir)
    _clock('qmc_run on smallest and b-strand')
    # one and two worker processes on the card, resumed from finite
    # cold-start walkers of smallest
    cfg_s, params_s = build_system(SYSTEM, device=dev)
    pool_s, pool_s_e = _finite_pool(torch, dev, cfg_s, params_s, tag=SYSTEM)
    phase_process_backend(seed, (pool_s.cpu().numpy(),
                                 pool_s_e.cpu().numpy()))
    _clock('process backend')
    phase_fused_vs_permove(torch, dev, seed)
    phase_fused_vs_permove(torch, dev, seed, n_det=100)
    phase_sem_drift(torch, dev, 'sem-vmc')
    phase_sem_drift(torch, dev, 'fused-vmc')
    _clock('fused vs per-move, drift')
    eq = phase_opt_vmc(torch, dev, seed, runs)
    R_eq = eq['R']
    _clock('opt-vmc')
    phase_grid(torch, dev, seed, runs, (pool_s, pool_s_e), eq)
    _clock('grid')
    phase_sim(torch, dev, seed, runs, eq)
    _clock('sim')
    phase_examples(torch, dev, runs)
    _clock('examples')
    phase_precision(torch, dev, seed, pool, R_eq, runs)
    _clock('precision')
    phase_serve(torch, seed, runs)
    _clock('serve')
    phase_shards(torch, dev, seed, runs, R_eq, (cfg_b, params_b, pool))
    _clock('shards')
    from repro_torch.runtime.samplers import worker_seed
    gen = torch.Generator(device=dev)
    gen.manual_seed(worker_seed(seed, 0))
    phase_spline(torch, dev, sample_positions(params_s, gen, WALKERS,
                                              cfg_s.n_elec))
    _clock('spline')
    phase_ci_rank(torch, dev, seed, runs, pool_s)
    _clock('ci rank')
    phase_paper_systems(torch, dev, seed, runs, pool_s)
    _clock('paper systems')
    phase_paper_systems_ci(torch, dev, seed, runs)
    _clock('paper systems ci')
    launches = {k: sum(r[k] for r in runs.values()) for k in _counters()}
    print(f'[launches] main path: ' + '; '.join(f'{m} {r}'
                                                for m, r in runs.items()))
    phase_layers(torch, dev, pool)
    _clock('layers')
    rows = phase_timing(torch, dev, rec, launches)
    _clock('kernel times')
    print(f'[done] {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
