#!/usr/bin/env python3
"""Phase profile of the MO-product and fused-sweep kernels on one NVIDIA GPU.

    python3 chip_phases.py [fused-sweep]

Builds ``src/repro_torch/csrc/mo_tile_phases.cu`` (the kernels of
``sparse_mo.cu`` and ``screened_mo.cu`` with ``clock64()`` marks at the
phase boundaries of ``mo_tile.cuh``) and runs both at the main path's
inputs (``chip_smoke.py``'s: ``smallest`` at W = 256 unscreened, the
``b-strand`` at W = 256 and eps = 1e-8, seeded cold starts), sorted by
nearest atom and, for ``sparse_mo``, in the walker-major order.  Prints
the card, then per run the kernel time by CUDA events, the mean SM cycles
of each phase of a 32-electron tile's first window, and the windows per
tile.

Then builds ``csrc/fused_sweep_phases.cu`` (``fused_sweep.cu`` with
``clock64()`` marks per phase of a move) and runs the sweep through its
wrapper on well-conditioned synthetic spin blocks at W = 256: n = 79 and
n = 217 on the rows route (the size's choice) and on the first design's
shared and global routes, and the CI variant (n = 79, n_orb = 118,
n_det = 100) on the rows and shared routes; the rows route at every
thread count a row that it runs at W = 256; n = 528 and 866 on the
cluster route at every cluster size that holds them (each block of a
cluster counted: the pass's dots, pushes, the wait for the move's values
with the next move's pairs, the division and the update), and with CI
(the chain and its replay) at 1ZE7's and 1AMB's ``--n-det 100`` widths
(n_orb = n + n // 2, 100 determinants of rank 2), the held rows' g a
phase of its own.  Before the
instrumented build, the cluster route's uninstrumented times at those
sizes (every cluster size that holds the block, the clusters the card
holds at once) beside the global route's, and with CI, CUDA events.  Prints the mean
SM cycles a
move of each phase on thread 0's clock (the compiler may move loads across
a mark, so a phase's count is approximate and a move's total is not; a
move's cycles on one SM say nothing of how many blocks share it: the time
does) and the instrumented build's time.  ``fused-sweep`` runs the fused
sweep's part alone.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MARKS = 32
PHASES = ((1, 'compaction'), (2, 'window end'), (3, 'bitmap trim'),
          (4, 'union prefix'), (5, 'union ids and offsets'))
# fused_sweep_phases.cu: slot, name
FS_PHASES = 12
FS_NAMES = ((1, 'waiting for phi'), (9, 'the pass: dots'),
            (10, 'its e-e pairs'), (0, 'the rest'), (2, 'its barrier'),
            (8, 'the decision'), (5, 'the division and its barrier'),
            (4, 'CI determinants and their barrier'),
            (11, "CI: the held rows' g"), (3, 'the update'))


def _nvcc_lib(source: str, name: str):
    """``nvcc`` one source of csrc/ into build/; the loaded library."""
    sys.path.insert(0, str(ROOT / 'src'))
    from repro_torch.kernels import _build as b
    out = b.BUILD_DIR / name
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, '-o', str(out),
                        str(b.CSRC / source)], capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f'chip_phases: nvcc failed:\n{r.stdout}{r.stderr}')
    return ctypes.CDLL(str(out))


def _mo_lib():
    lib = _nvcc_lib('mo_tile_phases.cu', 'mo_tile_phases.so')
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sparse_mo_launch.argtypes = [vp, ll, vp, vp, vp, vp, i, i, ll, vp]
    lib.screened_mo_launch.argtypes = [vp, ll] + [vp] * 5 + [i, i, ll, i,
                                                             vp]
    lib.mo_tile_phases_read.argtypes = [vp, i]
    return lib


def _report(torch, lib, label, launch, n_tiles, n_stages):
    import numpy as np
    import chip_smoke as cs
    launch()
    torch.cuda.synchronize()
    n = min(n_tiles, 16384)
    buf = np.zeros(n * MARKS, np.int64)
    if lib.mo_tile_phases_read(buf.ctypes.data, n) != 0:
        raise SystemExit('chip_phases: reading the marks failed')
    m = buf.reshape(n, MARKS).astype(np.float64)
    prev, parts = m[:, 0], []
    for k, name in PHASES:
        parts.append(f'{name} {np.mean(m[:, k] - prev):.0f}')
        prev = m[:, k]
    for s in range(n_stages):
        w, c, o = 6 + 3 * s, 7 + 3 * s, 8 + 3 * s
        if w >= 30:
            break
        parts.append(f'stage {s}: wait {np.mean(m[:, w] - prev):.0f}, '
                     f'next copies {np.mean(m[:, c] - m[:, w]):.0f}, '
                     f'products and stores {np.mean(m[:, o] - m[:, c]):.0f}')
        prev = m[:, o]
    windows = m[:, 31]
    ms, _ = cs._time_ms(launch)
    print(f'[phases] {label}: {ms:.4f} ms; SM cycles of a tile\'s first '
          f'window (mean of {n} tiles): ' + '; '.join(parts)
          + f'; window total {np.mean(m[:, 30] - m[:, 0]):.0f}; windows per '
          f'tile: mean {np.mean(windows):.3f}, max {int(windows.max())}, '
          f'{int((windows > 1).sum())} tiles with more than one',
          flush=True)


def cluster_times(torch, dev) -> None:
    """The cluster route at n = 528 and 866 (synthetic blocks, W = 256) at
    every cluster size that holds the block, beside the global route (256
    threads a block): the least of 3 readings of ``chip_smoke._fused_times``
    (one launch after one, CUDA events, the state copy subtracted)."""
    from types import SimpleNamespace
    import chip_smoke as cs
    from repro_torch.kernels.fused_sweep import kernel as fsk
    W = cs.WALKERS
    ones = torch.ones((), device=dev)
    card = fsk.device_card(dev)
    for n in (528, 866):
        blk, (r, sign, logdet) = cs._synthetic_block(torch, dev, n, W, seed=n)
        kls = [dict(route='cluster', cluster=x.cluster) for x in
               fsk.cluster_shapes(n, n, 2 * n - 1, card=card)]
        for kl in kls + [dict(route='global', threads=256)]:
            reads = [cs._fused_times(torch, blk, SimpleNamespace(
                r=r, sign=sign, logdet=logdet), n, ones, iters=1, warmup=0,
                **kl) for _ in range(3)]
            ms, _, acc, _, shape = min(reads, key=lambda x: x[0])
            extra = (f', {fsk.cluster_active(shape, n, 2 * n - 1, dev)} '
                     f'clusters on the card at once'
                     if shape.route == 'cluster' else '')
            print(f'[times] fused_sweep synthetic n={n} W={W} {shape}: '
                  f'{ms:.4f} ms (the state copies not counted), accepted '
                  f'{float(acc.float().mean()):.3f}{extra}', flush=True)
    # with CI: the chain and the replay of P (their sum) at every cluster
    # size that holds the block, beside the global route
    for n, up, (r, sign, logdet), ci_ops in _ci_cluster_blocks(torch, dev):
        n_orb = ci_ops[0].shape[1]
        lists = ci_ops[2:]
        kls = [dict(route='cluster', cluster=x.cluster) for x in
               fsk.cluster_shapes(n, n_orb, 2 * n, n_orb, 100, True,
                                  card=card)]
        for kl in kls + [dict(route='global', threads=256)]:
            reads = [cs._fused_times(torch, up, SimpleNamespace(
                r=r, sign=sign, logdet=logdet), n, ones, lists, iters=1,
                warmup=0, **kl) for _ in range(3)]
            ms, _, acc, _, shape = min(reads, key=lambda x: x[0])
            print(f'[times] fused_sweep synthetic CI n={n} n_orb={n_orb} '
                  f'n_det=100 W={W} {shape.route} {shape.cluster or ""}: '
                  f'{ms:.4f} ms (chain and replay), accepted '
                  f'{float(acc.float().mean()):.3f}', flush=True)


def _ci_cluster_blocks(torch, dev):
    """The up blocks of synthetic spin blocks at 1ZE7's and 1AMB's
    ``--n-det 100`` widths (n = 528, 866; n_orb = n + n // 2; the seed-5
    expansion of ``systems.bench.synthetic_ci``, W = 256): [(n, block,
    state, ci_ops)], ci_ops the kernel's (P, rdet, r_other, holes, parts,
    coeffs)."""
    import chip_smoke as cs
    from repro_torch.systems.bench import synthetic_ci
    out = []
    for n in (528, 866):
        n_orb = n + n // 2
        cfg, (up, _), state = cs._synthetic_pair(
            torch, dev, n, n, cs.WALKERS, seed=n + 1,
            mdw=synthetic_ci(n, n, n_orb, 100, seed=5))
        ci_ops = (up['P'].contiguous(), up['rdet'].contiguous(),
                  up['r_other'].contiguous(), cfg.ci_t.holes_up_k,
                  cfg.ci_t.parts_up_k, cfg.ci_t.coeffs)
        out.append((n, up, state, ci_ops))
    return out


def fused_sweep_phases(torch, dev) -> None:
    """The fused sweep's phases per move (see the module's docstring)."""
    import numpy as np
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_sweep import kernel as fsk
    from repro_torch.kernels.fused_sweep.ops import fused_sweep_block
    lib = _nvcc_lib('fused_sweep_phases.cu', 'fused_sweep_phases.so')
    fsk._configure(lib)
    lib.fused_sweep_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    # the wrapper launches the instrumented build from here on
    _build._LIBS['fused_sweep'] = lib
    W = cs.WALKERS
    ones = torch.ones((), device=dev)

    def _run(label, blk, state, n_up, route, ci_ops=None, **kl):
        r, sign, logdet = state
        n = blk['minv'].shape[1]
        shape = fsk.launch_shape(n, blk['phi'].shape[-1], r.shape[1],
                                 *(() if ci_ops is None else (
                                     ci_ops[0].shape[1], ci_ops[1].shape[1],
                                     True)), route=route, walkers=W,
                                 card=fsk.device_card(dev), **kl)

        def _sweep():
            ci = None if ci_ops is None else (
                ci_ops[0].clone(), ci_ops[1].clone(), *ci_ops[2:])
            return fused_sweep_block(
                blk['minv'].contiguous().clone(), blk['phi'], r.clone(),
                blk['r_prop'],
                blk['en'], blk['logu'], sign.clone(), logdet.clone(), ones,
                ci, offset=blk['offset'], n_up=n_up, use_kernel=True,
                route=route, **kl)
        _sweep()
        torch.cuda.synchronize()
        acc = _sweep()[6]
        torch.cuda.synchronize()
        blocks = W * max(1, shape.cluster)
        buf = np.zeros(blocks * FS_PHASES, np.uint64)
        if lib.fused_sweep_phases_read(buf.ctypes.data, blocks) != 0:
            raise SystemExit('chip_phases: reading the marks failed')
        per_move = buf.reshape(blocks, FS_PHASES).astype(np.float64).mean(
            0) / n
        ms, _ = cs._time_ms(_sweep)
        move = per_move[[k for k, _ in FS_NAMES]].sum()
        parts = [f'{name} {per_move[k]:.0f}' for k, name in FS_NAMES
                 if k not in (4, 11) or ci_ops is not None]
        print(f'[phases] fused_sweep {label} n={n} W={W} {shape}: '
              f'{ms:.4f} ms (instrumented, the state copies included); '
              f'accepted {float(acc.float().mean()):.3f}; SM cycles a move '
              f'(mean of {blocks} blocks): ' + '; '.join(parts)
              + f'; a move in all {move:.0f}; loads before the first move '
              f'{per_move[6] * n:.0f}, stores after the last '
              f'{per_move[7] * n:.0f} (a sweep)', flush=True)

    def _counts(*sizes):
        """The threads-per-row counts the tuner chooses from at W walkers."""
        return [x.per_row for x in fsk.rows_shapes(
            *sizes, walkers=W, card=fsk.device_card(dev))]

    for n in (79, 217):
        blk, state = cs._synthetic_block(torch, dev, n, W, seed=n)
        for t in _counts(n, n, 2 * n - 1):
            _run('synthetic route rows', blk, state, n, 'rows', per_row=t)
        for route in ('shared', 'global'):
            _run(f'synthetic route {route}', blk, state, n, route,
                 threads=128 if n == 79 else 512)
    cfg_s, (up, _), state = cs._synthetic_ci_blocks(torch, dev, 79, 118, 100,
                                                    W, seed=103)
    from repro_torch.core.sem import _ci_lists
    holes, parts = _ci_lists(cfg_s, 'up', True)
    ci_ops = (up['P'].contiguous(), up['rdet'].contiguous(),
              up['r_other'].contiguous(), holes, parts, cfg_s.ci_t.coeffs)
    for t in _counts(79, 118, 158, 118, 100, True):
        _run('synthetic CI n_orb=118 n_det=100 route rows', up, state, 79,
             'rows', ci_ops, per_row=t)
    _run('synthetic CI n_orb=118 n_det=100 route shared', up, state, 79,
         'shared', ci_ops, threads=128)
    for n in (528, 866):
        blk, state = cs._synthetic_block(torch, dev, n, W, seed=n)
        for x in fsk.cluster_shapes(n, n, 2 * n - 1,
                                    card=fsk.device_card(dev)):
            if x.cluster >= 8:
                _run('synthetic route cluster', blk, state, n, 'cluster',
                     cluster=x.cluster)
    for n, up, state, ci_ops in _ci_cluster_blocks(torch, dev):
        n_orb = ci_ops[0].shape[1]
        for x in fsk.cluster_shapes(n, n_orb, 2 * n, n_orb, 100, True,
                                    card=fsk.device_card(dev)):
            _run(f'synthetic CI n_orb={n_orb} n_det=100 route cluster '
                 f'(the chain and the replay)', up, state, n, 'cluster',
                 ci_ops, cluster=x.cluster)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_phases: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True)
    print(out.stdout.strip())
    sys.path.insert(0, str(ROOT / 'src'))
    dev = torch.device('cuda')
    if sys.argv[1:] == ['fused-sweep']:
        cluster_times(torch, dev)
        fused_sweep_phases(torch, dev)
        return 0
    lib = _mo_lib()
    import chip_smoke as cs
    from repro_torch.core.vmc import sample_positions
    from repro_torch.kernels import mo_tile
    from repro_torch.systems import build_system

    def stream():
        return torch.cuda.current_stream().cuda_stream

    cfg, params, R, B, mask, key = cs._main_path_inputs(torch, dev)
    A = params.mo
    At = mo_tile.transposed(A)
    N, n_ao = mask.shape
    ld = At.shape[1]
    n_stages = mo_tile.stage_width(A.shape[0])[1]

    def sparse(order):
        C = torch.empty((N, ld, 5), device=dev)
        err = lib.sparse_mo_launch(At.data_ptr(), ld, B.data_ptr(),
                                   mask.data_ptr(), order.data_ptr(),
                                   C.data_ptr(), A.shape[0], n_ao, N,
                                   stream())
        if err:
            raise SystemExit(f'chip_phases: sparse_mo launch error {err}')

    for label, order in (
            ('sorted', mo_tile.electron_order(key, N)),
            ('walker-major', torch.arange(N, dtype=torch.int32, device=dev))):
        _report(torch, lib, f'sparse_mo {cs.SYSTEM} W={cs.WALKERS} {label}',
                lambda: sparse(order), -(-N // mo_tile.TE), n_stages)

    cfg_b, params_b = build_system(cs.BSTRAND, screen_eps=cs.SCREEN_EPS,
                                   device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    Rb = sample_positions(params_b, gen, cs.WALKERS, cfg_b.n_elec)
    _, _, (Ab, Bp, idx, act, _, keyb) = cs._screened_inputs(
        torch, dev, Rb, cs.SCREEN_EPS)
    Atb = mo_tile.transposed(Ab)
    Nb, K = idx.shape
    idx32 = idx.to(torch.int32)
    ob = mo_tile.electron_order(keyb, Nb)

    def screened():
        C = torch.empty((Nb, Atb.shape[1], 5), device=dev)
        err = lib.screened_mo_launch(
            Atb.data_ptr(), Atb.shape[1], Bp.data_ptr(), idx32.data_ptr(),
            act.data_ptr(), ob.data_ptr(), C.data_ptr(), Ab.shape[0],
            Ab.shape[1], Nb, K, stream())
        if err:
            raise SystemExit(f'chip_phases: screened_mo launch error {err}')

    _report(torch, lib, f'screened_mo {cs.BSTRAND} W={cs.WALKERS} '
            f'eps={cs.SCREEN_EPS:g} sorted', screened, -(-Nb // mo_tile.TE),
            mo_tile.stage_width(Ab.shape[0])[1])
    cluster_times(torch, dev)
    fused_sweep_phases(torch, dev)
    return 0


if __name__ == '__main__':
    sys.exit(main())
