#!/usr/bin/env python3
"""Phase profile of the two MO-product kernels on one NVIDIA GPU.

    python3 chip_phases.py

Builds ``src/repro_torch/csrc/mo_tile_phases.cu`` (the kernels of
``sparse_mo.cu`` and ``screened_mo.cu`` with ``clock64()`` marks at the
phase boundaries of ``mo_tile.cuh``) and runs both at the main path's
inputs (``chip_smoke.py``'s: ``smallest`` at W = 256 unscreened, the
``b-strand`` at W = 256 and eps = 1e-8, seeded cold starts), sorted by
nearest atom and, for ``sparse_mo``, in the walker-major order.  Prints
the card, then per run the kernel time by CUDA events, the mean SM cycles
of each phase of a 32-electron tile's first window, and the windows per
tile.  Imports nothing of JAX.
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


def _build(torch):
    sys.path.insert(0, str(ROOT / 'src'))
    from repro_torch.kernels import _build as b
    out = b.BUILD_DIR / 'mo_tile_phases.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, '-o', str(out),
                        str(b.CSRC / 'mo_tile_phases.cu')],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f'chip_phases: nvcc failed:\n{r.stdout}{r.stderr}')
    lib = ctypes.CDLL(str(out))
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
    lib = _build(torch)
    import chip_smoke as cs
    from repro_torch.core.vmc import sample_positions
    from repro_torch.kernels import mo_tile
    from repro_torch.systems import build_system
    dev = torch.device('cuda')

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
    return 0


if __name__ == '__main__':
    sys.exit(main())
