#!/usr/bin/env python3
"""The per-move kernels of two checkouts, bitwise, on one NVIDIA GPU.

    python3 chip_bitwise.py OTHER_CHECKOUT

Runs the same seeded cases through the CUDA kernels of this checkout's
``src/repro_torch`` and of ``OTHER_CHECKOUT/src/repro_torch`` (each in a
process of its own, each building its kernels into its own ``build/``),
and fails unless every output is bitwise equal.  The cases are what a
change to ``csrc/ci_ratio.cuh``, ``csrc/sem_move.cu`` or
``csrc/fused_sweep.cu`` must leave as it was: ``fused_sweep`` on its rows,
shared and global routes and ``sem_move`` driving a whole up-block sweep
move by move, at n = 79 single determinant and with CI expansions over
n_orb = 118 orbitals (``multidet.from_excitations``, 50 determinants) at
excitation ranks 2, 3, 5 and 8, W = 64.  The inputs are made on the CPU
from a seed (well-conditioned blocks: Minv the inverse of I + 0.1 G /
sqrt(n), the proposals' phi the electron's own column plus noise, P and
the determinant ratios built from them), so both checkouts get the same
bits.  Prints the card, then per case and output the largest difference.
Then times the fused sweep's rows route (one and two threads a row) and
its shared route on the single-determinant case at W = 256 for the two
checkouts in turns (other, this, this, other; each in a process of its
own): the least of 5 readings of 20 launches, CUDA events, the state
copies included.  Imports nothing of JAX.
"""
from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, N_ORB, N_DET, W = 79, 118, 50, 64
RANKS = (2, 3, 5, 8)


def _expansion(k: int, seed: int):
    """Excitations of 1..k electrons of the up block, one of exactly k."""
    import numpy as np
    from repro_torch.core.multidet import from_excitations
    rng = np.random.default_rng(seed)
    exc, seen = [], set()
    while len(exc) < N_DET - 1:
        deg = int(rng.integers(1, k + 1))
        h = sorted(rng.choice(N, deg, replace=False).tolist())
        p = sorted((N + rng.choice(N_ORB - N, deg, replace=False)).tolist())
        if repr((h, p)) not in seen:
            seen.add(repr((h, p)))
            exc.append(((h, p), ([], [])))
    exc[0] = ((list(range(k)), list(range(N, N + k))), ([], []))
    coeffs = np.concatenate([[1.0], 0.2 * rng.choice([-1.0, 1.0],
                                                      N_DET - 1)])
    return from_excitations(coeffs, exc, N, N, N_ORB)


def _case(torch, dev, seed: int, k: int = 0, W: int = W):
    """One up block's inputs on ``dev`` (CI at rank k when k > 0), W
    walkers."""
    from repro_torch.core import multidet
    g = torch.Generator().manual_seed(seed)

    def _n(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)
    D = torch.eye(N, dtype=torch.float64) + 0.1 * _n(W, N, N) / math.sqrt(N)
    minv = torch.linalg.inv(D)
    phi = D.transpose(1, 2) + 0.3 * _n(W, N, N) / math.sqrt(N)
    r = 2.0 * _n(W, 2 * N, 3)
    blk = dict(minv=minv, phi=phi, r=r, r_prop=r[:, :N] + 0.3 * _n(W, N, 3),
               en=0.05 * _n(W, N),
               logu=torch.log(torch.rand((W, N), generator=g,
                                         dtype=torch.float64)
                              .clamp(min=1e-6)),
               sign=torch.ones(W, dtype=torch.float64),
               logdet=torch.zeros(W, dtype=torch.float64))
    if k:
        ci_t = multidet.pin(_expansion(k, seed), N, N, 'cpu')
        V = 0.3 * _n(W, N_ORB - N, N)
        blk['phi'] = torch.cat([phi, V.transpose(1, 2)
                                + 0.1 * _n(W, N, N_ORB - N)], dim=-1)
        P = multidet.reference_table(torch.cat([D, V], dim=1).float(),
                                     minv.float())
        blk['P'] = P.double()
        blk['rdet'] = multidet.det_ratios(P, ci_t.holes_up,
                                          ci_t.parts_up).double()
        blk['r_other'] = 1.0 + 0.1 * _n(W, N_DET)
        blk['lists'] = (ci_t.holes_up_k, ci_t.parts_up_k, ci_t.coeffs)
    return {key: (v.float().contiguous().to(dev) if torch.is_tensor(v)
                  else tuple(x.to(dev) for x in v))
            for key, v in blk.items()}


def _fused(torch, blk, route: str):
    from repro_torch.kernels.fused_sweep.ops import fused_sweep_block
    ci = None
    if 'P' in blk:
        ci = (blk['P'].clone(), blk['rdet'].clone(), blk['r_other'],
              *blk['lists'])
    out = fused_sweep_block(
        blk['minv'].clone(), blk['phi'], blk['r'].clone(), blk['r_prop'],
        blk['en'], blk['logu'], blk['sign'].clone(), blk['logdet'].clone(),
        torch.ones((), device=blk['r'].device), ci, offset=0, n_up=N,
        use_kernel=True, route=route)
    return [x for x in out if x is not None]


def _moves(torch, blk):
    from repro_torch.kernels.fused_sweep.ref import _ee_sum
    from repro_torch.kernels.sem_update.ops import sem_move
    dev = blk['r'].device
    bee = torch.ones((), device=dev)
    st = (blk['r'].clone(), blk['minv'].clone(), blk['sign'].clone(),
          blk['logdet'].clone(), None, None)
    ci = None
    if 'P' in blk:
        st = st[:4] + (blk['P'].clone(), blk['rdet'].clone())
        ci = (blk['r_other'], *blk['lists'])
    acc = torch.empty((N, W), dtype=torch.bool, device=dev)
    mar = torch.empty((N, W), device=dev)
    for e in range(N):
        cur, rp = st[0], blk['r_prop'][:, e].contiguous()
        d_jas = (_ee_sum(cur, e, rp, N, bee) - _ee_sum(cur, e, cur[:, e], N,
                                                       bee)
                 + blk['en'][:, e]).contiguous()
        st = sem_move(st, blk['phi'][:, e], rp, d_jas, blk['logu'][:, e], e,
                      e, acc, mar, ci)
    return [x for x in st if x is not None] + [acc, mar]


def dump(src: str, out: str) -> None:
    """Run every case through the kernels of the package under ``src``
    and save the outputs to ``out``."""
    sys.path.insert(0, src)
    import torch
    dev = torch.device('cuda')
    res = {}
    for k in (0,) + RANKS:
        blk = _case(torch, dev, seed=100 + k, k=k)
        tag = f'rank {k}' if k else 'single determinant'
        for route in ('rows', 'shared', 'global'):
            res[f'fused_sweep {route} {tag}'] = _fused(torch, blk, route)
        res[f'sem_move {tag}'] = _moves(torch, blk)
    torch.cuda.synchronize()
    torch.save({key: [x.cpu() for x in v] for key, v in res.items()}, out)


def timing(src: str) -> None:
    """Print the fused sweep's times on the single-determinant case at
    W = 256 through the package under ``src``."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels.fused_sweep.ops import fused_sweep_block
    dev = torch.device('cuda')
    blk = _case(torch, dev, seed=100, W=256)
    bufs = [blk[k].clone() for k in ('minv', 'r', 'sign', 'logdet')]
    ones = torch.ones((), device=dev)
    parts = []
    for route, launch in (('rows', dict(per_row=1)),
                          ('rows', dict(per_row=2)), ('shared', {})):
        def run():
            for b, key in zip(bufs, ('minv', 'r', 'sign', 'logdet')):
                b.copy_(blk[key])
            fused_sweep_block(*bufs[:1], blk['phi'], bufs[1], blk['r_prop'],
                              blk['en'], blk['logu'], bufs[2], bufs[3], ones,
                              offset=0, n_up=N, use_kernel=True, route=route,
                              **launch)
        reads = []
        for _ in range(6):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                run()
            e1.record()
            torch.cuda.synchronize()
            reads.append(e0.elapsed_time(e1) / 20)
        parts.append(f'{route} {launch or ""} {min(reads[1:]):.4f} ms')
    print(f'[time] fused_sweep n={N} W=256 through {src}: '
          + '; '.join(parts), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == '--dump':
        dump(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == '--time':
        timing(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print('chip_bitwise: no CUDA device', file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    outs = {}
    for label, tree in (('this checkout', ROOT), ('other', other)):
        path = ROOT / 'build' / f'chip_bitwise_{len(outs)}.pt'
        path.parent.mkdir(parents=True, exist_ok=True)
        # this file's cases, the tree's package and its own build/
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        '--dump', str(tree / 'src'), str(path)], check=True,
                       cwd=tree)
        outs[label] = torch.load(path)
    a, b = outs.values()
    same = True
    for key in a:
        diffs = [float((x.double() - y.double()).abs().max())
                 if x.is_floating_point() else float((x != y).sum())
                 for x, y in zip(a[key], b[key])]
        eq = all(torch.equal(x, y) for x, y in zip(a[key], b[key]))
        same &= eq
        print(f'[bitwise] {key}: equal {eq}; largest difference per output '
              f'{diffs}')
    print(f'[bitwise] {len(a)} cases against {other}: '
          + ('all bitwise equal' if same else 'NOT EQUAL'))
    for tree in (other, ROOT, ROOT, other):
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        '--time', str(tree / 'src')], check=True, cwd=tree)
    return 0 if same else 1


if __name__ == '__main__':
    sys.exit(main())
