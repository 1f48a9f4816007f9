"""Atomic npz snapshots of nested dicts of arrays (the synchronous-loop
checkpoint).

Port of ``repro.train.checkpoint`` without ``jax.tree_util``: a tree is a
dict, list or tuple of such trees or a leaf (an array or a number), and a
leaf's key is its path joined by '/' (dict keys, sequence indices), the
keys the reference writes.  So a checkpoint either package writes, the
other reads.  The outer wavefunction-optimization loop
(``repro_torch.optimize``) is synchronous, so its fault tolerance =
periodic atomic snapshots + restart (plus the CRC run-key guard shared
with the QMC side).  Writes are atomic (tmp + rename) so a mid-write crash
never corrupts the latest good checkpoint; ``latest_step`` scans the
directory on restart.
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np


def _leaves(tree, path=()):
    """(key, leaf) pairs of a tree, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, (*path, str(i)))
    else:
        yield '/'.join(path), tree


def _rebuild(tree, leaves):
    """A tree of ``tree``'s structure with its leaves drawn in order from
    the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, leaves) for sub in tree)
    return next(leaves)


def save_checkpoint(ckpt_dir: str | Path, step: int, tree,
                    run_key: str = '') -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = {key: np.asarray(leaf) for key, leaf in _leaves(tree)}
    flat['__step__'] = np.asarray(step)
    flat['__run_key__'] = np.frombuffer(
        run_key.encode() or b'\0', dtype=np.uint8)
    tmp = ckpt_dir / f'.tmp_step_{step:08d}.npz'
    final = ckpt_dir / f'step_{step:08d}.npz'
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, final)                     # atomic
    return final


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(m.group(1)) for f in ckpt_dir.iterdir()
             if (m := re.match(r'step_(\d+)\.npz$', f.name))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str | Path, tree_like, step: int = -1,
                       run_key: str = ''):
    """Restore into the structure of `tree_like`. Returns (tree, step)."""
    ckpt_dir = Path(ckpt_dir)
    if step < 0:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f'no checkpoints in {ckpt_dir}')
    data = np.load(ckpt_dir / f'step_{step:08d}.npz')
    if run_key:
        stored = bytes(data['__run_key__']).rstrip(b'\0').decode()
        if stored and stored != run_key:
            raise ValueError(f'checkpoint run_key {stored!r} != {run_key!r}'
                             ' — refusing to mix simulations (paper §V.C)')
    leaves = []
    for key, leaf in _leaves(tree_like):
        arr = data[key]
        leaves.append(arr.astype(leaf.dtype) if hasattr(leaf, 'dtype')
                      else arr)
    return _rebuild(tree_like, iter(leaves)), int(step)
