"""Measured launch-parameter tuner for the fused-sweep CUDA kernel.

Port of ``repro.kernels.fused_sweep.autotune``.  The CUDA kernel runs one
thread block per walker; its free launch parameter is the number of
threads per block (the TPU kernel's was the walker tile ``tile_w``).  The
tuner measures each candidate on synthetic operands of the real shape and
keeps the winner in the reference's JSON cache, keyed on
``(n_e, W, dtype, 'cuda')``:

    {"schema": 1, "tiles": {"158|256|fp32|cuda": 128, ...}}

Cache location: ``$REPRO_FUSED_TILE_CACHE`` or
``~/.cache/repro/fused_sweep_tiles.json`` (the reference's file; its own
entries, under other backends, are kept).  A cache hit returns the stored
value without measuring (``build_count()`` counts measurements); a
corrupt, stale-schema or unreadable cache is re-measured and rewritten.
Writes are atomic (tmp + replace).  The value is also kept in the process,
so the sweeps after the first read no file; ``measured_times()`` holds the
candidates' times of this process's measurements.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

_SCHEMA = 1
_CANDIDATES = (64, 128, 256, 512)
_build_count = 0
_resolved: dict = {}      # (cache path, key) -> threads, this process
_times: dict = {}         # key -> {threads: seconds}, this process


def measured_times() -> dict:
    """{cache key: {threads: seconds}} of the measurements this process
    made (a geometry served from the cache has no entry)."""
    return {k: dict(v) for k, v in _times.items()}


def build_count() -> int:
    """Number of measurement runs (cache misses) this process performed."""
    return _build_count


def cache_path() -> Path:
    """Resolved cache location (``REPRO_FUSED_TILE_CACHE`` overrides)."""
    env = os.environ.get('REPRO_FUSED_TILE_CACHE')
    if env:
        return Path(env)
    return Path.home() / '.cache' / 'repro' / 'fused_sweep_tiles.json'


def _cache_key(n_e: int, W: int, dtype: str, backend: str) -> str:
    return f'{n_e}|{W}|{dtype}|{backend}'


def _load_tiles(path: Path) -> dict:
    """Stored table, or {} on any corruption or stale schema."""
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get('schema') != _SCHEMA:
        return {}
    tiles = doc.get('tiles')
    return tiles if isinstance(tiles, dict) else {}


def _store_tiles(path: Path, tiles: dict) -> None:
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f'.tmp{os.getpid()}')
        tmp.write_text(json.dumps({'schema': _SCHEMA, 'tiles': tiles},
                                  indent=2) + '\n')
        os.replace(tmp, path)
    except OSError:
        pass                           # read-only cache dir: stay in memory


def _cuda_timer(fn, repeats: int = 3) -> float:
    """Least device time (s) of ``repeats`` calls, by CUDA events."""
    import torch
    fn()                                             # build / warm-up
    best = float('inf')
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / 1e3)
    return best


def _measure(n_e: int, W: int, candidates, timer=None,
             device='cuda') -> int:
    """Time the fused kernel at each candidate thread count on synthetic
    single-determinant operands (n = ceil(n_e / 2), random fp32 state);
    the fastest wins.  ``timer(fn) -> seconds`` is injectable (the CPU
    tests drive this with ``device='cpu'``, where the plain loop runs)."""
    import torch
    from .ops import fused_sweep_block

    timer = timer or _cuda_timer
    n_up = (n_e + 1) // 2
    g = torch.Generator(device=device).manual_seed(0)

    def _rand(*shape):
        return torch.randn(shape, generator=g, device=device)

    minv, phi = _rand(W, n_up, n_up), _rand(W, n_up, n_up)
    r = _rand(W, n_e, 3)
    r_prop = r[:, :n_up] + 0.1 * _rand(W, n_up, 3)
    en = 0.01 * _rand(W, n_up)
    logu = torch.log(torch.rand((W, n_up), generator=g, device=device)
                     .clamp(min=1e-6))
    b_ee = torch.ones((), device=device)

    best, best_t = None, float('inf')
    times = _times.setdefault(_cache_key(n_e, W, 'fp32', 'cuda'), {})
    for threads in candidates:
        def _run(threads=threads):
            fused_sweep_block(minv.clone(), phi, r.clone(), r_prop, en, logu,
                              torch.ones(W, device=device),
                              torch.zeros(W, device=device), b_ee,
                              offset=0, n_up=n_up, use_kernel=True,
                              threads=threads)
        t = timer(_run)
        times[int(threads)] = float(t)
        if t < best_t:
            best, best_t = threads, t
    return int(best)


def best_threads(n_e: int, W: int, dtype: str = 'fp32',
                 backend: str = 'cuda', path: Path | None = None,
                 measure=None) -> int:
    """Tuned threads per block for a (n_e, W, dtype, backend) geometry.

    Cache hit: the stored value, no measurement.  Miss (or a corrupt or
    stale cache): measures the candidates, stores, returns the winner.
    Either way the value is kept for the rest of the process.
    ``measure(n_e, W, candidates) -> int`` is injectable for tests.
    """
    global _build_count
    path = Path(path) if path is not None else cache_path()
    key = _cache_key(n_e, W, dtype, backend)
    known = _resolved.get((path, key))
    if known is not None:
        return known
    tiles = _load_tiles(path)
    stored = tiles.get(key)
    if isinstance(stored, int) and stored > 0:
        _resolved[(path, key)] = stored
        return stored
    _build_count += 1
    best = int((measure or _measure)(n_e, W, _CANDIDATES))
    tiles[key] = best
    _store_tiles(path, tiles)
    _resolved[(path, key)] = best
    return best


__all__ = ['best_threads', 'build_count', 'cache_path', 'measured_times']
