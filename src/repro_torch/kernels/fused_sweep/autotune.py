"""Measured launch-parameter tuner for the fused-sweep CUDA kernel.

Port of ``repro.kernels.fused_sweep.autotune``.  The CUDA kernel runs one
thread block per walker (the TPU kernel's parameter was the walker tile
``tile_w``).  Its free launch parameter depends on the route the block's
size picks (``kernel.launch_shape``): threads per row of the inverse on
the rows route (``best_per_row``; 1 or 2, those of the counts that need
the fewest waves of blocks for W walkers on the card; where one is left it
is taken without measuring), threads per block on the shared and global
routes (``best_threads``).  ``best_launch`` gives the one the size needs.
The tuner measures each candidate on synthetic
single-determinant operands of the real shape and keeps the winner in the
reference's JSON cache:

    {"schema": 1, "tiles": {"158|256|fp32|cuda|per_row": 1,
                            "1732|256|fp32|cuda": 256, ...}}

Threads per block are keyed on ``(n_e, W, dtype, 'cuda')``, as the first
design stored them; threads per row on the same fields and ``per_row``,
a key no entry of the first design can answer.  The schema stays 1, so the
reference's own entries (other backends) in the same file are kept.

Cache location: ``$REPRO_FUSED_TILE_CACHE`` or
``~/.cache/repro/fused_sweep_tiles.json``.  A cache hit returns the stored
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
PER_ROW_TAG = 'per_row'
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


def _cache_key(n_e: int, W: int, dtype: str, backend: str,
               tag: str | None = None) -> str:
    key = f'{n_e}|{W}|{dtype}|{backend}'
    return key if tag is None else f'{key}|{tag}'


def _block(n_e: int) -> int:
    """The larger spin block of n_e electrons (the tuner's synthetic n)."""
    return (n_e + 1) // 2


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


def _cuda_timer(fn, repeats: int = 5, warmup_s: float = 0.025) -> float:
    """Least device time (s) of ``repeats`` calls, by CUDA events, after
    ``warmup_s`` seconds of calls (the build, and the card's clocks
    rising: without it the first candidate measured was the slowest)."""
    import time

    import torch
    fn()                                             # build
    torch.cuda.synchronize()
    until = time.perf_counter() + warmup_s
    while time.perf_counter() < until:
        fn()
        torch.cuda.synchronize()
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


def _measure(n_e: int, W: int, candidates, timer=None, device='cuda',
             per_row: bool = False) -> int:
    """Time the fused kernel at each candidate on synthetic
    single-determinant operands (n = ceil(n_e / 2), random fp32 state);
    the fastest wins.  Candidates are threads per block on the route the
    first design takes at this size (shared, else global), or with
    ``per_row`` threads per row on the rows route.  ``timer(fn) ->
    seconds`` is injectable (the CPU tests drive this with
    ``device='cpu'``, where the plain loop runs)."""
    import torch
    from . import kernel
    from .ops import fused_sweep_block

    timer = timer or _cuda_timer
    n_up = _block(n_e)
    card = (kernel.device_card(device) if torch.device(device).type == 'cuda'
            else kernel.H100)
    route = 'rows' if per_row else kernel.tables_route(n_up, n_up, n_e,
                                                       card=card)
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
    times = _times.setdefault(_cache_key(
        n_e, W, 'fp32', 'cuda', PER_ROW_TAG if per_row else None), {})
    for cand in candidates:
        launch = (dict(per_row=cand) if per_row
                  else dict(threads=cand))

        def _run(launch=launch):
            fused_sweep_block(minv.clone(), phi, r.clone(), r_prop, en, logu,
                              torch.ones(W, device=device),
                              torch.zeros(W, device=device), b_ee,
                              offset=0, n_up=n_up, use_kernel=True,
                              route=route, **launch)
        t = timer(_run)
        times[int(cand)] = float(t)
        if t < best_t:
            best, best_t = cand, t
    return int(best)


def best_threads(n_e: int, W: int, dtype: str = 'fp32',
                 backend: str = 'cuda', path: Path | None = None,
                 measure=None) -> int:
    """Tuned threads per block (shared and global routes) for a (n_e, W,
    dtype, backend) geometry.

    Cache hit: the stored value, no measurement.  Miss (or a corrupt or
    stale cache): measures the candidates, stores, returns the winner.
    Either way the value is kept for the rest of the process.
    ``measure(n_e, W, candidates) -> int`` is injectable for tests.
    """
    return _best(_cache_key(n_e, W, dtype, backend), n_e, W, _CANDIDATES,
                 path, measure or _measure)


def _card():
    """The chooser's view of the card the tuner measures on (the H100's
    defaults where there is no CUDA device, as in the CPU tests)."""
    import torch
    from . import kernel
    return kernel.device_card('cuda') if torch.cuda.is_available() \
        else kernel.H100


def per_row_candidates(n_e: int, W: int = 0, card=None) -> tuple:
    """Threads per row the rows route can run at n = ceil(n_e / 2) (single
    determinant), with ``W`` only those that need the fewest waves of
    blocks on ``card`` (``kernel.rows_shapes``); empty when it cannot
    hold the block."""
    from . import kernel
    n = _block(n_e)
    return tuple(sorted(x.per_row for x in kernel.rows_shapes(
        n, n, n_e, walkers=W, card=card or _card())))


def best_per_row(n_e: int, W: int, dtype: str = 'fp32',
                 backend: str = 'cuda', path: Path | None = None,
                 measure=None, card=None) -> int:
    """Tuned threads per row (rows route) for a (n_e, W, dtype, backend)
    geometry, cached under the key with ``|per_row``; as
    ``best_threads`` otherwise.  Where one count is left
    (``per_row_candidates``) it is returned without measuring or storing.
    Raises ``ValueError`` when the rows route cannot hold the block."""
    candidates = per_row_candidates(n_e, W, card)
    if not candidates:
        raise ValueError(f'the rows route cannot hold a block of '
                         f'{_block(n_e)} electrons')
    if len(candidates) == 1:
        return candidates[0]
    return _best(_cache_key(n_e, W, dtype, backend, PER_ROW_TAG), n_e, W,
                 candidates, path,
                 measure or (lambda *a: _measure(*a, per_row=True)))


def best_launch(n_e: int, W: int, dtype: str = 'fp32',
                backend: str = 'cuda', path: Path | None = None,
                measure=None, card=None) -> dict:
    """The tuned launch parameter of the route a single-determinant block
    of ceil(n_e / 2) electrons takes: ``{'per_row': t}`` on the rows
    route, else ``{'threads': t}``; keyword arguments of
    ``ops.fused_sweep_block``.  ``measure`` as the two tuners take it;
    ``card`` (a ``kernel.Card``) defaults to the current CUDA device's."""
    if per_row_candidates(n_e, W, card):
        return {'per_row': best_per_row(n_e, W, dtype, backend, path,
                                        measure, card)}
    return {'threads': best_threads(n_e, W, dtype, backend, path, measure)}


def _best(key: str, n_e: int, W: int, candidates, path, measure) -> int:
    global _build_count
    path = Path(path) if path is not None else cache_path()
    known = _resolved.get((path, key))
    if known is not None:
        return known
    tiles = _load_tiles(path)
    stored = tiles.get(key)
    if isinstance(stored, int) and stored > 0:
        _resolved[(path, key)] = stored
        return stored
    _build_count += 1
    best = int(measure(n_e, W, candidates))
    tiles[key] = best
    _store_tiles(path, tiles)
    _resolved[(path, key)] = best
    return best


__all__ = ['best_launch', 'best_per_row', 'best_threads', 'build_count',
           'cache_path', 'measured_times', 'per_row_candidates']
