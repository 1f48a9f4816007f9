"""Measured launch-parameter tuner for the fused-sweep CUDA kernel.

Port of ``repro.kernels.fused_sweep.autotune``.  The CUDA kernel runs one
thread block per walker (the TPU kernel's parameter was the walker tile
``tile_w``).  Its free launch parameter depends on the route the block's
size picks (``kernel.launch_shape``): threads per row of the inverse on
the rows route (``best_per_row``; 1 or 2, those of the counts that need
the fewest waves of blocks for W walkers on the card; where one is left it
is taken without measuring), blocks a walker on the cluster route
(``best_cluster``; the cluster sizes that hold the block, likewise),
threads per block on the shared and global routes (``best_threads``).
``best_launch`` gives the one the size needs; a CI block the rows route
cannot hold takes the cluster route at the cluster size tuned on CI
operands where that holds it (``best_ci_cluster``), else the shared or
global route at threads per block tuned on CI operands
(``best_ci_threads``).
The tuner measures each candidate on synthetic operands of the real
shape (single determinant, or with ``ci`` the CI table, ratios and
rank-k lists of the expansion's widths) and keeps the winner in the
reference's JSON cache:

    {"schema": 1, "tiles": {"158|256|fp32|cuda|per_row": 1,
                            "1056|256|fp32|cuda|cluster": 8,
                            "1056|256|fp32|cuda|cluster|ci792x100x2": 8,
                            "1900|256|fp32|cuda|ci1300x100x2": 256,
                            "1900|256|fp32|cuda": 256, ...}}

Threads per block are keyed on ``(n_e, W, dtype, 'cuda')``, as the first
design stored them; threads per row on the same fields and ``per_row``,
cluster sizes on them and ``cluster``, CI threads per block on them and
``ci<n_orb>x<n_det>x<k>``, CI cluster sizes on them, ``cluster`` and
``ci<n_orb>x<n_det>x<k>``: keys no entry of the first design can
answer.  The schema stays 1, so the
reference's own entries (other backends) in the same file are kept.

Cache location: ``$REPRO_FUSED_TILE_CACHE`` or
``~/.cache/repro/fused_sweep_tiles.json``.  A cache hit returns the stored
value without measuring (``build_count()`` counts measurements); a
corrupt, stale-schema or unreadable cache is re-measured and rewritten.
Writes are atomic (tmp + replace, the temp file named by process and
thread).  The value is also kept in the process, so the sweeps after the
first read no file; ``measured_times()`` holds the candidates' times of
this process's measurements.  A miss is measured under one process-wide
lock: samplers of the run service share a process and a card, so two
threads asking for one geometry get one measurement (the second waits for
it), and no two measurements time each other's load.

The kernel is given fp32 buffers at every storage precision
(``core.sem._to_compute``), so ``core.sem`` asks with ``dtype='fp32'``.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path

_SCHEMA = 1
_CANDIDATES = (64, 128, 256, 512)
# a CI block on the shared or global route updates its n_orb x n table
# every accepted move: at 1ze7's and 1amb's CI widths 64 threads a block
# took 2.8x the best count and 128 threads 1.55x and 1.58x, each timed
# after an untimed call (NVIDIA H100 80GB HBM3 at 700 W), so the tuner's
# first use there measures the two counts that can win
_CI_CANDIDATES = (256, 512)
PER_ROW_TAG = 'per_row'
CLUSTER_TAG = 'cluster'
_build_count = 0
_resolved: dict = {}      # (cache path, key) -> threads, this process
_times: dict = {}         # key -> {threads: seconds}, this process
_miss_lock = threading.Lock()   # one measurement at a time, per process


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
        tmp = path.with_suffix(
            f'.tmp{os.getpid()}.{threading.get_ident()}')
        tmp.write_text(json.dumps({'schema': _SCHEMA, 'tiles': tiles},
                                  indent=2) + '\n')
        os.replace(tmp, path)
    except OSError:
        pass                           # read-only cache dir: stay in memory


def _cuda_timer(fn, repeats: int = 5, warmup_s: float = 0.025,
                long_s: float = 0.1) -> float:
    """Least device time (s) of ``repeats`` calls, by CUDA events, after
    ``warmup_s`` seconds of calls (the build, and the card's clocks
    rising: without it the first candidate measured was the slowest).  A
    candidate whose first call takes longer than ``long_s`` (the global
    route at 1ze7's and 1amb's blocks: 0.26 to 2.5 s a launch, with CI
    0.5 to 3.6 s, NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py's "[tune]"
    lines) is timed by one call right after that first, untimed one (the
    build done and the clocks risen within it): three calls of each
    candidate made the tuner's first use with CI at 1amb cost 44.4 s
    there."""
    import time
    import torch
    t0 = time.perf_counter()
    fn()                                             # build
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > long_s:
        repeats, warmup_s = 1, 0.0
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


def _ci_tag(ci) -> str:
    """The cache-key tag of CI widths ``ci`` = (n_orb, n_det, k)."""
    return 'ci{}x{}x{}'.format(*ci)


def _ci_operands(n: int, ci, W: int, g, device):
    """Synthetic CI operands of one block of n electrons at the widths
    ``ci`` = (n_orb, n_det, k): a random table P (W, n_orb, n), ratios of
    one, and every excited determinant at rank k (holes among the n
    occupied, particles among the virtual orbitals; the reference's row
    the sentinels), coefficients decaying from the reference's."""
    import torch
    n_orb, n_det, k = ci
    holes = torch.arange(n, n + k, dtype=torch.int32).repeat(n_det, 1)
    parts = torch.arange(n_orb, n_orb + k, dtype=torch.int32).repeat(n_det, 1)
    cpu = torch.Generator().manual_seed(1)
    for i in range(1, n_det):
        holes[i] = torch.randperm(n, generator=cpu)[:k].sort().values
        parts[i] = n + torch.randperm(n_orb - n, generator=cpu)[:k].sort(
            ).values
    coeffs = 1.0 / (1.0 + torch.arange(n_det, dtype=torch.float32))
    P = torch.randn((W, n_orb, n), generator=g, device=device)
    ones = torch.ones((W, n_det), device=device)
    return (P, ones, ones.clone(), holes.to(device), parts.to(device),
            coeffs.to(device))


def _measure(n_e: int, W: int, candidates, timer=None, device='cuda',
             per_row: bool = False, cluster: bool = False,
             ci=None) -> int:
    """Time the fused kernel at each candidate on synthetic operands (n =
    ceil(n_e / 2), random fp32 state; single determinant, or with ``ci`` =
    (n_orb, n_det, k) the CI operands of ``_ci_operands``); the fastest
    wins.  Candidates are threads per block on the route the first design
    takes at this size (shared, else global), with ``per_row`` threads
    per row on the rows route, with ``cluster`` blocks a walker on the
    cluster route.  ``timer(fn) -> seconds`` is injectable (the CPU tests
    drive this with ``device='cpu'``, where the plain loop runs)."""
    import torch
    from . import kernel
    from .ops import fused_sweep_block

    timer = timer or _cuda_timer
    n_up = _block(n_e)
    card = (kernel.device_card(device) if torch.device(device).type == 'cuda'
            else kernel.H100)
    n_cols = n_up if ci is None else ci[0]
    route = ('rows' if per_row else 'cluster' if cluster
             else kernel.tables_route(n_up, n_cols, n_e,
                                      *(() if ci is None else
                                        (ci[0], ci[1], True)), card=card))
    name, tag = (('per_row', PER_ROW_TAG) if per_row else
                 ('cluster', CLUSTER_TAG if ci is None
                  else f'{CLUSTER_TAG}|{_ci_tag(ci)}') if cluster else
                 ('threads', None if ci is None else _ci_tag(ci)))
    g = torch.Generator(device=device).manual_seed(0)

    def _rand(*shape):
        return torch.randn(shape, generator=g, device=device)

    minv, phi = _rand(W, n_up, n_up), _rand(W, n_up, n_cols)
    ci_ops = None if ci is None else _ci_operands(n_up, ci, W, g, device)
    r = _rand(W, n_e, 3)
    r_prop = r[:, :n_up] + 0.1 * _rand(W, n_up, 3)
    en = 0.01 * _rand(W, n_up)
    logu = torch.log(torch.rand((W, n_up), generator=g, device=device)
                     .clamp(min=1e-6))
    b_ee = torch.ones((), device=device)

    best, best_t = None, float('inf')
    times = _times.setdefault(_cache_key(n_e, W, 'fp32', 'cuda', tag), {})
    for cand in candidates:
        launch = {name: cand}

        def _run(launch=launch):
            ops = None if ci_ops is None else (
                ci_ops[0].clone(), ci_ops[1].clone(), *ci_ops[2:])
            fused_sweep_block(minv.clone(), phi, r.clone(), r_prop, en, logu,
                              torch.ones(W, device=device),
                              torch.zeros(W, device=device), b_ee, ops,
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


def best_ci_threads(n_e: int, W: int, ci, dtype: str = 'fp32',
                    backend: str = 'cuda', path: Path | None = None,
                    measure=None) -> int:
    """Tuned threads per block (shared and global routes) of a CI block of
    ceil(n_e / 2) electrons at the widths ``ci`` = (n_orb, n_det, k),
    measured among ``_CI_CANDIDATES`` on CI operands of that shape
    (``_measure`` with ``ci``) and cached under the key with
    ``ci<n_orb>x<n_det>x<k>``; as ``best_threads`` otherwise.
    ``measure(n_e, W, candidates) -> int`` is injectable for tests."""
    ci = tuple(int(x) for x in ci)
    return _best(_cache_key(n_e, W, dtype, backend, _ci_tag(ci)), n_e, W,
                 _CI_CANDIDATES, path,
                 measure or (lambda *a: _measure(*a, ci=ci)))


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


def cluster_candidates(n_e: int, card=None) -> tuple:
    """Cluster sizes the cluster route can run at n = ceil(n_e / 2)
    (single determinant, ``kernel.cluster_shapes``), smallest first; empty
    when it cannot hold the block."""
    from . import kernel
    n = _block(n_e)
    return tuple(x.cluster for x in kernel.cluster_shapes(
        n, n, n_e, card=card or _card()))


def best_cluster(n_e: int, W: int, dtype: str = 'fp32',
                 backend: str = 'cuda', path: Path | None = None,
                 measure=None, card=None) -> int:
    """Tuned blocks a walker (cluster route) for a (n_e, W, dtype,
    backend) geometry, cached under the key with ``|cluster``; as
    ``best_per_row`` otherwise: where one size is left
    (``cluster_candidates``) it is returned without measuring or storing.
    Raises ``ValueError`` when the cluster route cannot hold the block."""
    candidates = cluster_candidates(n_e, card)
    if not candidates:
        raise ValueError(f'the cluster route cannot hold a block of '
                         f'{_block(n_e)} electrons')
    if len(candidates) == 1:
        return candidates[0]
    return _best(_cache_key(n_e, W, dtype, backend, CLUSTER_TAG), n_e, W,
                 candidates, path,
                 measure or (lambda *a: _measure(*a, cluster=True)))


def ci_cluster_candidates(n_e: int, ci, card=None) -> tuple:
    """Cluster sizes the cluster route can run with CI at n =
    ceil(n_e / 2) and the widths ``ci`` = (n_orb, n_det, k), any expansion
    of them (``kernel.cluster_shapes`` at ``kernel.ci_extent``'s most),
    smallest first; empty below ``kernel.CI_CLUSTER_FROM`` or where it
    cannot hold the block."""
    from . import kernel
    n, (n_orb, n_det, k) = _block(n_e), ci
    if n < kernel.CI_CLUSTER_FROM:
        return ()
    return tuple(x.cluster for x in kernel.cluster_shapes(
        n, n_orb, n_e, n_orb, n_det, True, card or _card(), k))


def best_ci_cluster(n_e: int, W: int, ci, dtype: str = 'fp32',
                    backend: str = 'cuda', path: Path | None = None,
                    measure=None, card=None) -> int:
    """Tuned blocks a walker of the cluster route with CI at the widths
    ``ci`` = (n_orb, n_det, k), measured on CI operands of that shape
    (``_measure`` with ``cluster`` and ``ci``: the chain and the replay)
    and cached under the key with ``|cluster|ci<n_orb>x<n_det>x<k>``; as
    ``best_cluster`` otherwise (one size left: taken without measuring).
    Raises ``ValueError`` when the route cannot hold the block."""
    ci = tuple(int(x) for x in ci)
    candidates = ci_cluster_candidates(n_e, ci, card)
    if not candidates:
        raise ValueError(f'the cluster route cannot hold a CI block of '
                         f'{_block(n_e)} electrons at {_ci_tag(ci)}')
    if len(candidates) == 1:
        return candidates[0]
    return _best(_cache_key(n_e, W, dtype, backend,
                            f'{CLUSTER_TAG}|{_ci_tag(ci)}'), n_e, W,
                 candidates, path,
                 measure or (lambda *a: _measure(*a, cluster=True, ci=ci)))


def best_launch(n_e: int, W: int, dtype: str = 'fp32',
                backend: str = 'cuda', path: Path | None = None,
                measure=None, card=None, ci=None) -> dict:
    """The tuned launch parameter of the route a block of ceil(n_e / 2)
    electrons takes: ``{'per_row': t}`` on the rows route, else
    ``{'cluster': c}`` on the cluster route, else ``{'threads': t}``;
    keyword arguments of ``ops.fused_sweep_block``.  With ``ci`` =
    (n_orb, n_det, k), the CI expansion's widths, a block the rows route
    cannot hold takes ``{'cluster': c}`` tuned on CI operands
    (``best_ci_cluster``) where the cluster route holds it, else
    ``{'threads': t}`` tuned on CI operands (``best_ci_threads``); one the
    rows route can hold, the threads per row tuned on single determinants.
    ``measure`` as the tuners take it; ``card`` (a ``kernel.Card``)
    defaults to the current CUDA device's."""
    if ci is not None:
        from . import kernel
        n, (n_orb, n_det, _) = _block(n_e), ci
        if not kernel.rows_shapes(n, n_orb, n_e, n_orb, n_det, True, W,
                                  card or _card()):
            if ci_cluster_candidates(n_e, ci, card):
                return {'cluster': best_ci_cluster(n_e, W, ci, dtype,
                                                   backend, path, measure,
                                                   card)}
            return {'threads': best_ci_threads(n_e, W, ci, dtype, backend,
                                               path, measure)}
    if per_row_candidates(n_e, W, card):
        return {'per_row': best_per_row(n_e, W, dtype, backend, path,
                                        measure, card)}
    if cluster_candidates(n_e, card):
        return {'cluster': best_cluster(n_e, W, dtype, backend, path,
                                        measure, card)}
    return {'threads': best_threads(n_e, W, dtype, backend, path, measure)}


def _best(key: str, n_e: int, W: int, candidates, path, measure) -> int:
    global _build_count
    path = Path(path) if path is not None else cache_path()
    known = _resolved.get((path, key))
    if known is not None:
        return known
    with _miss_lock:
        # a thread that waited here finds the value the first one measured
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


__all__ = ['best_ci_cluster', 'best_ci_threads', 'best_cluster',
           'best_launch', 'best_per_row', 'best_threads', 'build_count',
           'cache_path', 'ci_cluster_candidates', 'cluster_candidates',
           'measured_times', 'per_row_candidates']
