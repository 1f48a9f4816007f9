"""Propagator/Driver API: one block loop for every QMC method.

Port of ``repro.core.driver``:

* a ``Propagator`` supplies the physics (``init`` / ``draw`` /
  ``propagate`` / ``block_stats``, optional ``feedback``);
* ``EnsembleDriver`` owns the block loop — a plain host loop over
  ``steps`` generations (the reference's jit'd ``lax.scan``).  Per-step
  outputs stay on the device; the block reduces them once, so a block
  costs one device-to-host sync, not one per step.  With ``devices`` it
  shards the walker axis (the reference's ``shard_map`` over a 1-D
  ``walkers`` mesh): one thread per shard, each holding its slice of the
  walkers on its own device, the ``Population`` collectives meeting at a
  barrier;
* ``BlockStats`` is the block contract (weight + weighted means, host
  floats), merged by ``runtime.blocks.BlockAccumulator``.

RNG: propagators draw from an explicit ``torch.Generator`` on the walkers'
device, through their ``draw(gen, state)`` — one generation's draws for
the whole population.  Every ``propagate`` also takes optional injected
``draws`` (a test feeds JAX's draws and demands the same accept
decisions).  The reference keys its per-walker streams on the global
walker index (``Population.walker_keys``); here the sharded driver draws
once per generation for the whole population from the one generator and
hands each shard its rows, so the random numbers of a walker do not
depend on the shard count, and an N-shard run takes the single-device
run's trajectories (DESIGN.md §5).

Sharding convention (the reference's): a state is either the walker
ensemble itself (every field walker-major, e.g. VMC's ``WalkerEnsemble``)
or a NamedTuple with an ``ens`` field holding it (``DMCState``,
``SEMState``); ``ens`` fields are split on their leading axis, every other
field is replicated.  Walker-major draws are split the same way; 0-d draws
(DMC's comb uniform) go to every shard.  Global reductions inside
``propagate`` go through the ``Population`` handle.

Ordering on the card: every shard thread runs on its device's default
stream, so a tensor one shard posts to the exchange is complete, in stream
order, before another shard's later launches read it; shards on distinct
cards copy through ``.to(device)``, which orders itself after the source
device's current (default) stream.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

WALKER_AXIS = 'walkers'

# seconds a shard waits at a collective for the others before the run is
# declared broken (a kernel build or a tuner measurement in one shard
# holds the others at their next collective)
BARRIER_TIMEOUT = 600.0

# method-name -> (factory, default_tau) registry, filled by vmc/sem/dmc and
# optimize.propagator at import
_METHODS: dict = {}


def register_method(name: str, factory, default_tau: float) -> None:
    """Register a Propagator factory under a CLI/RunSpec method name.

    ``factory(cfg, tau, e_trial, equil_steps) -> Propagator``; arguments a
    method doesn't use are ignored by its factory.
    """
    _METHODS[name] = (factory, float(default_tau))


def _method_entry(method: str):
    if method not in _METHODS:
        from repro_torch.core import dmc, sem, vmc  # noqa: F401
        from repro_torch.optimize import propagator  # noqa: F401  (opt-vmc)
    if method not in _METHODS:
        raise ValueError(f'unknown method {method!r} '
                         f'(registered: {sorted(_METHODS)})')
    return _METHODS[method]


def method_default_tau(method: str) -> float:
    """The registered step-size default for a method."""
    return _method_entry(method)[1]


def make_propagator(method: str, cfg, tau: float = 0.0,
                    e_trial: float | None = None, equil_steps: int = 100):
    """Build the Propagator for a registered method name (tau=0: the
    method's default)."""
    factory, default_tau = _method_entry(method)
    return factory(cfg, tau or default_tau, e_trial, equil_steps)


class BlockStats(NamedTuple):
    """One block's sufficient statistics: ``weight`` plus weighted means
    (``aux`` has a method-specific key set).  Host floats once reduced by
    ``EnsembleDriver.run_block`` (numpy arrays for array-valued aux, such
    as opt-vmc's moments); a propagator's ``block_stats`` may give
    the weight as a host float (VMC: the sample count) or a 0-d device
    tensor (DMC: the summed global weights)."""

    weight: float
    e_mean: float
    e2_mean: float
    aux: dict


class ShardGroup:
    """The meeting point of one sharded run's shard threads.

    ``exchange`` is the one collective: every shard posts a value, waits
    at the barrier for the others and gets all of them in rank order.
    The slots alternate between two buffers, so one barrier a collective
    suffices: a shard writes a buffer again only two collectives later,
    after every shard has passed the barrier in between, i.e. has taken
    its copy of the earlier round.  ``abort`` breaks the barrier (a shard
    that raised), so the others stop with ``BrokenBarrierError`` instead
    of waiting out the timeout.
    """

    def __init__(self, n_shards: int, timeout: float = BARRIER_TIMEOUT):
        self.n_shards = int(n_shards)
        self._barrier = threading.Barrier(self.n_shards, timeout=timeout)
        self._slots = ([None] * self.n_shards, [None] * self.n_shards)
        self._round = [0] * self.n_shards

    def exchange(self, rank: int, value) -> list:
        """Post ``value`` for shard ``rank``; -> every shard's, rank order."""
        buf = self._slots[self._round[rank] % 2]
        self._round[rank] += 1
        buf[rank] = value
        self._barrier.wait()
        return list(buf)

    def abort(self) -> None:
        """Break the barrier: every waiting or later collective raises."""
        self._barrier.abort()


class Population:
    """Global walker-axis reductions, shard-aware.

    Off a mesh (``group=None``) every method is the plain reduction on x's
    device: ``gather`` and ``take_local`` are the identity.  As shard
    ``rank`` of a ``ShardGroup`` each tensor holds this shard's slice of
    the walker axis: ``mean``/``mean0`` are the mean of the shards' means
    (the reference's ``pmean(mean(x))``), ``sum`` the sum of their sums,
    ``gather`` the whole population in rank order.  Every shard computes
    every collective from the same values in the same order, on its own
    device, so all shards hold the same result.
    """

    def __init__(self, group: ShardGroup | None = None, rank: int = 0):
        self.group = group
        self.rank = int(rank)
        self.n_shards = 1 if group is None else group.n_shards

    def size(self, x) -> int:
        """Global walker count (local x n_shards)."""
        return x.shape[0] * self.n_shards

    def shard_index(self) -> int:
        """This shard's position along the walker axis (0 off a mesh)."""
        return self.rank

    def _all(self, x: torch.Tensor) -> list:
        """Every shard's x, in rank order, on this shard's device."""
        return [p.to(x.device) for p in self.group.exchange(self.rank, x)]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Population mean (0-d tensor on x's device); a bool mask counts
        as 0/1 (exact for power-of-two walkers per shard)."""
        if x.dtype == torch.bool:
            x = x.to(torch.float32)
        m = torch.mean(x)
        if self.group is None:
            return m
        return torch.mean(torch.stack(self._all(m)))

    def mean0(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the walker axis only: (W, ...) -> (...)."""
        m = torch.mean(x, dim=0)
        if self.group is None:
            return m
        return torch.mean(torch.stack(self._all(m)), dim=0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Population sum (0-d tensor)."""
        s = torch.sum(x)
        if self.group is None:
            return s
        return torch.sum(torch.stack(self._all(s)))

    def gather(self, x):
        """The full population array (W, ...) from a local (W/S, ...); a
        tuple of such arrays is gathered in one exchange, as a tuple."""
        if self.group is None:
            return x
        parts = self.group.exchange(self.rank, x)
        if isinstance(x, torch.Tensor):
            return torch.cat([p.to(x.device) for p in parts], dim=0)
        return tuple(torch.cat([p[i].to(a.device) for p in parts], dim=0)
                     for i, a in enumerate(x))

    def take_local(self, x: torch.Tensor, n_local: int) -> torch.Tensor:
        """This shard's (n_local, ...) slice of a global walker-indexed
        array."""
        if self.group is None:
            return x
        return x[self.rank * n_local:(self.rank + 1) * n_local]


@runtime_checkable
class Propagator(Protocol):
    """The method-specific plug-in: one propagation step per method."""

    def init(self, params, gen: torch.Generator, n_walkers: int,
             walkers=None):
        """Initial state; ``walkers`` are optional (n_kept, ...) restart
        positions from the checkpoint reservoir."""
        ...

    def draw(self, gen: torch.Generator, state):
        """One generation's random numbers for the whole population of
        ``state`` (walker-major tensors, or 0-d ones every walker shares)."""
        ...

    def propagate(self, params, state, gen: torch.Generator,
                  pop: Population, draws=None):
        """One Monte Carlo generation -> (state, per-step outputs); draws
        with ``draw`` unless ``draws`` are injected."""
        ...

    def block_stats(self, params, state, outs, pop: Population
                    ) -> BlockStats:
        """Reduce the stacked per-step outputs (device tensors)."""
        ...


def restart_ensemble(walkers, n_walkers: int, evaluate, device):
    """Tile checkpointed walker positions up to ``n_walkers`` and
    re-evaluate (paper §V.D: restart = reseed from the reservoir)."""
    r = torch.as_tensor(walkers, dtype=torch.float32).to(device)
    reps = -(-n_walkers // r.shape[0])
    r = r.repeat((reps,) + (1,) * (r.ndim - 1))[:n_walkers].contiguous()
    return evaluate(r)


def merge_accepted(new, old, accept: torch.Tensor):
    """Per-walker select between two walker-major NamedTuples."""
    def _pick(a, b):
        return torch.where(accept.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
    return type(new)(*[_pick(a, b) for a, b in zip(new, old)])


def _to_device(x, dev: torch.device):
    """Every tensor of a NamedTuple/tuple/list/dict tree on ``dev`` (a
    tensor already there is returned itself, not copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*[_to_device(v, dev) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    return x


def _normalize(dev) -> torch.device:
    """A device with its index (``cuda`` -> the current card)."""
    dev = torch.device(dev)
    if dev.type == 'cuda' and dev.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def _on_device(dev: torch.device):
    """A shard thread's device: the card and its default stream (the
    ordering rule of the module docstring); nothing on the CPU."""
    if dev.type != 'cuda':
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(
            torch.cuda.default_stream(dev)):
        yield


def _host_stats(st: BlockStats) -> BlockStats:
    """A block's device BlockStats -> host floats in ONE transfer: a
    device-tensor weight (DMC) rides in it, a host-float weight (VMC)
    stays as is; array-valued aux (the optimizer's moments) is flattened
    into it and reshaped on the host."""
    on_device = isinstance(st.weight, torch.Tensor)
    parts = [st.e_mean, st.e2_mean, *st.aux.values(),
             *([st.weight] if on_device else [])]
    flat = torch.cat([p.reshape(-1) for p in parts]).tolist()
    vals, i = [], 0
    for p in parts:
        n = p.numel()
        vals.append(flat[i] if p.ndim == 0
                    else np.asarray(flat[i:i + n]).reshape(p.shape))
        i += n
    weight = vals.pop() if on_device else float(st.weight)
    return BlockStats(weight=weight, e_mean=vals[0], e2_mean=vals[1],
                      aux=dict(zip(st.aux, vals[2:])))


class EnsembleDriver:
    """Generic block runner: owns the ensemble, loops ``propagate`` steps.

    ``devices`` (a list of two or more; repeats allowed, which is how one
    card holds two shards) shards the walker axis: the state is then a
    list, one per shard, each on its device, and every block runs in one
    thread per shard.  ``None`` or one device is the single-device driver.
    ``timeout`` bounds every wait at a collective (seconds).
    """

    def __init__(self, propagator, steps: int, devices=None,
                 timeout: float = BARRIER_TIMEOUT):
        self.propagator = propagator
        self.steps = int(steps)
        self.devices = ([_normalize(d) for d in devices]
                        if devices is not None and len(devices) > 1
                        else None)
        self.timeout = float(timeout)
        self._props = None           # per-shard propagators (lazy)
        self._params = (None, None)  # (params, per-shard copies)

    @property
    def n_shards(self) -> int:
        """Walker-axis shards (1: the single-device driver)."""
        return 1 if self.devices is None else len(self.devices)

    def __getstate__(self):
        """Pickle support for the single-device driver; a sharded driver
        refuses (its shards are threads of this process, on its
        devices)."""
        if self.devices is not None:
            raise TypeError(
                'EnsembleDriver with walker shards cannot be pickled to '
                'another process; use the thread or sim backend for '
                'walker sharding')
        return self.__dict__.copy()

    # -- state construction / placement ---------------------------------
    def init(self, params, gen: torch.Generator, n_walkers: int,
             walkers=None):
        """Build the propagator state: the whole population on the
        parameters' device (drawing from ``gen`` as the single-device
        driver does), then, sharded, split across the devices."""
        if self.devices is not None and n_walkers % self.n_shards:
            raise ValueError(
                f'n_walkers={n_walkers} not divisible by the '
                f'{WALKER_AXIS!r} mesh axis ({self.n_shards} shards)')
        state = self.propagator.init(params, gen, n_walkers, walkers)
        return state if self.devices is None else self.split(state)

    def split(self, state) -> list:
        """A whole-population state -> one state per shard (walker-major
        part split in rank order, every other field replicated)."""
        ens = self._ensemble_part(state)
        n = ens[0].shape[0]
        if n % self.n_shards:
            raise ValueError(f'walker axis {n} not divisible by '
                             f'{self.n_shards} shards')
        m = n // self.n_shards
        out = []
        for k, dev in enumerate(self.devices):
            part = type(ens)(*[_to_device(a[k * m:(k + 1) * m], dev)
                               for a in ens])
            if hasattr(state, 'ens'):
                part = type(state)(**{
                    f: part if f == 'ens' else _to_device(getattr(state, f),
                                                          dev)
                    for f in state._fields})
            out.append(part)
        return out

    def merge(self, state):
        """Sharded state -> the whole population's ensemble part on the
        first device, in global walker order (the ensemble itself when
        unsharded)."""
        if self.devices is None:
            return self._ensemble_part(state)
        parts = [self._ensemble_part(s) for s in state]
        dev = self.devices[0]
        return type(parts[0])(*[torch.cat([f.to(dev) for f in fields])
                                for fields in zip(*parts)])

    def feedback(self, state, e_estimate):
        """Between-block scalar feedback (every shard); no-op for
        feedback-free methods."""
        fb = getattr(self.propagator, 'feedback', None)
        if fb is None:
            return state
        if self.devices is None:
            return fb(state, e_estimate)
        return [fb(s, e_estimate) for s in state]

    def reevaluate(self, params, state):
        """The ensemble re-evaluated under new ``params`` (opt-vmc after a
        parameter broadcast), on every shard."""
        if self.devices is None:
            return self.propagator.reevaluate(params, state)
        return [prop.reevaluate(p, s) for prop, p, s in
                zip(self.propagators(), self._shard_params(params), state)]

    # -- block loop ------------------------------------------------------
    def run_block(self, params, state, gen: torch.Generator):
        """Run one block of ``steps`` generations -> (state, BlockStats)."""
        if self.devices is not None:
            state, st = self._run_sharded(params, state, gen, self.steps)
            return state, _host_stats(st)
        pop = Population()
        outs = []
        for _ in range(self.steps):
            state, out = self.propagator.propagate(params, state, gen, pop)
            outs.append(out)
        stacked = tuple(torch.stack(col) for col in zip(*outs))
        st = self.propagator.block_stats(params, state, stacked, pop)
        # the block's one device-to-host sync
        return state, _host_stats(st)

    def step(self, params, state, draws):
        """One generation under injected whole-population ``draws`` (as
        ``propagator.draw`` makes them) -> (state, per-step outputs, rank
        0's when sharded)."""
        if self.devices is None:
            return self.propagator.propagate(params, state, None,
                                             Population(), draws)
        return self._run_sharded(params, state, None, 1, draws=draws)

    def _run_sharded(self, params, states, gen, steps: int, draws=None):
        """``steps`` generations in one thread per shard.  With ``draws``
        (one generation, injected) -> (states, rank 0's per-step
        outputs); else rank 0 draws each generation's whole-population
        numbers from ``gen`` and the block ends in its BlockStats ->
        (states, rank 0's device BlockStats).  A shard that raises aborts
        the barrier; the first shard's own exception is re-raised."""
        props = self.propagators()
        params_k = self._shard_params(params)
        group = ShardGroup(self.n_shards, self.timeout)
        n_local = self._ensemble_part(states[0])[0].shape[0]
        results = [None] * self.n_shards
        errors = []
        lock = threading.Lock()

        def _draws(pop, st):
            # rank 0 draws for the whole population; each shard its rows
            mine = None
            if pop.rank == 0:
                mine = draws if draws is not None else props[0].draw(
                    gen, self._stand_in(st, n_local * self.n_shards,
                                        gen.device))
            got = group.exchange(pop.rank, mine)[0]
            dev = self.devices[pop.rank]
            lo, hi = pop.rank * n_local, (pop.rank + 1) * n_local
            return tuple(_to_device(d if d.ndim == 0 else d[lo:hi], dev)
                         for d in got)

        def _shard(k):
            pop = Population(group, k)
            prop, p, st = props[k], params_k[k], states[k]
            try:
                with _on_device(self.devices[k]):
                    outs = []
                    for _ in range(steps):
                        st, out = prop.propagate(p, st, None, pop,
                                                 _draws(pop, st))
                        outs.append(out)
                    if draws is not None:
                        results[k] = (st, outs[0])
                        return
                    stacked = tuple(torch.stack(col) for col in zip(*outs))
                    results[k] = (st, prop.block_stats(p, st, stacked, pop))
            except BaseException as exc:  # noqa: BLE001  (re-raised below)
                with lock:
                    errors.append(exc)
                group.abort()

        threads = [threading.Thread(target=_shard, args=(k,), daemon=True,
                                    name=f'shard-{k}')
                   for k in range(self.n_shards)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            first = [e for e in errors
                     if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or errors)[0]
        return [r[0] for r in results], results[0][1]

    # -- per-shard copies -------------------------------------------------
    def propagators(self) -> list:
        """One propagator per shard: the driver's own where the shard is
        on its configuration's device, else a copy whose ``cfg`` (basis,
        CI tables, screening structure) is pinned on the shard's device."""
        if self._props is None:
            home = getattr(self.propagator, 'cfg', None)
            props = []
            for dev in self.devices:
                if home is None or _normalize(home.device) == dev:
                    props.append(self.propagator)
                    continue
                prop = copy.copy(self.propagator)
                prop.cfg = dataclasses.replace(home, device=str(dev))
                props.append(prop)
            self._props = props
        return self._props

    def _shard_params(self, params) -> list:
        """The parameters on every shard's device (cached per params
        object: a new broadcast vector makes a new one)."""
        seen, copies = self._params
        if seen is not params:
            copies = [_to_device(params, dev) for dev in self.devices]
            self._params = (params, copies)
        return copies

    # -- sharding convention --------------------------------------------
    @staticmethod
    def _ensemble_part(state):
        """Walker-major part of the state (see module docstring)."""
        return state.ens if hasattr(state, 'ens') else state

    @classmethod
    def _stand_in(cls, state, n_total: int, device) -> object:
        """``state`` with whole-population walker positions (uninitialised,
        on the generator's device): what ``Propagator.draw`` reads to size
        a generation's draws."""
        ens = cls._ensemble_part(state)
        r = torch.empty((n_total,) + tuple(ens.r.shape[1:]),
                        dtype=ens.r.dtype, device=device)
        ens = ens._replace(r=r)
        return state._replace(ens=ens) if hasattr(state, 'ens') else ens
