"""Propagator/Driver API: one block loop for every QMC method.

Port of ``repro.core.driver`` for a single device:

* a ``Propagator`` supplies the physics (``init`` / ``propagate`` /
  ``block_stats``, optional ``feedback``);
* ``EnsembleDriver`` owns the block loop — a plain host loop over
  ``steps`` generations (the reference's jit'd ``lax.scan``).  Per-step
  outputs stay on the device; the block reduces them once, so a block
  costs one device-to-host sync, not one per step;
* ``BlockStats`` is the block contract (weight + weighted means, host
  floats), merged by ``runtime.blocks.BlockAccumulator``.

RNG: propagators draw from an explicit ``torch.Generator`` on the walkers'
device.  Every ``propagate`` also takes optional injected ``draws`` — the
same normals/uniforms the reference derives from its threefry keys — so a
test can feed JAX's draws and demand the same accept decisions.
"""
from __future__ import annotations

from typing import NamedTuple, Protocol, runtime_checkable

import torch

# method-name -> (factory, default_tau) registry, filled by vmc/sem at import
_METHODS: dict = {}


def register_method(name: str, factory, default_tau: float) -> None:
    """Register a Propagator factory ``factory(cfg, tau) -> Propagator``
    under a CLI/RunSpec method name."""
    _METHODS[name] = (factory, float(default_tau))


def _method_entry(method: str):
    if method not in _METHODS:
        from repro_torch.core import sem, vmc  # noqa: F401  (registration)
    if method not in _METHODS:
        raise NotImplementedError(
            f'method {method!r} is not ported to the PyTorch package yet '
            f'(ported: {sorted(_METHODS)})')
    return _METHODS[method]


def method_default_tau(method: str) -> float:
    """The registered step-size default for a method."""
    return _method_entry(method)[1]


def make_propagator(method: str, cfg, tau: float = 0.0):
    """Build the Propagator for a registered method name (tau=0: the
    method's default)."""
    factory, default_tau = _method_entry(method)
    return factory(cfg, tau or default_tau)


class BlockStats(NamedTuple):
    """One block's sufficient statistics: ``weight`` plus weighted means
    (``aux`` has a method-specific key set).  Host floats once reduced by
    ``EnsembleDriver.run_block``."""

    weight: float
    e_mean: float
    e2_mean: float
    aux: dict


class Population:
    """Walker-axis reductions for one device (the reference's collectives
    degenerate to these outside a mesh)."""

    def size(self, x) -> int:
        """Walker count."""
        return x.shape[0]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Population mean (0-d tensor on x's device)."""
        if x.dtype == torch.bool:
            x = x.to(torch.float32)
        return torch.mean(x)


@runtime_checkable
class Propagator(Protocol):
    """The method-specific plug-in: one propagation step per method."""

    def init(self, params, gen: torch.Generator, n_walkers: int,
             walkers=None):
        """Initial state; ``walkers`` are optional (n_kept, ...) restart
        positions from the checkpoint reservoir."""
        ...

    def propagate(self, params, state, gen: torch.Generator,
                  pop: Population, draws=None):
        """One Monte Carlo generation -> (state, per-step outputs)."""
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


class EnsembleDriver:
    """Generic block runner: owns the ensemble, loops ``propagate`` steps."""

    def __init__(self, propagator, steps: int):
        self.propagator = propagator
        self.steps = int(steps)

    def init(self, params, gen: torch.Generator, n_walkers: int,
             walkers=None):
        """Build the propagator state."""
        return self.propagator.init(params, gen, n_walkers, walkers)

    def feedback(self, state, e_estimate):
        """Between-block scalar feedback; no-op for feedback-free methods."""
        fb = getattr(self.propagator, 'feedback', None)
        return state if fb is None else fb(state, e_estimate)

    def run_block(self, params, state, gen: torch.Generator):
        """Run one block of ``steps`` generations -> (state, BlockStats)."""
        pop = Population()
        outs = []
        for _ in range(self.steps):
            state, out = self.propagator.propagate(params, state, gen, pop)
            outs.append(out)
        stacked = tuple(torch.stack(col) for col in zip(*outs))
        st = self.propagator.block_stats(params, state, stacked, pop)
        keys = list(st.aux)
        # the block's one device-to-host sync
        vals = torch.stack([st.e_mean, st.e2_mean,
                            *st.aux.values()]).tolist()
        return state, BlockStats(weight=float(st.weight), e_mean=vals[0],
                                 e2_mean=vals[1],
                                 aux=dict(zip(keys, vals[2:])))
