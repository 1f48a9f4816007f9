"""The runtime adapter from torch Propagators to the worker Sampler protocol.

Port of ``repro.runtime.samplers``: ``BlockSampler`` wraps any
``core.driver.Propagator`` behind the ``init_state`` / ``run_subblock`` /
``set_e_trial`` contract of ``runtime.worker.Sampler``.  Each worker owns a
private walker population and a private ``torch.Generator`` on the
device, seeded from ``(seed, worker_id)``; its sub-blocks draw from that
one stream in order, so worker streams never alias.

A ``BlockSampler`` pickles by value for the ``process`` backend's spawned
children: every tensor it holds travels as host bytes with the device's
name, and the child puts them back on its own device.
"""
from __future__ import annotations

import io

import numpy as np
import torch

from repro_torch.core.driver import EnsembleDriver
from repro_torch.device import resolve_device
from repro_torch.runtime.blocks import BlockAccumulator


def worker_seed(seed: int, worker_id: int) -> int:
    """64-bit generator seed for one worker of a run."""
    return int(np.random.SeedSequence([int(seed), int(worker_id)])
               .generate_state(1, np.uint64)[0])


class BlockSampler:
    """Generic Sampler: (Propagator, params) -> worker-facing block runner.

    ``device`` is where the walkers live (``None``/``'cuda'``: the GPU,
    raising without one; ``'cpu'`` only when asked).
    """

    def __init__(self, propagator, params, n_walkers: int = 32,
                 steps: int = 50, device=None):
        self.device = resolve_device(device)
        if params.coords.device.type != self.device.type:
            raise ValueError(f'params live on {params.coords.device}, the '
                             f'sampler on {self.device}')
        self.propagator = propagator
        self.params = params
        self.n_walkers = int(n_walkers)
        self.params_version = 0
        self.driver = EnsembleDriver(propagator, steps)

    def __getstate__(self):
        """Pickle support (``ProcessBackend`` ships samplers to spawned
        children).  The params and the propagator, with every tensor its
        ``cfg`` holds (the basis, the CI tables, the screening structure,
        all pinned on the device), are serialised by ``torch.save``: their
        storages are copied to host memory, never shared by CUDA IPC.  The
        device travels by name."""
        buf = io.BytesIO()
        torch.save({'propagator': self.propagator, 'params': self.params},
                   buf)
        state = {k: v for k, v in self.__dict__.items()
                 if k not in ('propagator', 'params', 'driver', 'device')}
        return dict(state, device=str(self.device), steps=self.driver.steps,
                    tensors=buf.getvalue())

    def __setstate__(self, state):
        """Rebuild in the receiving process: resolve the device by name
        (``cuda`` raises where there is none; never the CPU instead) and
        load every tensor onto it."""
        state = dict(state)
        device = resolve_device(state.pop('device'))
        steps = state.pop('steps')
        objs = torch.load(io.BytesIO(state.pop('tensors')),
                          map_location=device, weights_only=False)
        self.__dict__.update(state)
        self.device = device
        self.propagator = objs['propagator']
        self.params = objs['params']
        self.driver = EnsembleDriver(self.propagator, steps)

    def init_state(self, worker_id: int, seed: int, walkers=None):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(worker_seed(seed, worker_id))
        state = self.driver.init(self.params, gen, self.n_walkers, walkers)
        return (gen, state)

    def set_e_trial(self, state, e_trial: float):
        """Between-block scalar feedback (no-op for VMC methods)."""
        gen, st = state
        return (gen, self.driver.feedback(st, e_trial))

    def apply_params(self, version: int, vec) -> None:
        """Parameter broadcast (wavefunction optimization) is not ported."""
        raise NotImplementedError('parameter broadcast (opt-vmc) is not '
                                  'ported to the PyTorch package yet')

    def run_subblock(self, state, step: int):
        """-> (state, BlockAccumulator, walkers np, energies np)."""
        gen, st = state
        st, stats = self.driver.run_block(self.params, st, gen)
        ens = st.ens if hasattr(st, 'ens') else st
        acc = BlockAccumulator.from_stats(stats)
        return ((gen, st), acc, ens.r.cpu().numpy(),
                ens.e_loc.cpu().numpy())
