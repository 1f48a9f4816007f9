"""Quickstart: VMC + DMC on real molecules through the unified driver API,
on the PyTorch/CUDA port (``repro_torch``; ``examples/quickstart.py`` is
the same walk-through on the JAX package).

Runs on one NVIDIA GPU in a few seconds (``--device cpu``: on the CPU):
  1. build an H2O trial wavefunction (core-Hamiltonian MOs + Jastrow);
  2. verify the paper's three MO-product paths (dense O(N^3) oracle,
     sparse-AO gather, the ``sparse_mo`` CUDA kernel; on the CPU that
     kernel's plain version) agree to fp32;
  3. VMC-equilibrate a walker population and measure <E_L>;
  4. run fixed-node DMC with constant-population reconfiguration.

The method-specific physics lives in a ``Propagator`` (VMCPropagator /
DMCPropagator); the block loop, walker ensemble and (optional) walker
sharding are one generic ``EnsembleDriver``.  To spread the walker axis
over every local card, pass ``devices=repro_torch.sharding
.walkers_devices()`` to the driver.  Random numbers come from explicit
``torch.Generator`` objects seeded with the JAX version's key integers;
the draws themselves differ (torch cannot replay threefry).

At tau = 0.25 the all-electron moves of water accept almost nothing
after the first block, and DMC from those walkers drifts far below
water's energy; the JAX version does the same with these settings.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.dmc import DMCPropagator, init_dmc
from repro_torch.core.driver import EnsembleDriver
from repro_torch.core.vmc import VMCPropagator
from repro_torch.core.wavefunction import psi_state
from repro_torch.device import resolve_device
from repro_torch.systems.molecule import build_wavefunction, water

# the three MO-product paths and their settings (``kernel`` takes no tile
# shape: the CUDA kernel sizes its own tiles)
MO_PATHS = (('dense', {}), ('sparse', {'k_max': 16}), ('kernel', {}))


def _gen(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def method_consistency(cfg, params, r, paths=MO_PATHS) -> dict:
    """E_L of one walker ``r`` (n_elec, 3) through each MO-product path
    of ``paths`` -> {method: E_L}."""
    e_loc = {}
    for method, kw in paths:
        c = dataclasses.replace(cfg, method=method, **kw)
        e_loc[method] = float(psi_state(c, params, r).e_loc)
        print(f'   {method:6s}: E_L = {e_loc[method]:+.6f}')
    return e_loc


def _block(drv, params, state, seed, dev):
    t0 = time.perf_counter()
    state, stats = drv.run_block(params, state, _gen(seed, dev))
    return state, dict(e=float(stats.e_mean),
                       accept=float(stats.aux['accept']),
                       secs=time.perf_counter() - t0)


def main(device=None, n_walkers: int = 256, steps: int = 60,
         vmc_blocks: int = 3, dmc_blocks: int = 4) -> dict:
    """Run the walk-through; returns what it prints: ``e_loc`` (the three
    paths' E_L), ``vmc`` and ``dmc`` (each block's ``e``, ``accept`` and
    wall ``secs``), ``e_trial`` (DMC's E_T before each block and after
    the last feedback), ``e_vmc``, ``e_dmc`` and ``e_dmc_err``."""
    dev = resolve_device(device)
    print('== building H2O trial wavefunction (STO-3G, core guess + Jastrow)')
    cfg, params = build_wavefunction(*water(), method='dense', device=dev)

    print('== method consistency: dense / sparse-AO / sparse_mo kernel')
    r = torch.randn((cfg.n_elec, 3), generator=_gen(0, dev),
                    device=dev) * 1.2
    out = dict(e_loc=method_consistency(cfg, params, r), vmc=[], dmc=[],
               e_trial=[])

    print(f'== VMC ({n_walkers} walkers, {vmc_blocks} blocks x {steps} '
          'steps)')
    # one driver per method; sharding across local cards is just
    # EnsembleDriver(..., devices=repro_torch.sharding.walkers_devices())
    vmc = EnsembleDriver(VMCPropagator(cfg, tau=0.25), steps=steps)
    ens = vmc.init(params, _gen(1, dev), n_walkers=n_walkers)
    for i in range(vmc_blocks):
        ens, b = _block(vmc, params, ens, 10 + i, dev)
        out['vmc'].append(b)
        print(f"   block {i}: E = {b['e']:+.4f}  accept = {b['accept']:.2f}")
    e_vmc = out['vmc'][-1]['e']

    print('== FN-DMC (constant population, reconfiguration)')
    dmc = EnsembleDriver(DMCPropagator(cfg, e_trial=e_vmc, tau=0.01),
                         steps=steps)
    st = init_dmc(ens, e_trial=e_vmc)      # reuse the equilibrated ensemble
    st, _ = _block(dmc, params, st, 42, dev)               # equilibrate
    for i in range(dmc_blocks):
        out['e_trial'].append(float(st.e_trial))
        st, b = _block(dmc, params, st, 100 + i, dev)
        st = dmc.feedback(st, b['e'])      # E_T update, one knob
        out['dmc'].append(b)
        print(f"   block {i}: E = {b['e']:+.4f}  accept = {b['accept']:.3f}")
    out['e_trial'].append(float(st.e_trial))
    es = [b['e'] for b in out['dmc']]
    out.update(e_vmc=e_vmc, e_dmc=float(np.mean(es)),
               e_dmc_err=float(np.std(es) / np.sqrt(len(es))))
    print(f"== E(VMC) = {e_vmc:+.4f}   E(DMC) = {out['e_dmc']:+.4f} "
          f"+/- {out['e_dmc_err']:.4f}  (DMC lowers the variational energy)")
    return out


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    main(device=ap.parse_args().device)
