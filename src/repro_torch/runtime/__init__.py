"""Fault-tolerant block runtime (paper §V), for the PyTorch port.

``blocks``, ``worker``, ``forwarder``, ``packets``, ``reservoir``,
``database``, ``manager`` and ``backends`` are verbatim copies of the
jax-free modules of ``repro.runtime`` (only their import lines differ);
``samplers`` is the port's own ``BlockSampler`` over torch propagators.
The TCP grid backend is not ported: ``make_backend('grid')`` raises.
"""
from repro_torch.runtime.backends import (BACKENDS, ExecutorBackend,
                                          ProcessBackend, SimGridBackend,
                                          SimGridConfig, ThreadBackend,
                                          WorkerHandle, make_backend)
from repro_torch.runtime.blocks import (BlockAccumulator, BlockResult,
                                        combine_blocks)
from repro_torch.runtime.database import (SCHEMA_VERSION, ResultDatabase,
                                          critical_data_key, validate_block)
from repro_torch.runtime.forwarder import Forwarder, build_tree
from repro_torch.runtime.manager import QMCManager, RunControl
from repro_torch.runtime.reservoir import WalkerReservoir

__all__ = [
    'BACKENDS', 'BlockAccumulator', 'BlockResult', 'combine_blocks',
    'ExecutorBackend', 'Forwarder', 'ProcessBackend', 'QMCManager',
    'ResultDatabase', 'RunControl', 'SCHEMA_VERSION', 'SimGridBackend',
    'SimGridConfig', 'ThreadBackend', 'WalkerReservoir', 'WorkerHandle',
    'build_tree', 'critical_data_key', 'make_backend', 'validate_block',
]
