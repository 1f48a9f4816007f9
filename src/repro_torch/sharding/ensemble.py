"""The walker axis's devices for the unified QMC driver.

Port of ``repro.sharding.ensemble``: where the reference builds a 1-D
``walkers`` mesh over local devices, the port lists them, and
``core.driver.EnsembleDriver`` runs one thread per shard on them.  The
whole population's draws are made once per generation and split by
global walker index, so any device list reproduces the single-device
run's trajectories (DESIGN.md §5).
"""
from __future__ import annotations

import torch


def walkers_devices(n_shards: int | None = None,
                    device=None) -> list[torch.device] | None:
    """Devices for walker-axis sharding.

    ``n_shards``: shard count (default: every visible card; one on the
    CPU).  ``device``: ``None``/``'cuda'`` lists the first ``n_shards``
    visible cards and raises when fewer are visible; ``'cpu'`` lists the
    CPU ``n_shards`` times (torch has one CPU device: the shards are its
    threads, as the reference's tests use virtual CPU devices).  Returns
    ``None`` for one shard or fewer, the single-device driver.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cpu':
        n = int(n_shards or 1)
        return None if n <= 1 else [dev] * n
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {device!r}')
    visible = torch.cuda.device_count()
    n = int(n_shards) if n_shards else visible
    if n > visible:
        raise ValueError(f'requested {n} walker shards but only '
                         f'{visible} local devices are visible')
    if n <= 1:
        return None
    return [torch.device('cuda', i) for i in range(n)]
