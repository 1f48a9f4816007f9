"""Sharding: the devices of the walker axis (port of ``repro.sharding``)."""
from repro_torch.sharding.ensemble import walkers_devices

__all__ = ['walkers_devices']
