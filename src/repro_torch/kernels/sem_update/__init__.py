"""Batched Sherman–Morrison update (port of ``repro.kernels.sem_update``)."""
