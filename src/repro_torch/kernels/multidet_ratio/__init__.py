"""Batched multideterminant move ratios (port of
``repro.kernels.multidet_ratio``)."""
