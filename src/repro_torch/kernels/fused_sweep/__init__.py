"""Fused single-electron-move sweep (port of ``repro.kernels.fused_sweep``)."""
