"""Hand-written CUDA kernels: ``<name>/{ref,ops,kernel}.py`` packages.

``ref`` is the plain PyTorch version (the CPU path and the oracle on the
card), ``kernel`` the ctypes wrapper of ``csrc/<name>.cu`` with its launch
counter, ``ops`` the public entry point: the plain version for a CPU
tensor, the kernel for a CUDA tensor (no fallback between the two).
"""
