"""PyTorch/CUDA port of the QMC system (the JAX package ``repro`` is the
reference).

Layout mirrors ``repro``: ``core`` (AO -> MO -> Slater -> local energy,
propagators, block driver), ``kernels`` (hand-written CUDA kernels, each
beside its plain PyTorch version), ``systems`` (molecules, the paper's
benchmark systems), ``runtime`` (the jax-free block runtime, copied) and
``launch`` (``RunSpec``/``build_run`` and the ``qmc_run`` CLI).

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``
(see ``repro_torch.device.resolve_device``).
"""
