"""Hand-written CUDA kernels: ``<name>/{ref,ops,kernel}.py`` packages.

``ref`` is the plain PyTorch version (the CPU path and the oracle on the
card), ``kernel`` the ctypes wrapper of ``csrc/<name>.cu`` with its launch
counter, ``ops`` the public entry point: the plain version for a CPU
tensor, the kernel for a CUDA tensor (no fallback between the two).
"""


def launch_counters() -> dict:
    """The launch counter of each CUDA kernel, by name (``sem_move`` is
    the per-move kernel that ``sem_update``'s package wraps,
    ``fused_sweep_p_replay`` the second kernel of ``fused_sweep``'s cluster
    route with CI).  Each
    process keeps its own counts: a run's workers in other processes
    report theirs (``launch.qmc_worker``'s closing line)."""
    from repro_torch.kernels.fused_sweep import kernel as fused_sweep
    from repro_torch.kernels.multidet_ratio import kernel as multidet_ratio
    from repro_torch.kernels.screened_mo import kernel as screened_mo
    from repro_torch.kernels.sem_update import kernel as sem_update
    from repro_torch.kernels.sparse_mo import kernel as sparse_mo
    return {'sparse_mo': sparse_mo.COUNTER, 'sem_update': sem_update.COUNTER,
            'sem_move': sem_update.MOVE_COUNTER,
            'fused_sweep': fused_sweep.COUNTER,
            'fused_sweep_p_replay': fused_sweep.REPLAY_COUNTER,
            'multidet_ratio': multidet_ratio.COUNTER,
            'screened_mo': screened_mo.COUNTER}
