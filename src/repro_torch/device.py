"""Device selection and the fp32 numerics contract of the port.

Every entry point (``build_system``, ``BlockSampler``, ``build_run``, the
``qmc_run`` CLI) resolves its device here: CUDA unless the caller asks for
the CPU.  Without a GPU an entry point raises; it never moves to the CPU on
its own.  TF32 is switched off for matmuls and cuDNN: a TF32 GEMM keeps
about three decimal digits, which would break the 1e-4 drift bound of the
maintained Slater inverses (DESIGN.md §6).
"""
from __future__ import annotations

import threading

import torch


def fp32_numerics() -> None:
    """Disable TF32 everywhere (matmul precision 'highest') and check that
    it stuck."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != 'highest'):
        raise RuntimeError('TF32 could not be disabled')


def resolve_device(device=None) -> torch.device:
    """``None``/``'cuda'`` -> the current CUDA device (raises without one);
    ``'cpu'`` -> the CPU.  Also pins the fp32 numerics contract."""
    fp32_numerics()
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" '
            '(CLI: --device cpu) to run on the CPU')
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {device!r}')
    return dev


_LINALG_LOCK = threading.Lock()
_linalg_loaded = False


def load_linalg(device) -> None:
    """Make this process's first ``torch.linalg`` call on a CUDA ``device``
    once, under a lock.  torch loads its CUDA linear-algebra library at
    that first call, and a second thread whose first call overlaps it
    raises "lazy wrapper should be called at most once"; a run's worker
    threads (``BlockSampler.init_state``) and shard threads make their
    first calls at once.  A no-op on the CPU and once loaded."""
    global _linalg_loaded
    dev = torch.device(device)
    if dev.type != 'cuda' or _linalg_loaded:
        return
    with _LINALG_LOCK:
        if not _linalg_loaded:
            torch.linalg.slogdet(torch.eye(2, device=dev))
            _linalg_loaded = True
