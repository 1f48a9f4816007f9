"""Build and load the CUDA kernels: ``nvcc`` into shared libraries, ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (pointers and the stream as
``void*``, sizes as integers, ``cudaGetLastError()`` as the return value)
and is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

into the repository's ``build/`` directory (listed in ``.gitignore``).  The
file name carries a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited kernel or header is rebuilt and an unchanged
one is loaded as it is.  ``build_all`` starts
one ``nvcc`` per source at once, so a cold build costs the slowest file,
not the sum.  Nothing here runs at import time: the CPU tests import every
module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'repro_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
KERNEL_SOURCES = ('sparse_mo', 'sem_update', 'sem_move', 'fused_sweep',
                  'multidet_ratio', 'screened_mo')

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Plain-int count of kernel launches (thread-safe increments).

    A wrapper adds one where it launches its kernel and nowhere else, so a
    run can show that its main path went through the kernel."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        """Count one launch."""
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        """Set the count to zero."""
        with self._lock:
            self.n = 0


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (looked on PATH and in '
                           '/usr/local/cuda/bin); the CUDA kernels are '
                           'built on a machine with the CUDA toolkit')
    return path


def lib_path(name: str) -> Path:
    """Content-addressed library path for ``csrc/<name>.cu``."""
    h = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    h = h.hexdigest()[:16]
    return BUILD_DIR / f'{name}-{h}.so'


def _start(name: str):
    """Start ``nvcc`` for one source (None when the library exists)."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    (BUILD_DIR / f'{out.stem}.log').write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed for {name}.cu '
                           f'(exit {proc.returncode}):\n{log}')
    os.replace(tmp, out)
    return log


def build_all(names=KERNEL_SOURCES) -> dict:
    """Build every named kernel library in parallel.

    Returns {name: (seconds, nvcc output)}; libraries already built report
    0 seconds and their saved log.  Raises on the first failed build after
    every ``nvcc`` has ended (no process is left running).
    """
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        out, errors = {}, []
        for n, job in jobs.items():
            if job is None:
                log = lib_path(n).with_suffix('.log')
                out[n] = (0.0, log.read_text() if log.exists() else '')
                continue
            try:
                out[n] = (time.perf_counter() - t0, _finish(n, job))
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError('\n'.join(errors))
    return out


def load(name: str, configure) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.

    ``configure(lib)`` runs once, when the library is first loaded: it
    declares ``argtypes``/``restype`` and checks compiled-in constants.
    """
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(lib_path(name)))
            configure(lib)
            _LIBS[name] = lib
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch entry point."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')
