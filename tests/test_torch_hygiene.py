"""Structural rules of the PyTorch port.

* ``src/repro_torch``, ``chip_smoke.py`` and ``chip_phases.py`` import
  neither JAX nor the JAX package ``repro`` (the port keeps its own copies
  of what it needs);
* without a GPU, the entry points raise unless the caller asks for the
  CPU — they never move to the CPU on their own;
* the runtime modules copied from ``repro.runtime`` differ from their
  originals only in import lines (and ``grid``'s localhost workers start
  the port's ``qmc_worker``, one named line); so do the optimization
  modules copied from ``repro.optimize`` (``solvers``, ``loop``).
"""
import ast
import re
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('jax')

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'src' / 'repro_torch'
RUNTIME_COPIES = ('blocks', 'worker', 'forwarder', 'packets', 'reservoir',
                  'database', 'manager', 'backends', 'grid', 'testing')
# the one non-import line a copy may change: the worker module the grid
# backend starts on localhost (the reference's would start the JAX worker)
WORKER_MODULE_LINE = {
    'grid': ("        cmd = [sys.executable, '-m', 'repro.launch.qmc_worker',",
             "        cmd = [sys.executable, '-m', "
             "'repro_torch.launch.qmc_worker',")}


def _port_files():
    return sorted(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py',
                                         ROOT / 'chip_phases.py']


def _forbidden(name: str) -> bool:
    top = name.split('.')[0]
    return top in ('jax', 'jaxlib', 'repro')


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f'{path}: forbidden imports {bad}'


def test_import_check_reaches_the_dmc_and_worker_modules():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {'core/dmc.py', 'core/reconfig.py', 'launch/qmc_worker.py',
            'runtime/grid.py', 'runtime/testing.py'} <= files


def test_import_check_reaches_the_optimization_modules():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {'optimize/__init__.py', 'optimize/estimators.py',
            'optimize/propagator.py', 'optimize/solvers.py',
            'optimize/loop.py', 'train/__init__.py',
            'train/checkpoint.py'} <= files


@pytest.mark.parametrize('name', ['solvers', 'loop'])
def test_optimize_copies_differ_only_in_import_lines(name):
    orig = (ROOT / 'src' / 'repro' / 'optimize' / f'{name}.py'
            ).read_text().splitlines()
    copy = (PORT / 'optimize' / f'{name}.py').read_text().splitlines()
    assert len(orig) == len(copy), name
    changed = 0
    for a, b in zip(orig, copy):
        if a == b:
            continue
        assert re.match(r'\s*(from|import) ', a), (name, a)
        assert re.sub(r'\brepro\.(runtime|optimize|train)\b',
                      r'repro_torch.\1', a) == b, (name, a, b)
        changed += 1
    assert changed >= 1


def test_runtime_copies_differ_only_in_import_lines():
    for name in RUNTIME_COPIES:
        orig = (ROOT / 'src' / 'repro' / 'runtime' / f'{name}.py'
                ).read_text().splitlines()
        copy = (PORT / 'runtime' / f'{name}.py').read_text().splitlines()
        assert len(orig) == len(copy), name
        for a, b in zip(orig, copy):
            if a == b:
                continue
            if (a, b) == WORKER_MODULE_LINE.get(name):
                continue
            assert re.match(r'\s*(from|import) ', a), (name, a)
            assert re.sub(r'\brepro\.runtime\b', 'repro_torch.runtime',
                          a) == b, (name, a, b)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is valid here')


def test_entry_points_refuse_to_fall_back_to_cpu(no_gpu):
    from repro_torch.core.vmc import VMCPropagator
    from repro_torch.launch import qmc_run
    from repro_torch.runtime.samplers import BlockSampler
    from repro_torch.systems import build_system
    with pytest.raises(RuntimeError, match='no CUDA device'):
        qmc_run.main(['--system', 'h2', '--workers', '1', '--blocks', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_system('h2')
    cfg, params = build_system('h2', device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        BlockSampler(VMCPropagator(cfg), params)
    BlockSampler(VMCPropagator(cfg), params, device='cpu')


def test_unported_methods_and_backends_say_so():
    """Every method and every backend of the reference is ported
    (``opt-vmc`` included); unknown names still raise."""
    from repro_torch.core.driver import method_default_tau
    from repro_torch.launch.spec import METHODS, RunSpec
    for method in METHODS:
        RunSpec(method=method)
        assert method_default_tau(method) > 0
    for kw in (dict(backend='process'), dict(backend='sim'),
               dict(backend='grid')):
        RunSpec(**kw)
    with pytest.raises(ValueError):
        RunSpec(method='nope')
    with pytest.raises(ValueError):
        RunSpec(backend='mpi')


def test_run_key_is_the_reference_key_plus_impl():
    """Same physics, distinct key: torch blocks never fold into a JAX
    run's averages."""
    from repro.runtime.database import critical_data_key as j_key
    from repro_torch.launch.spec import RunSpec, build_run
    run = build_run(RunSpec(system='h2', device='cpu', n_workers=1))
    mo = run.params.mo.numpy()
    coords = run.params.coords.numpy()
    base = dict(system='h2', method='vmc', tau=0.3, mo=mo, coords=coords)
    assert run.run_key == j_key(**base, impl='torch')
    assert run.run_key != j_key(**base)


KERNELS = ['sparse_mo', 'sem_update', 'sem_move', 'fused_sweep',
           'multidet_ratio', 'screened_mo']
# the package of each source's wrapper (sem_move.cu is wrapped beside
# sem_update.cu)
PACKAGE = {'sem_move': 'sem_update'}


@pytest.mark.parametrize('name', KERNELS)
def test_kernel_build_is_lazy_and_content_addressed(name):
    """Importing the kernel modules builds nothing; every source is in the
    build list, and its library name follows the source hash, inside the
    ignored build directory."""
    import importlib
    from repro_torch.kernels import _build
    package = PACKAGE.get(name, name)
    importlib.import_module(f'repro_torch.kernels.{package}.kernel')
    importlib.import_module(f'repro_torch.kernels.{package}.ops')
    assert _build._LIBS == {}
    assert name in _build.KERNEL_SOURCES
    assert (_build.CSRC / f'{name}.cu').is_file()
    p = _build.lib_path(name)
    assert p.parent == ROOT / 'build' / 'repro_torch'
    assert p.name.startswith(f'{name}-') and p.suffix == '.so'
    assert 'build/' in (ROOT / '.gitignore').read_text().split()


@pytest.mark.parametrize('name', KERNELS)
def test_kernel_library_name_follows_source_and_shared_headers(
        name, tmp_path, monkeypatch):
    """An edit of the kernel's source or of a shared header (``*.cuh``)
    gives the library a new name, so the next call rebuilds it."""
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, 'CSRC', csrc)
    base = _build.lib_path(name)
    assert base == _build.lib_path(name)
    names = {base}
    for path in [csrc / f'{name}.cu', *sorted(csrc.glob('*.cuh'))]:
        text = path.read_text()
        path.write_text(text + '\n// edited\n')
        names.add(_build.lib_path(name))
        path.write_text(text)
        assert _build.lib_path(name) == base
    assert len(names) == 2 + len(list(csrc.glob('*.cuh')))


# the configure function of each source's wrapper, by source
CONFIGURE = {'sparse_mo': ('sparse_mo', '_configure'),
             'sem_update': ('sem_update', '_configure'),
             'sem_move': ('sem_update', '_configure_move'),
             'fused_sweep': ('fused_sweep', '_configure'),
             'multidet_ratio': ('multidet_ratio', '_configure'),
             'screened_mo': ('screened_mo', '_configure')}


def _c_functions(src: str) -> dict:
    """{name: (return type, [parameter types])} of the ``extern "C"``
    functions of a CUDA source."""
    out = {}
    for ret, name, params in re.findall(
            r'extern "C" (int|long long) (\w+)\(([^)]*)\)', src):
        kinds = []
        for p in params.split(','):
            p = ' '.join(p.split())
            if not p:
                continue
            kinds.append('ptr' if '*' in p else
                         'long long' if p.startswith('long long') else
                         'int' if p.startswith('int') else p)
        out[name] = (ret, kinds)
    return out


@pytest.mark.parametrize('name', KERNELS)
def test_ctypes_argument_types_match_the_source(name, monkeypatch):
    """Every function a wrapper declares to ctypes has, in its argtypes and
    restype, the parameters and return type the ``extern "C"`` declaration
    in the source has: a pointer for each pointer, c_longlong for long
    long, c_int for int (ctypes passes an undeclared argument as a 32-bit
    int, which would cut a pointer or a long long)."""
    import ctypes
    import importlib
    from repro_torch.kernels import _build, mo_tile
    package, configure = CONFIGURE[name]
    module = importlib.import_module(f'repro_torch.kernels.{package}.kernel')
    monkeypatch.setattr(mo_tile, 'check_config', lambda *a: None)

    class _Fn:
        def __call__(self, *args):
            return getattr(module, 'MAX_RANK', 0)

    class _Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, attr):
            return self.fns.setdefault(attr, _Fn())
    lib = _Lib()
    getattr(module, configure)(lib)
    decl = _c_functions((_build.CSRC / f'{name}.cu').read_text())
    declared = {k: f for k, f in lib.fns.items() if hasattr(f, 'argtypes')}
    assert any(k.endswith('_launch') for k in declared)
    kind = {ctypes.c_int: 'int', ctypes.c_longlong: 'long long',
            ctypes.c_void_p: 'ptr'}
    for fn_name, fn in declared.items():
        assert fn_name in decl, f'{fn_name} is not in {name}.cu'
        ret, params = decl[fn_name]
        got = [kind.get(t, 'ptr' if issubclass(t, ctypes._Pointer) else t)
               for t in fn.argtypes]
        assert got == params, fn_name
        assert kind[fn.restype] == ret, fn_name
