"""What the two MO-product kernels share (``csrc/mo_tile.cuh``), on the
Python side: the electron order, the padded transpose of A, the orbital
stages, and the tile statistics that ``chip_smoke.py`` and the tests read.

Both kernels take the electrons in the order of a key that is local in
space, so that a tile of ``TE`` consecutive electrons shares most of its AO
rows.  The key is the nearest atom of each electron: it needs positions,
which the AO pass (``aos.eval_ao_rows``) and the screened candidate lists
(``screening.active_ao_lists_keyed``) already hold, so the caller passes it
in.  The output is written in the caller's electron order: nothing after
the product depends on the sort.
"""
from __future__ import annotations

import threading
import weakref

import torch

TE = 32            # electrons per tile (mo_tile::TE)
OPT = 4            # orbitals per thread (mo_tile::OPT)
MAX_STAGE = 80     # orbitals per stage, at most (mo_tile::MAX_STAGE)
CONFIG = (TE, OPT, MAX_STAGE)
PLAN_FIELDS = ('osw', 'n_stages', 'threads', 'lcap', 'ucap', 'smem')

_AT_LOCK = threading.Lock()
_AT = {}           # (device, id(A)) -> (weakref to A, A._version, At)


def stage_width(n_orb: int):
    """(orbitals per stage, stages): the fewest stages of at most
    ``MAX_STAGE`` orbitals, evened out and rounded up to a multiple of
    ``OPT`` (``mo_tile::stage_width``)."""
    s = max(-(-n_orb // MAX_STAGE), 1)
    per_stage = -(-n_orb // s)
    return max(-(-per_stage // OPT) * OPT, OPT), s


def padded_width(n_orb: int) -> int:
    """Columns of the padded transpose of A: whole orbital stages."""
    w, s = stage_width(n_orb)
    return w * s


def transposed(A: torch.Tensor) -> torch.Tensor:
    """A (n_orb, n_ao) as a contiguous (n_ao, padded_width(n_orb)) copy of
    its transpose, zero beyond n_orb, made once per parameter tensor: kept
    until A is freed or modified in place (its version counter moves)."""
    key = (str(A.device), id(A))
    with _AT_LOCK:
        got = _AT.get(key)
        if got is not None and got[0]() is A and got[1] == A._version:
            return got[2]
        for k in [k for k, v in _AT.items() if v[0]() is None]:
            del _AT[k]
        n_orb, n_ao = A.shape
        At = torch.zeros((n_ao, padded_width(n_orb)), dtype=torch.float32,
                         device=A.device)
        At[:, :n_orb] = A.t()
        _AT[key] = (weakref.ref(A), A._version, At)
        return At


def electron_order(key: torch.Tensor | None, n: int,
                   device=None) -> torch.Tensor:
    """The kernels' electron order: a stable argsort of the per-electron
    ``key`` as int32, or the identity when there is no key."""
    if key is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    if key.shape != (n,):
        raise ValueError(f'key: need shape ({n},), got {tuple(key.shape)}')
    return torch.argsort(key, stable=True).to(torch.int32)


def packed_mask(idx: torch.Tensor, active: torch.Tensor,
                n_ao: int) -> torch.Tensor:
    """(N, n_ao) bool activity mask of packed candidate lists."""
    N = idx.shape[0]
    mask = torch.zeros((N, n_ao), dtype=torch.bool, device=idx.device)
    rows = torch.arange(N, device=idx.device)[:, None].expand_as(idx)
    mask[rows[active], idx.long()[active]] = True
    return mask


def tile_unions(mask: torch.Tensor, order: torch.Tensor,
                te: int = TE) -> torch.Tensor:
    """AO rows each tile of ``te`` consecutive electrons of ``order`` needs
    (the size of the union of their active sets), as int64 (n_tiles,).
    mask: (N, n_ao) bool."""
    N, n_ao = mask.shape
    n_t = -(-N // te)
    m = torch.zeros((n_t * te, n_ao), dtype=torch.bool, device=mask.device)
    m[:N] = mask[order.long()]
    return m.reshape(n_t, te, n_ao).any(dim=1).sum(dim=1)


def check_config(got, what: str) -> None:
    """Raise unless a kernel library's compiled-in tile constants are
    ``CONFIG``."""
    if tuple(got) != CONFIG:
        raise RuntimeError(f'{what} config {tuple(got)} != {CONFIG}')


def check_tensor(name: str, t: torch.Tensor, dev, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous ``shape`` ``dtype`` tensor on the
    CUDA device ``dev``."""
    if t.device != dev or dev.type != 'cuda':
        raise ValueError(f'{name} must be on the CUDA device of At ({dev}), '
                         f'got {t.device}')
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f'{name}: need a contiguous {tuple(shape)} {dtype} '
                         f'tensor, got {tuple(t.shape)} {t.dtype}')


def output(N: int, n_orb: int, device) -> tuple:
    """The kernels' output: a (N, padded_width(n_orb), 5) buffer, which
    they write electron-major in whole 32-byte sectors (its padding
    orbitals are left unwritten), and its (n_orb, N, 5) view C[o, e, c] —
    the layout the callers read."""
    buf = torch.empty((N, padded_width(n_orb), 5), dtype=torch.float32,
                      device=device)
    return buf, buf[:, :n_orb].permute(1, 0, 2)


def check_at(At: torch.Tensor, n_orb: int) -> None:
    """Raise unless At is the padded transpose ``transposed`` makes for an
    A of n_orb rows."""
    if At.dim() != 2 or At.shape[1] != padded_width(n_orb):
        raise ValueError(f'At {tuple(At.shape)}: need (n_ao, '
                         f'{padded_width(n_orb)}) for n_orb={n_orb} '
                         f'(mo_tile.transposed)')


def _print_counts() -> None:
    """AO rows a tile of TE electrons needs on the CPU, at the chip run's
    cold start (``smallest`` unscreened and the ``b-strand`` at eps = 1e-8,
    W = 256, torch.Generator seed 1234), in the walker-major order and
    sorted by nearest atom or by first active AO: counts, no device
    metric."""
    from repro_torch.core import screening
    from repro_torch.core.vmc import sample_positions
    from repro_torch.systems import build_system
    for name, eps in (('smallest', None), ('b-strand', 1e-8)):
        kw = {} if eps is None else dict(screen_eps=eps)
        cfg, params = build_system(name, device='cpu', **kw)
        gen = torch.Generator()
        gen.manual_seed(1234)
        r = sample_positions(params, gen, 256, cfg.n_elec).reshape(-1, 3)
        d2 = ((r[:, None] - params.coords[None]) ** 2).sum(-1)
        if eps is None:
            mask = (d2 < cfg.basis_t.atom_radius2)[:, cfg.basis_t.ao_atom]
        else:
            idx, act, _ = screening.active_ao_lists(cfg.screening_t, r)
            mask = packed_mask(idx, act, cfg.basis_t.n_ao)
        first = torch.where(mask.any(1), mask.to(torch.int8).argmax(1),
                            mask.shape[1])
        N = r.shape[0]
        for label, key in (('walker-major', None),
                           ('nearest atom', d2.argmin(1)),
                           ('first active AO', first)):
            u = tile_unions(mask, electron_order(key, N)).double()
            print(f'{name} (N={N}, {mask.shape[1]} AOs, '
                  f'{float(mask.sum(1).double().mean()):.1f} active per '
                  f'electron), {label}: AO rows per {TE}-electron tile mean '
                  f'{float(u.mean()):.1f}, p90 {float(u.quantile(0.9)):.0f}, '
                  f'max {int(u.max())}')


if __name__ == '__main__':
    _print_counts()
