"""AdamW in plain torch (f32 moments, decoupled weight decay).

Port of ``repro.train.optimizer``: dependency-free, parameter tree in,
parameter tree out, so a caller can drop it onto any dict or NamedTuple
of tensors without an optimizer library.  Leaves are visited in the
reference's order (``jax.tree.leaves``: dict keys sorted, NamedTuple
fields in order), so the global gradient norm sums in the same order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: dict                 # first moments (params tree, f32)
    nu: dict                 # second moments


def _leaves(tree) -> list:
    """The tensors of a dict/NamedTuple/tuple/list tree, in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """A tree of ``tree``'s structure whose leaves are taken, in
    ``_leaves`` order, from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*[_rebuild(v, leaves) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _map(fn, tree):
    """``fn`` over the leaves of ``tree``, keeping its structure."""
    return _rebuild(tree, iter([fn(x) for x in _leaves(tree)]))


def _device(tree) -> torch.device:
    leaves = _leaves(tree)
    return leaves[0].device if leaves else torch.device('cpu')


def adamw_init(params) -> AdamWState:
    """Zero moments (f32, on each parameter's device) at step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=_device(params)),
                      mu=_map(zeros, params), nu=_map(zeros, params))


def adamw_abstract(abstract_params) -> AdamWState:
    """The state's shapes and dtypes without storage: ``meta``-device
    tensors (torch's counterpart of ``jax.ShapeDtypeStruct``)."""
    z = _map(lambda p: torch.empty(tuple(p.shape), dtype=torch.float32,
                                   device='meta'), abstract_params)
    return AdamWState(step=torch.empty((), dtype=torch.int32, device='meta'),
                      mu=z, nu=z)


def adamw_update(grads, state: AdamWState, params, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step -> (new params, new state, global gradient norm).

    Gradients are clipped to ``grad_clip`` in global norm first; moments
    and the update run in f32, new parameters keep each one's dtype."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in _leaves(grads)))
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.to(torch.float32)
        return (p32 - lr * (u + weight_decay * p32)).to(p.dtype), m, v

    new = [upd(*leaf) for leaf in zip(_leaves(grads), _leaves(state.mu),
                                      _leaves(state.nu), _leaves(params))]
    newp, mu, nu = [_rebuild(params, iter([t[i] for t in new]))
                    for i in range(3)]
    return newp, AdamWState(step=step, mu=mu, nu=nu), gnorm
