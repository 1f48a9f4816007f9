"""AdamW of the PyTorch port (``repro_torch.train.optimizer``) against
``repro.train.optimizer``: 5 steps on seeded numpy parameters and
gradients, with the global-norm clip active and inactive, on a dict and on
a NamedTuple tree (the reference's update maps dicts only, so the
NamedTuple case is held against its dict of the same leaves; rtol 1e-6,
the gradient norm too); the step count, the
moments' dtype and ``adamw_abstract``'s shapes and dtypes on ``meta``."""
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip('torch')
jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as j_opt  # noqa: E402

from repro_torch.train import (AdamWState, adamw_abstract,  # noqa: E402
                               adamw_init, adamw_update)


class Pair(NamedTuple):
    w: object
    b: object


SHAPES = {'w': (5, 3), 'b': (3,), 'a': (2, 2, 2)}


def _tree(kind, arrays, conv):
    if kind == 'dict':
        return {k: conv(v) for k, v in arrays.items()}
    return Pair(w=conv(arrays['w']), b=conv(arrays['b']))


def _leaves(tree, keys=('w', 'b')):
    if isinstance(tree, dict):
        return [tree[k] for k in keys if k in tree] + [
            tree[k] for k in sorted(tree) if k not in keys]
    return list(tree)


@pytest.mark.parametrize('kind', ['dict', 'namedtuple'])
@pytest.mark.parametrize('grad_clip', [1.0, 1e3], ids=['clip', 'noclip'])
def test_adamw_matches_jax(kind, grad_clip):
    rng = np.random.default_rng(7)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    if kind != 'dict':
        p0 = {k: p0[k] for k in ('w', 'b')}
    p_j = _tree('dict', p0, jnp.asarray)
    p_t = _tree(kind, p0, lambda a: torch.from_numpy(a.copy()))
    s_j, s_t = j_opt.adamw_init(p_j), adamw_init(p_t)
    clipped = []
    for _ in range(5):
        g = {k: (3.0 * rng.normal(size=s)).astype(np.float32)
             for k, s in SHAPES.items()}
        if kind != 'dict':
            g = {k: g[k] for k in ('w', 'b')}
        p_j, s_j, n_j = j_opt.adamw_update(_tree('dict', g, jnp.asarray), s_j,
                                           p_j, 1e-2, grad_clip=grad_clip)
        p_t, s_t, n_t = adamw_update(_tree(kind, g, torch.from_numpy), s_t,
                                     p_t, 1e-2, grad_clip=grad_clip)
        np.testing.assert_allclose(float(n_t), float(n_j), rtol=1e-6)
        clipped.append(float(n_j) > grad_clip)
        for a, b in zip(_leaves(p_t), _leaves(p_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for tree_t, tree_j in ((s_t.mu, s_j.mu), (s_t.nu, s_j.nu)):
            for a, b in zip(_leaves(tree_t), _leaves(tree_j)):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9)
    assert all(clipped) if grad_clip == 1.0 else not any(clipped)
    assert isinstance(s_t, AdamWState) and int(s_t.step) == 5
    assert s_t.step.dtype == torch.int32
    assert type(p_t) is type(_tree(kind, p0, torch.from_numpy))


def test_adamw_abstract_shapes_and_dtypes():
    params = {'w': torch.zeros((4, 3), dtype=torch.bfloat16),
              'b': torch.zeros((3,))}
    st = adamw_abstract(params)
    assert st.step.shape == () and st.step.dtype == torch.int32
    assert st.step.device.type == 'meta'
    for k, p in params.items():
        for tree in (st.mu, st.nu):
            assert tree[k].shape == p.shape
            assert tree[k].dtype == torch.float32
            assert tree[k].device.type == 'meta'
    # meta inputs too (no storage anywhere)
    st2 = adamw_abstract(Pair(w=torch.empty((2, 2), device='meta'),
                              b=torch.empty((5,), device='meta')))
    assert st2.mu.w.shape == (2, 2) and st2.nu.b.shape == (5,)
    j = j_opt.adamw_abstract({'w': jax.ShapeDtypeStruct((4, 3), jnp.bfloat16),
                              'b': jax.ShapeDtypeStruct((3,), jnp.float32)})
    for k in params:
        assert tuple(j.mu[k].shape) == tuple(st.mu[k].shape)
