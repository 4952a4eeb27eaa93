"""The port's MU sweeps against the JAX package's, from the JAX package's
own inits (``jax.vmap(init_one)(keys)``) through the port's private entry
point ``_sweep_from_init``: in float64 against ``_sweep_impl`` on the same
keys (rtol 1e-8), in float32 against the public ``sweep_fit`` on the same
data and seed (rtol 1e-4), on the conv, fft and dot strategies, with a
flip group, KL, a mask, ``l2``/``ortho`` vectors and inhibition vectors
holding a zero.  W, H and the energies are compared.  The port runs on the
CPU, where the operators' vmap rules run the kernels' plain versions model
by model."""

import numpy as np
import pytest
import torch
from tnmf_tpu import sweep_fit as jax_sweep_fit

from tnmf_tpu_torch.models.sweep import _sweep_from_init

from . import jax_sweep

F64 = dict(rtol=1e-8, atol=1e-10)
F32 = dict(rtol=1e-4, atol=1e-6)


def _data(seed=7, n=4, c=1, s=12):
    return np.random.default_rng(seed).random((n, c, s, s))


def _mask(V):
    m = np.ones(V.shape)
    m[:, :, :3] = 0.0
    m[0, 0, 5:8, 2] = 0.0
    return m


# (id, data, n_atoms, atom_shape, sweep keywords); the strengths are
# per-model vectors of three models
CASES = [
    ('conv', _data(), 3, (3, 3), dict(strategy='conv', sparsity=[0.0, 0.1, 0.5])),
    ('fft', _data(), 3, (3, 3), dict(strategy='fft', sparsity=[0.2, 0.0, 0.1])),
    ('dot', np.random.default_rng(3).random((6, 1, 20)), 4, (20,),
     dict(strategy='conv', mode='full', sparsity=[0.0, 0.1, 0.3])),
    ('flip group', _data(n=2, s=10), 2, (3, 3),
     dict(strategy='conv', transform_type='shift+flip', sparsity=0.1)),
    ('beta 1', _data(n=2, s=10) + 0.05, 2, (3, 3),
     dict(strategy='conv', beta=1.0, sparsity=[0.0, 0.2, 0.1])),
    ('mask', _data(n=2, s=10), 2, (3, 3),
     dict(strategy='conv', mask=_mask(_data(n=2, s=10)), sparsity=[0.1, 0.0, 0.3])),
    ('l2 ortho', _data(), 3, (3, 3),
     dict(strategy='conv', sparsity=0.05, l2=[0.0, 0.1, 0.2], ortho=[0.05, 0.0, 0.1])),
    ('inhibition', _data(), 3, (3, 3),
     dict(strategy='conv', sparsity=[0.0, 0.1, 0.5], inhibition=[0.1, 0.0, 0.2],
          cross_inhibition=[0.0, 0.05, 0.1])),
    ('fft inhibition', _data(), 3, (3, 3),
     dict(strategy='fft', inhibition=[0.2, 0.0, 0.1], cross_inhibition=[0.05, 0.0, 0.0])),
]
IDS = [c[0] for c in CASES]


def _port_kw(kw: dict) -> dict:
    """The JAX helper's keywords as the port's entry point takes them."""
    kw = dict(kw)
    if 'mode' in kw:
        kw['reconstruction_mode'] = kw.pop('mode')
    if 'beta' in kw:
        kw['beta_loss'] = kw.pop('beta')
    return kw


def _assert_close(res, W, H, E, tol):
    np.testing.assert_allclose(res.W.numpy(), W, **tol)
    np.testing.assert_allclose(res.H.numpy(), H, **tol)
    np.testing.assert_allclose(res.energies.numpy(), E, rtol=tol['rtol'])


@pytest.mark.parametrize('name, V, n_atoms, atom_shape, kw', CASES, ids=IDS)
def test_sweep_float64_matches_jax_sweep_impl(name, V, n_atoms, atom_shape, kw):
    keys = jax_sweep.keys_of(11, 3)
    W0, H0, (W, H, E) = jax_sweep.run(V, keys, n_atoms, atom_shape, n_iterations=5, **kw)
    res = _sweep_from_init(V, W0, H0, n_iterations=5, device='cpu', **_port_kw(kw))
    assert res.W.dtype == res.H.dtype == torch.float64
    _assert_close(res, W, H, E, F64)


@pytest.mark.parametrize('name, V, n_atoms, atom_shape, kw', CASES, ids=IDS)
def test_sweep_float32_matches_jax_sweep_fit(name, V, n_atoms, atom_shape, kw):
    V = V.astype(np.float32)
    kw = dict(kw)
    if kw.get('mask') is not None:
        kw['mask'] = kw['mask'].astype(np.float32)
    W0, H0 = jax_sweep.inits(V, jax_sweep.keys_of(5, 3), n_atoms, atom_shape, **kw)
    port_kw = _port_kw(kw)
    jax_kw = dict(port_kw, transform_type=port_kw.get('transform_type', 'shift'))
    ref = jax_sweep_fit(V, n_atoms, atom_shape, n_models=3, seed=5, n_iterations=5, **jax_kw)
    res = _sweep_from_init(V, W0, H0, n_iterations=5, device='cpu', **port_kw)
    assert res.W.dtype == torch.float32
    _assert_close(res, np.asarray(ref.W), np.asarray(ref.H), np.asarray(ref.energies), F32)


def test_sweep_plain_versions_match_kernels_path():
    """``use_pallas=False`` (the plain versions under vmap, no operator)
    against the default (the operators' vmap rules) on the CPU."""
    name, V, n_atoms, atom_shape, kw = CASES[-2]
    W0, H0 = jax_sweep.inits(V, jax_sweep.keys_of(2, 3), n_atoms, atom_shape, **kw)
    a = _sweep_from_init(V, W0, H0, n_iterations=4, device='cpu', **_port_kw(kw))
    b = _sweep_from_init(V, W0, H0, n_iterations=4, device='cpu', use_pallas=False,
                         **_port_kw(kw))
    np.testing.assert_allclose(a.W.numpy(), b.W.numpy(), **F64)
    np.testing.assert_allclose(a.H.numpy(), b.H.numpy(), **F64)
