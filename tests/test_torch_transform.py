"""The port's encoder against the JAX package, in float64 on the CPU: the
matched-filter start ``correlate_init_H``, the single H and W steps,
``set_dictionary``, ``transform`` (whole and in chunks, ``h_init`` random
and correlate, plain and inhibited), ``fit_transform`` and
``inverse_transform``; and a float32 ``transform`` of the golden 2-D
fixture against the JAX package in float32."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tnmf_tpu
from tnmf_tpu import engine as jengine
from tnmf_tpu.ops.inhibition import inhibition_kernels
from tnmf_tpu.ops.modes import ConvPlan as JConvPlan

import tnmf_tpu_torch
from tnmf_tpu_torch import engine
from tnmf_tpu_torch.ops.modes import ConvPlan

from .fixtures import image_2d as _image_2d

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
PACKAGES = (tnmf_tpu, tnmf_tpu_torch)
# (samples, channels, sample shape, atoms, atom shape)
SHAPES = {'2d': (2, 2, (24, 24), 3, (5, 5)), '1d': (1, 3, (100,), 3, (7,))}


@lru_cache(maxsize=None)
def image_2d():
    """The golden 2-D fixture, synthesized once for the module."""
    return _image_2d()


def _problem(dim, mode, seed=0):
    N, C, S, M, A = SHAPES[dim]
    rng = np.random.default_rng(seed)
    plan = ConvPlan.create(mode, S, A)
    V = rng.random((N, C) + S)
    W = rng.random((M, C) + A)
    W /= W.sum(axis=tuple(range(2, W.ndim)), keepdims=True)
    H = rng.random((N, M) + plan.transform_shape)
    return JConvPlan.create(mode, S, A), plan, V, W, H


@pytest.mark.parametrize('dim', ['1d', '2d'])
@pytest.mark.parametrize('mode', ['valid', 'full', 'circular', 'reflect'])
def test_correlate_init_H_matches_jax(mode, dim):
    jplan, plan, V, W, _ = _problem(dim, mode)
    want = jengine.correlate_init_H(
        jengine.prepare_data(jnp.asarray(V), plan=jplan, strategy='conv'), jnp.asarray(V),
        jnp.asarray(W), plan=jplan, strategy='conv', n_atoms=W.shape[0])
    Vt = torch.tensor(V)
    got = engine.correlate_init_H(engine.prepare_data(Vt, plan=plan), Vt, torch.tensor(W),
                                  plan=plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.dtype == F64 and bool((got > 0).all())


@pytest.mark.parametrize('inhibited', [False, True])
@pytest.mark.parametrize('dim,mode', [('1d', 'valid'), ('2d', 'circular'), ('2d', 'reflect')])
def test_update_steps_match_jax(dim, mode, inhibited):
    jplan, plan, V, W, H = _problem(dim, mode, seed=3)
    Vpj = jengine.prepare_data(jnp.asarray(V), plan=jplan, strategy='conv')
    Vp = engine.prepare_data(torch.tensor(V), plan=plan)
    ranges = tuple(a - 1 for a in SHAPES[dim][4])
    jk = tuple(jnp.asarray(k) for k in inhibition_kernels(ranges))
    pk = tuple(torch.tensor(k) for k in inhibition_kernels(ranges))
    inh, cross = (0.2, 0.1) if inhibited else (0., 0.)
    flags = dict(use_inhibition=inhibited, use_cross=inhibited)
    want = jengine.update_H_step(Vpj, jnp.asarray(W), jnp.asarray(H), 0.1, inh, cross, jk,
                                 plan=jplan, strategy='conv', **flags)
    got = engine.update_H_step(Vp, torch.tensor(W), torch.tensor(H), 0.1, inh, cross, pk,
                               plan=plan, **flags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jengine.update_W_step(Vpj, jnp.asarray(W), jnp.asarray(H), plan=jplan,
                                 strategy='conv')
    got = engine.update_W_step(Vp, torch.tensor(W), torch.tensor(H), plan=plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _model(module, atom_shape=(5, 5), seed=1, **init):
    kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
    return module.TransformInvariantNMF(3, atom_shape, seed=seed, **init, **kw)


@pytest.mark.parametrize('W,match', [
    (np.ones((2, 2, 5, 5)), 'does not match the model'),
    (np.ones((3, 2, 5, 4)), 'does not match the model'),
    (np.ones((3, 5, 5)), 'does not match the model'),
    (-np.ones((3, 2, 5, 5)), 'nonnegative'),
])
def test_set_dictionary_validates(W, match):
    for module in PACKAGES:
        with pytest.raises(ValueError, match=match):
            _model(module).set_dictionary(W)


def test_set_dictionary_normalises_and_drops_the_fit():
    W = np.random.default_rng(4).random((3, 2, 5, 5))
    W[1] = 0.
    m = _model(tnmf_tpu_torch)
    m.fit(np.random.default_rng(5).random((2, 2, 12, 12)), n_iterations=1)
    assert m.set_dictionary(W * 7.) is m
    assert m._H is None and m._plan is None and m._W.dtype == F64
    want = np.asarray(_model(tnmf_tpu).set_dictionary(W * 7.)._W)
    np.testing.assert_allclose(m.W, want, rtol=1e-15)
    np.testing.assert_allclose(m.W.sum(axis=(-2, -1))[[0, 2]], 1.)
    assert not m.W[1].any()


@pytest.fixture(name='dictionary', scope='module')
def fixture_dictionary():
    """A dictionary fit by the JAX package and new data to encode."""
    V = np.random.default_rng(6).random((3, 2, 24, 24))
    jm = _model(tnmf_tpu, seed=2)
    jm.fit(V, n_iterations=5, sparsity_H=0.1)
    return jm.W, np.random.default_rng(7).random((5, 2, 24, 24))


@pytest.mark.parametrize('inhibited', [False, True])
@pytest.mark.parametrize('h_init', ['random', 'correlate'])
def test_transform_matches_jax(dictionary, h_init, inhibited):
    W, V = dictionary
    fit = dict(sparsity_H=0.1)
    if inhibited:
        fit.update(inhibition_strength=0.1, cross_atom_inhibition_strength=0.05)
    out = []
    for module in PACKAGES:
        m = _model(module, h_init=h_init).set_dictionary(W)
        out.append((m, m.transform(V, n_iterations=6, **fit)))
    (jm, jH), (pm, pH) = out
    np.testing.assert_allclose(pH, jH, **TOL)
    np.testing.assert_array_equal(pH, pm.H)
    np.testing.assert_array_equal(pm.W, np.asarray(jm._W))  # frozen
    assert pm.n_iterations_ == 6
    np.testing.assert_allclose(pm.reconstruction_err_, jm.reconstruction_err_, rtol=1e-10)


def test_transform_correlate_draws_nothing(dictionary):
    """h_init='correlate' consumes no RNG for H (nor W, which is kept)."""
    W, V = dictionary
    m = _model(tnmf_tpu_torch, h_init='correlate').set_dictionary(W)
    state = m._rng.bit_generator.state
    first = m.transform(V, n_iterations=3)
    assert m._rng.bit_generator.state == state
    np.testing.assert_array_equal(m.transform(V, n_iterations=3), first)


def test_keep_H_wins_over_correlate(dictionary):
    W, V = dictionary
    m = _model(tnmf_tpu_torch, h_init='correlate').set_dictionary(W)
    m.transform(V, n_iterations=2)
    H2 = m.H
    m.transform(V, n_iterations=1, keep_H=True)
    want = engine.update_H_step(m._Vp, m._W, torch.tensor(H2), 0., plan=m._plan)
    np.testing.assert_array_equal(m.H, want.numpy())


@pytest.mark.parametrize('batch_size', [2, 4])
def test_transform_in_chunks_matches_jax(dictionary, batch_size):
    """Chunks of ``batch_size`` (the last one shorter) encode independently;
    with h_init='random' they draw the whole batch's H in the same order, so
    the chunked H is the whole batch's."""
    W, V = dictionary
    out = {}
    for module in PACKAGES:
        m = _model(module).set_dictionary(W)
        out[module] = m.transform(V, n_iterations=4, batch_size=batch_size, sparsity_H=0.1)
        assert m.H.shape[0] == V.shape[0] % batch_size  # the last chunk
    np.testing.assert_allclose(out[tnmf_tpu_torch], out[tnmf_tpu], **TOL)
    whole = _model(tnmf_tpu_torch).set_dictionary(W).transform(V, n_iterations=4,
                                                                 sparsity_H=0.1)
    np.testing.assert_allclose(out[tnmf_tpu_torch], whole, **TOL)


def test_fit_transform_and_inverse_transform():
    V = np.random.default_rng(8).random((2, 2, 16, 14))
    out = []
    for module in PACKAGES:
        m = _model(module, atom_shape=(4, 3))
        with pytest.raises(RuntimeError, match='requires a fitted model'):
            m.inverse_transform()
        H = m.fit_transform(V, n_iterations=3, sparsity_H=0.1)
        np.testing.assert_array_equal(H, m.H)
        out.append((m, H))
    (jm, jH), (pm, pH) = out
    np.testing.assert_allclose(pH, jH, **TOL)
    np.testing.assert_array_equal(pm.inverse_transform(), pm.R)
    H2 = np.random.default_rng(9).random(pH.shape)
    np.testing.assert_allclose(pm.inverse_transform(H2), jm.inverse_transform(H2), **TOL)
    pm.set_dictionary(pm.W)
    with pytest.raises(RuntimeError, match='requires a fitted model'):
        pm.inverse_transform(H2)


def test_transform_requires_a_dictionary():
    for module in PACKAGES:
        with pytest.raises(RuntimeError, match='fitted or loaded dictionary'):
            _model(module).transform(np.ones((1, 2, 8, 8)))


def test_loaded_dictionary_encodes_as_in_jax(dictionary, tmp_path):
    """A JAX checkpoint loaded in the port encodes new data as the JAX
    package's own load does."""
    W, V = dictionary
    j = _model(tnmf_tpu, h_init='correlate').set_dictionary(W)
    j.transform(V[:2], n_iterations=1)
    path = str(tmp_path / 'dict.npz')
    j.save(path)
    out = []
    for module in PACKAGES:
        kw = dict(device='cpu') if module is tnmf_tpu_torch else {}
        m = module.TransformInvariantNMF.load(path, h_init='correlate', **kw)
        out.append(m.transform(V, n_iterations=3, sparsity_H=0.2))
    np.testing.assert_allclose(out[1], out[0], **TOL)


@pytest.mark.parametrize('h_init', ['random', 'correlate'])
def test_float32_transform_of_golden_fixture(h_init):
    """In float32 on the CPU the golden 2-D fixture encodes against the JAX
    package's float32 dictionary within 1e-5 of the JAX package's H
    (max |port - jax| / max |jax|)."""
    image = image_2d()
    np.random.seed(42)
    jm = tnmf_tpu.TransformInvariantNMF(n_atoms=10, atom_shape=(7, 7), dtype='float32',
                                        h_init=h_init)
    jm.fit(image, sparsity_H=0.1, n_iterations=10)
    W = jm.W
    out = []
    for module in PACKAGES:
        kw = dict(device='cpu') if module is tnmf_tpu_torch else {}
        m = module.TransformInvariantNMF(n_atoms=10, atom_shape=(7, 7), dtype='float32',
                                         seed=3, h_init=h_init, **kw)
        out.append(m.set_dictionary(W).transform(image, n_iterations=10, sparsity_H=0.1))
    jH, pH = out
    assert pH.dtype == jH.dtype == np.float32
    assert np.abs(pH - jH).max() / np.abs(jH).max() <= 1e-5
