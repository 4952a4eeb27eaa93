"""The port's streaming and online fits against the JAX package, in float64
on the CPU: the golden ``stream`` energies on the fft and conv strategies,
``fit_stream`` from an array, from a generator, from tensors and with
``max_subsamples``, ``partial_fit`` sequences with and without memory, the
bits of a first memoryless ``partial_fit`` against one ``fit_batch``
iteration, the reset of the online state, and checkpoints of
``MiniBatchTransformInvariantNMF``.

The stream is the goldens' (``tests/test_stream.py``): 32 patches of 32 x
32 in subsamples of 16, 10 atoms of 7 x 7, ``batch_size=3`` (a ragged final
batch of 1), 3 epochs, ``sag_lambda=0.8``."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import tnmf_tpu

import tnmf_tpu_torch
from tnmf_tpu_torch import MiniBatchAlgorithm

from .fixtures import load_goldens, patches_2d

F64 = torch.float64
TOL = dict(rtol=1e-8, atol=1e-10)
PACKAGES = (tnmf_tpu_torch, tnmf_tpu)
SCHEDULE = dict(subsample_size=16, batch_size=3, n_epochs=3, sag_lambda=0.8)


@lru_cache(maxsize=None)
def stream_data():
    """The goldens' 32 patches, synthesized once for the module."""
    return patches_2d(n=32)


def _model(module, backend='jax_fft', **init):
    kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
    return module.TransformInvariantNMF(n_atoms=10, atom_shape=(7, 7), backend=backend,
                                        **init, **kw)


def _stream(module, backend, source, limited=False):
    """The golden stream fit from ``np.random.seed(42)`` over ``source``
    ('array', 'generator' or 'tensors'); returns the model and the global
    stream's next draw."""
    V = stream_data()
    samples = {'array': lambda: V, 'generator': lambda: (v for v in V),
               'tensors': lambda: (torch.tensor(v) for v in V)}[source]()
    np.random.seed(seed=42)
    nmf = _model(module, backend)
    algorithm = module.MiniBatchAlgorithm['Cyclic_MU' if limited else 'ASAG_MU']
    nmf.fit(samples, sparsity_H=0.1, algorithm=algorithm, **SCHEDULE,
            **(dict(max_subsamples=1) if limited else {}))
    return nmf, np.random.random()


@lru_cache(maxsize=None)
def _jax_stream(limited):
    return _stream(tnmf_tpu, 'jax_fft', 'array', limited)


def _assert_same(pm, jm):
    np.testing.assert_allclose(pm.W, jm.W, **TOL)
    np.testing.assert_allclose(pm.H, jm.H, **TOL)


@pytest.mark.parametrize('case', ['ASAG_MU', 'limited'])
@pytest.mark.parametrize('backend', ['jax_fft', 'jax_conv'])
def test_golden_stream_energies(backend, case):
    nmf, _ = _stream(tnmf_tpu_torch, backend, 'array', case == 'limited')
    assert nmf._strategy == backend.removeprefix('jax_')
    np.testing.assert_allclose(nmf._energy_function(), load_goldens()['stream'][case],
                               rtol=1e-8)
    np.testing.assert_allclose(nmf.W.sum(axis=(-1, -2)), 1.0)


@pytest.mark.parametrize('source,limited', [('array', False), ('generator', False),
                                            ('array', True)],
                         ids=['array', 'generator', 'max_subsamples=1'])
def test_stream_matches_jax(source, limited):
    """W and H of the last subsample's fit, and the global stream after
    it: H drawn for each subsample and a permutation for each epoch,
    interleaved as the JAX package draws them."""
    pm, p_next = _stream(tnmf_tpu_torch, 'jax_fft', source, limited)
    jm, j_next = _jax_stream(limited)
    _assert_same(pm, jm)
    assert p_next == j_next
    assert pm.H.shape[0] == 16


def test_stream_of_tensors_stacks_them_with_the_arrays_bits():
    """A subsample of tensors is stacked on their device, and the fit has
    the bits of the same stream of NumPy rows."""
    got, g_next = _stream(tnmf_tpu_torch, 'jax_fft', 'tensors')
    want, w_next = _stream(tnmf_tpu_torch, 'jax_fft', 'generator')
    assert isinstance(got._V, torch.Tensor) and isinstance(want._V, np.ndarray)
    assert torch.equal(got._W, want._W) and torch.equal(got._H, want._H)
    assert g_next == w_next


def _batches():
    """Three minibatches of differing sample count."""
    rng = np.random.default_rng(3)
    return [rng.random((n, 1, 16, 16)) for n in (4, 2, 5)]


@pytest.mark.parametrize('sag_lambda', [0.2, 1.0])
def test_partial_fit_sequence_matches_jax(sag_lambda):
    """Each step's W and H, the averaged statistics kept (or, at
    ``sag_lambda=1``, none) and ``n_steps_``."""
    models = [_model(module, 'jax_conv', seed=5) for module in PACKAGES]
    for step, V in enumerate(_batches()):
        for m in models:
            assert m.partial_fit(V, sag_lambda=sag_lambda, sparsity_H=0.1) is m
        pm, jm = models
        _assert_same(pm, jm)
        assert pm.n_steps_ == jm.n_steps_ == step + 1
        if sag_lambda == 1.0:
            assert pm._sag_stat_ is None and jm._sag_stat_ is None
        else:
            for p, j in zip(pm._sag_stat_, jm._sag_stat_):
                np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
def test_first_memoryless_partial_fit_is_one_fit_batch_iteration(backend):
    """A first call with ``sag_lambda=1`` runs the launches of one
    ``fit_batch`` iteration, in order, so it has its bits."""
    V = _batches()[0]
    a = _model(tnmf_tpu_torch, backend, seed=7)
    a.partial_fit(V, sag_lambda=1.0, sparsity_H=0.1, inhibition_strength=0.1)
    b = _model(tnmf_tpu_torch, backend, seed=7)
    b.fit_batch(V, n_iterations=1, sparsity_H=0.1, inhibition_strength=0.1)
    assert torch.equal(a._W, b._W) and torch.equal(a._H, b._H)


def test_every_fit_drops_the_online_state():
    V = _batches()[0]
    m = _model(tnmf_tpu_torch, 'jax_conv', seed=2)
    for refit in (lambda: m.fit_batch(V, n_iterations=1),
                  lambda: m.fit_minibatches(V, batch_size=2, n_epochs=1),
                  lambda: m.fit(iter(V), subsample_size=4, batch_size=2, n_epochs=1)):
        m.partial_fit(V, sag_lambda=0.5)
        assert m._sag_stat_ is not None
        refit()
        assert m._sag_stat_ is None
    with pytest.raises(ValueError, match='channel count'):
        m.partial_fit(np.ones((2, 3, 16, 16)))
    with pytest.raises(TypeError, match='sparsity_W'):
        m.partial_fit(V, sparsity_W=0.1)


def test_minibatch_model_streams_and_checkpoints(tmp_path):
    """``MiniBatchTransformInvariantNMF.fit`` still sends ``subsample_size``
    to ``fit_stream``; its checkpoint is the base class's, read by the JAX
    package, and loads back into the subclass with the default schedule."""
    out = []
    for module in PACKAGES:
        np.random.seed(42)
        kw = dict(device='cpu', dtype=F64) if module is tnmf_tpu_torch else {}
        nmf = module.MiniBatchTransformInvariantNMF(
            10, (7, 7), algorithm='ASAG_MU', batch_size=3, n_epochs=3, sag_lambda=0.8,
            backend='jax_fft', **kw)
        nmf.fit(stream_data(), sparsity_H=0.1, subsample_size=16)
        out.append(nmf)
    pm, jm = out
    _assert_same(pm, jm)
    np.testing.assert_allclose(pm._energy_function(), load_goldens()['stream']['ASAG_MU'],
                               rtol=1e-8)
    path = str(tmp_path / 'mb.npz')
    pm.save(path)
    loaded = tnmf_tpu_torch.MiniBatchTransformInvariantNMF.load(path, device='cpu')
    assert isinstance(loaded, tnmf_tpu_torch.MiniBatchTransformInvariantNMF)
    assert (loaded.algorithm, loaded.batch_size, loaded.n_epochs) == (
        MiniBatchAlgorithm.ASG_MU, 3, 1000)
    np.testing.assert_array_equal(loaded.W, pm.W)
    np.testing.assert_array_equal(tnmf_tpu.MiniBatchTransformInvariantNMF.load(path).W, pm.W)
